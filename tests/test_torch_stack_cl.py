"""K6, the channels-last residual stack: the port's plain version
(`kernels.residual_stack.residual_stack_cl_plain`, what the wrapper runs on
the CPU and what the CUDA kernel is held against on the card) against the
JAX package's `residual_stack_pallas` in interpret mode on the CPU (as
tests/unit/test_pallas_stack.py runs it, "highest" matmul precision), on
the same numpy inputs.

Tolerances (K1's, tests/test_torch_kernels.py):
  * float32: summation order only (three (C x C) dots per unit in the
    Pallas kernel vs one conv), rtol/atol 2e-5.
  * bfloat16 x with float32 weights: the plain version rounds where the
    kernel's source casts (activation, conv outputs, residual add); XLA
    evaluating the interpreted kernel can keep some intermediates in
    float32, which moves outputs by a bf16 ulp: max abs <= 2e-2 * max|ref|
    (a few ulps), mean abs <= 2e-3 * max|ref|, and the same max bound on the
    first tile, which holds the t < 0 halo.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsc_tpu.configs import get_config
from nsc_tpu.models import seanet as JS
from nsc_tpu.ops.pallas import residual_stack as JRS
from nsc_tpu_torch import kernels
from nsc_tpu_torch import weights as W
from nsc_tpu_torch.kernels import residual_stack as RS


def _units(c, dilations, act, seed):
    """JAX residual units with non-zero biases and non-unit alphas, so a
    stale halo (the bias ripple at t < 0) would show."""
    cfg = dataclasses.replace(get_config("base"), activation=act, dilations=dilations)
    rng = np.random.RandomState(seed)
    units = []
    for i in range(len(dilations)):
        u = jax.tree.map(np.asarray, JS._init_residual_unit(jax.random.PRNGKey(seed + i), c, 3, cfg))
        for conv in ("conv1", "conv2"):
            u[conv]["b"] = (rng.randn(c) * 0.5).astype(np.float32)
        for a in ("act1", "act2"):
            u[a]["alpha"] = (1 + 0.5 * rng.rand(c)).astype(np.float32)
        units.append(u)
    return cfg, units


def _packed_f32(units):
    """The port's K6 packing: float32 weights, as `residual_stack_pallas`
    receives them from `pack_stage_params`."""
    return RS.pack_stage(W.units_from_jax(units), torch.float32)


def _check(got, ref, dtype):
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
        return
    err = np.abs(got - ref)
    scale = np.abs(ref).max()
    assert err.max() <= 2e-2 * scale
    assert err.mean() <= 2e-3 * scale
    assert err[:, :128].max() <= 2e-2 * scale  # tile 0, the t < 0 halo


# (C, T, dilations, JAX tile): several tiles with a ragged last one; one
# unit; a 242-sample halo (wider than K1's JAX kernel allows). The JAX
# kernel zeroes the stale halo rows on tile 0 only, so a halo wider than its
# tile leaves a bias ripple at t < 0 in tile 1's halo (at tile_t=128 the
# 242-sample case is off by ~1.0 at t = 128..239 against the op-by-op
# units); its default tile at these widths (2048) never is. That case runs
# at tile_t=256.
CASES = [(8, 300, (1, 3, 9), 128), (32, 300, (1,), 128), (32, 600, (1, 3, 9, 27, 81), 256)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["snake_fast", "snake"])
@pytest.mark.parametrize("c,t,dilations,tile_t", CASES)
def test_residual_stack_cl_plain_matches_pallas(dtype, act, c, t, dilations, tile_t):
    cfg, units = _units(c, dilations, act, seed=c + len(dilations))
    x = (np.random.RandomState(1).randn(2, t, c) * 0.5).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    packed = JRS.pack_stage_params(jax.tree.map(jnp.asarray, units), cfg)
    ref = JRS.residual_stack_pallas(
        jnp.asarray(x).astype(jdt), *packed, dilations=dilations,
        interpret=True, fast_act=(act == "snake_fast"), tile_t=tile_t,
    )
    ref = np.asarray(ref.astype(jnp.float32))
    got = RS.residual_stack_cl(
        torch.from_numpy(x).to(tdt), _packed_f32(units), dilations, act == "snake_fast"
    )
    assert got.dtype == tdt and got.shape == (2, t, c)
    _check(got.float().numpy(), ref, dtype)


@pytest.mark.parametrize("act", ["snake_fast", "snake"])
def test_residual_stack_cl_plain_matches_op_by_op_reference(act):
    """float32: the plain version equals the JAX op-by-op units (each conv
    zero-pads its own activated input), the first samples included."""
    c, t, dilations = 16, 500, (1, 3, 9)
    cfg, units = _units(c, dilations, act, seed=3)
    x = (np.random.RandomState(2).randn(2, t, c) * 0.5).astype(np.float32)
    h = jnp.asarray(x)
    for u, d in zip(units, dilations):
        h = JS._apply_residual_unit(jax.tree.map(jnp.asarray, u), h, d, cfg, "causal")
    got = RS.residual_stack_cl(torch.from_numpy(x), _packed_f32(units), dilations,
                               act == "snake_fast").numpy()
    np.testing.assert_allclose(got, np.asarray(h), rtol=2e-5, atol=2e-5)


def test_snake_fast_divides_where_k1_multiplies():
    """K6's in-kernel snake_fast divides by (alpha + eps), K1's multiplies
    by its reciprocal: the two differ on some inputs by a rounding, and the
    port follows each kernel's own."""
    x = torch.linspace(-6, 6, 20001)[None, None, :]
    alpha = torch.tensor([1.37])
    a = alpha.reshape(1, 1, 1)
    sq = RS.sin_sq_poly(a * x)
    np.testing.assert_array_equal(RS.act(x, alpha, True, divide=True).numpy(),
                                  (x + sq / (a + 1e-9)).numpy())
    np.testing.assert_array_equal(RS.act(x, alpha, True).numpy(),
                                  (x + sq * (1.0 / (a + 1e-9))).numpy())
    assert not torch.equal(sq / (a + 1e-9), sq * (1.0 / (a + 1e-9)))


def test_bf16_products_keep_float32_weights():
    """bf16 x with float32 weights (K6's numerics) differs from the same
    stage with weights rounded to bf16 (K1's): the plain version must not
    round them."""
    cfg, units = _units(32, (1, 3, 9), "snake_fast", seed=5)
    x = torch.from_numpy((np.random.RandomState(4).randn(1, 300, 32) * 0.5).astype(np.float32))
    p32 = _packed_f32(units)
    p16 = {**p32, "w1": p32["w1"].bfloat16().float(), "w2": p32["w2"].bfloat16().float()}
    xb = x.bfloat16()
    assert not torch.equal(RS.residual_stack_cl(xb, p32, (1, 3, 9), True),
                           RS.residual_stack_cl(xb, p16, (1, 3, 9), True))


def test_cpu_stage_wrappers_count_no_launches():
    from nsc_tpu_torch.kernels import fused_stage as FS

    kernels.reset_launches()
    cfg, units = _units(8, (1,), "snake_fast", seed=0)
    p = _packed_f32(units)
    RS.residual_stack_cl(torch.randn(1, 50, 8), p, (1,), True)
    FS.fused_stage(torch.randn(1, 8, 50), {"units": p}, (1,), True)
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)
    assert set(kernels.LAUNCHES) >= {"residual_stack_cl", "fused_stage"}
