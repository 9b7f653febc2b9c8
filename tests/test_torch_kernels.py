"""Plain versions of the port's kernels against the JAX package's Pallas
kernels, run in interpret mode on the CPU (as tests/unit/test_pallas_*.py
run them), and against the JAX reference ops. On the CPU each port wrapper
runs its plain version; the CUDA kernels are held against these plain
versions on the card (chip_smoke.py, tests/test_torch_cuda.py).

Tolerances:
  * residual stack, float32: summation order only (three (C x C) dots per
    unit vs one conv), rtol/atol 2e-5 over three units.
  * residual stack, bfloat16: the plain version rounds where the kernel's
    source casts (activation, conv outputs, residual add). XLA evaluating
    the interpreted kernel can keep some of those intermediates in float32,
    which moves about a quarter of the outputs by one bf16 ulp; so max abs
    <= 2e-2 * max|ref| (a few ulps) and mean abs <= 2e-3 * max|ref|.
  * RVQ quantize and dequantize: bit-exact. An index outside [0, K) adds
    nothing to the sum, in the Pallas kernel (its one-hot row is zero) and
    in the port; the JAX package's XLA scan instead gathers with jnp's
    out-of-range rule, so those indices are held against the Pallas kernel
    only.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsc_tpu.configs import get_config
from nsc_tpu.models import seanet as JS
from nsc_tpu.ops import rvq as JR
from nsc_tpu.ops.pallas import residual_stack as JRS
from nsc_tpu.ops.pallas import rvq_argmin as JPK
from nsc_tpu_torch import kernels
from nsc_tpu_torch import weights as W
from nsc_tpu_torch.kernels import residual_stack as RS
from nsc_tpu_torch.kernels import rvq as KR


def _units(c, dilations, act, seed):
    """JAX residual units with non-zero biases and non-unit alphas, so a
    stale halo (W2.act(b1)+b2 left at t < 0) would show."""
    cfg = dataclasses.replace(get_config("base"), activation=act, dilations=dilations)
    rng = np.random.RandomState(seed)
    units = []
    for i in range(len(dilations)):
        u = JS._init_residual_unit(jax.random.PRNGKey(seed + i), c, 3, cfg)
        u = jax.tree.map(np.asarray, u)
        for conv in ("conv1", "conv2"):
            u[conv]["b"] = (rng.randn(c) * 0.5).astype(np.float32)
        for a in ("act1", "act2"):
            u[a]["alpha"] = (1 + 0.5 * rng.rand(c)).astype(np.float32)
        units.append(u)
    return cfg, units


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["snake_fast", "snake"])
@pytest.mark.parametrize("c,t,dilations", [(32, 3000, (1, 3, 9)), (16, 700, (1, 3))])
def test_residual_stack_plain_matches_pallas(dtype, act, c, t, dilations):
    cfg, units = _units(c, dilations, act, seed=c)
    x = (np.random.RandomState(1).randn(2, c, t) * 0.5).astype(np.float32)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    packed = JRS.pack_stage_params(jax.tree.map(jnp.asarray, units), cfg)
    ref = JRS.residual_stack_ct_pallas(
        jnp.asarray(x).astype(jdt), *packed, dilations=dilations,
        interpret=True, fast_act=(act == "snake_fast"), tile_t=512,
    )
    ref = np.asarray(ref.astype(jnp.float32))
    packed = RS.pack_stage(W.units_from_jax(units), tdt)
    got = RS.residual_stack(
        torch.from_numpy(x).to(tdt), packed, dilations, act == "snake_fast"
    ).float().numpy()
    err = np.abs(got - ref)
    scale = np.abs(ref).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
    else:
        assert err.max() <= 2e-2 * scale
        assert err.mean() <= 2e-3 * scale
        # the first tile holds the t < 0 halo: same bound there
        assert err[..., :64].max() <= 2e-2 * scale


@pytest.mark.parametrize("act", ["snake_fast", "snake"])
def test_residual_stack_plain_matches_op_by_op_reference(act):
    """float32: the in-kernel activation equals the standalone one, so the
    plain version must equal the JAX op-by-op units (each conv zero-pads
    its own activated input) including the first samples."""
    c, t, dilations = 16, 1000, (1, 3, 9)
    cfg, units = _units(c, dilations, act, seed=3)
    x = (np.random.RandomState(2).randn(2, t, c) * 0.5).astype(np.float32)
    h = jnp.asarray(x)
    for u, d in zip(units, dilations):
        h = JS._apply_residual_unit(jax.tree.map(jnp.asarray, u), h, d, cfg, "causal")
    ref = np.asarray(h).transpose(0, 2, 1)
    packed = RS.pack_stage(W.units_from_jax(units), torch.float32)
    got = RS.residual_stack(
        torch.from_numpy(x.transpose(0, 2, 1).copy()), packed, dilations,
        act == "snake_fast",
    ).numpy()
    np.testing.assert_allclose(got[..., :32], ref[..., :32], rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


def _books(n_q, k, d, seed):
    return np.random.RandomState(seed).randn(n_q, k, d).astype(np.float32)


@pytest.mark.parametrize("m,d,k,n_q", [(700, 32, 128, 4), (33, 128, 256, 3), (513, 16, 128, 2)])
def test_quantize_plain_bit_exact_with_pallas(m, d, k, n_q):
    books = _books(n_q, k, d, seed=m)
    z = (np.random.RandomState(m + 1).randn(m, d) * 1.5).astype(np.float32)
    ref = np.asarray(JPK.quantize_pallas(jnp.asarray(books), jnp.asarray(z), interpret=True))
    got = KR.quantize(torch.from_numpy(books), torch.from_numpy(z)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, np.asarray(JR.quantize({"codebooks": jnp.asarray(books)}, jnp.asarray(z)))
    )


def test_quantize_ties_go_to_lowest_index():
    """Duplicate codewords (in both books), and frames sitting exactly on a
    duplicated one: the lower index wins."""
    books = _books(2, 128, 8, seed=5)
    books[0, 90] = books[0, 3]
    books[1, 100] = books[1, 40]
    books[1, 7] = books[1, 40]
    z = np.stack([books[0, 3], books[0, 3] + books[1, 40], books[0, 90]]).astype(np.float32)
    ref = np.asarray(JPK.quantize_pallas(jnp.asarray(books), jnp.asarray(z), interpret=True))
    got = KR.quantize(torch.from_numpy(books), torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got[0, 0] == 3 and got[2, 0] == 3


def test_quantize_prefix_depth_slicing():
    """The first n_q books of a deeper quantizer give the same indices."""
    from nsc_tpu_torch.ops import rvq as PR

    books = _books(4, 128, 16, seed=8)
    z = np.random.RandomState(9).randn(3, 50, 16).astype(np.float32)
    st = {"codebooks": torch.from_numpy(books)}
    full = PR.quantize(st, torch.from_numpy(z), kernel=True).numpy()
    for n_q in (1, 2, 3):
        part = PR.quantize(st, torch.from_numpy(z), n_q=n_q, kernel=True).numpy()
        np.testing.assert_array_equal(part, full[..., :n_q])
        ref = np.asarray(JR.quantize({"codebooks": jnp.asarray(books)}, jnp.asarray(z), n_q=n_q))
        np.testing.assert_array_equal(part, ref)
        pallas = JPK.quantize_pallas(
            jnp.asarray(books[:n_q]), jnp.asarray(z.reshape(-1, 16)), interpret=True
        )
        np.testing.assert_array_equal(part.reshape(-1, n_q), np.asarray(pallas))
        np.testing.assert_array_equal(
            PR.quantize(st, torch.from_numpy(z), n_q=n_q).numpy(), ref
        )


@pytest.mark.parametrize("m,d,k,n_q", [(300, 32, 128, 4), (40, 128, 256, 16)])
def test_dequantize_plain_bit_exact(m, d, k, n_q):
    books = _books(n_q, k, d, seed=m)
    idx = np.random.RandomState(m + 2).randint(0, k, (m, n_q)).astype(np.int32)
    ref = np.asarray(JPK.dequantize_pallas(jnp.asarray(books), jnp.asarray(idx), interpret=True))
    scan = np.asarray(JR.dequantize({"codebooks": jnp.asarray(books)}, jnp.asarray(idx)))
    got = KR.dequantize(torch.from_numpy(books), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, scan)


@pytest.mark.parametrize("n_q,k,d", [(2, 8, 4), (3, 128, 16), (4, 256, 130)])
def test_dequantize_plain_out_of_range_indices_add_nothing(n_q, k, d):
    """Indices -1 and K (and far outside) beside indices in range: the plain
    version gives what the Pallas kernel gives, bit for bit."""
    books = _books(n_q, k, d, seed=k + d)
    idx = np.random.RandomState(k).randint(0, k, (40, n_q)).astype(np.int32)
    idx[::2, 0] = -1
    idx[1::3, -1] = k
    idx[5, :] = [k, -1, 1 << 30, -(1 << 30)][:n_q] + [3] * max(0, n_q - 4)
    idx[7, :] = -1  # no book adds anything: a zero row
    ref = np.asarray(JPK.dequantize_pallas(jnp.asarray(books), jnp.asarray(idx), interpret=True))
    got = KR.dequantize(torch.from_numpy(books), torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not got[7].any()
    in_range = (idx >= 0) & (idx < k)
    want = sum(np.where(in_range[:, q, None], books[q][np.clip(idx[:, q], 0, k - 1)], 0)
               for q in range(n_q))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_cpu_wrappers_do_not_count_launches():
    kernels.reset_launches()
    books = torch.from_numpy(_books(2, 128, 8, seed=1))
    z = torch.randn(10, 8)
    KR.dequantize(books, KR.quantize(books, z))
    cfg, units = _units(8, (1,), "snake_fast", seed=0)
    packed = RS.pack_stage(W.units_from_jax(units), torch.float32)
    RS.residual_stack(torch.randn(1, 8, 50), packed, (1,), True)
    from nsc_tpu_torch.ops import quant as Q

    Q.int_conv1d(torch.ones(1, 8, 12, dtype=torch.int8), torch.ones(4, 8, 3, dtype=torch.int8))
    assert kernels.LAUNCHES == {
        "residual_stack": 0, "rvq_quantize": 0, "rvq_split_planes": 0, "rvq_dequantize": 0,
        "stft_magnitude": 0, "stft_magnitude_bluestein": 0,
        "stft_magnitude_bluestein_cluster": 0, "stft_magnitude_bluestein_global": 0,
        "residual_stack_cl": 0, "fused_stage": 0, "int_mm": 0,
    }
