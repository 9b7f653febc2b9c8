"""K5, the boundary-fused stage, and the two opt-in serving paths of the
port (`unit_backend="pallas_ct_fused"` through K5, `"pallas_fused"` through
K6) against the JAX package on the same numpy inputs and weights. The JAX
side runs as its own tests run it: `fused_stage_ct_pallas` in interpret
mode on the CPU, "highest" matmul precision. Off the TPU the JAX package
runs `"pallas_fused"` op by op, so the port's K6 path is held against that.

Tolerances:
  * K5 plain vs `fused_stage_ct_pallas`: K1's (tests/test_torch_kernels.py)
    -- float32 rtol/atol 2e-5 (summation order: the head's and tail's two
    phase matmuls and the units' three dots vs one conv each); bfloat16 max
    abs <= 2e-2 * max|ref| and mean abs <= 2e-3 * max|ref| (a bf16 ulp where
    a float32 sum lands on the other side of a rounding boundary, carried
    through later units).
  * encoder/decoder on `small`, float32: rtol 1e-4 / atol 1e-5, the JAX
    package's own for the fused path (tests/unit/test_pallas_stack.py).
  * float32 reconstruct: indices bit-equal, waveforms rtol 1e-3 / atol 1e-4
    (the port's parity bar).
  * bf16 serving reconstruct: index agreement >= 0.95 and the decode-only
    bounds of tests/test_torch_codec.py (max abs <= 5e-2 * max|ref|, relative
    RMS <= 1e-2): both sides round to bf16, at partly different points.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsc_tpu import api as JA
from nsc_tpu.configs import get_config as jax_config
from nsc_tpu.configs import list_configs
from nsc_tpu.models import seanet as JS
from nsc_tpu.ops import conv as JC
from nsc_tpu.ops.pallas import residual_stack as JRS
from nsc_tpu_torch import api as PA
from nsc_tpu_torch import kernels
from nsc_tpu_torch import weights as W
from nsc_tpu_torch.configs import get_config
from nsc_tpu_torch.kernels import fused_stage as FS
from nsc_tpu_torch.kernels import residual_stack as RS
from nsc_tpu_torch.models import seanet as PS
from nsc_tpu_torch.models.codec import KernelOptions

DIL = (1, 3)


def _units(c, act, seed):
    cfg = dataclasses.replace(jax_config("base"), activation=act, dilations=DIL)
    rng = np.random.RandomState(seed)
    units = []
    for i in range(len(DIL)):
        u = jax.tree.map(np.asarray, JS._init_residual_unit(jax.random.PRNGKey(seed + i), c, 3, cfg))
        for conv in ("conv1", "conv2"):
            u[conv]["b"] = (rng.randn(c) * 0.5).astype(np.float32)
        for a in ("act1", "act2"):
            u[a]["alpha"] = (1 + 0.5 * rng.rand(c)).astype(np.float32)
        units.append(u)
    return cfg, units


def _boundary(c_act, c_in, c_out, s, seed):
    """A snake alpha over c_act channels and a weight-normed k=2S conv in the
    JAX layout, with a non-zero bias."""
    rng = np.random.RandomState(seed)
    conv = jax.tree.map(np.asarray, JC.init_conv(jax.random.PRNGKey(seed), 2 * s, c_in, c_out,
                                                 weight_norm=True))
    conv["b"] = (rng.randn(c_out) * 0.3).astype(np.float32)
    return {"alpha": (1 + 0.5 * rng.rand(c_act)).astype(np.float32)}, conv


def _check(got, ref, dtype):
    assert got.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)
        return
    err = np.abs(got - ref)
    scale = np.abs(ref).max()
    assert err.max() <= 2e-2 * scale
    assert err.mean() <= 2e-3 * scale


# (head stride, tail stride, C_in, C_mid, C_out, T_in): T_in not a multiple
# of the head's stride; several 128-frame tiles on the JAX side
CASES = [
    (2, 1, 8, 16, 16, 517), (4, 1, 8, 16, 16, 1037), (5, 1, 8, 16, 16, 1283),
    (1, 2, 16, 16, 8, 301), (1, 4, 16, 16, 8, 301), (1, 5, 16, 16, 8, 263),
    (1, 1, 16, 16, 16, 300),
]


@pytest.mark.parametrize("act", ["snake_fast", "snake"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sh,stl,c_in,c_mid,c_out,t_in", CASES)
def test_fused_stage_plain_matches_pallas(dtype, act, sh, stl, c_in, c_mid, c_out, t_in):
    fast = act == "snake_fast"
    cfg, units = _units(c_mid, act, seed=sh * 10 + stl)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    head = tail = None
    p_head = p_tail = None
    if sh > 1:
        a, conv = _boundary(c_in, c_in, c_mid, sh, seed=sh)
        head = JRS.pack_head_params(jax.tree.map(jnp.asarray, a), jax.tree.map(jnp.asarray, conv),
                                    sh, jdt)
        p_head = FS.pack_head(torch.from_numpy(a["alpha"]), W.conv_from_jax(conv), tdt)
    if stl > 1:
        a, conv = _boundary(c_mid, c_mid, c_out, stl, seed=stl + 7)
        tail = JRS.pack_tail_params(jax.tree.map(jnp.asarray, a), jax.tree.map(jnp.asarray, conv),
                                    stl, jdt)
        p_tail = FS.pack_tail(torch.from_numpy(a["alpha"]), W.conv_transpose_from_jax(conv), tdt)
    x = (np.random.RandomState(1).randn(2, c_in, t_in) * 0.5).astype(np.float32)
    packed = JRS.pack_stage_params(jax.tree.map(jnp.asarray, units), cfg)
    ref = JRS.fused_stage_ct_pallas(
        jnp.asarray(x).astype(jdt), head, *packed, tail, dilations=DIL, s_head=sh,
        s_tail=stl, interpret=True, tile_t=128, fast_act=fast,
    )
    ref = np.asarray(ref.astype(jnp.float32))
    p = FS.pack(W.units_from_jax(units), p_head, p_tail)
    got = FS.fused_stage(torch.from_numpy(x).to(tdt), p, DIL, fast)
    assert got.dtype == tdt
    _check(got.float().numpy(), ref, dtype)


# -- the slice on `small` ------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _weights(name):
    """Seeded weights in the JAX layout (numpy), given to both packages."""
    return W.init_jax_layout(get_config(name), 0)


def _pair(name, backend, serving=False):
    """(JAX bundle, port bundle) for `unit_backend=backend` on the same
    weights."""
    cfg = jax_config(name)
    if serving:
        cfg = JA.serving_config(cfg)
    cfg = dataclasses.replace(cfg, unit_backend=backend)
    params, rvq = _weights(name)
    jb = JA.ModelBundle(JA.NeuralSpeechCodec(cfg), jax.tree.map(jnp.asarray, params),
                        jax.tree.map(jnp.asarray, rvq))
    pb = PA.bundle_from_jax(get_config(name).__class__(**dataclasses.asdict(cfg)), params, rvq,
                            device="cpu")
    return jb, pb


@pytest.mark.parametrize("t", [2 * 320 + 77, 4 * 320])
def test_fused_encoder_matches_jax(t):
    jb, pb = _pair("small", "pallas_ct_fused")
    assert pb.model.kernels.units == "fused_stage"
    x = (np.random.RandomState(t).randn(2, t, 1) * 0.3).astype(np.float32)
    ref = JS.apply_encoder(jb.params["encoder"], jnp.asarray(x), jb.cfg)
    got = PS.apply_encoder(pb.params["encoder"], torch.from_numpy(x).transpose(1, 2).contiguous(),
                           pb.cfg, units="fused_stage")
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("f", [3, 4])
def test_fused_decoder_matches_jax(f):
    jb, pb = _pair("small", "pallas_ct_fused")
    z = np.random.RandomState(f).randn(2, f, jb.cfg.latent_dim).astype(np.float32)
    ref = JS.apply_decoder(jb.params["decoder"], jnp.asarray(z), jb.cfg)
    got = PS.apply_decoder(pb.params["decoder"], torch.from_numpy(z).transpose(1, 2).contiguous(),
                           pb.cfg, units="fused_stage")
    np.testing.assert_allclose(got.transpose(1, 2).numpy(), np.asarray(ref), rtol=1e-4, atol=1e-5)


def _wav(cfg, frames, seed):
    t = frames * cfg.hop - cfg.hop // 3
    return (np.random.RandomState(seed).randn(1, t) * 0.3).astype(np.float32)


@pytest.mark.parametrize("backend", ["pallas_ct_fused", "pallas_fused"])
def test_f32_reconstruct_matches_jax(backend):
    jb, pb = _pair("small", backend)
    wav = _wav(jb.cfg, 4, seed=5)
    idx_j = JA.encode(jb, wav)
    np.testing.assert_array_equal(PA.encode(pb, wav), idx_j)
    np.testing.assert_allclose(PA.decode(pb, idx_j), JA.decode(jb, idx_j), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("backend", ["pallas_ct_fused", "pallas_fused"])
def test_bf16_serving_reconstruct_within_tolerance(backend):
    jb, pb = _pair("small", backend, serving=True)
    assert pb.cfg.compute_dtype == "bfloat16"
    wav = _wav(jb.cfg, 8, seed=6)
    idx_j, idx_p = JA.encode(jb, wav), PA.encode(pb, wav)
    assert (idx_j == idx_p).mean() >= 0.95
    ref, got = JA.decode(jb, idx_j), PA.decode(pb, idx_j)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 5e-2 * np.abs(ref).max()
    assert np.sqrt(np.mean((got - ref) ** 2)) <= 1e-2 * np.sqrt(np.mean(ref**2)) + 1e-6


# -- the selector --------------------------------------------------------------


@pytest.mark.parametrize("backend,route", [
    ("reference", "reference"), ("auto", "residual_stack"), ("pallas_ct", "residual_stack"),
    ("pallas_fused", "residual_stack_cl"), ("pallas_ct_fused", "fused_stage"),
])
def test_kernel_options_for_each_unit_backend(backend, route):
    """The route, and the weights carry only what it runs."""
    cfg = dataclasses.replace(PA.serving_config(get_config("small")), unit_backend=backend)
    assert KernelOptions.for_config(cfg) == KernelOptions(units=route, rvq=True)
    params, _ = W.from_jax_params(*_weights("small"), cfg)
    packed = {"residual_stack": "stack", "residual_stack_cl": "stack_cl", "fused_stage": "fused"}
    for part in ("encoder", "decoder"):
        for stage in params[part]["stages"]:
            extra = set(stage) - {"units", "down_act", "down", "up_act", "up"}
            assert extra == ({packed[route]} if route in packed else set())


@pytest.mark.parametrize("name", list_configs())
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_gate_matches_jax(name, dtype):
    """`pallas_ct_fused` runs K5 exactly where the JAX package's
    `_fused_boundary_mode` returns a mode, and `pallas_fused` runs K6 where
    its channels-last branch would (off the TPU it never does)."""
    jcfg = dataclasses.replace(jax_config(name), compute_dtype=dtype)
    for backend in ("pallas_ct_fused", "pallas_fused"):
        jc = dataclasses.replace(jcfg, unit_backend=backend)
        pc = get_config(name).__class__(**dataclasses.asdict(jc))
        route = PS.unit_route(pc)
        if backend == "pallas_ct_fused":
            assert (route == "fused_stage") == (
                JS._fused_boundary_mode(jc, jnp.dtype(dtype)) is not None)
        else:
            want = (jc.activation in ("snake", "snake_fast") and jc.causal
                    and jc.quant == "none" and jc.residual_kernel == 3)
            assert (route == "residual_stack_cl") == want
        assert route in ("reference", "fused_stage", "residual_stack_cl")


def test_fused_outside_its_gate_runs_op_by_op_in_both(monkeypatch):
    """tiny_test (width 4) fails the fused gate: both packages run the
    stages op by op, and the port calls no stage kernel wrapper."""
    def refuse(*args, **kwargs):
        raise AssertionError("a stage kernel wrapper was called")

    for mod, name in ((RS, "residual_stack"), (RS, "residual_stack_cl"), (FS, "fused_stage")):
        monkeypatch.setattr(mod, name, refuse)
    jb, pb = _pair("tiny_test", "pallas_ct_fused")
    assert pb.model.kernels.units == "reference"
    assert JS._fused_boundary_mode(jb.cfg, jnp.float32) is None
    wav = _wav(jb.cfg, 16, seed=7)
    idx_j = JA.encode(jb, wav)
    np.testing.assert_array_equal(PA.encode(pb, wav), idx_j)
    np.testing.assert_allclose(PA.decode(pb, idx_j), JA.decode(jb, idx_j), rtol=1e-3, atol=1e-4)


def test_cpu_paths_count_no_launches():
    kernels.reset_launches()
    for backend in ("pallas_ct_fused", "pallas_fused"):
        _, pb = _pair("small", backend, serving=True)
        PA.decode(pb, PA.encode(pb, _wav(pb.cfg, 2, seed=8)))
    assert kernels.LAUNCHES == dict.fromkeys(kernels.LAUNCHES, 0)


def test_kernel_options_refuse_unknown_route():
    with pytest.raises(ValueError, match="units must be one of"):
        KernelOptions(units="pallas_ct")
