"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Marked `cuda`: they skip without a card. On a machine with one (and no JAX),
run them without the JAX conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q

This file imports torch and the port only.
"""

import ctypes
import math

import pytest
import torch

from nsc_tpu_torch.configs import get_config
from nsc_tpu_torch.kernels import _build
from nsc_tpu_torch.kernels import fused_stage as FS
from nsc_tpu_torch.kernels import residual_stack as RS
from nsc_tpu_torch.kernels import rvq as KR
from nsc_tpu_torch.kernels import stft as KS
from torch_stage_shapes import PLANNER_REJECTS, SHIPPED, stage_shapes

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _units(c, units, dev, bias):
    g = torch.Generator(device=dev).manual_seed(c)
    return [
        {"conv1": {"w": torch.randn(c, c, 3, device=dev, generator=g) / (3 * c) ** 0.5,
                   "b": bias * torch.randn(c, device=dev, generator=g)},
         "conv2": {"w": torch.randn(c, c, 1, device=dev, generator=g) / c ** 0.5,
                   "b": bias * torch.randn(c, device=dev, generator=g)},
         "act1": 1 + 0.3 * torch.rand(c, device=dev, generator=g),
         "act2": 1 + 0.3 * torch.rand(c, device=dev, generator=g)}
        for _ in range(units)
    ]


def _stage(c, units, dtype, dev, bias, planes=False):
    return RS.pack_stage(_units(c, units, dev, bias), dtype, planes)


# (dtype, max abs err / max|ref|): float32 differs only in summation order;
# bf16 by rounding flips of an ulp (2^-7 relative) that later units carry.
_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


# (C, T, dilations, B): the tensor-core chain (bf16 snake_fast) at every
# base_fast width with dilations up to (1, 3, 9, 27, 81), T not a
# multiple of the tile, B = 1; widths that are not a multiple of 16 (12, 40)
# take the SIMT chain, as do float32 and snake
STACK_CASES = [(32, 3001, (1, 3, 9), 2), (12, 77, (1, 3), 2), (256, 700, (2, 5, 13), 2),
               (64, 2999, (1, 3, 9), 1), (128, 1500, (1, 3, 9, 27), 2),
               (256, 1001, (1, 3, 9), 1), (32, 2500, (1, 3, 9, 27, 81), 1),
               (40, 999, (1, 3, 9), 2)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("c,t,dil,b", STACK_CASES)
def test_residual_stack_kernel_matches_plain(dev, dtype, fast, c, t, dil, b):
    """Ragged T, a non-zero bias (so a stale halo would show in the first
    tile), several widths and dilation sets."""
    p = _stage(c, len(dil), dtype, dev, bias=0.5)
    x = (torch.randn(b, c, t, device=dev) * 0.5).to(dtype)
    got = RS.residual_stack(x, p, dil, fast)
    torch.cuda.synchronize()
    ref = RS.residual_stack_plain(x, p, dil, fast)
    err = (got.float() - ref.float()).abs()
    scale = max(1.0, ref.float().abs().max().item())
    assert err[..., :64].max().item() <= _TOL[dtype] * scale
    assert err.max().item() <= _TOL[dtype] * scale


def test_residual_stack_rejects_bad_inputs(dev):
    p = _stage(32, 3, torch.bfloat16, dev, bias=0.1)
    x = torch.randn(2, 32, 100, device=dev)  # float32 x, bf16 weights
    with pytest.raises(ValueError):
        RS.residual_stack(x, p, (1, 3, 9), True)
    with pytest.raises(ValueError):
        RS.residual_stack(x.to(torch.bfloat16)[..., ::2], p, (1, 3, 9), True)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("c,t,dil,b", [(32, 3001, (1, 3, 9), 2), (8, 777, (1, 3, 9, 27, 81), 2),
                                       (256, 700, (2, 5, 13), 2)] + STACK_CASES[3:])
def test_residual_stack_cl_kernel_matches_plain(dev, dtype, fast, c, t, dil, b):
    """K6 on (B, T, C) with float32 weights (as bf16 planes where its
    tensor-core chain reads them): ragged T, a non-zero bias, a halo wider
    than 128 (dilations up to 81)."""
    p = _stage(c, len(dil), torch.float32, dev, bias=0.5,
               planes=RS.tensor_cores(dtype, fast, c))
    x = (torch.randn(b, t, c, device=dev) * 0.5).to(dtype)
    got = RS.residual_stack_cl(x, p, dil, fast)
    torch.cuda.synchronize()
    ref = RS.residual_stack_cl_plain(x, p, dil, fast)
    err = (got.float() - ref.float()).abs()
    scale = max(1.0, ref.float().abs().max().item())
    assert err[:, :64].max().item() <= _TOL[dtype] * scale
    assert err.max().item() <= _TOL[dtype] * scale


def _boundary(dev, c_act, c_out, s, transposed, dtype):
    g = torch.Generator(device=dev).manual_seed(s)
    alpha = 1 + 0.3 * torch.rand(c_act, device=dev, generator=g)
    shape = (c_act, c_out, 2 * s) if transposed else (c_out, c_act, 2 * s)
    conv = {"w": torch.randn(*shape, device=dev, generator=g) / (2 * s * c_act) ** 0.5,
            "b": 0.3 * torch.randn(c_out, device=dev, generator=g)}
    pack = FS.pack_tail if transposed else FS.pack_head
    return pack(alpha, conv, dtype)


# (head stride, tail stride, C_in, C_mid, C_out): the serving path's strides
# at small widths, and a stage with neither
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fast", [True, False])
# and base_fast's own boundary shapes (strides 2, 4, 5 in and 5, 4, 2 out)
# at full width; (0, 2, 16, 16, 8) and (0, 0, 24, 24, 24) take the SIMT
# chain in bf16 (C_out 8, C_mid 24: not multiples of 16)
@pytest.mark.parametrize("sh,stl,c_in,c_mid,c_out", [
    (2, 0, 16, 32, 32), (4, 0, 32, 64, 64), (5, 0, 64, 128, 128),
    (0, 5, 64, 64, 32), (0, 4, 32, 32, 16), (0, 2, 16, 16, 8), (0, 0, 32, 32, 32),
    (2, 0, 32, 64, 64), (5, 0, 128, 256, 256), (0, 5, 256, 256, 128), (0, 4, 128, 128, 64),
    (0, 2, 64, 64, 32), (0, 0, 24, 24, 24),
])
def test_fused_stage_kernel_matches_plain(dev, dtype, fast, sh, stl, c_in, c_mid, c_out):
    dil = (1, 3, 9)
    p = FS.pack(_units(c_mid, len(dil), dev, bias=0.5),
                _boundary(dev, c_in, c_mid, sh, False, dtype) if sh else None,
                _boundary(dev, c_mid, c_out, stl, True, dtype) if stl else None,
                dtype, fast)
    t_in = 2999 if sh else 1001
    x = (torch.randn(2, c_in, t_in, device=dev) * 0.5).to(dtype)
    got = FS.fused_stage(x, p, dil, fast)
    torch.cuda.synchronize()
    ref = FS.fused_stage_plain(x, p, dil, fast)
    assert got.shape == ref.shape
    err = (got.float() - ref.float()).abs()
    scale = max(1.0, ref.float().abs().max().item())
    assert err[..., :64].max().item() <= _TOL[dtype] * scale
    assert err.max().item() <= _TOL[dtype] * scale


def test_tensor_core_chain_needs_the_weight_planes(dev):
    """Each chain reads one form of the float32 unit weights: the
    tensor-core chain refuses weights packed without planes, the SIMT chain
    weights packed as planes."""
    x = torch.randn(2, 100, 32, device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="planes"):
        RS.residual_stack_cl(x, _stage(32, 3, torch.float32, dev, bias=0.1), (1, 3, 9), True)
    with pytest.raises(ValueError, match="missing"):
        RS.residual_stack_cl(x.float(), _stage(32, 3, torch.float32, dev, bias=0.1, planes=True),
                             (1, 3, 9), True)
    xc = torch.randn(2, 32, 100, device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="planes"):
        FS.fused_stage(xc, FS.pack(_units(32, 3, dev, 0.1), None, None), (1, 3, 9), True)
    with pytest.raises(ValueError, match="missing"):
        FS.fused_stage(xc, FS.pack(_units(32, 3, dev, 0.1), None, None, torch.bfloat16, True),
                       (1, 3, 9), False)


def _kernel_plan(kind, args):
    """(tile, shared-memory bytes) as the kernels plan a launch, from their
    C entry points; args as `RS.stack_plan` or `FS.stage_plan` take them."""
    *dims, dtype, fast = args[:-1] if kind == "stack" else args
    plan = (ctypes.c_longlong * 2)()
    flags = (int(dtype == torch.bfloat16), int(fast))
    if kind == "stack":
        c, halo = dims
        err = _build.library().nsc_stack_plan(c, halo, *flags, args[-1], ctypes.addressof(plan))
    else:
        err = _build.library().nsc_fused_stage_plan(*dims, *flags, ctypes.addressof(plan))
    assert err == 0
    return tuple(plan)


@pytest.mark.parametrize("name", SHIPPED)
def test_python_planner_matches_the_kernels(dev, name):
    """The wrappers' shared-memory planner restates the kernels'; on every
    stage of every shipped config, in every instantiation, both give the
    same tile and bytes."""
    cfg = get_config(name)
    halo = sum(2 * d for d in cfg.dilations)
    for c_in, c, c_out, sh, stl in stage_shapes(cfg):
        for dtype in (torch.float32, torch.bfloat16):
            for fast in (True, False):
                for planes in (1, 3):
                    args = (c, halo, dtype, fast, planes)
                    assert _kernel_plan("stack", args) == RS.stack_plan(*args), args
                args = (c_in, c, c_out, sh, stl, halo, dtype, fast)
                assert _kernel_plan("fused", args) == FS.stage_plan(*args), args


@pytest.mark.parametrize("args", PLANNER_REJECTS)
def test_kernels_reject_what_the_python_planner_rejects(dev, args):
    kind, a = args
    assert _kernel_plan(kind, a)[0] == 0


def test_stage_kernels_reject_bad_inputs(dev):
    p = _stage(32, 3, torch.float32, dev, bias=0.1)
    x = torch.randn(2, 100, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        RS.residual_stack_cl(x, RS.pack_stage(_units(32, 3, dev, 0.1), torch.bfloat16),
                             (1, 3, 9), True)  # bf16 weights
    with pytest.raises(ValueError):
        RS.residual_stack_cl(x[:, ::2], p, (1, 3, 9), True)  # not contiguous
    with pytest.raises(ValueError):
        RS.residual_stack_cl(torch.randn(2, 100, 30, device=dev), p, (1, 3, 9), True)
    head = _boundary(dev, 16, 32, 2, False, torch.bfloat16)
    fp = FS.pack(_units(32, 3, dev, 0.1), head, None)
    xh = torch.randn(2, 16, 100, device=dev)
    with pytest.raises(ValueError):
        FS.fused_stage(xh, fp, (1, 3, 9), True)  # float32 x, bf16 head weights
    with pytest.raises(ValueError):
        FS.fused_stage(xh.to(torch.bfloat16)[:, :8].contiguous(), fp, (1, 3, 9), True)  # C_in 8 != 16
    with pytest.raises(ValueError):
        FS.fused_stage(torch.randn(2, 16, 100, device=dev),
                       FS.pack(_units(32, 3, dev, 0.1), None, None), (1, 3, 9), True)


@pytest.mark.parametrize("backend,key", [("pallas_ct_fused", "fused_stage"),
                                         ("pallas_fused", "residual_stack_cl")])
def test_opt_in_serving_paths_launch_their_kernels(dev, backend, key):
    """reconstruct on `small` (widths 16-256 pass the bf16 gate): the stage
    kernel x8, K2 (with its codebook split) and K3 once, K1 never."""
    import dataclasses

    from nsc_tpu_torch import api, kernels, weights

    cfg = dataclasses.replace(api.serving_config(api.get_config("small")), unit_backend=backend)
    b = api.bundle_from_jax(cfg, *weights.init_jax_layout(cfg, 0), device=dev)
    wav = torch.randn(2, 64 * cfg.hop, device=dev) * 0.1
    kernels.reset_launches()
    out = b.model.reconstruct(b.params, b.rvq, wav)
    torch.cuda.synchronize()
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    want.update({key: 8, "rvq_quantize": 1, "rvq_split_planes": 1, "rvq_dequantize": 1})
    assert kernels.LAUNCHES == want
    assert out.shape == wav.shape and torch.isfinite(out).all()


def test_float32_path_ignores_callers_tf32(dev):
    """With both TF32 flags on (cuDNN's is PyTorch's default), the float32
    path gives the indices and the waveform bits of a TF32-off run."""
    import numpy as np

    from nsc_tpu_torch import api

    b = api.load_model("base_fast", serving=False, device=dev)
    wav = np.random.RandomState(0).randn(2, 3 * 16000).astype(np.float32) * 0.1
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    runs = {}
    try:
        for on in (True, False):
            torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = on
            idx = api.encode(b, wav)
            runs[on] = (idx, api.decode(b, idx))
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    np.testing.assert_array_equal(runs[True][0], runs[False][0])
    np.testing.assert_array_equal(runs[True][1], runs[False][1])


# (M, n_q, K, D): the serving shape; a ragged M; widths whose rows go 4
# bytes a lane (D % 4 != 0: 129, 77, 3, 1) and 16 (64, 8, 4, 384); more
# books than one batch of loads (20, 40)
DEQUANTIZE_CASES = [(32000, 16, 1024, 128), (1001, 16, 1024, 128), (999, 4, 300, 129),
                    (333, 20, 64, 77), (100, 3, 16, 3), (50, 2, 16, 1), (777, 2, 256, 64),
                    (123, 40, 16, 8), (65, 5, 8, 4), (300, 4, 100, 384)]


@pytest.mark.parametrize("m,n_q,k,d", DEQUANTIZE_CASES)
def test_dequantize_kernel_bit_exact(dev, m, n_q, k, d):
    """Bit-exact against the plain version, also where indices fall outside
    [0, K) (they add nothing), and from books that are not 16-byte aligned."""
    from nsc_tpu_torch import kernels

    g = torch.Generator(device=dev).manual_seed(m * d)
    books = torch.randn(n_q, k, d, device=dev, generator=g)
    idx = torch.randint(0, k, (m, n_q), device=dev, generator=g, dtype=torch.int32)
    kernels.reset_launches()
    got = KR.dequantize(books, idx)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rvq_dequantize"] == 1
    assert torch.equal(got, KR.dequantize_plain(books, idx))
    bad = idx.clone()
    bad[::3, 0] = -1
    bad[1::2, -1] = k
    bad[::7, n_q // 2] = 1 << 30
    assert torch.equal(KR.dequantize(books, bad), KR.dequantize_plain(books, bad))
    flat = torch.randn(books.numel() + 1, device=dev, generator=g)
    shifted = flat[1:].view(n_q, k, d)  # 4 bytes past an aligned start
    assert torch.equal(KR.dequantize(shifted, idx), KR.dequantize_plain(shifted, idx))


def test_rvq_kernels_match_plain_with_ties(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    books = torch.randn(4, 300, 40, device=dev, generator=g)
    books[0, 200] = books[0, 7]  # duplicate codeword: the lower index wins
    z = torch.randn(1000, 40, device=dev, generator=g) * 2
    z[0] = books[0, 7]
    idx = KR.quantize(books, z)
    torch.cuda.synchronize()
    assert torch.equal(idx, KR.quantize_plain(books, z))
    assert idx[0, 0].item() == 7
    assert torch.equal(KR.dequantize(books, idx), KR.dequantize_plain(books, idx))


# (n_q, K, D) of every shipped config: base/base_fast, small, small_factorized,
# base_fast_f, tiny_test
SHIPPED_RVQ = [(16, 1024, 128), (2, 256, 64), (2, 256, 16), (16, 1024, 32), (2, 16, 8)]


def _check_quantize_against_plain(dev, n_q, k, d, m):
    """On N(0, 1) books: an index may differ from the plain version only
    where the plain version's top-2 margin is a near-tie (1e-3, as
    chip_smoke.py's check). One split and one search launch per call."""
    from nsc_tpu_torch import kernels
    from nsc_tpu_torch.ops import rvq as rvq_ops
    from nsc_tpu_torch.ops.precision import float32_numerics

    g = torch.Generator(device=dev).manual_seed(m + k + d)
    books = torch.randn(n_q, k, d, device=dev, generator=g)
    z = torch.randn(m, d, device=dev, generator=g)
    kernels.reset_launches()
    idx = KR.quantize(books, z)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["rvq_quantize"] == kernels.LAUNCHES["rvq_split_planes"] == 1
    with float32_numerics():
        ref = KR.quantize_plain(books, z)
    assert idx.shape == ref.shape == (m, n_q) and idx.dtype == torch.int32
    diff = idx != ref
    bad = diff.any(dim=1).nonzero().flatten()
    if bad.numel():
        margins = rvq_ops.argmin_margins({"codebooks": books}, z[bad])
        first = diff[bad].int().argmax(dim=1)
        assert (margins[torch.arange(bad.numel(), device=dev), first] < 1e-3).all()


@pytest.mark.parametrize("n_q,k,d", SHIPPED_RVQ)
@pytest.mark.parametrize("m", [1, 333, 32000])
def test_quantize_kernel_matches_plain_at_shipped_shapes(dev, n_q, k, d, m):
    from nsc_tpu_torch.configs import get_config

    assert any((c.num_quantizers, c.codebook_size, c.codebook_dim) == (n_q, k, d)
               for c in map(get_config, SHIPPED))
    _check_quantize_against_plain(dev, n_q, k, d, m)


# widths past the resident plan's 128: chip_smoke.py's two (8 x 256 and
# 4 x 384 at 1024 codes), the first padded width over 128 (D 129 -> 144,
# a 16-dim last stage), and 1024
@pytest.mark.parametrize("n_q,k,d,m", [(8, 1024, 256, 32000), (4, 1024, 384, 32000),
                                       (8, 1024, 256, 333), (2, 300, 129, 1000),
                                       (3, 200, 1024, 700)])
def test_quantize_kernel_matches_plain_at_wide_widths(dev, n_q, k, d, m):
    assert KR.quantize_plan(m, d)["plan"] == "streamed"
    _check_quantize_against_plain(dev, n_q, k, d, m)


@pytest.mark.parametrize("k", [16, 200])
def test_quantize_kernel_never_chooses_padded_codes(dev, k):
    g = torch.Generator(device=dev).manual_seed(k)
    books = torch.randn(2, k, 8, device=dev, generator=g)
    books += torch.sign(books) * 4.0
    z = torch.cat([torch.zeros(5, 8, device=dev), torch.randn(60, 8, device=dev, generator=g) * 0.01])
    idx = KR.quantize(books, z)
    torch.cuda.synchronize()
    assert int(idx.max()) < k
    assert torch.equal(idx, KR.quantize_plain(books, z))


@pytest.mark.parametrize("n_q,k,d", SHIPPED_RVQ + [(3, 300, 40)])
def test_quantize_split_kernel_matches_codebook_planes(dev, n_q, k, d):
    """The split kernel writes the planes `codebook_planes` computes, bit
    for bit, zero past K and D."""
    g = torch.Generator(device=dev).manual_seed(k * d)
    books = torch.randn(n_q, k, d, device=dev, generator=g) * 3
    kp, dp = KR.padded_shape(k, d)
    planes = torch.empty(n_q, 3, kp, dp, dtype=torch.bfloat16, device=dev)
    err = _build.library().nsc_rvq_split_planes(books.data_ptr(), planes.data_ptr(), n_q, k, d,
                                                kp, dp, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    assert err == 0
    assert torch.equal(planes.view(torch.int16), KR.codebook_planes(books).view(torch.int16))


def test_quantize_kernel_plan_and_scores(dev):
    """At M = 32000 the persistent grid is one wave of whole blocks; at
    every padded width 16-1024 the plan is resident up to 128 and streamed
    above, its shared memory (213,504 bytes from 128 on) within one block's.
    The winning scores, in either plan, are the rescored ones: within 2
    float32 ulps of the float64 score of the same (frame, book, index)."""
    plan = KR.quantize_plan(32000, 128)
    assert plan["tiles"] == 250 and plan["blocks_per_sm"] >= 1
    for dp in range(16, 1025, 16):
        plan = KR.quantize_plan(32000, dp)
        assert plan["plan"] == ("resident" if dp <= KR.RESIDENT_DIM else "streamed"), dp
        assert plan["smem_bytes"] <= KS.MAX_SMEM, dp
        assert dp < KR.RESIDENT_DIM or plan["smem_bytes"] == 213504, dp
        assert plan["blocks"] == min(plan["tiles"], plan["blocks_per_sm"] * plan["sms"]), dp
    for d in (128, 256):
        g = torch.Generator(device=dev).manual_seed(5)
        _check_scores(torch.randn(4, 1024, d, device=dev, generator=g),
                      torch.randn(3000, d, device=dev, generator=g))


def _f32_ulp(x):
    """The float32 spacing at |x| (float64 x), as float64."""
    a = x.abs().float()
    return (torch.nextafter(a, torch.full_like(a, float("inf"))) - a).double()


def _check_scores(books, z):
    """K2's winning scores within 2 float32 ulps of the float64 score of the
    same (frame, book, index), and its pick's float64 score within 2 ulps of
    the book's float64 best, on the kernel's own residuals."""
    idx, best = KR.quantize_with_scores(books, z)
    assert torch.equal(idx, KR.quantize(books, z))
    csq = KR.codeword_sq_norms(books)
    r = z
    for q in range(books.shape[0]):
        i = idx[:, q].long()
        c = books[q][i]
        s64 = csq[q][i].double() - 2.0 * (r.double() * c.double()).sum(-1)
        assert ((best[:, q].double() - s64).abs() <= 2 * _f32_ulp(s64)).all(), q
        full = csq[q].double()[None, :] - 2.0 * (r.double() @ books[q].double().t())
        low = full.min(dim=1).values
        assert ((s64 - low) <= 2 * _f32_ulp(low)).all(), q
        r = r - c


@pytest.mark.parametrize("d", [128, 256])
def test_quantize_rescoring_at_trained_latent_scale(dev, d):
    """Frames of norm ~50 and books drawn near them (scores ~-2.5e3, where
    a float32 ulp is ~2.4e-4 and the tensor-core scores alone miss the
    float64 argmin by several ulps): K2's picks and winning scores against
    float64, in the resident (128) and the streamed (256) plan."""
    g = torch.Generator(device=dev).manual_seed(d)
    z = torch.randn(6000, d, device=dev, generator=g) * (50.0 / d ** 0.5)
    pick = torch.randint(0, 6000, (2, 1024), device=dev, generator=g)
    books = z[pick] + torch.randn(2, 1024, d, device=dev, generator=g) * (5.0 / d ** 0.5)
    _check_scores(books.contiguous(), z)


# the training step's STFT launches: five resolutions at hop n_fft/4 (the
# mel STFT is the n_fft 1024 shape), on B=64 x 1 s
@pytest.mark.parametrize("n_fft", [2048, 1024, 512, 256, 128])
def test_stft_kernel_matches_plain_at_slice_shapes(dev, n_fft):
    g = torch.Generator(device=dev).manual_seed(n_fft)
    x = torch.randn(64, 16000, device=dev, generator=g) * 0.3
    got = KS.stft_magnitude(x, n_fft, n_fft // 4)
    torch.cuda.synchronize()
    ref = KS.stft_magnitude_plain(x, n_fft, n_fft // 4)
    assert got.shape == ref.shape == (64, 1 + 16000 // (n_fft // 4), n_fft // 2 + 1)
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


# the smallest n_fft, small and large ones (4096 is twice the slice's
# largest), with a T that no hop divides
@pytest.mark.parametrize("n_fft,hop,t", [(2, 1, 997), (16, 4, 16001), (16, 5, 997),
                                         (4096, 1024, 16001),
                                         (4096, 333, 9000), (1024, 256, 15999)])
def test_stft_kernel_matches_plain_at_supported_extremes(dev, n_fft, hop, t):
    g = torch.Generator(device=dev).manual_seed(t)
    x = torch.randn(3, t, device=dev, generator=g) * 0.3
    got = KS.stft_magnitude(x, n_fft, hop)
    torch.cuda.synchronize()
    ref = KS.stft_magnitude_plain(x, n_fft, hop)
    assert got.shape == ref.shape == (3, 1 + t // hop, n_fft // 2 + 1)
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


# every power of two the FFT route takes, B = 1, a T that no hop divides
@pytest.mark.parametrize("n_fft", [16, 32, 64, 128, 256, 512, 1024, 2048, 4096])
def test_stft_fft_route_matches_plain_at_every_power_of_two(dev, n_fft):
    from nsc_tpu_torch import kernels

    g = torch.Generator(device=dev).manual_seed(n_fft)
    hop, t = n_fft // 4, 3 * n_fft + 101
    x = torch.randn(1, t, device=dev, generator=g) * 0.3
    kernels.reset_launches()
    got = KS.stft_magnitude(x, n_fft, hop)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["stft_magnitude"] == 1
    assert kernels.LAUNCHES["stft_magnitude_bluestein"] == 0
    assert kernels.LAUNCHES["stft_magnitude_bluestein_cluster"] == 0
    assert kernels.LAUNCHES["stft_magnitude_bluestein_global"] == 0
    ref = KS.stft_magnitude_plain(x, n_fft, hop)
    assert got.shape == ref.shape == (1, 1 + t // hop, n_fft // 2 + 1)
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()


def _frames64(x, n_fft, hop):
    """Float64 frames of x (reflect-padded, as `frame_signal`) times the
    float64 window: the yardstick's input."""
    from nsc_tpu_torch.ops import stft as S

    return S.frame_signal(x.double(), n_fft, hop) * S.hann_window(n_fft, x.device, torch.float64)


def _rfft64(x, n_fft, hop):
    """Magnitudes of float64 `torch.fft.rfft` of those frames, and the
    spectrum: the float64 yardstick of these tests (the port never calls it)."""
    z = torch.fft.rfft(_frames64(x, n_fft, hop), dim=-1)
    return torch.sqrt(z.real ** 2 + z.imag ** 2 + 1e-8), z


def _launch_counted(x, n_fft, hop, route):
    """The wrapper's magnitudes, after checking that it launched `route`'s
    kernel once and no other K4 kernel."""
    from nsc_tpu_torch import kernels

    kernels.reset_launches()
    got = KS.stft_magnitude(x, n_fft, hop)
    torch.cuda.synchronize()
    assert {name: kernels.LAUNCHES[name] for name in KS.COUNTERS.values()} == {
        name: int(name == route) for name in KS.COUNTERS.values()}
    return got


def _within_ulps_of_float64(got, x, n_fft, hop, ulps=2.0):
    m64, _ = _rfft64(x, n_fft, hop)
    a = m64.float()
    ulp = (torch.nextafter(a, torch.full_like(a, float("inf"))) - a).double()
    return ((got.double() - m64).abs() / ulp).max().item() <= ulps


# even n_fft whose half factors into 2, 3, 5, 7 take the FFT route: the
# speech windows, 1568 = 2^5 7^2, 6000, 8192, 11520, 12000 and the largest
# the one-buffer plan admits (28812 = 4 x 3 x 7^4), B = 2 and T that no hop
# divides; with the 25 ms window at 16 kHz on 1 s and at hop 160
@pytest.mark.parametrize("n_fft,hop,t", [(120, 30, 2017), (320, 80, 3001), (400, 100, 16000),
                                         (400, 160, 3001), (480, 120, 4001), (882, 220, 4001),
                                         (960, 240, 6001), (1200, 300, 6001), (1568, 392, 5001),
                                         (2400, 600, 16001), (6000, 1500, 16001),
                                         (8192, 2048, 16001), (11520, 2880, 16001),
                                         (12000, 3000, 16000), (28812, 7203, 40001)])
def test_stft_mixed_radix_route_matches_plain_and_float64(dev, n_fft, hop, t):
    """Launches `stft_magnitude` (not the DFT); within 1e-4 of the peak of
    the plain version, and every magnitude within 2 float32 ulps of float64."""
    g = torch.Generator(device=dev).manual_seed(t + n_fft)
    x = torch.randn(2, t, device=dev, generator=g) * 0.3
    got = _launch_counted(x, n_fft, hop, "stft_magnitude")
    ref = KS.stft_magnitude_plain(x, n_fft, hop)
    assert got.shape == ref.shape == (2, 1 + t // hop, n_fft // 2 + 1)
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    assert _within_ulps_of_float64(got, x, n_fft, hop)


# the chirp-z route: odd n_fft (3, 17, 441 = 3^2 7^2, the largest, 7203),
# even ones below the FFT's 16 (2, 8), a half with a prime factor above 7
# (2018 = 2 x 1009, 10006 = 2 x 5003) and the largest even one (14404 = 4 x
# 3601); B = 2, T that no hop divides or that one does
@pytest.mark.parametrize("n_fft,hop,t", [(2, 1, 997), (3, 1, 60), (8, 2, 501), (17, 4, 3000),
                                         (441, 110, 16000), (2018, 504, 16001),
                                         (7203, 1800, 16000), (10006, 2501, 16001),
                                         (14404, 3601, 16001)])
def test_stft_bluestein_route_matches_plain_and_float64(dev, n_fft, hop, t):
    """Launches `stft_magnitude_bluestein`; within 1e-4 of the peak of the
    plain version, and every magnitude within 2 float32 ulps of float64."""
    g = torch.Generator(device=dev).manual_seed(t + n_fft)
    x = torch.randn(2, t, device=dev, generator=g) * 0.3
    got = _launch_counted(x, n_fft, hop, "stft_magnitude_bluestein")
    ref = KS.stft_magnitude_plain(x, n_fft, hop)
    assert got.shape == ref.shape
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    assert _within_ulps_of_float64(got, x, n_fft, hop)


# the chirp-z cluster route: odd n_fft above the one-block plan's limit
# (7205, 8191: C 2; 31999: C 8), an even one whose half is not smooth above
# it (14410 = 2 x 5 x 11 x 131: C 2), a smooth even one above the FFT's
# one-buffer limit (30000: C 4); B = 2, T that no hop divides or that one does
@pytest.mark.parametrize("n_fft,hop,t", [(8191, 2048, 16000), (7205, 1801, 16001),
                                         (14410, 3602, 16001), (30000, 7500, 40000),
                                         (31999, 8000, 40001)])
def test_stft_bluestein_cluster_route_matches_plain_and_float64(dev, n_fft, hop, t):
    """Launches `stft_magnitude_bluestein_cluster`; within 1e-4 of the peak
    of the plain version, and every magnitude within 2 float32 ulps of
    float64."""
    g = torch.Generator(device=dev).manual_seed(t + n_fft)
    x = torch.randn(2, t, device=dev, generator=g) * 0.3
    got = _launch_counted(x, n_fft, hop, "stft_magnitude_bluestein_cluster")
    ref = KS.stft_magnitude_plain(x, n_fft, hop)
    assert got.shape == ref.shape
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    assert _within_ulps_of_float64(got, x, n_fft, hop)


# the cluster route's edges: the largest odd n_fft (57599) and even one
# (115200 = 2^9 3^2 5^2: M 115,200 on 8 blocks of 225 KB), against float64
# only (the plain version's bases there take 13-53 GB)
@pytest.mark.parametrize("n_fft,hop,t", [(57599, 14400, 64000), (115200, 28800, 120001)])
def test_stft_bluestein_cluster_route_at_its_edges(dev, n_fft, hop, t):
    g = torch.Generator(device=dev).manual_seed(t)
    x = torch.randn(1, t, device=dev, generator=g) * 0.3
    got = _launch_counted(x, n_fft, hop, "stft_magnitude_bluestein_cluster")
    assert KS.chirp_plan(n_fft)[1:3] == (115200, 8)
    assert _within_ulps_of_float64(got, x, n_fft, hop)


@pytest.mark.parametrize("n_fft,clusters", [(441, 2), (441, 4), (441, 8), (2018, 2), (2018, 4),
                                            (2018, 8), (17, 8)])
def test_stft_bluestein_cluster_kernel_is_the_one_block_kernel(dev, n_fft, clusters):
    """Given the same M and pass list (`bluestein_cluster_plan(n_fft, C)`),
    the cluster kernel's magnitudes and spectrum are the one-block chirp-z
    kernel's bit for bit."""
    g = torch.Generator(device=dev).manual_seed(n_fft + clusters)
    x = torch.randn(3, 4 * n_fft + 37, device=dev, generator=g) * 0.3
    plan = KS.bluestein_cluster_plan(n_fft, clusters)
    one = KS.launch_chirp(x, n_fft, n_fft // 4, (plan[0], plan[1], 1, plan[3]), spectrum=True)
    got = KS.launch_chirp(x, n_fft, n_fft // 4, plan, spectrum=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(one, got))


def test_stft_bluestein_cluster_plan_and_launcher(dev):
    """The cluster kernel's own plan (`nsc_stft_bluestein_cluster_plan`):
    512 threads a block, 16 M / C bytes, and at least one cluster on the
    card at every C up to the largest M; a C not 2, 4 or 8 or an M it does
    not divide refused. Its launcher refuses (cudaErrorInvalidValue, 1) an
    M below 2L - 1, a pass list that is not a transform of M or that does
    not end with C's passes, and a C it was not given the plan of; a launch
    after each runs and equals the wrapper's."""
    def plan(m, c):
        out = (ctypes.c_longlong * 3)()
        rc = _build.library().nsc_stft_bluestein_cluster_plan(m, c, out)
        return rc, out[0], out[1], out[2]

    for m, c in ((16384, 2), (22400, 2), (30240, 4), (64000, 8), (115200, 8)):
        rc, threads, nbytes, active = plan(m, c)
        assert (rc, threads, nbytes) == (0, 512, 16 * m // c) and active >= 1, (m, c)
    assert plan(16384, 3)[0] != 0 and plan(16386, 4)[0] != 0

    from nsc_tpu_torch.ops import stft as S

    n_fft, hop, t = 8191, 2048, 16000
    x = torch.randn(2, t, device=dev)
    _, m, c, passes = KS.chirp_plan(n_fft)
    tables = [t_.contiguous() for t_ in KS.bluestein_tables(n_fft, dev)]
    win = S.hann_window(n_fft, dev, torch.float64).contiguous()
    frames = S.num_frames(t + 2 * (n_fft // 2), n_fft, hop, center=False)
    out = torch.zeros(2, frames, n_fft // 2 + 1, device=dev)

    def launch(m_, c_, radices):
        rc = _build.library().nsc_stft_magnitude_bluestein_cluster(
            x.data_ptr(), win.data_ptr(), *(t_.data_ptr() for t_ in tables), out.data_ptr(),
            None, None, 2, t, n_fft, hop, frames, m_, c_, KS.pack_passes(radices),
            torch.cuda.current_stream(dev).cuda_stream)
        torch.cuda.synchronize()
        return rc

    assert (m, c, passes[-1]) == (16384, 2, 2)
    assert launch(8192, 2, (4,) * 6 + (2,)) == 1  # 8192 < 2 x 8191 - 1
    for c_, radices in ((2, (4,) * 7), (2, (2,) + (4,) * 6), (4, passes), (3, passes),
                        (2, passes[:-1])):
        assert launch(m, c_, radices) == 1, (c_, radices)
    assert launch(m, c, passes) == 0 and torch.equal(out, KS.launch(x, n_fft, hop))


# the two-level route: an odd n_fft beyond an 8-block cluster (60001), B =
# 2 rows of 4 s, against its plain version (the host builds 14.4 GB of
# float32 bases, dropped after the test)
@pytest.mark.parametrize("n_fft,hop,t", [(60001, 15000, 64000)])
def test_stft_bluestein_global_route_matches_plain(dev, n_fft, hop, t):
    """Launches `stft_magnitude_bluestein_global`; within 1e-4 of the peak
    of the plain version, and every magnitude within 2 float32 ulps of
    float64."""
    from nsc_tpu_torch.ops import stft as S

    g = torch.Generator(device=dev).manual_seed(t)
    x = torch.randn(2, t, device=dev, generator=g) * 0.3
    got = _launch_counted(x, n_fft, hop, "stft_magnitude_bluestein_global")
    ref = KS.stft_magnitude_plain(x, n_fft, hop)
    assert got.shape == ref.shape
    assert (got - ref).abs().max().item() <= 1e-4 * ref.abs().max().item()
    assert _within_ulps_of_float64(got, x, n_fft, hop)
    S._dft_basis_np.cache_clear()


# the two-level route against float64 only: its first odd and even n_fft
# (57601, 115202 = 2 x 57601), 131072 = 2^17 (M 131,072, C 32), 262145 odd
# (M 524,880, C 135), the largest odd and even n_fft of its reach (M 2^20, C
# 256), and chip_smoke.py's shapes (K4_GLOBAL_SHAPES); B 1-4, T that no hop
# divides or that one does
@pytest.mark.parametrize("n_fft,hop,b,t", [(57601, 14400, 2, 64000), (60001, 15000, 4, 64000),
                                           (115202, 28800, 4, 64000), (131072, 32768, 4, 128000),
                                           (262145, 65536, 2, 320000), (524287, 131072, 1, 600001),
                                           (1 << 20, 1 << 18, 1, 1 << 20)])
def test_stft_bluestein_global_route_against_float64(dev, n_fft, hop, b, t):
    g = torch.Generator(device=dev).manual_seed(t + n_fft)
    x = torch.randn(b, t, device=dev, generator=g) * 0.3
    got = _launch_counted(x, n_fft, hop, "stft_magnitude_bluestein_global")
    assert KS.chirp_plan(n_fft) == KS.bluestein_global_plan(n_fft)
    assert _within_ulps_of_float64(got, x, n_fft, hop)


@pytest.mark.parametrize("n_fft,clusters", [(441, 2), (441, 4), (441, 8), (441, 16), (2018, 2),
                                            (2018, 4), (2018, 8), (2018, 16), (17, 16),
                                            (2018, 64)])
def test_stft_bluestein_global_kernels_are_the_one_block_kernel(dev, n_fft, clusters):
    """Given the same M and pass list (`bluestein_global_plan(n_fft, C)`),
    the two-level route's magnitudes and spectrum are the one-block chirp-z
    kernel's bit for bit."""
    g = torch.Generator(device=dev).manual_seed(n_fft + clusters)
    x = torch.randn(3, 4 * n_fft + 37, device=dev, generator=g) * 0.3
    plan = KS.bluestein_global_plan(n_fft, clusters)
    one = KS.launch_chirp(x, n_fft, n_fft // 4, (plan[0], plan[1], 1, plan[3]), spectrum=True)
    got = KS.launch_global(x, n_fft, n_fft // 4, plan, spectrum=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(one, got))


@pytest.mark.parametrize("n_fft,hop", [(8191, 2048), (30000, 7500), (31999, 8000)])
def test_stft_bluestein_global_kernels_are_the_cluster_kernel(dev, n_fft, hop):
    """At the cluster route's own plans (C 2, 4 and 8), the two-level route's
    magnitudes and spectrum are the cluster kernel's bit for bit."""
    g = torch.Generator(device=dev).manual_seed(n_fft)
    x = torch.randn(2, 2 * n_fft + 37, device=dev, generator=g) * 0.3
    plan = KS.bluestein_cluster_plan(n_fft)
    assert KS.bluestein_global_plan(n_fft, plan[2]) == plan
    cluster = KS.launch_chirp(x, n_fft, hop, plan, spectrum=True)
    got = KS.launch_global(x, n_fft, hop, plan, spectrum=True)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(cluster, got))


@pytest.mark.parametrize("n_fft,hop", [(60001, 15000), (131072, 32768)])
def test_stft_bluestein_global_spectrum_outputs(dev, n_fft, hop):
    """With the spectrum kept, the magnitudes are those without it, sqrt(re^2
    + im^2 + 1e-8) of it, and the spectrum is float64 rfft's within 2^-23
    of the frame's peak; the scratch taken in chunks of one transform
    computes the same values bit for bit."""
    g = torch.Generator(device=dev).manual_seed(n_fft)
    x = torch.randn(2, 2 * n_fft + 1001, device=dev, generator=g) * 0.3
    mag, re, im = KS.launch(x, n_fft, hop, spectrum=True)
    torch.cuda.synchronize()
    assert torch.equal(mag, KS.launch(x, n_fft, hop))
    torch.testing.assert_close(mag, torch.sqrt(re * re + im * im + 1e-8), rtol=1e-6, atol=0)
    m64, z = _rfft64(x, n_fft, hop)
    peak = m64.amax(-1, keepdim=True)
    for got, ref in ((re, z.real), (im, z.imag)):
        assert ((got.double() - ref).abs() / peak).max().item() <= 2.0 ** -23
    bytes_ = KS.SCRATCH_BYTES
    try:
        KS.SCRATCH_BYTES = 16 * KS.bluestein_global_plan(n_fft)[1]
        assert KS.global_chunk(10, KS.bluestein_global_plan(n_fft)[1]) == 1
        chunked = KS.launch(x, n_fft, hop, spectrum=True)
    finally:
        KS.SCRATCH_BYTES = bytes_
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip((mag, re, im), chunked))


def test_stft_bluestein_global_plan_and_launcher(dev):
    """The two-level route's own plan (`nsc_stft_bluestein_global_plan`):
    256 threads a block, `global_tile(C)` offsets a tile, 16 M / C bytes a
    share block and 16 kt C a tile block; a C below 2 or above GLOBAL_MAX_C
    or an M it does not divide refused. Its launcher refuses
    (cudaErrorInvalidValue, 1) an M below 2L - 1, a pass list that is not a
    transform of M or with no prefix of M / C, a C that does not divide M
    and a chunk below 1; a launch after each runs and equals the
    wrapper's. The wrapper raises beyond the route's reach."""
    def plan(m, c):
        out = (ctypes.c_longlong * 4)()
        rc = _build.library().nsc_stft_bluestein_global_plan(m, c, out)
        return rc, out[0], out[1], out[2], out[3]

    for m, c in ((120960, 30), (115248, 42), (131072, 32), (524880, 135), (1 << 20, 256),
                 (896, 16), (2048, 64)):
        kt = KS.global_tile(c)
        assert plan(m, c) == (0, 256, kt, 16 * m // c, 16 * kt * c), (m, c)
    assert plan(120960, 1)[0] != 0 and plan(120961, 30)[0] != 0
    assert plan(1817 * 64, 1817)[0] != 0

    from nsc_tpu_torch.ops import stft as S

    n_fft, hop, t = 60001, 15000, 64000
    x = torch.randn(2, t, device=dev)
    _, m, c, passes = KS.bluestein_global_plan(n_fft)
    tables = [t_.contiguous() for t_ in KS.bluestein_tables(n_fft, dev)]
    win = S.hann_window(n_fft, dev, torch.float64).contiguous()
    frames = S.num_frames(t + 2 * (n_fft // 2), n_fft, hop, center=False)
    out = torch.zeros(2, frames, n_fft // 2 + 1, device=dev)
    scratch = torch.empty(2 * frames, m, 2, dtype=torch.float64, device=dev)

    def launch(m_, c_, chunk, radices):
        rc = _build.library().nsc_stft_magnitude_bluestein_global(
            x.data_ptr(), win.data_ptr(), *(t_.data_ptr() for t_ in tables), scratch.data_ptr(),
            out.data_ptr(), None, None, 2, t, n_fft, hop, frames, m_, c_, chunk,
            KS.pack_passes(radices), torch.cuda.current_stream(dev).cuda_stream)
        torch.cuda.synchronize()
        return rc

    assert (m, c) == (120960, 30)
    assert launch(115200, 30, 1, KS.transform_passes(3840) + (2, 3, 5)) == 1  # < 2 x 60001 - 1
    for c_, chunk, radices in ((30, 1, KS.transform_passes(m)), (30, 1, (2,) + passes),
                               (29, 1, passes), (1, 1, passes), (30, 0, passes),
                               (32, 1, passes)):
        assert launch(m, c_, chunk, radices) == 1, (c_, chunk, radices)
    assert launch(m, c, 3, passes) == 0 and torch.equal(out, KS.launch(x, n_fft, hop))
    with pytest.raises(ValueError, match="reach"):
        KS.launch(torch.zeros(1, 600000, device=dev), 524289, 131072)


@pytest.mark.parametrize("n_fft,hop", [(2048, 512), (128, 32), (400, 100), (441, 110),
                                       (2018, 504), (8191, 2048)])
def test_stft_kernel_spectrum_outputs(dev, n_fft, hop):
    """With the spectrum kept, the magnitudes are sqrt(re^2 + im^2 + 1e-8) of
    it and the spectrum is the plain path's within the forward tolerance."""
    from nsc_tpu_torch.ops import stft as S

    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(3, 5001, device=dev, generator=g) * 0.3
    mag, re, im = KS.launch(x, n_fft, hop, spectrum=True)
    torch.cuda.synchronize()
    assert torch.equal(mag, KS.launch(x, n_fft, hop))
    torch.testing.assert_close(mag, torch.sqrt(re * re + im * im + 1e-8), rtol=1e-6, atol=0)
    frames = S.frame_signal(x, n_fft, hop) * S.hann_window(n_fft, dev)
    cos_b, sin_b = S.dft_basis(n_fft, dev)
    for got, ref in ((re, frames @ cos_b), (im, frames @ sin_b)):
        assert (got - ref).abs().max().item() <= 1e-4 * mag.max().item()


def _fft_plan(n_fft, hop):
    """The kernel's own plan (`nsc_stft_fft_plan`): (rc, frames per block,
    bytes)."""
    plan = (ctypes.c_longlong * 2)()
    rc = _build.library().nsc_stft_fft_plan(n_fft, hop, plan)
    return rc, plan[0], plan[1]


def _fft_launch(x, n_fft, hop, radices):
    """The FFT kernel called with a given pass list: (rc, magnitudes)."""
    from nsc_tpu_torch.ops import stft as S

    b, t = x.shape
    n_frames = 1 + t // hop
    out = torch.zeros(b, n_frames, n_fft // 2 + 1, device=x.device)
    win = S.hann_window(n_fft, x.device, torch.float64).contiguous()
    tw = KS.twiddles(n_fft, x.device).contiguous()
    packed = sum(r << (4 * i) for i, r in enumerate(radices))
    order = torch.from_numpy(KS.digit_reversed(tuple(radices)).astype("int32")).to(x.device)
    rc = _build.library().nsc_stft_magnitude_fft(
        x.data_ptr(), win.data_ptr(), tw.data_ptr(), order.data_ptr(), out.data_ptr(), None, None,
        b, t, n_fft, hop, n_frames, packed, torch.cuda.current_stream(x.device).cuda_stream)
    torch.cuda.synchronize()
    return rc, out


def test_stft_fft_plan_fits_one_block(dev):
    """The FFT kernel's own plan at the wrapper's pass lists: frames per
    block a power of two, at most 4096 / n_fft, shared memory within one
    block's, passes whose radices multiply to n_fft/2, up to 8192, 11520,
    12000 and 28812 (the largest n_fft the route takes). The one-frame plan
    (one buffer, 8 n_fft bytes) fits at FFT_MAX and not at the next even
    n_fft: the wrapper's limit is the kernel's."""
    for n_fft, hop in ((16, 4), (16, 1000), (128, 32), (512, 1), (1024, 256), (2048, 512),
                       (4096, 1024), (4096, 4096), (400, 100), (882, 1), (6000, 1500),
                       (8192, 2048), (8192, 1), (11520, 2880), (12000, 3000), (28812, 7203)):
        rc, ft, smem = _fft_plan(n_fft, hop)
        assert rc == 0, n_fft
        assert 1 <= ft <= max(1, 4096 // n_fft) and ft & (ft - 1) == 0, (n_fft, hop, ft)
        assert smem == 8 * ft * n_fft <= KS.MAX_SMEM, (n_fft, hop, smem)
        radices = KS.fft_passes(n_fft)
        assert math.prod(radices) == n_fft // 2 and set(radices) <= {2, 3, 4, 5, 7}, radices
    assert _fft_plan(8192, 2048)[1:] == (1, 65536) and KS.fft_passes(8192) == (4,) * 6
    assert _fft_plan(11520, 2880)[1:] == (1, 92160)
    assert _fft_plan(12000, 3000)[1:] == (1, 96000)
    assert KS.fft_passes(11520) == (4, 4, 4, 2, 3, 3, 5)
    assert KS.FFT_MAX % 2 == 0
    assert _fft_plan(KS.FFT_MAX, 1)[2] <= KS.MAX_SMEM < _fft_plan(KS.FFT_MAX + 2, 1)[2]
    for n_fft in (-2, 0, 1, 441):
        assert _fft_plan(n_fft, 1)[0] != 0, n_fft


def test_stft_fft_launcher_checks_the_pass_list(dev):
    """The launcher runs a pass list only where it is a transform of n_fft/2
    points (radices 2, 3, 4, 5, 7 multiplying to it): anything else is
    cudaErrorInvalidValue (1), and a plan over a block's shared memory
    fails at the attribute; a launch after either runs."""
    x = torch.randn(2, 4001, device=dev)
    for radices in ((4, 4, 2, 3), (4, 4, 2, 3, 5, 5), (4, 2, 5, 5, 1), (8, 5, 5), ()):
        assert _fft_launch(x, 400, 100, radices)[0] == 1, radices
    big = torch.randn(1, 40000, device=dev)
    assert _fft_launch(big, 32768, 8192, (4,) * 7)[0] != 0
    rc, got = _fft_launch(x, 400, 100, KS.fft_passes(400))
    assert rc == 0 and torch.equal(got, KS.launch(x, 400, 100))


def test_stft_bluestein_plan_and_launcher(dev):
    """The chirp-z kernel's own plan (`nsc_stft_bluestein_plan`): frames per
    block the largest power of two with frames x M <= 4096, 16 M bytes a
    frame, within a block's shared memory up to BLUESTEIN_MAX_M. Its
    launcher refuses an M below 2L - 1 and a pass list that is not a
    transform of M points (cudaErrorInvalidValue, 1); a launch after either
    runs and equals the wrapper's."""
    def plan(m):
        out = (ctypes.c_longlong * 2)()
        rc = _build.library().nsc_stft_bluestein_plan(m, out)
        return rc, out[0], out[1]

    for m, ft in ((1, 4096), (5, 512), (882, 4), (2025, 2), (2048, 2), (14406, 1)):
        assert plan(m) == (0, ft, 16 * ft * m), m
    assert plan(KS.BLUESTEIN_MAX_M)[2] <= KS.MAX_SMEM < plan(KS.BLUESTEIN_MAX_M + 1)[2]
    assert plan(0)[0] != 0

    x = torch.randn(2, 4001, device=dev)
    n_fft, hop = 441, 110
    _, m, passes = KS.bluestein_plan(n_fft)
    tables = [t.contiguous() for t in KS.bluestein_tables(n_fft, dev)]
    from nsc_tpu_torch.ops import stft as S

    win = S.hann_window(n_fft, dev, torch.float64).contiguous()
    frames = 1 + (4001 + 440 - 441) // hop
    out = torch.zeros(2, frames, n_fft // 2 + 1, device=dev)

    def launch(m_, radices):
        rc = _build.library().nsc_stft_magnitude_bluestein(
            x.data_ptr(), win.data_ptr(), *(t.data_ptr() for t in tables), out.data_ptr(), None,
            None, 2, 4001, n_fft, hop, frames, m_, KS.pack_passes(radices),
            torch.cuda.current_stream(dev).cuda_stream)
        torch.cuda.synchronize()
        return rc

    assert launch(875, KS.transform_passes(875)) == 1  # 875 < 2 x 441 - 1
    for radices in ((2, 3, 3, 7), (2, 3, 3, 7, 7, 1), (9, 2, 7, 7)):
        assert launch(m, radices) == 1, radices
    assert launch(m, passes) == 0 and torch.equal(out, KS.launch(x, n_fft, hop))


def test_stft_fft_plan_keeps_the_power_of_two_passes(dev):
    """At every power of two the pass list is the earlier kernel's, pass for
    pass (its loop, copied: radix-4 while 4 p <= n/2, then radix-2 where p <
    n/2), so the one-buffer kernel runs the same butterflies and twiddles;
    frames per block 4096 / n_fft (at least 1: one buffer of 8 n_fft bytes a
    frame, 32 KB a block up to 4096); the kernel given that copied pass list
    gives the wrapper's output bit for bit."""
    for n_fft in (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192):
        n2, p, passes = n_fft // 2, 1, []
        while 4 * p <= n2:
            passes.append(4)
            p *= 4
        if p < n2:
            passes.append(2)
        assert KS.fft_passes(n_fft) == tuple(passes), n_fft
        for hop in (1, n_fft // 4, n_fft):
            assert _fft_plan(n_fft, hop)[1:] == (max(1, 4096 // n_fft),
                                                 8 * max(n_fft, 4096)), n_fft
        x = torch.randn(2, 3 * n_fft + 101, device=dev)
        rc, got = _fft_launch(x, n_fft, n_fft // 4, passes)
        assert rc == 0 and torch.equal(got, KS.launch(x, n_fft, n_fft // 4)), n_fft


def test_stft_function_gradient_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(4, 5000, device=dev, generator=g) * 0.3
    w = torch.rand(4, 1 + 5000 // 128, 257, device=dev, generator=g)
    grads = []
    for fn in (KS.stft_magnitude, KS.stft_magnitude_plain):
        xx = x.clone().requires_grad_(True)
        (fn(xx, 512, 128) * w).sum().backward()
        grads.append(xx.grad)
    assert (grads[0] - grads[1]).abs().max().item() <= 1e-4 * grads[1].abs().max().item()


def test_stft_wrapper_rejects_bad_inputs(dev):
    x = torch.randn(2, 3000, device=dev)
    with pytest.raises(ValueError):
        KS.stft_magnitude(x.double(), 256, 64)
    with pytest.raises(ValueError):
        KS.stft_magnitude(x[:, ::2], 256, 64)
    with pytest.raises(ValueError):
        KS.stft_magnitude(x[:, :100], 256, 64)  # shorter than the reflect pad
    for n_fft, hop in ((1, 1), (0, 4), (400, 0)):  # n_fft < 2; hop < 1
        with pytest.raises(ValueError):
            KS.stft_magnitude(torch.randn(2, 9000, device=dev), n_fft, hop)


def test_full_width_train_step_launches_the_kernels(dev):
    """One base_fast step at the TrainConfig defaults (batch 64 x 1 s, GAN
    with every discriminator): finite metrics, K4 x12 and K2 x1."""
    from nsc_tpu_torch import kernels
    from nsc_tpu_torch.configs import TrainConfig, get_config
    from nsc_tpu_torch.train import train as T

    cfg, tcfg = get_config("base_fast"), TrainConfig()
    model, state = T.init_train_state(cfg, tcfg, dev)
    step = T.make_train_step(model, tcfg)
    batch = torch.randn(64, 16000, device=dev) * 0.1
    kernels.reset_launches()
    state, metrics = step(state, batch)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"residual_stack": 0, "rvq_quantize": 1, "rvq_split_planes": 1,
                                "rvq_dequantize": 0, "stft_magnitude": 12,
                                "stft_magnitude_bluestein": 0,
                                "stft_magnitude_bluestein_cluster": 0,
                                "stft_magnitude_bluestein_global": 0, "residual_stack_cl": 0,
                                "fused_stage": 0, "int_mm": 0}
    assert all(torch.isfinite(v).item() for v in metrics.values())


def test_streaming_serving_bundle_launches_rvq_kernels_once_per_dispatch(dev):
    """StreamingEncoder/Decoder on a `small` serving bundle: K2 (with its
    split) once per encoder push, K3 once per decoder push, no stage
    kernel (the units run op by op)."""
    import numpy as np

    from nsc_tpu_torch import api, kernels, streaming

    b = api.load_model("small", serving=True, device=dev)
    hop = b.cfg.hop
    wav = (np.random.RandomState(0).randn(2, 12 * hop) * 0.1).astype(np.float32)
    enc = streaming.StreamingEncoder(b.model, b.params, b.rvq)
    dec = streaming.StreamingDecoder(b.model, b.params, b.rvq)
    kernels.reset_launches()
    blocks = enc.push_many([wav[:, : 4 * hop], wav[:, 4 * hop: 8 * hop]])
    blocks.append(enc.push(wav[:, 8 * hop:]))
    outs = dec.push_many(blocks[:2]) + [dec.push(blocks[2])]
    torch.cuda.synchronize()
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    want.update({"rvq_quantize": 2, "rvq_split_planes": 2, "rvq_dequantize": 2})
    assert kernels.LAUNCHES == want
    assert [o.shape for o in outs] == [(2, 4 * hop)] * 3
    assert all(np.isfinite(o).all() for o in outs)


def test_cli_runs_on_the_card_by_default(dev, tmp_path):
    """Without --device the CLI runs the model on CUDA: compress and
    decompress a WAV through the serving path of `small`."""
    import numpy as np

    from nsc_tpu_torch import bitstream
    from nsc_tpu_torch.__main__ import main
    from nsc_tpu_torch.utils import audio

    wav = tmp_path / "in.wav"
    audio.save_wav(str(wav), np.random.RandomState(0).randn(16000).astype(np.float32) * 0.1, 16000)
    assert main(["compress", str(wav), str(tmp_path / "a.nsc"), "--model", "small", "--serving"]) == 0
    assert main(["decompress", str(tmp_path / "a.nsc"), str(tmp_path / "b.wav"), "--model", "small",
                 "--serving"]) == 0
    header, idx = bitstream.deserialize((tmp_path / "a.nsc").read_bytes())
    assert idx.shape == (50, 2) and audio.load_wav(str(tmp_path / "b.wav"))[0].shape == (16000,)


def test_load_model_checkpoint_puts_every_tensor_on_the_card(dev):
    """The committed flagship export, serving and float32: every tensor of
    both bundles on cuda:0, the codebooks' fingerprint as in meta.json."""
    import os

    from nsc_tpu_torch import api, weights
    from nsc_tpu_torch.train import checkpoint as ckpt

    export = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "exports", "base_fast_synthetic2_48k_refit")
    for serving in (False, True):
        b = api.load_model("base_fast", checkpoint=export, serving=serving)
        devices = set()
        weights.tree_map(lambda t: devices.add(str(t.device)) if isinstance(t, torch.Tensor) else None,
                         (b.params, b.rvq))
        assert devices == {"cuda:0"}
        assert api.codebook_fingerprint(b.rvq) == ckpt.export_meta(export)["fingerprint"]


def test_snapshot_writer_keeps_the_state_at_submit(dev):
    """The loop's threaded writer copies the state as it was at `submit`,
    though the caller updates it in place right after (as the train step
    does); a write's exception comes back on the caller's thread."""
    from nsc_tpu_torch import weights
    from nsc_tpu_torch.train.loop import SnapshotWriter

    g = torch.Generator(device=dev).manual_seed(0)
    state = {"step": 3, "w": torch.randn(1 << 24, device=dev, generator=g),
             "m": [torch.randn(1000, device=dev, generator=g), None]}
    want = weights.tree_map(lambda x: x.cpu() if isinstance(x, torch.Tensor) else x, state)
    got = []
    writer = SnapshotWriter(dev)
    assert writer.threaded
    writer.submit(state, got.append)
    for _ in range(20):
        state["w"].mul_(1.5).add_(1.0)
    state["m"][0].zero_()
    writer.join()
    assert got[0]["step"] == 3 and got[0]["m"][1] is None
    assert got[0]["w"].device.type == "cpu"
    assert torch.equal(got[0]["w"], want["w"]) and torch.equal(got[0]["m"][0], want["m"][0])

    def fail(host):
        raise OSError("disk full")

    writer.submit(state, fail)
    with pytest.raises(OSError, match="disk full"):
        writer.join()
    writer.join()  # raised once


# the int8 product's CUDA route (im2col + torch._int_mm) at ragged shapes:
# Cin x k and Cout not multiples of 8, rows (N x T') at or below 16
INT8_CASES = [(1, 1, 10, 7, 8, 1, 1), (2, 3, 40, 5, 3, 2, 1), (1, 12, 9, 3, 1, 1, 3),
              (4, 32, 1000, 3, 32, 1, 9), (3, 5, 17, 4, 7, 2, 1), (1, 64, 4, 1, 16, 1, 1)]


@pytest.mark.parametrize("n,cin,t,k,cout,stride,dilation", INT8_CASES)
def test_int8_product_route_is_bit_exact(dev, n, cin, t, k, cout, stride, dilation):
    from nsc_tpu_torch import kernels
    from nsc_tpu_torch.ops import quant as Q

    g = torch.Generator(device=dev).manual_seed(n * cin + t)
    x8 = torch.randint(-127, 128, (n, cin, t + (k - 1) * dilation), device=dev, generator=g,
                       dtype=torch.int8)
    w8 = torch.randint(-127, 128, (cout, cin, k), device=dev, generator=g, dtype=torch.int8)
    kernels.reset_launches()
    got = Q.int_conv1d(x8, w8, stride, dilation)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["int_mm"] == 1
    assert torch.equal(got, Q.int_conv1d_plain(x8, w8, stride, dilation))
    wt = torch.randint(-127, 128, (cin, cout, 2 * stride), device=dev, generator=g,
                       dtype=torch.int8)
    assert torch.equal(Q.int_conv_transpose1d(x8, wt, stride),
                       Q.int_conv_transpose1d_plain(x8, wt, stride))


def test_int8_serving_bundle_launches(dev):
    """quantize_model of a `small` serving bundle: its reconstruct runs K2
    (with its split) and K3 once and the int8 product once per conv site,
    no stage kernel."""
    from nsc_tpu_torch import api, kernels
    from nsc_tpu_torch.ops import quant as Q

    b = api.quantize_model(api.load_model("small", serving=True, device=dev), seconds=0.25)
    wav = torch.randn(2, 64 * b.cfg.hop, device=dev) * 0.1
    kernels.reset_launches()
    out = b.model.reconstruct(b.params, b.rvq, wav)
    torch.cuda.synchronize()
    want = dict.fromkeys(kernels.LAUNCHES, 0)
    want.update({"rvq_quantize": 1, "rvq_split_planes": 1, "rvq_dequantize": 1,
                 "int_mm": len(list(Q._conv_sites(b.params)))})
    assert kernels.LAUNCHES == want
    assert out.shape == wav.shape and torch.isfinite(out).all()


def test_spans_reach_the_trace_as_a_host_clock_only(dev):
    """`api.encode` / `api.decode` of a `small` serving bundle under a CUDA
    profiler: no CUDA-typed event carries a span's name or `nsc.clock`
    (the spans stay in the program's memory), and the CUDA-event time of
    `api.encode.model` lies within the trace's device interval of the
    model's kernels: from the input's host-to-device copy to the last
    kernel before the indices' copy back."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from nsc_tpu_torch import api
    from nsc_tpu_torch.utils import profiling

    b = api.load_model("small", serving=True, device=dev)
    wav = (np.random.RandomState(0).randn(2, 64 * b.cfg.hop) * 0.1).astype(np.float32)
    api.decode(b, api.encode(b, wav))
    torch.cuda.synchronize()
    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        api.decode(b, api.encode(b, wav))
        torch.cuda.synchronize()
    rec = profiling.recorded()
    profiling.clear()
    names = {s["name"] for s in rec["spans"]}
    assert len(names) == 10
    on_card = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                     if str(e.device_type).split(".")[-1] == "CUDA")
    assert on_card
    assert not [n for _, _, n in on_card if n in names | {profiling.CLOCK}]
    i = next(k for k, e in enumerate(on_card) if "HtoD" in e[2])
    j = next(k for k in range(i + 1, len(on_card)) if "DtoH" in on_card[k][2])
    kernels = on_card[i + 1:j]
    assert kernels
    model = next(s for s in rec["spans"] if s["name"] == "api.encode.model")
    least = (kernels[-1][1] - kernels[0][0]) / 1e3
    most = (kernels[-1][1] - on_card[i][1]) / 1e3
    tol = 0.1 + 0.01 * most
    assert least - tol <= model["device_ms"] <= most + tol, (least, model["device_ms"], most)
