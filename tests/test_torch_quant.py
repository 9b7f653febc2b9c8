"""The port's int8 W8A8 path (`nsc_tpu_torch/ops/quant.py`, `api.
quantize_model`) against nsc_tpu's (`nsc_tpu/ops/quant.py`, `api.
quantize_model`) on the same numpy inputs, on the CPU.

Tolerances:
  * one conv site: bit-equal outputs. Quantization rounds half to even in
    both packages, the int32 sums are exact, and dequantization is the same
    two float32 operations, so equal inputs and weights give equal bits.
  * the int32 product's CUDA route (im2col + `torch._int_mm`, which the
    CPU build of PyTorch has too) equals its plain version exactly.
  * calibration: the a_s leaves within rtol 1e-5 of nsc_tpu's (the float
    activations before each site differ by ~1e-6 relative).
  * the calibrated model end to end (float32, nsc_tpu's a_s carried
    across): an activation that lands within ~1e-6 of a rounding boundary
    of its int8 grid may take the neighbouring code in the other package,
    which moves that site's output by one code step (1/127 of its range)
    at that sample; so latents and waveforms within 2e-2 x max|ref| (a
    couple of such steps through the later layers), and an index may differ
    only where nsc_tpu's float32 argmin margin at the frame's first
    differing book is below 1e-3.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nsc_tpu
from nsc_tpu import api as JA
from nsc_tpu.ops import conv as JC
from nsc_tpu.ops import quant as JQ
from nsc_tpu.ops import rvq as JR
from nsc_tpu_torch import api as PA
from nsc_tpu_torch import streaming, weights
from nsc_tpu_torch.ops import conv as PC
from nsc_tpu_torch.ops import quant as PQ
from nsc_tpu_torch.train import checkpoint as ckpt
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

# (k, stride, dilation, Cin, Cout): the conv sites' kinds in base_fast (stem
# k 7 Cin 1; units k 3 dilated 1/3/9 and k 1; strided downs k 2s; final k 3;
# decoder final Cout 1), at narrow widths
CONV_SITES = [(7, 1, 1, 1, 8), (3, 1, 1, 8, 8), (3, 1, 3, 8, 8), (3, 1, 9, 16, 16),
              (1, 1, 1, 16, 16), (4, 2, 1, 8, 16), (8, 4, 1, 16, 32), (10, 5, 1, 8, 16),
              (16, 8, 1, 16, 32), (3, 1, 1, 32, 16), (7, 1, 1, 8, 1)]
# (k, stride, Cin, Cout): the decoder's transposed up convs
UP_SITES = [(16, 8, 32, 16), (10, 5, 16, 8), (8, 4, 16, 8), (4, 2, 8, 4)]
SCALES = ["dynamic", "scalar", "per_channel"]


def _site(seed, k, cin, cout, scale, t=96):
    """JAX conv params {'w', 'b'[, 'a_s']} and an input (1, T, Cin), numpy."""
    rng = np.random.RandomState(seed)
    p = {"w": (rng.randn(k, cin, cout) / np.sqrt(k * cin)).astype(np.float32),
         "b": (rng.randn(cout) * 0.1).astype(np.float32)}
    x = rng.randn(2, t, cin).astype(np.float32)
    if scale == "scalar":
        p["a_s"] = np.float32(np.abs(x).max() * 0.8)  # some inputs clip
    elif scale == "per_channel":
        p["a_s"] = (np.abs(x).max(axis=(0, 1)) * 0.9).astype(np.float32)
    return p, x


def _port(p, transposed=False):
    tree = weights.to_tensors(p)
    return PC.conv_transpose_params(tree) if transposed else PC.conv_params(tree)


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("k,stride,dilation,cin,cout", CONV_SITES)
def test_conv1d_int8_bit_equal(k, stride, dilation, cin, cout, scale):
    p, x = _site(k * 100 + cin, k, cin, cout, scale)
    want = np.asarray(JQ.conv1d_int8(jnp.asarray(x), p, stride=stride, dilation=dilation))
    got = PQ.conv1d_int8(torch.from_numpy(x).transpose(1, 2), _port(p), stride=stride,
                         dilation=dilation)
    np.testing.assert_array_equal(got.transpose(1, 2).numpy(), want)


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("k,stride,cin,cout", UP_SITES)
def test_conv_transpose1d_int8_bit_equal(k, stride, cin, cout, scale):
    p, x = _site(k * 10 + cin, k, cin, cout, scale, t=24)
    want = np.asarray(JQ.conv_transpose1d_int8(jnp.asarray(x), p, stride=stride))
    got = PQ.conv_transpose1d_int8(torch.from_numpy(x).transpose(1, 2), _port(p, True),
                                   stride=stride)
    np.testing.assert_array_equal(got.transpose(1, 2).numpy(), want)


@pytest.mark.parametrize("k,stride,dilation,cin,cout", CONV_SITES)
def test_int_mm_route_equals_plain(k, stride, dilation, cin, cout):
    """The CUDA route's arithmetic (im2col, zero padding to _int_mm's
    rules, one int8 matmul) against the float64 plain version; ragged rows
    (T' <= 16 at B 1) included."""
    g = torch.Generator().manual_seed(k * cin)
    for n, t in ((2, 96), (1, (k - 1) * dilation + 9)):
        x8 = torch.randint(-127, 128, (n, cin, t), dtype=torch.int8, generator=g)
        w8 = torch.randint(-127, 128, (cout, cin, k), dtype=torch.int8, generator=g)
        assert torch.equal(PQ.int_conv1d_mm(x8, w8, stride, dilation),
                           PQ.int_conv1d_plain(x8, w8, stride, dilation))


@pytest.mark.parametrize("k,stride,cin,cout", UP_SITES + [(5, 2, 3, 5), (3, 3, 4, 2), (2, 3, 4, 2)])
def test_int_mm_transpose_route_equals_plain(k, stride, cin, cout):
    g = torch.Generator().manual_seed(k * cin + stride)
    for n, f in ((2, 24), (1, 3)):
        x8 = torch.randint(-127, 128, (n, cin, f), dtype=torch.int8, generator=g)
        w8 = torch.randint(-127, 128, (cin, cout, k), dtype=torch.int8, generator=g)
        assert torch.equal(PQ.int_conv_transpose1d_mm(x8, w8, stride),
                           PQ.int_conv_transpose1d_plain(x8, w8, stride))


def test_int8_product_refuses_other_devices():
    x8 = torch.zeros(1, 2, 8, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        PQ.int_conv1d(x8, torch.zeros(2, 2, 3, dtype=torch.int8, device="meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        PQ.int_conv_transpose1d(x8, torch.zeros(2, 2, 4, dtype=torch.int8, device="meta"), 2)


# ---------------------------------------------------------------------------
# calibration and the model
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    """Seeded weights in nsc_tpu's layout (the port's `init_jax_layout`,
    much faster than nsc_tpu's eager init), as JAX arrays."""
    params, rvq = weights.init_jax_layout(JA.get_config(name), 0)
    return jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, rvq)


def _cal(n=2, t=512, batches=2):
    rng = np.random.RandomState(0)
    return [rng.randn(n, t).astype(np.float32) * 0.1 for _ in range(batches)]


@functools.lru_cache(maxsize=None)
def _jax_calibrated():
    """nsc_tpu's float bundle on tiny_test and its calibrations, per-channel
    and per-tensor. One eager calibration pass (the slow part): the
    per-tensor scales are the per-channel records' maxima, as nsc_tpu's
    calibrate_codec reduces them."""
    cfg = JA.get_config("tiny_test")
    params, rvq = _jax_init("tiny_test")
    jb = JA.ModelBundle(JA.NeuralSpeechCodec(cfg), params, rvq)
    pc = nsc_tpu.quantize_model(jb, _cal(), per_channel=True)
    pt_params = jax.tree.map(lambda x: x, pc.params)  # a new tree, the same leaves
    for site in JQ._conv_sites(pt_params):
        site["a_s"] = jnp.max(site["a_s"])
    return jb, pc, JA.ModelBundle(pc.model, pt_params, pc.rvq)


@functools.lru_cache(maxsize=None)
def _pair(per_channel=False):
    """(JAX float bundle, JAX calibrated bundle, port float bundle, port
    calibrated bundle) on tiny_test's nsc_tpu weights."""
    jb, pc, pt = _jax_calibrated()
    pb = PA.bundle_from_jax(jb.cfg, jax.tree.map(np.asarray, jb.params),
                            jax.tree.map(np.asarray, jb.rvq), device="cpu")
    pq = PA.quantize_model(pb, _cal(), per_channel=per_channel)
    return jb, pc if per_channel else pt, pb, pq


@pytest.mark.parametrize("per_channel", [False, True])
def test_calibration_sites_and_scales_match(per_channel):
    _, jq, _, pq = _pair(per_channel)
    j_sites = list(JQ._conv_sites(jq.params))
    p_sites = list(PQ._conv_sites(pq.params))
    assert len(p_sites) == len(j_sites) == 24
    for a, b in zip(j_sites, p_sites):
        want, got = np.asarray(a["a_s"]), b["a_s"].numpy()
        assert got.shape == want.shape and got.ndim == (1 if per_channel else 0)
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert pq.cfg.quant == "int8" and pq.model.kernels.units == "reference"


def test_calibration_is_not_reentrant():
    with PQ.recording():
        with pytest.raises(RuntimeError, match="not reentrant"):
            with PQ.recording():
                pass
    with PQ.recording():  # the slot is free again
        pass


def _int8_bundle_from_jax(jq):
    """The port's int8 bundle on nsc_tpu's calibrated params (its a_s)."""
    return PA.bundle_from_jax(jq.cfg, jax.tree.map(np.asarray, jq.params),
                              jax.tree.map(np.asarray, jq.rvq), device="cpu")


def test_quantized_model_matches_nsc_tpu_end_to_end():
    _, jq, _, _ = _pair()
    pq = _int8_bundle_from_jax(jq)
    assert all("a_s" in s for s in PQ._conv_sites(pq.params))
    wav = (np.random.RandomState(3).randn(2, 64 * jq.cfg.hop) * 0.3).astype(np.float32)
    lat_j = np.asarray(jq.model.latents(jq.params, jnp.asarray(wav)))
    with torch.inference_mode():
        lat_p = pq.model.latents(pq.params, torch.from_numpy(wav)).numpy()
    assert np.abs(lat_p - lat_j).max() <= 2e-2 * np.abs(lat_j).max()
    idx_j = np.asarray(jq.model.encode(jq.params, jq.rvq, jnp.asarray(wav)))
    idx_p = PA.encode(pq, wav)
    diff = (idx_p != idx_j).any(-1)
    if diff.any():
        margins = np.asarray(JR.argmin_margins(jq.rvq, jnp.asarray(lat_j)))
        first = (idx_p != idx_j).argmax(-1)
        assert (margins[diff, first[diff]] < 1e-3).all()
    out_j = np.asarray(jq.model.decode(jq.params, jq.rvq, jnp.asarray(idx_j)))
    out_p = PA.decode(pq, idx_j)
    assert np.abs(out_p - out_j).max() <= 2e-2 * np.abs(out_j).max()


@pytest.mark.parametrize("which", ["tiny_test", "flagship"])
def test_folded_weights_against_materialize_weight(which):
    """The int8 path quantizes the port's folded weight; nsc_tpu quantizes
    its `materialize_weight`. The two differ by a few ulps wherever the
    weight-norm's sum of squares rounds apart (PyTorch and XLA sum in
    other orders), so the per-channel weight scales differ by an ulp at
    some channels, and an int8 weight code can move at a .5 boundary.
    Counted here, against nsc_tpu's jitted weights and codes: tiny_test's
    seeded weights 1,627 of 3,384 values (<= 3 ulps), 0 codes; the trained
    flagship's export 3,775,389 of 7,479,744 values (<= 5 ulps), 5 codes.
    Held: at most 8 ulps, and at most one code in a million."""
    if which == "tiny_test":
        params, _ = _jax_init("tiny_test")
    else:
        params, _ = ckpt.restore_inference(
            os.path.join(os.path.dirname(__file__), "..", "exports",
                         "base_fast_synthetic2_48k_refit"))
    sites = list(JQ._conv_sites(params))
    # nsc_tpu's weights and codes as its jitted serving path computes them
    jax_w = jax.jit(lambda ss: [(JC.materialize_weight(q), JQ._quantize_weight(
        JC.materialize_weight(q))[0]) for q in ss])(jax.tree.map(jnp.asarray, sites))
    values = codes = total = ulps = 0
    for site, (w_j, w8_j) in zip(sites, jax_w):
        want = np.asarray(w_j)
        got = PC.materialize_weight(weights.to_tensors(site)).numpy()
        values += int((got != want).sum())
        total += want.size
        ulps = max(ulps, int(np.abs(got.view(np.int32).astype(np.int64)
                                    - want.view(np.int32)).max()))
        w8_p, _ = PQ._quantize_weight(torch.from_numpy(got), 2)
        codes += int((np.asarray(w8_j) != w8_p.numpy()).sum())
    print(f"{which}: {values} of {total} weight values differ (<= {ulps} ulps), "
          f"{codes} int8 codes")
    assert total > 0 and ulps <= 8 and codes <= total // 1_000_000


def test_calibrated_bundle_save_and_restore(tmp_path):
    """a_s leaves in the JAX layout (scalar and per-channel) go through
    `from_jax_params` and `to_numpy`, and through an export (save_inference
    -> load_model), as nsc_tpu's test_calibrated_checkpoint_roundtrip."""
    for per_channel in (False, True):
        _, jq, _, _ = _pair(per_channel)
        pq = _int8_bundle_from_jax(jq)
        back = weights.to_numpy(pq.params)
        for a, b in zip(JQ._conv_sites(jq.params), PQ._conv_sites(back)):
            np.testing.assert_array_equal(b["a_s"], np.asarray(a["a_s"]))
        d = str(tmp_path / ("pc" if per_channel else "pt"))
        ckpt.save_inference(d, 1, jax.tree.map(np.asarray, jq.params), jq.rvq,
                            {"config": "tiny_test"})
        b2 = PA.load_model("tiny_test", checkpoint=d, device="cpu")
        for a, b in zip(PQ._conv_sites(pq.params), PQ._conv_sites(b2.params)):
            assert torch.equal(a["a_s"], b["a_s"])
        served = PA.ModelBundle(pq.model, b2.params, b2.rvq)
        wav = np.zeros(16 * jq.cfg.hop, np.float32)
        wav[::7] = 0.2
        np.testing.assert_array_equal(PA.encode(served, wav), PA.encode(pq, wav))
        # and the float model reads the same export, its a_s unread
        np.testing.assert_array_equal(PA.encode(b2, wav), PA.encode(_pair()[2], wav))


def test_export_refuses_a_misplaced_scale(tmp_path):
    params, rvq = _jax_init("tiny_test")
    tree = jax.tree.map(np.asarray, params)
    tree["encoder"]["stem"]["a_s"] = np.ones(3, np.float32)  # stem Cin is 1
    ckpt.save_inference(str(tmp_path), 1, tree, rvq, {"config": "tiny_test"})
    with pytest.raises(ValueError, match="a_s"):
        ckpt.restore_inference(str(tmp_path))


def test_default_calibration_and_float_params_unchanged():
    """quantize_model's default calibration (three batches of synthetic
    speech) runs, and the calibrated params serve the float model as the
    uncalibrated ones do (the float path ignores a_s)."""
    _, _, pb, _ = _pair()
    qb = PA.quantize_model(pb, seconds=0.25)
    wav = (np.random.RandomState(1).randn(16 * pb.cfg.hop) * 0.2).astype(np.float32)
    assert PA.encode(qb, wav).shape == (16, pb.cfg.num_quantizers)
    float_with_scales = PA.ModelBundle(pb.model, qb.params, pb.rvq)
    np.testing.assert_array_equal(PA.encode(float_with_scales, wav), PA.encode(pb, wav))


def test_streaming_an_int8_bundle_streams_the_float_convs():
    """As nsc_tpu's streaming: the streaming convs ignore quant and a_s, so
    an int8 bundle streams what its float bundle streams."""
    _, _, pb, pq = _pair()
    wav = (np.random.RandomState(2).randn(48 * pb.cfg.hop) * 0.2).astype(np.float32)
    blob_q = PA.streaming_compress(pq, wav, chunk_seconds=16 * pb.cfg.hop / pb.cfg.sample_rate)
    blob_f = PA.streaming_compress(pb, wav, chunk_seconds=16 * pb.cfg.hop / pb.cfg.sample_rate)
    assert blob_q == blob_f
    chunk = wav[None, : 16 * pb.cfg.hop]
    np.testing.assert_array_equal(
        streaming.StreamingEncoder(pq.model, pq.params, pq.rvq).push(chunk),
        streaming.StreamingEncoder(pb.model, pb.params, pb.rvq).push(chunk))


def test_int8_wins_over_the_stacked_backend():
    """As nsc_tpu's `_conv`: quant "int8" takes a conv before
    conv_backend "stacked" does, and an int8 serving config runs its units
    op by op and keeps the RVQ kernels."""
    from nsc_tpu_torch.models import seanet
    from nsc_tpu_torch.models.codec import KernelOptions

    cfg = dataclasses.replace(PA.serving_config(PA.get_config("tiny_test")), quant="int8",
                              conv_backend="stacked")
    assert KernelOptions.for_config(cfg) == KernelOptions(units="reference", rvq=True)
    p, x = _site(5, 3, 8, 8, "scalar")
    xt = torch.from_numpy(x).transpose(1, 2)
    assert torch.equal(seanet._conv(cfg, xt, _port(p), dilation=3),
                       PQ.conv1d_int8(xt, _port(p), dilation=3))
