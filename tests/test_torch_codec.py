"""The port's codec slice (nsc_tpu_torch: models, api, bitstream, entropy)
against nsc_tpu.NeuralSpeechCodec and nsc_tpu.api on the same weights:
JAX params from nsc_tpu's init, converted with weights.from_jax_params.

Tolerances:
  * float32: latents rtol 1e-4 / atol 1e-5 (conv summation order only),
    indices bit-exact, waveforms rtol 1e-3 / atol 1e-4 (the port's parity
    bar against nsc_tpu).
  * bfloat16 serving: both sides round activations to bf16 (2^-8
    relative), at partly different points (the port runs the residual-stack
    kernel's rounding, JAX on the CPU the op-by-op path). An index can flip
    only where the top-2 scores are that close, a few percent of frames at
    random init: agreement >= 0.95. Decoding the same indices: max abs
    <= 5e-2 * max|ref| and relative RMS <= 1e-2 (a few bf16 ulps through
    the decoder).
  * streams: byte-identical whenever the indices are.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsc_tpu import api as JA
from nsc_tpu_torch import api as PA
from nsc_tpu_torch import bitstream as PB

CONFIGS = ["tiny_test", "small", "small_factorized"]


@functools.lru_cache(maxsize=None)
def _jax_init(name):
    """nsc_tpu's own init, once per config (it dominates this file's time)."""
    _, params, rvq = JA.init_codec(jax.random.PRNGKey(0), JA.get_config(name))
    return params, rvq


def _pair(name, serving=False, causal=True, codebook_offset=0.0):
    """(JAX bundle, port bundle) on the same weights; `codebook_offset`
    stands for another checkpoint of the same config."""
    cfg = JA.get_config(name)
    if serving:
        cfg = JA.serving_config(cfg)
    cfg = dataclasses.replace(cfg, causal=causal)
    params, rvq = _jax_init(name)
    rvq = {**rvq, "codebooks": rvq["codebooks"] + codebook_offset}
    jb = JA.ModelBundle(JA.NeuralSpeechCodec(cfg), params, rvq)
    pb = PA.bundle_from_jax(
        cfg, jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, rvq),
        device="cpu",
    )
    return jb, pb


def _wav(cfg, n=2, frames=64, seed=0):
    t = frames * cfg.hop - cfg.hop // 3  # not a whole number of frames
    return (np.random.RandomState(seed).randn(n, t) * 0.3).astype(np.float32)


@pytest.fixture(scope="module", params=CONFIGS)
def f32(request):
    jb, pb = _pair(request.param)
    wav = _wav(jb.cfg, n=1)
    return jb, pb, wav, JA.encode(jb, wav)


def test_f32_latents_and_indices(f32):
    jb, pb, wav, idx_j = f32
    x = JA._pad_to_bucket(wav, jb.cfg.hop)
    lat_j = np.asarray(jax.jit(jb.model.latents)(jb.params, jnp.asarray(x)))
    with torch.inference_mode():
        lat_p = pb.model.latents(pb.params, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(lat_p, lat_j, rtol=1e-4, atol=1e-5)
    idx_p = PA.encode(pb, wav)
    assert idx_p.dtype == np.int32 and idx_p.shape == idx_j.shape
    np.testing.assert_array_equal(idx_p, idx_j)


def test_f32_waveforms(f32):
    jb, pb, wav, idx_j = f32
    np.testing.assert_allclose(
        PA.decode(pb, idx_j), JA.decode(jb, idx_j), rtol=1e-3, atol=1e-4
    )
    z = np.random.RandomState(3).randn(1, 64, jb.cfg.codebook_dim).astype(np.float32)
    ref = np.asarray(jax.jit(jb.model.decode_latents)(jb.params, jnp.asarray(z)))
    with torch.inference_mode():
        got = pb.model.decode_latents(pb.params, torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("entropy", [False, True])
def test_compress_byte_identical(f32, entropy):
    jb, pb, wav, _ = f32
    blob_j = JA.compress(jb, wav[0], entropy_coding=entropy)
    blob_p = PA.compress(pb, wav[0], entropy_coding=entropy)
    assert blob_p == blob_j
    out = PA.decompress(pb, blob_p)
    assert out.shape == wav[0].shape and np.isfinite(out).all()
    np.testing.assert_allclose(out, JA.decompress(jb, blob_j), rtol=1e-3, atol=1e-4)
    _, idx = PB.deserialize(blob_p)
    np.testing.assert_array_equal(idx, PA.encode(pb, wav[0]))


@pytest.mark.parametrize("name", CONFIGS)
def test_serving_bf16_within_tolerance(name):
    jb, pb = _pair(name, serving=True)
    assert pb.cfg.compute_dtype == "bfloat16" and pb.model.kernels.units == "residual_stack"
    wav = _wav(jb.cfg, seed=1)
    idx_j, idx_p = JA.encode(jb, wav), PA.encode(pb, wav)
    assert (idx_j == idx_p).mean() >= 0.95
    ref, got = JA.decode(jb, idx_j), PA.decode(pb, idx_j)
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 5e-2 * np.abs(ref).max()
    assert np.sqrt(np.mean((got - ref) ** 2)) <= 1e-2 * np.sqrt(np.mean(ref**2)) + 1e-6


def test_bucket_edge_and_prefix_frames():
    """Causal bucketing: 64 and 65 frames fall in different buckets (64,
    128); the shared 64 frames encode identically, and both match JAX."""
    jb, pb = _pair("tiny_test")
    hop = jb.cfg.hop
    wav = (np.random.RandomState(4).randn(65 * hop) * 0.3).astype(np.float32)
    a, b = PA.encode(pb, wav[: 64 * hop]), PA.encode(pb, wav)
    assert a.shape == (64, 2) and b.shape == (65, 2)
    np.testing.assert_array_equal(a, b[:64])
    np.testing.assert_array_equal(b, JA.encode(jb, wav))
    assert PA.decode(pb, b).shape == (65 * hop,)


def test_noncausal_tight_padding():
    """Non-causal configs pad to the hop only (one shape per length)."""
    jb, pb = _pair("tiny_test", causal=False)
    wav = _wav(jb.cfg, n=1, frames=20, seed=5)
    idx = PA.encode(pb, wav)
    np.testing.assert_array_equal(idx, JA.encode(jb, wav))
    np.testing.assert_allclose(PA.decode(pb, idx), JA.decode(jb, idx), rtol=1e-3, atol=1e-4)


def test_fingerprint_and_identity_checks():
    jb, pb = _pair("tiny_test")
    _, other = _pair("tiny_test", codebook_offset=1e-3)
    _, small = _pair("small")
    wav = _wav(pb.cfg, n=1, frames=10)[0]
    blob = PA.compress(pb, wav)
    with pytest.raises(PB.BitstreamError, match="fingerprint"):
        PA.decompress(other, blob)
    with pytest.raises(ValueError, match="incompatible"):
        PA.decompress(small, blob)
    assert PA.codebook_fingerprint(pb.rvq) == JA.codebook_fingerprint(jb.rvq)


def test_depth_truncation_matches_jax():
    jb, pb = _pair("small")
    wav = _wav(jb.cfg, n=1, frames=30, seed=6)[0]
    blob = PA.compress(pb, wav, n_q=1)
    assert blob == JA.compress(jb, wav, n_q=1)
    np.testing.assert_allclose(
        PA.decompress(pb, PB.truncate(PA.compress(pb, wav), 1)),
        JA.decompress(jb, blob), rtol=1e-3, atol=1e-4,
    )


@pytest.mark.parametrize("method", ["encode", "latents", "decode", "reconstruct", "decode_latents"])
def test_inference_methods_turn_tf32_off_and_restore_it(method, monkeypatch):
    """Inside every inference method both TF32 flags read False (PyTorch
    allows TF32 convolutions by default); the caller's values come back."""
    from nsc_tpu_torch.models import seanet as PS

    flags = lambda: (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    seen = []
    for name in ("apply_encoder", "apply_decoder"):
        real = getattr(PS, name)
        monkeypatch.setattr(PS, name, lambda *a, _f=real, **k: (seen.append(flags()), _f(*a, **k))[1])
    pb = PA.load_model("tiny_test", device="cpu")
    m = pb.model
    wav = torch.from_numpy(_wav(pb.cfg, n=1, frames=4))
    idx = m.encode(pb.params, pb.rvq, wav)
    args = {
        "encode": (pb.rvq, wav), "latents": (wav,), "decode": (pb.rvq, idx),
        "reconstruct": (pb.rvq, wav),
        "decode_latents": (torch.zeros(1, 4, pb.cfg.codebook_dim),),
    }[method]
    saved = flags()
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        seen.clear()
        with torch.inference_mode():
            getattr(m, method)(pb.params, *args)
        after = flags()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert seen and set(seen) == {(False, False)}
    assert after == (True, True)
