"""The port's streaming (`nsc_tpu_torch/streaming.py`, `api.
streaming_compress`/`streaming_decompress`): every test of
`tests/integration/test_streaming.py`, against the port on `tiny_test`,
float32, CPU; then the port's streaming indices against nsc_tpu's on the
same weights, the state dtype of a bf16 config and the causal gate.

Tolerances: on the CPU, PyTorch's convs give a chunk with its carried
context the bits of the whole sequence here, so indices, stream bytes and
encoder latents are compared for equality, as in the JAX tests; decoded
waveforms within rtol 1e-4 / atol 1e-5 (the JAX tests' tolerance: the
overlap-add of a transposed conv sums in another order). Across packages
an index may differ only where nsc_tpu's argmin margin at the frame's first
differing book is below 1e-3 (two float32 encoders agree to ~1e-6 relative
on the latents).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from nsc_tpu import streaming as JS
from nsc_tpu.api import ModelBundle
from nsc_tpu.configs import get_config
from nsc_tpu.models.codec import NeuralSpeechCodec
from nsc_tpu.ops import rvq as JR
from nsc_tpu_torch import api as PA
from nsc_tpu_torch import streaming, weights
from nsc_tpu_torch.bitstream import BitstreamError
from nsc_tpu_torch.models import seanet
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture(scope="module")
def bundle():
    return PA.load_model("tiny_test", device="cpu")


@pytest.fixture(scope="module")
def wav(bundle):
    rng = np.random.RandomState(0)
    t = 64 * bundle.cfg.hop
    return (rng.randn(t) * 0.2).astype(np.float32)


def test_streaming_encoder_latents_match_batch(bundle, wav):
    cfg = bundle.cfg
    enc_p = bundle.params["encoder"]
    with torch.inference_mode():
        z_batch = seanet.apply_encoder(enc_p, torch.from_numpy(wav)[None, None], cfg)
        state = streaming.encoder_init_state(enc_p, cfg, 1)
        zs = []
        for c in np.split(wav, 4):
            z, state = streaming.encoder_stream(enc_p, state, torch.from_numpy(c)[None, None], cfg)
            zs.append(z)
    assert torch.equal(torch.cat(zs, dim=-1), z_batch)


def test_streaming_indices_identical_to_batch(bundle, wav):
    batch_idx = PA.encode(bundle, wav)
    enc = streaming.StreamingEncoder(bundle.model, bundle.params, bundle.rvq)
    stream_idx = np.concatenate([enc.push(c) for c in np.split(wav, 8)], axis=0)
    np.testing.assert_array_equal(stream_idx, batch_idx)


def test_streaming_uneven_chunks(bundle, wav):
    """Chunks of different (hop-multiple) sizes still match batch."""
    hop = bundle.cfg.hop
    batch_idx = PA.encode(bundle, wav)
    enc = streaming.StreamingEncoder(bundle.model, bundle.params, bundle.rvq)
    got, start = [], 0
    for end in [4 * hop, 20 * hop, 40 * hop, len(wav)]:
        got.append(enc.push(wav[start:end]))
        start = end
    np.testing.assert_array_equal(np.concatenate(got, axis=0), batch_idx)


def test_streaming_rejects_non_hop_chunk(bundle):
    enc = streaming.StreamingEncoder(bundle.model, bundle.params, bundle.rvq)
    with pytest.raises(ValueError, match="multiple of hop"):
        enc.push(np.zeros(bundle.cfg.hop + 1, np.float32))


def test_streaming_decoder_matches_batch(bundle, wav):
    idx = PA.encode(bundle, wav)
    batch_wav = PA.decode(bundle, idx)
    dec = streaming.StreamingDecoder(bundle.model, bundle.params, bundle.rvq)
    stream_wav = np.concatenate([dec.push(p) for p in np.split(idx, 4, axis=0)], axis=0)
    np.testing.assert_allclose(stream_wav, batch_wav, rtol=1e-4, atol=1e-5)


def test_full_streaming_pipeline(bundle, wav):
    """encode chunks -> decode chunks == batch reconstruct."""
    ref = PA.decode(bundle, PA.encode(bundle, wav))
    enc = streaming.StreamingEncoder(bundle.model, bundle.params, bundle.rvq)
    dec = streaming.StreamingDecoder(bundle.model, bundle.params, bundle.rvq)
    got = np.concatenate([dec.push(enc.push(c)) for c in np.split(wav, 8)], axis=0)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("serving", [False, True])
def test_push_many_matches_sequential_pushes(bundle, serving):
    """push_many(k chunks) equals k sequential pushes, and the decoder side
    round-trips the same blocks; also for the bf16 serving bundle, whose
    streaming convs sum in float32 whatever the chunk length. The decoder's
    overlap-add tail joins chunks in the compute dtype, so its waveforms
    agree to atol 1e-6 in float32 and to one bf16 ulp below 1 (2^-8) in
    bf16."""
    if serving:
        bundle = PA.load_model("tiny_test", serving=True, device="cpu")
    hop = bundle.cfg.hop
    rng = np.random.RandomState(3)
    chunks = [(rng.randn(2, n * hop) * 0.1).astype(np.float32) for n in (3, 1, 2)]
    enc_seq = streaming.StreamingEncoder(bundle.model, bundle.params, bundle.rvq)
    seq = [enc_seq.push(c) for c in chunks]
    many = streaming.StreamingEncoder(bundle.model, bundle.params, bundle.rvq).push_many(chunks)
    assert len(many) == len(seq)
    for a, b in zip(many, seq):
        np.testing.assert_array_equal(a, b)
    dec_seq = streaming.StreamingDecoder(bundle.model, bundle.params, bundle.rvq)
    wav_seq = [dec_seq.push(i) for i in seq]
    wav_many = streaming.StreamingDecoder(bundle.model, bundle.params, bundle.rvq).push_many(seq)
    for a, b in zip(wav_many, wav_seq):
        np.testing.assert_allclose(a, b, atol=2.0 ** -8 if serving else 1e-6)


def test_streaming_batched(bundle):
    rng = np.random.RandomState(1)
    wavs = (rng.randn(3, 32 * bundle.cfg.hop) * 0.2).astype(np.float32)
    batch_idx = PA.encode(bundle, wavs)
    enc = streaming.StreamingEncoder(bundle.model, bundle.params, bundle.rvq)
    got = np.concatenate([enc.push(c) for c in np.split(wavs, 2, axis=1)], axis=1)
    np.testing.assert_array_equal(got, batch_idx)


def test_streaming_compress_byte_identical_to_batch(bundle, wav):
    a = PA.compress(bundle, wav)
    secs = 16 * bundle.cfg.hop / bundle.cfg.sample_rate  # 4 chunks
    assert PA.streaming_compress(bundle, wav, chunk_seconds=secs) == a


def test_streaming_decompress_matches_batch(bundle, wav):
    blob = PA.compress(bundle, wav)
    ref = PA.decompress(bundle, blob)
    # 24 frames a chunk: 2 full chunks and a partial one (pad and trim)
    secs = 24 * bundle.cfg.hop / bundle.cfg.sample_rate
    got = PA.streaming_decompress(bundle, blob, chunk_seconds=secs)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5)
    other = PA.load_model(bundle.cfg.name, seed=99, device="cpu")
    with pytest.raises(BitstreamError, match="fingerprint"):
        PA.streaming_decompress(other, blob)


def test_queue_chunks_byte_identical(bundle, wav):
    """queue_chunks=4 (the default) and 1 give the same stream, and the
    same waveform through a partial last chunk."""
    secs = 16 * bundle.cfg.hop / bundle.cfg.sample_rate
    one = PA.streaming_compress(bundle, wav, chunk_seconds=secs, queue_chunks=1)
    four = PA.streaming_compress(bundle, wav, chunk_seconds=secs, queue_chunks=4)
    assert one == four
    dsecs = 24 * bundle.cfg.hop / bundle.cfg.sample_rate
    w1 = PA.streaming_decompress(bundle, one, chunk_seconds=dsecs, queue_chunks=1)
    w4 = PA.streaming_decompress(bundle, one, chunk_seconds=dsecs, queue_chunks=4)
    np.testing.assert_array_equal(w1, w4)


def test_push_many_rejects_unaligned_interior_chunk(bundle):
    """Every chunk must be hop-aligned, not only the concatenation."""
    enc = streaming.StreamingEncoder(bundle.model, bundle.params, bundle.rvq)
    hop = bundle.cfg.hop
    rng = np.random.RandomState(0)
    chunks = [rng.randn(2, hop + hop // 2).astype(np.float32),
              rng.randn(2, hop // 2).astype(np.float32)]
    with pytest.raises(ValueError, match="not a multiple of hop"):
        enc.push_many(chunks)


# ---------------------------------------------------------------------------
# beyond the JAX tests
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_bundle():
    """nsc_tpu's bundle on seeded random weights in its own layout (the
    port's `init_jax_layout`: no JAX init to compile)."""
    cfg = get_config("tiny_test")
    params, rvq = weights.init_jax_layout(PA.get_config("tiny_test"), 0)
    return ModelBundle(NeuralSpeechCodec(cfg), params, rvq)


def test_streaming_indices_equal_nsc_tpu_streaming(jax_bundle):
    """The port's streaming encoder and nsc_tpu's, on the same weights
    (the port's through `bundle_from_jax`) and the same 2 x 96-frame input in three
    chunks of 32 frames (one compiled step in nsc_tpu)."""
    cfg = jax_bundle.cfg
    params, rvq = jax.tree.map(np.asarray, (jax_bundle.params, jax_bundle.rvq))
    port = PA.bundle_from_jax(PA.get_config(cfg.name), params, rvq, device="cpu")
    rng = np.random.RandomState(5)
    wav = (rng.randn(2, 96 * cfg.hop) * 0.2).astype(np.float32)
    chunks = np.split(wav, 3, axis=1)
    jenc = JS.StreamingEncoder(jax_bundle.model, jax_bundle.params, jax_bundle.rvq)
    want = np.concatenate([jenc.push(c) for c in chunks], axis=1)
    penc = streaming.StreamingEncoder(port.model, port.params, port.rvq)
    got = np.concatenate([penc.push(c) for c in chunks], axis=1)
    assert got.shape == want.shape == (2, 96, cfg.num_quantizers)
    lat = jax.jit(jax_bundle.model.latents)(jax_bundle.params, wav)
    margins = np.asarray(jax.jit(JR.argmin_margins)(jax_bundle.rvq, lat)).reshape(-1, cfg.num_quantizers)
    diff = (got != want).reshape(-1, cfg.num_quantizers)
    frames = np.nonzero(diff.any(-1))[0]
    first = diff[frames].argmax(-1)
    assert (margins[frames, first] < 1e-3).all(), margins[frames, first]


def test_state_is_made_in_the_compute_dtype():
    """A bf16 config's state is bf16 (as the step returns it), a float32
    one's float32, on the bundle's device, and keeps its dtype after a
    push."""
    for serving, dtype in ((True, torch.bfloat16), (False, torch.float32)):
        b = PA.load_model("tiny_test", serving=serving, device="cpu")
        enc = streaming.StreamingEncoder(b.model, b.params, b.rvq)
        dec = streaming.StreamingDecoder(b.model, b.params, b.rvq)
        enc.reset(2)
        dec.reset(2)
        leaves = []
        weights.tree_map(leaves.append, (enc._state, dec._state))
        assert leaves and all(t.dtype == dtype and t.device.type == "cpu" for t in leaves)
        idx = enc.push(np.zeros((2, 8 * b.cfg.hop), np.float32))
        dec.push(idx)
        assert enc._state["stem"].dtype == dec._state["final"].dtype == dtype


def test_non_causal_config_raises():
    cfg = dataclasses.replace(PA.get_config("tiny_test"), causal=False)
    b = PA.bundle_from_jax(cfg, *weights.init_jax_layout(cfg, 0), device="cpu")
    for cls in (streaming.StreamingEncoder, streaming.StreamingDecoder):
        with pytest.raises(ValueError, match="causal"):
            cls(b.model, b.params, b.rvq)
