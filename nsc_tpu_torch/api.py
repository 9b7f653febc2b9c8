"""Public API: load_model / encode / decode / compress / decompress
(counterpart of `nsc_tpu/api.py`).

Waveforms and indices cross the host boundary as numpy arrays; the model runs
on the bundle's device. Models run on CUDA unless the caller passes
`device="cpu"`: `load_model` raises when CUDA is asked for and absent.
Bit-packing is host-side numpy.

Causal configs pad every input to a power-of-two frame count (at least 64
frames), so arbitrary lengths reuse a few shapes; trailing zeros cannot
change earlier frames of a causal model, and the extra frames are trimmed.
Non-causal configs pad tightly to the hop.
"""

from __future__ import annotations

import dataclasses
import zlib
from typing import Optional, Union

import numpy as np
import torch

from nsc_tpu_torch import bitstream, weights
from nsc_tpu_torch.configs import CodecConfig, get_config, list_configs
from nsc_tpu_torch.models.codec import NeuralSpeechCodec
from nsc_tpu_torch.train import checkpoint as ckpt
from nsc_tpu_torch.utils import profiling

ArrayLike = Union[np.ndarray, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    """A loaded codec: static model + parameter/quantizer dicts on a device."""

    model: NeuralSpeechCodec
    params: dict
    rvq: dict

    @property
    def cfg(self) -> CodecConfig:
        return self.model.cfg

    @property
    def device(self) -> torch.device:
        return self.rvq["codebooks"].device


def list_models() -> tuple:
    return list_configs()


def serving_config(cfg: CodecConfig) -> CodecConfig:
    """The serving configuration: bf16 compute, the RVQ and residual-stack
    kernels, and the polynomial snake."""
    act = "snake_fast" if cfg.activation == "snake" else cfg.activation
    return dataclasses.replace(
        cfg,
        compute_dtype="bfloat16",
        rvq_backend="pallas",
        unit_backend="auto",
        activation=act,
    )


def resolve_device(device=None) -> torch.device:
    """`None` means CUDA. Raises when CUDA is asked for and not available;
    there is no silent move to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the codec on "
            "the CPU"
        )
    return dev


def bundle_from_jax(
    cfg: CodecConfig, params, rvq, *, device=None
) -> ModelBundle:
    """A bundle from the JAX package's parameter/quantizer trees."""
    dev = resolve_device(device)
    p, q = weights.from_jax_params(params, rvq, cfg)
    return ModelBundle(
        NeuralSpeechCodec(cfg), weights.to_device(p, dev),
        weights.to_device(q, dev),
    )


def load_model(
    name: str = "base",
    *,
    checkpoint: Optional[str] = None,
    seed: int = 0,
    serving: bool = False,
    device=None,
) -> ModelBundle:
    """Build a codec by config name, with the weights of `checkpoint` or,
    without one, weights made from `seed`. `checkpoint` is an export (of a
    JAX package checkpoint, `scripts/export_torch_checkpoint.py`, or one the
    port's trainer wrote) or a training workdir of the port, which reads
    the newest export of its `infer_best/`, else of its `infer/`
    (`train.checkpoint.resolve_export`); its config must be `name`.
    serving=True applies `serving_config`. device=None means CUDA."""
    cfg = get_config(name)
    if serving:
        cfg = serving_config(cfg)
    dev = resolve_device(device)
    if checkpoint is None:
        params, rvq = weights.init_jax_layout(cfg, seed)
    else:
        made_for = ckpt.export_meta(checkpoint)["config"]
        if made_for != name:
            raise ValueError(
                f"checkpoint {checkpoint} holds a {made_for!r} model, not {name!r}"
            )
        params, rvq = ckpt.restore_inference(checkpoint)
    return bundle_from_jax(cfg, params, rvq, device=dev)


def quantize_model(
    bundle: ModelBundle, calibration_wavs=None, *, seconds: float = 2.0,
    per_channel: bool = False,
) -> ModelBundle:
    """An int8 W8A8 serving bundle with statically calibrated activation
    scales (`ops.quant`): the bundle's model with quant "int8" runs once,
    eagerly on the bundle's device, over `calibration_wavs` (an iterable of
    (N, T) float32 arrays; by default three batches of 2 x `seconds` of
    `train.data.SyntheticSource(sample_rate, seed=0)`, as the JAX package
    takes), and each conv site's input amax lands in the params as an "a_s"
    leaf (per-channel vectors with per_channel=True). The convs then
    quantize with those constant scales; the RVQ search and sum stay
    float32 (K2, K3 where the bundle runs them)."""
    from nsc_tpu_torch.ops import quant as Q

    model = NeuralSpeechCodec(dataclasses.replace(bundle.cfg, quant="int8"))
    if calibration_wavs is None:
        from nsc_tpu_torch.train.data import SyntheticSource

        cfg = bundle.cfg
        src = SyntheticSource(cfg.sample_rate, seed=0)
        seg = max(cfg.hop, int(seconds * cfg.sample_rate) // cfg.hop * cfg.hop)
        it = src.batches(2, seg)
        calibration_wavs = [next(it) for _ in range(3)]
    params = Q.calibrate_codec(model, bundle.params, bundle.rvq, calibration_wavs,
                               per_channel=per_channel)
    return ModelBundle(model, params, bundle.rvq)


# ---------------------------------------------------------------------------
# padding
# ---------------------------------------------------------------------------


def _pad_to_hop(wav: np.ndarray, hop: int) -> np.ndarray:
    pad = (-wav.shape[-1]) % hop
    if pad:
        wav = np.pad(wav, [(0, 0)] * (wav.ndim - 1) + [(0, pad)])
    return wav


_MIN_BUCKET_FRAMES = 64


def _bucket_frames(frames: int) -> int:
    return max(_MIN_BUCKET_FRAMES, 1 << (frames - 1).bit_length())


def _pad_to_bucket(wav: np.ndarray, hop: int) -> np.ndarray:
    """Pad to a power-of-two frame count (causal configs only)."""
    t = wav.shape[-1]
    pad = _bucket_frames((t + hop - 1) // hop) * hop - t
    if pad:
        wav = np.pad(wav, [(0, 0)] * (wav.ndim - 1) + [(0, pad)])
    return wav


def _count_frames(rows: int, frames: int, frames_run: int) -> None:
    """The traced counters of the bucket's waste: frames asked for and
    frames the model runs, times rows."""
    profiling.count("api.frames", rows * frames)
    profiling.count("api.frames_run", rows * frames_run)


def _as_batch(wav: ArrayLike) -> tuple[np.ndarray, bool]:
    if isinstance(wav, torch.Tensor):
        wav = wav.detach().cpu().numpy()
    arr = np.asarray(wav, dtype=np.float32)
    if arr.ndim == 1:
        return arr[None], True
    if arr.ndim == 2:
        return arr, False
    raise ValueError(f"expected (T,) or (N, T) waveform, got {arr.shape}")


# ---------------------------------------------------------------------------
# public functions
# ---------------------------------------------------------------------------


def codebook_fingerprint(rvq: dict) -> int:
    """u32 CRC-32 of the float32 codebooks as loaded (the same value the JAX
    package computes for the same codebooks). Streams carry it so a stream
    is never decoded by a same-config model with different codebooks."""
    cb = rvq["codebooks"].detach().to("cpu", torch.float32).contiguous().numpy()
    return zlib.crc32(cb.tobytes()) & 0xFFFFFFFF


@torch.inference_mode()
def encode(
    bundle: ModelBundle, wav: ArrayLike, n_q: Optional[int] = None
) -> np.ndarray:
    """Waveform -> codebook indices. (T,) -> (F, n_q); (N, T) -> (N, F, n_q)."""
    cfg = bundle.cfg
    with profiling.span("api.encode"):
        with profiling.span("api.encode.pad"):
            batch, single = _as_batch(wav)
            t = batch.shape[-1]
            if cfg.causal:
                batch = _pad_to_bucket(batch, cfg.hop)
            else:
                # 'same' padding: trailing zeros reach the final frames'
                # receptive fields, so pad tightly
                batch = _pad_to_hop(batch, cfg.hop)
        frames = (t + cfg.hop - 1) // cfg.hop
        _count_frames(batch.shape[0], frames, batch.shape[-1] // cfg.hop)
        with profiling.span("api.encode.to_device"):
            x = torch.tensor(batch, device=bundle.device)
        with profiling.span("api.encode.model"):
            idx = bundle.model.encode(bundle.params, bundle.rvq, x, n_q=n_q)
        with profiling.span("api.encode.to_host"):
            idx = idx.cpu().numpy()[:, :frames]
    return idx[0] if single else idx


@torch.inference_mode()
def decode(
    bundle: ModelBundle, indices: ArrayLike, n_q: Optional[int] = None
) -> np.ndarray:
    """Codebook indices -> waveform. (F, n_q) -> (F*hop,); batched likewise."""
    with profiling.span("api.decode"):
        with profiling.span("api.decode.pad"):
            if isinstance(indices, torch.Tensor):
                indices = indices.detach().cpu().numpy()
            idx = np.asarray(indices, dtype=np.int32)
            single = idx.ndim == 2
            if single:
                idx = idx[None]
            frames = idx.shape[1]
            if bundle.cfg.causal and frames:
                bucket = _bucket_frames(frames)
                if bucket != frames:
                    idx = np.pad(idx, ((0, 0), (0, bucket - frames), (0, 0)))
        _count_frames(idx.shape[0], frames, idx.shape[1])
        with profiling.span("api.decode.to_device"):
            x = torch.tensor(idx, device=bundle.device)
        with profiling.span("api.decode.model"):
            wav = bundle.model.decode(bundle.params, bundle.rvq, x, n_q=n_q)
        with profiling.span("api.decode.to_host"):
            wav = wav.cpu().numpy()[:, : frames * bundle.cfg.hop]
    return wav[0] if single else wav


def compress(
    bundle: ModelBundle,
    wav: ArrayLike,
    n_q: Optional[int] = None,
    *,
    entropy_coding: bool = False,
) -> bytes:
    """(T,) waveform -> serialized NSC bitstream (header + index planes).
    entropy_coding=True arithmetic-codes the planes; decompress
    auto-detects."""
    arr, single = _as_batch(wav)
    if not single:
        raise ValueError("compress takes a single (T,) waveform")
    idx = encode(bundle, arr[0], n_q=n_q)
    return _finalize_stream(bundle, idx, arr.shape[-1], entropy_coding)


def _finalize_stream(
    bundle: ModelBundle, idx: np.ndarray, orig_len: int, entropy_coding: bool
) -> bytes:
    """Header + planes for `idx`. With entropy coding, whichever of the
    coded and the fixed-width stream is smaller is emitted: on near-uniform
    code usage the adaptive coder's overhead can exceed fixed-width packing,
    and the header flag tells decompress which one it got."""
    cfg = bundle.cfg

    def _stream(flags: int) -> bytes:
        header = bitstream.BitstreamHeader(
            model_name=cfg.name,
            bits=cfg.bits_per_codebook,
            n_q=idx.shape[-1],
            sample_rate=cfg.sample_rate,
            hop=cfg.hop,
            num_frames=idx.shape[0],
            orig_len=orig_len,
            flags=flags,
            fingerprint=codebook_fingerprint(bundle.rvq),
        )
        return bitstream.serialize(header, idx)

    raw = _stream(bitstream.FLAG_FINGERPRINT)
    if not entropy_coding:
        return raw
    coded = _stream(bitstream.FLAG_FINGERPRINT | bitstream.FLAG_ENTROPY)
    return coded if len(coded) < len(raw) else raw


def _check_stream_identity(bundle: ModelBundle, header) -> None:
    """Reject a stream the loaded model cannot faithfully decode: the model
    identity (name, sample rate, hop, bits) must match, and so must the
    codebook fingerprint when the stream carries one."""
    cfg = bundle.cfg
    if (
        header.hop != cfg.hop
        or header.sample_rate != cfg.sample_rate
        or header.bits != cfg.bits_per_codebook
        or header.model_name != cfg.name
    ):
        raise ValueError(
            f"bitstream was made by model {header.model_name!r} "
            f"(sr={header.sample_rate}, hop={header.hop}, bits={header.bits}); "
            f"loaded model {cfg.name!r} (sr={cfg.sample_rate}, hop={cfg.hop}, "
            f"bits={cfg.bits_per_codebook}) is incompatible"
        )
    if header.flags & bitstream.FLAG_FINGERPRINT:
        have = codebook_fingerprint(bundle.rvq)
        if header.fingerprint != have:
            raise bitstream.BitstreamError(
                f"codebook fingerprint mismatch: stream was encoded with "
                f"codebooks {header.fingerprint:#010x}, loaded model has "
                f"{have:#010x} (same config, different checkpoint?)"
            )


def decompress(
    bundle: ModelBundle, blob: bytes, n_q: Optional[int] = None
) -> np.ndarray:
    """Serialized bitstream -> (orig_len,) waveform."""
    header, idx = bitstream.deserialize(blob, max_n_q=n_q)
    _check_stream_identity(bundle, header)
    wav = decode(bundle, idx)
    return wav[: header.orig_len]


def streaming_compress(
    bundle: ModelBundle,
    wav: ArrayLike,
    chunk_seconds: float = 1.0,
    n_q: Optional[int] = None,
    *,
    entropy_coding: bool = False,
    queue_chunks: int = 4,
) -> bytes:
    """compress() through the stateful chunked encoder: bounded memory for
    arbitrarily long inputs; the stream of batch compress where batch and
    streaming run the same float operations (see `streaming`). Requires a
    causal config. queue_chunks: chunks encoded per pass
    (`StreamingEncoder.push_many`); 1 is strict chunk-at-a-time."""
    from nsc_tpu_torch.streaming import StreamingEncoder

    arr, single = _as_batch(wav)
    if not single:
        raise ValueError("streaming_compress takes a single (T,) waveform")
    arr = arr[0]
    cfg = bundle.cfg
    chunk = max(cfg.hop, int(chunk_seconds * cfg.sample_rate) // cfg.hop * cfg.hop)
    padded = np.pad(arr, (0, (-len(arr)) % cfg.hop))
    enc = StreamingEncoder(bundle.model, bundle.params, bundle.rvq, n_q=n_q)
    chunks = [padded[i : i + chunk] for i in range(0, len(padded), chunk)]
    group = max(1, int(queue_chunks))
    blocks: list = []
    for g in range(0, len(chunks), group):
        blocks.extend(enc.push_many(chunks[g : g + group]))
    idx = np.concatenate(blocks, axis=0)
    return _finalize_stream(bundle, idx, arr.shape[0], entropy_coding)


def streaming_decompress(
    bundle: ModelBundle,
    blob: bytes,
    chunk_seconds: float = 1.0,
    n_q: Optional[int] = None,
    *,
    queue_chunks: int = 4,
) -> np.ndarray:
    """decompress() through the stateful chunked decoder: bounded memory for
    arbitrarily long streams. Chunks have a fixed frame count; the last,
    partial one is zero-padded and trimmed (trailing frames cannot change
    earlier samples of a causal decoder). queue_chunks: index blocks decoded
    per pass; 1 is chunk-at-a-time."""
    from nsc_tpu_torch.streaming import StreamingDecoder

    header, idx = bitstream.deserialize(blob, max_n_q=n_q)
    _check_stream_identity(bundle, header)
    cfg = bundle.cfg
    fpc = max(1, int(chunk_seconds * cfg.sample_rate) // cfg.hop)
    dec = StreamingDecoder(bundle.model, bundle.params, bundle.rvq, n_q=n_q)
    blocks, gots = [], []
    for s in range(0, idx.shape[0], fpc):
        c = idx[s : s + fpc]
        gots.append(c.shape[0])
        if c.shape[0] < fpc:
            c = np.pad(c, ((0, fpc - c.shape[0]), (0, 0)))
        blocks.append(c)
    group = max(1, int(queue_chunks))
    parts = []
    for g in range(0, len(blocks), group):
        outs = dec.push_many(blocks[g : g + group])
        for out, got in zip(outs, gots[g : g + group]):
            parts.append(out[: got * cfg.hop])
    wav = np.concatenate(parts, axis=0) if parts else np.zeros(0, np.float32)
    return np.asarray(wav, np.float32)[: header.orig_len]
