"""Streaming chunked encode/decode (counterpart of `nsc_tpu/streaming.py`).

Streaming over chunks gives the codebook indices of batch encode of the
concatenated audio, where both run the same float operations: every causal
conv carries its left receptive field ((K-1)*dilation input samples at its
layer's rate) as explicit state, and zero-initialized state is batch mode's
zero left-padding. Strided layers stay aligned because chunk lengths are
multiples of the hop. Transposed convs (streaming decode) carry a
(K - stride)-sample overlap-add tail of pre-bias partial sums.

Layout is the port's (N, C, T); state tensors are (N, C, context) in the
config's compute dtype, on the bundle's device. The residual units run op
by op, as in the JAX package (the stack kernels take whole sequences), so a
bundle whose batch path runs a stack kernel may differ from batch encode
where the two float schedules round differently. Quantize and dequantize
go through `ops.rvq` with the model's RVQ kernel option, as
`NeuralSpeechCodec.encode`/`decode` do: a serving bundle launches K2 and K3
once per push. Each push runs under `float32_numerics` (no TF32).

The streaming convs are the float convs whatever the config's `quant` and
`conv_backend`, as the JAX package's streaming convs (which call
`ops.conv.conv1d` directly): an int8 bundle streams through its float
weights (its "a_s" leaves unread), so it gives what its float bundle
streams, not what its int8 batch path gives.

A bf16 config's convs take their operands, the bf16 activations and the
weights rounded to bf16, exactly into float32, sum the products in float32
and round the result to bf16 once: a bf16 conv's arithmetic, with a
summation order that does not depend on the sequence length. cuDNN's bf16
kernels choose their order by shape, so a 1 s chunk and a 4 s queue of
chunks would round some outputs differently, and on trained codebooks,
whose argmin margins are thin, push_many would not give the indices of
sequential pushes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nsc_tpu_torch.configs import CodecConfig
from nsc_tpu_torch.models.codec import DTYPES, NeuralSpeechCodec
from nsc_tpu_torch.ops import conv as C
from nsc_tpu_torch.ops import rvq as rvq_ops
from nsc_tpu_torch.ops.precision import float32_numerics
from nsc_tpu_torch.utils import profiling

State = Dict[str, Any]


# ---------------------------------------------------------------------------
# stateful conv primitives
# ---------------------------------------------------------------------------


def conv1d_init_state(p, n: int, dilation: int = 1,
                      dtype=torch.float32) -> Optional[torch.Tensor]:
    """Zero left context (N, Cin, (K-1)*dilation) for conv `p` ({'w': (Cout,
    Cin, K), 'b'}), or None for a 1-tap conv."""
    w = p["w"]
    ctx = (w.shape[-1] - 1) * dilation
    if ctx == 0:
        return None
    return torch.zeros(n, w.shape[1], ctx, dtype=dtype, device=w.device)


def _weight(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The float32 values of `w` rounded to x's dtype (see the module doc)."""
    return w.to(x.dtype).float()


def _conv1d_valid(x: torch.Tensor, p, stride: int, dilation: int) -> torch.Tensor:
    """`ops.conv.conv1d(..., padding="valid")` with float32 sums (see the
    module doc): the result in x's dtype, the bias added after it in x's
    dtype."""
    y = F.conv1d(x.float(), _weight(p["w"], x), stride=stride, dilation=dilation).to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(y.dtype)[None, :, None]
    return y


def conv1d_stream(
    x: torch.Tensor, p, state: Optional[torch.Tensor], *,
    stride: int = 1, dilation: int = 1,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Causal conv over one (N, Cin, T) chunk with carried left context.
    T must be a multiple of `stride`."""
    if state is None:
        return _conv1d_valid(x, p, stride, dilation), None
    xx = torch.cat([state.to(x.dtype), x], dim=-1)
    y = _conv1d_valid(xx, p, stride, dilation)
    return y, xx[..., xx.shape[-1] - state.shape[-1]:]


def conv_transpose1d_init_state(p, n: int, stride: int,
                                dtype=torch.float32) -> Optional[torch.Tensor]:
    """Zero overlap-add tail (N, Cout, K - stride) for transposed conv `p`
    ({'w': (Cin, Cout, K), 'b'}), or None when K == stride."""
    w = p["w"]
    tail = w.shape[-1] - stride
    if tail <= 0:
        return None
    return torch.zeros(n, w.shape[1], tail, dtype=dtype, device=w.device)


def conv_transpose1d_stream(
    x: torch.Tensor, p, state: Optional[torch.Tensor], *, stride: int
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Causal transposed conv over one (N, Cin, T) chunk -> (N, Cout,
    T*stride), with the overlap-add tail carried to the next chunk."""
    # full transposed conv, pre-bias: length (T-1)*stride + K
    y_full = F.conv_transpose1d(x.float(), _weight(p["w"], x), stride=stride).to(x.dtype)
    t_out = x.shape[-1] * stride
    new_state = None
    if state is not None:
        tail = state.shape[-1]
        y_full[..., :tail] += state.to(y_full.dtype)
        new_state = y_full[..., t_out : t_out + tail]
    y = y_full[..., :t_out]
    if "b" in p:
        y = y + p["b"].to(y.dtype)[None, :, None]
    return y, new_state


# ---------------------------------------------------------------------------
# streaming encoder (mirrors seanet.apply_encoder, units op by op)
# ---------------------------------------------------------------------------


def _unit_init_state(p, n: int, dilation: int, dtype) -> State:
    return {
        "conv1": conv1d_init_state(p["conv1"], n, dilation, dtype),
        "conv2": conv1d_init_state(p["conv2"], n, dtype=dtype),
    }


def _unit_stream(p, st: State, x: torch.Tensor, dilation: int,
                 cfg: CodecConfig) -> Tuple[torch.Tensor, State]:
    h = C.activation(cfg.activation, x, p["act1"])
    h, s1 = conv1d_stream(h, p["conv1"], st["conv1"], dilation=dilation)
    h = C.activation(cfg.activation, h, p["act2"])
    h, s2 = conv1d_stream(h, p["conv2"], st["conv2"])
    return x + h, {"conv1": s1, "conv2": s2}


def _dtype(cfg: CodecConfig, dtype):
    return DTYPES[cfg.compute_dtype] if dtype is None else dtype


def encoder_init_state(params, cfg: CodecConfig, n: int, dtype=None) -> State:
    """Zero state for the encoder `params` (the port's materialized tree),
    in the compute dtype unless `dtype` is given."""
    dt = _dtype(cfg, dtype)
    return {
        "stem": conv1d_init_state(params["stem"], n, dtype=dt),
        "stages": [
            {"units": [_unit_init_state(u, n, d, dt)
                       for u, d in zip(stage["units"], cfg.dilations)],
             "down": conv1d_init_state(stage["down"], n, dtype=dt)}
            for stage in params["stages"]
        ],
        "final": conv1d_init_state(params["final"], n, dtype=dt),
    }


def encoder_stream(params, state: State, chunk: torch.Tensor,
                   cfg: CodecConfig) -> Tuple[torch.Tensor, State]:
    """One chunk (N, 1, T), T % hop == 0 -> ((N, D, T/hop) latents, state')."""
    h, s_stem = conv1d_stream(chunk, params["stem"], state["stem"])
    new_stages = []
    for stage, st_stage, stride in zip(params["stages"], state["stages"], cfg.strides):
        new_units = []
        for unit, st_u, dil in zip(stage["units"], st_stage["units"], cfg.dilations):
            h, s_u = _unit_stream(unit, st_u, h, dil, cfg)
            new_units.append(s_u)
        h = C.activation(cfg.activation, h, stage["down_act"])
        h, s_down = conv1d_stream(h, stage["down"], st_stage["down"], stride=stride)
        new_stages.append({"units": new_units, "down": s_down})
    h = C.activation(cfg.activation, h, params["final_act"])
    z, s_final = conv1d_stream(h, params["final"], state["final"])
    return z, {"stem": s_stem, "stages": new_stages, "final": s_final}


# ---------------------------------------------------------------------------
# streaming decoder (mirrors seanet.apply_decoder; causal configs)
# ---------------------------------------------------------------------------


def decoder_init_state(params, cfg: CodecConfig, n: int, dtype=None) -> State:
    dt = _dtype(cfg, dtype)
    return {
        "stem": conv1d_init_state(params["stem"], n, dtype=dt),
        "stages": [
            {"up": conv_transpose1d_init_state(stage["up"], n, stride, dt),
             "units": [_unit_init_state(u, n, d, dt)
                       for u, d in zip(stage["units"], cfg.dilations)]}
            for stage, stride in zip(params["stages"], reversed(cfg.strides))
        ],
        "final": conv1d_init_state(params["final"], n, dtype=dt),
    }


def decoder_stream(params, state: State, z: torch.Tensor,
                   cfg: CodecConfig) -> Tuple[torch.Tensor, State]:
    """(N, D, F) latent chunk -> ((N, 1, F*hop) waveform, state')."""
    h, s_stem = conv1d_stream(z, params["stem"], state["stem"])
    new_stages = []
    for stage, st_stage, stride in zip(params["stages"], state["stages"],
                                       reversed(cfg.strides)):
        h = C.activation(cfg.activation, h, stage["up_act"])
        h, s_up = conv_transpose1d_stream(h, stage["up"], st_stage["up"], stride=stride)
        new_units = []
        for unit, st_u, dil in zip(stage["units"], st_stage["units"], cfg.dilations):
            h, s_u = _unit_stream(unit, st_u, h, dil, cfg)
            new_units.append(s_u)
        new_stages.append({"up": s_up, "units": new_units})
    h = C.activation(cfg.activation, h, params["final_act"])
    h, s_final = conv1d_stream(h, params["final"], state["final"])
    return torch.tanh(h), {"stem": s_stem, "stages": new_stages, "final": s_final}


# ---------------------------------------------------------------------------
# user-facing streaming sessions
# ---------------------------------------------------------------------------


def _check_causal(model: NeuralSpeechCodec) -> None:
    if not model.cfg.causal:
        raise ValueError("streaming requires a causal model config")


@dataclasses.dataclass
class StreamingEncoder:
    """Stateful chunked encoder. Feed (N, T) chunks with T % hop == 0; the
    indices are those of batch encode of the concatenation."""

    model: NeuralSpeechCodec
    params: dict
    rvq: dict
    n_q: Optional[int] = None
    _state: Any = None

    def __post_init__(self):
        _check_causal(self.model)

    @property
    def device(self) -> torch.device:
        return self.rvq["codebooks"].device

    def reset(self, batch_size: int = 1) -> None:
        self._state = encoder_init_state(self.params["encoder"], self.model.cfg, batch_size)

    @torch.inference_mode()
    @float32_numerics()
    def push(self, chunk) -> np.ndarray:
        """(N, T) or (T,) chunk -> (N, T/hop, n_q) or (T/hop, n_q) indices."""
        arr = np.asarray(chunk, dtype=np.float32)
        single = arr.ndim == 1
        if single:
            arr = arr[None]
        if self._state is None:
            self.reset(arr.shape[0])
        cfg = self.model.cfg
        if arr.shape[1] % cfg.hop:
            raise ValueError(f"chunk length {arr.shape[1]} not a multiple of hop {cfg.hop}")
        with profiling.span("stream.encode"):
            with profiling.span("stream.encode.to_device"):
                x = torch.tensor(arr, device=self.device)[:, None, :].to(self.model.compute_dtype)
            with profiling.span("stream.encode.model"):
                z, self._state = encoder_stream(self.params["encoder"], self._state, x, cfg)
                z = self.model._project_in(self.params, z.transpose(1, 2))
                idx = rvq_ops.quantize(self.rvq, z, n_q=self.n_q, kernel=self.model.kernels.rvq)
            with profiling.span("stream.encode.to_host"):
                idx = idx.cpu().numpy()
        return idx[0] if single else idx

    def push_many(self, chunks) -> list:
        """Encode several queued chunks in one pass; one (N, T_i/hop, n_q)
        index block per chunk. The carried state evolves as through
        sequential pushes, so the indices are theirs where the float ops
        agree; every chunk must be hop-aligned, as sequential pushes would
        require."""
        chunks = [np.asarray(c) for c in chunks]
        if not chunks:
            return []
        hop = self.model.cfg.hop
        lens = [c.shape[-1] for c in chunks]
        bad = [ln for ln in lens if ln % hop]
        if bad:
            raise ValueError(f"chunk length {bad[0]} not a multiple of hop {hop}")
        idx = self.push(np.concatenate(chunks, axis=-1))
        out, f0 = [], 0
        for ln in lens:
            f1 = f0 + ln // hop
            out.append(idx[..., f0:f1, :])
            f0 = f1
        return out


@dataclasses.dataclass
class StreamingDecoder:
    """Stateful chunked decoder (symmetric to StreamingEncoder)."""

    model: NeuralSpeechCodec
    params: dict
    rvq: dict
    n_q: Optional[int] = None
    _state: Any = None

    def __post_init__(self):
        _check_causal(self.model)

    @property
    def device(self) -> torch.device:
        return self.rvq["codebooks"].device

    def reset(self, batch_size: int = 1) -> None:
        self._state = decoder_init_state(self.params["decoder"], self.model.cfg, batch_size)

    @torch.inference_mode()
    @float32_numerics()
    def push(self, indices) -> np.ndarray:
        """(N, F, n_q) or (F, n_q) indices -> (N, F*hop) or (F*hop,)
        float32 waveform."""
        idx = np.asarray(indices, dtype=np.int32)
        single = idx.ndim == 2
        if single:
            idx = idx[None]
        if self._state is None:
            self.reset(idx.shape[0])
        model = self.model
        with profiling.span("stream.decode"):
            with profiling.span("stream.decode.to_device"):
                x = torch.tensor(idx, device=self.device)
            with profiling.span("stream.decode.model"):
                z = rvq_ops.dequantize(self.rvq, x, n_q=self.n_q, kernel=model.kernels.rvq)
                z = model._project_out(self.params, z).to(model.compute_dtype)
                wav, self._state = decoder_stream(self.params["decoder"], self._state,
                                                  z.transpose(1, 2), model.cfg)
            with profiling.span("stream.decode.to_host"):
                wav = wav[:, 0, :].float().cpu().numpy()
        return wav[0] if single else wav

    def push_many(self, index_blocks) -> list:
        """Decode several index blocks in one pass; one waveform chunk per
        block."""
        blocks = [np.asarray(b) for b in index_blocks]
        if not blocks:
            return []
        hop = self.model.cfg.hop
        frames = [b.shape[-2] for b in blocks]
        wav = self.push(np.concatenate(blocks, axis=-2))
        out, t0 = [], 0
        for f in frames:
            t1 = t0 + f * hop
            out.append(wav[..., t0:t1])
            t0 = t1
        return out
