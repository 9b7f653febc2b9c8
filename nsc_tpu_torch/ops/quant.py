"""int8 W8A8 convolutions for serving, with static calibration
(counterpart of `nsc_tpu/ops/quant.py`, in the port's (N, C, T) layout).

Scheme, as in the JAX package:

  * weights: per-output-channel symmetric int8 (amax / 127), quantized at
    each call from the float32 weight;
  * activations: per-tensor symmetric int8 at each conv input, from the
    tensor's own amax (dynamic) or from a calibrated "a_s" leaf in the
    conv's params: a scalar (per-tensor), or a (Cin,) vector (per-channel)
    that is folded into the weights before they are quantized, so the
    dequantization factor is the weight scale alone;
  * the product of the int8 codes is summed exactly in int32, dequantized
    as y32 * (sx * sw) in float32, the bias added, and the result cast to
    the input's dtype.

Rounding is half to even (`torch.round`, as `jnp.round`), so on the same
inputs the codes, the int32 sums and the outputs are the JAX package's bit
for bit.

The int32 product (`int_conv1d`, `int_conv_transpose1d`) has two routes.
On a CUDA tensor: im2col of the int8 codes (a polyphase frame matrix for
the transposed conv), then `torch._int_mm`, cuBLASLt's int8 x int8 -> int32
product on the tensor cores, the weight operand in column-major. The JAX package computes this product with
XLA's convolution, outside any Pallas kernel, so no hand-written kernel
replaces one here. `_int_mm` takes more than 16 rows and inner and output
widths that are multiples of 8, so the operands are padded with zero rows
and columns (the stem's Cin x k = 7, the decoder final's Cout = 1), which
add nothing to the sums. On the CPU: the plain version, a float64
convolution of the codes (every partial sum is an integer below 2^53, so
it is exact) cast to int32. Both give the same int32 sums; another device
raises. `LAUNCHES["int_mm"]` counts the CUDA route's products.

Calibration (`calibrate_codec`) runs the int8 model eagerly on a few
batches with the dynamic scales, records each conv site's per-channel
input amax in call order, and returns params with an "a_s" leaf at every
site. The recorder is a context manager over one module-level slot: a
second calibration while one runs raises, as the JAX package's global
does.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from nsc_tpu_torch import kernels

Params = Dict[str, torch.Tensor]

# _int_mm's shape rules on CUDA: rows > MIN_ROWS, inner and output widths
# multiples of ALIGN
MIN_ROWS = 16
ALIGN = 8

_lock = threading.Lock()
_record: Optional[List[torch.Tensor]] = None


@contextlib.contextmanager
def recording():
    """Collect the per-channel input amax of every dynamic int8 conv site
    run inside the block, in call order. Raises if a recording is already
    open (calibration is not reentrant)."""
    global _record
    with _lock:
        if _record is not None:
            raise RuntimeError("calibrate_codec is not reentrant/thread-safe")
        _record = []
    try:
        yield _record
    finally:
        with _lock:
            _record = None


def _quantize_weight(w: torch.Tensor, out_axis: int):
    """float32 weight -> (int8 codes, float32 scales over `out_axis`): the
    scale of each output channel is max(amax, 1e-12) / 127."""
    axes = tuple(a for a in range(w.dim()) if a != out_axis)
    amax = torch.amax(torch.abs(w), dim=axes)
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    shape = [1] * w.dim()
    shape[out_axis] = -1
    w8 = torch.clamp(torch.round(w / scale.reshape(shape)), -127, 127).to(torch.int8)
    return w8, scale


def _quantize_act(x: torch.Tensor, static_amax: Optional[torch.Tensor] = None):
    """(N, C, T) -> (int8 codes, scale): per-tensor from x's amax, or from a
    calibrated amax, a scalar or a (C,) vector (then one scale per
    channel). Without a calibrated amax, an open `recording` gets the
    per-channel amax."""
    xf = x.float()
    if static_amax is None:
        amax = torch.amax(torch.abs(xf))
        if _record is not None:
            _record.append(torch.amax(torch.abs(xf), dim=(0, 2)))
    else:
        amax = static_amax.float()
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    s = scale.reshape(1, -1, 1) if scale.dim() == 1 else scale
    x8 = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    return x8, scale


def _quantize_pair(x: torch.Tensor, p: Params, in_axis: int, out_axis: int):
    """The codes of one conv site: (x8, w8, dequantization factor (Cout,)).
    A per-channel "a_s" is folded into the weight along `in_axis` first."""
    w = p["w"].float()
    a_s = p.get("a_s")
    if a_s is not None and a_s.dim() == 1:
        s_c = torch.clamp_min(a_s.float(), 1e-12) / 127.0
        shape = [1] * w.dim()
        shape[in_axis] = -1
        x8, _ = _quantize_act(x, a_s)
        w8, sw = _quantize_weight(w * s_c.reshape(shape), out_axis)
        return x8, w8, sw
    x8, sx = _quantize_act(x, a_s)
    w8, sw = _quantize_weight(w, out_axis)
    return x8, w8, sx * sw


def _dequantize(y32: torch.Tensor, deq: torch.Tensor, p: Params, dtype) -> torch.Tensor:
    y = y32.float() * deq.reshape(1, -1, 1)
    if "b" in p:
        y = y + p["b"].float().reshape(1, -1, 1)
    return y.to(dtype)


# ---------------------------------------------------------------------------
# the int32 product
# ---------------------------------------------------------------------------


def int_conv1d_plain(x8: torch.Tensor, w8: torch.Tensor, stride: int, dilation: int):
    """(N, Cin, T) int8 (padded), (Cout, Cin, K) int8 -> (N, Cout, T') int32,
    through an exact float64 convolution."""
    y = F.conv1d(x8.double(), w8.double(), stride=stride, dilation=dilation)
    return y.to(torch.int32)


def int_conv_transpose1d_plain(x8: torch.Tensor, w8: torch.Tensor, stride: int):
    """(N, Cin, F) int8, (Cin, Cout, K) int8 -> (N, Cout, (F-1)*stride + K)
    int32: the full transposed conv, through an exact float64 one."""
    y = F.conv_transpose1d(x8.double(), w8.double(), stride=stride)
    return y.to(torch.int32)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _int_matmul(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ bt.T, bt (N, K) int8 -> (M, N) int32 by `torch._int_mm`,
    with M, K and N padded with zeros to its shape rules. The right operand
    goes in column-major, as bt's transpose: cuBLASLt's int8 product takes
    every shape in that layout (row-major operands on both sides are
    refused at some shapes)."""
    m, k = a.shape
    n = bt.shape[0]
    mp, kp, np_ = max(m, MIN_ROWS + 1), _round_up(k, ALIGN), _round_up(n, ALIGN)
    if (mp, kp) != (m, k):
        a = F.pad(a, (0, kp - k, 0, mp - m))
    if (np_, kp) != (n, k):
        bt = F.pad(bt, (0, kp - k, 0, np_ - n))
    out = torch._int_mm(a.contiguous(), bt.contiguous().t())
    kernels.LAUNCHES["int_mm"] += 1
    return out[:m, :n]


def int_conv1d_mm(x8: torch.Tensor, w8: torch.Tensor, stride: int, dilation: int):
    """`int_conv1d_plain` as im2col + one int8 matmul: rows are the output
    positions of every batch row, columns the (Cin, tap) pairs."""
    n, cin, t = x8.shape
    cout, _, k = w8.shape
    t_out = (t - (k - 1) * dilation - 1) // stride + 1
    cols = torch.stack(
        [x8[:, :, j * dilation: j * dilation + (t_out - 1) * stride + 1: stride]
         for j in range(k)], dim=-1)  # (N, Cin, T', K)
    a = cols.permute(0, 2, 1, 3).reshape(n * t_out, cin * k)
    y = _int_matmul(a, w8.reshape(cout, cin * k))
    return y.reshape(n, t_out, cout).permute(0, 2, 1)


def int_conv_transpose1d_mm(x8: torch.Tensor, w8: torch.Tensor, stride: int):
    """`int_conv_transpose1d_plain` as one int8 matmul by phases: output
    sample f * s + p is sum_m x[f - m] . w[:, :, p + m * s], so a row of
    frames x[f], x[f-1], ... against a (ceil(K/s) Cin, s Cout) weight gives
    all s phases of frame f; the samples past F * s (the full length's tail)
    follow from frames F .. F + ceil(K/s) - 2 of the zero-extended input."""
    n, cin, f = x8.shape
    _, cout, k = w8.shape
    s = stride
    taps = math.ceil(k / s)
    full = (f - 1) * s + k
    frames = -(-full // s)  # output frames that cover the full length
    xp = F.pad(x8, (taps - 1, frames - f))  # x[i] at i + taps - 1; zeros past F
    rows = torch.stack([xp[:, :, taps - 1 - m: taps - 1 - m + frames] for m in range(taps)],
                       dim=-1)  # (N, Cin, frames, taps): [.., i, m] = x[i - m]
    a = rows.permute(0, 2, 3, 1).reshape(n * frames, taps * cin)
    wt = F.pad(w8, (0, taps * s - k))  # (Cin, Cout, taps * s), zero past K
    wt = wt.reshape(cin, cout, taps, s).permute(3, 1, 2, 0)  # (s, Cout, taps, Cin)
    y = _int_matmul(a, wt.reshape(s * cout, taps * cin))
    y = y.reshape(n, frames * s, cout)[:, :full]
    return y.permute(0, 2, 1)


def int_conv1d(x8: torch.Tensor, w8: torch.Tensor, stride: int = 1, dilation: int = 1):
    """The exact int32 sums of a conv of int8 codes (x8 already padded)."""
    if x8.device.type == "cpu":
        return int_conv1d_plain(x8, w8, stride, dilation)
    if x8.device.type == "cuda":
        return int_conv1d_mm(x8, w8, stride, dilation)
    raise ValueError(f"int8 conv: unsupported device {x8.device}")


def int_conv_transpose1d(x8: torch.Tensor, w8: torch.Tensor, stride: int):
    """The exact int32 sums of a full transposed conv of int8 codes."""
    if x8.device.type == "cpu":
        return int_conv_transpose1d_plain(x8, w8, stride)
    if x8.device.type == "cuda":
        return int_conv_transpose1d_mm(x8, w8, stride)
    raise ValueError(f"int8 conv: unsupported device {x8.device}")


# ---------------------------------------------------------------------------
# the convs
# ---------------------------------------------------------------------------


def conv1d_int8(
    x: torch.Tensor, p: Params, *, stride: int = 1, dilation: int = 1,
    padding: str = "causal",
) -> torch.Tensor:
    """W8A8 conv with the semantics of `ops.conv.conv1d`: (N, Cin, T) ->
    (N, Cout, T'), p {'w': (Cout, Cin, K), 'b', ['a_s']}."""
    x8, w8, deq = _quantize_pair(x, p, in_axis=1, out_axis=0)
    eff = (w8.shape[-1] - 1) * dilation
    if padding == "causal":
        pads = (eff, 0)
    elif padding == "same":
        pads = (eff // 2, eff - eff // 2)
    elif padding == "valid":
        pads = (0, 0)
    else:
        raise ValueError(f"bad padding {padding!r}")
    if pads != (0, 0):
        x8 = F.pad(x8, pads)
    return _dequantize(int_conv1d(x8, w8, stride, dilation), deq, p, x.dtype)


def conv_transpose1d_int8(x: torch.Tensor, p: Params, *, stride: int) -> torch.Tensor:
    """W8A8 causal transposed conv: (N, Cin, F) -> (N, Cout, F*stride) (the
    full output trimmed by K - stride on the right), p {'w': (Cin, Cout, K),
    'b', ['a_s']}."""
    x8, w8, deq = _quantize_pair(x, p, in_axis=0, out_axis=1)
    y32 = int_conv_transpose1d(x8, w8, stride)
    trim = w8.shape[-1] - stride
    if trim > 0:
        y32 = y32[..., :-trim]
    return _dequantize(y32, deq, p, x.dtype)


# ---------------------------------------------------------------------------
# static calibration
# ---------------------------------------------------------------------------


def _conv_sites(params):
    """Every conv param dict in forward-call order (as `seanet.apply_encoder`
    and `apply_decoder` call them; `calibrate_codec` asserts the count).
    Encoder: stem; per stage the units' conv1, conv2, then the strided down
    conv; final. Decoder: stem; per stage the transposed up conv, then the
    units; final."""
    e = params["encoder"]
    yield e["stem"]
    for st in e["stages"]:
        for u in st["units"]:
            yield u["conv1"]
            yield u["conv2"]
        yield st["down"]
    yield e["final"]
    d = params["decoder"]
    yield d["stem"]
    for st in d["stages"]:
        yield st["up"]
        for u in st["units"]:
            yield u["conv1"]
            yield u["conv2"]
    yield d["final"]


# the packed copies of a stage's units that a kernel route runs; an int8
# model runs its units op by op and carries none
PACKED_KEYS = ("stack", "stack_cl", "fused")


def calibrate_codec(model, params, rvq, wav_batches, *, per_channel: bool = False) -> dict:
    """Run the int8 `model` (cfg.quant "int8") eagerly on each (N, T) batch of
    `wav_batches` with dynamic scales, and return a copy of `params` with an
    "a_s" leaf at every conv site: the largest input amax the site saw, a
    scalar (per-tensor) or, with per_channel=True, a (Cin,) vector (folded
    into the weights, see `_quantize_pair`). The JAX package measured
    per-channel worse on its trained checkpoint (0.44 against 0.88 index
    agreement with float). The copy drops the stages' packed kernel
    weights, which an int8 model does not run. The float path ignores
    "a_s"."""
    assert model.cfg.quant == "int8", "set cfg.quant='int8' for calibration"
    site_amax = None
    with recording() as rec, torch.inference_mode():
        for wav in wav_batches:
            rec.clear()
            x = torch.as_tensor(wav, dtype=torch.float32).to(rvq["codebooks"].device)
            model.reconstruct(params, rvq, x)
            if site_amax is None:
                site_amax = list(rec)
            else:
                assert len(rec) == len(site_amax), "conv call order changed"
                site_amax = [torch.maximum(a, b) for a, b in zip(site_amax, rec)]
    assert site_amax, "no calibration batches given"
    if not per_channel:
        site_amax = [torch.amax(a) for a in site_amax]
    return with_scales(params, site_amax)


def with_scales(params, scales) -> dict:
    """A copy of `params` with scales[i] (a tensor: a scalar or a (Cin,)
    vector) as the "a_s" leaf of the i-th conv site in call order, and
    without the stages' packed kernel weights, which an int8 model does
    not run."""
    sites = list(_conv_sites(params))
    assert len(sites) == len(scales), (
        f"walk order out of sync: {len(sites)} sites vs {len(scales)} recorded activations"
    )
    flat = {id(s): torch.as_tensor(a).float().clone() for s, a in zip(sites, scales)}

    def rebuild(node):
        if isinstance(node, dict):
            new = {k: rebuild(v) for k, v in node.items() if k not in PACKED_KEYS}
            if id(node) in flat:
                new["a_s"] = flat[id(node)].to(node["w"].device)
            return new
        if isinstance(node, list):
            return [rebuild(v) for v in node]
        return node

    return rebuild(params)
