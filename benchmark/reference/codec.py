"""Plain float32 reference of the codec: SEANet encoder and decoder with
weight-norm convolutions and snake activations, and a greedy residual
vector quantizer. Written from the architecture's description (SoundStream,
arXiv:2107.03312; the snake of DAC, arXiv:2306.06546) and the configuration
files of this benchmark; it imports nothing of the program under test.

Weights come in the layout the benchmark makes them in:

  conv   {'v': (K, Cin, Cout), 'g': (Cout,), 'b': (Cout,)}, w = v g / |v|
         (the norm over K and Cin, plus 1e-12 under the root)
  snake  {'alpha': (C,)}
  rvq    codebooks (n_q, K, D)

Activations are (N, C, T). Every convolution runs through `Numerics.conv`,
which in "float32" is a plain float32 convolution; in "bf16" it rounds its
input and weight to bfloat16, sums in float32 and rounds its output to
bfloat16, as it rounds each activation and residual sum (the rounding the
serving configuration states: the yardstick of how far rounding alone
moves a waveform); "fp8" rounds in the same places to float8 e4m3, each
tensor under its own scale (the control of the benchmark's comparison: the
serving path's bf16 computed one precision lower).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

Tree = Dict

# snake_fast: sin^2 by one range reduction to [-pi/2, pi/2] and the even
# polynomial u (c0 + c1 u + c2 u^2 + c3 u^3), u = r^2 (a Chebyshev-node fit
# of sin^2(sqrt(u))/u), constants rounded to float32.
_INV_PI = float(np.float32(1.0 / math.pi))
_PI = float(np.float32(math.pi))
_C3 = float(np.float32(-0.00254553))
_C2 = float(np.float32(0.04350543))
_C1 = float(np.float32(-0.33287596))
_C0 = float(np.float32(0.99996482))

FP8_MAX = 448.0  # largest finite float8 e4m3fn


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one per-tensor scale (amax to 448)."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


def bf16_round(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


class Numerics:
    """Where the reference rounds: "float32" nowhere; "bf16" and "fp8"
    the operands and the output of every convolution, activation and
    residual sum."""

    def __init__(self, precision: str = "float32"):
        if precision not in ("float32", "bf16", "fp8"):
            raise ValueError(f"unknown precision {precision!r}")
        self.precision = precision

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        if self.precision == "fp8":
            return fp8_round(x)
        return bf16_round(x) if self.precision == "bf16" else x

    def output(self, y: torch.Tensor) -> torch.Tensor:
        return self.operand(y)

    def conv(self, x, w, **kw):
        return self.output(F.conv1d(self.operand(x), self.operand(w), **kw))

    def conv_transpose(self, x, w, **kw):
        return self.output(F.conv_transpose1d(self.operand(x), self.operand(w), **kw))


FLOAT32 = Numerics("float32")


def weight(p: Tree) -> torch.Tensor:
    """(K, Cin, Cout) weight of a weight-norm conv."""
    v, g = p["v"].float(), p["g"].float()
    return v * (g / torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True) + 1e-12))


def conv1d(x, p, cfg, *, stride=1, dilation=1, num=FLOAT32):
    """Causal (left pad (K-1) d) or 'same' (the smaller half left) conv;
    the bias added after the convolution."""
    w = weight(p).permute(2, 1, 0)  # (Cout, Cin, K)
    eff = (w.shape[-1] - 1) * dilation
    pads = (eff, 0) if cfg["causal"] else (eff // 2, eff - eff // 2)
    y = num.conv(F.pad(x, pads), w, stride=stride, dilation=dilation)
    return y + p["b"].float()[None, :, None]


def conv_transpose1d(x, p, cfg, *, stride, num=FLOAT32):
    """Transposed conv to exactly T * stride samples: K - stride trimmed on
    the right when causal, split over both edges (the smaller half left)
    otherwise. The weight-norm is per output channel."""
    w = weight(p).permute(1, 2, 0)  # (Cin, Cout, K)
    y = num.conv_transpose(x, w, stride=stride)
    trim = w.shape[-1] - stride
    if trim:
        left = 0 if cfg["causal"] else trim // 2
        y = y[..., left:left + x.shape[-1] * stride]
    return y + p["b"].float()[None, :, None]


def snake(x, act, cfg):
    a = act["alpha"].float().reshape(1, -1, 1)
    if cfg["activation"] == "snake":
        s = torch.sin(a * x)
        return x + s * s / (a + 1e-9)
    if cfg["activation"] != "snake_fast":
        raise ValueError(f"unknown activation {cfg['activation']!r}")
    t = a * x
    r = t - torch.round(t * _INV_PI) * _PI
    u = r * r
    return x + u * (_C0 + u * (_C1 + u * (_C2 + u * _C3))) / (a + 1e-9)


def _act(h, act, cfg, num):
    return num.output(snake(h, act, cfg))


def _units(h, units, cfg, num):
    for u, d in zip(units, cfg["dilations"]):
        y = conv1d(_act(h, u["act1"], cfg, num), u["conv1"], cfg, dilation=d, num=num)
        y = conv1d(_act(y, u["act2"], cfg, num), u["conv2"], cfg, num=num)
        h = num.output(h + y)
    return h


def encode_latents(tree: Tree, wav: torch.Tensor, cfg: dict, num=FLOAT32) -> torch.Tensor:
    """(N, T) waveform -> (N, F, D) latents, T a multiple of the hop."""
    enc = tree["encoder"]
    h = conv1d(wav.float()[:, None, :], enc["stem"], cfg, num=num)
    for st, s in zip(enc["stages"], cfg["strides"]):
        h = _units(h, st["units"], cfg, num)
        h = conv1d(_act(h, st["down_act"], cfg, num), st["down"], cfg, stride=s, num=num)
    h = conv1d(_act(h, enc["final_act"], cfg, num), enc["final"], cfg, num=num)
    return h.transpose(1, 2)


def decode_latents(tree: Tree, z: torch.Tensor, cfg: dict, num=FLOAT32) -> torch.Tensor:
    """(N, F, D) latents -> (N, F * hop) waveform."""
    dec = tree["decoder"]
    h = conv1d(z.float().transpose(1, 2), dec["stem"], cfg, num=num)
    for st, s in zip(dec["stages"], reversed(cfg["strides"])):
        h = conv_transpose1d(_act(h, st["up_act"], cfg, num), st["up"], cfg, stride=s, num=num)
        h = _units(h, st["units"], cfg, num)
    h = conv1d(_act(h, dec["final_act"], cfg, num), dec["final"], cfg, num=num)
    return torch.tanh(h)[:, 0, :]


# ---------------------------------------------------------------------------
# residual vector quantizer
# ---------------------------------------------------------------------------


def quantize(books: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """Greedy residual search: (M, D) -> (M, n_q) indices; distance
    |c|^2 - 2 r.c in float32, the lowest index on ties."""
    r = z.float()
    out = []
    for cb in books.float():
        i = torch.argmin((cb * cb).sum(-1)[None, :] - 2.0 * (r @ cb.t()), dim=-1)
        out.append(i)
        r = r - cb[i]
    return torch.stack(out, -1)


def dequantize(books: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(M, n_q) indices -> (M, D): the sum of the chosen codewords."""
    out = torch.zeros(idx.shape[0], books.shape[-1], device=books.device)
    for q in range(idx.shape[1]):
        out = out + books[q].float()[idx[:, q].long()]
    return out


def index_gaps(books: torch.Tensor, z: torch.Tensor, idx: torch.Tensor) -> List[torch.Tensor]:
    """How much worse each chosen codeword is than the best one, along the
    residual chain the chosen indices make from the reference latents z
    (M, D): per book, (|r - c_idx|^2 - min_c |r - c|^2) over the median
    |r|^2 of that book. An index the reference would also choose reads 0."""
    r = z.float()
    gaps = []
    for q, cb in enumerate(books.float()):
        d = (cb * cb).sum(-1)[None, :] - 2.0 * (r @ cb.t())
        i = idx[:, q].long()
        chosen = d.gather(1, i[:, None])[:, 0]
        scale = torch.median((r * r).sum(-1)).clamp(min=1e-30)
        gaps.append((chosen - d.min(dim=1).values) / scale)
        r = r - cb[i]
    return gaps
