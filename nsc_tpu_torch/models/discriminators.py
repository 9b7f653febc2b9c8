"""Multi-period and multi-scale discriminators (counterpart of
`nsc_tpu/models/discriminators.py`).

  * MPD: one 2D-conv discriminator per period p in (2, 3, 5, 7, 11). The
    waveform is reflect-padded to a multiple of p and viewed as (N, 1, T/p,
    p), so periodic structure lands on the last axis; kernels (5, 1),
    strides (3, 1).
  * MSD: one grouped-1D-conv discriminator per scale (1x, /2, /4, with an
    average pool of kernel 4, stride 2, padding 1 between scales whose
    padded zeros count in the mean).

LeakyReLU(0.1) after every layer but the last. Each sub-discriminator
returns (logits (N, -1), [feature maps]); the features feed the
feature-matching loss. Inside, activations are NCHW / NCW; the JAX package
keeps them channels-last, which changes no mean the losses take.

Parameters stay in the JAX package's layout, one {'v', 'g', 'b'} per conv
with v (*kernel, Cin/groups, Cout): weight-norm is materialized on every
call (w = v * g / sqrt(sum v^2 + 1e-12) over all axes but the last), so
gradients reach v and g, and the trees convert to and from the JAX package
one to one. Widths and groups are read from the parameter shapes.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F

Params = Dict[str, Any]

PERIODS = (2, 3, 5, 7, 11)
MSD_SCALES = 3

# (out_ch, kernel, stride, groups) per MSD layer
_MSD_LAYERS = (
    (16, 15, 1, 1),
    (64, 41, 4, 4),
    (256, 41, 4, 16),
    (1024, 41, 4, 64),
    (1024, 5, 1, 1),
)
_MPD_CHANNELS = (32, 128, 512, 1024)
_LRELU = 0.1


def _weight(p: Params) -> torch.Tensor:
    """Materialized weight-norm conv weight in PyTorch's layout
    (Cout, Cin/groups, *kernel)."""
    v, g = p["v"], p["g"]
    axes = tuple(range(v.dim() - 1))
    norm = torch.sqrt(torch.sum(v * v, dim=axes, keepdim=True) + 1e-12)
    w = v * (g / norm)
    return w.permute(v.dim() - 1, v.dim() - 2, *range(v.dim() - 2))


def _scaled(ch: int, mult: float, groups: int = 1) -> int:
    """Scale a channel width, keeping it a positive multiple of `groups`."""
    return max(1, int(round(ch * mult / groups))) * groups


# ---------------------------------------------------------------------------
# seeded init (distributions of the JAX package's init, other numbers)
# ---------------------------------------------------------------------------


def _init_conv(
    gen: torch.Generator, kernel: Sequence[int], in_ch: int, out_ch: int,
    groups: int = 1,
) -> Params:
    fan_in = (in_ch // groups) * math.prod(kernel)
    bound = 1.0 / math.sqrt(fan_in)
    v = (torch.rand((*kernel, in_ch // groups, out_ch), generator=gen) * 2 - 1) * bound
    g = torch.sqrt(torch.sum(v * v, dim=tuple(range(v.dim() - 1))))
    b = (torch.rand((out_ch,), generator=gen) * 2 - 1) * bound
    return {"v": v, "g": g, "b": b}


def init_discriminators(
    seed: int,
    width_mult: float = 1.0,
    *,
    periods: Sequence[int] = PERIODS,
    msd_scales: int = MSD_SCALES,
) -> Params:
    """Random discriminator weights (float32, CPU) from `seed`."""
    gen = torch.Generator().manual_seed(seed)
    mpd = []
    for _ in periods:
        layers, in_ch = [], 1
        for out_ch in _MPD_CHANNELS:
            out_ch = _scaled(out_ch, width_mult)
            layers.append(_init_conv(gen, (5, 1), in_ch, out_ch))
            in_ch = out_ch
        layers.append(_init_conv(gen, (3, 1), in_ch, 1))
        mpd.append(layers)
    msd = []
    for _ in range(msd_scales):
        layers, in_ch = [], 1
        for out_ch, kernel, _, groups in _MSD_LAYERS:
            g = math.gcd(groups, in_ch)
            out_ch = _scaled(out_ch, width_mult, g)
            layers.append(_init_conv(gen, (kernel,), in_ch, out_ch, g))
            in_ch = out_ch
        layers.append(_init_conv(gen, (3,), in_ch, 1))
        msd.append(layers)
    return {"mpd": mpd, "msd": msd}


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------


def _apply_mpd_one(
    layers: List[Params], wav: torch.Tensor, period: int
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    n, t = wav.shape
    pad = (-t) % period
    x = wav[:, None, :]
    if pad:
        x = F.pad(x, (0, pad), mode="reflect" if pad < t else "constant")
    x = x.reshape(n, 1, -1, period)  # (N, C, T/p, p)
    feats = []
    for i, p in enumerate(layers[:-1]):
        stride = (3, 1) if i < len(layers) - 2 else (1, 1)
        x = F.conv2d(x, _weight(p), p["b"], stride=stride, padding=(2, 0))
        x = F.leaky_relu(x, _LRELU)
        feats.append(x)
    p = layers[-1]
    x = F.conv2d(x, _weight(p), p["b"], padding=(1, 0))
    feats.append(x)
    return x.reshape(n, -1), feats


def _apply_msd_one(
    layers: List[Params], wav: torch.Tensor
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    x = wav[:, None, :]  # (N, 1, T)
    feats = []
    for p, (_, kernel, stride, _) in zip(layers[:-1], _MSD_LAYERS):
        groups = x.shape[1] // p["v"].shape[-2]
        x = F.conv1d(
            x, _weight(p), p["b"], stride=stride, padding=(kernel - 1) // 2,
            groups=groups,
        )
        x = F.leaky_relu(x, _LRELU)
        feats.append(x)
    p = layers[-1]
    x = F.conv1d(x, _weight(p), p["b"], padding=1)
    feats.append(x)
    return x.reshape(x.shape[0], -1), feats


def avg_pool_half(wav: torch.Tensor) -> torch.Tensor:
    """AvgPool1d(kernel=4, stride=2, padding=1), padded zeros counted."""
    return F.avg_pool1d(wav[:, None, :], 4, 2, 1, count_include_pad=True)[:, 0, :]


def apply_discriminators(
    params: Params, wav: torch.Tensor, *, periods: Sequence[int] = PERIODS
) -> List[Tuple[torch.Tensor, List[torch.Tensor]]]:
    """(N, T) -> list over all sub-discriminators of (logits, features)."""
    if len(params["mpd"]) != len(periods):
        raise ValueError(
            f"params built for {len(params['mpd'])} periods, got {periods}"
        )
    outs = [
        _apply_mpd_one(layers, wav, period)
        for layers, period in zip(params["mpd"], periods)
    ]
    x = wav
    for i, layers in enumerate(params["msd"]):
        if i > 0:
            x = avg_pool_half(x)
        outs.append(_apply_msd_one(layers, x))
    return outs
