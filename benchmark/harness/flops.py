"""Floating-point operations the codec and the discriminators need, counted
from a configuration's shapes alone, as `torch.utils.flop_counter` counts
them: 2 per multiply-add of every convolution and matrix product, nothing
for elementwise work.

A convolution's forward is 2 N Cout (Cin/groups) prod(K) prod(T_out) (a
transposed one's 2 N Cin Cout K T_in); the gradient of its weight and the
gradient of its input each cost as much again. The residual quantizer's
search is 2 M K D per book; its sum is a gather.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import List

from benchmark.harness.seeded import MPD_CHANNELS, MSD_LAYERS


@dataclass(frozen=True)
class Conv:
    name: str
    flops: float  # forward, per batch row
    first: bool = False  # reads the network's input (needs no input gradient)


def _conv(name, cin, cout, k, t_out, groups=1, first=False) -> Conv:
    return Conv(name, 2.0 * cout * (cin // groups) * k * t_out, first)


def codec_convs(cfg: dict, samples: int) -> List[Conv]:
    """The codec's convolutions on one row of `samples` samples (a multiple
    of the hop): encoder, then decoder."""
    out, t = [], samples
    bw, rk = cfg["base_width"], cfg["residual_kernel"]
    out.append(_conv("enc.stem", cfg["channels"], bw, cfg["stem_kernel"], t, first=True))
    for i, s in enumerate(cfg["strides"]):
        c = bw * 2 ** i
        for j, _ in enumerate(cfg["dilations"]):
            out.append(_conv(f"enc{i}.u{j}.conv1", c, c, rk, t))
            out.append(_conv(f"enc{i}.u{j}.conv2", c, c, 1, t))
        t //= s
        out.append(_conv(f"enc{i}.down", c, 2 * c, 2 * s, t))
    fw = bw * 2 ** len(cfg["strides"])
    out.append(_conv("enc.final", fw, cfg["latent_dim"], cfg["last_kernel"], t))
    out.append(_conv("dec.stem", cfg["latent_dim"], fw, cfg["last_kernel"], t))
    for i, s in enumerate(reversed(cfg["strides"])):
        c = fw // 2 ** i
        out.append(Conv(f"dec{i}.up", 2.0 * c * (c // 2) * 2 * s * t))
        t *= s
        for j, _ in enumerate(cfg["dilations"]):
            out.append(_conv(f"dec{i}.u{j}.conv1", c // 2, c // 2, rk, t))
            out.append(_conv(f"dec{i}.u{j}.conv2", c // 2, c // 2, 1, t))
    out.append(_conv("dec.final", bw, cfg["channels"], cfg["stem_kernel"], t))
    return out


def rvq_search_flops(cfg: dict, frames: int) -> float:
    """The residual search over all books on `frames` frames."""
    return 2.0 * frames * cfg["codebook_size"] * cfg["codebook_dim"] * cfg["num_quantizers"]


def serve_flops(cfg: dict, rows: int, samples: int) -> float:
    """encode (encoder and search) and decode (sum and decoder) of `rows`
    rows of `samples` samples: the work a request needs, at its own length."""
    frames = samples // math.prod(cfg["strides"])
    return rows * (sum(c.flops for c in codec_convs(cfg, samples))
                   + rvq_search_flops(cfg, frames))


def _out_len(t, k, stride, pad):
    return (t + 2 * pad - k) // stride + 1


def disc_convs(samples: int, periods=(2, 3, 5, 7, 11), msd_scales: int = 3) -> List[Conv]:
    """The discriminators' convolutions on one row of `samples` samples."""
    out = []
    for p in periods:
        h, cin = -(-samples // p), 1
        for i, cout in enumerate(MPD_CHANNELS):
            h = _out_len(h, 5, 3 if i < len(MPD_CHANNELS) - 1 else 1, 2)
            out.append(_conv(f"mpd{p}.{i}", cin, cout, 5, h * p, first=i == 0))
            cin = cout
        out.append(_conv(f"mpd{p}.out", cin, 1, 3, h * p))
    t = samples
    for s in range(msd_scales):
        if s:
            t = _out_len(t, 4, 2, 1)
        tl, cin = t, 1
        for i, (cout, k, stride, groups) in enumerate(MSD_LAYERS):
            g = math.gcd(groups, cin)
            tl = _out_len(tl, k, stride, (k - 1) // 2)
            out.append(_conv(f"msd{s}.{i}", cin, cout, k, tl, g, first=i == 0))
            cin = cout
        out.append(_conv(f"msd{s}.out", cin, 1, 3, _out_len(tl, 3, 1, 1)))
    return out


def fwd_bwd(convs: List[Conv]) -> float:
    """Forward, weight gradients and input gradients (none for a layer that
    reads the network's input)."""
    return sum((2.0 if c.first else 3.0) * c.flops for c in convs)


def train_step_flops(cfg: dict, rows: int, samples: int) -> float:
    """What one GAN step needs on `rows` rows of `samples` samples: the
    codec forward and backward with its search; the discriminators' forward
    on the real and the generated rows, once; their weight gradients and
    the input gradients behind them on both (the discriminator's loss), and
    the input gradients on the generated rows down to the waveform (the
    generator's adversarial and feature losses)."""
    frames = samples // math.prod(cfg["strides"])
    codec = fwd_bwd(codec_convs(cfg, samples)) + rvq_search_flops(cfg, frames)
    d = disc_convs(samples)
    disc = 2 * rows * fwd_bwd(d) + rows * sum(c.flops for c in d)
    return rows * codec + disc
