"""The least time each kernel's operation could take on the chip: the larger
of its operations over the peak rate and its bytes over the HBM rate, each
input byte read once and each output byte written once (copied from the
port's `chip_smoke.py` `k1_bound`, `k4_bound` and `stage_list`, with K2
counted once: its product at the bf16 tensor-core rate, not the bf16
planes one kernel happens to run). Seconds throughout.
"""

from __future__ import annotations

import math
from typing import List, Tuple

from benchmark.harness.peaks import PEAK_BF16_FLOPS, PEAK_BYTES, PEAK_F32_FLOPS


def stage_shapes(cfg: dict, samples: int) -> List[Tuple[str, int, int]]:
    """(name, C, T) of the residual units of each of the 8 stages on a row
    of `samples` samples: the encoder's 4, then the decoder's 4."""
    out, t = [], samples
    for i, s in enumerate(cfg["strides"]):
        out.append((f"enc{i}", cfg["base_width"] * 2 ** i, t))
        t //= s
    fw = cfg["base_width"] * 2 ** len(cfg["strides"])
    for i, s in enumerate(reversed(cfg["strides"])):
        t *= s
        out.append((f"dec{i}", fw // 2 ** (i + 1), t))
    return out


def k1_stage(rows: int, c: int, t: int, units: int, act_bytes: int = 2,
             weight_bytes: int = 2) -> Tuple[float, float]:
    """(flops, bytes) of one stage's residual units (k = 3 conv and 1x1
    conv each) on rows x C x T: 8 C^2 flops a sample a unit; the input read
    and the output written once in the compute dtype, with the weights (4
    C^2 a unit) and the biases and snake alphas (4 C a unit, float32)."""
    flops = 2.0 * rows * t * units * 4 * c * c
    nbytes = 2 * rows * c * t * act_bytes + units * (4 * c * c * weight_bytes + 4 * c * 4)
    return flops, nbytes


def k1_bound_s(cfg: dict, rows: int, samples: int) -> float:
    """K1 over the 8 stages of one batch (bf16): the sum of each stage's
    bound."""
    units = len(cfg["dilations"])
    total = 0.0
    for _, c, t in stage_shapes(cfg, samples):
        f, b = k1_stage(rows, c, t, units)
        total += max(f / PEAK_BF16_FLOPS, b / PEAK_BYTES)
    return total


def k2_bound_s(cfg: dict, m: int) -> float:
    """K2 on M frames: the product 2 M K D n_q once at the bf16 tensor-core
    rate, against the frames, the books and the indices read or written
    once (float32 and int32)."""
    n_q, k, d = cfg["num_quantizers"], cfg["codebook_size"], cfg["codebook_dim"]
    flops = 2.0 * m * k * d * n_q
    nbytes = 4.0 * (m * d + n_q * k * d + m * n_q)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


def k4_bound_s(rows: int, t: int, n_fft: int, hop: int) -> float:
    """K4 (STFT magnitude) of rows x t samples: a real FFT of each frame
    (2.5 n log2 n), the window and the magnitudes at the float32 rate,
    against the signal, the window and the magnitudes read or written once."""
    frames = max(0, 1 + (t + 2 * (n_fft // 2) - n_fft) // hop)
    bins = n_fft // 2 + 1
    flops = rows * frames * (2.5 * n_fft * math.log2(n_fft) + n_fft + 4 * bins)
    nbytes = 4.0 * (rows * t + rows * frames * bins + n_fft)
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)


def k4_step_bound_s(training: dict, rows: int, samples: int) -> float:
    """The loss bank of one training step: each multi-resolution size (hop
    n/4) and the mel size (hop n/4) on the reconstruction and the target."""
    sizes = list(training["stft_fft_sizes"]) + [training["mel_fft_size"]]
    return sum(2 * k4_bound_s(rows, samples, n, n // 4) for n in sizes)
