"""Framed STFT magnitudes and mel spectrograms (counterpart of
`nsc_tpu/ops/stft.py`).

Two ways to the DFT, as in the JAX package:

  * `torch.fft.rfft` of the windowed frames;
  * products with a real/imaginary DFT basis (`use_matmul_dft=True`), the
    form the loss STFT kernel (`nsc_tpu_torch.kernels.stft`) computes.

The periodic Hann window, the DFT basis and the mel filterbank are built in
numpy float64 and cast to float32 once, exactly as the JAX package builds
them, so both packages multiply by the same float32 numbers (a basis made
with torch.float32 `cos` would differ in its last bits). `stft_magnitude`
of a float64 signal uses the float64 window and basis, unrounded: a
reference for the float32 path.

All functions work on the last axis (time) and broadcast over leading axes.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=32)
def _hann_window_np(n: int, dtype=np.float32) -> np.ndarray:
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)).astype(dtype)


def hann_window(n: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Periodic Hann window of length n, float32 (float64 for a float64
    dtype)."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return torch.from_numpy(_hann_window_np(n, np_dtype)).to(device)


def num_frames(length: int, n_fft: int, hop: int, center: bool) -> int:
    if center:
        return 1 + length // hop
    return max(0, 1 + (length - n_fft) // hop)


def reflect_pad(x: torch.Tensor, n_fft: int) -> torch.Tensor:
    """Reflect-pad n_fft//2 samples on both sides of the last axis."""
    lead = x.shape[:-1]
    p = n_fft // 2
    y = F.pad(x.reshape(-1, 1, x.shape[-1]), (p, p), mode="reflect")
    return y.reshape(*lead, y.shape[-1])


def frame_signal(
    x: torch.Tensor, n_fft: int, hop: int, *, center: bool = True
) -> torch.Tensor:
    """(..., T) -> (..., frames, n_fft). center=True reflect-pads n_fft//2 on
    both sides, so frame f is centred at f*hop."""
    if center:
        x = reflect_pad(x, n_fft)
    t = x.shape[-1]
    nf = max(0, 1 + (t - n_fft) // hop)
    idx = (
        torch.arange(nf, device=x.device)[:, None] * hop
        + torch.arange(n_fft, device=x.device)[None, :]
    )
    return x[..., idx]


@functools.lru_cache(maxsize=32)
def _dft_basis_np(n_fft: int, dtype=np.float32):
    """Real/imaginary rfft basis, (n_fft, n_fft//2+1) each, in `dtype`."""
    k = np.arange(n_fft // 2 + 1)
    n = np.arange(n_fft)
    ang = -2.0 * np.pi * np.outer(n, k) / n_fft
    return np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)


def dft_basis(n_fft: int, device=None, dtype=torch.float32):
    """The basis in float32 (float64 for a float64 dtype) on `device`."""
    c, s = _dft_basis_np(n_fft, np.float64 if dtype == torch.float64 else np.float32)
    return torch.from_numpy(c).to(device), torch.from_numpy(s).to(device)


def stft_magnitude(
    x: torch.Tensor,
    n_fft: int,
    hop: int,
    *,
    window: Optional[torch.Tensor] = None,
    center: bool = True,
    use_matmul_dft: bool = False,
    eps: float = 1e-8,
) -> torch.Tensor:
    """|STFT| = sqrt(re^2 + im^2 + eps), (..., T) -> (..., frames,
    n_fft//2+1), float32 (float64 for a float64 x)."""
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    if window is None:
        window = hann_window(n_fft, x.device, dt)
    frames = frame_signal(x, n_fft, hop, center=center) * window
    if use_matmul_dft:
        cos_b, sin_b = dft_basis(n_fft, x.device, dt)
        re = torch.matmul(frames, cos_b)
        im = torch.matmul(frames, sin_b)
    else:
        z = torch.fft.rfft(frames, dim=-1)
        re, im = z.real, z.imag
    return torch.sqrt(re * re + im * im + eps)


# ---------------------------------------------------------------------------
# mel
# ---------------------------------------------------------------------------


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=32)
def _mel_filterbank_np(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
) -> np.ndarray:
    fmax = fmax or sample_rate / 2.0
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    bins = np.fft.rfftfreq(n_fft, 1.0 / sample_rate)
    fb = np.zeros((len(bins), n_mels), dtype=np.float32)
    for m in range(n_mels):
        lo, cen, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (bins - lo) / max(cen - lo, 1e-9)
        down = (hi - bins) / max(hi - cen, 1e-9)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def mel_filterbank(
    sample_rate: int,
    n_fft: int,
    n_mels: int,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    device=None,
) -> torch.Tensor:
    """Triangular mel filterbank (HTK scale), (n_fft//2+1, n_mels) float32."""
    fb = _mel_filterbank_np(sample_rate, n_fft, n_mels, fmin, fmax)
    return torch.from_numpy(fb).to(device)


def mel_spectrogram(
    x: torch.Tensor,
    sample_rate: int,
    n_fft: int,
    hop: int,
    n_mels: int,
    *,
    fmin: float = 0.0,
    fmax: Optional[float] = None,
    log: bool = True,
    eps: float = 1e-5,
    use_matmul_dft: bool = False,
) -> torch.Tensor:
    """(..., T) -> (..., frames, n_mels); log-magnitude mel by default."""
    mag = stft_magnitude(x, n_fft, hop, use_matmul_dft=use_matmul_dft)
    fb = mel_filterbank(sample_rate, n_fft, n_mels, fmin, fmax, x.device)
    mel = torch.matmul(mag, fb)
    if log:
        mel = torch.log(mel + eps)
    return mel
