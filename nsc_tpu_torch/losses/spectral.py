"""Spectral reconstruction losses (counterpart of
`nsc_tpu/losses/spectral.py`).

Multi-resolution STFT loss = spectral convergence + log-magnitude L1 over a
bank of FFT sizes; mel loss = L1 on log-mel; time L1. Every loss STFT goes
through `stft`, by default `nsc_tpu_torch.kernels.stft.stft_magnitude`: the
CUDA kernel on a card (its backward through the spectrum the kernel
computed), the plain version on CPU tensors. Nothing moves to another path by itself; a caller
that holds the kernel against its plain version on the card passes
`stft=stft_magnitude_plain`. The multi-resolution loss computes in float32,
or in float64 for float64 inputs (a reference for its float32 gradient).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from nsc_tpu_torch.kernels import stft as KS
from nsc_tpu_torch.ops import stft as S


@dataclasses.dataclass(frozen=True)
class MultiResSTFTConfig:
    fft_sizes: Tuple[int, ...] = (2048, 1024, 512, 256, 128)
    hop_divisor: int = 4          # hop = n_fft // 4
    win_divisor: int = 1          # win = n_fft


def multi_res_stft_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    cfg: MultiResSTFTConfig = MultiResSTFTConfig(),
    *,
    eps: float = 1e-5,
    stft: Callable = KS.stft_magnitude,
) -> torch.Tensor:
    """(N, T) waveforms -> scalar: mean over resolutions of (spectral
    convergence + log-magnitude L1), each averaged over the batch."""
    dt = torch.float64 if pred.dtype == torch.float64 else torch.float32
    total = pred.new_zeros((), dtype=dt)
    for n_fft in cfg.fft_sizes:
        hop = n_fft // cfg.hop_divisor
        p = stft(pred.to(dt).contiguous(), n_fft, hop)
        t = stft(target.to(dt).contiguous(), n_fft, hop)
        sc = torch.linalg.norm(t - p, dim=(-2, -1)) / (
            torch.linalg.norm(t, dim=(-2, -1)) + eps
        )
        log_l1 = torch.mean(
            torch.abs(torch.log(t + eps) - torch.log(p + eps)), dim=(-2, -1)
        )
        total = total + torch.mean(sc) + torch.mean(log_l1)
    return total / len(cfg.fft_sizes)


def mel_loss(
    pred: torch.Tensor,
    target: torch.Tensor,
    *,
    sample_rate: int = 16_000,
    n_fft: int = 1024,
    hop: int = 256,
    n_mels: int = 80,
    stft: Callable = KS.stft_magnitude,
) -> torch.Tensor:
    """L1 between log-mel spectrograms, (N, T) -> scalar."""
    fb = S.mel_filterbank(sample_rate, n_fft, n_mels, device=pred.device)

    def logmel(x):
        mag = stft(x.float().contiguous(), n_fft, hop)
        return torch.log(torch.matmul(mag, fb) + 1e-5)

    return torch.mean(torch.abs(logmel(pred) - logmel(target)))


def time_l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred.float() - target.float()))
