"""STFT magnitude of the spectral losses: the CUDA kernel `csrc/stft.cu`, its
plain PyTorch version, and the wrapper.

    |STFT|(x)[b, f, k] = sqrt(re^2 + im^2 + 1e-8),
    (re, im) = sum_n x_pad[b, f*hop + n] * win[n] * (cos[n, k], sin[n, k])

for x (B, T) float32, centre reflect padding of n_fft//2, the periodic Hann
window and the float32 DFT basis of `nsc_tpu_torch.ops.stft`; the output is
(B, 1 + T//hop, n_fft//2 + 1) float32. The plain version is the matmul-DFT
path of `ops.stft.stft_magnitude`, which frames the signal in memory; the
kernel computes the same sums without the frame tensor.

`stft_magnitude` is differentiable. On a CUDA tensor its forward launches
the kernel and its backward recomputes through the plain version and takes
that graph's gradient (the JAX package's `ops/stft.py::_fused_bwd` does the
same with XLA's); on a CPU tensor the whole call is the plain version.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from nsc_tpu_torch import kernels
from nsc_tpu_torch.ops import stft as S

TILE_K = 128       # bins per block; the basis is padded to a multiple of it
TILE_F = 32        # frames per block
CHUNK_N = 32       # basis rows staged per step
MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper

_CONSTS: Dict[Tuple[int, torch.device], Tuple[torch.Tensor, ...]] = {}


def stft_magnitude_plain(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, T) float32 -> (B, 1 + T//hop, n_fft//2 + 1): the matmul-DFT path."""
    return S.stft_magnitude(x, n_fft, hop, use_matmul_dft=True)


def smem_bytes(n_fft: int, hop: int) -> int:
    """Shared memory of one block: basis chunks, window, signal segment."""
    return 4 * (2 * CHUNK_N * TILE_K + 2 * n_fft + (TILE_F - 1) * hop)


def _constants(n_fft: int, device: torch.device):
    """(window, cos basis, sin basis) on `device`, basis padded with zero
    columns to a multiple of TILE_K; cached per (n_fft, device)."""
    key = (n_fft, device)
    if key not in _CONSTS:
        k = n_fft // 2 + 1
        kp = -(-k // TILE_K) * TILE_K
        cos_b, sin_b = S.dft_basis(n_fft)
        _CONSTS[key] = (
            S.hann_window(n_fft).to(device).contiguous(),
            F.pad(cos_b, (0, kp - k)).to(device).contiguous(),
            F.pad(sin_b, (0, kp - k)).to(device).contiguous(),
        )
    return _CONSTS[key]


def _launch(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    from nsc_tpu_torch.kernels import _build

    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be (B, T) float32, got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    b, t = x.shape
    if n_fft < 2 or hop < 1 or t <= n_fft // 2:
        raise ValueError(f"stft: need n_fft >= 2, hop >= 1 and T > n_fft//2 (T={t})")
    if smem_bytes(n_fft, hop) > MAX_SMEM:
        raise ValueError(f"stft kernel: n_fft={n_fft}, hop={hop} needs too much shared memory")
    if not 1 <= b <= 65535:
        raise ValueError(f"stft kernel takes 1 <= B <= 65535, got {b}")
    win, cos_b, sin_b = _constants(n_fft, x.device)
    xpad = S.reflect_pad(x, n_fft).contiguous()
    n_frames = S.num_frames(t, n_fft, hop, center=True)
    k = n_fft // 2 + 1
    out = torch.empty(b, n_frames, k, dtype=torch.float32, device=x.device)
    lib = _build.library()
    err = lib.nsc_stft_magnitude(
        xpad.data_ptr(), win.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(),
        out.data_ptr(), b, xpad.shape[1], n_fft, hop, n_frames, k,
        cos_b.shape[1], torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "nsc_stft_magnitude")
    kernels.LAUNCHES["stft_magnitude"] += 1
    return out


class _STFTMagnitude(torch.autograd.Function):
    """Forward: the kernel. Backward: the plain version's gradient."""

    @staticmethod
    def forward(ctx, x, n_fft, hop):
        ctx.save_for_backward(x)
        ctx.n_fft, ctx.hop = n_fft, hop
        return _launch(x, n_fft, hop)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            y = stft_magnitude_plain(xx, ctx.n_fft, ctx.hop)
            (gx,) = torch.autograd.grad(y, xx, grad)
        return gx, None, None


def stft_magnitude(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, T) float32 -> (B, 1 + T//hop, n_fft//2 + 1) |STFT|, differentiable."""
    if x.device.type == "cpu":
        return stft_magnitude_plain(x, n_fft, hop)
    if x.device.type == "cuda":
        return _STFTMagnitude.apply(x, n_fft, hop)
    raise ValueError(f"stft_magnitude: unsupported device {x.device}")
