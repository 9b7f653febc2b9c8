"""STFT magnitude of the spectral losses: the CUDA kernels of `csrc/stft.cu`,
their plain PyTorch version, and the wrapper.

    |STFT|(x)[b, f, k] = sqrt(re^2 + im^2 + 1e-8),
    (re, im) = sum_n x_pad[b, f*hop + n] * win[n] * (cos, sin)(-2 pi n k / n_fft)

for x (B, T) float32, centre reflect padding of n_fft//2, the periodic Hann
window of `nsc_tpu_torch.ops.stft`; the output is (B, 1 + T//hop,
n_fft//2 + 1) float32. The plain version is the matmul-DFT path of
`ops.stft.stft_magnitude`, which frames the signal in memory; the kernels
compute the same magnitudes without the frame tensor.

Two kernels, chosen by n_fft alone (`route`), never by a failed launch:

  * "fft" (`stft_magnitude`, counted as "stft_magnitude"): powers of two
    from FFT_MIN to FFT_MAX, every n_fft the shipped losses use. A real FFT
    in shared memory, in float64, with its outputs rounded once to float32:
    each windowed frame (the float64 window) is packed into an
    n_fft/2-point complex sequence (even samples real, odd imaginary),
    transformed by Stockham radix-4 passes (a radix-2 pass last where
    log2(n_fft/2) is odd), then split into the real spectrum by the
    post-twiddle. Float64 because the
    spectral losses' log-magnitude L1 turns any float32 rounding of the
    magnitudes into sign flips of its gradient at near-tie bins; the
    correctly rounded magnitudes make the gradient the float64 one up to
    float32 rounding of the loss and backward.
  * "dft" (counted as "stft_magnitude_dft"): every other n_fft >= 2, the
    O(n_fft^2) DFT against the float32 basis.

`stft_magnitude` is differentiable. On a CUDA tensor its forward launches a
kernel, which also writes the spectrum (re, im) when x takes a gradient,
and its backward differentiates those magnitudes: dL/dX = dL/d|X| X/|X|
through the adjoint DFT as plain matmuls (`stft_magnitude_backward`), as
the JAX package's `ops/stft.py::_fused_bwd` leaves its backward to XLA. On
a CPU tensor the whole call is the plain version.
"""

from __future__ import annotations

import functools
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nsc_tpu_torch import kernels
from nsc_tpu_torch.ops import stft as S

MAX_SMEM = 232448  # bytes of shared memory one block may use on Hopper

# the DFT kernel
TILE_K = 128       # bins per block; the basis is padded to a multiple of it
TILE_F = 32        # frames per block
CHUNK_N = 32       # basis rows staged per step

# the FFT kernel
FFT_MIN, FFT_MAX = 16, 4096  # its plan (frames per block, bytes): nsc_stft_fft_plan

_CONSTS: Dict[Tuple[str, int, torch.device], Tuple[torch.Tensor, ...]] = {}


def stft_magnitude_plain(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, T) float32 -> (B, 1 + T//hop, n_fft//2 + 1): the matmul-DFT path."""
    return S.stft_magnitude(x, n_fft, hop, use_matmul_dft=True)


def route(n_fft: int) -> str:
    """"fft" for a power of two in [FFT_MIN, FFT_MAX], "dft" for any other
    n_fft >= 2; below 2 there is no STFT to take."""
    if n_fft < 2:
        raise ValueError(f"stft: need n_fft >= 2, got {n_fft}")
    pow2 = n_fft & (n_fft - 1) == 0
    return "fft" if pow2 and FFT_MIN <= n_fft <= FFT_MAX else "dft"


@functools.lru_cache(maxsize=32)
def _twiddles_np(n_fft: int) -> np.ndarray:
    ang = -2.0 * np.pi * np.arange(n_fft) / n_fft
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1)


def twiddles(n_fft: int, device=None) -> torch.Tensor:
    """(n_fft, 2) float64 table of exp(-2 pi i j / n_fft), from the float64
    expression the DFT basis is cast from: cast to float32, row j is the
    basis' column 1, (cos, sin)[j, 1]. The complex passes read it at a
    stride of n_fft / (R p), the real post-twiddle at stride 1."""
    return torch.from_numpy(_twiddles_np(n_fft)).to(device)


# ---------------------------------------------------------------------------
# Launches


def dft_smem_bytes(n_fft: int, hop: int) -> int:
    """Shared memory of one DFT block: basis chunks, window, signal segment."""
    return 4 * (2 * CHUNK_N * TILE_K + 2 * n_fft + (TILE_F - 1) * hop)


def _constants(kind: str, n_fft: int, device: torch.device):
    """Per (kind, n_fft, device), cached: "fft" (float64 window and twiddle
    table); "dft" (float32 window, cos basis, sin basis), the basis padded
    with zero columns to a multiple of TILE_K."""
    key = (kind, n_fft, device)
    if key in _CONSTS:
        return _CONSTS[key]
    if kind == "fft":
        _CONSTS[key] = (S.hann_window(n_fft, device, torch.float64).contiguous(),
                        twiddles(n_fft, device).contiguous())
    else:
        k = n_fft // 2 + 1
        kp = -(-k // TILE_K) * TILE_K
        cos_b, sin_b = S.dft_basis(n_fft)
        _CONSTS[key] = (S.hann_window(n_fft, device).contiguous(),
                        F.pad(cos_b, (0, kp - k)).to(device).contiguous(),
                        F.pad(sin_b, (0, kp - k)).to(device).contiguous())
    return _CONSTS[key]


def _check(x: torch.Tensor, n_fft: int, hop: int) -> str:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be (B, T) float32, got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    b, t = x.shape
    kind = route(n_fft)
    if hop < 1 or t <= n_fft // 2:
        raise ValueError(f"stft: need hop >= 1 and T > n_fft//2 (T={t})")
    if kind == "dft" and dft_smem_bytes(n_fft, hop) > MAX_SMEM:
        raise ValueError(f"stft kernel: n_fft={n_fft}, hop={hop} needs too much shared memory")
    if not 1 <= b <= 65535:
        raise ValueError(f"stft kernel takes 1 <= B <= 65535, got {b}")
    return kind


def launch(x: torch.Tensor, n_fft: int, hop: int, spectrum: bool = False):
    """The kernel of `route(n_fft)` on a CUDA tensor: the magnitudes, and with
    `spectrum` also the (re, im) they came from, each (B, F, n_fft//2 + 1)."""
    from nsc_tpu_torch.kernels import _build

    kind = _check(x, n_fft, hop)
    b, t = x.shape
    n_frames = S.num_frames(t, n_fft, hop, center=True)
    k = n_fft // 2 + 1
    out = torch.empty(b, n_frames, k, dtype=torch.float32, device=x.device)
    re, im = (torch.empty_like(out), torch.empty_like(out)) if spectrum else (None, None)
    ptrs = (re.data_ptr(), im.data_ptr()) if spectrum else (None, None)
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if kind == "fft":
        win, tw = _constants("fft", n_fft, x.device)
        err = lib.nsc_stft_magnitude_fft(x.data_ptr(), win.data_ptr(), tw.data_ptr(),
                                         out.data_ptr(), *ptrs, b, t, n_fft, hop, n_frames, stream)
        _build.check(err, "nsc_stft_magnitude_fft")
        kernels.LAUNCHES["stft_magnitude"] += 1
    else:
        win, cos_b, sin_b = _constants("dft", n_fft, x.device)
        xpad = S.reflect_pad(x, n_fft).contiguous()
        err = lib.nsc_stft_magnitude_dft(
            xpad.data_ptr(), win.data_ptr(), cos_b.data_ptr(), sin_b.data_ptr(),
            out.data_ptr(), *ptrs, b, xpad.shape[1], n_fft, hop, n_frames, k, cos_b.shape[1],
            stream)
        _build.check(err, "nsc_stft_magnitude_dft")
        kernels.LAUNCHES["stft_magnitude_dft"] += 1
    return (out, re, im) if spectrum else out


def stft_magnitude_backward(grad: torch.Tensor, re: torch.Tensor, im: torch.Tensor,
                            mag: torch.Tensor, length: int, n_fft: int, hop: int) -> torch.Tensor:
    """dL/dx of |STFT| from dL/d|STFT| and the spectrum the magnitudes came
    from: (grad re/|X|, grad im/|X|) through the adjoint of the DFT (the
    float32 basis, plain matmuls), the window, the overlap-add of the
    frames and the adjoint of the reflect pad. (B, F, K) -> (B, length)."""
    b = grad.shape[0]
    p = n_fft // 2
    cos_b, sin_b = S.dft_basis(n_fft, grad.device)
    frames = torch.matmul(grad * re / mag, cos_b.t()) + torch.matmul(grad * im / mag, sin_b.t())
    frames = frames * S.hann_window(n_fft, grad.device)
    tp = length + 2 * p
    xp = F.fold(frames.transpose(1, 2), output_size=(1, tp), kernel_size=(1, n_fft),
                stride=(1, hop)).reshape(b, tp)
    gx = xp[:, p:p + length].clone()
    gx[:, 1:p + 1] += xp[:, :p].flip(-1)
    gx[:, length - 1 - p:length - 1] += xp[:, p + length:].flip(-1)
    return gx


class _STFTMagnitude(torch.autograd.Function):
    """Forward: a kernel, keeping the spectrum when x takes a gradient.
    Backward: `stft_magnitude_backward` on that spectrum, so the backward
    differentiates the magnitudes the forward computed."""

    @staticmethod
    def forward(ctx, x, n_fft, hop):
        ctx.n_fft, ctx.hop, ctx.length = n_fft, hop, x.shape[1]
        if not ctx.needs_input_grad[0]:
            return launch(x, n_fft, hop)
        mag, re, im = launch(x, n_fft, hop, spectrum=True)
        ctx.save_for_backward(re, im, mag)
        return mag

    @staticmethod
    def backward(ctx, grad):
        re, im, mag = ctx.saved_tensors
        return stft_magnitude_backward(grad, re, im, mag, ctx.length, ctx.n_fft, ctx.hop), None, None


def stft_magnitude(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, T) float32 -> (B, 1 + T//hop, n_fft//2 + 1) |STFT|, differentiable."""
    if x.device.type == "cpu":
        return stft_magnitude_plain(x, n_fft, hop)
    if x.device.type == "cuda":
        return _STFTMagnitude.apply(x, n_fft, hop)
    raise ValueError(f"stft_magnitude: unsupported device {x.device}")
