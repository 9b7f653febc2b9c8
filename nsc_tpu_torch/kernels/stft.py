"""STFT magnitude of the spectral losses: the CUDA kernels of `csrc/stft.cu`,
their plain PyTorch version, and the wrapper.

    |STFT|(x)[b, f, k] = sqrt(re^2 + im^2 + 1e-8),
    (re, im) = sum_n x_pad[b, f*hop + n] * win[n] * (cos, sin)(-2 pi n k / n_fft)

for x (B, T) float32, centre reflect padding of n_fft//2, the periodic Hann
window of `nsc_tpu_torch.ops.stft`; the output is (B, 1 + T//hop,
n_fft//2 + 1) float32 (one frame fewer for an odd n_fft where hop divides
T, as `frame_signal` cuts them). The plain version is the matmul-DFT path of
`ops.stft.stft_magnitude`, which frames the signal in memory; the kernels
compute the same magnitudes without the frame tensor.

Two kernels, chosen by n_fft alone (`route`), never by a failed launch.
Both compute in float64 (the float64 window and the float64 table
`twiddles`) and round each output once to float32: the spectral losses'
log-magnitude L1 turns any float32 rounding of the magnitudes into sign
flips of its gradient at near-tie bins; the correctly rounded magnitudes
make the gradient the float64 one up to float32 rounding of the loss and
backward.

  * "fft" (`stft_magnitude`, counted as "stft_magnitude"): even n_fft from
    FFT_MIN to FFT_MAX whose half has no prime factor above 7 (every
    power of two there, and the usual speech windows: 320, 400, 480, 882,
    960, 1200, ...). A real FFT in shared memory: each windowed frame is
    packed into an n_fft/2-point complex sequence (even samples real, odd
    imaginary), transformed by Stockham passes of radix 4, 2, 3, 5 and 7,
    then split into the real spectrum by the post-twiddle. The pass list
    is written here (`fft_passes`, the one source of the route's domain)
    and passed to the kernel, which checks only that it is a transform of
    n_fft/2 points. FFT_MAX is the largest n_fft whose one-frame plan
    (20 n_fft bytes: `nsc_stft_fft_plan`) fits a block's shared memory.
  * "dft" (counted as "stft_magnitude_dft"): the remainder, every other
    n_fft >= 2. The O(n_fft^2) DFT against the twiddle table read at
    (n k) mod n_fft, staged in chunks of n in static shared memory, so a
    block's bytes are the same for every n_fft and hop and no shape is
    refused.

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

# the FFT kernel's n_fft: one frame's plan takes 20 n_fft bytes (two
# buffers of n_fft/2 complex float64 points and the float32 segment)
FFT_MIN, FFT_MAX = 16, MAX_SMEM // 20

_CONSTS: Dict[Tuple[int, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}


def stft_magnitude_plain(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, T) float32 -> (B, 1 + T//hop, n_fft//2 + 1): the matmul-DFT path."""
    return S.stft_magnitude(x, n_fft, hop, use_matmul_dft=True)


def fft_passes(n_fft: int) -> Tuple[int, ...]:
    """The FFT kernel's pass list over the n_fft/2 complex points: radix-4
    passes while 4 divides what is left of n_fft/2, a radix-2 pass where a
    2 is left, then radix 3, 5 and 7 passes (for a power of two, the
    radix-4 passes and a radix-2 pass last where log2(n_fft/2) is odd).
    Every prefix's product p times the next radix R divides n_fft/2, so
    Stockham's twiddle stride n_fft / (R p) is an integer. Empty where
    n_fft is outside the FFT route: odd, outside [FFT_MIN, FFT_MAX], or a
    half with a prime factor above 7."""
    if n_fft % 2 or not FFT_MIN <= n_fft <= FFT_MAX:
        return ()
    left, out = n_fft // 2, []
    while left % 4 == 0:
        out.append(4)
        left //= 4
    if left % 2 == 0:
        out.append(2)
        left //= 2
    for r in (3, 5, 7):
        while left % r == 0:
            out.append(r)
            left //= r
    return tuple(out) if left == 1 else ()


def route(n_fft: int) -> str:
    """"fft" where `fft_passes` has a plan, "dft" for any other n_fft >= 2;
    below 2 there is no STFT to take."""
    if n_fft < 2:
        raise ValueError(f"stft: need n_fft >= 2, got {n_fft}")
    return "fft" if fft_passes(n_fft) else "dft"


@functools.lru_cache(maxsize=32)
def _twiddles_np(n_fft: int) -> np.ndarray:
    ang = -2.0 * np.pi * np.arange(n_fft) / n_fft
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1)


def twiddles(n_fft: int, device=None) -> torch.Tensor:
    """(n_fft, 2) float64 table of exp(-2 pi i j / n_fft), from the float64
    expression the DFT basis is cast from: cast to float32, row j is the
    basis' column 1, (cos, sin)[j, 1]. The FFT's passes read it at a
    stride of n_fft / (R p) and their odd radices' constants at n_fft / R,
    its real post-twiddle at stride 1; the DFT reads it at (n k) mod n_fft."""
    return torch.from_numpy(_twiddles_np(n_fft)).to(device)


# ---------------------------------------------------------------------------
# Launches


def _constants(n_fft: int, device: torch.device):
    """The float64 window and twiddle table both kernels read, cached per
    (n_fft, device)."""
    key = (n_fft, device)
    if key not in _CONSTS:
        _CONSTS[key] = (S.hann_window(n_fft, device, torch.float64).contiguous(),
                        twiddles(n_fft, device).contiguous())
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
    if not 1 <= b <= 65535:
        raise ValueError(f"stft kernel takes 1 <= B <= 65535, got {b}")
    return kind


def launch(x: torch.Tensor, n_fft: int, hop: int, spectrum: bool = False):
    """The kernel of `route(n_fft)` on a CUDA tensor: the magnitudes, and with
    `spectrum` also the (re, im) they came from, each (B, F, n_fft//2 + 1)."""
    from nsc_tpu_torch.kernels import _build

    kind = _check(x, n_fft, hop)
    b, t = x.shape
    # the frames `frame_signal` cuts from the padded signal (1 + T//hop for
    # an even n_fft, one fewer where an odd one's last frame would run past)
    n_frames = S.num_frames(t + 2 * (n_fft // 2), n_fft, hop, center=False)
    k = n_fft // 2 + 1
    out = torch.empty(b, n_frames, k, dtype=torch.float32, device=x.device)
    re, im = (torch.empty_like(out), torch.empty_like(out)) if spectrum else (None, None)
    ptrs = (re.data_ptr(), im.data_ptr()) if spectrum else (None, None)
    win, tw = _constants(n_fft, x.device)
    args = (x.data_ptr(), win.data_ptr(), tw.data_ptr(), out.data_ptr(), *ptrs, b, t, n_fft,
            hop, n_frames)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if kind == "fft":
        # the pass list, 4 bits a radix from the lowest
        radices = sum(r << (4 * i) for i, r in enumerate(fft_passes(n_fft)))
        err = _build.library().nsc_stft_magnitude_fft(*args, radices, stream)
    else:
        err = _build.library().nsc_stft_magnitude_dft(*args, stream)
    name = "stft_magnitude" if kind == "fft" else "stft_magnitude_dft"
    _build.check(err, f"nsc_stft_magnitude_{kind}")
    kernels.LAUNCHES[name] += 1
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
