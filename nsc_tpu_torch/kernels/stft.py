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

Four routes, chosen by n_fft alone (`route`), never by a failed launch.
All compute in float64 (the float64 window and float64 tables `twiddles`)
and round each output once to float32: the spectral losses' log-magnitude
L1 turns any float32 rounding of the magnitudes into sign flips of its
gradient at near-tie bins; the correctly rounded magnitudes make the
gradient the float64 one up to float32 rounding of the loss and backward.
The transforms run the same passes (radix 4, 2, 3, 5 and 7, each in place
in one buffer of complex float64 points: `csrc/stft.cu`).

  * "fft" (`stft_magnitude`, counted as "stft_magnitude"): even n_fft from
    FFT_MIN to FFT_MAX whose half has no prime factor above 7 (every
    power of two there, the usual speech windows 320, 400, 480, 882, 960,
    1200, ..., and long ones such as 12000). A real FFT in shared memory:
    each windowed frame is packed into an n_fft/2-point complex sequence
    (even samples real, odd imaginary) and loaded in its passes' order
    (`fft_order`), transformed, then split into the real spectrum by the
    post-twiddle. The pass list is written here (`fft_passes`, the one
    statement of the route's domain) and passed to the kernel, which checks
    only that it is a transform of n_fft/2 points. FFT_MAX is the largest
    n_fft whose one-frame plan (one buffer of n_fft/2 complex float64
    points, 8 n_fft bytes: `nsc_stft_fft_plan`) fits a block's shared
    memory.
  * "bluestein" (counted as "stft_magnitude_bluestein"): every other
    n_fft >= 2 whose chirp-z plan fits a block (`bluestein_plan`): two
    frames as one complex sequence (odd n_fft, L = n_fft) or the packed
    half of one (even, L = n_fft/2) as a cyclic convolution with a chirp
    of length M, the smallest 7-smooth number >= 2L - 1, through two
    M-point transforms on the same passes. 16 M bytes a transform, so M up
    to BLUESTEIN_MAX_M: odd n_fft up to 7,203, even ones up to 14,404. Its
    float64 tables (`bluestein_tables`) are made here with numpy, once per
    (n_fft, plan, device).
  * "bluestein_cluster" (counted as "stft_magnitude_bluestein_cluster"):
    the same chirp-z transform where its M points outgrow one block, spread
    over a thread-block cluster of C = 2, 4 or 8 blocks
    (`bluestein_cluster_plan`): block r holds the contiguous share [r M/C,
    (r + 1) M/C) of the points, the passes within a share run on it alone,
    and the last passes of the list (their radices multiply to C) reach the
    other blocks' shared memory. C is the smallest whose share, 16 M/C
    bytes, fits a block, and M the smallest 7-smooth number >= 2L - 1 that
    8 C divides (each share a multiple of 8 points, so the kernels' slot
    swizzle works within each block). Clusters stop at 8, the portable
    size: odd n_fft from 7,205 to 57,599 and even ones from 14,408 to
    115,200 that the FFT route does not take (M up to 115,200, C 8, shares
    of 14,400 points).
  * "bluestein_global" (counted as "stft_magnitude_bluestein_global"): every
    n_fft no 8-block cluster holds (odd n_fft from 57,601, even ones from
    115,202), the same chirp-z transform in two levels through global
    memory (`bluestein_global_plan`): M the smallest 7-smooth multiple of 8
    >= 2L - 1, cut into C shares of S points (S the largest divisor of M
    that 8 divides and that is at most GLOBAL_SHARE_MAX, the points a
    one-block chirp-z block holds), the points of each transform in a
    float64 scratch buffer this wrapper allocates (at most SCRATCH_BYTES,
    the transforms taken in chunks), and four kernels in turn: the passes
    across the shares on tiles of local offsets, the passes within each
    share, the passes across again, the bins. Its reach is M up to
    GLOBAL_MAX_M = 2^20 (odd n_fft to 524,287, even ones to 1,048,576):
    there C is at most 1,771 and a tile of 8 offsets of C points fits a
    block. Beyond it the wrapper raises ValueError.

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

# the FFT kernel's n_fft: one frame's plan takes 8 n_fft bytes (one buffer
# of n_fft/2 complex float64 points)
FFT_MIN, FFT_MAX = 16, MAX_SMEM // 8
# the chirp-z kernel's transform length: one transform takes 16 M bytes
BLUESTEIN_MAX_M = MAX_SMEM // 16
# the blocks of a chirp-z cluster, smallest first (8: the portable limit)
CLUSTER_SIZES = (2, 4, 8)
# the two-level route: a share's points at most (the one-block chirp-z
# kernel's points a block, kBluesteinPoints), M at most (its reach), a
# tile's local offsets at least and at most (kTileMinOffsets,
# kTileMaxOffsets), the shares at most (a tile of 8 offsets of C points in
# a block: kGlobalMaxC), and the scratch bytes of one launch at most
GLOBAL_SHARE_MAX = 4096
GLOBAL_MAX_M = 1 << 20
GLOBAL_TILE_MIN, GLOBAL_TILE_MAX = 8, 64
GLOBAL_MAX_C = MAX_SMEM // (16 * GLOBAL_TILE_MIN)
SCRATCH_BYTES = 512 << 20

_CONSTS: Dict[Tuple[int, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}
_ORDER: Dict[Tuple[int, torch.device], torch.Tensor] = {}
_BLUESTEIN: Dict[tuple, Tuple[torch.Tensor, ...]] = {}


def stft_magnitude_plain(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(B, T) float32 -> (B, 1 + T//hop, n_fft//2 + 1): the matmul-DFT path."""
    return S.stft_magnitude(x, n_fft, hop, use_matmul_dft=True)


def transform_passes(n: int) -> Tuple[int, ...]:
    """The pass list of an n-point complex transform: radix-4 passes while 4
    divides what is left of n, a radix-2 pass where a 2 is left, then radix
    3, 5 and 7 passes (for a power of two, the radix-4 passes and a radix-2
    pass last where log2(n) is odd). Every prefix's product p times the next
    radix R divides n, so the twiddle stride t / (R p) of a table of t = a
    multiple of n entries is an integer. Empty where n has a prime factor
    above 7 (and for n = 1, the transform of one point)."""
    if n < 1:
        return ()
    left, out = n, []
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


def fft_passes(n_fft: int) -> Tuple[int, ...]:
    """The FFT kernel's pass list over the n_fft/2 complex points
    (`transform_passes(n_fft // 2)`). Empty where n_fft is outside the FFT
    route: odd, outside [FFT_MIN, FFT_MAX], or a half with a prime factor
    above 7."""
    if n_fft % 2 or not FFT_MIN <= n_fft <= FFT_MAX:
        return ()
    return transform_passes(n_fft // 2)


def smooth_at_least(n: int) -> int:
    """The smallest number >= max(n, 1) with no prime factor above 7."""
    m = max(n, 1)
    while m > 1 and not transform_passes(m):
        m += 1
    return m


@functools.lru_cache(maxsize=1024)
def bluestein_plan(n_fft: int):
    """(L, M, pass list of M) of the chirp-z kernel at n_fft: L = n_fft for
    an odd n_fft (two real frames as one complex sequence), n_fft/2 for an
    even one (the packed half), M the smallest 7-smooth number >= 2L - 1.
    None where the FFT route takes n_fft, below 2, or where M is above
    BLUESTEIN_MAX_M (one transform's 16 M bytes over a block's shared
    memory)."""
    if n_fft < 2 or fft_passes(n_fft):
        return None
    length = n_fft if n_fft % 2 else n_fft // 2
    m = smooth_at_least(2 * length - 1)
    if m > BLUESTEIN_MAX_M:
        return None
    return length, m, transform_passes(m)


def smooth_multiple(n: int, d: int) -> int:
    """The smallest multiple of d that is >= n and has no prime factor
    above 7 (d itself 7-smooth)."""
    m = -(-max(n, 1) // d) * d
    while not transform_passes(m):
        m += d
    return m


@functools.lru_cache(maxsize=1024)
def bluestein_cluster_plan(n_fft: int, clusters: int = 0):
    """(L, M, C, pass list of M) of the chirp-z cluster kernel at n_fft: L
    as `bluestein_plan`'s; C the first of CLUSTER_SIZES whose share of M/C
    points (16 M/C bytes) fits a block; M the smallest 7-smooth number >=
    2L - 1 that 8 C divides; the pass list `transform_passes(M/C)` (the
    passes within a share) then `transform_passes(C)` (the passes across
    the shares: radix 2, radix 4, or radix 4 then 2). None where another
    route takes n_fft or no 8-block cluster holds it. `clusters` asks for
    that C at any n_fft >= 2 whose share fits (the card's check that the
    cluster kernel computes the one-block kernel's values)."""
    if clusters and clusters not in CLUSTER_SIZES:
        raise ValueError(f"a chirp-z cluster has 2, 4 or 8 blocks, not {clusters}")
    if n_fft < 2 or not clusters and (fft_passes(n_fft) or bluestein_plan(n_fft)):
        return None
    length = n_fft if n_fft % 2 else n_fft // 2
    for c in (clusters,) if clusters else CLUSTER_SIZES:
        m = smooth_multiple(2 * length - 1, 8 * c)
        if 16 * (m // c) <= MAX_SMEM:
            return length, m, c, transform_passes(m // c) + transform_passes(c)
    return None


@functools.lru_cache(maxsize=1024)
def bluestein_global_plan(n_fft: int, clusters: int = 0):
    """(L, M, C, pass list of M) of the two-level chirp-z route at n_fft: L
    as `bluestein_plan`'s; M the smallest 7-smooth multiple of 8 that is >=
    2L - 1; S the largest divisor of M that 8 divides and that is at most
    GLOBAL_SHARE_MAX; C = M / S; the pass list `transform_passes(S)` (the
    passes within a share) then `transform_passes(C)` (across the shares).
    S is then above GLOBAL_SHARE_MAX / 7 (were it not, S times the smallest
    prime of C would be a larger such divisor), so for M up to GLOBAL_MAX_M
    C is at most 2^20 / 592 = 1,771 <= GLOBAL_MAX_C. None where another
    route takes n_fft or M is above GLOBAL_MAX_M (the route's reach).
    `clusters` asks for that C (7-smooth, at least 2) at any n_fft >= 2, M
    then the smallest 7-smooth multiple of 8 C >= 2L - 1 as the cluster
    plan's (the checks that the route computes the one-block and cluster
    kernels' values); None where its share (16 S bytes) or its tile (16 x
    GLOBAL_TILE_MIN x C bytes) is over a block."""
    if clusters and (clusters < 2 or not transform_passes(clusters)):
        raise ValueError(f"the two-level route takes a 7-smooth C >= 2, not {clusters}")
    if n_fft < 2 or not clusters and (fft_passes(n_fft) or bluestein_plan(n_fft)
                                      or bluestein_cluster_plan(n_fft)):
        return None
    length = n_fft if n_fft % 2 else n_fft // 2
    if clusters:
        m = smooth_multiple(2 * length - 1, 8 * clusters)
        share = m // clusters
        if 16 * share > MAX_SMEM or clusters > GLOBAL_MAX_C:
            return None
    else:
        m = smooth_multiple(2 * length - 1, 8)
        if m > GLOBAL_MAX_M:
            return None
        share = max(s for s in range(8, GLOBAL_SHARE_MAX + 1, 8) if m % s == 0)
    return length, m, m // share, transform_passes(share) + transform_passes(m // share)


def global_tile(clusters: int) -> int:
    """The local offsets of a tile of the two-level route's kernels across
    the shares at C = `clusters` (`global_tile` in csrc/stft.cu): the
    largest power of two from GLOBAL_TILE_MAX down whose C points each stay
    within GLOBAL_SHARE_MAX, and never below GLOBAL_TILE_MIN."""
    kt = GLOBAL_TILE_MAX
    while kt > GLOBAL_TILE_MIN and kt * clusters > GLOBAL_SHARE_MAX:
        kt //= 2
    return kt


def route(n_fft: int) -> str:
    """"fft" where `fft_passes` has a plan, "bluestein" where
    `bluestein_plan` has one, "bluestein_cluster" where
    `bluestein_cluster_plan` has one, "bluestein_global" for any other n_fft
    >= 2 (whose launch raises beyond the route's reach, GLOBAL_MAX_M); below
    2 there is no STFT to take."""
    if n_fft < 2:
        raise ValueError(f"stft: need n_fft >= 2, got {n_fft}")
    if fft_passes(n_fft):
        return "fft"
    if bluestein_plan(n_fft):
        return "bluestein"
    return "bluestein_cluster" if bluestein_cluster_plan(n_fft) else "bluestein_global"


def digit_reversed(passes: Tuple[int, ...]) -> np.ndarray:
    """pos[m], the position of point m of a transform in the input order of
    its DIT passes (the FFT kernel's load order, `fft_order`): m = sum_j
    d_j Q_j (Q_j the product of the radices after pass j) sits at sum_j d_j
    p_j (p_j the product of those before it). The DIF passes leave point m
    of the transform there too (the order of `bluestein_tables`' last)."""
    n = int(np.prod(passes)) if passes else 1
    m = np.arange(n)
    pos = np.zeros(n, dtype=np.int64)
    for r in reversed(passes):
        pos = pos * r + m % r
        m = m // r
    return pos


@functools.lru_cache(maxsize=32)
def _twiddles_np(n_fft: int) -> np.ndarray:
    ang = -2.0 * np.pi * np.arange(n_fft) / n_fft
    return np.stack([np.cos(ang), np.sin(ang)], axis=-1)


def twiddles(n_fft: int, device=None) -> torch.Tensor:
    """(n_fft, 2) float64 table of exp(-2 pi i j / n_fft), from the float64
    expression the DFT basis is cast from: cast to float32, row j is the
    basis' column 1, (cos, sin)[j, 1]. The FFT's passes read it at a
    stride of n_fft / (R p) and their odd radices' constants at n_fft / R,
    its real post-twiddle at stride 1 (the float32 DFT basis is this
    expression read at (n k) mod n_fft). The chirp-z kernels read the
    tables of 2L (its chirp, at j^2 mod 2L, and for an even n_fft its
    post-twiddle: 2L = n_fft) and of M (its passes)."""
    return torch.from_numpy(_twiddles_np(n_fft)).to(device)


def chirp_plan(n_fft: int):
    """(L, M, C, pass list) of the chirp-z route n_fft takes: the one-block
    plan with C = 1, the cluster plan, or the two-level plan (None beyond
    its reach)."""
    plan = bluestein_plan(n_fft)
    if plan:
        return (*plan[:2], 1, plan[2])
    return bluestein_cluster_plan(n_fft) or bluestein_global_plan(n_fft)


@functools.lru_cache(maxsize=32)
def _bluestein_np(n_fft: int, m: int, passes: Tuple[int, ...]):
    length = n_fft if n_fft % 2 else n_fft // 2
    chirp = _twiddles_np(2 * length)
    j = np.arange(length, dtype=np.int64)
    c = chirp[(j * j) % (2 * length)]
    b = np.zeros(m, dtype=np.complex128)
    b[:length] = c[:, 0] - 1j * c[:, 1]  # conj(c_j), and at M - j for 0 < j < L
    b[m - length + 1:] = b[1:length][::-1]
    fb = np.fft.fft(b) / m
    ordered = np.empty_like(fb)
    ordered[digit_reversed(passes)] = fb
    return chirp, _twiddles_np(m), np.stack([ordered.real, ordered.imag], axis=-1)


def bluestein_tables(n_fft: int, device=None, plan=None):
    """The chirp-z kernels' float64 tables at n_fft and `plan` (an (L, M,
    C, pass list) of `chirp_plan`'s form; by default the route's): the
    chirp table (2L, 2) (`twiddles(2L)`, read at j^2 mod 2L, the index
    reduced in integers), the M-point twiddle table (M, 2), and the
    transform over M of the conjugate chirp (conj(c_j) at j and M - j for j
    < L, zero between; float64 `numpy.fft.fft`), times 1/M and stored where
    the DIF passes leave each point (`digit_reversed` of the pass list),
    (M, 2)."""
    _, m, _, passes = plan or chirp_plan(n_fft)
    return tuple(torch.from_numpy(t).to(device) for t in _bluestein_np(n_fft, m, tuple(passes)))


# ---------------------------------------------------------------------------
# Launches


def _constants(n_fft: int, device: torch.device):
    """The float64 window and twiddle table the FFT kernel reads, cached per
    (n_fft, device)."""
    key = (n_fft, device)
    if key not in _CONSTS:
        _CONSTS[key] = (S.hann_window(n_fft, device, torch.float64).contiguous(),
                        twiddles(n_fft, device).contiguous())
    return _CONSTS[key]


COUNTERS = {"fft": "stft_magnitude", "bluestein": "stft_magnitude_bluestein",
            "bluestein_cluster": "stft_magnitude_bluestein_cluster",
            "bluestein_global": "stft_magnitude_bluestein_global"}


def pack_passes(passes: Tuple[int, ...]) -> int:
    """A pass list as the kernels take it: 4 bits a radix from the lowest
    (16 passes at most)."""
    if len(passes) > 16:
        raise ValueError(f"a pass list of {len(passes)} passes does not fit 64 bits")
    return sum(r << (4 * i) for i, r in enumerate(passes))


def fft_order(n_fft: int, device=None) -> torch.Tensor:
    """(n_fft/2,) int32: the FFT kernel's load order, where each packed
    point goes in its DIT passes' input (`digit_reversed` of its pass list),
    cached per (n_fft, device)."""
    key = (n_fft, device)
    if key not in _ORDER:
        pos = digit_reversed(fft_passes(n_fft)).astype(np.int32)
        _ORDER[key] = torch.from_numpy(pos).to(device).contiguous()
    return _ORDER[key]


def _check(x: torch.Tensor, n_fft: int, hop: int) -> str:
    if x.dim() != 2 or x.dtype != torch.float32:
        raise ValueError(f"x must be (B, T) float32, got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    b, t = x.shape
    kind = route(n_fft)
    if kind == "bluestein_global" and bluestein_global_plan(n_fft) is None:
        raise ValueError(f"stft: n_fft {n_fft} is beyond the two-level chirp-z route's reach "
                         f"(M up to {GLOBAL_MAX_M}: odd n_fft to 524,287, even to 1,048,576)")
    if hop < 1 or t <= n_fft // 2:
        raise ValueError(f"stft: need hop >= 1 and T > n_fft//2 (T={t})")
    if not 1 <= b <= 65535:
        raise ValueError(f"stft kernel takes 1 <= B <= 65535, got {b}")
    return kind


def _outputs(x: torch.Tensor, n_fft: int, hop: int, spectrum: bool):
    b, t = x.shape
    # the frames `frame_signal` cuts from the padded signal (1 + T//hop for
    # an even n_fft, one fewer where an odd one's last frame would run past)
    n_frames = S.num_frames(t + 2 * (n_fft // 2), n_fft, hop, center=False)
    out = torch.empty(b, n_frames, n_fft // 2 + 1, dtype=torch.float32, device=x.device)
    re, im = (torch.empty_like(out), torch.empty_like(out)) if spectrum else (None, None)
    return out, re, im


def launch(x: torch.Tensor, n_fft: int, hop: int, spectrum: bool = False):
    """The kernel of `route(n_fft)` on a CUDA tensor: the magnitudes, and with
    `spectrum` also the (re, im) they came from, each (B, F, n_fft//2 + 1)."""
    from nsc_tpu_torch.kernels import _build

    kind = _check(x, n_fft, hop)
    if kind in ("bluestein", "bluestein_cluster"):
        return launch_chirp(x, n_fft, hop, chirp_plan(n_fft), spectrum)
    if kind == "bluestein_global":
        return launch_global(x, n_fft, hop, bluestein_global_plan(n_fft), spectrum)
    b, t = x.shape
    out, re, im = _outputs(x, n_fft, hop, spectrum)
    ptrs = (re.data_ptr(), im.data_ptr()) if spectrum else (None, None)
    win, tw = _constants(n_fft, x.device)
    err = _build.library().nsc_stft_magnitude_fft(
        x.data_ptr(), win.data_ptr(), tw.data_ptr(), fft_order(n_fft, x.device).data_ptr(),
        out.data_ptr(), *ptrs, b, t, n_fft, hop, out.shape[1], pack_passes(fft_passes(n_fft)),
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "nsc_stft_magnitude_fft")
    kernels.LAUNCHES[COUNTERS[kind]] += 1
    return (out, re, im) if spectrum else out


def _chirp_args(x: torch.Tensor, n_fft: int, hop: int, plan, spectrum: bool):
    """The outputs and the leading arguments of a chirp-z entry point at
    `plan`: x, the float64 window and tables (cached per (n_fft, M, pass
    list, device)), out, re, im, B, T, n_fft, hop, F, M."""
    _check(x, n_fft, hop)
    b, t = x.shape
    _, m, _, passes = plan
    key = (n_fft, m, tuple(passes), x.device)
    if key not in _BLUESTEIN:
        _BLUESTEIN[key] = (S.hann_window(n_fft, x.device, torch.float64).contiguous(),
                           *(t_.contiguous() for t_ in bluestein_tables(n_fft, x.device, plan)))
    out, re, im = _outputs(x, n_fft, hop, spectrum)
    ptrs = (re.data_ptr(), im.data_ptr()) if spectrum else (None, None)
    return (out, re, im), (x.data_ptr(), *(t_.data_ptr() for t_ in _BLUESTEIN[key]),
                           out.data_ptr(), *ptrs, b, t, n_fft, hop, out.shape[1], m)


def launch_chirp(x: torch.Tensor, n_fft: int, hop: int, plan, spectrum: bool = False):
    """A chirp-z kernel on a CUDA tensor at `plan`, (L, M, C, pass list):
    the one-block kernel for C = 1, else the cluster kernel of C blocks.
    `launch` gives it the route's plan (`chirp_plan`); another plan of the
    same n_fft computes the same magnitudes up to float64 rounding."""
    from nsc_tpu_torch.kernels import _build

    (out, re, im), args = _chirp_args(x, n_fft, hop, plan, spectrum)
    _, _, c, passes = plan
    stream = torch.cuda.current_stream(x.device).cuda_stream
    lib = _build.library()
    if c == 1:
        kind = "bluestein"
        err = lib.nsc_stft_magnitude_bluestein(*args, pack_passes(passes), stream)
    else:
        kind = "bluestein_cluster"
        err = lib.nsc_stft_magnitude_bluestein_cluster(*args, c, pack_passes(passes), stream)
    _build.check(err, f"nsc_stft_magnitude_{kind}")
    kernels.LAUNCHES[COUNTERS[kind]] += 1
    return (out, re, im) if spectrum else out


def global_chunk(transforms: int, m: int) -> int:
    """The transforms the two-level route's scratch holds at once: all of
    them, or as many as SCRATCH_BYTES holds at 16 M bytes each (one at
    least)."""
    return max(1, min(transforms, SCRATCH_BYTES // (16 * m)))


def launch_global(x: torch.Tensor, n_fft: int, hop: int, plan, spectrum: bool = False):
    """The two-level chirp-z route on a CUDA tensor at `plan`, (L, M, C,
    pass list) of `bluestein_global_plan`'s form: its four kernels, chunk by
    chunk of transforms (`global_chunk`), on a float64 scratch buffer made
    here. `launch` gives it the route's plan; at a one-block or cluster
    plan (`bluestein_global_plan(n_fft, C)`) it computes those kernels'
    values bit for bit."""
    from nsc_tpu_torch.kernels import _build

    (out, re, im), args = _chirp_args(x, n_fft, hop, plan, spectrum)
    _, m, c, passes = plan
    per_row = (out.shape[1] + 1) // 2 if n_fft % 2 else out.shape[1]
    chunk = global_chunk(x.shape[0] * per_row, m)
    scratch = torch.empty(chunk, m, 2, dtype=torch.float64, device=x.device)
    args = args[:5] + (scratch.data_ptr(),) + args[5:]
    err = _build.library().nsc_stft_magnitude_bluestein_global(
        *args, c, chunk, pack_passes(passes), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "nsc_stft_magnitude_bluestein_global")
    kernels.LAUNCHES[COUNTERS["bluestein_global"]] += 1
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
