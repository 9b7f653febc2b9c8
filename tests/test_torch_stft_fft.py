"""The plan of the FFT route of the port's |STFT| kernel (K4), restated in
PyTorch (`stft_magnitude_fft_plain` below), on the CPU: against the
plain matmul-DFT version and the JAX package's Pallas kernel in interpret
mode, and at the mixed-radix n_fft against float64 `numpy.fft.rfft`; the
DFT remainder's arithmetic (`stft_magnitude_dft_plain`) against float64;
its twiddle table against the DFT basis; the routing rule; and the
spectrum backward against autograd of the plain version.

Tolerances:
  * the FFT plan (float64, rounded once) vs the plain version and
    `stft_magnitude_pallas(interpret=True)`: rtol 1e-4, atol 1e-4 *
    max|ref|, the JAX package's own kernel-test tolerance (the float32 DFT
    sums' error).
  * the FFT plan vs float64 rfft magnitudes (the same float64 window):
    2 float32 ulps elementwise, the plan's float64 passes rounded once
    (half an ulp) and their own float64 rounding far below it.
  * the DFT remainder's float64 sums vs float64 rfft: DFT_F64_TOL = 2^-23
    of each frame's peak magnitude. One rounding to float32 moves a
    magnitude v by at most 2^-24 v, so a float64 sum reads at most 2^-24
    of the peak; float32 sums (the plain matmul-DFT) read ~5e-7 at n_fft
    441 and 2018, so the limit is 2x the first and below the second.
  * the float64 twiddle table: cast to float32, bit-equal to the basis'
    column 1 (both come from the same float64 expression); any float64
    basis entry within 1e-11 of its table entry (the angle n*k/n_fft reduced
    mod n_fft rounds differently in float64: angles up to ~1.3e4 at n_fft
    4096, ~2e-12 of rounding), within one float32 ulp once
    both are cast.
  * the spectrum backward vs autograd of the plain version on the same
    spectrum: float32 summation order, 1e-5 * max|g|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsc_tpu.ops.pallas import stft as JPS
from nsc_tpu_torch.kernels import stft as KS
from nsc_tpu_torch.ops import stft as S
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

POWERS = [16, 128, 256, 512, 1024, 2048, 4096]
# even n_fft whose half factors into 2, 3, 5 and 7: speech windows (20 and
# 25 ms at 16, 24, 44.1 and 48 kHz), 882 = 2 x 3^2 x 7^2, 1568 = 2^5 x 7^2,
# and two beyond the powers of two the route took before
MIXED = [120, 320, 400, 480, 882, 960, 1200, 1568, 6000, 8192]
# n_fft the remainder takes: odd, a half with a prime factor above 7 (1009
# is prime), above the FFT's one-frame limit
REMAINDER = [2, 3, 17, 441, 2018, 12000]
DFT_F64_TOL = 2.0 ** -23


def fft_passes(n_fft):
    """(radix, p) of each Stockham pass over the n_fft/2 complex points, the
    kernel's pass list (`KS.fft_passes`, restated): radix-4 passes while 4
    divides what is left of n_fft/2, a radix-2 pass where a 2 is left, then
    radix 3, 5 and 7 passes; p is the length of the sub-transforms a pass
    combines R at a time."""
    left, p, out = n_fft // 2, 1, []

    def take(radix):
        nonlocal left, p
        out.append((radix, p))
        left //= radix
        p *= radix

    while left % 4 == 0:
        take(4)
    if left % 2 == 0:
        take(2)
    for radix in (3, 5, 7):
        while left % radix == 0:
            take(radix)
    assert left == 1, f"n_fft/2 = {n_fft // 2} has a prime factor above 7"
    return out


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def _butterfly(radix, ur, ui, c, s, n_fft):
    """The R-point DFT of u_0..u_(R-1) as the kernel takes it: radix 4 and 2
    in closed form, odd R in pairs (t, R - t) with a_m = u_m + u_(R-m), b_m
    = u_m - u_(R-m) and W_R^(m t) from the table at (m t mod R) n_fft / R."""
    if radix == 4:
        a0r, a0i = ur[0] + ur[2], ui[0] + ui[2]
        a1r, a1i = ur[0] - ur[2], ui[0] - ui[2]
        a2r, a2i = ur[1] + ur[3], ui[1] + ui[3]
        a3r, a3i = ur[1] - ur[3], ui[1] - ui[3]
        return [a0r + a2r, a1r + a3i, a0r - a2r, a1r - a3i], [a0i + a2i, a1i - a3r, a0i - a2i, a1i + a3r]
    if radix == 2:
        return [ur[0] + ur[1], ur[0] - ur[1]], [ui[0] + ui[1], ui[0] - ui[1]]
    h, stride = (radix - 1) // 2, n_fft // radix
    ar = [ur[m] + ur[radix - m] for m in range(1, h + 1)]
    ai = [ui[m] + ui[radix - m] for m in range(1, h + 1)]
    br = [ur[m] - ur[radix - m] for m in range(1, h + 1)]
    bi = [ui[m] - ui[radix - m] for m in range(1, h + 1)]
    yr, yi = [None] * radix, [None] * radix
    yr[0], yi[0] = ur[0] + sum(ar), ui[0] + sum(ai)
    for t in range(1, h + 1):
        rr, ri, jr, ji = ur[0], ui[0], 0.0, 0.0
        for m in range(1, h + 1):
            j = (m * t) % radix * stride
            rr, ri = rr + ar[m - 1] * c[j], ri + ai[m - 1] * c[j]
            jr, ji = jr + br[m - 1] * s[j], ji + bi[m - 1] * s[j]
        yr[t], yi[t] = rr - ji, ri + jr
        yr[radix - t], yi[radix - t] = rr + ji, ri - jr
    return yr, yi


def stft_magnitude_fft_plain(x, n_fft, hop):
    """The FFT kernel's plan (csrc/stft.cu) restated in PyTorch, in float64
    with the magnitudes rounded to float32 (the same packing, passes,
    twiddle table and post-twiddle; the kernel may fuse a multiply and an
    add where this rounds each): (B, T) float32 -> (B, F, n_fft//2 + 1)."""
    if KS.route(n_fft) != "fft":
        raise ValueError(f"the FFT route does not take n_fft {n_fft}")
    n2 = n_fft // 2
    tw = KS.twiddles(n_fft, x.device)
    c, s = tw[:, 0], tw[:, 1]
    frames = S.frame_signal(x.float().double(), n_fft, hop) * S.hann_window(
        n_fft, x.device, torch.float64)
    zr, zi = frames[..., 0::2], frames[..., 1::2]
    for radix, p in fft_passes(n_fft):
        q = n2 // radix
        i = torch.arange(q, device=x.device)
        k = i % p
        ur = [zr[..., i + m * q] for m in range(radix)]
        ui = [zi[..., i + m * q] for m in range(radix)]
        step = n_fft // (radix * p)
        for m in range(1, radix):
            j = m * k * step
            ur[m], ui[m] = _cmul(ur[m], ui[m], c[j], s[j])
        yr, yi = _butterfly(radix, ur, ui, c, s, n_fft)
        out = (i - k) * radix + k
        nr, ni = torch.empty_like(zr), torch.empty_like(zi)
        for t in range(radix):
            nr[..., out + t * p] = yr[t]
            ni[..., out + t * p] = yi[t]
        zr, zi = nr, ni
    # real spectrum: X[k] = Ze[k] + W^k Zo[k], Ze/Zo from Z[k] and Z[n2-k]*
    k = torch.arange(n2 + 1, device=x.device)
    ar, ai = zr[..., k % n2], zi[..., k % n2]
    br, bi = zr[..., (n2 - k) % n2], -zi[..., (n2 - k) % n2]
    er, ei = 0.5 * (ar + br), 0.5 * (ai + bi)
    o_r, o_i = 0.5 * (ai - bi), -0.5 * (ar - br)
    tr, ti = _cmul(o_r, o_i, c[k], s[k])
    xr, xi = er + tr, ei + ti
    return torch.sqrt(xr * xr + xi * xi + 1e-8).float()


def stft_magnitude_dft_plain(x, n_fft, hop):
    """The DFT remainder's arithmetic restated: float64 windowed frames
    against the float64 table read at (n k) mod n_fft, rounded once."""
    tw = KS.twiddles(n_fft, x.device)
    frames = S.frame_signal(x.float().double(), n_fft, hop) * S.hann_window(
        n_fft, x.device, torch.float64)
    j = (torch.arange(n_fft)[:, None] * torch.arange(n_fft // 2 + 1)[None, :]) % n_fft
    re, im = frames @ tw[j, 0], frames @ tw[j, 1]
    return torch.sqrt(re * re + im * im + 1e-8).float()


def rfft_magnitude_f64(x, n_fft, hop):
    """Float64 magnitudes of float64 `numpy.fft.rfft` of the same frames
    (the float64 window, the same 1e-8 under the root)."""
    frames = S.frame_signal(torch.from_numpy(x).double(), n_fft, hop).numpy()
    z = np.fft.rfft(frames * S.hann_window(n_fft, dtype=torch.float64).numpy(), axis=-1)
    return np.sqrt(z.real ** 2 + z.imag ** 2 + 1e-8)


def _x(b, t, seed):
    return (np.random.RandomState(seed).randn(b, t) * 0.3).astype(np.float32)


@pytest.mark.parametrize("n_fft", POWERS)
def test_fft_plan_matches_plain_and_pallas(n_fft):
    hop = n_fft // 4
    t = 2 * n_fft + 37  # no hop divides it
    x = _x(2, t, seed=n_fft)
    got = stft_magnitude_fft_plain(torch.from_numpy(x), n_fft, hop).numpy()
    plain = KS.stft_magnitude_plain(torch.from_numpy(x), n_fft, hop).numpy()
    pallas = np.asarray(JPS.stft_magnitude_pallas(jnp.asarray(x), n_fft, hop, interpret=True))
    assert got.shape == plain.shape == pallas.shape == (2, 1 + t // hop, n_fft // 2 + 1)
    for ref in (plain, pallas):
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("n_fft", POWERS)
def test_twiddle_table_against_dft_basis(n_fft):
    """The float64 table the kernel reads, cast to float32, is the basis'
    column 1 bit for bit; every float64 basis entry is the table's entry at
    n*k mod n_fft up to the float64 rounding of the unreduced angle."""
    tw = KS.twiddles(n_fft)
    cos_b, sin_b = S.dft_basis(n_fft)
    assert tw.dtype == torch.float64 and tw.shape == (n_fft, 2)
    assert torch.equal(tw[:, 0].float(), cos_b[:, 1]) and torch.equal(tw[:, 1].float(), sin_b[:, 1])
    cos64, sin64 = S.dft_basis(n_fft, dtype=torch.float64)
    n = torch.arange(n_fft)[:, None]
    k = torch.arange(n_fft // 2 + 1)[None, :]
    j = (n * k) % n_fft
    assert (tw[j, 0] - cos64).abs().max().item() <= 1e-11
    assert (tw[j, 1] - sin64).abs().max().item() <= 1e-11
    assert (tw[j, 0].float() - cos_b).abs().max().item() <= 2.0 ** -24


@pytest.mark.parametrize("n_fft", [16, 32, 64, 128, 2048, 4096])
def test_fft_passes_cover_the_transform(n_fft):
    """Radix-4 passes with p = 1, 4, 16, ..., and one radix-2 pass last
    where log2(n_fft/2) is odd: the radices multiply to n_fft/2."""
    passes = fft_passes(n_fft)
    p = 1
    for i, (radix, pp) in enumerate(passes):
        assert pp == p and (radix == 4 or i == len(passes) - 1)
        p *= radix
    assert p == n_fft // 2
    assert (passes[-1][0] == 2) == (int(np.log2(n_fft // 2)) % 2 == 1)


def test_routing_rule():
    for n in (16, 32, 64, 128, 256, 512, 1024, 2048, 4096):
        assert KS.route(n) == "fft"
    for n in (2, 4, 8, 17, 3):
        assert KS.route(n) == "dft"
    for n in (400, 1000, 8192):  # 2^3 5^2, 2^3 5^3, 2^13
        assert KS.route(n) == "fft"
    for n in MIXED + [11520]:  # 11520 = 2 x 2^7 3^2 5, the largest the plan admits
        assert KS.route(n) == "fft", n
    for n in REMAINDER + [11522, 16384, KS.FFT_MAX + 2]:
        assert KS.route(n) == "dft", n
    assert KS.FFT_MAX == 11622  # 20 bytes a point at one frame
    for n in (1, 0, -4):
        with pytest.raises(ValueError):
            KS.route(n)
    with pytest.raises(ValueError):
        stft_magnitude_fft_plain(torch.zeros(1, 999), 441, 110)


def test_wrapper_pass_list_is_the_restated_plan():
    """The pass list the wrapper gives the kernel (`KS.fft_passes`) is the
    restated plan at every n_fft the route takes (even, 16 to 11,622, a
    half with no prime factor above 7), and empty at every other."""
    for n in range(-2, KS.FFT_MAX + 40):
        left = abs(n) // 2
        for r in (2, 3, 5, 7):
            while left and left % r == 0:
                left //= r
        taken = n % 2 == 0 and 16 <= n <= 11622 and left == 1
        want = tuple(r for r, _ in fft_passes(n)) if taken else ()
        assert KS.fft_passes(n) == want, n


@pytest.mark.parametrize("n_fft", MIXED)
def test_mixed_radix_plan_against_float64_rfft(n_fft):
    """The plan's passes of radix 2/3/4/5/7 (k = i mod p) give the float64
    spectrum's magnitudes, rounded once: within 2 float32 ulps each."""
    hop = n_fft // 4
    t = 2 * n_fft + 37  # no hop divides it
    x = _x(2, t, seed=n_fft)
    got = stft_magnitude_fft_plain(torch.from_numpy(x), n_fft, hop).numpy()
    ref = rfft_magnitude_f64(x, n_fft, hop)
    assert got.shape == ref.shape == (2, 1 + t // hop, n_fft // 2 + 1)
    ulp = np.spacing(ref.astype(np.float32)).astype(np.float64)
    assert (np.abs(got - ref) / ulp).max() <= 2.0


@pytest.mark.parametrize("n_fft", [n for n in MIXED if n <= 1568])
def test_mixed_radix_plan_matches_plain_and_pallas(n_fft):
    hop = n_fft // 4
    t = 2 * n_fft + 37
    x = _x(1, t, seed=n_fft + 1)
    got = stft_magnitude_fft_plain(torch.from_numpy(x), n_fft, hop).numpy()
    plain = KS.stft_magnitude_plain(torch.from_numpy(x), n_fft, hop).numpy()
    pallas = np.asarray(JPS.stft_magnitude_pallas(jnp.asarray(x), n_fft, hop, interpret=True))
    for ref in (plain, pallas):
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("n_fft", MIXED + [11520])
def test_mixed_radix_passes_cover_the_transform(n_fft):
    """Radix-4 passes, one radix-2 pass where a 2 is left, then radix 3, 5
    and 7 in that order: the radices multiply to n_fft/2 and every R p
    divides it (Stockham's twiddle stride n_fft / (R p) is an integer)."""
    passes = fft_passes(n_fft)
    radices = [r for r, _ in passes]
    assert radices == sorted(radices, key=[4, 2, 3, 5, 7].index)
    assert radices.count(2) <= 1
    p = 1
    for radix, pp in passes:
        assert pp == p and (n_fft // 2) % (radix * p) == 0
        p *= radix
    assert p == n_fft // 2


@pytest.mark.parametrize("n_fft,hop", [(2, 1), (3, 1), (17, 5), (441, 110), (2018, 504),
                                       (12000, 3000)])
def test_dft_remainder_against_float64_rfft(n_fft, hop):
    """The remainder's float64 sums, rounded once, within DFT_F64_TOL of
    each frame's peak of the float64 magnitudes; the frame count is the
    plain version's (one fewer than 1 + T//hop for an odd n_fft where hop
    divides T). The control: from n_fft 441 on, the plain version's
    float32 sums lie beyond the limit."""
    t = 2 * n_fft + 37 if n_fft > 3 else 60
    x = _x(2, t, seed=n_fft)
    got = stft_magnitude_dft_plain(torch.from_numpy(x), n_fft, hop).numpy()
    ref = rfft_magnitude_f64(x, n_fft, hop)
    plain = KS.stft_magnitude_plain(torch.from_numpy(x), n_fft, hop).numpy()
    assert got.shape == ref.shape == plain.shape
    peak = ref.max(-1, keepdims=True)
    assert (np.abs(got - ref) / peak).max() <= DFT_F64_TOL
    if n_fft >= 441:
        assert (np.abs(plain - ref) / peak).max() > DFT_F64_TOL


@pytest.mark.parametrize("n_fft,hop,t", [(256, 64, 1500), (128, 32, 999), (16, 5, 300),
                                         (400, 100, 2000)])
def test_spectrum_backward_matches_autograd(n_fft, hop, t):
    x = torch.from_numpy(_x(2, t, seed=t)).requires_grad_(True)
    y = KS.stft_magnitude_plain(x, n_fft, hop)
    g = torch.rand(y.shape, generator=torch.Generator().manual_seed(0))
    (ref,) = torch.autograd.grad(y, x, g)
    frames = S.frame_signal(x.detach(), n_fft, hop) * S.hann_window(n_fft)
    cos_b, sin_b = S.dft_basis(n_fft)
    got = KS.stft_magnitude_backward(g, frames @ cos_b, frames @ sin_b, y.detach(), t, n_fft, hop)
    assert got.shape == ref.shape
    assert (got - ref).abs().max().item() <= 1e-5 * ref.abs().max().item()
