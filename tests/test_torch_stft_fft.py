"""The plans of the port's |STFT| kernels (K4), restated in PyTorch, on
the CPU: the FFT route's one-buffer plan (`stft_magnitude_fft_plain`:
digit-reversed load, in-place DIT passes, post-twiddle) and the chirp-z
route's (`stft_magnitude_bluestein_plain`: chirp from integer j^2 mod 2L,
M the smallest 7-smooth number >= 2L - 1, DIF passes, the conjugate
chirp's transform, DIT passes), each against the plain matmul-DFT version
and the JAX package's Pallas kernel in interpret mode and against float64
`numpy.fft.rfft`; the one-buffer plan against the two-buffer Stockham plan
the FFT kernel ran before (`stft_magnitude_stockham_plain`), bit for bit;
the chirp-z cluster route's plan (`stft_magnitude_bluestein_cluster_plain`:
the M points in C contiguous shares, the passes within a share on each
share, the passes across the shares on the C points of each local offset)
against the one-buffer chirp-z plan at the same M and pass list, bit for
bit, and against float64 `numpy.fft.rfft`, and its (M, C, pass list)
against an independent search; the two-level route's plan
(`stft_magnitude_bluestein_global_plain`: the M points of a transform in
one array, the passes across the shares on tiles of local offsets, the
passes within each share, the passes across again) against the one-buffer
and cluster plans at the same M and pass list, bit for bit, against
float64 `numpy.fft.rfft` at its route's shapes, its plan against an
independent search and its 64-bit chirp index against exact integers; the
twiddle table against the DFT basis; the routing rule and its boundaries;
and the spectrum backward against autograd of the plain version.

Tolerances:
  * the FFT and chirp-z plans (float64, rounded once) vs the plain version
    and `stft_magnitude_pallas(interpret=True)`: rtol 1e-4, atol 1e-4 *
    max|ref|, the JAX package's own kernel-test tolerance (the float32 DFT
    sums' error).
  * the FFT and chirp-z plans vs float64 rfft magnitudes (the same float64
    window): 2 float32 ulps elementwise, the plan's float64 passes rounded
    once (half an ulp) and their own float64 rounding far below it.
  * the one-buffer plan vs the Stockham plan, and the cluster and two-level
    plans vs the one-buffer chirp-z plan at its M and pass list (and the
    two-level plan vs the cluster plan): equal, bit for bit (the same
    butterflies and twiddles in the same order per point, in other slots,
    blocks or tiles).
  * the float64 twiddle table: cast to float32, bit-equal to the basis'
    column 1 (both come from the same float64 expression); any float64
    basis entry within 1e-11 of its table entry (the angle n*k/n_fft reduced
    mod n_fft rounds differently in float64: angles up to ~1.3e4 at n_fft
    4096, ~2e-12 of rounding), within one float32 ulp once
    both are cast.
  * the spectrum backward vs autograd of the plain version on the same
    spectrum: float32 summation order, 1e-5 * max|g|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsc_tpu.losses import spectral as JSP
from nsc_tpu.ops.pallas import stft as JPS
from nsc_tpu_torch.kernels import stft as KS
from nsc_tpu_torch.losses import spectral as SP
from nsc_tpu_torch.ops import stft as S
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

POWERS = [16, 128, 256, 512, 1024, 2048, 4096]
# even n_fft whose half factors into 2, 3, 5 and 7: speech windows (20 and
# 25 ms at 16, 24, 44.1 and 48 kHz), 882 = 2 x 3^2 x 7^2, 1568 = 2^5 x 7^2,
# and three long windows (12000 fits a block only as one buffer of n_fft/2
# complex points: 8 bytes a point)
MIXED = [120, 320, 400, 480, 882, 960, 1200, 1568, 6000, 8192, 12000]
# n_fft the chirp-z route takes: odd, below the FFT's 16, a half with a
# prime factor above 7 (1009 is prime)
BLUESTEIN = [2, 3, 4, 8, 10, 17, 38, 441, 2018]
# n_fft the chirp-z cluster route takes: odd or a non-smooth half beyond
# the one-block chirp-z plan's limit, a smooth even n_fft above the FFT's
# one-buffer limit
CLUSTER = [7205, 8191, 14410, 29056, 30000]
# the cluster route's shapes on the card (chip_smoke.py's K4_CLUSTER_SHAPES):
# C 2 (8191 odd, 11025 = 3^2 5^2 7^2 odd), 4 (30000 = 2 x 3 x 5^4 x 2^3
# even, above the FFT's limit), 8 (31999 odd)
CLUSTER_SHAPES = [(8191, 2048), (11025, 2756), (30000, 7500), (31999, 8000)]
# n_fft no 8-block cluster holds: the two-level route (57601 and 115202 its
# first odd and even ones, 131072 = 2^17, 262145 odd)
GLOBAL = [57601, 60001, 115202, 127999, 131072, 262145]
# the two-level route's shapes on the card (chip_smoke.py's
# K4_GLOBAL_SHAPES), here at B 1 and a few frames
GLOBAL_SHAPES = [(60001, 15000), (115202, 28800), (131072, 32768), (262145, 65536)]


def fft_passes(n_fft):
    """(radix, p) of each pass over the n_fft/2 complex points, the FFT
    kernel's pass list (`KS.fft_passes`, restated)."""
    return transform_passes(n_fft // 2)


def transform_passes(n):
    """(radix, p) of each pass of an n-point transform (`KS.transform_passes`,
    restated): radix-4 passes while 4 divides what is left of n, a radix-2
    pass where a 2 is left, then radix 3, 5 and 7 passes; p is the length
    of the sub-transforms a pass combines R at a time."""
    left, p, out = n, 1, []

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
    assert left == 1, f"{n} has a prime factor above 7"
    return out


def smallest_smooth(n):
    """The smallest number >= n with no prime factor above 7."""
    m = max(n, 1)
    while True:
        left = m
        for r in (2, 3, 5, 7):
            while left % r == 0:
                left //= r
        if left == 1:
            return m
        m += 1


def digit_reversed(passes):
    """pos[m]: where point m of a transform sits in its DIT passes' input
    order, m = sum_j d_j Q_j -> sum_j d_j p_j (Q_j the product of the radices
    after pass j, p_j of those before it), digit by digit."""
    radices = [r for r, _ in passes]
    n = int(np.prod(radices)) if radices else 1
    pos = []
    for m in range(n):
        digits = []
        for r in reversed(radices):  # the last pass's digit is the lowest of m
            digits.append(m % r)
            m //= r
        digits.reverse()
        p, q = 1, 0
        for d, r in zip(digits, radices):
            q += d * p
            p *= r
        pos.append(q)
    return torch.tensor(pos)


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


def _passes_in_place(zr, zi, passes, c, s, tn, dif):
    """The kernels' in-place passes over the last axis (its length the
    product of the radices): butterfly i of radix R at p (k = i mod p) owns
    the points (i - k) R + k + m p. DIT (passes first to last) twiddles
    u_m by W^(m k tn/(R p)) from the table (c, s) of tn entries before the
    R-point DFT; DIF (last to first) twiddles its outputs after it."""
    n = zr.shape[-1]
    for radix, p in (reversed(passes) if dif else passes):
        q = n // radix
        i = torch.arange(q, device=zr.device)
        k = i % p
        at = [(i - k) * radix + k + m * p for m in range(radix)]
        ur = [zr[..., a] for a in at]
        ui = [zi[..., a] for a in at]
        step = tn // (radix * p)
        if not dif:
            for m in range(1, radix):
                j = m * k * step
                ur[m], ui[m] = _cmul(ur[m], ui[m], c[j], s[j])
        yr, yi = _butterfly(radix, ur, ui, c, s, tn)
        if dif:
            for t in range(1, radix):
                j = t * k * step
                yr[t], yi[t] = _cmul(yr[t], yi[t], c[j], s[j])
        zr, zi = zr.clone(), zi.clone()
        for t in range(radix):
            zr[..., at[t]] = yr[t]
            zi[..., at[t]] = yi[t]
    return zr, zi


def _rounded(xr, xi, spectrum):
    """The magnitudes of (xr, xi) rounded once to float32, and with
    `spectrum` the (re, im) they came from, each rounded once."""
    mag = torch.sqrt(xr * xr + xi * xi + 1e-8).float()
    return (mag, xr.float(), xi.float()) if spectrum else mag


def _real_spectrum(zr, zi, c, s, spectrum=False):
    """X[k] = Ze[k] + W^k Zo[k] from the n2-point transform Z of the packed
    sequence (W^k = (c, s)[k] of a table of 2 n2 entries), the magnitudes
    rounded to float32 (and with `spectrum` re and im)."""
    n2 = zr.shape[-1]
    k = torch.arange(n2 + 1, device=zr.device)
    ar, ai = zr[..., k % n2], zi[..., k % n2]
    br, bi = zr[..., (n2 - k) % n2], -zi[..., (n2 - k) % n2]
    er, ei = 0.5 * (ar + br), 0.5 * (ai + bi)
    o_r, o_i = 0.5 * (ai - bi), -0.5 * (ar - br)
    tr, ti = _cmul(o_r, o_i, c[k], s[k])
    return _rounded(er + tr, ei + ti, spectrum)


def _windowed_frames(x, n_fft, hop):
    return S.frame_signal(x.float().double(), n_fft, hop) * S.hann_window(
        n_fft, x.device, torch.float64)


def stft_magnitude_fft_plain(x, n_fft, hop, spectrum=False):
    """The FFT kernel's one-buffer plan (csrc/stft.cu) restated in PyTorch,
    in float64 with the magnitudes rounded to float32: each windowed frame
    packed (even samples real, odd imaginary) and loaded digit-reversed,
    the DIT passes in place, the post-twiddle (the kernel may fuse a
    multiply and an add where this rounds each): (B, T) float32 -> (B, F,
    n_fft//2 + 1)."""
    if KS.route(n_fft) != "fft":
        raise ValueError(f"the FFT route does not take n_fft {n_fft}")
    tw = KS.twiddles(n_fft, x.device)
    c, s = tw[:, 0], tw[:, 1]
    frames = _windowed_frames(x, n_fft, hop)
    passes = fft_passes(n_fft)
    pos = digit_reversed(passes)
    zr, zi = torch.empty_like(frames[..., 0::2]), torch.empty_like(frames[..., 0::2])
    zr[..., pos], zi[..., pos] = frames[..., 0::2], frames[..., 1::2]
    zr, zi = _passes_in_place(zr, zi, passes, c, s, n_fft, dif=False)
    return _real_spectrum(zr, zi, c, s, spectrum)


def bluestein_tables(n_fft, m=None, passes=None):
    """The chirp-z kernel's tables restated (numpy, float64): the chirp
    table of 2L entries, the M-point twiddle table, and the transform over
    M of the conjugate chirp (conj c_j at j and M - j for j < L), times
    1/M, stored where the DIF passes (by default those of
    `transform_passes(M)`, M by default the smallest 7-smooth >= 2L - 1)
    leave each point."""
    length = n_fft if n_fft % 2 else n_fft // 2
    m = m or smallest_smooth(2 * length - 1)
    passes = passes or transform_passes(m)
    ang = -np.pi * np.arange(2 * length) / length
    chirp = np.stack([np.cos(ang), np.sin(ang)], axis=-1)
    j = np.arange(length, dtype=np.int64)
    cj = chirp[(j * j) % (2 * length)]
    b = np.zeros(m, dtype=np.complex128)
    b[j] = cj[:, 0] - 1j * cj[:, 1]
    b[(m - j[1:]) % m] = cj[1:, 0] - 1j * cj[1:, 1]
    fb = np.fft.fft(b) / m
    ordered = np.empty_like(fb)
    ordered[digit_reversed(passes).numpy()] = fb
    ang = -2.0 * np.pi * np.arange(m) / m
    return chirp, np.stack([np.cos(ang), np.sin(ang)], axis=-1), np.stack(
        [ordered.real, ordered.imag], axis=-1)


def with_p(radices):
    """(radix, p) of each pass of a pass list of radices."""
    out, p = [], 1
    for r in radices:
        out.append((r, p))
        p *= r
    return out


def _chirped(x, n_fft, hop, chirp):
    """The chirp-z kernels' input: two frames as one complex sequence z = a
    + i a' (odd n_fft, L = n_fft; a zero frame after an odd count) or the
    packed frame (even, L = n_fft/2), times the chirp c_j = tw2L[j^2 mod
    2L] (the index reduced in int64); and the frame count."""
    odd = n_fft % 2 == 1
    length = n_fft if odd else n_fft // 2
    frames = _windowed_frames(x, n_fft, hop)
    n_frames = frames.shape[-2]
    if odd:
        frames = torch.cat([frames, torch.zeros_like(frames[..., :n_frames % 2, :])], dim=-2)
        ar, ai = frames[..., 0::2, :], frames[..., 1::2, :]
    else:
        ar, ai = frames[..., 0::2], frames[..., 1::2]
    j = torch.arange(length, dtype=torch.int64)
    cj = chirp[(j * j) % (2 * length)]
    return _cmul(ar, ai, cj[:, 0], cj[:, 1]), n_frames


def _chirp_z_end(zr, zi, n_fft, n_frames, chirp, spectrum):
    """Z[k] = c_k conj(G[k]) for k < L from the DIT passes' output G, then
    the bins (`_chirp_z_bins`)."""
    length = n_fft if n_fft % 2 else n_fft // 2
    j = torch.arange(length, dtype=torch.int64)
    cj = chirp[(j * j) % (2 * length)]
    zr, zi = _cmul(zr[..., :length], -zi[..., :length], cj[:, 0], cj[:, 1])
    return _chirp_z_bins(zr, zi, n_fft, n_frames, chirp, spectrum)


def _chirp_z_bins(zr, zi, n_fft, n_frames, chirp, spectrum):
    """From Z (its first L points): for an odd n_fft the two frames' spectra
    (Z[k] +- conj Z[n-k]) / (2 or 2i), for an even one the real FFT's
    post-twiddle (W^k = tw2L[k])."""
    odd = n_fft % 2 == 1
    if odd:
        k = torch.arange(n_fft // 2 + 1)
        ar, ai = zr[..., k], zi[..., k]
        br, bi = zr[..., (n_fft - k) % n_fft], -zi[..., (n_fft - k) % n_fft]
        first = (0.5 * (ar + br), 0.5 * (ai + bi))
        second = (0.5 * (ai - bi), -0.5 * (ar - br))
        xr = torch.stack([first[0], second[0]], dim=-2).flatten(-3, -2)[..., :n_frames, :]
        xi = torch.stack([first[1], second[1]], dim=-2).flatten(-3, -2)[..., :n_frames, :]
        return _rounded(xr, xi, spectrum)
    return _real_spectrum(zr, zi, chirp[:, 0], chirp[:, 1], spectrum)


def stft_magnitude_bluestein_plain(x, n_fft, hop, spectrum=False, plan=None):
    """The chirp-z kernel's plan (csrc/stft.cu) restated in PyTorch, in
    float64 with the magnitudes rounded to float32: two frames as one
    complex sequence z = a + i a' (odd n_fft, L = n_fft; a zero frame after
    an odd count) or the packed frame (even, L = n_fft/2) times the chirp
    c_j = tw2L[j^2 mod 2L] (the index reduced in int64), zero-padded to M;
    the DIF passes; times the conjugate chirp's transform, conjugated; the
    DIT passes; conjugated back and times c_k: Z; for an odd n_fft the two
    frames' spectra (Z[k] +- conj Z[n-k]) / (2 or 2i), for an even one the
    real FFT's post-twiddle (W^k = tw2L[k]): (B, T) float32 -> (B, F,
    n_fft//2 + 1). `plan`, (M, pass list of M), runs it at another M and
    pass list (the cluster route's, in one buffer)."""
    if plan is None and KS.route(n_fft) != "bluestein":
        raise ValueError(f"the chirp-z route does not take n_fft {n_fft}")
    length = n_fft if n_fft % 2 else n_fft // 2
    m, radices = plan or (None, None)
    chirp, twm, fb = (torch.from_numpy(t) for t in bluestein_tables(
        n_fft, m, radices and with_p(radices)))
    m = twm.shape[0]
    passes = with_p(radices) if radices else transform_passes(m)
    (ar, ai), n_frames = _chirped(x, n_fft, hop, chirp)
    zr = torch.zeros(*ar.shape[:-1], m, dtype=torch.float64)
    zi = torch.zeros_like(zr)
    zr[..., :length], zi[..., :length] = ar, ai
    zr, zi = _passes_in_place(zr, zi, passes, twm[:, 0], twm[:, 1], m, dif=True)
    zr, zi = _cmul(zr, zi, fb[:, 0], fb[:, 1])
    zr, zi = _passes_in_place(zr, -zi, passes, twm[:, 0], twm[:, 1], m, dif=False)
    return _chirp_z_end(zr, zi, n_fft, n_frames, chirp, spectrum)


def _cross_passes(ur, ui, radices, k, share, c, s, m, dif):
    """The passes across a cluster's shares, on the C points k + j S of
    each local offset k (ur[j], ui[j]: vectors over k, j < C, point j in
    share j): a pass of radix R at p = S p' (p' the product of the cross
    radices before it) is, on the j axis of length C, a pass at p' whose
    butterfly (j0 = i mod p') takes the twiddle of global offset k + j0 S,
    step M / (R p). DIT (first to last) twiddles before the R-point DFT, DIF
    (last to first) after it, as `_passes_in_place`."""
    n = len(ur)
    ur, ui = list(ur), list(ui)
    for radix, pj in (reversed(with_p(radices)) if dif else with_p(radices)):
        step = m // (radix * pj * share)
        for i in range(n // radix):
            j0 = i % pj
            at = [(i - j0) * radix + j0 + q * pj for q in range(radix)]
            kg = k + j0 * share
            vr, vi = [ur[a] for a in at], [ui[a] for a in at]
            if not dif:
                for q in range(1, radix):
                    j = q * kg * step
                    vr[q], vi[q] = _cmul(vr[q], vi[q], c[j], s[j])
            yr, yi = _butterfly(radix, vr, vi, c, s, m)
            if dif:
                for q in range(1, radix):
                    j = q * kg * step
                    yr[q], yi[q] = _cmul(yr[q], yi[q], c[j], s[j])
            for q, a in enumerate(at):
                ur[a], ui[a] = yr[q], yi[q]
    return ur, ui


def stft_magnitude_bluestein_cluster_plain(x, n_fft, hop, spectrum=False, plan=None):
    """The chirp-z cluster kernel's plan (csrc/stft.cu) restated in PyTorch,
    in float64 with the magnitudes rounded to float32: the chirped sequence
    zero-padded to M in C contiguous shares of S = M/C points (share j the
    block of rank j); the DIF passes across the shares (the pass list's
    last, whose radices multiply to C), then the passes within a share on
    each share alone (the twiddles of the M-point table, each share's
    butterflies those of its global positions); times the conjugate chirp's
    transform (each share its slice), conjugated; the DIT passes within a
    share, then across; the end as the one-block kernel's. `plan` is an
    (L, M, C, pass list) of `KS.bluestein_cluster_plan`'s form, by default
    the route's."""
    _, m, clusters, radices = plan or KS.bluestein_cluster_plan(n_fft)
    share = m // clusters
    cross = len(transform_passes(clusters))
    local = with_p(radices[:-cross])
    assert int(np.prod(radices[:-cross])) == share and tuple(radices[-cross:]) == tuple(
        r for r, _ in transform_passes(clusters))
    length = n_fft if n_fft % 2 else n_fft // 2
    chirp, twm, fb = (torch.from_numpy(t) for t in bluestein_tables(n_fft, m, with_p(radices)))
    c, s = twm[:, 0], twm[:, 1]
    (ar, ai), n_frames = _chirped(x, n_fft, hop, chirp)
    zr = torch.zeros(*ar.shape[:-1], m, dtype=torch.float64)
    zi = torch.zeros_like(zr)
    zr[..., :length], zi[..., :length] = ar, ai
    zr, zi = zr.unflatten(-1, (clusters, share)), zi.unflatten(-1, (clusters, share))
    k = torch.arange(share)

    def across(zr, zi, dif):
        ur, ui = _cross_passes(zr.unbind(-2), zi.unbind(-2), radices[-cross:], k, share, c, s,
                               m, dif)
        return torch.stack(ur, dim=-2), torch.stack(ui, dim=-2)

    zr, zi = across(zr, zi, dif=True)
    zr, zi = _passes_in_place(zr, zi, local, c, s, m, dif=True)
    fbr, fbi = fb[:, 0].reshape(clusters, share), fb[:, 1].reshape(clusters, share)
    zr, zi = _cmul(zr, zi, fbr, fbi)
    zr, zi = _passes_in_place(zr, -zi, local, c, s, m, dif=False)
    zr, zi = across(zr, zi, dif=False)
    return _chirp_z_end(zr.flatten(-2), zi.flatten(-2), n_fft, n_frames, chirp, spectrum)


def _tile_passes(zr, zi, radices, share, c, s, m, dif):
    """The two-level route's passes across the shares (csrc/stft.cu
    `tile_pass`), on all local offsets at once: zr, zi (..., C, S), point g
    = j S + k at [j, k]. A pass of radix R at p = S q (q the product of the
    cross radices before it) is on the j axis a pass at q whose butterfly i
    (j0 = i mod q) owns the rows (i - j0) R + j0 + m q and twiddles offset k
    by the table's entry m (k + j0 S) C / (R q). DIT (first to last)
    twiddles before the R-point DFT, DIF (last to first) after it."""
    clusters = zr.shape[-2]
    k = torch.arange(share)
    for radix, q in (reversed(with_p(radices)) if dif else with_p(radices)):
        step = clusters // (radix * q)
        i = torch.arange(clusters // radix)
        j0 = i % q
        at = [(i - j0) * radix + j0 + r * q for r in range(radix)]
        kg = k[None, :] + (j0 * share)[:, None]
        ur = [zr[..., a, :] for a in at]
        ui = [zi[..., a, :] for a in at]
        if not dif:
            for r in range(1, radix):
                ur[r], ui[r] = _cmul(ur[r], ui[r], c[r * kg * step], s[r * kg * step])
        yr, yi = _butterfly(radix, ur, ui, c, s, m)
        if dif:
            for r in range(1, radix):
                yr[r], yi[r] = _cmul(yr[r], yi[r], c[r * kg * step], s[r * kg * step])
        zr, zi = zr.clone(), zi.clone()
        for r in range(radix):
            zr[..., at[r], :] = yr[r]
            zi[..., at[r], :] = yi[r]
    return zr, zi


def stft_magnitude_bluestein_global_plain(x, n_fft, hop, spectrum=False, plan=None):
    """The two-level route's four kernels (csrc/stft.cu) restated in
    PyTorch, in float64 with the magnitudes rounded to float32: the chirped
    sequence zero-padded to M in one array per transform (point g at g, C
    shares of S = M/C points, share-major); the DIF passes across the shares
    (`_tile_passes`); the passes within each share (the twiddles of the
    M-point table), times the conjugate chirp's transform, conjugated, the
    DIT passes within each share; the DIT passes across; Z[g] = c_g
    conj(G[g]) for g < L; the bins. `plan` is an (L, M, C, pass list) of
    `KS.bluestein_global_plan`'s form, by default the route's: the pass
    list that of S, whose prefix multiplies to S, then that of C."""
    _, m, clusters, radices = plan or KS.bluestein_global_plan(n_fft)
    share = m // clusters
    split = next(i for i in range(len(radices) + 1) if int(np.prod(radices[:i])) == share)
    local, cross = with_p(radices[:split]), radices[split:]
    assert int(np.prod(cross)) == clusters
    length = n_fft if n_fft % 2 else n_fft // 2
    chirp, twm, fb = (torch.from_numpy(t) for t in bluestein_tables(n_fft, m, with_p(radices)))
    c, s = twm[:, 0], twm[:, 1]
    (ar, ai), n_frames = _chirped(x, n_fft, hop, chirp)
    zr = torch.zeros(*ar.shape[:-1], m, dtype=torch.float64)
    zi = torch.zeros_like(zr)
    zr[..., :length], zi[..., :length] = ar, ai
    zr, zi = zr.unflatten(-1, (clusters, share)), zi.unflatten(-1, (clusters, share))
    zr, zi = _tile_passes(zr, zi, cross, share, c, s, m, dif=True)
    zr, zi = _passes_in_place(zr, zi, local, c, s, m, dif=True)
    zr, zi = _cmul(zr, zi, fb[:, 0].reshape(clusters, share), fb[:, 1].reshape(clusters, share))
    zr, zi = _passes_in_place(zr, -zi, local, c, s, m, dif=False)
    zr, zi = _tile_passes(zr, zi, cross, share, c, s, m, dif=False)
    g = torch.arange(length, dtype=torch.int64)
    cg = chirp[(g * g) % (2 * length)]
    zr, zi = zr.flatten(-2)[..., :length], zi.flatten(-2)[..., :length]
    zr, zi = _cmul(zr, -zi, cg[:, 0], cg[:, 1])
    return _chirp_z_bins(zr, zi, n_fft, n_frames, chirp, spectrum)


def stft_magnitude_stockham_plain(x, n_fft, hop):
    """The two-buffer Stockham plan the FFT kernel ran before the one-buffer
    plan, restated in float64 with the magnitudes rounded to float32: the
    packed frame in natural order, pass R at p reading u_m = z[i + m n2/R]
    and writing the R-point DFT to (i - k) R + k + t p, then the
    post-twiddle: (B, T) float32 -> (B, F, n_fft//2 + 1)."""
    if KS.route(n_fft) != "fft":
        raise ValueError(f"the FFT route does not take n_fft {n_fft}")
    n2 = n_fft // 2
    tw = KS.twiddles(n_fft, x.device)
    c, s = tw[:, 0], tw[:, 1]
    frames = _windowed_frames(x, n_fft, hop)
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
    return _real_spectrum(zr, zi, c, s)


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
    for n in (16, 32, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384):
        assert KS.route(n) == "fft"
    for n in (2, 4, 8, 17, 3):
        assert KS.route(n) == "bluestein"
    for n in (400, 1000, 8192):  # 2^3 5^2, 2^3 5^3, 2^13
        assert KS.route(n) == "fft"
    # 11520 = 2 x 2^7 3^2 5; 12000 = 2 x 2^4 3 5^3 and 28812 = 2 x 2 3 7^4 (the
    # largest the one-buffer plan admits), beyond the two-buffer plan's 11,622
    for n in MIXED + [11520, 12000, 28812]:
        assert KS.route(n) == "fft", n
    # 11522 = 2 x 7 x 823, 2018 = 2 x 1009: non-smooth halves within the
    # chirp-z limit, as 7203 (odd) and 14404 = 2 x 2 x 3601 at its edge
    for n in BLUESTEIN + [11522, 7203, 14404]:
        assert KS.route(n) == "bluestein", n
    # 29058 = 2 x 3 x 29 x 167, 32768 and 60000 = 2 x 2^4 3 5^4: even, beyond
    # the FFT's one-buffer limit; 20001 odd
    for n in CLUSTER + [KS.FFT_MAX + 2, 32768, 60000, 20001] + [n for n, _ in CLUSTER_SHAPES]:
        assert KS.route(n) == "bluestein_cluster", n
    for n in GLOBAL:
        assert KS.route(n) == "bluestein_global", n
    # every n_fft >= 2 takes one of the four routes (every 6007th to 2^21,
    # and the powers of two)
    sample = [*range(2, 1 << 21, 6007), *(1 << e for e in range(1, 21))]
    assert {KS.route(n) for n in sample} == set(KS.COUNTERS)
    assert KS.FFT_MAX == 29056  # 8 bytes a point at one frame
    for n in (1, 0, -4):
        with pytest.raises(ValueError):
            KS.route(n)
    with pytest.raises(ValueError):
        stft_magnitude_fft_plain(torch.zeros(1, 999), 441, 110)
    with pytest.raises(ValueError):
        stft_magnitude_bluestein_plain(torch.zeros(1, 999), 400, 100)


def test_wrapper_pass_list_is_the_restated_plan():
    """The pass list the wrapper gives the FFT kernel (`KS.fft_passes`) is
    the restated plan at every n_fft the route takes (even, 16 to 29,056, a
    half with no prime factor above 7), and empty at every other; the
    chirp-z plan (`KS.bluestein_plan`) is (L, M, the restated passes of M)
    at every other n_fft from 2 whose M is within BLUESTEIN_MAX_M, and None
    at the rest (every 7th n_fft, to keep the scan short)."""
    for n in range(-2, KS.FFT_MAX + 40):
        left = abs(n) // 2
        for r in (2, 3, 5, 7):
            while left and left % r == 0:
                left //= r
        taken = n % 2 == 0 and 16 <= n <= 29056 and left == 1
        want = tuple(r for r, _ in fft_passes(n)) if taken else ()
        assert KS.fft_passes(n) == want, n
        if n % 7 or n < 2:
            continue
        length = n if n % 2 else n // 2
        m = smallest_smooth(2 * length - 1)
        want = (None if taken or m > 14528
                else (length, m, tuple(r for r, _ in transform_passes(m))))
        assert KS.bluestein_plan(n) == want, n


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


@pytest.mark.parametrize("n_fft", [n for n in MIXED if n <= 1568] + [12000])
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


@pytest.mark.parametrize("n_fft", POWERS + MIXED)
def test_one_buffer_plan_is_the_stockham_plan(n_fft):
    """The one-buffer plan (digit-reversed load, passes in place) computes
    the two-buffer Stockham plan's float64 values bit for bit: the same
    butterflies and twiddles in the same order per point, in other slots."""
    hop = n_fft // 4
    x = torch.from_numpy(_x(1, 2 * n_fft + 37, seed=n_fft + 2))
    assert torch.equal(stft_magnitude_fft_plain(x, n_fft, hop),
                       stft_magnitude_stockham_plain(x, n_fft, hop))


@pytest.mark.parametrize("n_fft", BLUESTEIN)
def test_bluestein_plan_against_float64_rfft(n_fft):
    """The chirp-z plan gives the float64 spectrum's magnitudes, rounded
    once: within 2 float32 ulps each, for odd n_fft (the real frame as a
    complex sequence) and even ones (the packed half and the post-twiddle)."""
    hop = max(1, n_fft // 4)
    t = 2 * n_fft + 37 if n_fft > 3 else 60
    x = _x(2, t, seed=n_fft)
    got = stft_magnitude_bluestein_plain(torch.from_numpy(x), n_fft, hop).numpy()
    ref = rfft_magnitude_f64(x, n_fft, hop)
    assert got.shape == ref.shape
    ulp = np.spacing(ref.astype(np.float32)).astype(np.float64)
    assert (np.abs(got - ref) / ulp).max() <= 2.0


@pytest.mark.parametrize("n_fft,hop", [(3, 1), (17, 5), (441, 110), (2018, 504)])
def test_bluestein_plan_matches_plain_and_pallas(n_fft, hop):
    t = 2 * n_fft + 37 if n_fft > 3 else 60
    x = _x(1, t, seed=n_fft + 1)
    got = stft_magnitude_bluestein_plain(torch.from_numpy(x), n_fft, hop).numpy()
    plain = KS.stft_magnitude_plain(torch.from_numpy(x), n_fft, hop).numpy()
    pallas = np.asarray(JPS.stft_magnitude_pallas(jnp.asarray(x), n_fft, hop, interpret=True))
    assert got.shape == plain.shape == pallas.shape
    for ref in (plain, pallas):
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("n_fft", [2, 3, 17, 441, 2018, 7203, 14404])
def test_bluestein_tables_are_the_restated_tables(n_fft):
    """The wrapper's float64 tables (`KS.bluestein_tables`) are the restated
    ones: the chirp table of 2L entries, the M-point table, and the
    conjugate chirp's transform times 1/M in the DIF passes' output order
    (equal up to the float64 rounding of the two angle expressions)."""
    want = bluestein_tables(n_fft)
    got = [t.numpy() for t in KS.bluestein_tables(n_fft)]
    length, m, _ = KS.bluestein_plan(n_fft)
    assert [g.shape for g in got] == [(2 * length, 2), (m, 2), (m, 2)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-15)
    # the table read at j^2 mod 2L is the chirp exp(-i pi j^2 / L)
    j = np.arange(length, dtype=np.int64)
    c = got[0][(j * j) % (2 * length)]
    np.testing.assert_allclose(c[:, 0] + 1j * c[:, 1], np.exp(-1j * np.pi * (j * j) / length),
                               rtol=0, atol=1e-11)


def test_bluestein_length_is_the_smallest_smooth():
    """M is the smallest 7-smooth number >= 2L - 1 (the first of them by a
    scan), so the M-point transforms run on the FFT's passes: 441 -> L 441,
    M 882; 2018 -> L 1009, M 2025; 2 -> L 1, M 1 (the empty pass list)."""
    assert KS.bluestein_plan(441) == (441, 882, (2, 3, 3, 7, 7))
    assert KS.bluestein_plan(2018) == (1009, 2025, (3, 3, 3, 3, 5, 5))
    assert KS.bluestein_plan(2) == (1, 1, ())
    for n in range(1, 3000):
        m = KS.smooth_at_least(n)
        assert m >= n and KS.transform_passes(m) or m == 1
        assert all(not KS.transform_passes(v) for v in range(max(n, 2), m)), n


def test_route_boundaries():
    """FFT_MAX is the largest n_fft whose one-frame plan (8 n_fft bytes)
    fits a block; BLUESTEIN_MAX_M the largest M whose (16 M bytes) does.
    The largest n_fft each route takes: 28812 (FFT), 7203 (odd) and 14404
    (even) on the chirp-z route, M 14406 = 2 x 3 x 7^4 the largest 7-smooth
    number within its limit; one past them the next route takes over."""
    assert 8 * KS.FFT_MAX <= KS.MAX_SMEM < 8 * (KS.FFT_MAX + 1)
    assert 16 * KS.BLUESTEIN_MAX_M <= KS.MAX_SMEM < 16 * (KS.BLUESTEIN_MAX_M + 1)
    assert KS.BLUESTEIN_MAX_M == 14528
    assert max(n for n in range(28000, KS.FFT_MAX + 1, 2) if KS.fft_passes(n)) == 28812
    assert KS.smooth_at_least(14407) > KS.BLUESTEIN_MAX_M >= KS.smooth_at_least(14406) == 14406
    assert KS.route(7203) == KS.route(14404) == "bluestein"
    assert KS.route(7205) == KS.route(14408) == "bluestein_cluster"
    assert KS.route(28812) == "fft" and KS.route(28814) == "bluestein_cluster"
    # the cluster route's edges: M 115,200 = 2^9 3^2 5^2 (C 8, shares of
    # 14,400 points) the largest 7-smooth multiple of 64 within 8 blocks;
    # no 7-smooth multiple of 64 lies in (115,200, 116,224]
    assert 16 * (8 * KS.BLUESTEIN_MAX_M) <= 8 * KS.MAX_SMEM
    assert KS.bluestein_cluster_plan(57599)[1:3] == KS.bluestein_cluster_plan(115200)[1:3] == (
        115200, 8)
    assert not [m for m in range(115200 + 64, 8 * KS.BLUESTEIN_MAX_M + 1, 64)
                if KS.transform_passes(m)]
    assert KS.route(57599) == KS.route(115200) == "bluestein_cluster"
    assert KS.route(57601) == KS.route(115202) == "bluestein_global"
    # the two-level route's reach, M up to 2^20: the largest odd n_fft
    # (524,287: 2L - 1 = 2^20 - 3) and even one (2^20: L 2^19) have plans,
    # the next ones none, and the wrapper refuses them
    assert KS.bluestein_global_plan(524287)[1] == KS.bluestein_global_plan(1 << 20)[1] == 1 << 20
    assert KS.bluestein_global_plan(524289) is KS.bluestein_global_plan((1 << 20) + 2) is None
    for n in (524289, (1 << 20) + 2):
        assert KS.route(n) == "bluestein_global"
        with pytest.raises(ValueError, match="reach"):
            KS._check(torch.zeros(1, n), n, n // 4)
    assert KS.digit_reversed(KS.transform_passes(24)).tolist() == digit_reversed(
        transform_passes(24)).tolist()
    for n in (1, 5, 64, 882, 2025, 6000):
        pos = KS.digit_reversed(KS.transform_passes(n))
        assert sorted(pos.tolist()) == list(range(n)), n
        assert pos.tolist() == digit_reversed(transform_passes(n)).tolist(), n


def cluster_plan_search(n_fft):
    """The cluster plan by its rules, searched independently: for C = 2, 4,
    8 in turn, M the first multiple of 8 C from 2L - 1 up with no prime
    factor above 7; the first C whose share of M/C points (16 bytes each)
    fits 232,448 bytes; the pass list that of M/C (radix 4 first, then 2,
    3, 5, 7), then 2 (C 2), 4 (C 4) or 4, 2 (C 8)."""
    length = n_fft if n_fft % 2 else n_fft // 2
    for c, tail in ((2, (2,)), (4, (4,)), (8, (4, 2))):
        m = smallest_smooth(2 * length - 1)
        while m % (8 * c):
            m = smallest_smooth(m + 1)
        if 16 * (m // c) <= 232448:
            return length, m, c, tuple(r for r, _ in transform_passes(m // c)) + tail
    return None


def test_cluster_plan_is_the_searched_plan():
    """`KS.bluestein_cluster_plan` is the searched plan at every n_fft the
    one-block routes do not take (every 97th n_fft from 7,205 to 131,072,
    and the edges); each share a multiple of 8 points within a block's
    shared memory, the pass list a transform of M. With C asked for, the
    same search at that C alone (the card's check at one-block shapes)."""
    for n in list(range(7205, 131073, 97)) + [57599, 57601, 115200, 115202]:
        if KS.fft_passes(n) or KS.bluestein_plan(n):
            assert KS.bluestein_cluster_plan(n) is None, n
            continue
        want = cluster_plan_search(n)
        assert KS.bluestein_cluster_plan(n) == want, n
        assert KS.route(n) == ("bluestein_cluster" if want else "bluestein_global"), n
        if want:
            _, m, c, radices = want
            assert int(np.prod(radices)) == m and (m // c) % 8 == 0
            assert 16 * (m // c) <= KS.MAX_SMEM
    assert KS.bluestein_cluster_plan(441, 2) == (441, 896, 2, (4, 4, 4, 7, 2))
    assert KS.bluestein_cluster_plan(441, 8) == (441, 896, 8, (4, 4, 7, 4, 2))
    assert KS.bluestein_cluster_plan(2018, 4) == (1009, 2048, 4, (4, 4, 4, 4, 2, 4))
    assert KS.chirp_plan(441) == (441, 882, 1, (2, 3, 3, 7, 7))
    with pytest.raises(ValueError):
        KS.bluestein_cluster_plan(441, 3)


@pytest.mark.parametrize("n_fft,hop", CLUSTER_SHAPES)
def test_cluster_plan_is_the_one_buffer_plan(n_fft, hop):
    """The cluster plan (shares, passes within and across them) computes the
    one-buffer chirp-z plan's float64 values at the same M and pass list
    bit for bit, the spectrum too: the same butterflies and twiddles in the
    same order per point, in other blocks."""
    x = torch.from_numpy(_x(1, 2 * n_fft + 37, seed=n_fft + 3))
    plan = KS.bluestein_cluster_plan(n_fft)
    got = stft_magnitude_bluestein_cluster_plain(x, n_fft, hop, spectrum=True, plan=plan)
    want = stft_magnitude_bluestein_plain(x, n_fft, hop, spectrum=True, plan=(plan[1], plan[3]))
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("n_fft,clusters", [(441, 2), (441, 4), (441, 8), (2018, 2), (2018, 4),
                                            (2018, 8), (17, 8)])
def test_cluster_plan_at_one_block_shapes(n_fft, clusters):
    """At a shape the one-block kernel runs, the cluster plan of C blocks
    asked for (`clusters`) is the one-buffer plan at its M and pass list,
    bit for bit (what chip_smoke.py holds the two kernels to on the card),
    and within 2 float32 ulps of float64."""
    x = torch.from_numpy(_x(2, 3 * n_fft + 37, seed=n_fft + clusters))
    hop = max(1, n_fft // 4)
    plan = KS.bluestein_cluster_plan(n_fft, clusters)
    got = stft_magnitude_bluestein_cluster_plain(x, n_fft, hop, plan=plan)
    assert torch.equal(got, stft_magnitude_bluestein_plain(x, n_fft, hop, plan=(plan[1], plan[3])))
    ref = rfft_magnitude_f64(x.numpy(), n_fft, hop)
    ulp = np.spacing(ref.astype(np.float32)).astype(np.float64)
    assert (np.abs(got.numpy() - ref) / ulp).max() <= 2.0


@pytest.mark.parametrize("n_fft,hop", CLUSTER_SHAPES)
def test_cluster_plan_against_float64_rfft(n_fft, hop):
    """The cluster plan gives the float64 spectrum's magnitudes, rounded
    once: within 2 float32 ulps each, at C 2, 4 and 8, odd and even n_fft.
    (The plain version's bases at these n_fft take gigabytes on the host:
    the card holds the kernel to it, chip_smoke.py's K4_CLUSTER_SHAPES.)"""
    x = _x(2, 2 * n_fft + 37, seed=n_fft)
    got = stft_magnitude_bluestein_cluster_plain(torch.from_numpy(x), n_fft, hop).numpy()
    ref = rfft_magnitude_f64(x, n_fft, hop)
    assert got.shape == ref.shape
    ulp = np.spacing(ref.astype(np.float32)).astype(np.float64)
    assert (np.abs(got - ref) / ulp).max() <= 2.0


@pytest.mark.parametrize("n_fft", [7205, 8191, 11025, 30000, 31999])
def test_cluster_tables_are_the_restated_tables(n_fft):
    """The wrapper's float64 tables at the cluster plan (`KS.bluestein_tables`
    of the route's plan) are the restated ones at its M and pass list."""
    length, m, _, radices = KS.chirp_plan(n_fft)
    want = bluestein_tables(n_fft, m, with_p(radices))
    got = [t.numpy() for t in KS.bluestein_tables(n_fft)]
    assert [g.shape for g in got] == [(2 * length, 2), (m, 2), (m, 2)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-15)


def _slice_losses_against_jax(monkeypatch, fft_sizes, mel_n_fft):
    """Both spectral losses on the bank `fft_sizes` (hop n/4) and the mel
    loss at `mel_n_fft`, with the port's autograd function fed by the
    restated plans in place of the launches (the forward's spectrum kept,
    the backward `stft_magnitude_backward` on it, as on the card), against
    the JAX package's losses (XLA matmul-DFT) on a (1, 12800) pair. Values:
    rtol 1e-4; the mel gradient rtol 1e-4, atol 1e-6; the multi-resolution
    gradient's relative L2 distance to the float64 one (the port's plain
    path on float64 input) at most 1e-5 and no farther than the JAX
    package's float32 gradient. Returns the route of each n_fft."""
    plans = {"fft": stft_magnitude_fft_plain, "bluestein": stft_magnitude_bluestein_plain,
             "bluestein_cluster": stft_magnitude_bluestein_cluster_plain}
    routes = {}

    def launch(x, n_fft, hop, spectrum=False):
        routes[n_fft] = KS.route(n_fft)
        return plans[routes[n_fft]](x, n_fft, hop, spectrum)

    monkeypatch.setattr(KS, "launch", launch)

    def restated(x, n_fft, hop):
        return KS._STFTMagnitude.apply(x, n_fft, hop)

    rng = np.random.RandomState(17)
    target = (rng.randn(1, 12800) * 0.3).astype(np.float32)
    pred = (target + rng.randn(1, 12800) * 0.05).astype(np.float32)
    bank = SP.MultiResSTFTConfig(fft_sizes=fft_sizes)
    mel_kw = dict(sample_rate=16000, n_fft=mel_n_fft, hop=mel_n_fft // 4, n_mels=80)

    def port(fn, st, dtype=torch.float32):
        p = torch.from_numpy(pred).to(dtype).requires_grad_(True)
        loss = fn(p, torch.from_numpy(target).to(dtype), st)
        loss.backward()
        return loss.item(), p.grad.double().numpy()

    # the multi-resolution loss
    rv, rg = jax.value_and_grad(lambda p: JSP.multi_res_stft_loss(
        p, jnp.asarray(target), JSP.MultiResSTFTConfig(fft_sizes=bank.fft_sizes)))(
            jnp.asarray(pred))
    loss_fn = lambda p, t, st: SP.multi_res_stft_loss(p, t, bank, stft=st)  # noqa: E731
    value, grad = port(loss_fn, restated)
    _, g64 = port(loss_fn, KS.stft_magnitude_plain, torch.float64)
    np.testing.assert_allclose(value, float(rv), rtol=1e-4)
    dist = np.linalg.norm(grad - g64) / np.linalg.norm(g64)
    dist_jax = np.linalg.norm(np.asarray(rg, np.float64) - g64) / np.linalg.norm(g64)
    assert dist <= 1e-5 and dist <= dist_jax, (dist, dist_jax)
    # the mel loss
    rv, rg = jax.value_and_grad(lambda p: JSP.mel_loss(p, jnp.asarray(target), **mel_kw))(
        jnp.asarray(pred))
    value, grad = port(lambda p, t, st: SP.mel_loss(p, t, **mel_kw, stft=st), restated)
    np.testing.assert_allclose(value, float(rv), rtol=1e-4)
    np.testing.assert_allclose(grad, np.asarray(rg), rtol=1e-4, atol=1e-6)
    return routes


def test_slice_losses_through_the_restated_kernels_match_jax(monkeypatch):
    """The slice as a whole: both spectral losses on a bank whose every
    resolution takes a route of this kernel's redesign (12000 on the
    one-buffer FFT, 2018 and 441 on the chirp-z transform; the mel loss at
    441), through the restated plans, against the JAX package's losses
    (`_slice_losses_against_jax`; the JAX package's float32 gradient reads
    5.2e-2 from the float64 one on this pair, its log-magnitude term
    amplifying the float32 DFT's rounding at the 12000 frame's small
    bins)."""
    routes = _slice_losses_against_jax(monkeypatch, (12000, 2018, 441), 441)
    assert routes == {12000: "fft", 2018: "bluestein", 441: "bluestein"}


def test_cluster_bank_losses_through_the_restated_kernels_match_jax(monkeypatch):
    """The cluster route in the slice: both spectral losses on the bank of
    chip_smoke.py's k4_cluster phase (11025 and 8191 on the chirp-z cluster
    route, 1024 on the FFT; the mel loss at 1024), through the restated
    plans, against the JAX package's losses (`_slice_losses_against_jax`)."""
    routes = _slice_losses_against_jax(monkeypatch, (11025, 8191, 1024), 1024)
    assert routes == {11025: "bluestein_cluster", 8191: "bluestein_cluster", 1024: "fft"}


def global_plan_search(n_fft):
    """The two-level plan by its rules, searched independently: M the first
    multiple of 8 from 2L - 1 up with no prime factor above 7 (None above
    2^20); S the largest of M's divisors that 8 divides, at most 4096,
    found by trying them all from 4096 down; C = M / S; the pass list that
    of S then that of C (radix 4 first, then 2, 3, 5, 7)."""
    length = n_fft if n_fft % 2 else n_fft // 2
    m = smallest_smooth(2 * length - 1)
    while m % 8:
        m = smallest_smooth(m + 1)
    if m > 1 << 20:
        return None
    share = next(d for d in range(4096, 7, -1) if d % 8 == 0 and m % d == 0)
    return length, m, m // share, tuple(r for r, _ in transform_passes(share)) + tuple(
        r for r, _ in transform_passes(m // share))


def test_global_plan_is_the_searched_plan():
    """`KS.bluestein_global_plan` is the searched plan at every n_fft no
    8-block cluster holds (every 97th n_fft from 57,601 to 300,000, and the
    edges of the route and of its reach), None at every other; each share a
    multiple of 8 points within GLOBAL_SHARE_MAX, C within GLOBAL_MAX_C, a
    tile of GLOBAL_TILE_MIN offsets of C points within a block, at most 16
    passes. With C asked for, the cluster plan's M at that C (equal to the
    cluster plan at C 2, 4 and 8)."""
    for n in list(range(57601, 300001, 97)) + [57599, 57601, 115200, 115202, 524287, 524288,
                                                524289, 1 << 20, (1 << 20) + 2]:
        plan = KS.bluestein_global_plan(n)
        if KS.bluestein_cluster_plan(n):
            assert plan is None, n
            continue
        assert plan == global_plan_search(n), n
        if plan:
            _, m, c, radices = plan
            share = m // c
            assert int(np.prod(radices)) == m and share % 8 == 0 and share <= KS.GLOBAL_SHARE_MAX
            assert 2 <= c <= KS.GLOBAL_MAX_C and len(radices) <= 16
            assert 16 * KS.global_tile(c) * c <= KS.MAX_SMEM
    for n, c in ((441, 2), (441, 8), (2018, 4), (8191, 2), (30000, 4), (31999, 8)):
        assert KS.bluestein_global_plan(n, c) == KS.bluestein_cluster_plan(n, c), (n, c)
    assert KS.bluestein_global_plan(441, 16) == (441, 896, 16, (4, 2, 7, 4, 4))
    assert KS.bluestein_global_plan(60001) == (60001, 120960, 30, (4, 4, 4, 3, 3, 7, 2, 3, 5))
    assert KS.bluestein_global_plan(262145)[1:3] == (524880, 135)
    for bad in (1, 11, -2):
        with pytest.raises(ValueError):
            KS.bluestein_global_plan(441, bad)
    assert KS.bluestein_global_plan(441, 2048) is None  # a tile of 8 x 2048 points is over a block


def test_global_chirp_index_in_64_bits():
    """The chirp index j^2 mod 2L at L = 262,145 (n_fft 262145) as the
    two-level kernels take it (64-bit integers), against exact integers: j^2
    passes 2^32 from j = 65,536, where a 32-bit index would wrap; the table
    read there is exp(-i pi j^2 / L)."""
    length = 262145
    j = np.arange(length, dtype=np.uint64)
    idx = (j * j) % np.uint64(2 * length)
    exact = [(int(v) * int(v)) % (2 * length) for v in range(0, length, 1009)]
    assert idx[::1009].tolist() == exact
    assert idx[-1] == ((length - 1) ** 2) % (2 * length)
    wrapped = (j.astype(np.uint32) * j.astype(np.uint32)) % np.uint32(2 * length)
    assert (wrapped[65536:] != idx[65536:]).any() and (wrapped[:65536] == idx[:65536]).all()
    chirp = KS.twiddles(2 * length).numpy()
    sample = np.arange(0, length, 4099)
    got = chirp[idx[sample].astype(np.int64)]
    ang = np.array([float((int(v) * int(v)) % (2 * length)) for v in sample]) * np.pi / length
    np.testing.assert_allclose(got[:, 0] + 1j * got[:, 1], np.exp(-1j * ang), rtol=0, atol=1e-15)


@pytest.mark.parametrize("n_fft,clusters", [(441, 2), (441, 4), (441, 8), (441, 16), (2018, 2),
                                            (2018, 4), (2018, 8), (2018, 16), (17, 16),
                                            (2018, 64)])
def test_global_plan_is_the_one_buffer_plan(n_fft, clusters):
    """The two-level plan at C asked for computes the one-buffer chirp-z
    plan's float64 values at its M and pass list bit for bit, the spectrum
    too (what chip_smoke.py holds the two-level kernels to beside the
    one-block kernel on the card), and within 2 float32 ulps of float64."""
    x = torch.from_numpy(_x(2, 3 * n_fft + 37, seed=n_fft + clusters))
    hop = max(1, n_fft // 4)
    plan = KS.bluestein_global_plan(n_fft, clusters)
    got = stft_magnitude_bluestein_global_plain(x, n_fft, hop, spectrum=True, plan=plan)
    want = stft_magnitude_bluestein_plain(x, n_fft, hop, spectrum=True, plan=(plan[1], plan[3]))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    ref = rfft_magnitude_f64(x.numpy(), n_fft, hop)
    ulp = np.spacing(ref.astype(np.float32)).astype(np.float64)
    assert (np.abs(got[0].numpy() - ref) / ulp).max() <= 2.0


@pytest.mark.parametrize("n_fft,hop,clusters", [(n, h, 0) for n, h in CLUSTER_SHAPES]
                         + [(441, 110, 16), (2018, 504, 64), (8191, 2048, 16)])
def test_global_plan_is_the_cluster_plan(n_fft, hop, clusters):
    """The two-level plan (the passes across the shares on tiles of
    offsets, `_tile_passes`) computes the cluster plan's float64 values
    bit for bit, the spectrum too (the cross passes per offset,
    `_cross_passes`): at the cluster route's own plans (C 2, 2, 4, 8: what
    chip_smoke.py holds the two-level kernels to beside the cluster kernel
    on the card), and at C 16 and 64, which only the two-level kernels
    run."""
    x = torch.from_numpy(_x(1, 2 * n_fft + 37, seed=n_fft + 5))
    plan = (KS.bluestein_global_plan(n_fft, clusters) if clusters
            else KS.bluestein_global_plan(n_fft, KS.bluestein_cluster_plan(n_fft)[2]))
    assert clusters or plan == KS.bluestein_cluster_plan(n_fft)
    got = stft_magnitude_bluestein_global_plain(x, n_fft, hop, spectrum=True, plan=plan)
    want = stft_magnitude_bluestein_cluster_plain(x, n_fft, hop, spectrum=True, plan=plan)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("n_fft,hop", GLOBAL_SHAPES)
def test_global_plan_against_float64_rfft(n_fft, hop):
    """The two-level route's plan gives the float64 spectrum's magnitudes,
    rounded once: within 2 float32 ulps each, at its route's plans (odd
    and even n_fft, C 30, 42, 32 and 135), B 1 and 3-5 frames. (The plain
    version's bases at these n_fft take 14-275 GB on the host: the card
    holds the kernels to it at 60001, chip_smoke.py's K4_GLOBAL_SHAPES.)"""
    x = _x(1, n_fft + 37, seed=n_fft)
    got = stft_magnitude_bluestein_global_plain(torch.from_numpy(x), n_fft, hop).numpy()
    ref = rfft_magnitude_f64(x, n_fft, hop)
    assert got.shape == ref.shape and got.shape[1] >= 3
    ulp = np.spacing(ref.astype(np.float32)).astype(np.float64)
    assert (np.abs(got - ref) / ulp).max() <= 2.0


@pytest.mark.parametrize("n_fft", [60001, 115202, 131072])
def test_global_tables_are_the_restated_tables(n_fft):
    """The wrapper's float64 tables at the two-level plan
    (`KS.bluestein_tables` of the route's plan: the conjugate chirp's
    transform where the DIF passes of its pass list, across the shares
    first, leave each point) are the restated ones at its M and pass list."""
    length, m, _, radices = KS.chirp_plan(n_fft)
    assert (length, m, _, radices) == KS.bluestein_global_plan(n_fft)
    want = bluestein_tables(n_fft, m, with_p(radices))
    got = [t.numpy() for t in KS.bluestein_tables(n_fft)]
    assert [g.shape for g in got] == [(2 * length, 2), (m, 2), (m, 2)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-15)


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
