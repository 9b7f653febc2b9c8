"""The plan of the FFT route of the port's |STFT| kernel (K4), restated in
PyTorch (`stft_magnitude_fft_plain` below), on the CPU: against the
plain matmul-DFT version and the JAX package's Pallas kernel in interpret
mode; its twiddle table against the DFT basis; the routing rule; and the
spectrum backward against autograd of the plain version.

Tolerances:
  * the FFT plan (float64, rounded once) vs the plain version and
    `stft_magnitude_pallas(interpret=True)`: rtol 1e-4, atol 1e-4 *
    max|ref|, the JAX package's own kernel-test tolerance (the float32 DFT
    sums' error).
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

POWERS = [16, 128, 256, 512, 1024, 2048, 4096]


def fft_passes(n_fft):
    """(radix, p) of each Stockham pass over the n_fft/2 complex points: p is
    the length of the sub-transforms a pass combines R at a time."""
    n2, p, out = n_fft // 2, 1, []
    while 4 * p <= n2:
        out.append((4, p))
        p *= 4
    if p < n2:
        out.append((2, p))
    return out


def _cmul(ar, ai, br, bi):
    return ar * br - ai * bi, ar * bi + ai * br


def stft_magnitude_fft_plain(x, n_fft, hop):
    """The FFT kernel's plan (csrc/stft.cu) restated in PyTorch, in float64
    with the magnitudes rounded to float32 (the same packing, passes,
    twiddle table and post-twiddle; the kernel may fuse a multiply and an
    add where this rounds each): (B, T) float32 -> (B, F, n_fft//2 + 1)."""
    if KS.route(n_fft) != "fft":
        raise ValueError(f"the FFT takes powers of two {KS.FFT_MIN}-{KS.FFT_MAX}, got {n_fft}")
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
        if radix == 4:
            a0r, a0i = ur[0] + ur[2], ui[0] + ui[2]
            a1r, a1i = ur[0] - ur[2], ui[0] - ui[2]
            a2r, a2i = ur[1] + ur[3], ui[1] + ui[3]
            a3r, a3i = ur[1] - ur[3], ui[1] - ui[3]
            yr = [a0r + a2r, a1r + a3i, a0r - a2r, a1r - a3i]
            yi = [a0i + a2i, a1i - a3r, a0i - a2i, a1i + a3r]
        else:
            yr = [ur[0] + ur[1], ur[0] - ur[1]]
            yi = [ui[0] + ui[1], ui[0] - ui[1]]
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
    for n in (2, 4, 8, 400, 1000, 17, 8192, 3):
        assert KS.route(n) == "dft"
    for n in (1, 0, -4):
        with pytest.raises(ValueError):
            KS.route(n)
    with pytest.raises(ValueError):
        stft_magnitude_fft_plain(torch.zeros(1, 999), 400, 100)


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
