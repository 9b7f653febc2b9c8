"""The port's STFT ops and the plain version of its STFT-magnitude kernel
against the JAX package, on the same numpy inputs.

Tolerances:
  * window, DFT basis and mel filterbank: bit-equal (both are built in
    numpy float64 and cast to float32 once).
  * matmul-DFT magnitudes vs the JAX package's XLA path: float32 products,
    only the summation order differs: rtol 1e-5, atol 1e-5 * max|ref|.
  * rfft magnitudes: two FFT implementations in float32: rtol 1e-4,
    atol 1e-4 * max|ref|.
  * the kernel's plain version vs `stft_magnitude_pallas(interpret=True)`
    at the shapes of tests/unit/test_pallas_stft.py: rtol 1e-4, atol 1e-4,
    that test's own tolerance; at the speech window n_fft 400 and at 6000
    (both on the FFT route now): rtol 1e-5, atol 1e-5 * max|ref| (the same
    float32 basis and products, summed in another order).
  * both spectral losses, values and gradients, at fft_sizes (960, 400) and
    the mel loss at n_fft 400: the tolerances of tests/test_torch_losses.py.
  * gradients vs the JAX custom-VJP path (`stft_magnitude_fused`): float32
    summation order, atol 1e-5 * max|g|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsc_tpu.losses import spectral as JSP
from nsc_tpu.ops import stft as JS
from nsc_tpu.ops.pallas import stft as JPS
from nsc_tpu_torch import kernels
from nsc_tpu_torch.kernels import stft as KS
from nsc_tpu_torch.losses import spectral as SP
from nsc_tpu_torch.ops import stft as S
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _x(b, t, seed=0):
    return (np.random.RandomState(seed).randn(b, t) * 0.3).astype(np.float32)


@pytest.mark.parametrize("n", [128, 256, 1024, 2048])
def test_window_and_basis_bit_equal(n):
    np.testing.assert_array_equal(S.hann_window(n).numpy(), np.asarray(JS.hann_window(n)))
    c, s = S.dft_basis(n)
    jc, js = JS._dft_basis_np(n)
    np.testing.assert_array_equal(c.numpy(), jc)
    np.testing.assert_array_equal(s.numpy(), js)


@pytest.mark.parametrize("sr,n_fft,n_mels", [(16000, 1024, 80), (16000, 256, 20), (24000, 512, 40)])
def test_mel_filterbank_bit_equal(sr, n_fft, n_mels):
    np.testing.assert_array_equal(
        S.mel_filterbank(sr, n_fft, n_mels).numpy(), np.asarray(JS.mel_filterbank(sr, n_fft, n_mels))
    )


@pytest.mark.parametrize("center", [True, False])
@pytest.mark.parametrize("matmul", [True, False])
@pytest.mark.parametrize("n_fft,hop,t", [(256, 64, 2000), (512, 128, 3001)])
def test_stft_magnitude_matches_jax(center, matmul, n_fft, hop, t):
    x = _x(2, t)
    ref = np.asarray(JS.stft_magnitude(jnp.asarray(x), n_fft, hop, center=center,
                                       use_matmul_dft=matmul))
    got = S.stft_magnitude(torch.from_numpy(x), n_fft, hop, center=center,
                           use_matmul_dft=matmul).numpy()
    assert got.shape == ref.shape
    tol = 1e-5 if matmul else 1e-4
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol * np.abs(ref).max())


def test_frame_signal_matches_jax():
    x = _x(3, 1000)
    for center in (True, False):
        np.testing.assert_array_equal(
            S.frame_signal(torch.from_numpy(x), 128, 32, center=center).numpy(),
            np.asarray(JS.frame_signal(jnp.asarray(x), 128, 32, center=center)),
        )
    assert S.num_frames(1000, 128, 32, True) == 1 + 1000 // 32


def test_mel_spectrogram_matches_jax():
    x = _x(2, 4000, seed=3)
    ref = np.asarray(JS.mel_spectrogram(jnp.asarray(x), 16000, 512, 128, 40, use_matmul_dft=True))
    got = S.mel_spectrogram(torch.from_numpy(x), 16000, 512, 128, 40, use_matmul_dft=True).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


@pytest.mark.parametrize("n_fft,hop,t", [(256, 64, 4096), (512, 128, 4000), (128, 32, 1000)])
def test_kernel_plain_matches_pallas_interpret(n_fft, hop, t):
    x = _x(2, t, seed=n_fft)
    ref = np.asarray(JPS.stft_magnitude_pallas(jnp.asarray(x), n_fft, hop, interpret=True))
    got = KS.stft_magnitude_plain(torch.from_numpy(x), n_fft, hop).numpy()
    assert got.shape == ref.shape == (2, 1 + t // hop, n_fft // 2 + 1)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_fft,hop,b", [(400, 100, 2), (6000, 1500, 1)])
def test_kernel_plain_matches_pallas_at_mixed_radix_sizes(n_fft, hop, b):
    """The port's plain reference is the JAX kernel's at n_fft the FFT route
    now takes past the powers of two (T a multiple of no hop)."""
    t = 2 * n_fft + 37
    x = _x(b, t, seed=n_fft)
    ref = np.asarray(JPS.stft_magnitude_pallas(jnp.asarray(x), n_fft, hop, interpret=True))
    got = KS.stft_magnitude_plain(torch.from_numpy(x), n_fft, hop).numpy()
    assert got.shape == ref.shape == (b, 1 + t // hop, n_fft // 2 + 1)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())


def test_losses_at_speech_windows_match_jax():
    """Both spectral losses, values and gradients, at the bank (960, 400)
    and the mel loss at n_fft 400, against the JAX package's (XLA
    matmul-DFT) on a (2, 4000) pair."""
    rng = np.random.RandomState(5)
    target = (rng.randn(2, 4000) * 0.3).astype(np.float32)
    pred = (target + rng.randn(2, 4000) * 0.05).astype(np.float32)
    mel_kw = dict(sample_rate=16000, n_fft=400, hop=100, n_mels=80)
    cases = (
        (lambda p, t: SP.multi_res_stft_loss(p, t, SP.MultiResSTFTConfig(fft_sizes=(960, 400))),
         lambda p: JSP.multi_res_stft_loss(
             p, jnp.asarray(target), JSP.MultiResSTFTConfig(fft_sizes=(960, 400))),
         5e-4),
        (lambda p, t: SP.mel_loss(p, t, **mel_kw),
         lambda p: JSP.mel_loss(p, jnp.asarray(target), **mel_kw), None),
    )
    for fn, jfn, grad_atol in cases:
        rv, rg = jax.value_and_grad(jfn)(jnp.asarray(pred))
        p = torch.from_numpy(pred).requires_grad_(True)
        loss = fn(p, torch.from_numpy(target))
        loss.backward()
        rg = np.asarray(rg)
        np.testing.assert_allclose(loss.item(), float(rv), rtol=1e-4, atol=1e-6)
        atol = 1e-6 if grad_atol is None else grad_atol * np.abs(rg).max()
        np.testing.assert_allclose(p.grad.numpy(), rg, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("n_fft,hop", [(256, 64), (128, 32)])
def test_wrapper_gradient_matches_jax_custom_vjp(n_fft, hop):
    """On the CPU the wrapper is the plain version; its gradient equals the
    JAX package's VJP of the fused STFT (interpret mode)."""
    x = _x(2, 1500, seed=7)
    w = np.random.RandomState(8).rand(2, 1 + 1500 // hop, n_fft // 2 + 1).astype(np.float32)

    def jloss(xx):
        return jnp.sum(JS.stft_magnitude_fused(xx, n_fft, hop, interpret=True) * w)

    ref = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    kernels.reset_launches()
    (KS.stft_magnitude(xt, n_fft, hop) * torch.from_numpy(w)).sum().backward()
    assert kernels.LAUNCHES["stft_magnitude"] == 0
    got = xt.grad.numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * np.abs(ref).max())


def test_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="unsupported device"):
        KS.stft_magnitude(torch.empty(2, 100, device="meta"), 64, 16)


def test_kernel_shared_memory_budget():
    """The DFT remainder stages its basis and samples in chunks of n, in
    static shared memory whose size no shape enters: the wrapper refuses
    no n_fft >= 2 and hop >= 1 for shared memory, small or large, and
    routes each by n_fft alone. The FFT route's shapes are bounded by its
    one-frame plan, 20 n_fft bytes (FFT_MAX)."""
    x = torch.zeros(2, 64000)
    for n_fft, hop in ((2, 1), (3, 64000), (441, 110), (2048, 512), (6000, 1500), (8192, 2048),
                       (12000, 3000), (20001, 1), (60000, 7), (127999, 1)):
        assert KS._check(x, n_fft, hop) == KS.route(n_fft)
    assert 20 * KS.FFT_MAX <= KS.MAX_SMEM < 20 * (KS.FFT_MAX + 1)
