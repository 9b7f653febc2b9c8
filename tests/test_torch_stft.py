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
    that test's own tolerance.
  * gradients vs the JAX custom-VJP path (`stft_magnitude_fused`): float32
    summation order, atol 1e-5 * max|g|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsc_tpu.ops import stft as JS
from nsc_tpu.ops.pallas import stft as JPS
from nsc_tpu_torch import kernels
from nsc_tpu_torch.kernels import stft as KS
from nsc_tpu_torch.ops import stft as S


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
    """The DFT kernel at the losses' largest shape (n_fft 2048, hop 512)
    fits one block's shared memory with room for two blocks per SM."""
    assert KS.dft_smem_bytes(2048, 512) <= KS.MAX_SMEM // 2
    assert KS.dft_smem_bytes(128, 32) < KS.dft_smem_bytes(2048, 512)
