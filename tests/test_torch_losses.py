"""The port's spectral and GAN losses against the JAX package's, values and
gradients, on the same numpy inputs.

The JAX side runs with `backend="xla"` (the matmul-DFT lowering) and
`backend="pallas_interpret"` (the Pallas STFT kernel in interpret mode with
its XLA VJP); on the CPU the port's loss STFT is its kernel's plain version.
Tolerances: values, and the mel loss's gradient with respect to `pred`,
at rtol 1e-4, atol 1e-6 (float32 sums taken in another order; the losses
are means of logs and norms of those sums). The multi-resolution STFT
loss's gradient: rtol 1e-4, atol 5e-4 * max|g|. Its log-magnitude term's
gradient at a bin is (re dre + im dim) / (|X| (|X| + eps)): the float32
error of re and im (about 1e-7 of the frame's energy, whatever the order)
is divided by |X|^2, so a low-energy bin amplifies it, and a bin where
|X_pred| and |X_target| nearly agree can take the other sign of the L1
subgradient. On these inputs the worst difference is 1.7e-4 * max|g|
(n_fft 1024); an absolute 1e-6 does not hold for this gradient. GAN
losses: rtol 1e-6 (the same float32 elementwise arithmetic and means).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsc_tpu.losses import gan as JG
from nsc_tpu.losses import spectral as JSP
from nsc_tpu_torch.losses import gan as G
from nsc_tpu_torch.losses import spectral as SP

FFTS = (1024, 256, 128)


def _wavs(n=2, t=3000, seed=0):
    rng = np.random.RandomState(seed)
    target = (rng.randn(n, t) * 0.3).astype(np.float32)
    pred = (target + rng.randn(n, t) * 0.05).astype(np.float32)
    return pred, target


def _torch_value_and_grad(fn, pred, target):
    p = torch.from_numpy(pred).requires_grad_(True)
    loss = fn(p, torch.from_numpy(target))
    loss.backward()
    return loss.item(), p.grad.numpy()


def _close(got, ref, grad_atol=None):
    v, g = got
    rv, rg = ref
    rg = np.asarray(rg)
    np.testing.assert_allclose(v, float(rv), rtol=1e-4, atol=1e-6)
    atol = 1e-6 if grad_atol is None else grad_atol * np.abs(rg).max()
    np.testing.assert_allclose(g, rg, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_multi_res_stft_loss_value_and_grad(backend):
    pred, target = _wavs()
    cfg = SP.MultiResSTFTConfig(fft_sizes=FFTS)
    jcfg = JSP.MultiResSTFTConfig(fft_sizes=FFTS)
    ref = jax.value_and_grad(
        lambda p: JSP.multi_res_stft_loss(p, jnp.asarray(target), jcfg, backend=backend)
    )(jnp.asarray(pred))
    got = _torch_value_and_grad(lambda p, t: SP.multi_res_stft_loss(p, t, cfg), pred, target)
    _close(got, ref, grad_atol=5e-4)


@pytest.mark.parametrize("backend", ["xla", "pallas_interpret"])
def test_mel_loss_value_and_grad(backend):
    pred, target = _wavs(seed=1)
    kw = dict(sample_rate=16000, n_fft=512, hop=128, n_mels=40)
    ref = jax.value_and_grad(
        lambda p: JSP.mel_loss(p, jnp.asarray(target), backend=backend, **kw)
    )(jnp.asarray(pred))
    got = _torch_value_and_grad(lambda p, t: SP.mel_loss(p, t, **kw), pred, target)
    _close(got, ref)


def test_default_resolutions_value():
    """The TrainConfig resolutions (n_fft 2048..128, hop n_fft/4) and the
    default mel loss on a 1 s pair."""
    pred, target = _wavs(n=1, t=16000, seed=2)
    ref = float(JSP.multi_res_stft_loss(jnp.asarray(pred), jnp.asarray(target)))
    got = SP.multi_res_stft_loss(torch.from_numpy(pred), torch.from_numpy(target)).item()
    np.testing.assert_allclose(got, ref, rtol=1e-4)
    ref = float(JSP.mel_loss(jnp.asarray(pred), jnp.asarray(target)))
    got = SP.mel_loss(torch.from_numpy(pred), torch.from_numpy(target)).item()
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_time_l1_and_identity():
    pred, target = _wavs(seed=3)
    np.testing.assert_allclose(
        SP.time_l1_loss(torch.from_numpy(pred), torch.from_numpy(target)).item(),
        float(JSP.time_l1_loss(jnp.asarray(pred), jnp.asarray(target))), rtol=1e-6,
    )
    t = torch.from_numpy(target)
    assert SP.multi_res_stft_loss(t, t, SP.MultiResSTFTConfig(fft_sizes=FFTS)).item() < 1e-5
    assert SP.mel_loss(t, t).item() == 0.0


def _disc_outs(seed, n_sub=4, n=3):
    """Random (logits, features) lists in NHWC-free shapes (means only)."""
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n_sub):
        feats = [rng.randn(n, 5 + i, 4).astype(np.float32) for _ in range(3)]
        out.append((rng.randn(n, 7 + i).astype(np.float32), feats))
    return out


def _to(outs, conv):
    return [(conv(lg), [conv(f) for f in fs]) for lg, fs in outs]


def test_gan_losses_match_jax():
    real, fake = _disc_outs(0), _disc_outs(1)
    jr, jf = _to(real, jnp.asarray), _to(fake, jnp.asarray)
    tr, tf = _to(real, torch.from_numpy), _to(fake, torch.from_numpy)
    np.testing.assert_allclose(G.discriminator_loss(tr, tf).item(),
                               float(JG.discriminator_loss(jr, jf)), rtol=1e-6)
    np.testing.assert_allclose(G.generator_adversarial_loss(tf).item(),
                               float(JG.generator_adversarial_loss(jf)), rtol=1e-6)
    np.testing.assert_allclose(G.feature_matching_loss(tr, tf).item(),
                               float(JG.feature_matching_loss(jr, jf)), rtol=1e-6)


def test_feature_matching_gradient_reaches_fake_only():
    real, fake = _disc_outs(2), _disc_outs(3)
    f0 = fake[1][1][0]

    def jfm(r0, f0_):
        jr = _to(real, jnp.asarray)
        jf = _to(fake, jnp.asarray)
        jr[1][1][0] = r0
        jf[1][1][0] = f0_
        return JG.feature_matching_loss(jr, jf)

    g_real, g_fake = jax.grad(jfm, argnums=(0, 1))(jnp.asarray(real[1][1][0]), jnp.asarray(f0))
    tr, tf = _to(real, torch.from_numpy), _to(fake, torch.from_numpy)
    r0 = tr[1][1][0].requires_grad_(True)
    ft = tf[1][1][0].requires_grad_(True)
    G.feature_matching_loss(tr, tf).backward()
    assert r0.grad is None and not np.any(np.asarray(g_real))
    np.testing.assert_allclose(ft.grad.numpy(), np.asarray(g_fake), rtol=1e-5, atol=1e-9)
