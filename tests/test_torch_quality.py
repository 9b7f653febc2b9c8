"""The port's quality metrics (`nsc_tpu_torch/eval/quality.py`) and audio
utilities (`nsc_tpu_torch/utils/audio.py`) against nsc_tpu's, on seeded
inputs.

Tolerances: the numpy metrics (si_snr, snr, stoi, codebook_match_rate) and
the audio utilities are exact. The spectral ones (mel_distance,
fw_seg_snr, pesq_proxy, stoi_proxy, visqol_nsim) take their spectra from
the port's `ops/stft.py` in float32 on the CPU, where nsc_tpu uses
`jnp.fft`/its matmul DFT: float32 sums in another order, rtol 1e-5.
"""

import numpy as np
import pytest

from nsc_tpu.eval import quality as J
from nsc_tpu.utils import audio as JAU
from nsc_tpu_torch.eval import quality as P
from nsc_tpu_torch.utils import audio as PAU
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

EXACT = ("si_snr", "snr", "stoi")
SPECTRAL = ("mel_distance", "fw_seg_snr", "pesq_proxy", "stoi_proxy", "visqol_nsim")


def _pair(seed, batch):
    """A speech-like reference (harmonics under an envelope) and a degraded
    copy (noise, a gain and a one-sample shift), (batch, 1.5 s) at 16 kHz."""
    rng = np.random.RandomState(seed)
    t = np.arange(24000) / 16000.0
    ref = np.stack([
        sum(rng.uniform(0.05, 0.3) / h * np.sin(2 * np.pi * f0 * h * t) for h in range(1, 6))
        * (0.6 + 0.4 * np.sin(2 * np.pi * 3 * t))
        for f0 in rng.uniform(90, 250, batch)
    ]).astype(np.float32)
    deg = (0.9 * np.roll(ref, 1, axis=-1) + 0.02 * rng.randn(*ref.shape)).astype(np.float32)
    return ref, deg


@pytest.mark.parametrize("name", EXACT + SPECTRAL)
@pytest.mark.parametrize("seed,batch", [(0, 1), (1, 3)])
def test_metric_matches_nsc_tpu(name, seed, batch):
    ref, deg = _pair(seed, batch)
    if batch == 1:
        ref, deg = ref[0], deg[0]
    want = getattr(J, name)(ref, deg)
    got = getattr(P, name)(ref, deg)
    if name in EXACT:
        assert got == want
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_codebook_match_rate_and_errors():
    rng = np.random.RandomState(2)
    a = rng.randint(0, 16, (3, 50, 4))
    b = np.where(rng.rand(*a.shape) < 0.1, (a + 1) % 16, a)
    assert P.codebook_match_rate(a, b) == J.codebook_match_rate(a, b)
    for fn in (P.codebook_match_rate, P.stoi, P.visqol_nsim):
        with pytest.raises(ValueError, match="shape mismatch"):
            fn(np.zeros((2, 16000)), np.zeros((1, 16000)))
    with pytest.raises(ValueError, match="too short"):
        P.stoi(np.zeros(100), np.zeros(100))


def test_audio_utilities_match_nsc_tpu(tmp_path):
    rng = np.random.RandomState(4)
    wav = (rng.randn(4000, 2) * 0.3).astype(np.float32)
    for mod in (PAU, JAU):
        assert mod.to_mono(wav).shape == (4000,)
    np.testing.assert_array_equal(PAU.to_mono(wav), JAU.to_mono(wav))
    np.testing.assert_array_equal(PAU.normalize(wav), JAU.normalize(wav))
    np.testing.assert_array_equal(PAU.resample(wav, 16000, 24000), JAU.resample(wav, 16000, 24000))
    path = str(tmp_path / "a.wav")
    PAU.save_wav(path, wav[:, 0] * 4, 16000)  # clipped to [-1, 1]
    for target in (None, 8000):
        got, sr = PAU.load_wav(path, target_sr=target)
        want, jsr = JAU.load_wav(path, target_sr=target)
        assert sr == jsr and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
