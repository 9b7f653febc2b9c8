"""Quality metrics (the port of `nsc_tpu/eval/quality.py`).

Host-side metrics on (T,) or (N, T) arrays: SNR, SI-SNR, a log-mel
distance, frequency-weighted segmental SNR and the PESQ proxy built on it,
an STOI-style proxy, faithful STOI (Taal et al. 2011) and a ViSQOL-style
NSIM. The spectra come from the port's `ops/stft.py` on CPU tensors in
float32 (the JAX package uses its `ops/stft.py` there); everything else is
numpy, as in the JAX package.

*** pesq_proxy is NOT ITU-T P.862 PESQ, visqol_nsim is NOT ViSQOL v3, and
stoi_proxy is not the STOI reference; `stoi` is the published algorithm.
No pesq/visqol package is used. ***
"""

from __future__ import annotations

import numpy as np

import torch

from nsc_tpu_torch.ops import stft as S


def _as2d(x) -> np.ndarray:
    x = np.asarray(x, np.float64)
    return x[None] if x.ndim == 1 else x


def _f32(x) -> torch.Tensor:
    """A host array as a float32 CPU tensor (the spectra's input)."""
    return torch.from_numpy(np.asarray(x, np.float32))


def si_snr(ref, deg, eps: float = 1e-8) -> float:
    """Scale-invariant SNR in dB (mean over batch)."""
    r, d = _as2d(ref), _as2d(deg)
    r = r - r.mean(-1, keepdims=True)
    d = d - d.mean(-1, keepdims=True)
    proj = (np.sum(d * r, -1, keepdims=True) / (np.sum(r * r, -1, keepdims=True) + eps)) * r
    noise = d - proj
    ratio = np.sum(proj**2, -1) / (np.sum(noise**2, -1) + eps)
    return float(np.mean(10 * np.log10(ratio + eps)))


def snr(ref, deg, eps: float = 1e-8) -> float:
    r, d = _as2d(ref), _as2d(deg)
    ratio = np.sum(r**2, -1) / (np.sum((r - d) ** 2, -1) + eps)
    return float(np.mean(10 * np.log10(ratio + eps)))


def mel_distance(
    ref, deg, sample_rate: int = 16_000, n_fft: int = 1024,
    hop: int = 256, n_mels: int = 80,
) -> float:
    """L2 distance between log-mel spectrograms (the bitrate-sweep spectral
    metric; lower is better)."""
    r = S.mel_spectrogram(_f32(_as2d(ref)), sample_rate, n_fft, hop, n_mels).numpy()
    d = S.mel_spectrogram(_f32(_as2d(deg)), sample_rate, n_fft, hop, n_mels).numpy()
    return float(np.sqrt(np.mean((r - d) ** 2)))


def fw_seg_snr(
    ref, deg, sample_rate: int = 16_000, n_fft: int = 512, n_mels: int = 23,
    clamp: tuple = (-10.0, 35.0),
) -> float:
    """Frequency-weighted segmental SNR (dB) on a mel filterbank — the core
    of the PESQ proxy."""
    hop = n_fft // 2
    r = S.mel_spectrogram(_f32(_as2d(ref)), sample_rate, n_fft, hop, n_mels, log=False).numpy()
    d = S.mel_spectrogram(_f32(_as2d(deg)), sample_rate, n_fft, hop, n_mels, log=False).numpy()
    eps = 1e-8
    err = (r - d) ** 2
    band_snr = 10 * np.log10((r**2 + eps) / (err + eps))
    band_snr = np.clip(band_snr, *clamp)
    # weight by band energy (loud bands matter more)
    w = r + eps
    seg = np.sum(band_snr * w, axis=-1) / np.sum(w, axis=-1)  # (N, frames)
    # only score frames with energy (speech activity)
    active = np.sum(r, axis=-1) > 1e-4 * np.max(np.sum(r, axis=-1))
    if not np.any(active):
        return float(np.mean(seg))
    return float(np.mean(seg[active]))


def pesq_proxy(ref, deg, sample_rate: int = 16_000) -> float:
    """MOS-like score in [1, 4.5] from fwSegSNR through a logistic map.

    *** PROXY — not ITU-T P.862 PESQ (package unavailable offline). ***
    Calibrated so ~0 dB -> ~1.5 (bad), ~15 dB -> ~3.2, >=30 dB -> ~4.4.
    """
    s = fw_seg_snr(ref, deg, sample_rate)
    return float(1.0 + 3.5 / (1.0 + np.exp(-(s - 12.0) / 6.0)))


def stoi_proxy(
    ref, deg, sample_rate: int = 16_000, n_fft: int = 512,
    seg_frames: int = 30, beta_db: float = -15.0,
) -> float:
    """Short-time objective intelligibility PROXY in ~[0, 1] (higher=better).

    *** PROXY — not the Taal et al. STOI reference implementation. ***
    Same construction, differently built from the PESQ proxy (a second,
    independently-constructed perceptual axis):
    1/3-octave band envelopes from the framed STFT, short-time segments
    (~0.5 s), degraded envelope normalized + clipped at +beta dB, then
    band/segment-wise Pearson correlation, averaged. Tracks intelligibility-
    style degradations (temporal envelope damage) that an SNR-family metric
    under-weights.
    """
    hop = n_fft // 2
    # matmul-DFT magnitudes, as the JAX package computes them
    r = S.stft_magnitude(_f32(_as2d(ref)), n_fft, hop, use_matmul_dft=True).numpy()
    d = S.stft_magnitude(_f32(_as2d(deg)), n_fft, hop, use_matmul_dft=True).numpy()
    # 1/3-octave bands, 150 Hz .. ~4.3 kHz (15 bands)
    freqs = np.fft.rfftfreq(n_fft, 1.0 / sample_rate)
    centers = 150.0 * 2.0 ** (np.arange(15) / 3.0)
    lo, hi = centers / 2 ** (1 / 6), centers * 2 ** (1 / 6)
    bands = (freqs[None, :] >= lo[:, None]) & (freqs[None, :] < hi[:, None])
    bands = bands.astype(np.float64)  # (15, K)
    # band envelopes: (N, frames, 15)
    er = np.sqrt(np.einsum("nfk,bk->nfb", r.astype(np.float64) ** 2, bands) + 1e-12)
    ed = np.sqrt(np.einsum("nfk,bk->nfb", d.astype(np.float64) ** 2, bands) + 1e-12)

    n, frames, nb = er.shape
    if frames < seg_frames:
        seg_frames = frames
    clip = 10.0 ** (-beta_db / 20.0)
    scores = []
    for s0 in range(0, frames - seg_frames + 1, seg_frames):
        x = er[:, s0 : s0 + seg_frames, :]  # (N, M, B)
        y = ed[:, s0 : s0 + seg_frames, :]
        # normalize degraded to the clean segment's energy, clip upward dev.
        alpha = np.sqrt(
            np.sum(x**2, axis=1, keepdims=True)
            / (np.sum(y**2, axis=1, keepdims=True) + 1e-12)
        )
        yn = np.minimum(y * alpha, x * clip)
        xm = x - x.mean(axis=1, keepdims=True)
        ym = yn - yn.mean(axis=1, keepdims=True)
        num = np.sum(xm * ym, axis=1)
        den = np.sqrt(np.sum(xm**2, axis=1) * np.sum(ym**2, axis=1)) + 1e-12
        corr = num / den  # (N, B)
        # weight by reference band energy: bands the clean signal doesn't
        # occupy carry no intelligibility information (pure STOI averages
        # uniformly but assumes broadband speech input)
        w = np.sum(x**2, axis=1) + 1e-12  # (N, B)
        scores.append(np.sum(corr * w, axis=-1) / np.sum(w, axis=-1))
    if not scores:
        return 0.0
    return float(np.mean(np.stack(scores)))


# ---------------------------------------------------------------------------
# faithful STOI (Taal et al. 2011)
# ---------------------------------------------------------------------------

_STOI_SR = 10_000  # the algorithm is defined at 10 kHz
_STOI_FRAME = 256  # 25.6 ms analysis frames
_STOI_HOP = 128  # 50% overlap
_STOI_NFFT = 512  # zero-padded DFT
_STOI_NBANDS = 15  # 1/3-octave bands, lowest cf 150 Hz
_STOI_SEG = 30  # 384 ms short-time segments
_STOI_BETA = -15.0  # lower SDR clipping bound (dB)
_STOI_DYN = 40.0  # silent-frame dynamic range (dB)


def _stoi_window() -> np.ndarray:
    # the reference implementation's periodic-interior Hann
    # (matlab hanning(N): no zero endpoints)
    return np.hanning(_STOI_FRAME + 2)[1:-1]


def _stoi_frames(x: np.ndarray) -> np.ndarray:
    """(T,) -> (num_frames, FRAME) windowed frames, hop 128."""
    n = 1 + max(0, (len(x) - _STOI_FRAME)) // _STOI_HOP
    if len(x) < _STOI_FRAME:
        x = np.pad(x, (0, _STOI_FRAME - len(x)))
        n = 1
    idx = (
        np.arange(_STOI_FRAME)[None, :]
        + _STOI_HOP * np.arange(n)[:, None]
    )
    return x[idx] * _stoi_window()[None, :]


def _remove_silent_frames(x: np.ndarray, y: np.ndarray):
    """Drop frames whose CLEAN energy is > 40 dB below the loudest frame,
    then overlap-add the survivors back into time signals (spec step 1)."""
    xf, yf = _stoi_frames(x), _stoi_frames(y)
    energies = 20 * np.log10(np.linalg.norm(xf, axis=1) + 1e-20)
    keep = energies > np.max(energies) - _STOI_DYN
    xf, yf = xf[keep], yf[keep]
    if not len(xf):
        return None, None
    out_len = _STOI_FRAME + _STOI_HOP * (len(xf) - 1)
    xs, ys = np.zeros(out_len), np.zeros(out_len)
    for i in range(len(xf)):
        s = i * _STOI_HOP
        xs[s : s + _STOI_FRAME] += xf[i]
        ys[s : s + _STOI_FRAME] += yf[i]
    return xs, ys


def _third_octave_matrix() -> np.ndarray:
    """(15, 257) binary band matrix with the reference implementation's
    nearest-bin edge rounding."""
    f = np.linspace(0, _STOI_SR / 2, _STOI_NFFT // 2 + 1)
    cf = 150.0 * 2.0 ** (np.arange(_STOI_NBANDS) / 3.0)
    obm = np.zeros((_STOI_NBANDS, len(f)))
    for i, c in enumerate(cf):
        lo = np.argmin(np.abs(f - c * 2.0 ** (-1.0 / 6.0)))
        hi = np.argmin(np.abs(f - c * 2.0 ** (1.0 / 6.0)))
        obm[i, lo:hi] = 1.0
    return obm


def stoi(ref, deg, sample_rate: int = 16_000) -> float:
    """Short-Time Objective Intelligibility, FAITHFUL to the published
    algorithm (Taal, Hendriks, Heusdens & Jensen, "An Algorithm for
    Intelligibility Prediction of Time-Frequency Weighted Noisy Speech",
    IEEE TASLP 2011) — not a proxy:

      1. resample both signals to 10 kHz (polyphase);
      2. remove frames > 40 dB below the clean signal's loudest frame
         (256-sample Hann frames, 50% overlap, overlap-add reconstruction);
      3. STFT: 256-sample Hann frames zero-padded to 512;
      4. 15 one-third-octave bands, lowest center 150 Hz (~4.3 kHz top),
         nearest-bin edges, band magnitude = sqrt(sum of squared bins);
      5. sliding 30-frame (384 ms) segments, stride 1;
      6. per band+segment: normalize degraded to clean energy, clip at
         (1 + 10^(-beta/20)) * clean with beta = -15 dB (the lower SDR
         bound), Pearson correlation over the 30 frames;
      7. UNIFORM average over all bands and segments.

    Returns a scalar in ~[0, 1]; mean over batch rows for (N, T) input.
    """
    from nsc_tpu_torch.utils import audio

    r2, d2 = _as2d(ref), _as2d(deg)
    if r2.shape != d2.shape:
        raise ValueError(f"shape mismatch {r2.shape} vs {d2.shape}")
    scores = []
    for rr, dd in zip(r2, d2):
        if sample_rate != _STOI_SR:
            rr = audio.resample(rr, sample_rate, _STOI_SR)
            dd = audio.resample(dd, sample_rate, _STOI_SR)
        rr, dd = _remove_silent_frames(rr, dd)
        if rr is None:
            continue
        xf = np.fft.rfft(_stoi_frames(rr), _STOI_NFFT, axis=1)  # host-side
        yf = np.fft.rfft(_stoi_frames(dd), _STOI_NFFT, axis=1)
        obm = _third_octave_matrix()
        x = np.sqrt(obm @ (np.abs(xf) ** 2).T + 1e-20)  # (15, frames)
        y = np.sqrt(obm @ (np.abs(yf) ** 2).T + 1e-20)
        frames = x.shape[1]
        if frames < _STOI_SEG:
            continue
        clip = 10.0 ** (-_STOI_BETA / 20.0)
        d_sum, d_cnt = 0.0, 0
        for m in range(_STOI_SEG, frames + 1):
            xs = x[:, m - _STOI_SEG : m]  # (15, 30)
            ys = y[:, m - _STOI_SEG : m]
            alpha = np.sqrt(
                np.sum(xs**2, axis=1, keepdims=True)
                / (np.sum(ys**2, axis=1, keepdims=True) + 1e-20)
            )
            yn = np.minimum(ys * alpha, xs * (1 + clip))
            xm = xs - xs.mean(axis=1, keepdims=True)
            ym = yn - yn.mean(axis=1, keepdims=True)
            num = np.sum(xm * ym, axis=1)
            den = (
                np.sqrt(np.sum(xm**2, axis=1) * np.sum(ym**2, axis=1)) + 1e-20
            )
            d_sum += float(np.sum(num / den))
            d_cnt += _STOI_NBANDS
        if d_cnt:
            scores.append(d_sum / d_cnt)
    if not scores:
        raise ValueError(
            "signal too short for STOI (needs >= 30 active frames "
            f"~ {(_STOI_SEG * _STOI_HOP + _STOI_FRAME) * sample_rate // _STOI_SR} "
            "samples at the input rate)"
        )
    return float(np.mean(scores))


# ---------------------------------------------------------------------------
# ViSQOL-style NSIM
# ---------------------------------------------------------------------------


def _erb(f: np.ndarray) -> np.ndarray:
    """Equivalent rectangular bandwidth (Hz) at frequency f (Glasberg &
    Moore 1990): ERB(f) = 24.7 * (4.37 f/1000 + 1)."""
    return 24.7 * (4.37 * f / 1000.0 + 1.0)


def _gammatone_matrix(
    n_fft: int, sample_rate: int, n_bands: int = 21, f_lo: float = 50.0,
) -> np.ndarray:
    """(n_bands, n_fft//2+1) power weights of an ERB-spaced 4th-order
    gammatone filterbank — the spectro-temporal front end ViSQOL scores on.

    Centers are uniform on the ERB-rate scale between f_lo and min(8 kHz,
    Nyquist); each row is the order-4 gammatone magnitude-squared response
    |H(f)|^2 = [1 + ((f-fc)/b)^2]^-4 with b = 1.019*ERB(fc), row-normalized.
    """
    f_hi = min(8000.0, sample_rate / 2.0)
    erb_rate = lambda f: 21.4 * np.log10(1.0 + 0.00437 * f)  # noqa: E731
    erb_inv = lambda e: (10.0 ** (e / 21.4) - 1.0) / 0.00437  # noqa: E731
    centers = erb_inv(np.linspace(erb_rate(f_lo), erb_rate(f_hi), n_bands))
    freqs = np.linspace(0, sample_rate / 2.0, n_fft // 2 + 1)
    b = 1.019 * _erb(centers)
    resp = (1.0 + ((freqs[None, :] - centers[:, None]) / b[:, None]) ** 2) ** -4.0
    return resp / np.sum(resp, axis=1, keepdims=True)


def _nsim(x: np.ndarray, y: np.ndarray, dyn: float) -> float:
    """Neurogram Similarity Index Measure between two equal-shape
    (bands, frames) images with intensity range `dyn`: SSIM's luminance and
    structure terms (no contrast term), 3x3 Gaussian local statistics,
    averaged over all time-frequency points (Hines & Harte 2012)."""
    # 3x3 Gaussian window, sigma 0.5 (the SSIM/NSIM reference window)
    g1 = np.array([np.exp(-2.0), 1.0, np.exp(-2.0)])
    g1 /= g1.sum()
    w = np.outer(g1, g1)

    def _filt(a: np.ndarray) -> np.ndarray:
        p = np.pad(a, 1, mode="edge")
        out = np.zeros_like(a)
        for i in range(3):
            for j in range(3):
                out += w[i, j] * p[i : i + a.shape[0], j : j + a.shape[1]]
        return out

    c1 = (0.01 * dyn) ** 2
    c3 = (0.03 * dyn) ** 2 / 2.0
    mx, my = _filt(x), _filt(y)
    sxx = _filt(x * x) - mx * mx
    syy = _filt(y * y) - my * my
    sxy = _filt(x * y) - mx * my
    sxx, syy = np.maximum(sxx, 0.0), np.maximum(syy, 0.0)
    lum = (2.0 * mx * my + c1) / (mx**2 + my**2 + c1)
    struct = (sxy + c3) / (np.sqrt(sxx * syy) + c3)
    return float(np.mean(lum * struct))


def visqol_nsim(
    ref, deg, sample_rate: int = 16_000, n_fft: int = 512, hop: int = 160,
    n_bands: int = 21, floor_db: float = 60.0,
) -> float:
    """ViSQOL-style similarity score in ~[0, 1] (higher = better).

    *** PROXY — not Google's ViSQOL v3 (no network/package offline). ***
    Implements the published core of ViSQOL (Hines, Skoglund, Kokaram &
    Harte, "ViSQOL: an objective speech quality model", 2015): a gammatone
    spectrogram (ERB-spaced 4th-order filterbank, 50 Hz - 8 kHz) in dB,
    compared patch-wise with NSIM — SSIM's luminance*structure terms over
    3x3 Gaussian-weighted local statistics — and averaged. What it does NOT
    reproduce: ViSQOL's patch alignment search (our eval pairs are already
    time-aligned by construction) and the fitted NSIM->MOS support-vector
    mapping (training data unavailable); the raw mean NSIM is returned
    instead of a MOS-LQO. Identical signals score exactly 1.0.
    """
    r2, d2 = _as2d(ref), _as2d(deg)
    if r2.shape != d2.shape:
        raise ValueError(f"shape mismatch {r2.shape} vs {d2.shape}")
    # matmul-DFT magnitudes, as the JAX package computes them
    rm = S.stft_magnitude(_f32(r2), n_fft, hop, use_matmul_dft=True).numpy().astype(np.float64)
    dm = S.stft_magnitude(_f32(d2), n_fft, hop, use_matmul_dft=True).numpy().astype(np.float64)
    gt = _gammatone_matrix(n_fft, sample_rate, n_bands)  # (B, K)
    scores = []
    for rr, dd in zip(rm, dm):  # (frames, K) each
        gr = 10.0 * np.log10(gt @ rr.T**2 + 1e-20)  # (B, frames) dB
        gd = 10.0 * np.log10(gt @ dd.T**2 + 1e-20)
        lo = float(np.max(gr)) - floor_db
        gr = np.clip(gr, lo, None) - lo
        gd = np.clip(gd, lo, None) - lo
        scores.append(_nsim(gr, gd, dyn=floor_db))
    return float(np.mean(scores))


def codebook_match_rate(idx_a, idx_b) -> dict:
    """Fraction of identical indices, overall and per book."""
    a, b = np.asarray(idx_a), np.asarray(idx_b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {a.shape} vs {b.shape}")
    eq = a == b
    per_book = eq.reshape(-1, a.shape[-1]).mean(axis=0)
    return {
        "overall": float(eq.mean()),
        "per_book": [float(x) for x in per_book],
    }
