"""Audio I/O and host-side DSP: WAV files through scipy.io.wavfile,
resampling by polyphase filtering (the port's copy of
`nsc_tpu/utils/audio.py`). Host-side numpy; device code never touches
this module. Operating point: 16 kHz mono.
"""

from __future__ import annotations

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def load_wav(path: str, target_sr: int | None = None) -> tuple[np.ndarray, int]:
    """Load a WAV file as float32 in [-1, 1], shape (num_samples,) for mono
    or (num_samples, num_channels). Optionally resample to `target_sr`."""
    sr, data = wavfile.read(path)
    data = _to_float32(data)
    if target_sr is not None and sr != target_sr:
        data = resample(data, sr, target_sr)
        sr = target_sr
    return data, sr


def save_wav(path: str, wav: np.ndarray, sample_rate: int) -> None:
    """Save float waveform in [-1, 1] as 16-bit PCM WAV."""
    wav = np.asarray(wav)
    wav = np.clip(wav, -1.0, 1.0)
    pcm = (wav * 32767.0).astype(np.int16)
    wavfile.write(path, sample_rate, pcm)


def resample(wav: np.ndarray, orig_sr: int, target_sr: int) -> np.ndarray:
    """Polyphase resampling along the time (first) axis."""
    if orig_sr == target_sr:
        return wav
    g = np.gcd(orig_sr, target_sr)
    return resample_poly(wav, target_sr // g, orig_sr // g, axis=0).astype(
        wav.dtype
    )


def to_mono(wav: np.ndarray) -> np.ndarray:
    """Average channels down to mono. Accepts (T,) or (T, C)."""
    if wav.ndim == 1:
        return wav
    return wav.mean(axis=1)


def normalize(wav: np.ndarray, peak: float = 0.95) -> np.ndarray:
    """Peak-normalize; no-op on silence."""
    m = np.max(np.abs(wav))
    if m < 1e-8:
        return wav
    return (wav * (peak / m)).astype(wav.dtype)


def _to_float32(data: np.ndarray) -> np.ndarray:
    if data.dtype == np.float32:
        return data
    if data.dtype == np.float64:
        return data.astype(np.float32)
    if data.dtype == np.int16:
        return (data / 32768.0).astype(np.float32)
    if data.dtype == np.int32:
        return (data / 2147483648.0).astype(np.float32)
    if data.dtype == np.uint8:
        return ((data.astype(np.float32) - 128.0) / 128.0).astype(np.float32)
    raise ValueError(f"unsupported WAV dtype {data.dtype}")
