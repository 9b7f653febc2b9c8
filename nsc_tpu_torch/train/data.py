"""Deterministic synthetic training audio (the port's copy of the
`synthetic` and `synthetic2` sources of `nsc_tpu/train/data.py`).

Both draw from a numpy `RandomState` in the JAX package's order, so the
same seed gives bit-identical batches in both packages. `get_state` /
`set_state` carry the generator's position through a checkpoint, so a
resumed run continues the stream where it stopped.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch


class _Seeded:
    def __init__(self, sample_rate: int = 16_000, seed: int = 0):
        self.sample_rate = sample_rate
        self._rng = np.random.RandomState(seed)

    def get_state(self) -> dict:
        """The generator's position, as tensors and numbers (loadable with
        `torch.load(weights_only=True)`)."""
        name, keys, pos, has_gauss, gauss = self._rng.get_state()
        return {"name": name, "keys": torch.from_numpy(keys.astype(np.int64)),
                "pos": int(pos), "has_gauss": int(has_gauss), "gauss": float(gauss)}

    def set_state(self, st: dict) -> None:
        self._rng.set_state((
            st["name"], st["keys"].numpy().astype(np.uint32), st["pos"],
            st["has_gauss"], st["gauss"],
        ))


class SyntheticSource(_Seeded):
    """Speech-like signals: a harmonic stack (5 harmonics of a random f0),
    a 2-6 Hz amplitude envelope and a little noise."""

    def batches(self, batch_size: int, segment_len: int) -> Iterator[np.ndarray]:
        sr = self.sample_rate
        while True:
            t = np.arange(segment_len, dtype=np.float32) / sr
            out = np.zeros((batch_size, segment_len), np.float32)
            for i in range(batch_size):
                f0 = self._rng.uniform(80, 300)
                sig = np.zeros_like(t)
                for h in range(1, 6):
                    sig += self._rng.uniform(0.05, 0.3) / h * np.sin(
                        2 * np.pi * f0 * h * t + self._rng.uniform(0, 2 * np.pi)
                    )
                env = 0.5 * (1 + np.sin(2 * np.pi * self._rng.uniform(2, 6) * t))
                sig = sig * env + 0.01 * self._rng.randn(segment_len)
                out[i] = np.clip(sig, -1, 1)
            yield out


class SyntheticSourceV2(_Seeded):
    """Richer speech-like signals: gliding f0 with optional vibrato, up to
    10 harmonics with random tilt, 1-3 formant resonators, unvoiced noise
    syllables, a syllabic envelope, a level over ~24 dB and occasional edge
    silence."""

    def _segment(self, t: np.ndarray) -> np.ndarray:
        from scipy.signal import lfilter

        rng = self._rng
        sr = self.sample_rate
        n = t.shape[0]
        f0a = rng.uniform(70, 320)
        f0b = np.clip(f0a * 2.0 ** rng.uniform(-0.7, 0.7), 60, 400)
        f0 = f0a * (f0b / f0a) ** (t / max(t[-1], 1e-6))
        if rng.rand() < 0.5:  # vibrato
            f0 = f0 * (1 + 0.02 * np.sin(2 * np.pi * rng.uniform(4, 7) * t))
        phase = 2 * np.pi * np.cumsum(f0) / sr
        tilt = rng.uniform(0.7, 1.6)
        sig = np.zeros_like(t)
        for h in range(1, 11):
            if f0a * h > 0.45 * sr:
                break
            sig += (
                rng.uniform(0.5, 1.0) / h**tilt
                * np.sin(h * phase + rng.uniform(0, 2 * np.pi))
            )
        for lo, hi in ((250, 900), (850, 2400), (2300, 3400)):
            if rng.rand() < 0.8:
                fc = rng.uniform(lo, hi)
                bw = rng.uniform(60, 200)
                r = np.exp(-np.pi * bw / sr)
                th = 2 * np.pi * fc / sr
                sig = lfilter(
                    [1 - r], [1, -2 * r * np.cos(th), r * r], sig
                ).astype(np.float32)
        sig = sig / (np.abs(sig).max() + 1e-6)
        env = 0.5 * (
            1 + np.sin(2 * np.pi * rng.uniform(2, 8) * t + rng.uniform(0, 2 * np.pi))
        )
        noise = rng.randn(n).astype(np.float32)
        noise = lfilter([1, -0.97], [1], noise).astype(np.float32)
        noise = noise / (np.abs(noise).max() + 1e-6)
        frac_unvoiced = rng.uniform(0.0, 0.4)
        gate = (rng.rand(max(1, int(t[-1] * 8)) + 1) < frac_unvoiced)
        gate = np.repeat(gate, n // gate.shape[0] + 1)[:n]
        mix = np.where(gate, 0.6 * noise, sig) * env
        mix = mix + 0.003 * rng.randn(n)
        mix *= 10.0 ** (rng.uniform(-24, 0) / 20.0) / (np.abs(mix).max() + 1e-6)
        if rng.rand() < 0.15:
            cut = rng.randint(0, n // 4)
            if rng.rand() < 0.5:
                mix[:cut] = 0.0
            else:
                mix[n - cut:] = 0.0
        return np.clip(mix, -1, 1).astype(np.float32)

    def batches(self, batch_size: int, segment_len: int) -> Iterator[np.ndarray]:
        t = np.arange(segment_len, dtype=np.float32) / self.sample_rate
        while True:
            out = np.zeros((batch_size, segment_len), np.float32)
            for i in range(batch_size):
                out[i] = self._segment(t)
            yield out


def make_source(spec: str, sample_rate: int, seed: int = 0):
    """'synthetic' or 'synthetic2'. (WAV directories, grain pipelines and
    pooled sources are not ported yet.)"""
    if spec == "synthetic":
        return SyntheticSource(sample_rate, seed)
    if spec == "synthetic2":
        return SyntheticSourceV2(sample_rate, seed)
    raise ValueError(
        f"data source {spec!r} is not ported yet; the port has 'synthetic' "
        "and 'synthetic2'"
    )
