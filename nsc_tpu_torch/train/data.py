"""Training audio sources and the background batch assembly (the port's
copy of `nsc_tpu/train/data.py`).

Sources, each yielding (batch_size, segment_len) float32 batches:

  * `SyntheticSource` / `SyntheticSourceV2` ("synthetic", "synthetic2"):
    deterministic speech-like signals;
  * `PooledSource` (a ":pool=N" suffix): N pre-generated segments of another
    source, sampled with crop jitter, gain and polarity;
  * `WavDirectorySource` (a directory): every WAV under it decoded once into
    host memory, random crops;
  * `WavReaderSource` ("grain:<dir>"): the port's own on-demand reader in
    place of the JAX package's grain pipeline (the spec keeps its name, so
    one command line works in both packages): files decoded per item, a
    disjoint contiguous-stride shard of the file list, a deterministic
    shuffle per epoch.

Each draws from numpy `RandomState`s in the JAX package's order, so the
same seed gives bit-identical batches in both packages (the on-demand
reader has no counterpart order to match: grain's shuffle is grain's own).
`get_state` / `set_state` carry a source's position through a checkpoint
(generators, epoch and position; a pool is rebuilt from its seed or its
cache), so a resumed run continues the stream where it stopped.
`Prefetcher` assembles batches on a background thread; `batches_with_state`
pairs each batch with the state after it, so a consumer that runs ahead of
its checkpoints still saves the position of the last batch it used.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from nsc_tpu_torch.utils import audio, profiling


def _rng_state(rng: np.random.RandomState) -> dict:
    """A generator's position, as tensors and numbers (loadable with
    `torch.load(weights_only=True)`)."""
    name, keys, pos, has_gauss, gauss = rng.get_state()
    return {"name": name, "keys": torch.from_numpy(keys.astype(np.int64)),
            "pos": int(pos), "has_gauss": int(has_gauss), "gauss": float(gauss)}


def _set_rng_state(rng: np.random.RandomState, st: dict) -> None:
    rng.set_state((
        st["name"], st["keys"].numpy().astype(np.uint32), st["pos"],
        st["has_gauss"], st["gauss"],
    ))


class _Seeded:
    def __init__(self, sample_rate: int = 16_000, seed: int = 0):
        self.sample_rate = sample_rate
        self._rng = np.random.RandomState(seed)

    def get_state(self) -> dict:
        return _rng_state(self._rng)

    def set_state(self, st: dict) -> None:
        _set_rng_state(self._rng, st)


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


class PooledSource:
    """A finite pool of segments pre-generated from another source, served
    by sampling the pool with cheap augmentation: a random crop offset
    within MARGIN extra samples per segment, a gain of -6..6 dB and a
    polarity flip. Per-batch synthesis of `synthetic2` costs host time that
    the pool pays once; a finite pool is no less realistic than a corpus.

    `set_cache_dir(d)` caches the pool as .npy under `d` (the workdir), so a
    restart reloads it instead of synthesizing it again. The state is the
    sampler's generator; the pool comes back from its seed or its cache."""

    MARGIN = 1600  # 0.1 s of crop jitter at 16 kHz

    def __init__(self, inner, pool_size: int = 8192, seed: int = 0):
        self._inner = inner
        self._pool_size = int(pool_size)
        self._seed = int(seed)
        self._rng = np.random.RandomState(seed ^ 0x5EED)
        self._pool: Optional[np.ndarray] = None
        self._pool_seg_len = -1
        self._cache_dir: Optional[str] = None

    def set_cache_dir(self, d: str) -> None:
        self._cache_dir = d

    def get_state(self) -> dict:
        return {"sampler": _rng_state(self._rng)}

    def set_state(self, st: dict) -> None:
        _set_rng_state(self._rng, st["sampler"])

    def _build(self, segment_len: int) -> None:
        gen_len = segment_len + self.MARGIN
        cache = None
        if self._cache_dir:
            cache = os.path.join(
                self._cache_dir, f"pool_{self._pool_size}x{gen_len}_s{self._seed}.npy"
            )
            if os.path.exists(cache):
                pool = np.load(cache)
                if pool.shape == (self._pool_size, gen_len):
                    self._pool = pool.astype(np.float32, copy=False)
                    self._pool_seg_len = segment_len
                    return
        # whole batches of 64 from the inner source
        parts, have = [], 0
        it = self._inner.batches(64, gen_len)
        while have < self._pool_size:
            b = next(it)
            parts.append(b)
            have += b.shape[0]
        self._pool = np.concatenate(parts, axis=0)[: self._pool_size]
        self._pool_seg_len = segment_len
        if cache:
            os.makedirs(self._cache_dir, exist_ok=True)
            tmp = cache + ".tmp.npy"
            np.save(tmp, self._pool)
            os.replace(tmp, cache)

    def batches(self, batch_size: int, segment_len: int) -> Iterator[np.ndarray]:
        if self._pool is None or self._pool_seg_len != segment_len:
            self._build(segment_len)
        pool, rng = self._pool, self._rng
        n = pool.shape[0]
        while True:
            rows = rng.randint(0, n, size=batch_size)
            offs = rng.randint(0, self.MARGIN + 1, size=batch_size)
            gain = 10.0 ** (rng.uniform(-6, 6, size=batch_size) / 20.0)
            sign = rng.choice((-1.0, 1.0), size=batch_size)
            out = np.empty((batch_size, segment_len), np.float32)
            for i in range(batch_size):
                seg = pool[rows[i], offs[i] : offs[i] + segment_len]
                out[i] = seg * np.float32(gain[i] * sign[i])
            yield np.clip(out, -1, 1)


def wav_paths(root: str) -> List[str]:
    """Every .wav under `root`, recursively, in a fixed order (directories
    as os.walk visits them, files sorted)."""
    paths: List[str] = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.lower().endswith(".wav"):
                paths.append(os.path.join(dirpath, f))
    if not paths:
        raise FileNotFoundError(f"no .wav files under {root}")
    return paths


def _load_clip(path: str, sample_rate: int) -> np.ndarray:
    wav, _ = audio.load_wav(path, target_sr=sample_rate)
    return audio.to_mono(wav).astype(np.float32)


class WavDirectorySource(_Seeded):
    """Every WAV under `root` decoded once (resampled to `sample_rate`,
    averaged to mono) into host memory; batches of random crops, a clip
    shorter than the segment zero-padded at its end."""

    def __init__(self, root: str, sample_rate: int = 16_000, seed: int = 0,
                 max_files: Optional[int] = None):
        super().__init__(sample_rate, seed)
        paths = wav_paths(root)
        if max_files:
            paths = paths[:max_files]
        self._clips = [_load_clip(p, sample_rate) for p in paths]

    def batches(self, batch_size: int, segment_len: int) -> Iterator[np.ndarray]:
        n = len(self._clips)
        while True:
            out = np.zeros((batch_size, segment_len), np.float32)
            for i in range(batch_size):
                clip = self._clips[self._rng.randint(n)]
                if len(clip) <= segment_len:
                    out[i, : len(clip)] = clip
                else:
                    start = self._rng.randint(len(clip) - segment_len)
                    out[i] = clip[start : start + segment_len]
            yield out


class WavReaderSource:
    """WAVs decoded on demand, for corpora larger than host memory (the
    port's reader behind the "grain:<dir>" spec; it does not use grain).

    The file list is sharded by contiguous stride: shard i of n takes files
    i, i + n, ...; with more shards than files, shard i takes the one file
    i % len(files) (shards may share a file, never the whole corpus). Each
    epoch visits the shard's files in a permutation drawn from
    RandomState((seed + 104729 * (epoch + 1)) % 2**31); the item at global
    position idx = epoch * files + position is cropped with
    RandomState((seed + 7919 * idx) % 2**31), as the JAX package's grain
    pipeline crops its idx-th item. The state is (epoch, position). Without
    shard arguments the shard is (0, 1); the training loop's data
    parallelism gives rank r of W the shard (r, W)."""

    def __init__(self, root: str, sample_rate: int = 16_000, seed: int = 0,
                 shard_index: Optional[int] = None, shard_count: Optional[int] = None):
        self.sample_rate = sample_rate
        self._seed = seed
        paths = wav_paths(root)
        if (shard_index is None) != (shard_count is None):
            raise ValueError(
                "shard_index and shard_count must be provided together "
                f"(got index={shard_index}, count={shard_count})"
            )
        if shard_index is None:
            shard_index, shard_count = 0, 1
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard_index {shard_index} not in [0, {shard_count})")
        if shard_count > len(paths):
            self._paths = [paths[shard_index % len(paths)]]
        else:
            self._paths = paths[shard_index::shard_count]
        self._epoch, self._pos = 0, 0
        self._order_of = (-1, None)

    def get_state(self) -> dict:
        return {"epoch": self._epoch, "pos": self._pos}

    def set_state(self, st: dict) -> None:
        self._epoch, self._pos = int(st["epoch"]), int(st["pos"])

    def _order(self) -> np.ndarray:
        """The current epoch's file permutation (drawn once per epoch)."""
        if self._order_of[0] != self._epoch:
            self._order_of = (self._epoch, np.random.RandomState(
                (self._seed + 104729 * (self._epoch + 1)) % 2**31).permutation(len(self._paths)))
        return self._order_of[1]

    def _item(self, segment_len: int) -> np.ndarray:
        n = len(self._paths)
        idx = self._epoch * n + self._pos
        clip = _load_clip(self._paths[self._order()[self._pos]], self.sample_rate)
        self._pos += 1
        if self._pos == n:
            self._epoch, self._pos = self._epoch + 1, 0
        out = np.zeros(segment_len, np.float32)
        if len(clip) <= segment_len:
            out[: len(clip)] = clip
        else:
            rng = np.random.RandomState((self._seed + 7919 * idx) % 2**31)
            start = rng.randint(len(clip) - segment_len)
            out[:] = clip[start : start + segment_len]
        return out

    def batches(self, batch_size: int, segment_len: int) -> Iterator[np.ndarray]:
        while True:
            yield np.stack([self._item(segment_len) for _ in range(batch_size)])


def make_source(spec: str, sample_rate: int, seed: int = 0,
                shard: Optional[Tuple[int, int]] = None):
    """'synthetic', 'synthetic2', a directory of WAVs, or 'grain:<dir>' (the
    on-demand reader, which reads shard (index, count) of its file list
    when `shard` is given); a ':pool=N' suffix wraps the source in a
    `PooledSource` of N segments."""
    pool = 0
    if ":pool=" in spec:
        spec, _, arg = spec.partition(":pool=")
        pool = int(arg)
    if spec == "synthetic":
        src = SyntheticSource(sample_rate, seed)
    elif spec == "synthetic2":
        src = SyntheticSourceV2(sample_rate, seed)
    elif spec.startswith("grain:"):
        index, count = shard if shard is not None else (None, None)
        src = WavReaderSource(spec[len("grain:"):], sample_rate, seed,
                              shard_index=index, shard_count=count)
    else:
        src = WavDirectorySource(spec, sample_rate, seed)
    return PooledSource(src, pool_size=pool, seed=seed) if pool else src


def strip_pool(spec: str) -> str:
    """The spec without its ':pool=N' suffix: the source the pool draws from."""
    return spec.partition(":pool=")[0]


def batches_with_state(source, batch_size: int, segment_len: int) -> Iterator[Tuple[np.ndarray, dict]]:
    """(batch, the source's state after it): restoring that state resumes
    the stream at the batch after this one."""
    for batch in source.batches(batch_size, segment_len):
        yield batch, source.get_state()


class Prefetcher:
    """Runs a batch iterator on a background thread through a bounded
    queue, so synthesis, decoding and cropping overlap the device step. An
    exception of the iterator is raised again on the consumer's side;
    `close()` stops the thread. depth 2: one batch on its way to the device
    (the loop's one-step device prefetch), one being built."""

    _STOP = object()

    def __init__(self, it, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._done = False

        def worker():
            try:
                for item in it:
                    if self._done:
                        return
                    self._q.put(item)
            except BaseException as e:  # raised again in the consumer
                self._err = e
            finally:
                self._q.put(self._STOP)

        self._thread = threading.Thread(target=worker, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        with profiling.span("data.wait"):
            item = self._q.get()
        if item is self._STOP:
            self._q.put(self._STOP)  # later calls stop too
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self, timeout: float = 60.0) -> None:
        """Stop the worker: drain the queue so a blocked put returns, then
        wait (up to `timeout` s) for the item it is building."""
        self._done = True
        while self._thread.is_alive():
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            self._thread.join(timeout=0.05)
            timeout -= 0.05
            if timeout <= 0:
                break
