"""The port's training data sources (`nsc_tpu_torch.train.data`) against the
JAX package's (`nsc_tpu.train.data`): the pooled source and the WAV
directory give bit-identical batches on the same seed (tolerance: none, the
same numpy draws in the same order) and resume from `get_state`/
`set_state`; the on-demand reader (the port's own, in place of grain) keeps
the contracts of `tests/unit/test_data.py`; the prefetcher delivers,
raises its worker's error and closes.
"""

import os

import numpy as np
import pytest

from nsc_tpu.train import data as JD
from nsc_tpu_torch.train import data as D
from nsc_tpu_torch.utils import audio
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


@pytest.fixture()
def wav_dir(tmp_path):
    """Five mono 16 kHz files, one at 22.05 kHz and one in stereo."""
    for i in range(5):
        audio.save_wav(str(tmp_path / f"{i}.wav"),
                       np.random.RandomState(i).randn(8000).astype(np.float32) * 0.1, 16_000)
    audio.save_wav(str(tmp_path / "sr22050.wav"),
                   np.random.RandomState(5).randn(11025).astype(np.float32) * 0.1, 22_050)
    sub = tmp_path / "sub"
    sub.mkdir()
    audio.save_wav(str(sub / "stereo.wav"),
                   np.random.RandomState(6).randn(7000, 2).astype(np.float32) * 0.1, 16_000)
    return str(tmp_path)


def _resumes(make, batch, seg):
    """Three batches of a fresh source; a new source of the same seed (as a
    resumed run makes it) set to the first's state after batch 1 continues
    with batches 2 and 3, where without the state it starts over."""
    src = make(seed=3)
    it = src.batches(batch, seg)
    first = next(it)
    st = src.get_state()
    rest = [next(it), next(it)]
    np.testing.assert_array_equal(next(make(seed=3).batches(batch, seg)), first)
    other = make(seed=3)
    other.set_state(st)
    it2 = other.batches(batch, seg)
    for want in rest:
        np.testing.assert_array_equal(next(it2), want)
    assert not np.array_equal(rest[0], first)


def test_pooled_source_matches_jax_and_resumes():
    spec = "synthetic:pool=32"
    src = D.make_source(spec, 16_000, seed=9)
    ref = JD.make_source(spec, 16_000, seed=9)
    assert isinstance(src, D.PooledSource) and isinstance(ref, JD.PooledSource)
    got, want = src.batches(4, 1600), ref.batches(4, 1600)
    for _ in range(3):
        a, b = next(got), next(want)
        assert a.dtype == np.float32 and a.shape == (4, 1600)
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(src._pool, ref._pool)
    _resumes(lambda seed: D.make_source(spec, 16_000, seed), 4, 1600)


def test_pooled_source_disk_cache_roundtrip(tmp_path):
    src = D.make_source("synthetic:pool=8", 16_000, seed=2)
    src.set_cache_dir(str(tmp_path))
    b1 = next(src.batches(2, 800))
    files = [f for f in os.listdir(tmp_path) if f.endswith(".npy")]
    assert files == [f"pool_8x{800 + D.PooledSource.MARGIN}_s2.npy"]
    pool = np.load(tmp_path / files[0])
    # a fresh source loads the pool: change the cached pool and see it served
    np.save(tmp_path / files[0], pool * 0.5)
    src2 = D.make_source("synthetic:pool=8", 16_000, seed=2)
    src2.set_cache_dir(str(tmp_path))
    b2 = next(src2.batches(2, 800))
    np.testing.assert_array_equal(src2._pool, pool * 0.5)
    np.testing.assert_array_equal(b2, np.clip(b1 * np.float32(0.5), -1, 1))


def test_wav_directory_source_matches_jax_and_resumes(wav_dir):
    src = D.make_source(wav_dir, 16_000, seed=4)
    ref = JD.make_source(wav_dir, 16_000, seed=4)
    assert isinstance(src, D.WavDirectorySource)
    assert len(src._clips) == len(ref._clips) == 7
    for a, b in zip(src._clips, ref._clips):
        np.testing.assert_array_equal(a, b)
    got, want = src.batches(3, 9000), ref.batches(3, 9000)  # longer than some clips
    for _ in range(3):
        np.testing.assert_array_equal(next(got), next(want))
    _resumes(lambda seed: D.WavDirectorySource(wav_dir, 16_000, seed), 3, 4000)
    # a pooled WAV directory matches too
    p, q = D.make_source(wav_dir + ":pool=4", 16_000, 1), JD.make_source(wav_dir + ":pool=4", 16_000, 1)
    np.testing.assert_array_equal(next(p.batches(2, 3000)), next(q.batches(2, 3000)))


def test_wav_directory_source(tmp_path):
    """Port of tests/integration/test_training.py::test_wav_directory_source."""
    for i in range(3):
        audio.save_wav(str(tmp_path / f"{i}.wav"),
                       np.random.RandomState(i).randn(5000).astype(np.float32) * 0.1, 16000)
    src = D.WavDirectorySource(str(tmp_path), 16000)
    b = next(src.batches(2, 1000))
    assert b.shape == (2, 1000)


def test_missing_or_empty_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        D.make_source(str(tmp_path / "absent"), 16_000)
    with pytest.raises(FileNotFoundError):
        D.make_source("grain:" + str(tmp_path), 16_000)


def test_reader_batches_determinism_and_resume(wav_dir):
    src = D.make_source("grain:" + wav_dir, 16_000, seed=3)
    assert isinstance(src, D.WavReaderSource)
    it = src.batches(4, 3200)
    b1, b2 = next(it), next(it)
    assert b1.shape == (4, 3200) and b1.dtype == np.float32 and np.isfinite(b1).all()
    assert not np.allclose(b1, b2)  # the stream advances
    np.testing.assert_array_equal(next(D.make_source("grain:" + wav_dir, 16_000, 3)
                                       .batches(4, 3200)), b1)
    assert not np.array_equal(next(D.make_source("grain:" + wav_dir, 16_000, 4)
                                   .batches(4, 3200)), b1)
    assert src.get_state() == {"epoch": 1, "pos": 1}  # 8 items of 7 files
    _resumes(lambda seed: D.WavReaderSource(wav_dir, 16_000, seed), 3, 2000)


def test_reader_item_order_and_crops(wav_dir):
    """Each epoch is a permutation of the shard's files; item idx is cropped
    with RandomState((seed + 7919 * idx) % 2**31)."""
    seed, seg = 11, 4000
    src = D.WavReaderSource(wav_dir, 16_000, seed)
    paths = src._paths
    clips = {p: D._load_clip(p, 16_000) for p in paths}
    items = np.concatenate([next(src.batches(7, seg)) for _ in range(2)])
    for epoch in range(2):
        order = np.random.RandomState((seed + 104729 * (epoch + 1)) % 2**31).permutation(7)
        for pos in range(7):
            idx = epoch * 7 + pos
            clip = clips[paths[order[pos]]]
            want = np.zeros(seg, np.float32)
            if len(clip) <= seg:
                want[: len(clip)] = clip
            else:
                start = np.random.RandomState((seed + 7919 * idx) % 2**31).randint(len(clip) - seg)
                want = clip[start : start + seg]
            np.testing.assert_array_equal(items[idx], want)


def test_reader_shards_files(wav_dir):
    s0 = D.WavReaderSource(wav_dir, 16_000, shard_index=0, shard_count=2)
    s1 = D.WavReaderSource(wav_dir, 16_000, shard_index=1, shard_count=2)
    assert set(s0._paths).isdisjoint(s1._paths)
    assert sorted(s0._paths + s1._paths) == sorted(D.wav_paths(wav_dir))
    assert s0._paths == D.wav_paths(wav_dir)[0::2]
    assert D.WavReaderSource(wav_dir, 16_000)._paths == D.wav_paths(wav_dir)


def test_reader_shard_validation(wav_dir):
    """The shard arguments come together and in range; with more shards than
    files each shard takes one file, round robin, never the whole corpus."""
    with pytest.raises(ValueError, match="together"):
        D.WavReaderSource(wav_dir, 16_000, shard_index=1)
    with pytest.raises(ValueError, match="together"):
        D.WavReaderSource(wav_dir, 16_000, shard_count=2)
    with pytest.raises(ValueError, match="not in"):
        D.WavReaderSource(wav_dir, 16_000, shard_index=2, shard_count=2)
    shards = [D.WavReaderSource(wav_dir, 16_000, shard_index=i, shard_count=9)._paths
              for i in range(9)]
    assert all(len(s) == 1 for s in shards)
    assert shards[0] != shards[1]
    assert shards[7] == shards[0]  # wraps: 7 % 7 == 0


def test_prefetcher_passthrough_and_close():
    pf = D.Prefetcher(iter([np.ones(2), np.zeros(2)]))
    got = [next(pf), next(pf)]
    assert np.allclose(got[0], 1) and np.allclose(got[1], 0)
    with pytest.raises(StopIteration):
        next(pf)
    with pytest.raises(StopIteration):
        next(pf)
    pf.close()
    assert not pf._thread.is_alive()


def test_prefetcher_surfaces_worker_error():
    def bad():
        yield np.ones(2)
        raise RuntimeError("decode failed")

    pf = D.Prefetcher(bad())
    next(pf)
    with pytest.raises(RuntimeError, match="decode failed"):
        next(pf)


def test_prefetcher_delivers_and_propagates_errors():
    """Port of tests/integration/test_training.py::
    test_prefetcher_delivers_and_propagates_errors; close() also stops a
    worker of an endless source."""
    pf = D.Prefetcher(D.SyntheticSource(16000, 0).batches(2, 800), depth=2)
    a, b = next(pf), next(pf)
    assert a.shape == b.shape == (2, 800)
    assert not np.array_equal(a, b)
    pf.close()
    assert not pf._thread.is_alive()

    def boom():
        yield np.zeros((1, 8), np.float32)
        raise RuntimeError("loader exploded")

    pf2 = D.Prefetcher(boom())
    next(pf2)
    with pytest.raises(RuntimeError, match="exploded"):
        next(pf2)


@pytest.mark.parametrize("spec", ["synthetic2:pool=16", "dir", "grain:dir"])
def test_state_travels_with_the_batch(spec, wav_dir):
    """Through the prefetcher the source runs ahead of the consumer; the
    state paired with batch k still resumes the stream at batch k + 1."""
    spec = spec.replace("dir", wav_dir)
    src = D.make_source(spec, 16_000, 5)
    pf = D.Prefetcher(D.batches_with_state(src, 2, 1600))
    items = [next(pf) for _ in range(4)]
    pf.close()
    other = D.make_source(spec, 16_000, 5)
    other.set_state(items[1][1])
    it = other.batches(2, 1600)
    for batch, _ in items[2:]:
        np.testing.assert_array_equal(next(it), batch)
