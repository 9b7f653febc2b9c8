"""The port's C coder (`nsc_tpu_torch/native.py`: `native/bitpack.c` and
`native/entropy.c`, built by the port's own loader) against the port's
numpy coder and against `nsc_tpu.native`: byte-identical packed and
arithmetic-coded planes over random shapes, widths and symbol skews (as
`tests/unit/test_native_bitpack.py` and `test_native_entropy.py` hold the
reference's), cross-decodable both ways, the rescale path included. The
library is built into a temporary build directory, never next to the
sources."""

import numpy as np
import pytest

from nsc_tpu import bitstream as JB
from nsc_tpu import entropy as JE
from nsc_tpu import native as jnative
from nsc_tpu_torch import bitstream as B
from nsc_tpu_torch import entropy as E
from nsc_tpu_torch import native
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def temp_build(tmp_path_factory):
    """The port's library built afresh under a temporary `_build`."""
    saved = native.BUILD_DIR
    native.BUILD_DIR = tmp_path_factory.mktemp("native") / "_build"
    native.reset()
    yield native.BUILD_DIR
    native.BUILD_DIR = saved
    native.reset()


def test_builds_into_the_build_dir_not_beside_the_sources(temp_build):
    assert native.available(), native.unavailable_reason()
    path = native.library_path()
    assert path.exists() and temp_build in path.parents
    assert native.SOURCE_DIR not in path.parents
    assert not (native.SOURCE_DIR / native.LIB_NAME).exists()


def _frames(rng, bits):
    frames, n_q = rng.randint(1, 900), rng.randint(1, 17)
    return rng.randint(0, 2**bits, size=(frames, n_q)).astype(np.int32)


@pytest.mark.parametrize("bits", [1, 3, 4, 8, 10, 13, 16])
def test_pack_identical_to_numpy_and_to_nsc_tpu(bits):
    rng = np.random.RandomState(bits)
    for _ in range(4):
        idx = _frames(rng, bits)
        c = native.pack_frames(idx, bits)
        assert c == B.pack_frames_numpy(idx, bits)
        assert c == B.pack_frames(idx, bits)
        assert c == JB.pack_frames(idx, bits)
        if jnative.available():
            assert c == jnative.pack_frames(idx, bits)
        n, q = idx.shape
        np.testing.assert_array_equal(native.unpack_frames(c, n, q, bits), idx)
        np.testing.assert_array_equal(B.unpack_frames_numpy(c, n, q, bits), idx)
        np.testing.assert_array_equal(B.unpack_frames(c, n, q, bits), idx)


def test_bitstream_is_the_same_on_both_paths(monkeypatch):
    rng = np.random.RandomState(2)
    idx = rng.randint(0, 1024, size=(100, 4)).astype(np.int32)
    for flags in (0, B.FLAG_ENTROPY):
        h = B.BitstreamHeader("base", 10, 4, 16000, 320, 100, 32000, flags=flags)
        blob = B.serialize(h, idx)
        with monkeypatch.context() as m:
            m.setattr(native, "_load", lambda: None)
            assert not native.available()
            assert B.serialize(h, idx) == blob
            np.testing.assert_array_equal(B.deserialize(blob)[1], idx)
        np.testing.assert_array_equal(B.deserialize(blob)[1], idx)
    with pytest.raises(B.BitstreamError):
        B.pack_frames(np.array([[1024]], np.int32), 10)


def _planes(rng, k):
    return (rng.randint(0, k, rng.randint(1, 1500)).astype(np.int32),
            np.minimum(rng.zipf(1.4, 1500) - 1, k - 1).astype(np.int32),
            np.zeros(300, np.int32), np.arange(min(k, 200), dtype=np.int32) % k,
            np.zeros(0, np.int32))


@pytest.mark.parametrize("k", [2, 16, 256, 1024, 4096])
def test_arithmetic_coder_identical_to_numpy_and_to_nsc_tpu(k):
    rng = np.random.RandomState(k)
    for syms in _planes(rng, k):
        c = native.ac_encode_plane(syms, k, E.REBUILD, E.RESCALE_AT)
        assert c == E.encode_plane_numpy(syms, k), f"k={k} n={syms.size}"
        assert c == E.encode_plane(syms, k)
        assert c == JE.encode_plane(syms, k)
        np.testing.assert_array_equal(E.decode_plane_numpy(c, syms.size, k), syms)
        np.testing.assert_array_equal(
            native.ac_decode_plane(c, syms.size, k, E.REBUILD, E.RESCALE_AT), syms)
        np.testing.assert_array_equal(JE.decode_plane(c, syms.size, k), syms)


def test_arithmetic_coder_rescale_path(monkeypatch):
    monkeypatch.setattr(E, "RESCALE_AT", 4096)
    rng = np.random.RandomState(9)
    syms = np.minimum(rng.zipf(1.3, 3000) - 1, 63).astype(np.int32)
    c = E.encode_plane(syms, 64)
    assert c == E.encode_plane_numpy(syms, 64)
    np.testing.assert_array_equal(E.decode_plane(c, 3000, 64), syms)
    np.testing.assert_array_equal(E.decode_plane_numpy(c, 3000, 64), syms)


def test_frames_coder_identical_to_nsc_tpu():
    rng = np.random.RandomState(4)
    idx = np.minimum(rng.zipf(1.5, (400, 8)) - 1, 1023).astype(np.int32)
    payload = E.encode_frames(idx, 1024)
    assert payload == JE.encode_frames(idx, 1024)
    np.testing.assert_array_equal(E.decode_frames(payload, 400, 8, 1024), idx)


def test_unavailable_reason_names_the_failure(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "COMPILERS", ("no-such-compiler-here",))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    native.reset()
    try:
        assert not native.available()
        assert "no-such-compiler-here" in native.unavailable_reason()
        rng = np.random.RandomState(0)
        idx = _frames(rng, 10)
        assert B.pack_frames(idx, 10) == B.pack_frames_numpy(idx, 10)
    finally:
        native.reset()
