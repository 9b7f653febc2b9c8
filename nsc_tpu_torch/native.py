"""The C bit-packer and arithmetic coder (`native/bitpack.c`,
`native/entropy.c` at the repo root), built and bound with ctypes: the
port's own loader (counterpart of `nsc_tpu/native.py`).

The sources are compiled with the system's `cc` (else `gcc`, `clang`) on the
first call in a process, never on import, into
`nsc_tpu_torch/_build/native-<hash of the sources>/libnsc_native.so`, and a
library already built from the same sources is reused. `bitstream.py` and
`entropy.py` take the C path whenever the library loads and their numpy
path otherwise, with byte-identical output; `available()` says which one is
active, and `unavailable_reason()` why the C path is not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE_DIR = Path(__file__).resolve().parent.parent / "native"
SOURCES = ("bitpack.c", "entropy.c")
BUILD_DIR = Path(__file__).resolve().parent / "_build"
COMPILERS = ("cc", "gcc", "clang")
FLAGS = ["-O3", "-shared", "-fPIC"]
LIB_NAME = "libnsc_native.so"

_L, _I, _P = ctypes.c_long, ctypes.c_int, ctypes.c_void_p
SIGNATURES = {
    # idx (frames, n_q) int32, frames, n_q, bits, out -> bytes written or < 0
    "nsc_pack_frames": (_L, [_P, _L, _I, _I, _P]),
    # payload, payload bytes, frames, n_q, bits, idx -> 0 or < 0
    "nsc_unpack_frames": (_L, [_P, _L, _L, _I, _I, _P]),
    # symbols, n, k, rebuild, rescale_at, out, out capacity -> bytes or < 0
    "nsc_ac_encode_plane": (_L, [_P, _L, _I, _L, _L, _P, _L]),
    # data, bytes, n, k, rebuild, rescale_at, out -> 0 or < 0
    "nsc_ac_decode_plane": (_L, [_P, _L, _L, _I, _L, _L, _P]),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_reason: Optional[str] = None


def library_path() -> Path:
    """Where the library of the current sources is (or will be) built."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in SOURCES:
        h.update((SOURCE_DIR / name).read_bytes())
    return BUILD_DIR / f"native-{h.hexdigest()[:16]}" / LIB_NAME


def _build(out: Path) -> None:
    """Compile the sources into `out` (atomically: a temporary file renamed)."""
    srcs = [str(SOURCE_DIR / name) for name in SOURCES]
    out.parent.mkdir(parents=True, exist_ok=True)
    errors = []
    for cc in COMPILERS:
        if shutil.which(cc) is None:
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        try:
            subprocess.run([cc, *FLAGS, "-o", tmp, *srcs], check=True, capture_output=True,
                           text=True, timeout=120)
            os.replace(tmp, out)
            return
        except (OSError, subprocess.SubprocessError) as e:
            errors.append(f"{cc}: {getattr(e, 'stderr', '') or e}")
            if os.path.exists(tmp):
                os.remove(tmp)
    raise RuntimeError("no C compiler built the native coder: " + ("; ".join(errors) or
                       f"none of {COMPILERS} found"))


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _reason
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            path = library_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, (restype, argtypes) in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype, fn.argtypes = restype, argtypes
            _lib = lib
        except (OSError, RuntimeError, AttributeError) as e:
            _reason = str(e)
        return _lib


def reset() -> None:
    """Forget the loaded library (the next call builds or loads it again,
    from `BUILD_DIR` as it is then)."""
    global _lib, _tried, _reason
    with _lock:
        _lib, _tried, _reason = None, False, None


def available() -> bool:
    """True when the C coder is the active path."""
    return _load() is not None


def unavailable_reason() -> Optional[str]:
    """Why the C coder did not load (None when it did)."""
    _load()
    return _reason


def pack_frames(indices: np.ndarray, bits: int) -> Optional[bytes]:
    """(frames, n_q) -> book-major byte-aligned planes; None without the
    library (the caller takes its numpy path)."""
    lib = _load()
    if lib is None:
        return None
    idx = np.ascontiguousarray(indices, dtype=np.int32)
    frames, n_q = idx.shape
    out = np.empty(n_q * ((frames * bits + 7) // 8), np.uint8)
    if lib.nsc_pack_frames(idx.ctypes.data, frames, n_q, bits, out.ctypes.data) < 0:
        return None
    return out.tobytes()


def unpack_frames(payload: bytes, num_frames: int, n_q: int, bits: int) -> Optional[np.ndarray]:
    """Inverse of `pack_frames` -> (frames, n_q) int32, or None."""
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(payload, np.uint8)
    idx = np.empty((num_frames, n_q), np.int32)
    if lib.nsc_unpack_frames(buf.ctypes.data, len(buf), num_frames, n_q, bits,
                             idx.ctypes.data) < 0:
        return None
    return idx


def ac_encode_plane(symbols: np.ndarray, k: int, rebuild: int, rescale_at: int) -> Optional[bytes]:
    """Adaptive arithmetic coding of one plane (the bytes of
    `entropy.encode_plane`'s numpy path), or None."""
    lib = _load()
    if lib is None:
        return None
    syms = np.ascontiguousarray(symbols, dtype=np.int32)
    # the coded size exceeds the fixed-width bound only by the model's
    # adaptation overhead: 4 bytes a symbol and some slack is ample
    out = np.empty(syms.size * 4 + 64, np.uint8)
    n = lib.nsc_ac_encode_plane(syms.ctypes.data, syms.size, k, rebuild, rescale_at,
                                out.ctypes.data, out.size)
    if n < 0:
        return None
    return out[:n].tobytes()


def ac_decode_plane(data: bytes, n: int, k: int, rebuild: int, rescale_at: int) -> Optional[np.ndarray]:
    """Inverse of `ac_encode_plane` -> (n,) int32, or None."""
    lib = _load()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(n, np.int32)
    if lib.nsc_ac_decode_plane(buf.ctypes.data, buf.size, n, k, rebuild, rescale_at,
                               out.ctypes.data) < 0:
        return None
    return out
