"""Adaptive arithmetic coding of RVQ index planes (the port's own copy of
the JAX package's `nsc_tpu/entropy.py`; coded bytes are identical).

`encode_plane` / `decode_plane` run the C coder (`native/entropy.c`,
through `nsc_tpu_torch.native`) when it loads, else the Python path below
(`encode_plane_numpy` / `decode_plane_numpy`), which is the specification:
the two give the same bytes (`tests/test_torch_native.py`).

Coder: CACM87-style 32-bit arithmetic coder with an adaptive per-plane
frequency model. The model starts uniform (Laplace +1 counts) and adds each
coded symbol; the cumulative table is rebuilt every REBUILD symbols (numpy
cumsum), so encode/decode stay deterministic.

Stream framing is handled by nsc_tpu_torch.bitstream (flags bit 0 =
entropy-coded; each plane is a u32 length + coded bytes). Coding is
per-plane, so bitrate truncation by dropping trailing planes still works.
"""

from __future__ import annotations

import numpy as np

from nsc_tpu_torch import native

_FULL = 0xFFFFFFFF
_HALF = 0x80000000
_Q1 = 0x40000000
_Q3 = 0xC0000000
REBUILD = 64
# The 32-bit coder needs total <= span at all times (span >= _Q1 after
# renormalization), so counts are halved when their sum crosses this; the
# rescale happens at rebuild points only, identically on encode and decode.
RESCALE_AT = 1 << 29


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self._acc = 0
        self._n = 0

    def bit(self, b: int):
        self._acc = (self._acc << 1) | b
        self._n += 1
        if self._n == 8:
            self.out.append(self._acc)
            self._acc = 0
            self._n = 0

    def bit_plus_pending(self, b: int, pending: int):
        self.bit(b)
        inv = b ^ 1
        for _ in range(pending):
            self.bit(inv)

    def finish(self) -> bytes:
        while self._n:
            self.bit(0)
        return bytes(self.out)


class _BitReader:
    def __init__(self, data: bytes):
        self._data = data
        self._pos = 0
        self._acc = 0
        self._n = 0

    def bit(self) -> int:
        if self._n == 0:
            if self._pos < len(self._data):
                self._acc = self._data[self._pos]
                self._pos += 1
            else:
                self._acc = 0  # implicit trailing zeros
            self._n = 8
        self._n -= 1
        return (self._acc >> self._n) & 1


class _AdaptiveModel:
    """Counts with periodically-rebuilt cumulative table (deterministic)."""

    def __init__(self, k: int):
        self.counts = np.ones(k, np.int64)
        self._pending = 0
        self._rebuild()

    def _rebuild(self):
        self.cum = np.zeros(len(self.counts) + 1, np.int64)
        np.cumsum(self.counts, out=self.cum[1:])
        self.total = int(self.cum[-1])

    def interval(self, s: int):
        return int(self.cum[s]), int(self.cum[s + 1]), self.total

    def find(self, value: int) -> int:
        # largest s with cum[s] <= value
        return int(np.searchsorted(self.cum, value, side="right")) - 1

    def update(self, s: int):
        self.counts[s] += 32  # fast adaptation for short planes
        self._pending += 1
        if self._pending >= REBUILD:
            self._pending = 0
            if int(self.counts.sum()) > RESCALE_AT:
                # halve (ceil) so every count stays >= 1; keeps total well
                # under the coder's total<=span invariant for any plane length
                self.counts = (self.counts + 1) >> 1
            self._rebuild()


def encode_plane(symbols: np.ndarray, k: int) -> bytes:
    """(F,) ints in [0, k) -> arithmetic-coded bytes (the C coder when it
    loads, else `encode_plane_numpy`)."""
    syms = np.asarray(symbols, np.int64)
    if syms.size and (syms.min() < 0 or syms.max() >= k):
        raise ValueError("symbol out of range")
    coded = native.ac_encode_plane(syms, k, REBUILD, RESCALE_AT)
    return coded if coded is not None else encode_plane_numpy(syms, k)


def encode_plane_numpy(symbols: np.ndarray, k: int) -> bytes:
    """`encode_plane` on the Python path."""
    syms = np.asarray(symbols, np.int64)
    if syms.size and (syms.min() < 0 or syms.max() >= k):
        raise ValueError("symbol out of range")
    model = _AdaptiveModel(k)
    w = _BitWriter()
    low, high, pending = 0, _FULL, 0
    for s in syms:
        c_lo, c_hi, tot = model.interval(int(s))
        span = high - low + 1
        high = low + span * c_hi // tot - 1
        low = low + span * c_lo // tot
        while True:
            if high < _HALF:
                w.bit_plus_pending(0, pending)
                pending = 0
            elif low >= _HALF:
                w.bit_plus_pending(1, pending)
                pending = 0
                low -= _HALF
                high -= _HALF
            elif low >= _Q1 and high < _Q3:
                pending += 1
                low -= _Q1
                high -= _Q1
            else:
                break
            low = low * 2
            high = high * 2 + 1
        model.update(int(s))
    # flush
    pending += 1
    if low < _Q1:
        w.bit_plus_pending(0, pending)
    else:
        w.bit_plus_pending(1, pending)
    return w.finish()


def decode_plane(data: bytes, n: int, k: int) -> np.ndarray:
    """Inverse of encode_plane: coded bytes -> (n,) int32 symbols (the C
    coder when it loads, else `decode_plane_numpy`)."""
    out = native.ac_decode_plane(data, n, k, REBUILD, RESCALE_AT)
    return out if out is not None else decode_plane_numpy(data, n, k)


def decode_plane_numpy(data: bytes, n: int, k: int) -> np.ndarray:
    """`decode_plane` on the Python path."""
    model = _AdaptiveModel(k)
    r = _BitReader(data)
    low, high = 0, _FULL
    value = 0
    for _ in range(32):
        value = (value << 1) | r.bit()
    out = np.empty(n, np.int32)
    for i in range(n):
        span = high - low + 1
        tot = model.total
        scaled = ((value - low + 1) * tot - 1) // span
        s = model.find(scaled)
        c_lo, c_hi, _ = model.interval(s)
        high = low + span * c_hi // tot - 1
        low = low + span * c_lo // tot
        while True:
            if high < _HALF:
                pass
            elif low >= _HALF:
                low -= _HALF
                high -= _HALF
                value -= _HALF
            elif low >= _Q1 and high < _Q3:
                low -= _Q1
                high -= _Q1
                value -= _Q1
            else:
                break
            low = low * 2
            high = high * 2 + 1
            value = value * 2 + r.bit()
        out[i] = s
        model.update(s)
    return out


def encode_frames(indices: np.ndarray, k: int) -> bytes:
    """(F, n_q) -> concatenated per-plane sections (u32 length + bytes);
    trailing planes can be dropped for bitrate truncation."""
    idx = np.asarray(indices)
    parts = []
    for q in range(idx.shape[1]):
        coded = encode_plane(idx[:, q], k)
        parts.append(len(coded).to_bytes(4, "little") + coded)
    return b"".join(parts)


def decode_frames(payload: bytes, num_frames: int, n_q: int, k: int) -> np.ndarray:
    planes = []
    off = 0
    for _ in range(n_q):
        if off + 4 > len(payload):
            break
        ln = int.from_bytes(payload[off : off + 4], "little")
        off += 4
        if off + ln > len(payload):
            break
        planes.append(decode_plane(payload[off : off + ln], num_frames, k))
        off += ln
    if not planes:
        raise ValueError("no complete entropy-coded plane in payload")
    return np.stack(planes, axis=1)


def count_planes(payload: bytes, n_q_max: int) -> int:
    """How many complete coded planes the payload holds (truncation rule)."""
    off, n = 0, 0
    while n < n_q_max and off + 4 <= len(payload):
        ln = int.from_bytes(payload[off : off + 4], "little")
        if off + 4 + ln > len(payload):
            break
        off += 4 + ln
        n += 1
    return n
