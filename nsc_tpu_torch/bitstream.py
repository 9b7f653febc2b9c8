"""Bitstream format: RVQ indices <-> bytes (the port's own copy of the JAX
package's `nsc_tpu/bitstream.py`; streams are byte-identical).

  header | book-0 plane | book-1 plane | ... | book-(n_q-1) plane

Planes are book-major and each plane is independently byte-aligned, so a
stored stream can be truncated to its first d planes to drop bitrate without
re-encoding.

Header (little-endian), 20 bytes + name:
  magic    4s  = b"NSC1"
  version  u8  = 1, or 2 when the header carries the fingerprint extension
  flags    u8  (FLAG_ENTROPY, FLAG_FINGERPRINT; unknown bits are rejected)
  name_len u8  + name bytes (config/model identity, ascii)
  bits     u8  bits per index (log2 codebook_size)
  n_q      u8  number of codebook planes present
  _pad     u8
  sample_rate u32
  hop      u16
  num_frames  u32
  orig_len    u32  original sample count (decode trims to this)
  [fingerprint u32]  only when flags & FLAG_FINGERPRINT: CRC-32 of the
      encoder's RVQ codebooks (api.codebook_fingerprint)

Index packing: MSB-first fixed-width bit-packing per plane, by the C
packer (`native/bitpack.c`, through `nsc_tpu_torch.native`) when it loads,
else with numpy packbits/unpackbits (`pack_frames_numpy`,
`unpack_frames_numpy`); the bytes are the same.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from nsc_tpu_torch import native

MAGIC = b"NSC1"
VERSION = 1
# Streams whose header carries the fingerprint extension (4 extra bytes after
# orig_len) are WRITTEN as version 2: a pre-fingerprint reader that only knows
# version 1 then fails cleanly with "unsupported version" instead of computing
# the payload offset 4 bytes short and silently unpacking shifted garbage.
# Readers here accept both versions and additionally reject any
# unknown flag bit, so future extensions also fail loudly.
VERSION_FINGERPRINT = 2
_SUPPORTED_VERSIONS = (1, 2)
_FIXED = struct.Struct("<BBBIHII")  # bits n_q pad sr hop frames orig_len


class BitstreamError(ValueError):
    pass


@dataclasses.dataclass(frozen=True)
class BitstreamHeader:
    model_name: str
    bits: int
    n_q: int
    sample_rate: int
    hop: int
    num_frames: int
    orig_len: int
    version: int = VERSION
    flags: int = 0
    fingerprint: int = 0  # u32 codebook CRC; meaningful iff FLAG_FINGERPRINT

    def to_bytes(self) -> bytes:
        name = self.model_name.encode("ascii")
        if len(name) > 255:
            raise BitstreamError("model name too long")
        version = self.version
        if self.flags & FLAG_FINGERPRINT:
            version = max(version, VERSION_FINGERPRINT)
        blob = (
            MAGIC
            + struct.pack("<BBB", version, self.flags, len(name))
            + name
            + _FIXED.pack(
                self.bits,
                self.n_q,
                0,
                self.sample_rate,
                self.hop,
                self.num_frames,
                self.orig_len,
            )
        )
        if self.flags & FLAG_FINGERPRINT:
            blob += struct.pack("<I", self.fingerprint & 0xFFFFFFFF)
        return blob

    @classmethod
    def from_bytes(cls, blob: bytes) -> tuple["BitstreamHeader", int]:
        """Parse; returns (header, payload_offset). Any malformed input —
        truncated header, non-ascii name, short fixed fields — raises
        BitstreamError (never a raw struct/decode error; fuzz-tested)."""
        if blob[:4] != MAGIC:
            raise BitstreamError("bad magic: not an NSC bitstream")
        if len(blob) < 7:
            raise BitstreamError("truncated header")
        version, flags, name_len = struct.unpack_from("<BBB", blob, 4)
        if version not in _SUPPORTED_VERSIONS:
            raise BitstreamError(f"unsupported bitstream version {version}")
        if flags & ~(FLAG_ENTROPY | FLAG_FINGERPRINT):
            raise BitstreamError(f"unknown bitstream flags 0x{flags:02x}")
        off = 7
        if len(blob) < off + name_len + _FIXED.size:
            raise BitstreamError("truncated header")
        try:
            name = blob[off : off + name_len].decode("ascii")
        except UnicodeDecodeError as e:
            raise BitstreamError(f"bad model name in header: {e}") from None
        off += name_len
        bits, n_q, _, sr, hop, frames, orig = _FIXED.unpack_from(blob, off)
        off += _FIXED.size
        fingerprint = 0
        if flags & FLAG_FINGERPRINT:
            if len(blob) < off + 4:
                raise BitstreamError("truncated header")
            (fingerprint,) = struct.unpack_from("<I", blob, off)
            off += 4
        return (
            cls(name, bits, n_q, sr, hop, frames, orig, version, flags,
                fingerprint),
            off,
        )


def plane_nbytes(num_frames: int, bits: int) -> int:
    return (num_frames * bits + 7) // 8


def pack_plane(indices: np.ndarray, bits: int) -> bytes:
    """(F,) ints -> MSB-first fixed-width packed bytes."""
    idx = np.asarray(indices, dtype=np.uint32)
    if idx.ndim != 1:
        raise BitstreamError("plane must be 1-D")
    if bits < 1 or bits > 32:
        raise BitstreamError(f"bits out of range: {bits}")
    if idx.size and int(idx.max()) >= (1 << bits):
        raise BitstreamError("index exceeds bit width")
    shifts = np.arange(bits - 1, -1, -1, dtype=np.uint32)
    bit_arr = ((idx[:, None] >> shifts[None, :]) & 1).astype(np.uint8)
    return np.packbits(bit_arr.reshape(-1)).tobytes()


def unpack_plane(payload: bytes, num_frames: int, bits: int) -> np.ndarray:
    need = plane_nbytes(num_frames, bits)
    if len(payload) < need:
        raise BitstreamError("truncated plane")
    bit_arr = np.unpackbits(np.frombuffer(payload[:need], np.uint8))
    bit_arr = bit_arr[: num_frames * bits].reshape(num_frames, bits)
    weights = (1 << np.arange(bits - 1, -1, -1, dtype=np.uint32))
    return (bit_arr.astype(np.uint32) * weights).sum(axis=1).astype(np.int32)


def _check_frames(idx: np.ndarray, bits: int) -> None:
    if idx.ndim != 2:
        raise BitstreamError("expected (frames, n_q)")
    if bits < 1 or bits > 32:
        raise BitstreamError(f"bits out of range: {bits}")
    if idx.size and (int(idx.min()) < 0 or int(idx.max()) >= (1 << bits)):
        raise BitstreamError("index exceeds bit width")


def pack_frames(indices: np.ndarray, bits: int) -> bytes:
    """(F, n_q) -> book-major byte-aligned planes (the C packer when it
    loads, else `pack_frames_numpy`)."""
    idx = np.asarray(indices)
    _check_frames(idx, bits)
    packed = native.pack_frames(idx, bits)
    return packed if packed is not None else pack_frames_numpy(idx, bits)


def pack_frames_numpy(indices: np.ndarray, bits: int) -> bytes:
    """`pack_frames` with numpy."""
    idx = np.asarray(indices)
    _check_frames(idx, bits)
    return b"".join(pack_plane(idx[:, q], bits) for q in range(idx.shape[1]))


def unpack_frames(
    payload: bytes, num_frames: int, n_q: int, bits: int
) -> np.ndarray:
    """Inverse of pack_frames -> (F, n_q) int32. Accepts a payload holding at
    least n_q planes (extra trailing planes/bytes ignored — truncation rule)."""
    per = plane_nbytes(num_frames, bits)
    if len(payload) < n_q * per:
        raise BitstreamError("truncated plane")
    idx = native.unpack_frames(payload, num_frames, n_q, bits)
    return idx if idx is not None else unpack_frames_numpy(payload, num_frames, n_q, bits)


def unpack_frames_numpy(payload: bytes, num_frames: int, n_q: int, bits: int) -> np.ndarray:
    """`unpack_frames` with numpy."""
    per = plane_nbytes(num_frames, bits)
    if len(payload) < n_q * per:
        raise BitstreamError("truncated plane")
    planes = []
    for q in range(n_q):
        planes.append(unpack_plane(payload[q * per : (q + 1) * per], num_frames, bits))
    return np.stack(planes, axis=1)


FLAG_ENTROPY = 0x1  # planes are arithmetic-coded (nsc_tpu_torch/entropy.py)
FLAG_FINGERPRINT = 0x2  # header carries a u32 codebook CRC after orig_len


def serialize(header: BitstreamHeader, indices: np.ndarray) -> bytes:
    """Full stream: header + planes. indices: (F, n_q). If
    header.flags & FLAG_ENTROPY, planes are adaptively arithmetic-coded
    (smaller for trained/skewed codebooks) instead of fixed-width packed."""
    idx = np.asarray(indices)
    if idx.shape != (header.num_frames, header.n_q):
        raise BitstreamError(
            f"indices {idx.shape} != header ({header.num_frames}, {header.n_q})"
        )
    if header.flags & FLAG_ENTROPY:
        from nsc_tpu_torch import entropy

        return header.to_bytes() + entropy.encode_frames(idx, 1 << header.bits)
    return header.to_bytes() + pack_frames(idx, header.bits)


def deserialize(
    blob: bytes, max_n_q: int | None = None
) -> tuple[BitstreamHeader, np.ndarray]:
    """Full stream -> (header, (F, n_q') indices). If the payload was
    truncated to fewer planes than the header claims (bitrate truncation),
    returns the planes actually present; `max_n_q` further caps depth."""
    header, off = BitstreamHeader.from_bytes(blob)
    # structural sanity before any decode work: every writer in this package
    # sets num_frames == ceil(orig_len / hop) exactly, so a mismatch means a
    # corrupt header — without this, a corrupted num_frames (u32) would send
    # the arithmetic decoder off to decode billions of symbols
    if not (1 <= header.bits <= 16):
        raise BitstreamError(f"bits out of range: {header.bits}")
    if header.hop < 1 or header.sample_rate < 1 or header.n_q < 1:
        raise BitstreamError("corrupt header field")
    if header.num_frames != -(-header.orig_len // header.hop):
        raise BitstreamError(
            "inconsistent header: num_frames does not match orig_len/hop"
        )
    if header.flags & FLAG_ENTROPY:
        from nsc_tpu_torch import entropy

        n_q = entropy.count_planes(blob[off:], header.n_q)
        if max_n_q is not None:
            n_q = min(n_q, max_n_q)
        if n_q < 1:
            raise BitstreamError("no complete codebook plane in payload")
        return header, entropy.decode_frames(
            blob[off:], header.num_frames, n_q, 1 << header.bits
        )
    per = plane_nbytes(header.num_frames, header.bits)
    avail = (len(blob) - off) // per if per else 0
    n_q = min(header.n_q, avail)
    if max_n_q is not None:
        n_q = min(n_q, max_n_q)
    if n_q < 1:
        raise BitstreamError("no complete codebook plane in payload")
    return header, unpack_frames(blob[off:], header.num_frames, n_q, header.bits)


def truncate(blob: bytes, n_q: int) -> bytes:
    """Drop fine codebook planes from a serialized stream (bandwidth
    scalability at the byte level) — rewrites the header's n_q."""
    header, off = BitstreamHeader.from_bytes(blob)
    if n_q < 1 or n_q > header.n_q:
        raise BitstreamError(f"cannot truncate to {n_q} of {header.n_q} planes")
    new_header = dataclasses.replace(header, n_q=n_q)
    if header.flags & FLAG_ENTROPY:
        end = 0
        for _ in range(n_q):
            # bounds-check each section: a blob already truncated mid-plane
            # must raise, not yield a garbage end offset
            if off + end + 4 > len(blob):
                raise BitstreamError(
                    f"payload holds fewer than {n_q} complete entropy planes"
                )
            ln = int.from_bytes(blob[off + end : off + end + 4], "little")
            if off + end + 4 + ln > len(blob):
                raise BitstreamError(
                    f"payload holds fewer than {n_q} complete entropy planes"
                )
            end += 4 + ln
        return new_header.to_bytes() + blob[off : off + end]
    per = plane_nbytes(header.num_frames, header.bits)
    if len(blob) < off + n_q * per:
        raise BitstreamError(
            f"payload holds fewer than {n_q} complete planes"
        )
    return new_header.to_bytes() + blob[off : off + n_q * per]
