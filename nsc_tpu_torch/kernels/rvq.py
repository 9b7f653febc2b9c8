"""Residual vector quantizer search and sum: the CUDA kernels in
`csrc/rvq.cu`, their plain PyTorch versions, and the wrappers.

quantize: for each frame, over the books in order, pick
    argmin_k  ||c_k||^2 - 2 r.c_k     (float32, lowest index on ties)
and subtract the chosen codeword from the residual r (the last book's update
is skipped: nothing reads it). `||c||^2` is computed once per call, by the
wrapper, and the score is two separately rounded operations on it and on
the dot product. The kernel takes the dot on the tensor cores: the wrapper
splits the codebooks into exact bf16 planes hi + mid + lo (once per call,
with a small split kernel; `codebook_planes` is its plain version), the
kernel splits each book's residuals the same way, and six of the nine
plane products (lo.hi, hi.lo, mid.mid, mid.hi, hi.mid, hi.hi, smallest
first) are accumulated in float32. Those scores only shortlist: they
differ from the float32 ones by the summation order, the tensor cores'
accumulation and the three dropped products, by up to a few ulps on raw
trained latents. The best code of each of 16 subsets of the book (a
thread's even or odd codes) goes on a list, the frame's two best of the
list are scored again from the exact float32 residual (the dot and
||c||^2 - 2 dot in float64, rounded once to float32), and the frame takes
the lowest of those, lowest index on ties. It takes every width:
padded widths up to RESIDENT_DIM keep the tile's residual planes in shared
memory, wider ones stream them from a scratch in device memory that the
wrapper allocates (`quantize_plan`).

dequantize: sum the chosen codewords in book order, 0 + c_0 + c_1 + ...,
in float32 (bit-exact with the JAX package's scan and Pallas kernel); an
index outside [0, K) adds nothing, as in the Pallas kernel's one-hot product.
"""

from __future__ import annotations

import torch

from nsc_tpu_torch import kernels
from nsc_tpu_torch.kernels.residual_stack import split_planes

# The quantize kernel's tiling (csrc/rvq.cu): frames per block tile, codes
# per chunk (K is padded to it with zero planes, and padded codes are never
# scored) and the dims a plane row is padded to.
TILE_M = 128
CODE_TILE = 128
DIM_ALIGN = 16
# The kernel's two launch plans (csrc/rvq.cu), chosen by the padded width
# Dp: up to RESIDENT_DIM the three bf16 residual planes of the 128-frame
# tile stay in shared memory beside the stages of code planes ("resident");
# above it each stage also carries the tile's residual planes of its dims,
# copied from a slot of 3 x TILE_M x Dp bf16 per block in device memory that
# the wrapper allocates ("streamed").
RESIDENT_DIM = 128
# The kernel packs two code indices into one 32-bit word.
MAX_CODES = 65536


def codeword_sq_norms(codebooks: torch.Tensor) -> torch.Tensor:
    """(n_q, K, D) float32 -> (n_q, K) ||c||^2."""
    return torch.sum(codebooks * codebooks, dim=-1)


def quantize_plain(codebooks: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """codebooks (n_q, K, D) f32, z (M, D) f32 -> (M, n_q) int32."""
    csq = codeword_sq_norms(codebooks)
    r = z
    out = []
    for q in range(codebooks.shape[0]):
        cb = codebooks[q]
        scores = csq[q][None, :] - 2.0 * (r @ cb.t())
        idx = torch.argmin(scores, dim=-1)  # first (lowest) index on ties
        out.append(idx)
        if q + 1 < codebooks.shape[0]:
            r = r - cb[idx]
    return torch.stack(out, dim=-1).to(torch.int32)


def dequantize_plain(codebooks: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """codebooks (n_q, K, D) f32, idx (M, n_q) int -> (M, D) f32. An index
    outside [0, K) adds nothing."""
    k = codebooks.shape[1]
    acc = torch.zeros(
        idx.shape[0], codebooks.shape[-1], dtype=torch.float32,
        device=codebooks.device,
    )
    for q in range(codebooks.shape[0]):
        i = idx[:, q].long()
        ok = (i >= 0) & (i < k)
        # +0 where the index is out of range: the sum starts at +0 and so is
        # never -0, so adding +0 leaves it as it is
        acc = acc + torch.where(ok[:, None], codebooks[q][i.clamp(0, k - 1)], 0.0)
    return acc


def _check_books(codebooks: torch.Tensor, device: torch.device) -> None:
    if codebooks.dim() != 3 or codebooks.dtype != torch.float32:
        raise ValueError(
            f"codebooks must be (n_q, K, D) float32, got "
            f"{tuple(codebooks.shape)} {codebooks.dtype}"
        )
    if codebooks.device != device or not codebooks.is_contiguous():
        raise ValueError(f"codebooks must be contiguous on {device}")


def padded_shape(k: int, d: int):
    """(Kp, Dp): K rounded up to CODE_TILE, D to DIM_ALIGN."""
    return -(-k // CODE_TILE) * CODE_TILE, -(-d // DIM_ALIGN) * DIM_ALIGN


def codebook_planes(codebooks: torch.Tensor) -> torch.Tensor:
    """(n_q, K, D) float32 -> (n_q, 3, Kp, Dp) bf16 planes hi, mid, lo of
    each codeword (`split_planes`), zero past K and D: what the split kernel
    (`csrc/rvq.cu::rvq_split_planes_kernel`) writes on a card."""
    n_q, k, d = codebooks.shape
    kp, dp = padded_shape(k, d)
    planes = split_planes(codebooks).transpose(0, 1)  # (n_q, 3, K, D)
    return torch.nn.functional.pad(planes, (0, dp - d, 0, kp - k)).contiguous()


def quantize_plan(m: int, d: int) -> dict:
    """The launch plan the kernel takes for M frames of width D on this
    card (needs the library): tiles of TILE_M frames, blocks (a persistent
    grid of at most one block per slot), blocks per SM, SMs, shared-memory
    bytes, and the plan, "resident" or "streamed"."""
    import ctypes

    from nsc_tpu_torch.kernels import _build

    plan = (ctypes.c_longlong * 6)()
    err = _build.library().nsc_rvq_quantize_plan(m, padded_shape(1, d)[1], plan)
    _build.check(err, "nsc_rvq_quantize_plan")
    out = dict(zip(("tiles", "blocks", "blocks_per_sm", "sms", "smem_bytes"), plan))
    out["plan"] = "streamed" if plan[5] else "resident"
    return out


def _check_quantize(codebooks: torch.Tensor, z: torch.Tensor) -> None:
    """What the kernel takes: (n_q, K, D) float32 books with n_q, K, D >= 1
    and (M, D) float32 frames, both contiguous on z's device."""
    _check_books(codebooks, z.device)
    n_q, k, d = codebooks.shape
    if min(n_q, k, d) < 1 or padded_shape(k, d)[0] > MAX_CODES:
        raise ValueError(f"quantize kernel takes n_q, K, D >= 1 and K <= {MAX_CODES}, got "
                         f"{tuple(codebooks.shape)}")
    if z.dim() != 2 or z.shape[1] != d or z.dtype != torch.float32:
        raise ValueError(f"z must be (M, {d}) float32, got {tuple(z.shape)} {z.dtype}")
    if not z.is_contiguous():
        raise ValueError("z must be contiguous")


def _quantize_cuda(codebooks: torch.Tensor, z: torch.Tensor, scores: bool = False):
    from nsc_tpu_torch.kernels import _build

    _check_quantize(codebooks, z)
    n_q, k, d = codebooks.shape
    m = z.shape[0]
    idx = torch.empty(m, n_q, dtype=torch.int32, device=z.device)
    best = torch.empty(m, n_q, dtype=torch.float32, device=z.device) if scores else None
    if m == 0:
        return (idx, best) if scores else idx
    kp, dp = padded_shape(k, d)
    lib = _build.library()
    stream = torch.cuda.current_stream(z.device).cuda_stream
    planes = torch.empty(n_q, 3, kp, dp, dtype=torch.bfloat16, device=z.device)
    err = lib.nsc_rvq_split_planes(codebooks.data_ptr(), planes.data_ptr(), n_q, k, d, kp, dp,
                                   stream)
    _build.check(err, "nsc_rvq_split_planes")
    kernels.LAUNCHES["rvq_split_planes"] += 1
    csq = codeword_sq_norms(codebooks).contiguous()
    scratch, slots = None, 0
    if dp > RESIDENT_DIM:  # the streamed plan: a residual slot per block of its grid
        slots = quantize_plan(m, d)["blocks"]
        scratch = torch.empty(slots, 3, TILE_M, dp, dtype=torch.bfloat16, device=z.device)
    err = lib.nsc_rvq_quantize(
        z.data_ptr(), planes.data_ptr(), codebooks.data_ptr(), csq.data_ptr(),
        scratch.data_ptr() if scratch is not None else None, idx.data_ptr(),
        best.data_ptr() if scores else None, m, n_q, k, d, kp, dp, slots, stream,
    )
    _build.check(err, "nsc_rvq_quantize")
    kernels.LAUNCHES["rvq_quantize"] += 1
    return (idx, best) if scores else idx


def quantize_with_scores(codebooks: torch.Tensor, z: torch.Tensor):
    """The kernel's indices and winning scores ((M, n_q) int32, float32), on
    a CUDA tensor only: what `quantize` launches, with the scores kept, so a
    caller can hold them against a float64 score."""
    if z.device.type != "cuda":
        raise ValueError("quantize_with_scores runs the CUDA kernel only")
    return _quantize_cuda(codebooks, z, scores=True)


def _dequantize_cuda(codebooks: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    from nsc_tpu_torch.kernels import _build

    _check_books(codebooks, idx.device)
    n_q, k, d = codebooks.shape
    if idx.dim() != 2 or idx.shape[1] != n_q or idx.dtype != torch.int32:
        raise ValueError(
            f"idx must be (M, {n_q}) int32, got {tuple(idx.shape)} {idx.dtype}"
        )
    if not idx.is_contiguous():
        raise ValueError("idx must be contiguous")
    m = idx.shape[0]
    out = torch.empty(m, d, dtype=torch.float32, device=idx.device)
    if m == 0:
        return out
    lib = _build.library()
    err = lib.nsc_rvq_dequantize(
        idx.data_ptr(), codebooks.data_ptr(), out.data_ptr(), m, n_q, k, d,
        torch.cuda.current_stream(idx.device).cuda_stream,
    )
    _build.check(err, "nsc_rvq_dequantize")
    kernels.LAUNCHES["rvq_dequantize"] += 1
    return out


def quantize(codebooks: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """codebooks (n_q, K, D) f32, z (M, D) f32 -> (M, n_q) int32."""
    if z.device.type == "cpu":
        return quantize_plain(codebooks, z)
    if z.device.type == "cuda":
        return _quantize_cuda(codebooks, z)
    raise ValueError(f"rvq quantize: unsupported device {z.device}")


def dequantize(codebooks: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """codebooks (n_q, K, D) f32, idx (M, n_q) int32 -> (M, D) f32."""
    if idx.device.type == "cpu":
        return dequantize_plain(codebooks, idx)
    if idx.device.type == "cuda":
        return _dequantize_cuda(codebooks, idx)
    raise ValueError(f"rvq dequantize: unsupported device {idx.device}")
