"""Residual vector quantizer search and sum: the CUDA kernels in
`csrc/rvq.cu`, their plain PyTorch versions, and the wrappers.

quantize: for each frame, over the books in order, pick
    argmin_k  ||c_k||^2 - 2 r.c_k     (true float32, lowest index on ties)
and subtract the chosen codeword from the residual r (the last book's update
is skipped: nothing reads it). `||c||^2` is computed once per call, by the
wrapper, and the score is two separately rounded operations on it and on
the dot product, so only the dot's summation order can differ between the
kernel, its plain version and the JAX package.

dequantize: sum the chosen codewords in book order, 0 + c_0 + c_1 + ...,
in float32 (bit-exact with the JAX package's scan).
"""

from __future__ import annotations

import torch

from nsc_tpu_torch import kernels


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
    """codebooks (n_q, K, D) f32, idx (M, n_q) int -> (M, D) f32."""
    acc = torch.zeros(
        idx.shape[0], codebooks.shape[-1], dtype=torch.float32,
        device=codebooks.device,
    )
    for q in range(codebooks.shape[0]):
        acc = acc + codebooks[q][idx[:, q].long()]
    return acc


def _check_books(codebooks: torch.Tensor, device: torch.device) -> None:
    if codebooks.dim() != 3 or codebooks.dtype != torch.float32:
        raise ValueError(
            f"codebooks must be (n_q, K, D) float32, got "
            f"{tuple(codebooks.shape)} {codebooks.dtype}"
        )
    if codebooks.device != device or not codebooks.is_contiguous():
        raise ValueError(f"codebooks must be contiguous on {device}")


# The quantize kernel keeps a (D x 64) residual tile and a (D x 64) codeword
# tile in shared memory; 227 KB per block bounds D.
MAX_QUANTIZE_DIM = 384


def _quantize_cuda(codebooks: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    from nsc_tpu_torch.kernels import _build

    _check_books(codebooks, z.device)
    n_q, k, d = codebooks.shape
    if z.dim() != 2 or z.shape[1] != d or z.dtype != torch.float32:
        raise ValueError(f"z must be (M, {d}) float32, got {tuple(z.shape)} {z.dtype}")
    if not z.is_contiguous():
        raise ValueError("z must be contiguous")
    if d > MAX_QUANTIZE_DIM or n_q < 1 or k < 1:
        raise ValueError(f"quantize kernel takes 1 <= D <= {MAX_QUANTIZE_DIM}")
    m = z.shape[0]
    idx = torch.empty(m, n_q, dtype=torch.int32, device=z.device)
    if m == 0:
        return idx
    cbt = codebooks.transpose(1, 2).contiguous()  # (n_q, D, K)
    csq = codeword_sq_norms(codebooks).contiguous()
    lib = _build.library()
    err = lib.nsc_rvq_quantize(
        z.data_ptr(), cbt.data_ptr(), codebooks.data_ptr(), csq.data_ptr(),
        idx.data_ptr(), m, n_q, k, d,
        torch.cuda.current_stream(z.device).cuda_stream,
    )
    _build.check(err, "nsc_rvq_quantize")
    kernels.LAUNCHES["rvq_quantize"] += 1
    return idx


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
