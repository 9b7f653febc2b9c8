"""Residual vector quantizer, inference side (counterpart of
`nsc_tpu/ops/rvq.py`).

State: {'codebooks': (n_q, K, D) float32}. The index contract is fixed for
parity with the JAX package: distance = ||c||^2 - 2 r.c in true float32,
lowest index on ties, books searched in order with the chosen codeword
subtracted from the residual. Depth is variable: the first n_q books of a
deeper quantizer give the same indices as a quantizer of depth n_q.

With `kernel=True` quantize and dequantize go through the wrappers of
`nsc_tpu_torch.kernels.rvq` (the CUDA kernels on a card, their plain
versions on the CPU); otherwise they run the plain versions directly.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from nsc_tpu_torch.configs import CodecConfig
from nsc_tpu_torch.kernels import rvq as K

RVQState = Dict[str, torch.Tensor]


def init_rvq(cfg: CodecConfig, generator: torch.Generator) -> RVQState:
    """N(0, 1) codebooks in codebook_dim space."""
    shape = (cfg.num_quantizers, cfg.codebook_size, cfg.codebook_dim)
    return {"codebooks": torch.randn(shape, generator=generator)}


def _books(state: RVQState, n_q: Optional[int]) -> torch.Tensor:
    books = state["codebooks"]
    return books if n_q is None else books[:n_q]


def quantize(
    state: RVQState, z: torch.Tensor, n_q: Optional[int] = None,
    *, kernel: bool = False,
) -> torch.Tensor:
    """Latents to indices. z (..., D) -> (..., n_q) int32."""
    books = _books(state, n_q).float().contiguous()
    r = z.reshape(-1, z.shape[-1]).float().contiguous()
    idx = (K.quantize if kernel else K.quantize_plain)(books, r)
    return idx.reshape(*z.shape[:-1], books.shape[0])


def dequantize(
    state: RVQState, indices: torch.Tensor, n_q: Optional[int] = None,
    *, kernel: bool = False,
) -> torch.Tensor:
    """Indices to latents. indices (..., n_q_in) -> (..., D) float32; with
    n_q given only the first n_q books are summed."""
    used = indices.shape[-1] if n_q is None else n_q
    books = state["codebooks"][:used].float().contiguous()
    idx2d = indices[..., :used].reshape(-1, used).to(torch.int32).contiguous()
    out = (K.dequantize if kernel else K.dequantize_plain)(books, idx2d)
    return out.reshape(*indices.shape[:-1], books.shape[-1])


def argmin_margins(
    state: RVQState, z: torch.Tensor, n_q: Optional[int] = None
) -> torch.Tensor:
    """Per-book argmin safety margins: second-smallest minus smallest
    distance score at every residual step, along the top-1 path.
    z (..., D) -> (..., n_q) float32. A small margin marks a frame whose
    index may flip under another summation order of the same f32 scores."""
    books = _books(state, n_q)
    lead = z.shape[:-1]
    r = z.reshape(-1, z.shape[-1]).float()
    margins = []
    for cb in books:
        c = cb.float()
        scores = K.codeword_sq_norms(c)[None, :] - 2.0 * (r @ c.t())
        top2 = torch.topk(scores, 2, dim=-1, largest=False).values
        margins.append(top2[:, 1] - top2[:, 0])
        r = r - c[torch.argmin(scores, dim=-1)]
    return torch.stack(margins, dim=-1).reshape(*lead, books.shape[0])
