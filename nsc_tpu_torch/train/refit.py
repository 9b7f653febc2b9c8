"""Offline codebook refit of a trained codec (counterpart of
`nsc_tpu/train/refit.py`).

With the encoder and decoder frozen, the codebooks are estimated again on
the trained encoder's latent distribution:

  1. `collect_latents`: a pool of pre-quantization latents (in codebook
     space) of waveform batches, kept on the device;
  2. `refit_codebooks`: sequential residual k-means, book q fit on the
     residual pool left by the refit books before it, through
     `ops.rvq.init_codebooks_from_data` (its nearest-code searches are
     launches of the RVQ quantize wrapper: K2 on a card);
  3. `pool_report`: per-book usage and perplexity and the residual MSE at
     every depth, before and after.

Every code ends at the mean of a real cluster, so usage rises by
construction; whether decoded quality improves is for the caller to
measure.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from nsc_tpu_torch.kernels import rvq as K
from nsc_tpu_torch.ops import rvq as rvq_ops


@torch.no_grad()
def collect_latents(bundle, batches: Iterator[np.ndarray], n_batches: int) -> torch.Tensor:
    """`n_batches` waveform batches through the bundle's encoder: the pooled
    latents, (M, D) float32 on the bundle's device."""
    parts = []
    for _ in range(n_batches):
        wav = torch.from_numpy(np.ascontiguousarray(next(batches), np.float32)).to(bundle.device)
        z = bundle.model.latents(bundle.params, wav)
        parts.append(z.reshape(-1, z.shape[-1]).float())
    return torch.cat(parts, dim=0)


def refit_codebooks(
    rvq_state: rvq_ops.RVQState, pool: torch.Tensor, *, kmeans_iters: int = 10, seed: int = 0
) -> rvq_ops.RVQState:
    """Sequential residual k-means over all books: a full RVQ training state
    (codebooks, and EMA statistics consistent with them). The k-means
    starting points are drawn from a CPU generator seeded with `seed`."""
    books = rvq_state["codebooks"].to(pool.device)
    return rvq_ops.init_codebooks_from_data(
        {"codebooks": books}, pool, kmeans_iters=kmeans_iters,
        generator=torch.Generator().manual_seed(seed),
    )


@torch.no_grad()
def pool_stats(rvq_state: rvq_ops.RVQState, pool: torch.Tensor):
    """Per-book assignment counts (n_q, K) and the residual MSE after each
    depth (n_q,) of quantizing `pool`. The search is one launch of the RVQ
    quantize wrapper over all books (K2 on a card, its plain version on the
    CPU): the same residual chain as the JAX package's per-book `_nearest`
    (XLA, precision HIGHEST), so K2's near-tie flips can move a count."""
    books = rvq_state["codebooks"].to(pool.device).float().contiguous()
    n_q, k, _ = books.shape
    r = pool.float().contiguous()
    idx = K.quantize(books, r).long()
    counts, mse = [], []
    for q in range(n_q):
        counts.append(torch.bincount(idx[:, q], minlength=k).float())
        r = r - books[q][idx[:, q]]
        mse.append(torch.mean(torch.square(r)))
    return torch.stack(counts), torch.stack(mse)


def pool_report(rvq_state: rvq_ops.RVQState, pool: torch.Tensor) -> Dict:
    """Host-side summary: per-book usage and perplexity, and the residual
    MSE at every depth, of `pool` (rounded as the JAX package rounds)."""
    counts, mse = pool_stats(rvq_state, pool)
    counts = counts.cpu().double().numpy()
    p = counts / np.maximum(counts.sum(axis=-1, keepdims=True), 1.0)
    ent = -(p * np.log(np.where(p > 0, p, 1.0))).sum(axis=-1)
    return {
        "book_usage": [round(float(u), 4) for u in (counts > 0).mean(axis=-1)],
        "book_perplexity": [round(float(x), 1) for x in np.exp(ent)],
        "mean_usage": round(float((counts > 0).mean()), 4),
        "residual_mse_per_depth": [round(float(x), 6) for x in mse.cpu().numpy()],
    }
