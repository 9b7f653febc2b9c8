"""Residual vector quantizer (counterpart of `nsc_tpu/ops/rvq.py`): the
inference search and sum, and the training half (straight-through forward
with EMA statistics, EMA codebook update with dead-code reseeding,
data-driven codebook init, perplexity).

Inference state: {'codebooks': (n_q, K, D) float32}; training adds
'ema_count' (n_q, K) and 'ema_sum' (n_q, K, D). The index contract is fixed for
parity with the JAX package: distance = ||c||^2 - 2 r.c in true float32,
lowest index on ties, books searched in order with the chosen codeword
subtracted from the residual. Depth is variable: the first n_q books of a
deeper quantizer give the same indices as a quantizer of depth n_q.

With `kernel=True` quantize and dequantize go through the wrappers of
`nsc_tpu_torch.kernels.rvq` (the CUDA kernels on a card, their plain
versions on the CPU); otherwise they run the plain versions directly. The
training forward and the data init always search through the quantize
wrapper: the search is the same all-book chain.

Random draws (reseed picks, init permutations) come from a
`torch.Generator` on the CPU, or are passed in explicitly.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

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


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


class RVQForward(NamedTuple):
    quantized: torch.Tensor     # (N, T, D) straight-through quantized latents
    indices: torch.Tensor       # (N, T, n_q) int32
    commit_loss: torch.Tensor   # scalar commitment loss
    counts: torch.Tensor        # (n_q, K) masked assignment counts
    sums: torch.Tensor          # (n_q, K, D) masked assigned-residual sums
    usage: torch.Tensor         # (n_q,) fraction of codes used this batch


def init_rvq_train(codebooks: torch.Tensor) -> RVQState:
    """Training state for `codebooks`: zero EMA counts, EMA sums equal to
    the codebooks (the JAX package's `init_rvq`)."""
    cb = codebooks.float()
    return {
        "codebooks": cb,
        "ema_count": torch.zeros(cb.shape[:2], dtype=torch.float32, device=cb.device),
        "ema_sum": cb.clone(),
    }


def forward(
    state: RVQState,
    z: torch.Tensor,
    *,
    n_q: Optional[int] = None,
    depth: Optional[torch.Tensor] = None,
    axis=None,
) -> RVQForward:
    """Quantize with a straight-through estimator and collect EMA stats.

    z: (N, T, D). `depth`: optional (N,) int tensor of per-sample active
    book counts (quantizer dropout); books q >= depth[i] are left out of
    sample i's output sum and EMA stats, but the residual chain is the
    full-depth chain, so the indices of the active books are those a
    shallower encode gives (the prefix property).

    The nearest-code search of all books is one call of the quantize
    wrapper (the CUDA kernel on a card). Counts, sums and the output sum
    follow the JAX scan book by book in float32.

    `axis` (a `parallel.Mesh`, data parallelism): counts and sums are
    summed over its ranks, as the JAX package psums them, and `usage` is
    taken from the summed counts: the global batch's, as one process on the
    whole batch reports it (the JAX package takes each replica's own usage
    before its psum and averages the metric, so its value depends on the
    world size).
    """
    books = _books(state, n_q).float()
    num_books, k, d = books.shape
    n, t, _ = z.shape
    m = n * t
    zf = z.reshape(m, d).float()
    r = zf.detach().contiguous()
    idx = K.quantize(books.detach().contiguous(), r).long()  # (M, n_q)

    if depth is None:
        mask = torch.ones(num_books, m, dtype=torch.float32, device=z.device)
    else:
        q_ids = torch.arange(num_books, device=z.device)[:, None]
        per_sample = (q_ids < depth.to(z.device)[None, :]).float()  # (n_q, N)
        mask = torch.repeat_interleave(per_sample, t, dim=1)  # (n_q, M)

    acc = torch.zeros_like(r)
    counts, sums = [], []
    for q in range(num_books):
        cb = books[q].detach()
        iq = idx[:, q]
        quant = cb[iq]
        mq = mask[q]
        cnt = torch.zeros(k, dtype=torch.float32, device=z.device).index_add_(0, iq, mq)
        sm = torch.zeros(k, d, dtype=torch.float32, device=z.device).index_add_(
            0, iq, r * mq[:, None]
        )
        acc = acc + quant * mq[:, None]
        r = r - quant
        counts.append(cnt)
        sums.append(sm)

    counts, sums = torch.stack(counts), torch.stack(sums)
    if axis is not None:
        axis.psum_([counts, sums])
    usage = torch.mean((counts > 0).float(), dim=-1)
    zq = acc.reshape(n, t, d)
    commit = torch.mean(torch.square(z.float() - zq))
    zq_ste = z + (zq - z.float()).to(z.dtype).detach()
    indices = idx.to(torch.int32).reshape(n, t, num_books)
    return RVQForward(zq_ste, indices, commit, counts, sums, usage)


def init_codebooks_from_data(
    state: RVQState,
    z: torch.Tensor,
    *,
    kmeans_iters: int = 2,
    generator: Optional[torch.Generator] = None,
    picks: Optional[torch.Tensor] = None,
) -> RVQState:
    """Data-driven codebook init: book q starts from K points of the
    residual pool left after books < q (a permutation of the pool, wrapping
    only when K exceeds it), then `kmeans_iters` Lloyd iterations in
    float32; empty clusters keep their point. EMA counts start at
    max(M/K, 8) for every code.

    z: (..., D) pre-quantization latents. The starting points are
    `picks` (n_q, K) pool indices when given, else drawn from `generator`
    (a CPU `torch.Generator`).
    """
    books = state["codebooks"]
    n_q, k, d = books.shape
    pool = z.reshape(-1, d).float().detach().contiguous()
    m = pool.shape[0]
    if picks is None:
        if generator is None:
            raise ValueError("init_codebooks_from_data needs a generator or picks")
        wrap = torch.arange(k) % max(m, 1)
        picks = torch.stack(
            [torch.randperm(m, generator=generator)[wrap] for _ in range(n_q)]
        )
    picks = picks.long().to(pool.device)

    def nearest(residual, cb):
        return K.quantize(cb[None].contiguous(), residual)[:, 0].long()

    residual = pool
    new_books = []
    for q in range(n_q):
        cb = residual[picks[q]]
        for _ in range(kmeans_iters):
            idx = nearest(residual, cb)
            counts = torch.zeros(k, device=pool.device).index_add_(
                0, idx, torch.ones(m, device=pool.device)
            )
            sums = torch.zeros(k, d, device=pool.device).index_add_(0, idx, residual)
            cb = torch.where(
                counts[:, None] > 0, sums / torch.clamp(counts[:, None], min=1.0), cb
            )
        idx = nearest(residual, cb)
        residual = (residual - cb[idx]).contiguous()
        new_books.append(cb)
    new_books = torch.stack(new_books)
    count0 = torch.full((n_q, k), max(m / k, 8.0), dtype=torch.float32, device=pool.device)
    return {
        "codebooks": new_books,
        "ema_count": count0,
        "ema_sum": new_books * count0[..., None],
    }


def sample_reseed_candidates(
    pool: torch.Tensor,
    n_q: int,
    k: int,
    *,
    generator: Optional[torch.Generator] = None,
    picks: Optional[torch.Tensor] = None,
    axis=None,
) -> torch.Tensor:
    """(n_q, K, D) random vectors of the (M, D) pool for dead-code
    reseeding: `picks` (n_q, K) pool indices when given, else uniform draws
    from `generator` (a CPU `torch.Generator`).

    With `axis` (a `parallel.Mesh`) `pool` is this rank's part of the
    global pool, the ranks' parts in rank order, and `picks` index the
    global pool [0, M x world). The generator must be the same on every
    rank: each rank fills the picks it owns, zeros elsewhere, and a sum
    over the ranks gives every rank the same candidates (the JAX package's
    psum broadcast), so the codebooks stay bit-identical across ranks."""
    m = pool.shape[0]
    world = 1 if axis is None else axis.size
    if picks is None:
        picks = torch.randint(0, m * world, (n_q, k), generator=generator)
    picks = picks.long().to(pool.device)
    if axis is None:
        return pool[picks]
    local = picks - axis.rank * m
    mine = (local >= 0) & (local < m)
    cand = torch.where(mine[..., None], pool[local.clamp(0, m - 1)],
                       torch.zeros((), dtype=pool.dtype, device=pool.device))
    axis.psum_([cand])
    return cand


def ema_update(
    state: RVQState,
    counts: torch.Tensor,
    sums: torch.Tensor,
    *,
    decay: float = 0.99,
    eps: float = 1e-5,
    dead_threshold: float = 2.0,
    reseed_candidates: Optional[torch.Tensor] = None,
):
    """Fold one batch's stats into the EMA codebooks: Laplace-smoothed
    cluster sizes; codes whose EMA count falls below `dead_threshold` are
    reseeded from `reseed_candidates` (n_q, K, D) with their count reset to
    a grace value, min(thr / decay**20, 4 * thr), so a fresh code is not
    reseeded again on the next step.

    Returns (new state, reseed fraction (scalar tensor)).
    """
    n_used = counts.shape[0]
    ema_count = state["ema_count"]
    ema_sum = state["ema_sum"]
    new_count = decay * ema_count[:n_used] + (1.0 - decay) * counts
    new_sum = decay * ema_sum[:n_used] + (1.0 - decay) * sums

    total = torch.sum(new_count, dim=-1, keepdim=True)
    k = new_count.shape[-1]
    smoothed = (new_count + eps) / (total + k * eps) * total
    new_cb = new_sum / smoothed[..., None]

    reseed_frac = torch.zeros((), dtype=torch.float32, device=counts.device)
    if reseed_candidates is not None:
        dead = (new_count < dead_threshold)[..., None]
        reseed_frac = torch.mean(dead.float())
        grace = min(dead_threshold / decay**20, 4.0 * dead_threshold)
        new_cb = torch.where(dead, reseed_candidates, new_cb)
        new_sum = torch.where(dead, reseed_candidates * grace, new_sum)
        new_count = torch.where(dead[..., 0], torch.full_like(new_count, grace), new_count)

    def put(full, part):
        return part if part.shape[0] == full.shape[0] else torch.cat([part, full[n_used:]])

    out = {
        "codebooks": put(state["codebooks"], new_cb),
        "ema_count": put(ema_count, new_count),
        "ema_sum": put(ema_sum, new_sum),
    }
    return out, reseed_frac


def codebook_perplexity(counts: torch.Tensor) -> torch.Tensor:
    """exp(entropy) of the batch assignment distribution, per book."""
    p = counts / torch.clamp(torch.sum(counts, dim=-1, keepdim=True), min=1e-9)
    ent = -torch.sum(torch.where(p > 0, p * torch.log(p), torch.zeros_like(p)), dim=-1)
    return torch.exp(ent)
