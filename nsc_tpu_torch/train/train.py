"""The GAN train step (counterpart of `nsc_tpu/train/train.py`).

One step, in the JAX package's order and with its numbers:

  1. generator: codec forward (quantizer dropout depths), time-L1 + mel +
     multi-resolution STFT + commitment losses, and with the GAN on the
     adversarial and feature-matching losses through the discriminators
     with the step's OLD parameters; gradients of the generator only;
     `grad/g_norm` before clipping;
  2. RVQ EMA fold of the forward's counts and sums, with dead codes
     reseeded from the step's latents;
  3. discriminator: LS-GAN loss on real and (detached) fake with the same
     old parameters; gradients scaled by `adv_on` (0 before
     `disc_start_step`);
  4. both optimizers: clip by global norm (optax semantics: no epsilon,
     g * max_norm / norm when norm >= max_norm), then Adam (b1 0.5, b2 0.9,
     eps 1e-8) with the learning rate of the schedule at the count before
     the step, as optax evaluates it.

Gradients are taken with `torch.autograd.grad`, never accumulated into
`.grad`, so the generator's backward cannot reach the discriminator's
update. Parameters and optimizer moments are updated in place (the port
keeps one copy of the state); the step returns the state and its metrics
(0-dim tensors, the JAX package's metric names).

The step computes in full float32, the training dtype: it turns TF32 off
for cuDNN convolutions and cuBLAS matmuls while it runs (PyTorch allows it
for convolutions by default) and restores the caller's settings after.

Random draws of a step (depths, reseed picks) come from a CPU
`torch.Generator` seeded from (seed, step), so a resumed run draws what an
uninterrupted one would; tests pass JAX's own draws in explicitly.

Data parallelism (`make_train_step(..., axis=mesh)`, built by
`parallel.make_parallel_train_step`; the JAX step's `axis_name`): each rank
runs the step on its rows of the global batch; the generator's and the
discriminator's gradients are summed over the ranks and divided by the
world size before the norm, the clip and Adam; the RVQ forward sums its EMA
counts and sums (and takes `rvq/usage` from the sums: the global batch's,
where the JAX step averages the replicas' own); the reseed picks index the
global pool; every metric is averaged over the ranks. Every rank draws from the same (seed, step)
generator: the depths of the whole global batch (each rank takes its rows)
and then the global reseed picks, so a one-rank group draws what the plain
step draws and is the plain step bit for bit, and N ranks draw what one
process draws on the global batch.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from nsc_tpu_torch import weights
from nsc_tpu_torch.configs import CodecConfig, TrainConfig
from nsc_tpu_torch.losses import gan as gan_losses
from nsc_tpu_torch.losses import spectral
from nsc_tpu_torch.models import discriminators as disc
from nsc_tpu_torch.models.codec import KernelOptions, NeuralSpeechCodec
from nsc_tpu_torch.ops import rvq as rvq_ops
from nsc_tpu_torch.ops.precision import float32_numerics
from nsc_tpu_torch.utils import profiling

TrainState = Dict[str, Any]


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------


def tree_leaves(tree) -> List[torch.Tensor]:
    """Tensor leaves of a nested dict/list tree, in a fixed order (dict keys
    sorted, as JAX flattens)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [] if tree is None else [tree]


def _as_leaves(tree, device) -> Any:
    """Float32 leaf tensors on `device` that require grad."""
    return weights.tree_map(
        lambda x: x.detach().to(device, torch.float32).contiguous().requires_grad_(True), tree
    )


# ---------------------------------------------------------------------------
# learning rate and optimizer (optax semantics)
# ---------------------------------------------------------------------------


def make_lr_schedule(base_lr: float, tcfg: TrainConfig) -> Callable[[int], float]:
    """Linear warmup -> optional cosine decay to base_lr * lr_end_factor,
    constant when warmup_steps and lr_decay_steps are both 0. The values are
    optax's `warmup_cosine_decay_schedule` / `join_schedules` of linear and
    constant, evaluated in float32."""
    f32 = np.float32
    if tcfg.warmup_steps <= 0 and tcfg.lr_decay_steps <= 0:
        return lambda count: float(f32(base_lr))
    warmup = max(tcfg.warmup_steps, 0)

    def linear(count: int, steps: int) -> float:
        if steps <= 0:
            return 0.0
        c = f32(min(max(count, 0), steps))
        frac = f32(1) - c / f32(steps)
        return float((f32(0.0) - f32(base_lr)) * frac + f32(base_lr))

    if tcfg.lr_decay_steps > 0:
        w = max(warmup, 1)
        decay = max(tcfg.lr_decay_steps, warmup + 1) - w
        alpha = f32(tcfg.lr_end_factor)  # end / peak

        def cosine(count: int) -> float:
            c = f32(min(count, decay))
            cd = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay)))
            return float(f32(base_lr) * ((f32(1) - alpha) * cd + alpha))

        return lambda count: linear(count, w) if count < w else cosine(count - w)
    return lambda count: linear(count, warmup) if count < warmup else float(f32(base_lr))


def global_norm(grads: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def init_adam(params) -> Dict[str, Any]:
    zeros = lambda x: torch.zeros_like(x, requires_grad=False)  # noqa: E731
    return {"count": 0, "mu": weights.tree_map(zeros, params),
            "nu": weights.tree_map(zeros, params)}


@torch.no_grad()
def clip_adam_update(
    params, grads: List[torch.Tensor], opt: Dict[str, Any], tcfg: TrainConfig,
    lr_fn: Callable[[int], float],
) -> None:
    """optax.chain(clip_by_global_norm(grad_clip), adam(lr_fn, b1, b2,
    eps=1e-8)) applied to `params` in place; `grads` are in
    `tree_leaves(params)` order."""
    norm = global_norm(grads)
    clip = norm >= tcfg.grad_clip
    b1, b2 = tcfg.adam_b1, tcfg.adam_b2
    count = opt["count"] + 1
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
    step = -lr_fn(opt["count"])
    for p, g, m, v in zip(
        tree_leaves(params), grads, tree_leaves(opt["mu"]), tree_leaves(opt["nu"])
    ):
        g = torch.where(clip, (g / norm) * tcfg.grad_clip, g)
        m.mul_(b1).add_((1.0 - b1) * g)
        v.mul_(b2).add_((1.0 - b2) * (g * g))
        u = (m / bc1) / (torch.sqrt(v / bc2) + 1e-8)
        p.add_(step * u)
    opt["count"] = count


# ---------------------------------------------------------------------------
# state and step
# ---------------------------------------------------------------------------


def init_train_state(
    cfg: CodecConfig, tcfg: TrainConfig, device, *, seed: Optional[int] = None
) -> Tuple[NeuralSpeechCodec, TrainState]:
    """Seeded codec and discriminator weights (float32), zero optimizer
    moments, the RVQ training state; on `device`."""
    seed = tcfg.seed if seed is None else seed
    params_g, rvq = weights.init_jax_layout(cfg, seed)
    params_d = disc.init_discriminators(
        seed + 1, tcfg.disc_width_mult,
        periods=tcfg.mpd_periods, msd_scales=tcfg.msd_scales,
    )
    trees = weights.train_state_from_jax(params_g, params_d, rvq)
    return model_for(cfg), state_from_trees(trees, device)


def model_for(cfg: CodecConfig) -> NeuralSpeechCodec:
    """The codec that trains: no inference kernels (the training forward
    runs the residual units op by op and searches through the RVQ wrapper)."""
    return NeuralSpeechCodec(cfg, kernels=KernelOptions())


def state_from_trees(trees: TrainState, device, step: int = 0) -> TrainState:
    """A train state from `train_state_from_jax`'s trees (and, when resuming,
    optimizer states and the step)."""
    params_g = _as_leaves(trees["params_g"], device)
    params_d = _as_leaves(trees["params_d"], device)
    state = {
        "step": step,
        "params_g": params_g,
        "params_d": params_d,
        "opt_g": init_adam(params_g),
        "opt_d": init_adam(params_d),
        "rvq": weights.tree_map(lambda x: x.to(device, torch.float32), trees["rvq"]),
    }
    for name in ("opt_g", "opt_d"):
        if name in trees:
            state[name] = {
                "count": int(trees[name]["count"]),
                "mu": weights.tree_map(lambda x: x.to(device, torch.float32), trees[name]["mu"]),
                "nu": weights.tree_map(lambda x: x.to(device, torch.float32), trees[name]["nu"]),
            }
    return state


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step's draws, a function of (seed, step)."""
    return torch.Generator().manual_seed((seed * 1_000_003 + step) % (2**63))


def sample_depths(
    gen: torch.Generator, n: int, n_q: int, dropout_p: float
) -> torch.Tensor:
    """Quantizer dropout: with probability p a sample trains at a random
    depth in [1, n_q]; otherwise at full depth."""
    rand_depth = torch.randint(1, n_q + 1, (n,), generator=gen)
    use_rand = torch.rand(n, generator=gen) < dropout_p
    return torch.where(use_rand, rand_depth, torch.full_like(rand_depth, n_q))


def _split(outs, n):
    real = [(lg[:n], [f[:n] for f in fs]) for lg, fs in outs]
    fake = [(lg[n:], [f[n:] for f in fs]) for lg, fs in outs]
    return real, fake


def make_train_step(model: NeuralSpeechCodec, tcfg: TrainConfig, *, axis=None):
    """(state, batch (N, T) float32) -> (state, metrics). Optional keyword
    arguments `depth` (N,) and `reseed_picks` (n_q, K) replace the step's
    own draws; `mark(name)` is called after the generator's gradients
    ("generator"), the discriminator's ("discriminator") and the updates
    ("updates"), so a caller can record timing events between them. The
    step runs under `float32_numerics()`.

    With `axis` (a `parallel.Mesh`) the batch is this rank's rows of the
    global batch, and `depth` (N x world,) and `reseed_picks` refer to the
    global batch and its pool (see the module doc)."""
    world = 1 if axis is None else axis.size
    cfg = model.cfg
    lr_g = make_lr_schedule(tcfg.lr_g, tcfg)
    lr_d = make_lr_schedule(tcfg.lr_d, tcfg)
    mrstft = spectral.MultiResSTFTConfig(fft_sizes=tcfg.stft_fft_sizes)

    def g_loss(state, batch, depth, adv_on):
        recon, fwd, z = model.forward(state["params_g"], state["rvq"], batch, depth=depth,
                                      axis=axis)
        l_time = spectral.time_l1_loss(recon, batch)
        l_mel = spectral.mel_loss(
            recon, batch, sample_rate=cfg.sample_rate, n_fft=tcfg.mel_fft_size,
            hop=tcfg.mel_fft_size // 4, n_mels=tcfg.mel_bins,
        )
        l_stft = spectral.multi_res_stft_loss(recon, batch, mrstft)
        total = (
            tcfg.weight_l1_time * l_time
            + tcfg.weight_mel * l_mel
            + tcfg.weight_stft * l_stft
            + tcfg.weight_commit * fwd.commit_loss
        )
        metrics = {
            "loss/time_l1": l_time,
            "loss/mel": l_mel,
            "loss/stft": l_stft,
            "loss/commit": fwd.commit_loss,
        }
        if tcfg.use_gan:
            outs = disc.apply_discriminators(
                state["params_d"], torch.cat([batch, recon]), periods=tcfg.mpd_periods
            )
            real, fake = _split(outs, batch.shape[0])
            l_adv = gan_losses.generator_adversarial_loss(fake)
            l_fm = gan_losses.feature_matching_loss(real, fake)
            total = total + adv_on * (tcfg.weight_adv * l_adv + tcfg.weight_fm * l_fm)
            metrics["loss/adv_g"] = l_adv
            metrics["loss/fm"] = l_fm
        metrics["loss/g_total"] = total
        return total, metrics, fwd, z, recon

    def train_step(state: TrainState, batch: torch.Tensor, **kwargs):
        with float32_numerics(), profiling.span("train.step"):
            return _train_step(state, batch, **kwargs)

    def _train_step(
        state: TrainState, batch: torch.Tensor, *,
        depth: Optional[torch.Tensor] = None,
        reseed_picks: Optional[torch.Tensor] = None,
        mark: Optional[Callable[[str], None]] = None,
    ):
        mark = mark or (lambda _: None)
        step = state["step"]
        gen = step_generator(tcfg.seed, step)
        n = batch.shape[0]
        with profiling.span("train.generator"):
            if depth is None and tcfg.quantizer_dropout > 0:
                depth = sample_depths(gen, n * world, cfg.num_quantizers, tcfg.quantizer_dropout)
            if depth is not None and axis is not None:
                depth = depth[axis.rank * n:(axis.rank + 1) * n]
            adv_on = 1.0 if step >= tcfg.disc_start_step else 0.0

            # --- generator gradients (old discriminator) ---
            g_params = tree_leaves(state["params_g"])
            total, metrics, fwd, z, recon = g_loss(state, batch, depth, adv_on)
            g_grads = list(torch.autograd.grad(total, g_params))
            if axis is not None:
                axis.pmean_(g_grads)
            metrics["grad/g_norm"] = global_norm(g_grads)
            fake = recon.detach()
            del total, recon
        mark("generator")

        # --- discriminator gradients (same old parameters) ---
        d_grads = None
        with profiling.span("train.discriminator"):
            if tcfg.use_gan:
                d_params = tree_leaves(state["params_d"])
                outs = disc.apply_discriminators(
                    state["params_d"], torch.cat([batch, fake]), periods=tcfg.mpd_periods
                )
                d_total = gan_losses.discriminator_loss(*_split(outs, batch.shape[0]))
                d_grads = [g * adv_on for g in torch.autograd.grad(d_total, d_params)]
                if axis is not None:
                    axis.pmean_(d_grads)
                metrics["loss/d_total"] = d_total
                del outs
        mark("discriminator")

        # --- updates: generator, RVQ EMA, discriminator ---
        with profiling.span("train.update"):
            clip_adam_update(state["params_g"], g_grads, state["opt_g"], tcfg, lr_g)
            with torch.no_grad():
                pool = z.detach().reshape(-1, z.shape[-1])
                candidates = rvq_ops.sample_reseed_candidates(
                    pool, fwd.counts.shape[0], cfg.codebook_size,
                    generator=gen, picks=reseed_picks, axis=axis,
                )
                new_rvq, reseed_frac = rvq_ops.ema_update(
                    state["rvq"], fwd.counts, fwd.sums,
                    decay=cfg.ema_decay, eps=cfg.ema_eps,
                    dead_threshold=cfg.threshold_dead_code,
                    reseed_candidates=candidates,
                )
                metrics["rvq/perplexity"] = torch.mean(rvq_ops.codebook_perplexity(fwd.counts))
                metrics["rvq/usage"] = torch.mean(fwd.usage)
                metrics["rvq/reseed_frac"] = reseed_frac
            metrics["lr/g"] = torch.tensor(lr_g(step))
            if d_grads is not None:
                clip_adam_update(state["params_d"], d_grads, state["opt_d"], tcfg, lr_d)

            state["rvq"] = new_rvq
            state["step"] = step + 1
            metrics = {k: v.detach() for k, v in metrics.items()}
            if axis is not None:
                metrics = axis.pmean_metrics(metrics)
        mark("updates")
        return state, metrics

    return train_step
