"""The training loop and its entry point (counterpart of
`nsc_tpu/train/loop.py`).

    python -m nsc_tpu_torch.train --config base_fast --data synthetic \
        --steps N --workdir DIR [--device cpu]

Runs on CUDA unless `--device cpu` is given, and raises when CUDA is asked
for and absent. Fresh runs start from seeded weights with the step-0
data-driven codebook init; a workdir with a checkpoint resumes from it
(parameters, optimizers, RVQ state, step and data stream), bit-exactly on
the CPU. Metrics go to `<workdir>/metrics.jsonl`; checkpoints to
`<workdir>/train/`. Not ported yet: data parallelism, asynchronous
snapshots, keep-best and eviction, inference-only exports, WAV-directory
data.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Optional

import torch

from nsc_tpu_torch.api import resolve_device
from nsc_tpu_torch.configs import CodecConfig, TrainConfig, get_config
from nsc_tpu_torch.ops import rvq as rvq_ops
from nsc_tpu_torch.ops.precision import float32_numerics
from nsc_tpu_torch.train import checkpoint as ckpt
from nsc_tpu_torch.train import data as data_lib
from nsc_tpu_torch.train.train import (
    init_train_state,
    make_train_step,
    model_for,
    state_from_trees,
)


class MetricsLogger:
    """One JSON object per logged step in `<workdir>/metrics.jsonl`."""

    def __init__(self, workdir: str):
        os.makedirs(workdir, exist_ok=True)
        self._f = open(os.path.join(workdir, "metrics.jsonl"), "a")

    def log(self, step: int, metrics: dict) -> None:
        row = {"step": step}
        row.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()


def segment_length(cfg: CodecConfig, seconds: float) -> int:
    """Samples per training segment: a whole number of hops, at least one."""
    seg = int(seconds * cfg.sample_rate)
    return max(cfg.hop, (seg // cfg.hop) * cfg.hop)


@torch.no_grad()
def data_init_codebooks(model, state: dict, tcfg: TrainConfig, data_spec: str) -> None:
    """Step-0 codebook init from a warm batch of min(batch, 16) segments of
    the fixed-seed source (the first rows the training stream will see), in
    full float32 like the step."""
    cfg = model.cfg
    warm = next(
        data_lib.make_source(data_spec, cfg.sample_rate, tcfg.seed)
        .batches(min(tcfg.batch_size, 16), segment_length(cfg, tcfg.segment_seconds))
    )
    dev = state["rvq"]["codebooks"].device
    with float32_numerics():
        z = model.train_latents(state["params_g"], torch.from_numpy(warm).to(dev))
        state["rvq"] = rvq_ops.init_codebooks_from_data(
            state["rvq"], z, generator=torch.Generator().manual_seed(tcfg.seed + 77)
        )


def run(
    cfg: CodecConfig,
    tcfg: TrainConfig,
    *,
    workdir: str,
    data_spec: str = "synthetic",
    steps: Optional[int] = None,
    resume: bool = True,
    device=None,
) -> dict:
    """Train to `steps` (default tcfg.steps); returns the last metrics."""
    dev = resolve_device(device)
    steps = tcfg.steps if steps is None else steps
    train_dir = os.path.join(workdir, "train")
    source = data_lib.make_source(data_spec, cfg.sample_rate, tcfg.seed)
    if resume and ckpt.latest_step(train_dir) is not None:
        start, trees, data_state = ckpt.restore(train_dir)
        model, state = model_for(cfg), state_from_trees(trees, dev, step=start)
        source.set_state(data_state)
        print(f"resumed from step {start}")
    else:
        model, state = init_train_state(cfg, tcfg, dev)
        if tcfg.codebook_init == "data":
            data_init_codebooks(model, state, tcfg, data_spec)
            print("codebooks: data-driven init (residual sampling + k-means)")
    step_fn = make_train_step(model, tcfg)
    batches = source.batches(tcfg.batch_size, segment_length(cfg, tcfg.segment_seconds))
    logger = MetricsLogger(workdir)
    metrics: dict = {}
    t0 = time.time()
    try:
        for step in range(state["step"], steps):
            batch = torch.from_numpy(next(batches)).to(dev)
            state, metrics = step_fn(state, batch)
            last = step + 1 == steps
            if (step + 1) % tcfg.log_every == 0 or last:
                m = {k: float(v) for k, v in metrics.items()}
                m["steps_per_sec"] = tcfg.log_every / max(time.time() - t0, 1e-9)
                t0 = time.time()
                logger.log(step + 1, m)
                print(
                    f"step {step + 1}: g={m['loss/g_total']:.4f} "
                    f"d={m.get('loss/d_total', 0.0):.4f} mel={m['loss/mel']:.4f}"
                )
            if (step + 1) % tcfg.checkpoint_every == 0 or last:
                ckpt.save(train_dir, step + 1, state, source.get_state())
    finally:
        logger.close()
    return {k: float(v) for k, v in metrics.items()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nsc_tpu_torch.train")
    p.add_argument("--config", default="base")
    p.add_argument("--workdir", default="./runs/nsc")
    p.add_argument("--data", default="synthetic", help="'synthetic' or 'synthetic2'")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--segment-seconds", type=float, default=None)
    p.add_argument("--no-gan", action="store_true")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--warmup-steps", type=int, default=2000,
                   help="linear LR warmup steps")
    p.add_argument("--lr-decay-steps", type=int, default=-1,
                   help="cosine-decay horizon; -1 = the full run, 0 = constant LR")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default; raises without CUDA) or 'cpu'")
    args = p.parse_args(argv)

    cfg = get_config(args.config)
    overrides = {"seed": args.seed, "warmup_steps": args.warmup_steps}
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.segment_seconds:
        overrides["segment_seconds"] = args.segment_seconds
    if args.no_gan:
        overrides["use_gan"] = False
    tcfg = dataclasses.replace(TrainConfig(), **overrides)
    total = args.steps if args.steps is not None else tcfg.steps
    decay = total if args.lr_decay_steps < 0 else args.lr_decay_steps
    tcfg = dataclasses.replace(tcfg, lr_decay_steps=decay)
    run(cfg, tcfg, workdir=args.workdir, data_spec=args.data, steps=args.steps,
        resume=not args.no_resume, device=args.device)
    return 0
