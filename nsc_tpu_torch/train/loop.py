"""The training loop and its entry point (counterpart of
`nsc_tpu/train/loop.py`).

    python -m nsc_tpu_torch.train --config base_fast --data synthetic2:pool=8192 \
        --steps N --workdir DIR [--checkpoint-every K] [--full-state-every F] [--device cpu]

Runs on CUDA unless `--device cpu` is given, and raises when CUDA is asked
for and absent. Data: 'synthetic', 'synthetic2', a directory of WAVs,
'grain:<dir>' (the port's on-demand reader) and a ':pool=N' suffix
(`train/data.py`); batches are built on a background thread and copied to
the device one step ahead (pinned host memory, non-blocking copies).

Fresh runs start from seeded weights with the step-0 data-driven codebook
init; a workdir with a full checkpoint resumes from it (parameters,
optimizers, RVQ state, step and the data stream's position), bit-exactly
on the CPU. In `<workdir>`:

  metrics.jsonl   one row per logged step
  train/          full train states every `full_state_every` steps counted
                  from the last full save (forced at a fresh run's first
                  checkpoint boundary and at the end), evicted with
                  `keep_checkpoints` / `keep_period`
  infer/          an inference export at every checkpoint boundary (the
                  newest 3 kept), which `api.load_model(checkpoint=<workdir>)`
                  and the CLI read
  infer_best/     an export whenever the mean of `best_metric` over the log
                  rows since the last boundary improves; `best.json` records
                  it and survives restarts

On a CUDA device the snapshots are written by a thread (`SnapshotWriter`),
inline on the CPU; the final save is inline everywhere.

Liveness (`utils/liveness.py`, the JAX package's guards): a deadline-
guarded probe of the device before any start-up work (exit 97 when it
hangs); on a CUDA device, where the snapshots run on a thread, a
`Heartbeat` beaten at every log row and checkpoint boundary (exit 98 after
a silence); and at each checkpoint boundary before the last, when the
host's RSS is above `rss_exit_limit_gb()`, a synchronous full save and
exit 99, for a relaunch that resumes.

`--debug-nans` (the counterpart of `jax_debug_nans`): every step runs
under `torch.autograd.detect_anomaly`, so a backward function that returns
a NaN raises, and every step's losses and metrics are read back and checked;
the first non-finite one raises `FloatingPointError` naming the step (and
the metric, or the backward function). What it does not see, unlike
`jax_debug_nans`: a NaN or inf in forward values that no metric reports
and no gradient carries (the RVQ's EMA statistics, the optimizer's
update), until it reaches a metric in a later step.

Data parallelism (`--distributed`, `run(..., distributed=True)`; the
JAX package's `--multihost` mesh): one process per device, started by
`torchrun` / `python -m torch.distributed.run`, which sets the `env://`
variables; NCCL on cards (device `cuda:<LOCAL_RANK>`), gloo with
`--device cpu`. `batch_size` is the global batch and must divide by the
world size; each rank reads `batch_size // world` rows from its own stream
(seed + 1009 x rank; the on-demand reader's shard `rank` of `world`). The
data init runs on rank 0 and every rank starts from rank 0's state
(`parallel.replicate`, checked bit for bit). The step keeps the state
identical across ranks (`parallel.make_parallel_train_step`). Only rank 0
writes metrics, exports, snapshots and best.json; the liveness guards run
on every rank (the RSS exit when any rank passes its limit). A full save
keeps every rank's stream position ({"world": W, "ranks": [...]}), and a
resume at the same world size continues each rank's stream; at another
world size the streams start again from their seeds, and the run says so.

Not ported: the tensorboard writer of the JAX package's `MetricsLogger`.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import os
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from nsc_tpu_torch import weights
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
from nsc_tpu_torch.utils import liveness


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


class SnapshotWriter:
    """Writes checkpoints of a state that the train step keeps updating in
    place. On a CUDA device `submit` clones the tree on the device in the
    current stream, records an event, and a thread copies the clone to the
    host on its own stream (after waiting on the event) and calls `write`
    with it; elsewhere, and with sync=True, `write` runs inline on the live
    tree. At most one write is in flight: `submit` first joins the previous
    one, which bounds device memory at the state plus one copy. A writer's
    exception is raised again on the caller's thread by the next `submit`
    or `join`."""

    def __init__(self, device: torch.device):
        self.threaded = device.type == "cuda"
        self._stream = torch.cuda.Stream(device) if self.threaded else None
        self._thread: Optional[threading.Thread] = None
        self._err: list = []

    def wait(self) -> None:
        """Wait for the write in flight, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def join(self) -> None:
        """`wait`, then raise the writer's exception, if any."""
        self.wait()
        if self._err:
            raise self._err.pop()

    def submit(self, tree, write: Callable, *, sync: bool = False) -> None:
        self.join()
        if sync or not self.threaded:
            write(weights.tree_map(_to_host, tree))
            return
        snap = weights.tree_map(_clone, tree)
        ready = torch.cuda.Event()
        ready.record()

        def work():
            try:
                with torch.cuda.stream(self._stream):
                    self._stream.wait_event(ready)
                    host = weights.tree_map(_to_host, snap)
                    self._stream.synchronize()
                write(host)
            except BaseException as e:  # raised again on the training thread
                self._err.append(e)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()


def _clone(x):
    return x.detach().clone() if isinstance(x, torch.Tensor) else x


def _to_host(x):
    return x.detach().to("cpu") if isinstance(x, torch.Tensor) else x


def segment_length(cfg: CodecConfig, seconds: float) -> int:
    """Samples per training segment: a whole number of hops, at least one."""
    seg = int(seconds * cfg.sample_rate)
    return max(cfg.hop, (seg // cfg.hop) * cfg.hop)


def warm_batch(cfg: CodecConfig, tcfg: TrainConfig, data_spec: str) -> np.ndarray:
    """The data init's batch: min(batch, 16) segments of the fixed-seed
    source without its ':pool=' suffix (one batch must not build a pool),
    the JAX package's warm batch."""
    source = data_lib.make_source(data_lib.strip_pool(data_spec), cfg.sample_rate, tcfg.seed)
    return next(source.batches(min(tcfg.batch_size, 16), segment_length(cfg, tcfg.segment_seconds)))


@torch.no_grad()
def data_init_codebooks(model, state: dict, tcfg: TrainConfig, data_spec: str) -> None:
    """Step-0 codebook init from `warm_batch`, in full float32 like the
    step."""
    warm = warm_batch(model.cfg, tcfg, data_spec)
    dev = state["rvq"]["codebooks"].device
    with float32_numerics():
        z = model.train_latents(state["params_g"], torch.from_numpy(warm).to(dev))
        state["rvq"] = rvq_ops.init_codebooks_from_data(
            state["rvq"], z, generator=torch.Generator().manual_seed(tcfg.seed + 77)
        )


def batch_to_device(item, dev: torch.device):
    """(numpy batch, data state) -> (batch tensor on `dev`, data state); to
    a card through pinned host memory, without waiting for the copy."""
    batch, data_state = item
    t = torch.from_numpy(batch)
    if dev.type == "cuda":
        t = t.pin_memory().to(dev, non_blocking=True)
    return t, data_state


def export_fields(cfg: CodecConfig, workdir: str, data_spec: str) -> dict:
    """The meta.json fields of a run's inference exports (step, fingerprint,
    sha256 and size are added per export)."""
    return {"config": cfg.name, "source": os.path.abspath(workdir), "data": data_spec}


def write_json(path: str, obj: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def run(
    cfg: CodecConfig,
    tcfg: TrainConfig,
    *,
    workdir: str,
    data_spec: str = "synthetic",
    steps: Optional[int] = None,
    resume: bool = True,
    device=None,
    debug_nans: bool = False,
    distributed: bool = False,
    deterministic: bool = False,
) -> dict:
    """Train to `steps` (default tcfg.steps); returns the last metrics.
    Exits 97 when the device does not answer its probe, 98 when a CUDA run
    stalls, 99 after a full save when the host's RSS passes its limit (see
    the module doc); `debug_nans` raises FloatingPointError at the first
    non-finite loss, metric or gradient. `distributed`: data parallelism
    over the default process group (initialised from `env://` when it is
    not yet), see the module doc. `deterministic`: PyTorch's deterministic
    algorithms and cuDNN's deterministic convolutions for the run, so two
    runs of the same arguments log the same metrics bit for bit."""
    if deterministic:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    with deterministic_algorithms(deterministic):
        return _run(cfg, tcfg, workdir=workdir, data_spec=data_spec, steps=steps, resume=resume,
                    device=device, debug_nans=debug_nans, distributed=distributed)


@contextlib.contextmanager
def deterministic_algorithms(on: bool = True):
    """PyTorch's deterministic algorithms (warnings, not errors, where an op
    has none) and cuDNN's deterministic convolutions while the block runs;
    the caller's settings come back after it. cuBLAS needs
    CUBLAS_WORKSPACE_CONFIG set before its first use."""
    if not on:
        yield
        return
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved[2:]


def _run(cfg, tcfg, *, workdir, data_spec, steps, resume, device, debug_nans,
         distributed) -> dict:
    mesh = None
    if distributed:
        from nsc_tpu_torch import parallel

        mesh = parallel.make_mesh(device)
        dev = mesh.device
    else:
        dev = resolve_device(device)
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.size)
    lead = rank == 0
    if tcfg.batch_size % world:
        raise ValueError(f"batch {tcfg.batch_size} not divisible by {world} ranks")
    # before any start-up work: a hung device fails here in bounded time
    liveness.device_liveness_check(probe=functools.partial(liveness._default_probe, dev))
    steps = tcfg.steps if steps is None else steps
    train_dir = os.path.join(workdir, "train")
    # each rank its own stream (the JAX package's per-process seed offset)
    source = data_lib.make_source(data_spec, cfg.sample_rate, tcfg.seed + 1009 * rank,
                                  shard=(rank, world) if mesh is not None else None)
    if hasattr(source, "set_cache_dir"):
        source.set_cache_dir(workdir)
    start = 0
    if resume and ckpt.latest_step(train_dir) is not None:
        start, trees, data_state = ckpt.restore(train_dir)
        model, state = model_for(cfg), state_from_trees(trees, dev, step=start)
        data_state = rank_data_state(data_state, rank, world)
        if data_state is not None:
            source.set_state(data_state)
        if lead:
            print(f"resumed from step {start}")
    else:
        model, state = init_train_state(cfg, tcfg, dev)
        if tcfg.codebook_init == "data" and lead:
            data_init_codebooks(model, state, tcfg, data_spec)
            print("codebooks: data-driven init (residual sampling + k-means)")
    if mesh is not None:
        from nsc_tpu_torch import parallel

        # rank 0's state on every rank (its data init), checked bit for bit
        parallel.replicate(mesh, state)
        step_fn = parallel.make_parallel_train_step(model, tcfg, mesh)
    else:
        step_fn = make_train_step(model, tcfg)
    seg = segment_length(cfg, tcfg.segment_seconds)
    batches = data_lib.Prefetcher(
        data_lib.batches_with_state(source, tcfg.batch_size // world, seg))
    logger = MetricsLogger(workdir) if lead else None
    writer = SnapshotWriter(dev)
    meta = export_fields(cfg, workdir, data_spec)
    best_path = os.path.join(workdir, "best.json")
    best = math.inf
    if resume and os.path.exists(best_path):
        with open(best_path) as f:
            best = float(json.load(f)["value"])

    def write(host, step1, full, improved, best_val, data_state):
        if full:
            ckpt.save(train_dir, step1, host, data_state, max_to_keep=tcfg.keep_checkpoints,
                      keep_period=tcfg.keep_period or None)
        ckpt.save_inference(os.path.join(workdir, "infer"), step1,
                            host["params_g"], host["rvq"], meta)
        if improved:
            ckpt.save_inference(os.path.join(workdir, "infer_best"), step1,
                                host["params_g"], host["rvq"], meta)
            write_json(best_path, {"metric": tcfg.best_metric, "value": best_val, "step": step1})

    # the best metric is compared as a mean over the rows logged since the
    # last checkpoint boundary, not one batch's value; full saves count
    # steps since the last full save (a resume starts at one), and a fresh
    # run's first boundary is a full save
    window: list = []
    last_full, have_full = start, start > 0
    metrics: dict = {}
    # the stall detector where snapshots run on a thread (as the JAX
    # package's, which runs it with its async checkpoints)
    hb = liveness.Heartbeat() if writer.threaded else None
    t0 = time.time()
    try:
        pending = batch_to_device(next(batches), dev) if start < steps else None
        for step in range(start, steps):
            batch, data_state = pending
            last = step + 1 == steps
            if not last:
                pending = batch_to_device(next(batches), dev)
            if debug_nans:
                state, metrics = _checked_step(step_fn, state, batch, step + 1)
            else:
                state, metrics = step_fn(state, batch)
            if (step + 1) % tcfg.log_every == 0 or last:
                m = {k: float(v) for k, v in metrics.items()}
                if hb is not None:
                    hb.beat(step + 1)  # float() above waited for the device
                m["steps_per_sec"] = tcfg.log_every / max(time.time() - t0, 1e-9)
                t0 = time.time()
                if tcfg.best_metric in m:
                    window.append(m[tcfg.best_metric])
                if lead:
                    logger.log(step + 1, m)
                    print(
                        f"step {step + 1}: g={m['loss/g_total']:.4f} "
                        f"d={m.get('loss/d_total', 0.0):.4f} mel={m['loss/mel']:.4f}"
                    )
            if (step + 1) % tcfg.checkpoint_every == 0 or last:
                if not window:
                    window.append(float(metrics.get(tcfg.best_metric, math.inf)))
                val = float(np.mean(window))
                window = []
                improved = bool(np.isfinite(val) and val < best)
                if improved:
                    best = val
                if hb is not None:
                    hb.beat(step + 1)  # the save below gets a whole deadline
                # the host-RSS guard: past the limit, a synchronous full save
                # and exit 99, so a relaunch resumes here
                rss_limit = liveness.rss_exit_limit_gb()
                rss_gb = liveness.host_rss_gb() if rss_limit is not None else 0.0
                rss_exit = rss_limit is not None and rss_gb > rss_limit and not last
                if mesh is not None:  # every rank exits when one passes its limit
                    rss_exit = any(mesh.all_gather_object(rss_exit))
                full = (rss_exit or not tcfg.full_state_every or not have_full or last
                        or step + 1 - last_full >= tcfg.full_state_every)
                if full:
                    last_full, have_full = step + 1, True
                tree = state if full else {"params_g": state["params_g"], "rvq": state["rvq"]}
                sync = last or rss_exit
                if sync and hb is not None:
                    hb.stop()  # a long final save is not a stall
                saved_data = data_state
                if mesh is not None and full:  # every rank's stream position
                    saved_data = {"world": world, "ranks": mesh.all_gather_object(data_state)}
                if lead:
                    writer.submit(tree, lambda host, a=(step + 1, full, improved, best, saved_data):
                                  write(host, *a), sync=sync)
                if rss_exit:
                    writer.join()
                    if mesh is not None:
                        mesh.barrier()  # rank 0's save is on disk
                    print(f"{liveness._MARKER_RSS}: rss {rss_gb:.1f} GB > limit "
                          f"{rss_limit:.1f} GB; full state saved at step {step + 1}; exiting "
                          f"{liveness.EXIT_RSS_LIMIT} for a relaunch that resumes", flush=True)
                    raise SystemExit(liveness.EXIT_RSS_LIMIT)
        writer.join()
    finally:
        if hb is not None:
            hb.stop()
        writer.wait()
        batches.close()
        if logger is not None:
            logger.close()
    if mesh is not None:
        mesh.barrier()  # rank 0's final save is on disk when run returns
    return {k: float(v) for k, v in metrics.items()}


def rank_data_state(saved, rank: int, world: int):
    """This rank's stream position from a full save's data state: a
    distributed run's save holds {"world": W, "ranks": [...]}, another run's
    the one position. Returns None (the stream starts from its seed, with a
    message) when the save was made at another world size."""
    if saved is None:
        return None
    ranks = saved["ranks"] if isinstance(saved, dict) and "ranks" in saved else [saved]
    if len(ranks) == world:
        return ranks[rank]
    if rank == 0:
        print(f"the checkpoint's data streams are of {len(ranks)} ranks, this run has "
              f"{world}: each rank's stream starts from its seed")
    return None


def _checked_step(step_fn, state, batch, step1: int):
    """One step under `--debug-nans`: the backward under anomaly detection,
    then every loss and metric read back; the first non-finite one raises
    FloatingPointError naming the step."""
    try:
        with torch.autograd.detect_anomaly(check_nan=True):
            state, metrics = step_fn(state, batch)
    except RuntimeError as e:
        if "nan" not in str(e).lower():
            raise
        raise FloatingPointError(f"step {step1}: non-finite gradient: {e}") from e
    for name, value in metrics.items():
        v = torch.as_tensor(value)
        if not bool(torch.isfinite(v).all()):
            raise FloatingPointError(f"step {step1}: non-finite {name} = {v.tolist()}")
    return state, metrics


def parse_args(argv=None) -> tuple[CodecConfig, TrainConfig, dict]:
    """The entry point's arguments -> (config, train config, the keyword
    arguments of `run` besides those two)."""
    p = argparse.ArgumentParser(prog="nsc_tpu_torch.train")
    p.add_argument("--config", default="base")
    p.add_argument("--workdir", default="./runs/nsc")
    p.add_argument("--data", default="synthetic",
                   help="'synthetic', 'synthetic2', a directory of WAVs or 'grain:<dir>' "
                   "(read on demand by the port's own reader); ':pool=N' pre-generates N "
                   "segments and samples them")
    p.add_argument("--steps", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--segment-seconds", type=float, default=None)
    p.add_argument("--no-gan", action="store_true")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--warmup-steps", type=int, default=2000,
                   help="linear LR warmup steps")
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="checkpoint cadence in steps (TrainConfig.checkpoint_every)")
    p.add_argument("--full-state-every", type=int, default=None,
                   help="full train-state cadence in steps since the last full save; other "
                   "boundaries write the inference export only (0 = every boundary is full); "
                   "a resume starts from a full save")
    p.add_argument("--lr-decay-steps", type=int, default=-1,
                   help="cosine-decay horizon; -1 = the full run, 0 = constant LR")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default; raises without CUDA) or 'cpu'")
    p.add_argument("--debug-nans", action="store_true",
                   help="anomaly detection in the backward and a finiteness check of every "
                   "step's losses and metrics: raise FloatingPointError at the first "
                   "non-finite value instead of training on")
    p.add_argument("--distributed", action="store_true",
                   help="data parallelism over torch.distributed, one process per device, "
                   "initialised from the env:// variables that torchrun sets (NCCL on cards: "
                   "cuda:<LOCAL_RANK>; gloo with --device cpu); --batch-size is the global "
                   "batch")
    p.add_argument("--deterministic", action="store_true",
                   help="PyTorch's deterministic algorithms and cuDNN's deterministic "
                   "convolutions, so that two runs log the same metrics bit for bit")
    args = p.parse_args(argv)

    cfg = get_config(args.config)
    overrides = {"seed": args.seed, "warmup_steps": args.warmup_steps}
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.segment_seconds:
        overrides["segment_seconds"] = args.segment_seconds
    if args.no_gan:
        overrides["use_gan"] = False
    if args.checkpoint_every is not None:
        overrides["checkpoint_every"] = args.checkpoint_every
    if args.full_state_every is not None:
        overrides["full_state_every"] = args.full_state_every
    tcfg = dataclasses.replace(TrainConfig(), **overrides)
    total = args.steps if args.steps is not None else tcfg.steps
    decay = total if args.lr_decay_steps < 0 else args.lr_decay_steps
    tcfg = dataclasses.replace(tcfg, lr_decay_steps=decay)
    return cfg, tcfg, {"workdir": args.workdir, "data_spec": args.data, "steps": args.steps,
                       "resume": not args.no_resume, "device": args.device,
                       "debug_nans": args.debug_nans, "distributed": args.distributed,
                       "deterministic": args.deterministic}


def main(argv=None) -> int:
    cfg, tcfg, kwargs = parse_args(argv)
    started = kwargs["distributed"] and not torch.distributed.is_initialized()
    try:
        run(cfg, tcfg, **kwargs)
    finally:
        if started and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return 0
