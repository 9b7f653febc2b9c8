"""Export a run's chosen step as a serving artifact, with its GPU pin
(counterpart of `scripts/export_flagship.py`).

    python3 scripts/torch_export_flagship.py RUN --name NAME [--step N] [--data SPEC]
        [--segment-len SAMPLES] [--dest DIR] [--device cpu]

The step: `--step`, else the one in `best.json`, found in `infer_best/`,
then `infer/`, then `harvest/` (steps the rolling `infer/` already evicted,
`train/harvest.py`); an explicit `--step` found nowhere is an error and
nothing is written. Otherwise the newest step of `infer_best/`, else of
`infer/`.

The artifact is the port's flat export layout in `<dest>` (default
`exports/<name>`): `weights.npz` and `meta.json`, as
`exports/base_fast_synthetic2_48k_refit/` holds them. `meta.json` is the
step's own plus `data` (the run's spec unless `--data` says otherwise),
`segment_len` and `run_dir`; the copy's sha256 is checked against its
`weights_sha256`. A destination that holds other weights (another sha256)
is refused: the JAX script keeps the old checkpoint and rewrites its meta
and pin, which leaves a pin of weights it did not pin beside them.

Then the GPU pin (`canonical.write_pin` on the serving bundle, on CUDA
unless `--device cpu`, as `scripts/torch_write_gpu_pin.py` does) is
written beside it and checked again; the script exits 2 unless the
re-check is exact. `reference_f32.npz` (the JAX package's float32 indices
on the probes) is not written: only the JAX package can compute it
(`scripts/export_torch_checkpoint.py`).
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Callable, Optional

from nsc_tpu_torch import api, canonical
from nsc_tpu_torch.train import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _holds(directory: str, step: int) -> bool:
    return os.path.exists(os.path.join(directory, str(step), ckpt.EXPORT_WEIGHTS))


def select_step(run_dir: str, step: Optional[int] = None,
                log: Callable[[str], None] = print) -> str:
    """The step directory to export (the rules of the module docstring).
    Raises LookupError when an explicit step is missing or the run has no
    export."""
    explicit = step is not None
    best_path = os.path.join(run_dir, "best.json")
    if step is None and os.path.exists(best_path):
        with open(best_path) as f:
            best = json.load(f)
        step = int(best["step"])
        log(f"best.json: {best['metric']}={best['value']:.4f} at step {step}")
    if step is not None:
        # the same step exported twice is the same export
        for sub in ("infer_best", "infer", "harvest"):
            if _holds(os.path.join(run_dir, sub), step):
                return os.path.join(run_dir, sub, str(step))
        if explicit:
            raise LookupError(f"--step {step} not found under {run_dir}/infer_best, "
                              f"{run_dir}/infer or {run_dir}/harvest")
    for sub in ("infer_best", "infer"):
        steps = ckpt.export_steps(os.path.join(run_dir, sub))
        if steps:
            if step is not None:
                log(f"step {step} not in {sub}; using the newest, {steps[-1]}")
            return os.path.join(run_dir, sub, str(steps[-1]))
    raise LookupError(f"no inference export under {run_dir}")


def copy_export(src: str, dest: str, extra: dict, log: Callable[[str], None] = print) -> dict:
    """Write the export of step directory `src` into `dest` (flat: weights.npz
    and meta.json), its meta.json updated with `extra`; each file through a
    temporary name. Raises ValueError when `dest` holds other weights or the
    copy's sha256 is not its meta's. Returns the meta written."""
    with open(os.path.join(src, ckpt.EXPORT_META)) as f:
        meta = json.load(f)
    want = meta["weights_sha256"]
    weights = os.path.join(dest, ckpt.EXPORT_WEIGHTS)
    if os.path.exists(weights):
        have = ckpt._sha256(weights)
        if have != want:
            raise ValueError(f"{dest} holds other weights (sha256 {have}, the step's is {want}); "
                             f"choose another --name or --dest")
        log(f"{dest} already holds these weights; keeping them")
    else:
        os.makedirs(dest, exist_ok=True)
        tmp = weights + ".tmp"
        shutil.copyfile(os.path.join(src, ckpt.EXPORT_WEIGHTS), tmp)
        got = ckpt._sha256(tmp)
        if got != want:
            os.remove(tmp)
            raise ValueError(f"the copy of {src} has sha256 {got}, not meta.json's {want}")
        os.replace(tmp, weights)
        log(f"copied {src} -> {dest}")
    meta.update(extra)
    tmp = os.path.join(dest, ckpt.EXPORT_META + ".tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    os.replace(tmp, os.path.join(dest, ckpt.EXPORT_META))
    return meta


def export_flagship(run_dir: str, name: str, *, step: Optional[int] = None,
                    data: Optional[str] = None, segment_len: Optional[int] = None,
                    dest: Optional[str] = None, device=None,
                    log: Callable[[str], None] = print) -> dict:
    """Select, copy and pin (the module docstring). Returns the export's
    directory, step, meta and the pin's re-check (`canonical.PinCheck`)."""
    run = os.path.abspath(run_dir)
    src = select_step(run, step, log)
    dest = os.path.abspath(dest or os.path.join(REPO, "exports", name))
    with open(os.path.join(src, ckpt.EXPORT_META)) as f:
        src_meta = json.load(f)
    extra = {"data": data or src_meta.get("data") or "synthetic",
             "run_dir": os.path.relpath(run, REPO)}
    if segment_len is not None:
        extra["segment_len"] = int(segment_len)
    meta = copy_export(src, dest, extra, log)
    bundle = api.load_model(meta["config"], checkpoint=dest, serving=True, device=device)
    pin = canonical.write_pin(bundle, dest)
    check = canonical.check_pin(bundle, dest)
    log(f"pinned canonical indices: {pin} ({canonical.backend(bundle.device)})")
    log(f"self-check: exact={check.exact} rate={check.match_rate:.6f} ({check.status})")
    return {"dest": dest, "step": int(meta["step"]), "meta": meta, "pin": pin, "check": check}
