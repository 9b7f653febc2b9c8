"""Checkpoints.

Training: the full train state (parameters, optimizers, the RVQ EMA state,
the step) and the data stream's position, in one `torch.save` file per
step under the train directory. Eviction follows orbax's rule: the newest
`max_to_keep` steps stay, and so does every step that is a multiple of
`keep_period`.

Inference exports, in the format `scripts/export_torch_checkpoint.py`
writes for a JAX package checkpoint: `weights.npz` (float32 arrays keyed by
their tree path, "params/encoder/stem/v", "rvq/codebooks") and `meta.json`
(config, step, source, codebook fingerprint, the npz's sha256, the number
of values, and for a training run its data spec). A conv of an int8
calibrated tree carries its "a_s" leaf (`ops.quant`) through the export:
a scalar, or one value per input channel. `save_inference` writes
one under `<directory>/<step>/` and keeps the newest 3, as orbax's default
does. `restore_inference` and `export_meta` take an export directory, such
a step directory's parent, or a training workdir, which resolves to the
newest step of `infer_best/`, else of `infer/` (the JAX package's
preference). The JAX package's orbax stores are not read here.

Every file and export directory is written under a temporary name and
renamed, so a crash never leaves a half-written one under a real name.
"""

from __future__ import annotations

import errno
import hashlib
import json
import os
import re
import shutil
from typing import Any, Optional, Tuple

import numpy as np
import torch

from nsc_tpu_torch import weights
from nsc_tpu_torch.configs import get_config

EXPORT_WEIGHTS, EXPORT_META = "weights.npz", "meta.json"
EXPORT_SCRIPT = "scripts/export_torch_checkpoint.py"
INFER_KEEP = 3

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def path_for(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:09d}.pt")


def kept_steps(steps, max_to_keep: Optional[int], keep_period: Optional[int] = None) -> list:
    """The steps orbax's CheckpointManager keeps of `steps`: all when
    max_to_keep is None, else the newest max_to_keep plus every multiple of
    keep_period."""
    steps = sorted(steps)
    if max_to_keep is None:
        return steps
    newest = set(steps[-max_to_keep:]) if max_to_keep > 0 else set()
    return [s for s in steps if s in newest or (keep_period and s % keep_period == 0)]


def all_steps(directory: str) -> list:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m)


def save(directory: str, step: int, state: dict, data_state: Optional[dict] = None, *,
         max_to_keep: Optional[int] = 3, keep_period: Optional[int] = None) -> str:
    """Write `state` (tensors moved to the CPU) and `data_state` for `step`,
    then evict by orbax's rule."""
    os.makedirs(directory, exist_ok=True)
    host = weights.tree_map(
        lambda x: x.detach().cpu() if isinstance(x, torch.Tensor) else x, state
    )
    path = path_for(directory, step)
    tmp = path + ".tmp"
    torch.save({"step": step, "state": host, "data": data_state}, tmp)
    os.replace(tmp, path)
    steps = all_steps(directory)
    for s in set(steps) - set(kept_steps(steps, max_to_keep, keep_period)):
        os.remove(path_for(directory, s))
    return path


def latest_step(directory: str) -> Optional[int]:
    steps = all_steps(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: Optional[int] = None) -> Tuple[int, Any, Optional[dict]]:
    """(step, state with CPU tensors, data state) of `step` (default: the
    latest)."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    blob = torch.load(path_for(directory, step), map_location="cpu", weights_only=True)
    return blob["step"], blob["state"], blob["data"]


# ---------------------------------------------------------------------------
# inference exports
# ---------------------------------------------------------------------------


def _array(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def _flatten(tree, prefix: str, out: dict) -> dict:
    """Nested dicts/lists of tensors or arrays -> {"a/b/0/c": float32 array};
    None leaves (elu activations) are left out."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out)
    elif tree is not None:
        out[prefix] = _array(tree)
    return out


def export_arrays(params_g, rvq) -> dict:
    """The npz arrays of an export: the generator tree in the JAX layout
    (weight-norm as (v, g) leaves, as the train state holds it) and the
    codebooks."""
    arrays = _flatten(params_g, "params", {})
    arrays["rvq/codebooks"] = _array(rvq["codebooks"])
    return arrays


def export_steps(directory: str) -> list:
    """The step directories of `directory` that hold an export."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(n) for n in os.listdir(directory)
                  if n.isdigit() and os.path.exists(os.path.join(directory, n, EXPORT_WEIGHTS)))


def save_inference(directory: str, step: int, params_g, rvq, meta: dict, *,
                   max_to_keep: Optional[int] = INFER_KEEP) -> str:
    """Export (params_g, rvq codebooks) to `<directory>/<step>/`: weights.npz
    and meta.json (`meta`'s fields, e.g. config, source and data, plus step,
    fingerprint, weights_sha256 and values); then keep the newest
    `max_to_keep` steps. Returns the step directory."""
    from nsc_tpu_torch.api import codebook_fingerprint  # api imports this module

    arrays = export_arrays(params_g, rvq)
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, str(step))
    tmp = final + ".tmp"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    path = os.path.join(tmp, EXPORT_WEIGHTS)
    np.savez(path, **arrays)
    out = dict(meta)
    out.update({
        "step": step,
        "fingerprint": codebook_fingerprint({"codebooks": torch.from_numpy(arrays["rvq/codebooks"])}),
        "weights_sha256": _sha256(path),
        "values": int(sum(a.size for a in arrays.values())),
    })
    with open(os.path.join(tmp, EXPORT_META), "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    steps = export_steps(directory)
    for s in set(steps) - set(kept_steps(steps, max_to_keep)):
        shutil.rmtree(os.path.join(directory, str(s)))
    return final


def resolve_export(directory: str) -> str:
    """The export a directory names: the newest step of `infer_best/`, else
    of `infer/` (a training workdir), else its own newest step (an
    `infer/`-like directory), else the directory itself."""
    for sub in ("infer_best", "infer"):
        steps = export_steps(os.path.join(directory, sub))
        if steps:
            return os.path.join(directory, sub, str(steps[-1]))
    steps = export_steps(directory)
    return os.path.join(directory, str(steps[-1])) if steps else directory


def _is_orbax(directory: str) -> bool:
    """An orbax checkpoint directory as the JAX package writes it: with
    `_CHECKPOINT_METADATA`, or with a step directory that holds one, itself
    or under `infer`/`infer_best`."""
    def holds_orbax_step(d):
        return os.path.isdir(d) and (
            os.path.exists(os.path.join(d, "_CHECKPOINT_METADATA"))
            or any(n.isdigit() and os.path.exists(os.path.join(d, n, "_CHECKPOINT_METADATA"))
                   for n in os.listdir(d)))

    return holds_orbax_step(directory) or any(
        holds_orbax_step(os.path.join(directory, sub)) for sub in ("infer", "infer_best"))


def export_meta(directory: str) -> dict:
    """`meta.json` of the export `directory` resolves to (`resolve_export`).
    An orbax checkpoint raises a ValueError that names the export script; a
    directory without an export raises FileNotFoundError."""
    target = resolve_export(directory)
    if not os.path.exists(os.path.join(target, EXPORT_WEIGHTS)):
        if _is_orbax(directory):
            raise ValueError(
                f"{directory} is an orbax checkpoint, which only the JAX package "
                f"reads; export it for the port first: python {EXPORT_SCRIPT} {directory}"
            )
        raise FileNotFoundError(
            errno.ENOENT, f"no exported checkpoint (see {EXPORT_SCRIPT})",
            os.path.join(target, EXPORT_WEIGHTS),
        )
    with open(os.path.join(target, EXPORT_META)) as f:
        return json.load(f)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def restore_inference(directory: str) -> Tuple[dict, dict]:
    """The (params, rvq) trees of the export `directory` resolves to
    (`resolve_export`), as numpy float32 arrays in the JAX package's layout
    (what `weights.from_jax_params` takes). The npz must match the sha256 in
    `meta.json`, and its leaves the config's tree exactly (paths and
    shapes)."""
    meta = export_meta(directory)
    path = os.path.join(resolve_export(directory), EXPORT_WEIGHTS)
    digest = _sha256(path)
    if digest != meta["weights_sha256"]:
        raise ValueError(
            f"{path}: sha256 {digest} does not match meta.json's {meta['weights_sha256']}"
        )
    with np.load(path, allow_pickle=False) as z:
        arrays = {k: z[k] for k in z.files}
    # the config's tree in the JAX layout, with its leaves replaced by path
    template = weights.init_jax_layout(get_config(meta["config"]), 0)

    def fill(tree, prefix):
        if isinstance(tree, dict):
            out = {k: fill(v, f"{prefix}/{k}") for k, v in tree.items()}
            scale = arrays.pop(f"{prefix}/a_s", None)
            if scale is not None:
                w = tree.get("v", tree.get("w"))
                if w is None or scale.dtype != np.float32 or scale.shape not in ((), np.shape(w)[1:2]):
                    raise ValueError(
                        f"{path}: {prefix}/a_s is {scale.dtype}{list(scale.shape)}, not the "
                        f"calibration scale of a conv"
                    )
                out["a_s"] = scale
            return out
        if isinstance(tree, (list, tuple)):
            return type(tree)(fill(v, f"{prefix}/{i}") for i, v in enumerate(tree))
        if tree is None:
            return None
        if prefix not in arrays:
            raise ValueError(f"{path}: no leaf {prefix!r}")
        leaf = arrays.pop(prefix)
        if leaf.shape != np.shape(tree) or leaf.dtype != np.float32:
            raise ValueError(
                f"{path}: {prefix!r} is {leaf.dtype}{list(leaf.shape)}, "
                f"expected float32{list(np.shape(tree))}"
            )
        return leaf

    params, rvq = fill(template[0], "params"), fill(template[1], "rvq")
    if arrays:
        raise ValueError(f"{path}: leaves not in the {meta['config']} tree: {sorted(arrays)}")
    return params, rvq
