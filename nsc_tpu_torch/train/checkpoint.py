"""Checkpoints.

Training: the full train state (parameters, both optimizers, the RVQ EMA
state, the step) and the data stream's position, in one `torch.save` file
per step under the train directory. Files are written to a temporary name
and renamed, so a crash never leaves a half-written checkpoint under a real
name. Every checkpoint is kept (eviction and keep-best are not ported yet).

Inference: `restore_inference` reads an export of a JAX package checkpoint
(`scripts/export_torch_checkpoint.py`): `weights.npz` (float32 arrays keyed
by their tree path, "params/encoder/stem/v", "rvq/codebooks") and
`meta.json` (config, step, source, codebook fingerprint, the npz's sha256),
with numpy alone. The JAX package's orbax stores are not read here.
"""

from __future__ import annotations

import errno
import hashlib
import json
import os
import re
from typing import Any, Optional, Tuple

import numpy as np
import torch

from nsc_tpu_torch import weights
from nsc_tpu_torch.configs import get_config

EXPORT_WEIGHTS, EXPORT_META = "weights.npz", "meta.json"
EXPORT_SCRIPT = "scripts/export_torch_checkpoint.py"

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def path_for(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step:09d}.pt")


def save(directory: str, step: int, state: dict, data_state: Optional[dict] = None) -> str:
    """Write `state` (tensors moved to the CPU) and `data_state` for `step`."""
    os.makedirs(directory, exist_ok=True)
    host = weights.tree_map(
        lambda x: x.detach().cpu() if isinstance(x, torch.Tensor) else x, state
    )
    path = path_for(directory, step)
    tmp = path + ".tmp"
    torch.save({"step": step, "state": host, "data": data_state}, tmp)
    os.replace(tmp, path)
    return path


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for m in map(_NAME.match, os.listdir(directory)) if m]
    return max(steps) if steps else None


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


def _is_orbax(directory: str) -> bool:
    """An orbax checkpoint directory as the JAX package writes it: a step
    directory with `_CHECKPOINT_METADATA`, or `infer`/`infer_best` beside
    them."""
    if not os.path.isdir(directory):
        return False
    names = os.listdir(directory)
    return "_CHECKPOINT_METADATA" in names or any(
        n in ("infer", "infer_best")
        or (n.isdigit() and os.path.exists(os.path.join(directory, n, "_CHECKPOINT_METADATA")))
        for n in names
    )


def export_meta(directory: str) -> dict:
    """`meta.json` of the export at `directory`. An orbax checkpoint raises
    a ValueError that names the export script; a directory without an export
    raises FileNotFoundError."""
    path = os.path.join(directory, EXPORT_META)
    if not os.path.exists(os.path.join(directory, EXPORT_WEIGHTS)):
        if _is_orbax(directory):
            raise ValueError(
                f"{directory} is an orbax checkpoint, which only the JAX package "
                f"reads; export it for the port first: python {EXPORT_SCRIPT} {directory}"
            )
        raise FileNotFoundError(
            errno.ENOENT, f"no exported checkpoint (see {EXPORT_SCRIPT})",
            os.path.join(directory, EXPORT_WEIGHTS),
        )
    with open(path) as f:
        return json.load(f)


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def restore_inference(directory: str) -> Tuple[dict, dict]:
    """The (params, rvq) trees of the export at `directory`, as numpy
    float32 arrays in the JAX package's layout (what
    `weights.from_jax_params` takes). The npz must match the sha256 in
    `meta.json`, and its leaves the config's tree exactly (paths and
    shapes)."""
    meta = export_meta(directory)
    path = os.path.join(directory, EXPORT_WEIGHTS)
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
            return {k: fill(v, f"{prefix}/{k}") for k, v in tree.items()}
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
