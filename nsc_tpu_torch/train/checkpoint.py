"""Training checkpoints: the full train state (parameters, both optimizers,
the RVQ EMA state, the step) and the data stream's position, in one
`torch.save` file per step under the train directory.

Files are written to a temporary name and renamed, so a crash never leaves
a half-written checkpoint under a real name. Every checkpoint is kept
(eviction and keep-best are not ported yet).
"""

from __future__ import annotations

import os
import re
from typing import Any, Optional, Tuple

import torch

from nsc_tpu_torch import weights

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
