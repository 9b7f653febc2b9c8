"""Harvest a live run's rolling inference exports (counterpart of
`scripts/harvest_checkpoints.sh`).

    python3 scripts/torch_harvest_checkpoints.py RUN [PID_FILE]

The training loop keeps only the newest 3 `infer/<step>/` exports
(`checkpoint.INFER_KEEP`), and `infer_best/` is chosen by the windowed
train mel. A run whose held-out quality peaks mid-run and then declines
loses that export to eviction before the run ends. This sidecar copies
every `infer/<step>/` into `<run>/harvest/<step>/`, so that the held-out
trend (`eval/heldout.py`) can score every step and the export
(`train/export.py`) can take an evicted one.

Each step is copied to `harvest/.tmp_<step>`, its `weights.npz` checked
against the `weights_sha256` of its `meta.json`, then renamed into place.
The loop renames an export into place when it is complete, so the newest
step can be copied as soon as it appears (the JAX sidecar waits for a newer
one). What remains is eviction during the copy: a source that vanishes
mid-copy is a miss, said on stderr, and its tmp directory is dropped.
Names that are not all digits (`<step>.tmp`, a half-written export) are
skipped.

The loop sweeps every `poll` seconds (90) and, once the PID in the PID file
is gone (or the file is), makes a final sweep and returns. Give it a PID
that outlives the run's restarts, such as the watchdog's: the trainer's own
PID is gone for a moment at each relaunch.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time
from typing import Callable

from nsc_tpu_torch.train import checkpoint as ckpt

DEFAULT_PID_FILE = os.path.join(tempfile.gettempdir(), "train_run.pid")
POLL_SECONDS = 90.0


def _stamp() -> str:
    return time.strftime("%H:%M:%S", time.gmtime())


def copy_step(run_dir: str, step: int) -> bool:
    """Copy `infer/<step>` into `harvest/<step>`; True when it was copied
    now. A step already harvested is left as it is; a source that vanished
    or whose weights do not match its sha256 is a miss (said on stderr)."""
    src = os.path.join(run_dir, "infer", str(step))
    harvest = os.path.join(run_dir, "harvest")
    dst = os.path.join(harvest, str(step))
    if os.path.isdir(dst):
        return False
    tmp = os.path.join(harvest, f".tmp_{step}")
    shutil.rmtree(tmp, ignore_errors=True)
    try:
        shutil.copytree(src, tmp)
        with open(os.path.join(tmp, ckpt.EXPORT_META)) as f:
            want = json.load(f)["weights_sha256"]
        got = ckpt._sha256(os.path.join(tmp, ckpt.EXPORT_WEIGHTS))
    except OSError as e:  # evicted during the copy (shutil.Error is an OSError)
        shutil.rmtree(tmp, ignore_errors=True)
        print(f"{_stamp()} missed {step}: the export vanished during the copy ({e})",
              file=sys.stderr)
        return False
    if got != want:
        shutil.rmtree(tmp, ignore_errors=True)
        print(f"{_stamp()} missed {step}: weights.npz sha256 {got} is not meta.json's {want}",
              file=sys.stderr)
        return False
    os.replace(tmp, dst)
    return True


def harvest_once(run_dir: str, log: Callable[[str], None] = print) -> list:
    """One sweep of `infer/`: the steps harvested now."""
    infer = os.path.join(run_dir, "infer")
    if not os.path.isdir(infer):
        return []
    os.makedirs(os.path.join(run_dir, "harvest"), exist_ok=True)
    got = []
    for step in sorted(int(n) for n in os.listdir(infer) if n.isdigit()):
        if copy_step(run_dir, step):
            log(f"{_stamp()} harvested {step}")
            got.append(step)
    return got


def pid_alive(pid_file: str) -> bool:
    """Whether the PID in `pid_file` names a live process (False when the
    file is missing or holds no PID)."""
    try:
        with open(pid_file) as f:
            pid = int(f.read().strip())
    except (OSError, ValueError):
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:  # alive, another user's
        return True
    return True


def harvest(run_dir: str, pid_file: str = DEFAULT_PID_FILE, *, poll: float = POLL_SECONDS,
            log: Callable[[str], None] = print) -> list:
    """Sweep every `poll` seconds until the PID in `pid_file` is gone, then
    sweep once more and return every step harvested."""
    got = []
    while True:
        got += harvest_once(run_dir, log)
        if not pid_alive(pid_file):
            got += harvest_once(run_dir, log)
            log(f"{_stamp()} training pid gone; harvest complete")
            return got
        time.sleep(poll)
