"""Training supervisor for long runs (counterpart of
`scripts/train_watchdog.sh`, rule for rule).

    python3 scripts/torch_train_watchdog.py WORKDIR [train args...]

Launches `python -m nsc_tpu_torch.train --workdir WORKDIR <args>` and
relaunches it when the process dies or when `metrics.jsonl` goes stale;
the loop resumes from the newest full state, so a kill and relaunch is safe.
The rules, each the JAX supervisor's:

- A dead process is seen before the grace check: rc 0 means the run is
  complete, any other rc (a crash, the liveness exits 97/98/99, a kill)
  means a restart.
- A metrics row at `--steps N` means the run is complete.
- No new metrics row for `STALE_S` seconds (600), once `GRACE_S` (1500)
  have passed since the launch (restore and start-up write no rows): the
  process is terminated, killed after 8 s, and relaunched.
- Backoff: a relaunch after which no new metrics row appeared is
  fruitless. After two fruitless restarts, or when the tail of the run's
  log holds "NSC-LIVENESS: DEVICE WEDGED", the next launch waits
  `WEDGE_BACKOFF_S` (300) times the fruitless count, capped at 1800 s:
  restarting does not un-wedge a device.
- The stop file (`STOP_FILE`) ends supervision at the next poll (120 s) and
  leaves the training process alone. A stop file left by an earlier supervisor
  is removed at start: starting the watchdog asks for supervision.
- Before every launch, the leftovers of a killed writer go:
  `train/ckpt_*.pt.tmp` (a full state is ~480 MB for base_fast) and
  `infer/<n>.tmp`, `infer_best/<n>.tmp`.

The trainer's output is appended to `<WORKDIR>.log`, the watchdog's events
to `<WORKDIR>.watchdog.log`; the trainer's PID goes to `PID_FILE`. The
environment variables and their defaults are the JAX supervisor's; the PID
and stop files live in the temporary directory (`/tmp` unless `TMPDIR`
says otherwise).
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Callable, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
POLL_SECONDS = 120.0
BACKOFF_CAP_S = 1800.0
TERM_WAIT_S, KILL_WAIT_S = 8.0, 4.0
MARKER_WEDGED = "NSC-LIVENESS: DEVICE WEDGED"
_LOG_TAIL, _METRICS_TAIL = 4000, 2000


def _env_float(name: str, default: float) -> float:
    return float(os.environ.get(name, default))


def total_steps(args: Sequence[str]) -> Optional[int]:
    """N of `--steps N` or `--steps=N` in the train arguments, else None."""
    m = re.search(r"(?:^| )--steps[= ](\d+)(?: |$)", " ".join(args))
    return int(m.group(1)) if m else None


def _mtime(path: str) -> float:
    try:
        return os.path.getmtime(path)
    except OSError:
        return 0.0


def _tail(path: str, n: int) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(max(0, os.path.getsize(path) - n))
            return f.read().decode("utf-8", "replace")
    except OSError:
        return ""


def logged_step(metrics_path: str, step: int) -> bool:
    """Whether a row of the tail of metrics.jsonl is at `step`."""
    for line in _tail(metrics_path, _METRICS_TAIL).splitlines():
        try:
            if json.loads(line).get("step") == step:
                return True
        except ValueError:  # the tail's first line, cut, or a line being written
            continue
    return False


def clean_leftovers(workdir: str) -> list:
    """Remove what a killed writer leaves: train/ckpt_*.pt.tmp and the
    <n>.tmp directories of infer/ and infer_best/. Returns their paths."""
    gone = glob.glob(os.path.join(workdir, "train", "ckpt_*.pt.tmp"))
    for sub in ("infer", "infer_best"):
        gone += [p for p in glob.glob(os.path.join(workdir, sub, "*.tmp"))
                 if os.path.basename(p)[:-4].isdigit()]
    for p in gone:
        if os.path.isdir(p):
            shutil.rmtree(p, ignore_errors=True)
        else:
            try:
                os.remove(p)
            except FileNotFoundError:
                pass
    return sorted(gone)


@dataclasses.dataclass
class Supervision:
    """What `supervise` saw: `status` is "complete" or "stopped";
    `restarts` counts relaunches; `proc` is the last trainer (still running
    when the run was found complete by its metrics row); `events` the
    watchdog log's lines."""

    status: str
    restarts: int
    proc: Optional[subprocess.Popen]
    events: list


def supervise(workdir: str, args: Sequence[str] = (), *,
              command: Optional[Sequence[str]] = None, poll: float = POLL_SECONDS,
              grace_s: Optional[float] = None, stale_s: Optional[float] = None,
              wedge_backoff_s: Optional[float] = None, pid_file: Optional[str] = None,
              stop_file: Optional[str] = None,
              sleep: Optional[Callable[[float], None]] = None) -> Supervision:
    """Run `command` (default `python -m nsc_tpu_torch.train`) with
    `--workdir WORKDIR *args` under the rules of the module docstring until
    the run is complete or the stop file appears. Knobs left None read the
    environment (GRACE_S, STALE_S, WEDGE_BACKOFF_S, PID_FILE, STOP_FILE)."""
    workdir = os.path.abspath(workdir)
    os.makedirs(workdir, exist_ok=True)
    command = [sys.executable, "-m", "nsc_tpu_torch.train"] if command is None else list(command)
    grace_s = _env_float("GRACE_S", 1500) if grace_s is None else grace_s
    stale_s = _env_float("STALE_S", 600) if stale_s is None else stale_s
    backoff_s = _env_float("WEDGE_BACKOFF_S", 300) if wedge_backoff_s is None else wedge_backoff_s
    tmp = tempfile.gettempdir()
    pid_file = pid_file or os.environ.get("PID_FILE", os.path.join(tmp, "train_run.pid"))
    stop_file = stop_file or os.environ.get("STOP_FILE", os.path.join(tmp, "train_stop"))
    sleep = time.sleep if sleep is None else sleep
    metrics, log_path = os.path.join(workdir, "metrics.jsonl"), workdir + ".log"
    steps = total_steps(args)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    events: list = []

    def event(text: str) -> None:
        line = f"{time.strftime('%Y-%m-%d %H:%M:%S')} {text}"
        events.append(line)
        with open(workdir + ".watchdog.log", "a") as f:
            f.write(line + "\n")

    def stopped() -> bool:
        if os.path.exists(stop_file):
            event("stop file -> exit")
            return True
        return False

    # a stop file left by an earlier supervisor must not end this one
    if os.path.exists(stop_file):
        os.remove(stop_file)
    state = {"fruitless": -1, "last_m": _mtime(metrics), "proc": None, "t": 0.0}

    def launch() -> bool:
        """Start the trainer (after a backoff where one is due); False when
        the stop file appeared during the backoff."""
        m = _mtime(metrics)
        # the last incarnation made progress: reset the wedge counter
        state["fruitless"] = 0 if m > state["last_m"] else state["fruitless"] + 1
        state["last_m"] = m
        n = state["fruitless"]
        if n >= 2 or MARKER_WEDGED in _tail(log_path, _LOG_TAIL):
            wait = min(max(backoff_s * n, backoff_s), BACKOFF_CAP_S)
            event(f"wedge suspected (fruitless={n}) -> backoff {wait:g}s")
            sleep(wait)
            if stopped():
                return False
        for p in clean_leftovers(workdir):
            event(f"removed {os.path.relpath(p, workdir)}")
        with open(log_path, "a") as out:
            proc = subprocess.Popen(command + ["--workdir", workdir, *args], stdout=out,
                                    stderr=subprocess.STDOUT, env=env, start_new_session=True)
        with open(pid_file, "w") as f:
            f.write(f"{proc.pid}\n")
        state["proc"], state["t"] = proc, time.time()
        event(f"launched pid {proc.pid} ({workdir})")
        return True

    def result(status: str) -> Supervision:
        return Supervision(status, restarts, state["proc"], events)

    restarts = 0
    if not launch():  # the first launch is not a restart
        return result("stopped")
    while True:
        sleep(poll)
        if stopped():
            return result("stopped")
        if steps is not None and logged_step(metrics, steps):
            event("run complete")
            return result("complete")
        proc = state["proc"]
        # death before the grace gate: a dead process is unambiguous
        rc = proc.poll()
        if rc is not None:
            if rc == 0:
                event("process exited 0 -> run complete")
                return result("complete")
            event(f"process gone (rc={rc}) -> restart")
            restarts += 1
            if not launch():
                return result("stopped")
            continue
        # the stale check needs the grace: restore and start-up log no rows
        now = time.time()
        if now - state["t"] < grace_s:
            continue
        age = now - _mtime(metrics)
        if age > stale_s:
            event(f"stale {age:.0f}s -> restart")
            proc.terminate()
            try:
                proc.wait(TERM_WAIT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                try:
                    proc.wait(KILL_WAIT_S)
                except subprocess.TimeoutExpired:
                    event(f"pid {proc.pid} survived SIGKILL for {KILL_WAIT_S:g}s")
            restarts += 1
            if not launch():
                return result("stopped")

