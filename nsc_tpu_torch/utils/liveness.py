"""Device liveness and in-process stall detection (counterpart of
`nsc_tpu/utils/liveness.py`).

A device call that hangs (a wedged card) looks, from outside the
process, like a slow start, so a supervisor cannot tell the two apart.
These helpers give the process a voice of its own:

- `device_liveness_check` proves the device answers a tiny op with a host
  readback within a deadline, else prints a one-line diagnosis and exits
  with `EXIT_DEVICE_WEDGED`. Run it before expensive start-up work.
- `Heartbeat` is a training-loop stall detector: the loop calls
  `Heartbeat.beat` at its synchronous points (metric readbacks); a monitor
  thread exits the process with `EXIT_STALLED` if no beat arrives within
  the deadline.
- `rss_exit_limit_gb` / `host_rss_gb`: the host-RSS ceiling at which the
  training loop saves a full state and exits `EXIT_RSS_LIMIT`, for a clean
  relaunch and resume instead of the OOM killer's SIGKILL.

A hung device call cannot be interrupted from Python, so both detectors use
a monitor thread and `os._exit`, which skips atexit handlers on purpose:
they could touch the hung device and hang the exit. The exit codes, the
environment variables (NSC_DEVICE_CHECK_TIMEOUT, NSC_HEARTBEAT_TIMEOUT,
NSC_HEARTBEAT_FIRST, NSC_RSS_EXIT_GB) and the printed markers
(``NSC-LIVENESS: ...``, on stderr) are the JAX package's, so one supervisor
reads both. Unlike the JAX package, a malformed NSC_RSS_EXIT_GB counts as
unset instead of raising at the first checkpoint boundary.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Callable, Optional

EXIT_DEVICE_WEDGED = 97
EXIT_STALLED = 98
EXIT_RSS_LIMIT = 99

_MARKER_WEDGED = "NSC-LIVENESS: DEVICE WEDGED"
_MARKER_STALLED = "NSC-LIVENESS: RUN STALLED"
_MARKER_RSS = "NSC-LIVENESS: HOST RSS LIMIT"


def _default_probe(device=None) -> float:
    """One tiny op on `device` (default CUDA), its result read back to the
    host: the readback, not the launch, shows the device answers."""
    import torch

    x = torch.full((8, 128), 2.0, dtype=torch.float32,
                   device=torch.device("cuda" if device is None else device))
    return float(torch.sum(x * x).item())


def host_rss_gb() -> float:
    """This process's resident set size in GiB (`/proc/self/statm`); 0.0
    where /proc is unavailable, which callers read as "unknown, don't
    act"."""
    try:
        with open("/proc/self/statm") as f:
            resident_pages = int(f.read().split()[1])
        return resident_pages * os.sysconf("SC_PAGE_SIZE") / 2**30
    except (OSError, ValueError, IndexError):
        return 0.0


def rss_exit_limit_gb() -> Optional[float]:
    """The host-RSS ceiling (GiB) above which a long run saves a full state
    and exits, or None for no ceiling. `NSC_RSS_EXIT_GB` overrides (0
    disables; a value that is not a number counts as unset). Default: 80%
    of MemTotal on hosts with >= 32 GiB, else none (on a small host the
    interpreter's baseline alone could graze a relative limit)."""
    env = os.environ.get("NSC_RSS_EXIT_GB")
    if env is not None:
        try:
            v = float(env)
        except ValueError:
            v = None
        if v is not None:
            return v if v > 0 else None
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total_gb = int(line.split()[1]) / 2**20  # kB -> GiB
                    break
            else:
                return None
    except (OSError, ValueError):
        return None
    return 0.8 * total_gb if total_gb >= 32 else None


def run_with_deadline(fn: Callable[[], object], timeout_s: float) -> tuple:
    """Run `fn` in a daemon thread under a deadline. Returns (status, value,
    seconds): ("ok", result, dt), ("error", exception, dt) if `fn` raised,
    ("timeout", None, timeout_s) if the deadline passed (`fn` may still be
    running: do not touch the device again in this process)."""
    done = threading.Event()
    box: list = []

    def _worker() -> None:
        try:
            box.append(("ok", fn()))
        except Exception as e:  # noqa: BLE001 (reported to the caller)
            box.append(("error", e))
        finally:
            done.set()

    t0 = time.monotonic()
    threading.Thread(target=_worker, daemon=True).start()
    if not done.wait(timeout_s):
        return "timeout", None, float(timeout_s)
    status, value = box[0]
    return status, value, time.monotonic() - t0


def device_liveness_check(
    timeout_s: Optional[float] = None,
    *,
    probe: Callable[[], object] = _default_probe,
    _exit: Callable[[int], None] = os._exit,
) -> float:
    """Run `probe` under a deadline and return its wall time. On timeout
    print the wedged marker and `_exit(EXIT_DEVICE_WEDGED)`; a probe that
    raises raises here. Default deadline: NSC_DEVICE_CHECK_TIMEOUT seconds,
    else 420."""
    if timeout_s is None:
        timeout_s = float(os.environ.get("NSC_DEVICE_CHECK_TIMEOUT", "420"))
    status, value, dt = run_with_deadline(probe, timeout_s)
    if status == "timeout":
        print(
            f"{_MARKER_WEDGED}: no probe result in {timeout_s:.0f}s; the device "
            f"is hung; exiting {EXIT_DEVICE_WEDGED} (a restart in this state "
            "cannot fix it)",
            file=sys.stderr, flush=True,
        )
        _exit(EXIT_DEVICE_WEDGED)
        return dt  # only reached with an injected _exit (tests)
    if status == "error":
        raise value
    print(f"NSC-LIVENESS: device ok ({dt:.1f}s)", file=sys.stderr, flush=True)
    return dt


class Heartbeat:
    """Exit the process if the training loop stops making progress.

    `first_timeout_s` covers the window before the first beat (restore and
    the first steps), `timeout_s` the gaps between beats. Defaults 780 and
    450 s (NSC_HEARTBEAT_FIRST, NSC_HEARTBEAT_TIMEOUT), below the JAX
    package's supervisor's own stale and grace limits (600 and 900 s). A run
    whose beats are legitimately further apart must raise them.
    """

    def __init__(
        self,
        timeout_s: Optional[float] = None,
        first_timeout_s: Optional[float] = None,
        *,
        poll_s: float = 5.0,
        _exit: Callable[[int], None] = os._exit,
    ):
        if timeout_s is None:
            timeout_s = float(os.environ.get("NSC_HEARTBEAT_TIMEOUT", "450"))
        if first_timeout_s is None:
            first_timeout_s = float(os.environ.get("NSC_HEARTBEAT_FIRST", "780"))
        self._timeout = float(timeout_s)
        self._deadline = time.monotonic() + float(first_timeout_s)
        self._poll = poll_s
        self._exit_fn = _exit
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self._last_step: Optional[int] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def beat(self, step: Optional[int] = None) -> None:
        with self._lock:
            self._deadline = time.monotonic() + self._timeout
            if step is not None:
                self._last_step = step

    def stop(self) -> None:
        self._stop.set()

    def _run(self) -> None:
        while not self._stop.wait(self._poll):
            with self._lock:
                late = time.monotonic() - self._deadline
                step = self._last_step
            if late > 0:
                print(
                    f"{_MARKER_STALLED}: no progress for {self._timeout:.0f}s past "
                    f"deadline (last step: {step}); exiting {EXIT_STALLED} so the "
                    "supervisor restarts cleanly",
                    file=sys.stderr, flush=True,
                )
                self._exit_fn(EXIT_STALLED)
                return  # only reached with an injected _exit (tests)
