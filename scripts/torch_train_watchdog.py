"""Supervise a training run of the port.

Usage: python3 scripts/torch_train_watchdog.py WORKDIR [train args...]

e.g.

    python3 scripts/torch_train_watchdog.py runs/bf --config base_fast \
        --data synthetic2:pool=8192 --steps 50000 --checkpoint-every 2000

Launches `python -m nsc_tpu_torch.train --workdir WORKDIR <train args>`
and relaunches it when it dies (any rc but 0) or when metrics.jsonl goes
stale, with a backoff after fruitless restarts or a device-wedged marker;
ends when the run is complete or the stop file appears. Knobs, as the JAX
package's supervisor: GRACE_S (1500), STALE_S (600), WEDGE_BACKOFF_S (300),
PID_FILE ($TMPDIR/train_run.pid), STOP_FILE ($TMPDIR/train_stop); the
trainer logs to WORKDIR.log, the watchdog to WORKDIR.watchdog.log
(`nsc_tpu_torch/train/watchdog.py`). Imports the port only; the trainer
runs on CUDA unless the train arguments say `--device cpu`.
"""

from __future__ import annotations

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__, file=sys.stdout if argv else sys.stderr)
        return 0 if argv else 2
    from nsc_tpu_torch.train.watchdog import supervise

    res = supervise(argv[0], argv[1:])
    print(f"watchdog: run {res.status} after {res.restarts} restarts", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
