"""Harvest a live run's rolling inference exports, on the port.

    python3 scripts/torch_harvest_checkpoints.py RUN [PID_FILE]

Copies every `RUN/infer/<step>/` into `RUN/harvest/<step>/` (through a
temporary name, its weights.npz checked against meta.json's sha256) every
90 seconds, and exits after a final sweep once the PID in PID_FILE
(default `$TMPDIR/train_run.pid`, `/tmp` without TMPDIR) is gone. Point it
at a PID that outlives the run's relaunches (the watchdog's) to keep
harvesting across them (`nsc_tpu_torch/train/harvest.py`). Imports torch
and the port only; touches no device.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    from nsc_tpu_torch.train import harvest

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("run_dir")
    p.add_argument("pid_file", nargs="?", default=harvest.DEFAULT_PID_FILE)
    args = p.parse_args(argv)
    harvest.harvest(args.run_dir, args.pid_file, log=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
