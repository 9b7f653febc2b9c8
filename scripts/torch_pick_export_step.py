"""Pick which export of a finished run to ship, on the port.

    python3 scripts/torch_pick_export_step.py RUN [--config base_fast] [--data synthetic2]
        [--batch 4] [--seconds 10] [--depths 8,16] [--device cpu]

Sweeps the newest export of `RUN/infer/` and of `RUN/infer_best/` (a step
in both counts once) through its serving bundle (CUDA unless `--device
cpu`) on a held-out batch, prints them side by side and, on the last line,
`RECOMMEND --step N`: the lower full-depth mel distance
(`nsc_tpu_torch/eval/heldout.py`). For scripting:
`scripts/torch_export_flagship.py RUN --name X --step $(... | tail -1 | awk '{print $3}')`.
Exits 1 when the run has no export. Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("run_dir")
    p.add_argument("--config", default="base_fast")
    p.add_argument("--data", default="synthetic2",
                   help="held-out eval distribution (its ':pool=N' suffix stripped)")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--eval-seed", type=int, default=1)
    p.add_argument("--depths", default="8,16")
    p.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)

    from nsc_tpu_torch.eval.heldout import pick_export_step

    step = pick_export_step(args.run_dir, config=args.config, data=args.data, batch=args.batch,
                            seconds=args.seconds, eval_seed=args.eval_seed,
                            depths=[int(d) for d in args.depths.split(",")], device=args.device)
    return 1 if step is None else 0


if __name__ == "__main__":
    sys.exit(main())
