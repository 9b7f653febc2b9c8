"""Held-out quality trend across a run's harvested exports, on the port.

    python3 scripts/torch_heldout_trend.py RUN [--config base_fast] [--data synthetic2]
        [--segment-len 17600] [--depth N] [--device cpu] [--out RUN/heldout_trend.jsonl]

Scores every `RUN/harvest/<step>/` not yet in `--out` through its serving
bundle (CUDA unless `--device cpu`) on training-length and 10 s held-out
segments and appends one JSONL row per step, tagged with the backend it
was scored on; a file of one backend's rows takes no row of another's
(`nsc_tpu_torch/eval/heldout.py`). Exits 1 without a harvest or on a
backend mix. Imports torch and the port only.
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
                   help="eval distribution (its ':pool=N' suffix stripped)")
    p.add_argument("--eval-seed", type=int, default=1)
    p.add_argument("--segment-len", type=int, default=17600,
                   help="training segment length in samples (the short protocol)")
    p.add_argument("--batch-short", type=int, default=16)
    p.add_argument("--batch-10s", type=int, default=4)
    p.add_argument("--depth", type=int, default=None,
                   help="RVQ depth (default: the config's full depth, 16 for base_fast)")
    p.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    p.add_argument("--out", default=None, help="default: <run_dir>/heldout_trend.jsonl")
    args = p.parse_args(argv)

    from nsc_tpu_torch.eval.heldout import heldout_trend

    try:
        heldout_trend(args.run_dir, config=args.config, data=args.data,
                      eval_seed=args.eval_seed, segment_len=args.segment_len,
                      batch_short=args.batch_short, batch_10s=args.batch_10s, depth=args.depth,
                      device=args.device, out=args.out, log=lambda line: print(line, flush=True))
    except (FileNotFoundError, ValueError) as e:
        print(e, file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
