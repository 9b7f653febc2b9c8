"""Export a trained run's chosen step as a serving artifact, on the port.

    python3 scripts/torch_export_flagship.py RUN --name NAME [--step N] [--data SPEC]
        [--segment-len SAMPLES] [--dest DIR] [--device cpu]

The step: `--step`, else best.json's (in infer_best/, infer/, then
harvest/), else the newest of infer_best/, then infer/. Writes
`weights.npz` and `meta.json` (with `data`, `segment_len`, `run_dir`) into
`--dest` (default `exports/NAME`), then the serving path's pin
`canonical_idx_gpu.npz` beside them, on CUDA unless `--device cpu`
(`nsc_tpu_torch/train/export.py`). Exits 1 when the step is missing or the
destination holds other weights (nothing is written), 2 unless the pin's
re-check is exact. `reference_f32.npz` needs the JAX package:
`scripts/export_torch_checkpoint.py`. Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("run_dir")
    p.add_argument("--name", required=True, help="exports/<name>")
    p.add_argument("--step", type=int, default=None,
                   help="explicit step (default: best.json's step, else the newest)")
    p.add_argument("--data", default=None,
                   help="training data spec for meta.json (default: the run's own)")
    p.add_argument("--segment-len", type=int, default=None,
                   help="training segment length in samples, recorded in meta.json: the "
                   "eval harnesses score the export at its own length")
    p.add_argument("--dest", default=None, help="destination (default: <repo>/exports/<name>)")
    p.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)

    from nsc_tpu_torch.train.export import export_flagship

    try:
        out = export_flagship(args.run_dir, args.name, step=args.step, data=args.data,
                              segment_len=args.segment_len, dest=args.dest, device=args.device)
    except (LookupError, ValueError) as e:
        print(e, file=sys.stderr)
        return 1
    check = out["check"]
    print(json.dumps({"export": out["dest"], "step": out["step"], "pin": out["pin"],
                      "recheck_exact": check.exact, "recheck_rate": check.match_rate,
                      "same_backend": check.same_backend}))
    return 0 if check.exact else 2


if __name__ == "__main__":
    sys.exit(main())
