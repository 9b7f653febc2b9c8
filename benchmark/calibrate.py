"""Readings from which a cell's limits are set, in one process on the card:
for each seed, the program's set-up and a window at the cell's own load,
the program freed, and its compared numbers; for the control seeds, the
reference in the precision below the configuration's put in the program's
place and judged the same way (and, for a training cell, each fault the
cell can have). The benchmark's own runs never run this.

    python3 benchmark/calibrate.py --workload <name> --seeds 11,12,13 \
        --control-seeds 11,12,13 --seconds 3 --out calib.json
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import runner, spec

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = spec.find_cell(spec.load_benchmark(), args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in sorted(set(seeds) | controls):
        t0 = time.perf_counter()
        drv = runner.kind_for(cell, seed, dev)
        drv.setup()
        w = drv.window(args.seconds)
        drv.release()
        row = {"seed": seed, "units": w["units"], "metrics": w["metrics"]}
        if seed in seeds:
            row["program"] = drv.check()
        if seed in controls:
            row["control"] = drv.control()
            if hasattr(drv, "faults"):
                row["faults"] = drv.faults()
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        rows.append(row)
        del drv
        torch.cuda.empty_cache()
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"workload": args.workload, "card": torch.cuda.get_device_name(0),
                   "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
