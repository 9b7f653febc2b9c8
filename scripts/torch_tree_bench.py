"""What the port's cross-tree kernel benches share (scripts/torch_rvq_bench.py
and scripts/torch_k4_bench.py): `nsc_tpu_torch` imported from another
commit's tree, the card's name and power limit, CUDA-event timing, and the
comparison of the outputs each run saved.

A bench gives `main` its `run(tree, save) -> dict`, which times one tree
and saves its outputs, and how to load and compare them:

    python3 scripts/<bench>.py [--tree DIR] [--save FILE]
    python3 scripts/<bench>.py --compare FILE FILE [FILE ...]

`--tree` imports `nsc_tpu_torch` from DIR (unpacked with `git archive`) in
place of this checkout's. Run a bench once per tree in one card call, in
turns (parent, change, change, parent), then `--compare` the saved files:
it prints, per case, the runs that had it and whether their outputs are
equal, and exits 1 where any differ.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def import_tree(tree: str) -> None:
    """Put DIR first on the path, so that `nsc_tpu_torch` is imported from it."""
    sys.path.insert(0, os.path.abspath(tree))


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def events_ms(torch, fn, reps: int) -> float:
    """Mean ms of `reps` calls of fn by CUDA events, after one call."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(torch, fn, reps: int) -> float:
    """Mean ms of fn on the card alone: `reps` calls captured in one CUDA
    graph (after a call outside it, which also fills the callee's caches)
    and the graph replayed 5 times by CUDA events, so the host's share of
    each call is not in it."""
    fn()
    torch.cuda.synchronize()
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    with torch.cuda.stream(stream):
        fn()
        stream.synchronize()
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(reps):
                fn()
    return events_ms(torch, graph.replay, 5) / reps


def compare(files, load, equal) -> dict:
    saved = [load(f) for f in files]
    out = {}
    for name in sorted(set().union(*saved)):
        have = [s[name] for s in saved if name in s]
        out[name] = {"runs": [name in s for s in saved],
                     "equal": all(equal(h, have[0]) for h in have)}
    return out


def main(description: str, run, load, equal) -> int:
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--tree", default=ROOT)
    ap.add_argument("--save")
    ap.add_argument("--compare", nargs="+")
    args = ap.parse_args()
    if args.compare:
        result = compare(args.compare, load, equal)
        ok = all(v["equal"] for v in result.values())
    else:
        result, ok = run(args.tree, args.save), True
    print(json.dumps(result), flush=True)
    return 0 if ok else 1
