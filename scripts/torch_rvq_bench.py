"""Time the port's RVQ kernels on a CUDA card, and keep K2's indices so that
two trees of the port can be held against each other.

    python3 scripts/torch_rvq_bench.py [--tree DIR] [--save FILE]
    python3 scripts/torch_rvq_bench.py --compare FILE FILE [FILE ...]

`--tree` imports `nsc_tpu_torch` from DIR (another commit's tree, unpacked
with `git archive`) in place of this checkout's; the script calls only what
every tree of the port has (`api.load_model`, the codec's `latents`,
`kernels.rvq.quantize` / `dequantize` / `dequantize_plain`). Run it once per
tree in one card call, in turns (parent, change, change, parent), then
`--compare` the saved files: K2's indices must be equal where both trees
ran a shape (each run's own line has its times).

Inputs, from fixed seeds:
  * serving: `base_fast`'s serving codebooks (seed 0) and its latents of
    64 x 10 s of `randn * 0.1` audio (seed 0), as `chip_smoke.py` makes them
    (M 32,000, 16 x 1024 x 128); K3 on K2's indices of them;
  * random: N(0, 1) books and frames at 16 x 1024 x 128, and at the widths
    past 128 that K2's streamed plan takes (8 x 1024 x 256, 4 x 1024 x 384),
    M 32,000; K3 on uniform random indices at 16 x 1024 x 128.
A tree whose K2 refuses a width records "refused" for it.

One JSON line per run: the card, and per shape K2's ms (CUDA events, mean
of 10 launches after one) or K3's ms (mean of 100), with K3 checked
bit-exact against the plain version.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def _events_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def run(tree: str, save: str | None) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import numpy as np
    import torch

    from nsc_tpu_torch import api
    from nsc_tpu_torch.kernels import rvq as KR

    if not torch.cuda.is_available():
        raise SystemExit("torch_rvq_bench: CUDA is not available")
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out = {"tree": os.path.abspath(tree), "card": card, "quantize": {}, "dequantize": {}}
    kept = {}
    with torch.no_grad():
        bundle = api.load_model("base_fast", serving=True, device=dev)
        wav = torch.from_numpy(
            np.random.RandomState(0).randn(64, 160000).astype(np.float32) * 0.1).to(dev)
        z = bundle.model.latents(bundle.params, wav)
        cases = {"serving": (bundle.rvq["codebooks"].contiguous(),
                             z.reshape(-1, z.shape[-1]).float().contiguous())}
        del bundle, wav, z
        g = torch.Generator(device=dev).manual_seed(11)
        for n_q, k, d in ((16, 1024, 128), (8, 1024, 256), (4, 1024, 384)):
            cases[f"random_{n_q}x{k}x{d}"] = (torch.randn(n_q, k, d, device=dev, generator=g),
                                              torch.randn(32000, d, device=dev, generator=g))
        for name, (books, zz) in cases.items():
            try:
                idx = KR.quantize(books, zz)
            except ValueError as e:
                out["quantize"][name] = {"refused": str(e)}
                continue
            torch.cuda.synchronize()
            kept[name] = idx.cpu()
            out["quantize"][name] = {
                "shape": list(books.shape), "M": zz.shape[0],
                "ms": _events_ms(torch, lambda: KR.quantize(books, zz), 10)}
        books = cases["serving"][0]
        uniform = torch.randint(0, books.shape[1], (32000, books.shape[0]), device=dev,
                                generator=g, dtype=torch.int32)
        for name, ii in (("serving", kept["serving"].to(dev)), ("uniform", uniform)):
            got = KR.dequantize(books, ii)
            torch.cuda.synchronize()
            out["dequantize"][name] = {
                "bit_exact": bool(torch.equal(got, KR.dequantize_plain(books, ii))),
                "ms": _events_ms(torch, lambda: KR.dequantize(books, ii), 100)}
    if save:
        torch.save(kept, save)
    return out


def compare(files) -> dict:
    import torch

    saved = [torch.load(f) for f in files]
    out = {}
    for name in sorted(set().union(*saved)):
        have = [s[name] for s in saved if name in s]
        out[name] = {"runs": [name in s for s in saved],
                     "indices_equal": all(torch.equal(h, have[0]) for h in have)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--save")
    ap.add_argument("--compare", nargs="+")
    args = ap.parse_args()
    result = compare(args.compare) if args.compare else run(args.tree, args.save)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
