#!/usr/bin/env python3
"""K2 (the RVQ quantize kernel) against its plain version on the k-means
searches of a codebook refit of the trained flagship, on a CUDA card.

    python3 scripts/torch_refit_flips.py [--seeds 7 8 9] [--batches 8]

For each seed: `--batches` x 64 x 1 s of synthetic2 from that seed through
the flagship's float32 encoder, `refit.refit_codebooks` (k-means 10, the
same seed) with every K2 search recorded, and each search held against
`quantize_plain` on its own inputs and, past the flagship check's rule
(plain's margin < 1e-3), against the float64 scores of the book
(`chip_smoke.hold_refit_search`). Prints one JSON line per seed (frames
searched, frames where K2 and plain differ, how many of those are near-ties
by the margin rule, how many are K2 errors: K2's pick not within 1e-3 of
the float64 best) and, for each differing frame past the margin rule,
plain's margin, the float64 best score, and K2's and plain's picks' float64
scores above it. Then a summary line and the card line. Exits 1 where any
seed has a K2 error.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--seeds", type=int, nargs="+", default=[7, 8, 9])
    p.add_argument("--batches", type=int, default=8)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_refit_flips: CUDA is not available", file=sys.stderr)
        return 2
    import chip_smoke as C
    from nsc_tpu_torch import api
    from nsc_tpu_torch.kernels import rvq as KR
    from nsc_tpu_torch.train import data as data_lib
    from nsc_tpu_torch.train import refit

    torch.set_grad_enabled(False)
    dev = torch.device("cuda")
    f32 = api.load_model(C.FLAGSHIP, checkpoint=C.EXPORT, device=dev)
    sr = f32.cfg.sample_rate
    total = {"refits": 0, "frames": 0, "frames_differing": 0, "near_ties": 0,
             "k2_errors": 0, "past_near_tie": 0}
    for seed in args.seeds:
        batches = data_lib.make_source("synthetic2", sr, seed).batches(64, sr)
        pool = refit.collect_latents(f32, batches, args.batches)
        with C.recording(KR, ("quantize",)) as calls:
            refit.refit_codebooks(f32.rvq, pool, kmeans_iters=C.REFIT_ITERS, seed=seed)
        rec = {"seed": seed, "searches": len(calls["quantize"]), "frames": 0,
               "frames_differing": 0, "near_ties": 0, "k2_errors": 0, "past_near_tie": []}
        for (books, z), idx in calls["quantize"]:
            r = C.hold_refit_search(books, z, idx)
            rec["frames"] += z.shape[0]
            for key in ("frames_differing", "near_ties", "k2_errors"):
                rec[key] += r[key]
            rec["past_near_tie"] += r["past_near_tie"]
        print(json.dumps(rec), flush=True)
        total["refits"] += 1
        for key in ("frames", "frames_differing", "near_ties", "k2_errors"):
            total[key] += rec[key]
        total["past_near_tie"] += len(rec["past_near_tie"])
        del calls, pool
    print(json.dumps(total))
    print(C.card_line())
    return 1 if total["k2_errors"] else 0


if __name__ == "__main__":
    sys.exit(main())
