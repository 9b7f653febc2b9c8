"""Offline codebook refit of an exported codec, on the port.

    python3 scripts/torch_refit_flagship.py [exports/base_fast_synthetic2_48k_refit]
        [--frames 120000] [--iters 10] [--data SPEC] [--export NAME] [--device cpu]

Loads the export's serving bundle (`nsc_tpu_torch.load_model(...,
serving=True)`; CUDA unless `--device cpu`), collects a latent pool from
its training data spec (meta.json's `data`, or `--data` where the export
records none), refits every codebook by sequential residual k-means
(`nsc_tpu_torch/train/refit.py`, its searches K2 on a card), then measures
before and after:

  * on the pool: per-book usage and perplexity, the residual MSE per depth;
  * end to end: `bitrate_sweep` (mel distance, SI-SNR, NSIM, the coded
    bitrate) of a held-out batch at several depths.

Pool and held-out segments are meta.json's `segment_len` samples when it
records one, else `--seconds` (10 s): a model trained on short segments is
scored at its own length. The report goes to `--report`.

With `--export NAME` the refit codebooks and the export's other weights are
written as an export, `<--exports-dir>/NAME/` (weights.npz and meta.json,
which records the refit and a lineage depth), and its serving indices are
pinned beside it (`scripts/torch_write_gpu_pin.py`). The export is REFUSED
(exit 2) when the refit worsens mel distance at full depth: a refit must
dominate, not trade. Imports torch and the port only.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))
EXPORT = os.path.join(REPO, "exports", "base_fast_synthetic2_48k_refit")


def data_spec_of(meta: dict, override) -> str:
    spec = override or meta.get("data")
    if not spec:
        raise SystemExit("the export's meta.json records no training data spec: pass --data")
    return spec


def depths_of(text: str, cfg) -> list:
    return [d for d in (int(x) for x in text.split(",")) if 1 <= d <= cfg.num_quantizers]


def write_export(dst: str, step: int, params_g, rvq, meta: dict) -> str:
    """An export at `dst` (weights.npz and meta.json directly in it, as
    `exports/` holds them), replacing any there."""
    from nsc_tpu_torch.train import checkpoint as ckpt

    parts = dst + ".parts"
    shutil.rmtree(parts, ignore_errors=True)
    step_dir = ckpt.save_inference(parts, step, params_g, rvq, meta)
    shutil.rmtree(dst, ignore_errors=True)
    os.replace(step_dir, dst)
    shutil.rmtree(parts)
    return dst


def pin(dst: str, cfg_name: str, device) -> int:
    """The serving pin of the export at `dst`, written by
    torch_write_gpu_pin.py's code; its exit code."""
    import torch_write_gpu_pin

    return torch_write_gpu_pin.main([dst, "--model", cfg_name]
                                    + (["--device", device] if device else []))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("artifact", nargs="?", default=EXPORT, help="an export directory")
    p.add_argument("--frames", type=int, default=120_000, help="latent pool size (frames)")
    p.add_argument("--iters", type=int, default=10, help="Lloyd iterations")
    p.add_argument("--pool-seed", type=int, default=7)
    p.add_argument("--eval-seed", type=int, default=1,
                   help="held-out eval batch seed (training used 0)")
    p.add_argument("--depths", default="1,2,4,8,12,16")
    p.add_argument("--data", default=None,
                   help="training data spec where meta.json has none")
    p.add_argument("--seconds", type=float, default=10.0,
                   help="segment length where meta.json records no segment_len")
    p.add_argument("--batch", type=int, default=16, help="pool batch size")
    p.add_argument("--export", default=None, help="<exports-dir>/<name> to write")
    p.add_argument("--exports-dir", default=os.path.join(REPO, "exports"))
    p.add_argument("--report", default=os.path.join(REPO, "docs", "torch_refit_report.json"))
    p.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)

    import dataclasses

    import numpy as np

    from nsc_tpu_torch import api
    from nsc_tpu_torch.eval.sweep import bitrate_sweep
    from nsc_tpu_torch.train import checkpoint as ckpt
    from nsc_tpu_torch.train import refit
    from nsc_tpu_torch.train.data import make_source, strip_pool

    art = os.path.abspath(args.artifact)
    meta = ckpt.export_meta(art)
    cfg_name, step = meta["config"], int(meta["step"])
    data_spec = data_spec_of(meta, args.data)
    bundle = api.load_model(cfg_name, checkpoint=art, serving=True, device=args.device)
    cfg = bundle.cfg

    # the latent pool, from the training distribution at the training length
    seg = int(meta.get("segment_len") or args.seconds * cfg.sample_rate)
    seg = max(cfg.hop, seg // cfg.hop * cfg.hop)
    n_batches = max(1, -(-args.frames // (args.batch * (seg // cfg.hop))))
    src = make_source(data_spec, cfg.sample_rate, seed=args.pool_seed)
    pool = refit.collect_latents(bundle, src.batches(args.batch, seg), n_batches)
    print(f"latent pool: {pool.shape[0]} frames x {pool.shape[1]} dims ({n_batches} batches "
          f"of {args.batch} x {seg / cfg.sample_rate:g} s '{data_spec}' seed {args.pool_seed})")
    before_pool = refit.pool_report(bundle.rvq, pool)
    rvq2 = refit.refit_codebooks(bundle.rvq, pool, kmeans_iters=args.iters, seed=args.pool_seed)
    after_pool = refit.pool_report(rvq2, pool)
    print(f"pool usage: {before_pool['mean_usage']:.3f} -> {after_pool['mean_usage']:.3f}; "
          f"full-depth residual MSE: {before_pool['residual_mse_per_depth'][-1]:.6f} -> "
          f"{after_pool['residual_mse_per_depth'][-1]:.6f}")

    # held-out A/B: at least ~17.6 s of audio whatever the segment length
    depths = depths_of(args.depths, cfg)
    eval_batch = max(4, -(-int(17.6 * cfg.sample_rate) // seg))
    wavs = next(make_source(strip_pool(data_spec), cfg.sample_rate, seed=args.eval_seed)
                .batches(eval_batch, seg))
    rows_a = bitrate_sweep(bundle, wavs, depths)
    bundle2 = dataclasses.replace(bundle, rvq={"codebooks": rvq2["codebooks"]})
    rows_b = bitrate_sweep(bundle2, wavs, depths)

    report = {"artifact": os.path.relpath(art, REPO), "frames": int(pool.shape[0]),
              "kmeans_iters": args.iters, "pool_before": before_pool, "pool_after": after_pool,
              "sweep_before": rows_a, "sweep_after": rows_b}
    print(f"{'n_q':>4} {'mel before':>11} {'mel after':>10} {'usage b':>8} {'usage a':>8} "
          f"{'ec-kbps b':>9} {'ec-kbps a':>9}")
    for ra, rb in zip(rows_a, rows_b):
        print(f"{ra['n_q']:>4} {ra['mel_distance']:>11.4f} {rb['mel_distance']:>10.4f} "
              f"{np.mean(ra['book_usage']):>8.3f} {np.mean(rb['book_usage']):>8.3f} "
              f"{ra['entropy_bitrate_bps'] / 1000:>9.2f} {rb['entropy_bitrate_bps'] / 1000:>9.2f}")
    os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
    with open(args.report, "w") as f:
        json.dump(report, f, indent=1)
    print(f"report -> {args.report}")

    if not args.export:
        return 0
    if rows_b[-1]["mel_distance"] > rows_a[-1]["mel_distance"]:
        print("refit WORSENED full-depth mel distance; refusing to export", file=sys.stderr)
        return 2
    params, _ = ckpt.restore_inference(art)
    out_meta = {"config": cfg_name, "data": data_spec, "source": os.path.relpath(art, REPO),
                # the derivation depth: export 0, refit 1, refit of a refit 2
                "lineage": int(meta.get("lineage", 1 if meta.get("refit") else 0)) + 1,
                "refit": {"from": os.path.relpath(art, REPO), "frames": int(pool.shape[0]),
                          "kmeans_iters": args.iters, "pool_seed": args.pool_seed}}
    if meta.get("segment_len"):
        out_meta["segment_len"] = int(meta["segment_len"])
    dst = write_export(os.path.join(args.exports_dir, args.export), step, params,
                       {"codebooks": rvq2["codebooks"].cpu()}, out_meta)
    print(f"exported {dst} (step {step})")
    return pin(dst, cfg_name, args.device)


if __name__ == "__main__":
    sys.exit(main())
