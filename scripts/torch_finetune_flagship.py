"""Decoder finetune of an exported codec, on the port.

    python3 scripts/torch_finetune_flagship.py [exports/base_fast_synthetic2_48k_refit]
        [--steps 20000] [--lr 1e-4] [--data SPEC] [--export NAME] [--device cpu]

Freezes the export's encoder and codebooks and finetunes only its decoder
on reconstruction losses across RVQ depths (`nsc_tpu_torch/train/
finetune.py`, in `--workdir`), then measures before and after with the
held-out protocol of `scripts/torch_refit_flagship.py` (seed-1 batch,
`bitrate_sweep`), so the two reports' rows compare. The finetuned decoder
is the workdir's keep-best export where the run wrote one (`infer_best/`),
else its last (`infer/`). The data spec is meta.json's `data`, or `--data`
where the export records none. The report goes to `--report`.

With `--export NAME` the finetuned weights are written as an export,
`<--exports-dir>/NAME/`, whose meta.json records the finetune and a lineage
depth, and its serving indices are pinned beside it
(`scripts/torch_write_gpu_pin.py`; the encoder and codebooks are frozen, so
the pin's indices are the source export's by construction, and they are
checked again all the same). The export is REFUSED (exit 2) when the
finetune worsens mel distance at full depth. Imports torch and the port
only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))
EXPORT = os.path.join(REPO, "exports", "base_fast_synthetic2_48k_refit")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("artifact", nargs="?", default=EXPORT, help="an export directory")
    p.add_argument("--steps", type=int, default=20_000)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--batch-size", type=int, default=64)
    p.add_argument("--segment-seconds", type=float, default=None,
                   help="training segment length (TrainConfig's default when absent)")
    p.add_argument("--workdir", default=None,
                   help="finetune run directory (default runs/finetune_<artifact>)")
    p.add_argument("--eval-seed", type=int, default=1,
                   help="held-out eval batch seed (training used 0; as the refit's report)")
    p.add_argument("--eval-batch", type=int, default=4)
    p.add_argument("--seconds", type=float, default=10.0, help="held-out segment length")
    p.add_argument("--depths", default="1,2,4,8,12,16")
    p.add_argument("--eval-every", type=int, default=1000,
                   help="held-out keep-best cadence (train/finetune.py)")
    p.add_argument("--no-keep-best", action="store_true",
                   help="export the final step even where a mid-run decoder scored better")
    p.add_argument("--data", default=None, help="training data spec where meta.json has none")
    p.add_argument("--no-resume", action="store_true")
    p.add_argument("--export", default=None, help="<exports-dir>/<name> to write")
    p.add_argument("--exports-dir", default=os.path.join(REPO, "exports"))
    p.add_argument("--report", default=os.path.join(REPO, "docs", "torch_finetune_report.json"))
    p.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)

    import dataclasses

    from nsc_tpu_torch import api
    from nsc_tpu_torch.eval.sweep import bitrate_sweep
    from nsc_tpu_torch.train import checkpoint as ckpt
    from nsc_tpu_torch.train import finetune
    from nsc_tpu_torch.train.data import make_source, strip_pool
    from torch_refit_flagship import data_spec_of, depths_of, pin, write_export

    art = os.path.abspath(args.artifact)
    meta = ckpt.export_meta(art)
    data_spec = data_spec_of(meta, args.data)
    workdir = args.workdir or os.path.join(REPO, "runs", f"finetune_{os.path.basename(art)}")
    tcfg = finetune.finetune_config(args.steps, lr=args.lr, batch_size=args.batch_size)
    if args.segment_seconds:
        tcfg = dataclasses.replace(tcfg, segment_seconds=args.segment_seconds)
    last_metrics, meta = finetune.run_finetune(
        art, workdir=workdir, steps=args.steps, tcfg=tcfg, data_spec=data_spec,
        resume=not args.no_resume, eval_every=args.eval_every,
        keep_best=not args.no_keep_best, device=args.device)
    print(f"finetune done: {last_metrics}")
    cfg_name, step = meta["config"], int(meta["step"])

    # held-out A/B (the refit report's protocol)
    bundle_a = api.load_model(cfg_name, checkpoint=art, serving=True, device=args.device)
    bundle_b = api.load_model(cfg_name, checkpoint=workdir, serving=True, device=args.device)
    selected = os.path.relpath(ckpt.resolve_export(workdir), workdir)
    cfg = bundle_a.cfg
    seg = int(args.seconds * cfg.sample_rate) // cfg.hop * cfg.hop
    wavs = next(make_source(strip_pool(data_spec), cfg.sample_rate, seed=args.eval_seed)
                .batches(args.eval_batch, seg))
    depths = depths_of(args.depths, cfg)
    rows_a = bitrate_sweep(bundle_a, wavs, depths)
    rows_b = bitrate_sweep(bundle_b, wavs, depths)
    report = {"artifact": os.path.relpath(art, REPO), "steps": args.steps, "lr": args.lr,
              "last_metrics": last_metrics, "selected": selected,
              "sweep_before": rows_a, "sweep_after": rows_b}
    print(f"{'n_q':>4} {'mel before':>11} {'mel after':>10} {'si_snr b':>9} {'si_snr a':>9}")
    for ra, rb in zip(rows_a, rows_b):
        print(f"{ra['n_q']:>4} {ra['mel_distance']:>11.4f} {rb['mel_distance']:>10.4f} "
              f"{ra['si_snr_db']:>9.2f} {rb['si_snr_db']:>9.2f}")
    os.makedirs(os.path.dirname(os.path.abspath(args.report)), exist_ok=True)
    with open(args.report, "w") as f:
        json.dump(report, f, indent=1)
    print(f"report -> {args.report}")

    if not args.export:
        return 0
    if rows_b[-1]["mel_distance"] > rows_a[-1]["mel_distance"]:
        print("finetune WORSENED full-depth mel distance; refusing to export", file=sys.stderr)
        return 2
    params, rvq = ckpt.restore_inference(workdir)
    lineage = int(meta.get("lineage", 1 if meta.get("refit") else 0)) + 1
    out_meta = {"config": cfg_name, "data": data_spec, "source": os.path.relpath(art, REPO),
                "lineage": lineage, "refit": meta.get("refit"),
                "finetune": {"from": os.path.relpath(art, REPO), "steps": args.steps,
                             "lr": args.lr, "batch_size": args.batch_size,
                             "selected": selected, "workdir": os.path.abspath(workdir)}}
    dst = write_export(os.path.join(args.exports_dir, args.export), step, params, rvq, out_meta)
    print(f"exported {dst} (step {step}, lineage {lineage})")
    return pin(dst, cfg_name, args.device)


if __name__ == "__main__":
    sys.exit(main())
