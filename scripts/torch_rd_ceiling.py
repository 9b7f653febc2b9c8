"""Rate-distortion ceiling of an exported codec, on the port.

    python3 scripts/torch_rd_ceiling.py [EXPORT_DIR] [--batch 4] [--seconds 10] [--device cpu]

Bounds what any RVQ depth could reach, so that a sweep that saturates is a
measured property:

  * the autoencoder ceiling: the un-quantized latents decoded
    (`decode_latents(latents(wav))`), the infinite-bitrate bound of this
    encoder and decoder on this data;
  * the quantization gap per depth: the sweep's mel distance minus the
    ceiling's;
  * the no-information anchor: the mel distance between two different
    batches of the eval distribution, the scale's far end.

The float32 bundle of the export (`nsc_tpu_torch.load_model`, CUDA unless
`--device cpu`); the data spec is meta.json's `data`, else `--data`
("synthetic"). Writes `--out` and prints a table. Imports torch and the
port only.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
EXPORT = os.path.join(REPO, "exports", "base_fast_synthetic2_48k_refit")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("artifact", nargs="?", default=EXPORT, help="an export directory")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--eval-seed", type=int, default=1,
                   help="held-out seed (training used 0; as the refit and finetune reports)")
    p.add_argument("--depths", default="1,2,4,8,12,16")
    p.add_argument("--data", default="synthetic", help="data spec where meta.json has none")
    p.add_argument("--out", default=os.path.join(REPO, "docs", "torch_rd_ceiling.json"))
    p.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from nsc_tpu_torch import api
    from nsc_tpu_torch.eval import quality
    from nsc_tpu_torch.eval.sweep import bitrate_sweep
    from nsc_tpu_torch.train import checkpoint as ckpt
    from nsc_tpu_torch.train.data import make_source, strip_pool

    art = os.path.abspath(args.artifact)
    meta = ckpt.export_meta(art)
    cfg_name, data_spec = meta["config"], strip_pool(meta.get("data") or args.data)
    bundle = api.load_model(cfg_name, checkpoint=art, device=args.device)
    cfg = bundle.cfg
    seg = int(args.seconds * cfg.sample_rate) // cfg.hop * cfg.hop
    wavs = np.asarray(next(make_source(data_spec, cfg.sample_rate, seed=args.eval_seed)
                           .batches(args.batch, seg)))

    # the autoencoder ceiling (infinite bitrate)
    with torch.inference_mode():
        x = torch.from_numpy(wavs).to(bundle.device)
        z = bundle.model.latents(bundle.params, x)
        ceiling_wav = bundle.model.decode_latents(bundle.params, z).cpu().numpy()[..., :seg]

    def metrics(ref, deg):
        row = {"mel_distance": round(quality.mel_distance(ref, deg, cfg.sample_rate), 6),
               "si_snr_db": round(quality.si_snr(ref, deg), 3)}
        try:
            row["stoi"] = round(quality.stoi(ref, deg, cfg.sample_rate), 4)
        except ValueError:
            pass
        return row

    ceiling = metrics(wavs, ceiling_wav)
    # the no-information anchor: another batch of the same distribution
    other = np.asarray(next(make_source(data_spec, cfg.sample_rate, seed=args.eval_seed + 1000)
                            .batches(args.batch, seg)))
    anchor = metrics(wavs, other)
    depths = [d for d in (int(x) for x in args.depths.split(",")) if 1 <= d <= cfg.num_quantizers]
    rows = bitrate_sweep(bundle, wavs, depths)
    for r in rows:
        r["mel_gap_vs_ceiling"] = round(r["mel_distance"] - ceiling["mel_distance"], 6)

    report = {"artifact": os.path.relpath(art, REPO), "data": data_spec,
              "eval_seed": args.eval_seed,
              "eval_frames": int(wavs.shape[0] * (wavs.shape[1] // cfg.hop)),
              "autoencoder_ceiling": ceiling, "no_information_anchor": anchor, "sweep": rows}
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(f"artifact: {report['artifact']}  data: {data_spec}  seed: {args.eval_seed}")
    print(f"{'point':>18} {'mel':>8} {'si_snr':>8} {'stoi':>6}")
    print(f"{'ceiling (inf bps)':>18} {ceiling['mel_distance']:>8.4f} "
          f"{ceiling['si_snr_db']:>8.2f} {ceiling.get('stoi', float('nan')):>6.3f}")
    for r in rows:
        print(f"{'n_q=' + str(r['n_q']):>18} {r['mel_distance']:>8.4f} {r['si_snr_db']:>8.2f} "
              f"{r.get('stoi', float('nan')):>6.3f}   gap {r['mel_gap_vs_ceiling']:+.4f}")
    print(f"{'no-info anchor':>18} {anchor['mel_distance']:>8.4f} "
          f"{anchor['si_snr_db']:>8.2f} {anchor.get('stoi', float('nan')):>6.3f}")
    print(f"report -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
