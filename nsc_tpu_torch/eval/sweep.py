"""Bitrate sweep (counterpart of `nsc_tpu/eval/sweep.py`): the codec's
bandwidth axis, RVQ depth 1..n_q.

One encode at full depth, then for each depth the first n_q books decoded;
each row reports the nominal bitrate, the arithmetic-coded payload's
bitrate, per-book perplexity and usage of the indices, SI-SNR, mel
distance, the PESQ, STOI and ViSQOL-style proxies, Taal's STOI where it
accepts the input (at least 30 active frames), and with a reference bundle
the index match rate against its indices. The rows and keys are the JAX
package's.

    python -m nsc_tpu_torch.eval --model base --data synthetic --seconds 10 [--device cpu]
"""

from __future__ import annotations

import json
from typing import Optional, Sequence

import numpy as np

from nsc_tpu_torch import api, entropy
from nsc_tpu_torch.eval import quality


def bitrate_sweep(
    bundle: api.ModelBundle,
    wavs: np.ndarray,
    n_q_list: Optional[Sequence[int]] = None,
    *,
    reference_bundle: Optional[api.ModelBundle] = None,
) -> list[dict]:
    """wavs: (N, T). One result dict per depth."""
    cfg = bundle.cfg
    if n_q_list is None:
        n_q_list = list(range(1, cfg.num_quantizers + 1))
    full_idx = api.encode(bundle, wavs)  # one encode; each depth takes its first books
    ref_idx = api.encode(reference_bundle, wavs) if reference_bundle is not None else None
    seconds = wavs.shape[-1] / cfg.sample_rate
    k = 2**cfg.bits_per_codebook
    results = []
    for n_q in n_q_list:
        idx = full_idx[..., :n_q]
        recon = api.decode(bundle, idx)[..., : wavs.shape[-1]]
        # the payload under the adaptive arithmetic coder: trained books
        # are used unevenly, so it sits below the nominal rate
        coded = np.mean([len(entropy.encode_frames(row, k))
                         for row in (idx if idx.ndim == 3 else idx[None])])
        # per-book perplexity (exp of the index histogram's entropy: the
        # effective code count) and usage (codes hit at least once)
        flat = idx.reshape(-1, n_q)
        perpl, used = [], []
        for q in range(n_q):
            h = np.bincount(flat[:, q], minlength=k).astype(np.float64)
            p_q = h / max(h.sum(), 1.0)
            ent = -(p_q[p_q > 0] * np.log(p_q[p_q > 0])).sum()
            perpl.append(float(np.exp(ent)))
            used.append(float((h > 0).mean()))
        row = {
            "n_q": int(n_q),
            "bitrate_bps": float(cfg.bitrate(n_q)),
            "entropy_bitrate_bps": float(coded * 8 / seconds),
            "book_perplexity": [round(x, 1) for x in perpl],
            "book_usage": [round(x, 4) for x in used],
            "si_snr_db": quality.si_snr(wavs, recon),
            "mel_distance": quality.mel_distance(wavs, recon, cfg.sample_rate),
            "pesq_proxy": quality.pesq_proxy(wavs, recon, cfg.sample_rate),
            "stoi_proxy": quality.stoi_proxy(wavs, recon, cfg.sample_rate),
            "visqol_nsim": quality.visqol_nsim(wavs, recon, cfg.sample_rate),
        }
        try:  # Taal et al. 2011 (needs at least 30 active frames)
            row["stoi"] = quality.stoi(wavs, recon, cfg.sample_rate)
        except ValueError:
            pass
        if ref_idx is not None:
            row["index_match"] = quality.codebook_match_rate(idx, ref_idx[..., :n_q])["overall"]
        results.append(row)
    return results


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="nsc_tpu_torch.eval")
    p.add_argument("--model", default="base")
    p.add_argument("--checkpoint", default=None,
                   help="an export directory or a training workdir of the port")
    p.add_argument("--data", default="synthetic", help="'synthetic' or wav dir")
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--json", action="store_true", help="machine-readable output")
    p.add_argument("--device", default=None,
                   help="'cuda' (the default; raises without CUDA) or 'cpu'")
    args = p.parse_args(argv)

    bundle = api.load_model(args.model, checkpoint=args.checkpoint, seed=args.seed,
                            device=args.device)
    cfg = bundle.cfg
    from nsc_tpu_torch.train.data import make_source

    seg = int(args.seconds * cfg.sample_rate) // cfg.hop * cfg.hop
    wavs = next(make_source(args.data, cfg.sample_rate, args.seed).batches(args.batch, seg))
    rows = bitrate_sweep(bundle, wavs)
    if args.json:
        print(json.dumps(rows))
    else:
        print(f"{'n_q':>4} {'kbps':>7} {'ec-kbps':>8} {'SI-SNR':>8} "
              f"{'melDist':>8} {'PESQ*':>6} {'STOI*':>6} {'STOI':>6} {'NSIM*':>6}")
        for r in rows:
            print(f"{r['n_q']:>4} {r['bitrate_bps']/1000:>7.2f} "
                  f"{r['entropy_bitrate_bps']/1000:>8.2f} "
                  f"{r['si_snr_db']:>8.2f} {r['mel_distance']:>8.3f} "
                  f"{r['pesq_proxy']:>6.2f} {r['stoi_proxy']:>6.3f} "
                  f"{r.get('stoi', float('nan')):>6.3f} {r['visqol_nsim']:>6.3f}")
        print("(PESQ*: fwSegSNR proxy, not ITU-T P.862. STOI*: envelope-correlation "
              "proxy. STOI: faithful Taal et al. 2011. NSIM*: ViSQOL-style gammatone "
              "NSIM, not ViSQOL v3 — see nsc_tpu_torch/eval/quality.py)")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
