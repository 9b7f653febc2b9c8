"""Held-out quality across a run's exports (counterparts of
`scripts/heldout_trend.py` and `scripts/pick_export_step.py`).

    python3 scripts/torch_heldout_trend.py RUN [--config base_fast] [--data synthetic2]
    python3 scripts/torch_pick_export_step.py RUN [--config base_fast] [--batch 4]

(each with `--device cpu` for the CPU; CUDA otherwise)

The trend scores every export under `<run>/harvest/` (`train/harvest.py`)
on a fixed held-out batch and appends one JSONL row per step to
`<run>/heldout_trend.jsonl`, so that a run's held-out optimum is a measured
curve. Two protocols a row, the JAX script's:

- `mel_short` / `si_snr_short`: training-length segments (17,600 samples,
  rounded down to the hop) of the pool-stripped data spec at seed 1, the
  like-for-like generalization number (synthetic2's segments are shaped
  per segment, so 10 s draws are another distribution);
- `mel_10s` / `si_snr_10s`: 4 x 10 s, the refit and finetune reports'
  protocol, the duration-generalization diagnostic.

It is incremental: steps already in the file are skipped. Each row also
records `backend` (`canonical.backend`: the card with its torch, CUDA and
cuDNN versions, or "cpu"), and a file of one backend's rows takes no row
of another's: on the card the bf16 serving path runs K1 and is a codec of
its own, so rows scored on two backends do not compare. (The JAX close
keeps one numerics by always scoring on the CPU; the port states the rule.)

`smoothed_winner` is the JAX close's picker: each row's `mel_short`
averaged with its neighbours', the lowest mean wins (adjacent rows differ
by ~0.02 on this batch, so a raw minimum picks a lucky draw).

`pick_export_step` sweeps the newest export of `infer/` and of
`infer_best/` (a step in both counts once) at depths 8 and 16 on 4 x 10 s
of held-out data, prints the table and, last, `RECOMMEND --step N`, the
lower full-depth mel.
"""

from __future__ import annotations

import json
import math
import os
import sys
from typing import Callable, Optional, Sequence

import numpy as np

from nsc_tpu_torch import api, canonical
from nsc_tpu_torch.configs import get_config
from nsc_tpu_torch.eval.sweep import bitrate_sweep
from nsc_tpu_torch.train import checkpoint as ckpt
from nsc_tpu_torch.train.data import make_source, strip_pool

TREND_FILE = "heldout_trend.jsonl"


def heldout_batches(cfg, data: str, seed: int = 1, segment_len: int = 17_600,
                    batch_short: int = 16, batch_10s: int = 4):
    """(short, 10 s) held-out batches: fresh draws of `data` without its
    ':pool=' suffix at `seed`, segments rounded down to the hop."""
    spec = strip_pool(data)
    seg = segment_len // cfg.hop * cfg.hop
    held = next(make_source(spec, cfg.sample_rate, seed=seed).batches(batch_short, seg))
    seg10 = int(10.0 * cfg.sample_rate) // cfg.hop * cfg.hop
    held10 = next(make_source(spec, cfg.sample_rate, seed=seed).batches(batch_10s, seg10))
    return held, held10


def trend_row(bundle, held, held10, depth: int) -> dict:
    """The trend's metric fields of one bundle, rounded as the JAX script
    rounds them."""
    r = bitrate_sweep(bundle, held, [depth])[0]
    r10 = bitrate_sweep(bundle, held10, [depth])[0]
    return {
        "mel_short": round(float(r["mel_distance"]), 4),
        "si_snr_short": round(float(r["si_snr_db"]), 2),
        "usage": round(float(np.mean(r["book_usage"])), 4),
        "mel_10s": round(float(r10["mel_distance"]), 4),
        "si_snr_10s": round(float(r10["si_snr_db"]), 2),
    }


def load_rows(path: str) -> list:
    """The rows of a trend file, by step (none when it does not exist)."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    return sorted(rows, key=lambda r: r["step"])


def heldout_trend(run_dir: str, *, config: str = "base_fast", data: str = "synthetic2",
                  eval_seed: int = 1, segment_len: int = 17_600, batch_short: int = 16,
                  batch_10s: int = 4, depth: Optional[int] = None, device=None,
                  out: Optional[str] = None,
                  log: Callable[[str], None] = print) -> list:
    """Score each step of `<run_dir>/harvest/` not yet in `out` (default
    `<run_dir>/heldout_trend.jsonl`) and append its row; returns the new
    rows. `depth` defaults to the config's full depth (16 for base_fast,
    the JAX script's default). Raises FileNotFoundError without a
    harvest/, ValueError when `out` holds rows of another backend or
    `depth` is not one of the config's."""
    run = os.path.abspath(run_dir)
    out = out or os.path.join(run, TREND_FILE)
    harvest = os.path.join(run, "harvest")
    if not os.path.isdir(harvest):
        raise FileNotFoundError(f"no harvest/ under {run}: "
                                f"run scripts/torch_harvest_checkpoints.py")
    here = canonical.backend(api.resolve_device(device))
    rows = load_rows(out)
    other = sorted({str(r.get("backend")) for r in rows} - {here})
    if other:
        raise ValueError(f"{out} holds rows scored on {other}; this run scores on '{here}'. "
                         f"Rows of two backends do not compare: score on their device or "
                         f"give another --out")
    done = {r["step"] for r in rows}
    steps = sorted(int(s) for s in os.listdir(harvest) if s.isdigit())
    new = [s for s in steps if s not in done]
    if not new:
        log(f"no new steps (have {len(done)}, harvest has {len(steps)})")
        return []
    cfg = get_config(config)
    depth = cfg.num_quantizers if depth is None else depth
    if not 1 <= depth <= cfg.num_quantizers:
        raise ValueError(f"depth {depth} is not a depth of {config} (1 to {cfg.num_quantizers})")
    held, held10 = heldout_batches(cfg, data, eval_seed, segment_len, batch_short, batch_10s)
    added = []
    for st in new:
        bundle = api.load_model(config, checkpoint=os.path.join(harvest, str(st)), serving=True,
                                device=device)
        row = {"step": st, **trend_row(bundle, held, held10, depth), "backend": here}
        with open(out, "a") as f:
            f.write(json.dumps(row) + "\n")
        log(json.dumps(row))
        added.append(row)
    best = min(load_rows(out), key=lambda r: r["mel_short"])
    log(f"held-out best (mel_short): step {best['step']} mel {best['mel_short']} "
        f"si_snr {best['si_snr_short']}")
    return added


def smoothed_winner(rows: Sequence[dict]) -> tuple:
    """(row, smoothed mel_short) of the rows' winner: each row's mel_short
    averaged with its neighbours' by step, the lowest mean wins (the first
    on a tie)."""
    rows = sorted(rows, key=lambda r: r["step"])
    if not rows:
        raise ValueError("no trend rows")

    def smoothed(i):
        vals = [rows[j]["mel_short"] for j in (i - 1, i, i + 1) if 0 <= j < len(rows)]
        return sum(vals) / len(vals)

    i = min(range(len(rows)), key=smoothed)
    return rows[i], smoothed(i)


def pick_export_step(run_dir: str, *, config: str = "base_fast", data: str = "synthetic2",
                     batch: int = 4, seconds: float = 10.0, eval_seed: int = 1,
                     depths: Sequence[int] = (8, 16), device=None,
                     log: Callable[[str], None] = print) -> Optional[int]:
    """Sweep the newest export of `infer/` and of `infer_best/` on held-out
    data, print the table and the recommendation; returns the recommended
    step (None without an export)."""
    run = os.path.abspath(run_dir)
    cands, seen = [], set()
    for sub in ("infer", "infer_best"):
        steps = ckpt.export_steps(os.path.join(run, sub))
        # the same step in both is the same export
        if steps and steps[-1] not in seen:
            seen.add(steps[-1])
            cands.append((sub, steps[-1]))
    if not cands:
        print(f"no inference exports under {run}", file=sys.stderr)
        return None
    wavs, rows_by = None, {}
    for sub, step in cands:
        bundle = api.load_model(config, checkpoint=os.path.join(run, sub, str(step)),
                                serving=True, device=device)
        if wavs is None:
            cfg = bundle.cfg
            seg = int(seconds * cfg.sample_rate) // cfg.hop * cfg.hop
            wavs = next(make_source(strip_pool(data), cfg.sample_rate, seed=eval_seed)
                        .batches(batch, seg))
        rows_by[(sub, step)] = bitrate_sweep(bundle, wavs, list(depths))
    log(f"{'checkpoint':>16} {'n_q':>4} {'mel':>8} {'si_snr':>8} {'stoi':>6} {'usage':>6}")
    for (sub, step), rows in rows_by.items():
        for r in rows:
            log(f"{sub + '@' + str(step):>16} {r['n_q']:>4} {r['mel_distance']:>8.4f} "
                f"{r['si_snr_db']:>8.2f} {r.get('stoi', math.nan):>6.3f} "
                f"{float(np.mean(r['book_usage'])):>6.3f}")
    (sub, step), rows = min(rows_by.items(), key=lambda kv: kv[1][-1]["mel_distance"])
    log(f"held-out full-depth mel favors {sub}@{step} (mel {rows[-1]['mel_distance']:.4f})")
    log(f"RECOMMEND --step {step}")
    return step
