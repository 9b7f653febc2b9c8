"""The port's held-out trend, export pick and flagship export
(`nsc_tpu_torch/eval/heldout.py`, `nsc_tpu_torch/train/export.py` and their
scripts), against the JAX package's scripts where those compute something.

- `heldout_batches` against `nsc_tpu.train.data.make_source` bit for bit.
- `trend_row` on a float32 `tiny_test` bundle converted from nsc_tpu's
  seed-0 weights against the row `scripts/heldout_trend.py` builds with
  nsc_tpu's `bitrate_sweep` on the JAX bundle: `usage` (index-derived)
  equal, the float fields within `test_torch_sweep.FLOAT_TOL` after the
  script's rounding (mel distance at 4 decimals, SI-SNR at 2).
- `smoothed_winner` against the JAX close's own picker: the heredoc of
  `scripts/close_flagship.sh`, run with `python -` on the same file.
- The trend, pick and export on CPU exports of `tiny_test` made from the
  port's seeded weights (`checkpoint.save_inference`)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import nsc_tpu
from nsc_tpu.eval.sweep import bitrate_sweep as jsweep
from nsc_tpu.train.data import make_source as jmake_source
from nsc_tpu_torch import api, canonical
from nsc_tpu_torch import weights as W
from nsc_tpu_torch.configs import get_config
from nsc_tpu_torch.eval import heldout
from nsc_tpu_torch.eval.sweep import bitrate_sweep
from nsc_tpu_torch.train import checkpoint as ckpt
from nsc_tpu_torch.train import export
from nsc_tpu_torch.train.data import make_source
from test_torch_sweep import FLOAT_TOL
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = get_config("tiny_test")
# small held-out batches for the CPU: 2 x 0.2 s and 1 x 10 s
SMALL = {"segment_len": 3200, "batch_short": 2, "batch_10s": 1}


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _script(name, *args, timeout=240):
    return subprocess.run([sys.executable, os.path.join(REPO, "scripts", name), *map(str, args)],
                          capture_output=True, text=True, env=_env(), timeout=timeout)


def _export(directory, step, seed):
    params, rvq = W.init_jax_layout(CFG, seed)
    return ckpt.save_inference(str(directory), step, params, rvq,
                               {"config": "tiny_test", "data": "synthetic2:pool=16"},
                               max_to_keep=None)


def test_heldout_batches_equal_nsc_tpu_bit_for_bit():
    held, held10 = heldout.heldout_batches(CFG, "synthetic2:pool=16")
    want = next(jmake_source("synthetic2", CFG.sample_rate, seed=1).batches(16, 17600))
    want10 = next(jmake_source("synthetic2", CFG.sample_rate, seed=1).batches(4, 160000))
    assert held.dtype == want.dtype and np.array_equal(held, want)
    assert held10.dtype == want10.dtype and np.array_equal(held10, want10)


@pytest.fixture(scope="module")
def jax_and_port():
    jb = nsc_tpu.api.load_model("tiny_test", seed=0)
    params = W.tree_map(np.asarray, jb.params)
    rvq = W.tree_map(np.asarray, jb.rvq)
    return jb, api.bundle_from_jax(CFG, params, rvq, device="cpu")


def test_trend_row_matches_the_jax_script(jax_and_port):
    jb, pb = jax_and_port
    held, held10 = heldout.heldout_batches(CFG, "synthetic2", batch_short=4, batch_10s=1)
    depth = CFG.num_quantizers
    got = heldout.trend_row(pb, held, held10, depth)
    # scripts/heldout_trend.py:107-116, on nsc_tpu's bundle
    r = jsweep(jb, held, [depth])[0]
    r10 = jsweep(jb, held10, [depth])[0]
    want = {
        "mel_short": round(float(r["mel_distance"]), 4),
        "si_snr_short": round(float(r["si_snr_db"]), 2),
        "usage": round(float(np.mean(r["book_usage"])), 4),
        "mel_10s": round(float(r10["mel_distance"]), 4),
        "si_snr_10s": round(float(r10["si_snr_db"]), 2),
    }
    assert list(got) == list(want)
    assert got["usage"] == want["usage"]
    for key, field in (("mel_short", "mel_distance"), ("mel_10s", "mel_distance"),
                       ("si_snr_short", "si_snr_db"), ("si_snr_10s", "si_snr_db")):
        rtol, atol = FLOAT_TOL[field]
        np.testing.assert_allclose(got[key], want[key], rtol=rtol, atol=atol, err_msg=key)


def _jax_picker() -> str:
    with open(os.path.join(REPO, "scripts", "close_flagship.sh")) as f:
        text = f.read()
    return text.split("<<'PYEOF'\n", 1)[1].split("\nPYEOF", 1)[0]


PICKER_CASES = {
    # the raw minimum (step 3000) is a lucky draw; the smoothed curve picks 6000
    "raw_and_smoothed_differ": [0.50, 0.60, 0.30, 0.70, 0.45, 0.44, 0.46],
    "two_rows": [0.41, 0.40],
    "one_row": [0.7],
    "ties": [0.5, 0.5, 0.5, 0.5],
}


@pytest.mark.parametrize("case", sorted(PICKER_CASES))
def test_smoothed_winner_is_the_jax_close_picker(case, tmp_path):
    mels = PICKER_CASES[case]
    rows = [{"step": 1000 * (i + 1), "mel_short": m, "si_snr_short": 1.0 + i}
            for i, m in enumerate(mels)]
    with open(tmp_path / "heldout_trend.jsonl", "w") as f:
        for r in rows[::-1]:  # out of order: both sort by step
            f.write(json.dumps(r) + "\n")
    proc = subprocess.run([sys.executable, "-", str(tmp_path)], input=_jax_picker(),
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr
    best, mean = heldout.smoothed_winner(heldout.load_rows(str(tmp_path / "heldout_trend.jsonl")))
    assert best["step"] == int(proc.stdout.split()[0])
    assert f"(smoothed {mean:.4f})" in proc.stderr
    if case == "raw_and_smoothed_differ":
        assert best["step"] == 6000 != min(rows, key=lambda r: r["mel_short"])["step"]


def test_trend_script_appends_skips_and_refuses_a_backend_mix(tmp_path):
    run = tmp_path / "run"
    for step, seed in ((1000, 0), (2000, 1)):
        _export(run / "harvest", step, seed)
    (run / "harvest" / ".tmp_3000").mkdir()  # a copy in flight is no step
    out = _script("torch_heldout_trend.py", run, "--config", "tiny_test", "--device", "cpu",
                  "--segment-len", SMALL["segment_len"], "--batch-short", SMALL["batch_short"],
                  "--batch-10s", SMALL["batch_10s"], "--depth", 2)
    assert out.returncode == 0, out.stderr[-2000:]
    rows = heldout.load_rows(str(run / "heldout_trend.jsonl"))
    assert [r["step"] for r in rows] == [1000, 2000]
    assert all(r["backend"] == "cpu" for r in rows)
    assert "held-out best (mel_short)" in out.stdout
    # the rows are trend_row's of the serving bundles
    held, held10 = heldout.heldout_batches(CFG, "synthetic2", **SMALL)
    b = api.load_model("tiny_test", checkpoint=str(run / "harvest" / "1000"), serving=True,
                       device="cpu")
    assert rows[0] == {"step": 1000, **heldout.trend_row(b, held, held10, 2), "backend": "cpu"}

    lines = []
    assert heldout.heldout_trend(str(run), config="tiny_test", device="cpu", log=lines.append,
                                 **SMALL) == []
    assert lines == ["no new steps (have 2, harvest has 2)"]

    path = run / "heldout_trend.jsonl"
    card = "NVIDIA H100 80GB HBM3 torch 2.11.0+cu128 cuda 12.8 cudnn 92200"
    path.write_text("".join(json.dumps({**r, "backend": card}) + "\n" for r in rows))
    before = path.read_text()
    _export(run / "harvest", 3000, 2)
    with pytest.raises(ValueError, match="do not compare"):
        heldout.heldout_trend(str(run), config="tiny_test", device="cpu", **SMALL)
    with pytest.raises(ValueError, match="depth 16"):
        heldout.heldout_trend(str(run), config="tiny_test", device="cpu", out=str(tmp_path / "o"),
                              depth=16, **SMALL)
    assert path.read_text() == before
    with pytest.raises(FileNotFoundError, match="no harvest"):
        heldout.heldout_trend(str(tmp_path), config="tiny_test", device="cpu")


@pytest.mark.parametrize("best_step,cands", [(5, [("infer", 6), ("infer_best", 5)]),
                                             (6, [("infer", 6)])])
def test_pick_export_step(tmp_path, best_step, cands):
    run = tmp_path / "run"
    for step in (4, 5, 6):
        _export(run / "infer", step, step)
    _export(run / "infer_best", best_step, best_step)
    lines = []
    got = heldout.pick_export_step(str(run), config="tiny_test", batch=2, seconds=0.5,
                                   depths=(1, 2), device="cpu", log=lines.append)
    wavs = next(make_source("synthetic2", CFG.sample_rate, seed=1).batches(2, 8000))
    mel = {}
    for sub, step in cands:
        b = api.load_model("tiny_test", checkpoint=str(run / sub / str(step)), serving=True,
                           device="cpu")
        mel[step] = bitrate_sweep(b, wavs, [1, 2])[-1]["mel_distance"]
    want = min(mel, key=mel.get)
    assert got == want
    assert lines[-1] == f"RECOMMEND --step {want}"
    table = [ln for ln in lines if "@" in ln and "favors" not in ln]
    assert sorted({ln.split()[0] for ln in table}) == sorted(f"{s}@{n}" for s, n in cands)
    assert len(table) == 2 * len(cands)
    assert heldout.pick_export_step(str(tmp_path / "empty"), config="tiny_test",
                                    device="cpu") is None


@pytest.fixture
def run_dir(tmp_path):
    """infer/ 4-6, infer_best/ 5, harvest/ 1-6 (sha-distinct weights per step)."""
    run = tmp_path / "run"
    for step in (4, 5, 6):
        _export(run / "infer", step, step)
    _export(run / "infer_best", 5, 5)
    for step in range(1, 7):
        _export(run / "harvest", step, step)
    return run


SELECT = [  # (best.json's step or None, explicit --step, subdirs removed, expected source)
    (5, None, (), "infer_best/5"),
    (4, None, (), "infer/4"),
    (2, None, (), "harvest/2"),
    (9, None, (), "infer_best/5"),
    (5, 4, (), "infer/4"),
    (None, None, (), "infer_best/5"),
    (None, None, ("infer_best",), "infer/6"),
    (5, 9, (), LookupError),
    (None, None, ("infer_best", "infer"), LookupError),
]


@pytest.mark.parametrize("best,step,removed,want", SELECT)
def test_export_step_selection(run_dir, best, step, removed, want):
    import shutil

    if best is not None:
        (run_dir / "best.json").write_text(json.dumps({"metric": "loss/mel", "value": 0.5,
                                                       "step": best}))
    for sub in removed:
        shutil.rmtree(run_dir / sub)
    if want is LookupError:
        with pytest.raises(LookupError):
            export.select_step(str(run_dir), step, print)
    else:
        assert export.select_step(str(run_dir), step, print) == str(run_dir / want)


def test_export_script_writes_the_export_and_a_cpu_pin(run_dir, tmp_path):
    dest = tmp_path / "exports" / "flag"
    out = _script("torch_export_flagship.py", run_dir, "--name", "flag", "--dest", dest,
                  "--step", 2, "--segment-len", 17600, "--device", "cpu")
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["recheck_exact"] is True and res["same_backend"] is True and res["step"] == 2
    src = run_dir / "harvest" / "2"
    assert (dest / "weights.npz").read_bytes() == (src / "weights.npz").read_bytes()
    meta = json.loads((dest / "meta.json").read_text())
    src_meta = json.loads((src / "meta.json").read_text())
    assert meta == {**src_meta, "data": "synthetic2:pool=16", "segment_len": 17600,
                    "run_dir": os.path.relpath(run_dir, REPO)}
    assert sorted(os.listdir(dest)) == ["canonical_idx_gpu.npz", "meta.json", "weights.npz"]
    assert res["recheck_rate"] == 1.0 and res["pin"] == str(dest / canonical.PIN_NAME)

    # another step's weights at the same destination: refused, nothing touched
    before = {n: (dest / n).read_bytes() for n in os.listdir(dest)}
    with pytest.raises(ValueError, match="holds other weights"):
        export.export_flagship(str(run_dir), "flag", step=3, dest=str(dest), device="cpu")
    assert {n: (dest / n).read_bytes() for n in os.listdir(dest)} == before
    # an explicit step found nowhere: exit 1, nothing written
    out = _script("torch_export_flagship.py", run_dir, "--name", "x", "--dest",
                  tmp_path / "exports" / "x", "--step", 9, "--device", "cpu")
    assert out.returncode == 1 and "--step 9 not found" in out.stderr
    assert not (tmp_path / "exports" / "x").exists()


@pytest.mark.parametrize("script", ["torch_heldout_trend.py", "torch_pick_export_step.py",
                                    "torch_export_flagship.py", "torch_harvest_checkpoints.py",
                                    "torch_train_watchdog.py"])
def test_script_help(script):
    out = _script(script, "--help", timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "usage" in out.stdout.lower()
