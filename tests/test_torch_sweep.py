"""The port's bitrate sweep (`nsc_tpu_torch/eval/sweep.py`) against
nsc_tpu's, its entry point `python -m nsc_tpu_torch.eval`, and the port's
scripts (`scripts/torch_refit_flagship.py`,
`torch_finetune_flagship.py`, `torch_rd_ceiling.py`).

Both sweeps run float32 `tiny_test` from the same weights (nsc_tpu's seeded
init, converted) on 2 x 0.5 s. The integer fields (`n_q`, `bitrate_bps`)
and, where the indices are equal, the index-derived fields
(`entropy_bitrate_bps`, `book_perplexity`, `book_usage`, `index_match`)
must be equal. The float fields are held within FLOAT_TOL: the two
reconstructions agree to the parity tolerance (rtol 1e-3, atol 1e-4,
`tests/parity/test_torch_parity.py`; here within 2.4e-7), and each metric
but STOI is a smooth function of them (dB fields in absolute dB, the others
relative to their value). Taal's STOI drops frames 40 dB below the loudest
by a hard threshold and clips, so a one-ulp change of the reconstruction
can move it: with the same function on both sides (the port's copy returns
nsc_tpu's value bit for bit on the same arrays), the two reconstructions
moved it by 3.2e-4 on this input and by 7.2e-4 on white noise; it is held
at 2e-3 absolute.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import nsc_tpu
from nsc_tpu.eval.sweep import bitrate_sweep as jsweep
from nsc_tpu_torch import api
from nsc_tpu_torch import weights as W
from nsc_tpu_torch.configs import get_config
from nsc_tpu_torch.eval.sweep import bitrate_sweep
from nsc_tpu_torch.train import checkpoint as ckpt
from nsc_tpu_torch.train.data import SyntheticSource
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = ("torch_refit_flagship.py", "torch_finetune_flagship.py", "torch_rd_ceiling.py")
INDEX_FIELDS = ("entropy_bitrate_bps", "book_perplexity", "book_usage", "index_match")
# field -> (rtol, atol)
FLOAT_TOL = {"si_snr_db": (0.0, 2e-3), "mel_distance": (1e-4, 1e-6),
             "pesq_proxy": (1e-3, 1e-4), "stoi_proxy": (1e-3, 1e-4),
             "visqol_nsim": (1e-3, 1e-4), "stoi": (0.0, 2e-3)}


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.fixture(scope="module")
def sweeps():
    jb = nsc_tpu.api.load_model("tiny_test", seed=0)
    params = W.tree_map(np.asarray, jb.params)
    rvq = W.tree_map(np.asarray, jb.rvq)
    pb = api.bundle_from_jax(get_config("tiny_test"), params, rvq, device="cpu")
    ref_pb = api.load_model("tiny_test", seed=3, device="cpu")
    ref_jb = nsc_tpu.api.load_model("tiny_test", seed=3)
    wavs = next(SyntheticSource(16000, 0).batches(2, 8000))  # 2 x 0.5 s
    got = bitrate_sweep(pb, wavs, reference_bundle=ref_pb)
    want = jsweep(jb, wavs, reference_bundle=ref_jb)
    same_idx = [np.array_equal(api.encode(pb, wavs)[..., : r["n_q"]],
                               np.asarray(nsc_tpu.api.encode(jb, wavs))[..., : r["n_q"]])
                for r in want]
    ref_same = np.array_equal(api.encode(ref_pb, wavs), np.asarray(nsc_tpu.api.encode(ref_jb, wavs)))
    return got, want, same_idx, ref_same, (params, rvq)


def test_rows_and_keys_match_nsc_tpu(sweeps):
    got, want, *_ = sweeps
    assert [r["n_q"] for r in got] == [r["n_q"] for r in want] == [1, 2]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert g["bitrate_bps"] == w["bitrate_bps"]


def test_index_fields_equal_where_the_indices_are(sweeps):
    got, want, same_idx, ref_same, _ = sweeps
    assert all(same_idx), "the port's float32 indices differ from nsc_tpu's on random books"
    for g, w, same in zip(got, want, same_idx):
        for k in INDEX_FIELDS:
            if k == "index_match" and not ref_same:
                continue
            assert g[k] == w[k], (g["n_q"], k, g[k], w[k])


@pytest.mark.parametrize("field", sorted(FLOAT_TOL))
def test_float_fields_within_tolerance(sweeps, field):
    got, want, *_ = sweeps
    rtol, atol = FLOAT_TOL[field]
    for g, w in zip(got, want):
        assert (field in g) == (field in w), field
        if field in w:
            np.testing.assert_allclose(g[field], w[field], rtol=rtol, atol=atol,
                                       err_msg=f"n_q {g['n_q']} {field}")


def test_eval_entry_point_json(tmp_path):
    out = subprocess.run(
        [sys.executable, "-m", "nsc_tpu_torch.eval", "--model", "tiny_test", "--seconds", "0.5",
         "--batch", "2", "--json", "--device", "cpu"],
        capture_output=True, text=True, env=_env(), cwd=str(tmp_path), timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    rows = json.loads(out.stdout.strip().splitlines()[-1])
    assert [r["n_q"] for r in rows] == [1, 2]
    assert all(np.isfinite(r["mel_distance"]) for r in rows)


@pytest.mark.parametrize("script", SCRIPTS)
def test_script_help(script):
    out = subprocess.run([sys.executable, os.path.join(REPO, "scripts", script), "--help"],
                         capture_output=True, text=True, env=_env(), timeout=60)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "--device" in out.stdout


def test_refit_script_on_a_tiny_export(sweeps, tmp_path):
    params, rvq = sweeps[4]
    src = tmp_path / "src"
    step_dir = ckpt.save_inference(str(src), 5, params, rvq,
                                   {"config": "tiny_test", "data": "synthetic"})
    exports, report = tmp_path / "exports", tmp_path / "report.json"
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_refit_flagship.py"), step_dir,
         "--frames", "200", "--iters", "2", "--batch", "2", "--seconds", "0.5",
         "--depths", "1,2", "--export", "tiny_refit", "--exports-dir", str(exports),
         "--report", str(report), "--device", "cpu"],
        capture_output=True, text=True, env=_env(), timeout=240)
    rep = json.loads(report.read_text())
    assert [r["n_q"] for r in rep["sweep_after"]] == [1, 2]
    assert rep["pool_after"]["residual_mse_per_depth"][-1] <= \
        rep["pool_before"]["residual_mse_per_depth"][-1]
    worse = rep["sweep_after"][-1]["mel_distance"] > rep["sweep_before"][-1]["mel_distance"]
    if worse:  # the reference's refusal rule
        assert out.returncode == 2 and "refusing to export" in out.stderr
        assert not (exports / "tiny_refit").exists()
        return
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    meta = ckpt.export_meta(str(exports / "tiny_refit"))
    assert meta["lineage"] == 1 and meta["refit"]["kmeans_iters"] == 2
    assert os.path.exists(exports / "tiny_refit" / "canonical_idx_gpu.npz")
    b = api.load_model("tiny_test", checkpoint=str(exports / "tiny_refit"), device="cpu")
    assert not np.array_equal(b.rvq["codebooks"].numpy(), rvq["codebooks"])
