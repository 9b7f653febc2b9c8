"""The port's training loop and checkpoints (`nsc_tpu_torch.train.loop`,
`train.checkpoint`) against the JAX package's, on the CPU.

  * eviction keeps the steps orbax keeps (exact);
  * `save_inference` writes the arrays and fingerprint of the export script
    (bit-exact);
  * a workdir resolves to infer_best, else infer, else itself; the orbax
    flagship still raises;
  * the fault-recovery tests of the JAX package, ported, with the full-save
    steps of one JAX run of the same `TrainConfig`;
  * a resume through the prefetcher from a mid-run checkpoint, for a WAV
    directory and a pooled source, is bit-exact against an uninterrupted
    run (metrics rows and the final state);
  * the warm batch of a pooled spec is the JAX package's and builds no pool.
"""

import json
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from nsc_tpu.configs import TrainConfig as JTrainConfig
from nsc_tpu.configs import get_config as jget_config
from nsc_tpu.train import checkpoint as JC
from nsc_tpu.train import data as JD
from nsc_tpu_torch import api as PA
from nsc_tpu_torch import weights as W
from nsc_tpu_torch.configs import TrainConfig, get_config
from nsc_tpu_torch.train import checkpoint as ckpt
from nsc_tpu_torch.train import data as D
from nsc_tpu_torch.train import loop as L
from nsc_tpu_torch.train import train as T
from nsc_tpu_torch.utils import audio
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))
import export_torch_checkpoint as E  # noqa: E402

FLAGSHIP = os.path.join(ROOT, "artifacts", "base_fast_synthetic2_48k_refit")

# tests/integration/test_fault_recovery.py::_tcfg
_FAULT = dict(
    batch_size=8, segment_seconds=0.032, use_gan=False, disc_width_mult=1 / 16,
    stft_fft_sizes=(128, 64), mel_fft_size=128, mel_bins=10, quantizer_dropout=0.0,
    log_every=1, checkpoint_every=3,
)
_FIRST_BOUNDARY = dict(_FAULT, checkpoint_every=2, full_state_every=100)


def _rows(workdir):
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        r.pop("steps_per_sec", None)
    return rows


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("keep,period", [(3, 4), (2, None), (1, 3)])
def test_eviction_keeps_the_steps_orbax_keeps(tmp_path, keep, period):
    tree = {"a": np.arange(3, dtype=np.float32)}
    for step in range(1, 11):
        JC.save(str(tmp_path / "orbax"), step, tree, max_to_keep=keep, keep_period=period)
        ckpt.save(str(tmp_path / "port"), step, W.to_tensors(tree), max_to_keep=keep,
                  keep_period=period)
    mgr = JC._manager(str(tmp_path / "orbax"))
    want = sorted(mgr.all_steps())
    mgr.close()
    assert ckpt.all_steps(str(tmp_path / "port")) == want
    assert ckpt.kept_steps(range(1, 11), keep, period) == want
    assert sorted(os.listdir(tmp_path / "port")) == [f"ckpt_{s:09d}.pt" for s in want]


def test_save_inference_writes_the_export_scripts_arrays(tmp_path):
    """Same trees (tiny_test, seeded, JAX layout): the same npz arrays and
    the same fingerprint as `export_torch_checkpoint.export_weights`; the
    newest 3 steps kept."""
    params, rvq = W.init_jax_layout(get_config("tiny_test"), 3)
    want = E.export_weights("tiny_test", params, rvq, str(tmp_path / "script"), step=5)
    tensors = (W.to_tensors(params), W.to_tensors(rvq))
    for step in (1, 2, 5, 7):
        ckpt.save_inference(str(tmp_path / "infer"), step, *tensors,
                            {"config": "tiny_test", "data": "synthetic"})
    assert ckpt.export_steps(str(tmp_path / "infer")) == [2, 5, 7]
    with np.load(tmp_path / "script" / E.WEIGHTS) as a, \
            np.load(tmp_path / "infer" / "5" / ckpt.EXPORT_WEIGHTS) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype == np.float32
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    meta = ckpt.export_meta(str(tmp_path / "infer"))
    assert meta["step"] == 7 and meta["data"] == "synthetic"
    meta = ckpt.export_meta(str(tmp_path / "infer" / "5"))
    assert meta["fingerprint"] == want["fingerprint"] and meta["values"] == want["values"]
    assert meta["weights_sha256"] == E.sha256(str(tmp_path / "infer" / "5" / ckpt.EXPORT_WEIGHTS))
    got_p, got_q = ckpt.restore_inference(str(tmp_path / "infer" / "5"))
    np.testing.assert_array_equal(got_q["codebooks"], rvq["codebooks"])


def test_workdir_resolution_and_orbax_refusal(tmp_path):
    """infer_best's newest step > infer's newest step > the directory itself;
    a port workdir is not taken for an orbax store, the flagship's orbax
    store still raises naming the export script."""
    cfg = get_config("tiny_test")
    wd = tmp_path / "wd"
    trees = [W.to_tensors(W.init_jax_layout(cfg, s)) for s in range(3)]
    meta = {"config": "tiny_test"}
    ckpt.save_inference(str(wd / "infer"), 4, *trees[0], meta)
    ckpt.save_inference(str(wd / "infer"), 6, *trees[1], meta)
    assert not ckpt._is_orbax(str(wd))
    assert ckpt.resolve_export(str(wd)) == str(wd / "infer" / "6")
    fp = lambda b: PA.codebook_fingerprint(b.rvq)  # noqa: E731
    assert fp(PA.load_model("tiny_test", checkpoint=str(wd), device="cpu")) == \
        PA.codebook_fingerprint(trees[1][1])
    ckpt.save_inference(str(wd / "infer_best"), 2, *trees[2], meta)
    assert ckpt.resolve_export(str(wd)) == str(wd / "infer_best" / "2")
    assert ckpt.export_meta(str(wd))["step"] == 2
    assert fp(PA.load_model("tiny_test", checkpoint=str(wd), device="cpu")) == \
        PA.codebook_fingerprint(trees[2][1])
    plain = tmp_path / "plain"
    E.export_weights("tiny_test", *W.init_jax_layout(cfg, 0), str(plain))
    assert ckpt.resolve_export(str(plain)) == str(plain)
    with pytest.raises(ValueError, match="export_torch_checkpoint.py"):
        ckpt.export_meta(FLAGSHIP)
    with pytest.raises(ValueError, match="holds a 'tiny_test' model, not 'small'"):
        PA.load_model("small", checkpoint=str(wd), device="cpu")
    (wd / "infer_best" / "2" / ckpt.EXPORT_META).unlink()
    with pytest.raises(FileNotFoundError):
        PA.load_model("tiny_test", checkpoint=str(wd / "infer_best" / "2"), device="cpu")


# ---------------------------------------------------------------------------
# the loop against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_first_boundary(tmp_path_factory):
    """One JAX run of test_first_checkpoint_boundary_is_a_full_save's
    TrainConfig (5 steps): its full-save and export steps."""
    from nsc_tpu.train import loop as JL

    wd = tmp_path_factory.mktemp("jax") / "run"
    JL.run(jget_config("tiny_test"), JTrainConfig(**_FIRST_BOUNDARY), workdir=str(wd),
           data_spec="synthetic", steps=5)
    out = {}
    for sub in ("train", "infer", "infer_best"):
        mgr = JC._manager(str(wd / sub))
        out[sub] = sorted(mgr.all_steps())
        mgr.close()
    return out


def test_first_checkpoint_boundary_is_a_full_save(tmp_path, jax_first_boundary):
    """Port of tests/integration/test_fault_recovery.py::
    test_first_checkpoint_boundary_is_a_full_save, and the JAX loop's own
    steps for the same TrainConfig."""
    wd = str(tmp_path / "run")
    L.run(get_config("tiny_test"), TrainConfig(**_FIRST_BOUNDARY), workdir=wd,
          data_spec="synthetic", steps=5, device="cpu")
    steps = ckpt.all_steps(os.path.join(wd, "train"))
    assert 2 in steps and 4 not in steps and 5 in steps
    assert steps == jax_first_boundary["train"] == [2, 5]
    assert ckpt.export_steps(os.path.join(wd, "infer")) == jax_first_boundary["infer"] == [2, 4, 5]


def test_crash_and_resume(tmp_path):
    """Port of tests/integration/test_fault_recovery.py::test_crash_and_resume."""
    cfg = get_config("tiny_test")
    wd = str(tmp_path / "run")
    L.run(cfg, TrainConfig(**_FAULT), workdir=wd, data_spec="synthetic", steps=4, device="cpu")
    assert ckpt.latest_step(os.path.join(wd, "train")) == 4  # the final save too
    L.run(cfg, TrainConfig(**_FAULT), workdir=wd, data_spec="synthetic", steps=7, device="cpu")
    assert ckpt.latest_step(os.path.join(wd, "train")) == 7
    rows = _rows(wd)
    steps = [r["step"] for r in rows]
    assert max(steps) == 7
    assert sorted(set(steps)) == steps, "steps re-ran from zero after resume"
    assert all(np.isfinite(r["loss/g_total"]) for r in rows)
    bundle = PA.load_model("tiny_test", checkpoint=wd, device="cpu")
    idx = PA.encode(bundle, np.zeros(cfg.hop * 8, np.float32))
    assert idx.shape == (8, cfg.num_quantizers)
    assert ckpt.export_steps(os.path.join(wd, "infer_best"))
    with open(os.path.join(wd, "best.json")) as f:
        best = json.load(f)
    assert best["metric"] == "loss/mel"
    assert np.isfinite(best["value"]) and 1 <= best["step"] <= 7


def test_best_json_survives_a_restart(tmp_path):
    """A resumed run compares against the best.json it finds: an
    unbeatable recorded value leaves infer_best/ and best.json as they
    were."""
    cfg = get_config("tiny_test")
    tcfg = TrainConfig(**dict(_FAULT, checkpoint_every=1))
    wd = str(tmp_path / "run")
    L.run(cfg, tcfg, workdir=wd, data_spec="synthetic", steps=2, device="cpu")
    best_steps = ckpt.export_steps(os.path.join(wd, "infer_best"))
    assert best_steps and best_steps[-1] <= 2
    L.write_json(os.path.join(wd, "best.json"), {"metric": "loss/mel", "value": 0.0, "step": 2})
    L.run(cfg, tcfg, workdir=wd, data_spec="synthetic", steps=4, device="cpu")
    assert ckpt.export_steps(os.path.join(wd, "infer_best")) == best_steps
    with open(os.path.join(wd, "best.json")) as f:
        assert json.load(f) == {"metric": "loss/mel", "value": 0.0, "step": 2}
    assert ckpt.export_steps(os.path.join(wd, "infer")) == [2, 3, 4]
    # without the sidecar a resume starts from infinity and improves at once
    os.remove(os.path.join(wd, "best.json"))
    L.run(cfg, tcfg, workdir=wd, data_spec="synthetic", steps=5, device="cpu")
    with open(os.path.join(wd, "best.json")) as f:
        assert json.load(f)["step"] == 5


def test_default_train_config_keeps_what_the_reference_keeps(tmp_path):
    """keep_checkpoints full states (plus keep_period multiples) and 3
    exports, with checkpoint_every 1 and full_state_every 2."""
    cfg = get_config("tiny_test")
    tcfg = TrainConfig(**dict(_FAULT, checkpoint_every=1, full_state_every=2,
                              keep_checkpoints=2, keep_period=3))
    wd = str(tmp_path / "run")
    L.run(cfg, tcfg, workdir=wd, data_spec="synthetic", steps=8, device="cpu")
    # full saves at 1 (first boundary), 3, 5, 7 and 8 (the end)
    assert ckpt.all_steps(os.path.join(wd, "train")) == ckpt.kept_steps([1, 3, 5, 7, 8], 2, 3)
    assert ckpt.all_steps(os.path.join(wd, "train")) == [3, 7, 8]
    assert ckpt.export_steps(os.path.join(wd, "infer")) == [6, 7, 8]
    assert len(ckpt.export_steps(os.path.join(wd, "infer_best"))) <= 3


# ---------------------------------------------------------------------------
# the entry point: resume through the prefetcher, the warm batch, the flags
# ---------------------------------------------------------------------------

_CLI = ["--config", "tiny_test", "--device", "cpu", "--batch-size", "2", "--no-gan",
        "--segment-seconds", "0.128", "--warmup-steps", "1", "--lr-decay-steps", "10"]


@pytest.fixture()
def wav_dir(tmp_path):
    d = tmp_path / "wavs"
    d.mkdir()
    for i in range(4):
        audio.save_wav(str(d / f"{i}.wav"),
                       np.random.RandomState(i).randn(6000).astype(np.float32) * 0.1, 16_000)
    audio.save_wav(str(d / "stereo.wav"),
                   np.random.RandomState(9).randn(7000, 2).astype(np.float32) * 0.1, 22_050)
    return str(d)


@pytest.mark.parametrize("spec", ["wavs", "synthetic2:pool=16"])
def test_resume_from_a_mid_run_checkpoint_is_bit_exact(tmp_path, wav_dir, spec):
    """An uninterrupted 5-step run (checkpoints at 2 and 4, written while the
    prefetcher and the device prefetch ran ahead of the step), and a run
    that resumes from the first one's step-2 checkpoint: the same metrics
    rows after step 2 and the same final state, bit for bit."""
    spec = wav_dir if spec == "wavs" else spec
    cfg = get_config("tiny_test")
    tcfg = TrainConfig(batch_size=2, segment_seconds=0.128, use_gan=False, log_every=1,
                       checkpoint_every=2, full_state_every=0, keep_checkpoints=5,
                       warmup_steps=1, lr_decay_steps=10)
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    L.run(cfg, tcfg, workdir=a, data_spec=spec, steps=5, device="cpu")
    assert ckpt.all_steps(os.path.join(a, "train")) == [2, 4, 5]
    os.makedirs(os.path.join(b, "train"))
    shutil.copy(ckpt.path_for(os.path.join(a, "train"), 2), os.path.join(b, "train"))
    L.run(cfg, tcfg, workdir=b, data_spec=spec, steps=5, device="cpu")
    ra, rb = _rows(a), _rows(b)
    assert [r["step"] for r in ra] == [1, 2, 3, 4, 5]
    assert [r["step"] for r in rb] == [3, 4, 5]
    assert ra[2:] == rb
    sa, ta, da = ckpt.restore(os.path.join(a, "train"))
    sb, tb, db = ckpt.restore(os.path.join(b, "train"))
    assert sa == sb == 5
    la, lb = T.tree_leaves([ta, da]), T.tree_leaves([tb, db])
    assert len(la) == len(lb) > 50
    assert all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
               for x, y in zip(la, lb))


def test_warm_batch_of_a_pooled_spec_is_the_references(monkeypatch):
    """The data init strips ':pool=' (as nsc_tpu/train/loop.py does): the
    batch its encoder sees equals the JAX package's warm batch, and no pool
    is built."""
    from nsc_tpu_torch.models.codec import NeuralSpeechCodec

    cfg = get_config("tiny_test")
    tcfg = TrainConfig(batch_size=20, segment_seconds=0.05, seed=4, use_gan=False)

    def no_pool(*_):
        raise AssertionError("the warm batch built a pool")

    seen = []
    latents = NeuralSpeechCodec.train_latents

    def spy(self, tree, wav):
        seen.append(wav.clone())
        return latents(self, tree, wav)

    monkeypatch.setattr(D.PooledSource, "_build", no_pool)
    monkeypatch.setattr(NeuralSpeechCodec, "train_latents", spy)
    model, state = T.init_train_state(cfg, tcfg, torch.device("cpu"))
    L.data_init_codebooks(model, state, tcfg, "synthetic:pool=32")
    seg0 = int(tcfg.segment_seconds * cfg.sample_rate)
    seg0 = max(cfg.hop, (seg0 // cfg.hop) * cfg.hop)
    want = next(JD.make_source("synthetic", cfg.sample_rate, tcfg.seed).batches(16, seg0))
    assert len(seen) == 1
    np.testing.assert_array_equal(seen[0].numpy(), want)
    np.testing.assert_array_equal(L.warm_batch(cfg, tcfg, "synthetic:pool=32"), want)


def test_new_cli_flags(tmp_path):
    """--checkpoint-every and --full-state-every reach the TrainConfig
    (`parse_args`), and through `main` the run: boundaries 2 and 4 and the
    end (5); full at 2 (the first) and 5 (the end), both kept
    (keep_checkpoints 3); exports at each."""
    wd = tmp_path / "run"
    argv = _CLI + ["--steps", "5", "--workdir", str(wd), "--checkpoint-every", "2",
                   "--full-state-every", "10"]
    _, tcfg, kwargs = L.parse_args(argv)
    assert (tcfg.checkpoint_every, tcfg.full_state_every, tcfg.keep_checkpoints) == (2, 10, 3)
    assert kwargs == {"workdir": str(wd), "data_spec": "synthetic", "steps": 5, "resume": True,
                      "device": "cpu", "debug_nans": False, "distributed": False,
                      "deterministic": False}
    assert L.main(argv) == 0
    assert ckpt.all_steps(str(wd / "train")) == [2, 5]
    assert ckpt.export_steps(str(wd / "infer")) == [2, 4, 5]


def test_rss_limit_saves_a_full_state_and_exits_99(tmp_path, monkeypatch, capsys):
    """The host-RSS guard (the JAX loop's): with a limit below this
    process's RSS, the first checkpoint boundary (step 3) saves a full
    state synchronously and exits 99; a relaunch without the limit resumes
    from it."""
    from nsc_tpu_torch.utils import liveness

    cfg, wd = get_config("tiny_test"), str(tmp_path / "run")
    monkeypatch.setenv("NSC_RSS_EXIT_GB", "0.001")
    with pytest.raises(SystemExit) as e:
        L.run(cfg, TrainConfig(**_FAULT), workdir=wd, data_spec="synthetic", steps=5,
              device="cpu")
    assert e.value.code == liveness.EXIT_RSS_LIMIT == 99
    assert "NSC-LIVENESS: HOST RSS LIMIT" in capsys.readouterr().out
    step, state, data_state = ckpt.restore(os.path.join(wd, "train"))
    assert step == 3 and "opt_g" in state and data_state is not None
    monkeypatch.setenv("NSC_RSS_EXIT_GB", "0")
    L.run(cfg, TrainConfig(**_FAULT), workdir=wd, data_spec="synthetic", steps=5, device="cpu")
    assert [r["step"] for r in _rows(wd)] == [1, 2, 3, 4, 5]


def test_debug_nans_raises_at_the_poisoned_step(tmp_path, monkeypatch):
    """`--debug-nans`: a batch of NaNs at step 2 raises FloatingPointError
    naming step 2 (anomaly detection in the backward, or the metrics'
    check), before any checkpoint of it; without the flag the loop trains
    on (no error at that step)."""
    calls = []
    real = L.batch_to_device

    def poisoned(item, dev):
        batch, data_state = real(item, dev)
        calls.append(1)
        if len(calls) == 2:
            batch = torch.full_like(batch, float("nan"))
        return batch, data_state

    monkeypatch.setattr(L, "batch_to_device", poisoned)
    cfg = get_config("tiny_test")
    argv = _CLI + ["--steps", "3", "--workdir", str(tmp_path / "a"), "--debug-nans"]
    _, tcfg, kwargs = L.parse_args(argv)
    assert kwargs["debug_nans"] is True
    with pytest.raises(FloatingPointError, match="step 2"):
        L.run(cfg, TrainConfig(**_FAULT), **{**kwargs, "steps": 3})
    assert ckpt.latest_step(str(tmp_path / "a" / "train")) is None
    calls.clear()
    L.run(cfg, TrainConfig(**_FAULT), workdir=str(tmp_path / "b"), data_spec="synthetic",
          steps=2, device="cpu")
