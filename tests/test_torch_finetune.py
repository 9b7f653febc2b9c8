"""The port's decoder finetune (`nsc_tpu_torch.train.finetune`) against the
JAX package's (`nsc_tpu.train.finetune`), on the CPU.

One finetune step on `small` from the same weights and batch, with JAX's
own quantizer-dropout depths passed in (random codebooks at the latents'
scale, as `tests/test_torch_train.py` does for the GAN step and for the
same reason). Tolerances, as that file's:
  * every metric at rtol 1e-4;
  * decoder gradients per leaf within 1e-3 * max|g| of the leaf, compared
    as the first Adam moment after the step ((1 - b1) x the clipped
    gradient);
  * decoder parameters after the step within 1e-6 where the JAX gradient
    is at least max(1e-3 * max|g| of the leaf, 1e-6), elsewhere within
    2 * lr (Adam's first step is lr * g / (|g| + 1e-8));
  * the encoder and the codebooks bit-identical to their inputs.
Then the tests of `tests/unit/test_finetune.py`, ported, and the stale
`infer_best/` case the port does not copy.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsc_tpu.configs import get_config as jget_config
from nsc_tpu.models.codec import NeuralSpeechCodec
from nsc_tpu.train import finetune as JF
from nsc_tpu.train import train as JT
from nsc_tpu.train.data import SyntheticSource
from nsc_tpu_torch import api as PA
from nsc_tpu_torch import weights as W
from nsc_tpu_torch.configs import get_config
from nsc_tpu_torch.train import checkpoint as ckpt
from nsc_tpu_torch.train import finetune
from nsc_tpu_torch.train import train as T
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

_SMALL = dict(segment_seconds=0.2, stft_fft_sizes=(512, 256, 128), mel_fft_size=512,
              mel_bins=40, quantizer_dropout=0.5)


def _find_adam(opt_state):
    for leaf in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return leaf
    raise AssertionError("no Adam state")


@pytest.fixture(scope="module")
def one_step():
    cfg = jget_config("small")
    jt = dataclasses.replace(JF.finetune_config(10, lr=1e-3, batch_size=4, warmup_steps=2),
                             **_SMALL)
    tcfg = dataclasses.replace(finetune.finetune_config(10, lr=1e-3, batch_size=4,
                                                        warmup_steps=2), **_SMALL)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jt)
    params, rvq0 = W.init_jax_layout(get_config("small"), 0)
    frames = 10
    batch = next(SyntheticSource(16000, 0).batches(4, frames * cfg.hop)).copy()
    jmodel = NeuralSpeechCodec(cfg)
    z = np.asarray(jax.jit(jmodel.latents)(jax.tree.map(jnp.asarray, params), jnp.asarray(batch)))
    cb = (np.random.RandomState(5).randn(*rvq0["codebooks"].shape) * z.std()).astype(np.float32)
    rvq = {"codebooks": cb}
    jstate = JF.init_finetune_state(jax.random.PRNGKey(7), jax.tree.map(jnp.asarray, params),
                                    jax.tree.map(jnp.asarray, rvq), jt)
    depth = np.asarray(JT._sample_depths(jax.random.fold_in(jstate["rng"], 0), 4,
                                         cfg.num_quantizers, jt.quantizer_dropout))
    new, metrics = jax.jit(JF.make_finetune_step(jmodel, jt))(jstate, jnp.asarray(batch))
    ref = {"metrics": {k: float(v) for k, v in metrics.items()},
           "decoder": jax.tree.map(np.asarray, new["params_g"]["decoder"]),
           "mu": jax.tree.map(np.asarray, _find_adam(new["opt"]).mu)}

    state = finetune.init_finetune_state(params, rvq, torch.device("cpu"))
    enc_before = [x.clone() for x in T.tree_leaves(state["params_g"]["encoder"])]
    step = finetune.make_finetune_step(T.model_for(get_config("small")), tcfg)
    state, pm = step(state, torch.from_numpy(batch), depth=torch.from_numpy(depth.copy()))
    got = {"metrics": {k: float(v) for k, v in pm.items()},
           "decoder": W.to_numpy(state["params_g"]["decoder"]),
           "mu": W.to_numpy(state["opt"]["mu"]), "depth": depth, "state": state,
           "enc_before": enc_before, "books": cb}
    return ref, got, tcfg


def test_finetune_step_metrics_match_jax(one_step):
    ref, got, _ = one_step
    assert set(got["metrics"]) == set(ref["metrics"])
    assert (got["depth"] < 2).any()  # some dropout this step
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4, atol=1e-7, err_msg=k)


def test_finetune_step_decoder_gradients_match_jax(one_step):
    ref, got, _ = one_step
    r_leaves, r_def = jax.tree.flatten(ref["mu"])
    g_leaves, g_def = jax.tree.flatten(got["mu"])
    assert r_def == g_def and len(r_leaves) > 20
    for g, r in zip(g_leaves, r_leaves):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-3 * np.abs(r).max())


def test_finetune_step_decoder_matches_jax_and_the_rest_is_frozen(one_step):
    ref, got, tcfg = one_step
    new_r, new_g, mus = (jax.tree.leaves(t) for t in (ref["decoder"], got["decoder"], ref["mu"]))
    assert len(new_r) == len(new_g) == len(mus)
    for g, r, mu in zip(new_g, new_r, mus):
        grad = np.abs(mu) / (1 - tcfg.adam_b1)
        small = grad < max(1e-3 * grad.max(), 1e-6)
        diff = np.abs(g - r)
        assert diff[~small].max(initial=0) <= 1e-6
        assert diff[small].max(initial=0) <= 2 * tcfg.lr_g
    state = got["state"]
    assert all(torch.equal(a, b) for a, b in zip(
        got["enc_before"], T.tree_leaves(state["params_g"]["encoder"])))
    np.testing.assert_array_equal(state["rvq"]["codebooks"].numpy(), got["books"])
    assert state["step"] == 1 and state["opt"]["count"] == 1


# ---------------------------------------------------------------------------
# tests/unit/test_finetune.py, ported
# ---------------------------------------------------------------------------


def _state_and_step(steps_cfg=50):
    cfg = get_config("tiny_test")
    params, rvq = W.init_jax_layout(cfg, 0)
    tcfg = finetune.finetune_config(steps_cfg, lr=3e-3, batch_size=4)
    state = finetune.init_finetune_state(params, rvq, torch.device("cpu"))
    step_fn = finetune.make_finetune_step(T.model_for(cfg), tcfg)
    return cfg, state, step_fn


def _batch(cfg, seed):
    """4 segments of 2080 samples: the JAX test's 8 hops of tiny_test are
    shorter than the 2048-point loss STFT's reflect pad, which PyTorch's pad
    refuses (jnp.pad reflects again)."""
    return torch.from_numpy((np.random.RandomState(seed).randn(4, 2080) * 0.1)
                            .astype(np.float32))


def test_finetune_moves_only_the_decoder():
    cfg, state, step_fn = _state_and_step()
    rest = [x.clone() for k, v in state["params_g"].items() if k != "decoder"
            for x in T.tree_leaves(v)]
    books = state["rvq"]["codebooks"].clone()
    dec = [x.detach().clone() for x in T.tree_leaves(state["params_g"]["decoder"])]
    batch = _batch(cfg, 0)
    for _ in range(3):
        state, metrics = step_fn(state, batch)
    after = [x for k, v in state["params_g"].items() if k != "decoder" for x in T.tree_leaves(v)]
    assert len(rest) == len(after) > 10
    assert all(torch.equal(a, b) for a, b in zip(rest, after))
    assert torch.equal(books, state["rvq"]["codebooks"])
    assert any(not torch.equal(a, b) for a, b in zip(dec, T.tree_leaves(state["params_g"]["decoder"])))
    assert state["step"] == 3
    assert all(np.isfinite(float(v)) for v in metrics.values())


def test_finetune_loss_decreases_on_fixed_batch():
    cfg, state, step_fn = _state_and_step(steps_cfg=40)
    batch = _batch(cfg, 1)
    first = None
    for _ in range(40):
        state, metrics = step_fn(state, batch)
        if first is None:
            first = float(metrics["loss/g_total"])
    assert float(metrics["loss/g_total"]) < first


def test_finetune_state_checkpoint_roundtrip(tmp_path):
    cfg, state, step_fn = _state_and_step()
    state, _ = step_fn(state, _batch(cfg, 2))
    ckpt.save(str(tmp_path / "train"), 1, state)
    step, restored, _ = ckpt.restore(str(tmp_path / "train"))
    assert step == 1
    again = finetune.init_finetune_state(restored["params_g"], restored["rvq"],
                                         torch.device("cpu"), step=restored["step"],
                                         opt=restored["opt"])
    for tree in ("params_g", "opt", "rvq"):
        a, b = T.tree_leaves(state[tree]), T.tree_leaves(again[tree])
        assert len(a) == len(b)
        assert all(torch.equal(x, y) if isinstance(x, torch.Tensor) else x == y
                   for x, y in zip(a, b))
    # the inference part reads back through the public API's layout
    ckpt.save_inference(str(tmp_path / "art"), 1, state["params_g"], state["rvq"],
                        {"config": "tiny_test"})
    params2, rvq2 = ckpt.restore_inference(str(tmp_path / "art"))
    np.testing.assert_array_equal(rvq2["codebooks"], state["rvq"]["codebooks"].numpy())
    bundle = PA.load_model("tiny_test", checkpoint=str(tmp_path / "art"), device="cpu")
    assert PA.encode(bundle, np.zeros(8 * cfg.hop, np.float32)).shape == (8, cfg.num_quantizers)


def _artifact(tmp_path, data="synthetic"):
    cfg = get_config("tiny_test")
    params, rvq = W.init_jax_layout(cfg, 11)
    meta = {"config": "tiny_test"} if data is None else {"config": "tiny_test", "data": data}
    ckpt.save_inference(str(tmp_path / "art"), 3, W.to_tensors(params), W.to_tensors(rvq), meta)
    return str(tmp_path / "art"), params, rvq


def _patch_step(monkeypatch, delta):
    """A finetune step that adds `delta` to every decoder leaf."""
    def factory(model, tcfg):
        def step(state, batch):
            with torch.no_grad():
                for x in T.tree_leaves(state["params_g"]["decoder"]):
                    x.add_(delta)
            state["step"] += 1
            return state, {"loss/g_total": torch.tensor(0.0), "loss/mel": torch.tensor(0.0)}
        return step

    monkeypatch.setattr(finetune, "make_finetune_step", factory)


def test_finetune_keep_best_exports_best_heldout_decoder(tmp_path, monkeypatch):
    """Port of tests/unit/test_finetune.py::
    test_finetune_keep_best_exports_best_heldout_decoder: a step that adds
    0.02 to every decoder weight degrades the held-out mel, so the step-2
    eval beats step 4's and infer_best/2 holds the init + 0.04 decoder,
    which restore_inference prefers; the frozen halves ride along."""
    art, params, rvq = _artifact(tmp_path)
    _patch_step(monkeypatch, 0.02)
    wd = tmp_path / "wd"
    out, meta = finetune.run_finetune(art, workdir=str(wd), steps=4,
                                      tcfg=finetune.finetune_config(4, batch_size=2),
                                      eval_every=2, resume=False, device="cpu")
    assert meta["step"] == 3
    assert out["heldout/best_step"] == 2.0
    assert out["heldout/mel_best"] < out["heldout/mel_final"]
    assert ckpt.export_steps(str(wd / "infer_best")) == [2]
    assert ckpt.export_steps(str(wd / "infer")) == [4]
    params_b, rvq_b = ckpt.restore_inference(str(wd))
    for e, g in zip(jax.tree.leaves(params["decoder"]), jax.tree.leaves(params_b["decoder"])):
        np.testing.assert_allclose(g, np.float32(e) + np.float32(0.02) + np.float32(0.02),
                                   rtol=0, atol=1e-6)
    for e, g in zip(jax.tree.leaves(params["encoder"]), jax.tree.leaves(params_b["encoder"])):
        np.testing.assert_array_equal(g, e)
    np.testing.assert_array_equal(rvq_b["codebooks"], rvq["codebooks"])
    with open(wd / "metrics.jsonl") as f:
        held = [json.loads(line) for line in f if "heldout/mel" in line]
    assert [r["step"] for r in held] == [2, 4]


def test_finetune_removes_a_stale_infer_best(tmp_path, monkeypatch):
    """A second call of the same workdir whose final decoder is its best
    leaves no infer_best/ from the first call: the workdir then resolves to
    infer/'s final export."""
    art, params, _ = _artifact(tmp_path)
    wd = tmp_path / "wd"
    tcfg = finetune.finetune_config(6, batch_size=2)
    _patch_step(monkeypatch, 0.02)
    finetune.run_finetune(art, workdir=str(wd), steps=4, tcfg=tcfg, eval_every=2, device="cpu")
    assert ckpt.export_steps(str(wd / "infer_best")) == [2]
    _patch_step(monkeypatch, -0.01)  # now every step improves the held-out mel
    out, _ = finetune.run_finetune(art, workdir=str(wd), steps=6, tcfg=tcfg, eval_every=1,
                                   device="cpu")
    assert out["heldout/best_step"] == 6.0 and out["heldout/mel_best"] == out["heldout/mel_final"]
    assert not os.path.exists(wd / "infer_best")
    assert ckpt.resolve_export(str(wd)) == str(wd / "infer" / "6")
    params_f, _ = ckpt.restore_inference(str(wd))
    for e, g in zip(jax.tree.leaves(params["decoder"]), jax.tree.leaves(params_f["decoder"])):
        np.testing.assert_allclose(g, np.float32(e) + 0.08 - 0.02, rtol=0, atol=1e-6)


def test_finetune_data_spec_and_device(tmp_path, monkeypatch):
    """No spec and no meta.json `data` raises and names the field; the
    spec argument overrides it; device=None means CUDA and raises without
    it."""
    art, _, _ = _artifact(tmp_path, data=None)
    tcfg = finetune.finetune_config(1, batch_size=2)
    with pytest.raises(ValueError, match="'data'"):
        finetune.run_finetune(art, workdir=str(tmp_path / "wd"), steps=1, tcfg=tcfg, device="cpu")
    _patch_step(monkeypatch, 0.0)
    out, _ = finetune.run_finetune(art, workdir=str(tmp_path / "wd"), steps=1, tcfg=tcfg,
                                   data_spec="synthetic2:pool=4", device="cpu")
    assert np.isfinite(out["heldout/mel_final"])
    assert ckpt.export_meta(str(tmp_path / "wd"))["data"] == "synthetic2:pool=4"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        finetune.run_finetune(art, workdir=str(tmp_path / "wd2"), steps=1, tcfg=tcfg)
