"""The port's training path against the JAX package's: the LR schedule and
the clipped Adam against optax, the data sources, one full GAN train step
from the same weights (with JAX's own depth and reseed draws passed in),
and the entry point on the CPU with a bit-exact resume.

Tolerances of the train step (float32 sums in other orders, through a
codec, an RVQ, spectral losses and discriminators):
  * every metric at rtol 1e-4;
  * gradients per leaf within 1e-3 * max|g| of the leaf; compared as the
    first Adam moment after the step, which is (1 - b1) times the clipped
    gradient (the clip scale comes from `grad/g_norm`, compared above);
  * parameters after the step within 1e-6 where the JAX gradient is at
    least max(1e-3 * max|g| of the leaf, 1e-6); elsewhere within 2 * lr.
    Adam's first step is lr * g / (|g| + 1e-8): below the gradient
    tolerance the two gradients may differ in sign, and at Adam's eps scale
    (|g| ~ 1e-8) a 1e-9 difference in g moves the step by a good fraction
    of lr;
  * RVQ state after the step at rtol 1e-5.

The step runs on `small` from seeded weights in the JAX layout, given to
both packages, with random codebooks at the latents' scale. Not from `tiny_test`, and not from N(0, 1)
codebooks: there every frame takes one code, the decoder's output repeats
with the hop, and most STFT bins of the reconstruction sit at the
sqrt(1e-8) floor, where the log-magnitude gradients are float32 rounding
noise (the port's own encoder gradients move by 25% between 1 and 8 CPU
threads there). On `small` they move by 3e-4 of their leaf's maximum.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nsc_tpu.configs import TrainConfig as JTrainConfig
from nsc_tpu.configs import get_config as jget_config
from nsc_tpu.models.codec import NeuralSpeechCodec
from nsc_tpu.train import data as jdata
from nsc_tpu.train import train as JT
from nsc_tpu_torch import weights as W
from nsc_tpu_torch.configs import TrainConfig, get_config
from nsc_tpu_torch.models import discriminators as D
from nsc_tpu_torch.train import checkpoint as ckpt
from nsc_tpu_torch.train import data as data_lib
from nsc_tpu_torch.train import loop as L
from nsc_tpu_torch.train import train as T

_SMALL = dict(
    batch_size=4, segment_seconds=0.2, lr_g=1e-3, lr_d=1e-3,
    disc_width_mult=1 / 16, stft_fft_sizes=(512, 256, 128), mel_fft_size=512,
    mel_bins=40, quantizer_dropout=0.5,
)


# ---------------------------------------------------------------------------
# schedule and optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warmup,decay", [(0, 0), (10, 0), (10, 100), (0, 50), (1, 3)])
def test_lr_schedule_matches_optax(warmup, decay):
    kw = dict(warmup_steps=warmup, lr_decay_steps=decay, lr_end_factor=0.01)
    ref = JT.make_lr_schedule(3e-4, JTrainConfig(**kw))
    got = T.make_lr_schedule(3e-4, TrainConfig(**kw))
    for step in (0, 1, 2, 5, 9, 10, 11, 30, 49, 50, 51, 99, 100, 101, 500):
        np.testing.assert_allclose(got(step), float(ref(step)), rtol=1e-6, atol=1e-12)
    if warmup:
        assert got(0) == 0.0  # optax evaluates the schedule before its count moves


@pytest.mark.parametrize("scale", [1e-3, 10.0])
def test_clipped_adam_matches_optax(scale):
    """Three steps with a warmup schedule; scale 10 clips every step, 1e-3
    none."""
    tcfg = TrainConfig(warmup_steps=2, lr_decay_steps=10, grad_clip=1.0)
    rng = np.random.RandomState(0)
    params = {"a": rng.randn(3, 4).astype(np.float32), "b": [rng.randn(5).astype(np.float32)]}
    grads = [{"a": (rng.randn(3, 4) * scale).astype(np.float32),
              "b": [(rng.randn(5) * scale).astype(np.float32)]} for _ in range(3)]
    opt = optax.chain(
        optax.clip_by_global_norm(1.0),
        optax.adam(JT.make_lr_schedule(3e-4, JTrainConfig(warmup_steps=2, lr_decay_steps=10)),
                   b1=tcfg.adam_b1, b2=tcfg.adam_b2),
    )
    jp = jax.tree.map(jnp.asarray, params)
    js = opt.init(jp)
    tp = W.to_tensors(params)
    ts = T.init_adam(tp)
    for g in grads:
        u, js = opt.update(jax.tree.map(jnp.asarray, g), js, jp)
        jp = optax.apply_updates(jp, u)
        T.clip_adam_update(tp, T.tree_leaves(W.to_tensors(g)), ts, tcfg,
                           T.make_lr_schedule(3e-4, tcfg))
    for got, ref in zip(T.tree_leaves(tp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-9)
    assert ts["count"] == 3


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("spec", ["synthetic", "synthetic2"])
def test_sources_bit_identical_and_resumable(spec):
    ref = jdata.make_source(spec, 16000, 3).batches(3, 1000)
    src = data_lib.make_source(spec, 16000, 3)
    got = src.batches(3, 1000)
    np.testing.assert_array_equal(next(got), next(ref))
    st = src.get_state()
    b2 = next(got)
    np.testing.assert_array_equal(b2, next(ref))
    other = data_lib.make_source(spec, 16000, 99)
    other.set_state(st)
    np.testing.assert_array_equal(next(other.batches(3, 1000)), b2)
    with pytest.raises(FileNotFoundError):
        data_lib.make_source("/some/wav/dir", 16000)


# ---------------------------------------------------------------------------
# one GAN train step against the JAX package
# ---------------------------------------------------------------------------


def _find_adam(opt_state):
    """The ScaleByAdamState inside an optax chain's state."""
    for leaf in jax.tree.leaves(opt_state, is_leaf=lambda x: hasattr(x, "mu")):
        if hasattr(leaf, "mu"):
            return leaf
    raise AssertionError("no Adam state")


@pytest.fixture(scope="module")
def one_step():
    cfg = jget_config("small")
    jt = JTrainConfig(**_SMALL)
    # the same initial weights on both sides: seeded, in the JAX layout (the
    # JAX package's own eager init costs tens of seconds on the CPU)
    params_g, rvq0 = W.init_jax_layout(get_config("small"), 0)
    params_d = W.to_numpy(D.init_discriminators(1, jt.disc_width_mult))
    opt_g, opt_d = JT.make_optimizers(jt)
    params_g, params_d = (jax.tree.map(jnp.asarray, t) for t in (params_g, params_d))
    state = {
        "step": jnp.zeros((), jnp.int32), "params_g": params_g, "params_d": params_d,
        "opt_g": opt_g.init(params_g), "opt_d": opt_d.init(params_d),
        "rvq": jax.tree.map(jnp.asarray, rvq0), "rng": jax.random.PRNGKey(0),
    }
    frames = 10
    batch = next(jdata.SyntheticSource(16000, 0).batches(4, frames * cfg.hop))
    # random codebooks at the latents' scale (see the module docstring)
    jmodel = NeuralSpeechCodec(cfg)
    z = np.asarray(jax.jit(jmodel.latents)(state["params_g"], jnp.asarray(batch)))
    cb = np.random.RandomState(5).randn(*state["rvq"]["codebooks"].shape) * z.std()
    cb = jnp.asarray(cb.astype(np.float32))
    state["rvq"] = {"codebooks": cb, "ema_count": jnp.zeros(cb.shape[:2]), "ema_sum": cb}
    base = jax.random.fold_in(state["rng"], 0)
    k_reseed, k_local = jax.random.split(base)
    depth = np.asarray(JT._sample_depths(k_local, 4, cfg.num_quantizers, jt.quantizer_dropout))
    picks = np.asarray(jax.random.randint(k_reseed, (cfg.num_quantizers, cfg.codebook_size),
                                          0, 4 * frames))
    init = jax.tree.map(np.array, {k: state[k] for k in ("params_g", "params_d", "rvq")})
    step = jax.jit(JT.make_train_step(jmodel, jt))
    new, metrics = step(state, jnp.asarray(batch))
    ref = {
        "metrics": {k: float(v) for k, v in metrics.items()},
        "params_g": jax.tree.map(np.asarray, new["params_g"]),
        "params_d": jax.tree.map(np.asarray, new["params_d"]),
        "rvq": jax.tree.map(np.asarray, new["rvq"]),
        "mu_g": jax.tree.map(np.asarray, _find_adam(new["opt_g"]).mu),
        "mu_d": jax.tree.map(np.asarray, _find_adam(new["opt_d"]).mu),
    }

    tcfg = TrainConfig(**_SMALL)
    pstate = T.state_from_trees(W.train_state_from_jax(**init), "cpu")
    pstep = T.make_train_step(T.model_for(get_config("small")), tcfg)
    pstate, pmetrics = pstep(pstate, torch.from_numpy(batch), depth=torch.from_numpy(depth),
                             reseed_picks=torch.from_numpy(picks.copy()))
    got = W.train_state_to_jax(pstate)
    got["metrics"] = {k: float(v) for k, v in pmetrics.items()}
    got["depth"] = depth
    return ref, got, tcfg


def test_train_step_metrics_match_jax(one_step):
    ref, got, _ = one_step
    assert set(got["metrics"]) == set(ref["metrics"])
    assert 0 < got["depth"].min() and (got["depth"] < 2).any()  # some dropout this step
    for k, v in ref["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-4, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("part", ["g", "d"])
def test_train_step_gradients_match_jax(one_step, part):
    ref, got, _ = one_step
    r_leaves, r_def = jax.tree.flatten(ref[f"mu_{part}"])
    g_leaves, g_def = jax.tree.flatten(got[f"opt_{part}"]["mu"])
    assert r_def == g_def
    for g, r in zip(g_leaves, r_leaves):
        np.testing.assert_allclose(g, r, rtol=0, atol=1e-3 * np.abs(r).max())


@pytest.mark.parametrize("part", ["g", "d"])
def test_train_step_parameters_match_jax(one_step, part):
    ref, got, tcfg = one_step
    lr = tcfg.lr_g if part == "g" else tcfg.lr_d
    new_r = jax.tree.leaves(ref[f"params_{part}"])
    new_g = jax.tree.leaves(got[f"params_{part}"])
    mus = jax.tree.leaves(ref[f"mu_{part}"])
    assert len(new_r) == len(new_g) == len(mus)
    for g, r, mu in zip(new_g, new_r, mus):
        grad = np.abs(mu) / (1 - tcfg.adam_b1)
        small = grad < max(1e-3 * grad.max(), 1e-6)
        diff = np.abs(g - r)
        assert diff[~small].max(initial=0) <= 1e-6
        assert diff[small].max(initial=0) <= 2 * lr


def test_train_step_rvq_state_matches_jax(one_step):
    ref, got, _ = one_step
    for k in ("codebooks", "ema_count", "ema_sum"):
        np.testing.assert_allclose(got["rvq"][k], ref["rvq"][k], rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

_CLI = ["--config", "tiny_test", "--device", "cpu", "--batch-size", "2",
        "--segment-seconds", "0.128", "--warmup-steps", "1", "--lr-decay-steps", "10"]


def _rows(workdir):
    with open(workdir / "metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    for r in rows:
        r.pop("steps_per_sec")
    return rows


def test_entry_point_resume_is_bit_exact(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    assert L.main(_CLI + ["--steps", "2", "--workdir", str(a)]) == 0
    assert ckpt.latest_step(str(a / "train")) == 2
    assert L.main(_CLI + ["--steps", "3", "--workdir", str(a)]) == 0
    assert L.main(_CLI + ["--steps", "3", "--workdir", str(b)]) == 0
    sa, ta, da = ckpt.restore(str(a / "train"))
    sb, tb, db = ckpt.restore(str(b / "train"))
    assert sa == sb == 3
    la = T.tree_leaves({k: ta[k] for k in ("params_g", "params_d", "rvq")})
    lb = T.tree_leaves({k: tb[k] for k in ("params_g", "params_d", "rvq")})
    assert len(la) == len(lb) > 50
    assert all(torch.equal(x, y) for x, y in zip(la, lb))
    for name in ("opt_g", "opt_d"):
        assert ta[name]["count"] == tb[name]["count"] == 3
        assert all(torch.equal(x, y) for x, y in zip(
            T.tree_leaves(ta[name]["mu"]), T.tree_leaves(tb[name]["mu"])))
    assert torch.equal(da["keys"], db["keys"]) and da["pos"] == db["pos"]
    ra, rb = _rows(a), _rows(b)
    assert [r["step"] for r in ra] == [2, 3] and [r["step"] for r in rb] == [3]
    assert ra[-1] == rb[-1]
    assert all(np.isfinite(v) for v in rb[-1].values())


def test_entry_point_without_cuda_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        L.main(["--config", "tiny_test", "--steps", "1", "--workdir", str(tmp_path)])
    assert not (tmp_path / "metrics.jsonl").exists()


def test_train_step_turns_tf32_off_and_restores_it():
    """The step computes in float32 whatever the caller's TF32 settings
    (PyTorch allows TF32 convolutions by default) and puts them back."""
    tcfg = dataclasses.replace(TrainConfig(), **_SMALL)
    cfg = get_config("tiny_test")
    model, state = T.init_train_state(cfg, tcfg, torch.device("cpu"))
    batch = torch.from_numpy(next(data_lib.make_source("synthetic", cfg.sample_rate, 0)
                                  .batches(2, L.segment_length(cfg, 0.2))))
    flags = lambda: (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)
    saved = flags()
    seen = []
    try:
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
        T.make_train_step(model, tcfg)(state, batch, mark=lambda _: seen.append(flags()))
        after = flags()
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    assert seen == [(False, False)] * 3
    assert after == (True, True)


def test_train_config_matches_jax():
    assert dataclasses.asdict(TrainConfig()) == dataclasses.asdict(JTrainConfig())
