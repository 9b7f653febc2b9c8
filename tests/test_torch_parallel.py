"""The port's data parallelism (`nsc_tpu_torch/parallel`) against one
process and against the JAX package's data-parallel step.

Two gloo processes (`tests/torch_dp_worker.py`) run one step of
`make_parallel_train_step` on `small` (global batch 4 x 0.2 s, no GAN,
quantizer dropout 0) from the same weights and batch as:

  * the port's one-process step on the global batch, and
  * nsc_tpu's `make_parallel_train_step` over a 2-device mesh,

with the tolerances of the JAX package's own DP test
(`tests/integration/test_training.py::test_dp_step_equals_single_device`):
metrics rtol 2e-3 / atol 2e-4; parameters rtol 0.2 / atol 4 x lr (Adam
turns noise-level sign flips of a gradient into +-lr steps); codebooks
rtol 1e-4 / atol 1e-5 (EMA statistics, no optimizer). The reseed picks are
nsc_tpu's own global draws, given to every step. The two ranks' states must
be bit-identical, and a one-rank group must be the plain step bit for bit.
The ranks also run a forced reseed with fixed global picks (bit-exact
against the one-process gather), data-parallel `encode` (bit-exact) and
`reconstruct` (rtol 1e-5 / atol 1e-6, the JAX package's
`test_dp_inference_equals_single_device`), the training loop's
`--distributed` path (a resume continues every rank's stream: its last
metrics equal an uninterrupted run's bit for bit) and its refusal of a
batch that does not divide, on `tiny_test`.

The step runs on `small`, not `tiny_test`: on `tiny_test` the gradient
norm is float32 noise (its 16-code books give a reconstruction whose STFT
bins sit at the log floor, `tests/test_torch_train.py`), and the one-device
steps of the two packages already differ by 6.6% there (70.46 against
75.13), where on `small` they agree to 1e-6.
"""

import json
import os
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nsc_tpu.configs import TrainConfig as JTrainConfig
from nsc_tpu.configs import get_config as jget_config
from nsc_tpu.models.codec import NeuralSpeechCodec
from nsc_tpu.parallel import make_mesh, make_parallel_train_step, replicate, shard_batch
from nsc_tpu.train import data as jdata
from nsc_tpu.train import train as JT
from nsc_tpu_torch import api
from nsc_tpu_torch import weights as W
from nsc_tpu_torch.configs import TrainConfig, get_config
from nsc_tpu_torch.models import discriminators as D
from nsc_tpu_torch.ops import rvq as rvq_ops
from nsc_tpu_torch.train import train as T
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")
CONFIG, SMALL = "tiny_test", "small"
TCFG = dict(
    batch_size=4, segment_seconds=0.2, lr_g=1e-3, lr_d=1e-3, disc_width_mult=1 / 16,
    quantizer_dropout=0.0, stft_fft_sizes=(256, 128), mel_fft_size=256, mel_bins=20,
    use_gan=False, log_every=1, checkpoint_every=1000,
)
METRIC_TOL = dict(rtol=2e-3, atol=2e-4)
CODEBOOK_TOL = dict(rtol=1e-4, atol=1e-5)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(spec_path: str, out_dir: str, world: int) -> list:
    """`world` worker processes of one gloo group; their outputs."""
    env = {**os.environ, "MASTER_ADDR": "localhost", "MASTER_PORT": str(_free_port()),
           "WORLD_SIZE": str(world), "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, WORKER, spec_path, out_dir],
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(world)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} of {world} failed:\n{logs[r][-4000:]}"
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    cfg = jget_config(SMALL)
    jt = JTrainConfig(**TCFG)
    # the same weights on every side: seeded in the JAX layout, codebooks
    # at the latents' scale (tests/test_torch_train.py)
    params_g, rvq0 = W.init_jax_layout(get_config(SMALL), 0)
    params_d = W.to_numpy(D.init_discriminators(1, jt.disc_width_mult))
    seg = int(TCFG["segment_seconds"] * cfg.sample_rate) // cfg.hop * cfg.hop
    batch = next(jdata.SyntheticSource(cfg.sample_rate, 0).batches(4, seg))
    jmodel = NeuralSpeechCodec(cfg)
    z = np.asarray(jax.jit(jmodel.latents)(jax.tree.map(jnp.asarray, params_g), jnp.asarray(batch)))
    cb = (np.random.RandomState(5).randn(*rvq0["codebooks"].shape) * z.std()).astype(np.float32)
    rvq = {"codebooks": cb, "ema_count": np.zeros(cb.shape[:2], np.float32), "ema_sum": cb}
    trees = {"params_g": params_g, "params_d": params_d, "rvq": rvq}

    # nsc_tpu over a 2-device mesh, and its global reseed draws
    opt_g, opt_d = JT.make_optimizers(jt)
    jp = jax.tree.map(jnp.asarray, trees)
    state = {"step": jnp.zeros((), jnp.int32), **jp, "opt_g": opt_g.init(jp["params_g"]),
             "opt_d": opt_d.init(jp["params_d"]), "rng": jax.random.PRNGKey(0)}
    k_reseed, _ = jax.random.split(jax.random.fold_in(state["rng"], 0))
    m_local = 2 * (seg // cfg.hop)
    picks = np.asarray(jax.random.randint(
        k_reseed, (cfg.num_quantizers, cfg.codebook_size), 0, 2 * m_local))
    mesh = make_mesh(jax.devices()[:2])
    jnew, jmetrics = make_parallel_train_step(jmodel, jt, mesh)(
        replicate(mesh, state), shard_batch(mesh, batch))
    jax_ref = {"metrics": {k: float(v) for k, v in jmetrics.items()},
               "params_g": jax.tree.map(np.asarray, jnew["params_g"]),
               "rvq": jax.tree.map(np.asarray, jnew["rvq"])}

    # the port, one process, global batch
    tcfg = TrainConfig(**TCFG)
    pstate = T.state_from_trees(W.train_state_from_jax(**trees), "cpu")
    pstate, pmetrics = T.make_train_step(T.model_for(get_config(SMALL)), tcfg)(
        pstate, torch.from_numpy(batch), reseed_picks=torch.from_numpy(picks))
    one = {"metrics": {k: float(v) for k, v in pmetrics.items()},
           **W.train_state_to_jax(pstate)}

    rng = np.random.RandomState(3)
    pool = rng.randn(2 * 50, cfg.codebook_dim).astype(np.float32)
    wav = (rng.randn(4, 16 * get_config(CONFIG).hop) * 0.2).astype(np.float32)
    tmp = tmp_path_factory.mktemp("dp")
    out = {}
    for world in (1, 2):
        spec = {"step_config": SMALL, "config": CONFIG, "tcfg": TCFG, "trees": trees, "batch": batch,
                "picks": picks, "pool": pool,
                "pool_picks": rng.randint(0, pool.shape[0], (cfg.num_quantizers, 7)),
                "wav": wav, "workdir": str(tmp / f"loop{world}"),
                "loop_tcfg": {"checkpoint_every": 1, "full_state_every": 1,
                              "segment_seconds": 0.064}}
        path = str(tmp / f"spec{world}.pt")
        torch.save(spec, path)
        out[world] = _launch(path, str(tmp), world)
        out[f"spec{world}"] = spec
        for r in range(world):
            os.remove(tmp / f"rank{r}.pt")
    return {"jax": jax_ref, "one": one, "ranks": out[2], "single": out[1][0],
            "spec": out["spec2"], "tcfg": tcfg, "tmp": tmp}


def _close_steps(got, ref, tcfg, what, skip=()):
    assert set(got["metrics"]) == set(ref["metrics"]), what
    for k, v in ref["metrics"].items():
        if k in skip:
            continue
        np.testing.assert_allclose(got["metrics"][k], v, **METRIC_TOL,
                                   err_msg=f"{what}: metric {k}")
    for a, b in zip(jax.tree.leaves(got["params_g"]), jax.tree.leaves(ref["params_g"])):
        np.testing.assert_allclose(a, b, rtol=0.2, atol=4 * tcfg.lr_g, err_msg=f"{what}: params")
    np.testing.assert_allclose(got["rvq"]["codebooks"], ref["rvq"]["codebooks"],
                               **CODEBOOK_TOL, err_msg=f"{what}: codebooks")


def test_two_ranks_match_one_process_step(dp):
    got = {"metrics": dp["ranks"][0]["metrics"], **dp["ranks"][0]["state"]}
    _close_steps(got, dp["one"], dp["tcfg"], "2 ranks vs one process")


def test_two_ranks_match_nsc_tpu_dp_step(dp):
    """Every metric but rvq/usage: nsc_tpu takes each replica's usage from
    its own counts and averages it (so it moves with the world size); the
    port takes it from the summed counts, the global batch's, which the
    previous test holds to one process."""
    got = {"metrics": dp["ranks"][0]["metrics"], **dp["ranks"][0]["state"]}
    _close_steps(got, dp["jax"], dp["tcfg"], "2 ranks vs nsc_tpu's 2-device step",
                 skip=("rvq/usage",))
    assert got["metrics"]["rvq/usage"] == dp["one"]["metrics"]["rvq/usage"]


def test_ranks_stay_bit_identical(dp):
    a, b = dp["ranks"]
    assert a["metrics"] == b["metrics"]
    for part in ("params_g", "params_d", "rvq", "opt_g", "opt_d"):
        la, lb = jax.tree.leaves(a["state"][part]), jax.tree.leaves(b["state"][part])
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(x, y, err_msg=part)


def test_one_rank_group_is_the_plain_step_bit_for_bit(dp):
    s = dp["single"]
    assert s["world"] == 1
    assert s["metrics"] == s["plain_metrics"]
    for part in ("params_g", "params_d", "rvq", "opt_g", "opt_d"):
        for x, y in zip(jax.tree.leaves(s["state"][part]), jax.tree.leaves(s["plain_state"][part])):
            np.testing.assert_array_equal(x, y, err_msg=part)


def test_forced_reseed_with_global_picks(dp):
    spec = dp["spec"]
    want = rvq_ops.sample_reseed_candidates(
        torch.from_numpy(spec["pool"]), *spec["pool_picks"].shape,
        picks=torch.from_numpy(spec["pool_picks"])).numpy()
    for r in dp["ranks"]:
        np.testing.assert_array_equal(r["candidates"], want)
    # and through the EMA fold: every code dead, every code reseeded
    cb = torch.zeros(want.shape)
    state = {"codebooks": cb, "ema_count": torch.zeros(want.shape[:2]), "ema_sum": cb}
    new, frac = rvq_ops.ema_update(state, torch.zeros(want.shape[:2]), torch.zeros(want.shape),
                                   reseed_candidates=torch.from_numpy(dp["ranks"][1]["candidates"]))
    assert float(frac) == 1.0
    np.testing.assert_array_equal(new["codebooks"].numpy(), want)


def test_parallel_inference_equals_one_process(dp):
    b = api.load_model(CONFIG, seed=0, device="cpu")
    wav = torch.from_numpy(dp["spec"]["wav"])
    with torch.inference_mode():
        idx = b.model.encode(b.params, b.rvq, wav).numpy()
        rec = b.model.reconstruct(b.params, b.rvq, wav).numpy()
    for r in dp["ranks"]:
        np.testing.assert_array_equal(r["encode"], idx)
        np.testing.assert_allclose(r["reconstruct"], rec, rtol=1e-5, atol=1e-6)


def test_distributed_loop_writes_once_and_keeps_every_stream(dp):
    from nsc_tpu_torch.train import checkpoint as ckpt

    workdir = dp["spec"]["workdir"]
    rows = open(os.path.join(workdir, "metrics.jsonl")).read().splitlines()
    assert [json.loads(r)["step"] for r in rows] == [1, 2, 3]  # rank 0 alone writes
    assert dp["ranks"][0]["loop_metrics"] == dp["ranks"][1]["loop_metrics"]
    step, _, data = ckpt.restore(os.path.join(workdir, "train"))
    assert step == 3 and data["world"] == 2 and len(data["ranks"]) == 2
    assert pickle.dumps(data["ranks"][0]) != pickle.dumps(data["ranks"][1])  # seed + 1009 x rank
    assert sorted(os.listdir(os.path.join(workdir, "infer"))) == ["1", "2", "3"]


def test_distributed_resume_continues_every_rank_stream(dp):
    for r in dp["ranks"]:
        assert r["resumed_metrics"] == r["straight_metrics"]


def test_distributed_loop_refuses_an_uneven_batch(dp):
    for r in dp["ranks"]:
        assert "not divisible by 2" in r["uneven"], r["uneven"]


def test_workers_import_no_jax(dp):
    for r in [*dp["ranks"], dp["single"]]:
        assert r["foreign_modules"] == [], r["foreign_modules"]


def test_rank_data_state_across_world_sizes(capsys):
    from nsc_tpu_torch.train.loop import rank_data_state

    saved = {"world": 2, "ranks": [{"a": 0}, {"a": 1}]}
    assert rank_data_state(saved, 1, 2) == {"a": 1}
    assert rank_data_state({"a": 5}, 0, 1) == {"a": 5}
    assert rank_data_state(saved, 0, 4) is None
    assert "starts from its seed" in capsys.readouterr().out
    assert rank_data_state(None, 0, 1) is None
