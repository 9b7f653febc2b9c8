"""One rank of the port's data-parallel tests (`tests/test_torch_parallel.py`).

    RANK=r WORLD_SIZE=w MASTER_ADDR=localhost MASTER_PORT=p \
        python tests/torch_dp_worker.py SPEC.pt OUT_DIR

Joins a gloo group from the `env://` variables, reads the spec that the
test wrote (the training trees in the JAX layout, the train config, the
global batch, the global reseed picks, an inference batch and a workdir)
and writes `OUT_DIR/rank<r>.pt`:

  * step: one `make_parallel_train_step` step (of `step_config`) on this
    rank's rows, its
    metrics, the parameters and the RVQ state after it; with one rank, also
    the plain step from the same state (to be held bit for bit);
  * reseed: `sample_reseed_candidates` on this rank's part of a pool with
    the spec's global picks;
  * infer: `make_parallel_infer` encode and reconstruct of the global batch;
  * loop: `loop.run(..., distributed=True)` for 2 steps, a resume to 3
    and an uninterrupted 3-step run, and with a global batch that does not
    divide by the world size (which must raise);
  * the modules of JAX and of the JAX package that the process imported.

Imports torch and the port only.
"""

import copy
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(spec_path: str, out_dir: str) -> None:
    torch.set_num_threads(1)
    from nsc_tpu_torch import api, parallel, weights
    from nsc_tpu_torch.configs import TrainConfig, get_config
    from nsc_tpu_torch.ops import rvq as rvq_ops
    from nsc_tpu_torch.train import loop as L
    from nsc_tpu_torch.train import train as T

    spec = torch.load(spec_path, weights_only=False)
    mesh = parallel.make_mesh("cpu")
    cfg = get_config(spec["config"])
    tcfg = TrainConfig(**spec["tcfg"])
    out = {"rank": mesh.rank, "world": mesh.size}

    # one step of the data-parallel train step (on the spec's step_config)
    model = T.model_for(get_config(spec["step_config"]))
    state = T.state_from_trees(weights.train_state_from_jax(**spec["trees"]), "cpu")
    plain_state = copy.deepcopy(state) if mesh.size == 1 else None
    parallel.replicate(mesh, state)
    step = parallel.make_parallel_train_step(model, tcfg, mesh)
    picks = torch.from_numpy(spec["picks"])
    state, metrics = step(state, parallel.shard_batch(mesh, spec["batch"]), reseed_picks=picks)
    out["metrics"] = {k: float(v) for k, v in metrics.items()}
    out["state"] = weights.train_state_to_jax(state)
    if plain_state is not None:
        plain = T.make_train_step(model, tcfg)
        plain_state, plain_metrics = plain(plain_state, torch.from_numpy(spec["batch"]),
                                           reseed_picks=picks)
        out["plain_metrics"] = {k: float(v) for k, v in plain_metrics.items()}
        out["plain_state"] = weights.train_state_to_jax(plain_state)

    # a forced reseed: this rank's part of the pool, the global picks
    pool = torch.from_numpy(spec["pool"])
    part = pool[parallel.mesh.local_rows(mesh, pool.shape[0])]
    gp = torch.from_numpy(spec["pool_picks"])
    out["candidates"] = rvq_ops.sample_reseed_candidates(
        part, gp.shape[0], gp.shape[1], picks=gp, axis=mesh).numpy()

    # inference
    bundle = api.load_model(spec["config"], seed=0, device="cpu")
    for kind in ("encode", "reconstruct"):
        fn = parallel.make_parallel_infer(bundle.model, mesh, kind=kind)
        out[kind] = fn(bundle.params, bundle.rvq, torch.from_numpy(spec["wav"])).numpy()

    # the training loop's entry: 2 steps, then a batch that does not divide
    loop_cfg = TrainConfig(**{**spec["tcfg"], **spec["loop_tcfg"]})
    out["loop_metrics"] = L.run(cfg, loop_cfg, workdir=spec["workdir"], data_spec="synthetic",
                                steps=2, device="cpu", distributed=True)
    # a resume to step 3 against an uninterrupted 3-step run
    out["resumed_metrics"] = L.run(cfg, loop_cfg, workdir=spec["workdir"], data_spec="synthetic",
                                   steps=3, device="cpu", distributed=True)
    out["straight_metrics"] = L.run(cfg, loop_cfg, workdir=spec["workdir"] + "_straight",
                                    data_spec="synthetic", steps=3, device="cpu", distributed=True)
    try:
        L.run(cfg, TrainConfig(**{**spec["tcfg"], "batch_size": 2 * mesh.size + 1}),
              workdir=spec["workdir"] + "_uneven", steps=1, device="cpu", distributed=True)
        out["uneven"] = "ran"
    except ValueError as e:
        out["uneven"] = str(e)

    out["foreign_modules"] = sorted(
        m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "nsc_tpu"))
    torch.save(out, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
