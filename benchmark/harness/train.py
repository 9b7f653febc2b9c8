"""Training: the port's GAN step (`train.train.make_train_step`) on batches of
its own data source through its `Prefetcher`, back to back.

Traffic file keys: "batch" rows of "segment_seconds" at "sample_rate" from
the port's data source "source" (seeded with the run's seed), a prefetch
queue of "prefetch_depth", "checked_steps" steps at set-up that the check
follows, "trace_steps" steps in a traced window (each with a device sync at
the step's `mark` points, for the generator's and the discriminators'
times).

Set-up builds one train state from the seed's weights, runs the checked
steps through the same call and feed as the window, and hands that state
to the window. It keeps each checked batch, the losses of each checked
step, the norm of each leaf's first gradient as the optimizer got it
(Adam's first moment after one step over 1 - b1) and the norm of each
leaf's change over the checked steps. The check runs the plain float32
reference (`benchmark.reference.train`) through the same steps from the
same weights and batches, once the program is freed, and compares:

  loss_gap         the wider relative gap of the first step's generator and
                   discriminator losses (the later steps' losses follow
                   Adam's first update, which moves each element by +-lr
                   whatever its gradient's size, so elements whose
                   gradients sit near zero take their sign from rounding);
  grad_norm_gap    the widest gap of a leaf's first-gradient norm, over the
                   reference's norm of that leaf or of the median leaf,
                   whichever is larger (generator and discriminators each
                   against their own median);
  change_norm_gap  the same of each leaf's change, the codebooks a leaf of
                   their own; leaves whose reference gradient is under a
                   thousandth of the median leaf's are left out (Adam moves
                   them by round-off alone).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import common, seeded
from benchmark.reference import codec as rc
from benchmark.reference import train as rt

TINY_GRAD = 1e-3  # leaves under this share of the median leaf's gradient


class Train:
    part = "training"

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.dev = cell, int(seed), torch.device(device)
        t = cell.traffic
        self.rows = t["batch"]
        self.samples = int(round(t["segment_seconds"] * t["sample_rate"]))
        self.codec = common.run_codec(cell.config, self.part)
        self.tcfg = dict(cell.config["training"])

    def setup(self) -> None:
        from nsc_tpu_torch import weights
        from nsc_tpu_torch.configs import TrainConfig
        from nsc_tpu_torch.train import data, train

        t = self.cell.traffic
        cfg = common.port_config(self.cell.config, self.part)
        fields = {k: tuple(v) if isinstance(v, list) else v for k, v in self.tcfg.items()}
        tcfg = TrainConfig(**fields, seed=self.seed)
        if (tcfg.batch_size, tcfg.segment_seconds) != (self.rows, t["segment_seconds"]):
            raise ValueError("traffic batch differs from the configuration's training batch")
        gen = seeded.generator(self.seed, self.dev)
        self.params_g, rvq = seeded.codec_weights(self.codec, gen, self.dev)
        self.codebooks = rvq["codebooks"]
        self.params_d = seeded.discriminator_weights(gen, self.dev, tcfg.mpd_periods, tcfg.msd_scales)
        trees = weights.train_state_from_jax(self.params_g, self.params_d, rvq)
        self.model = train.model_for(cfg)
        self.state = train.state_from_trees(trees, self.dev)
        self.step_fn = train.make_train_step(self.model, tcfg)
        source = data.make_source(t["source"], cfg.sample_rate, self.seed % 2**32)
        self.feed = data.Prefetcher(source.batches(self.rows, self.samples), depth=t["prefetch_depth"])
        self.b1 = tcfg.adam_b1
        self._checked_steps(t["checked_steps"])
        common.sync(self.dev)

    def _tensor(self, batch: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(batch)
        if self.dev.type == "cuda":
            x = x.pin_memory().to(self.dev, non_blocking=True)
        return x

    def _leaves(self):
        from nsc_tpu_torch.train import train

        s = self.state
        return (train.tree_leaves(s["params_g"]) + train.tree_leaves(s["params_d"])
                + [s["rvq"]["codebooks"]])

    def _checked_steps(self, n: int) -> None:
        from nsc_tpu_torch.train import train

        start = [x.detach().clone() for x in self._leaves()]
        self.batches, self.losses = [], []
        for k in range(n):
            batch = next(self.feed)
            self.batches.append(batch.copy())
            self.state, m = self.step_fn(self.state, self._tensor(batch))
            self.losses.append((m["loss/g_total"].item(), m["loss/d_total"].item()))
            if k == 0:
                mu = (train.tree_leaves(self.state["opt_g"]["mu"])
                      + train.tree_leaves(self.state["opt_d"]["mu"]))
                self.grad_norms = rt.norms([m_ / (1.0 - self.b1) for m_ in mu])
        self.change_norms = rt.norms([x.detach() - s for x, s in zip(self._leaves(), start)])
        del start

    def window(self, seconds: float, max_units=None, traced: bool = False) -> dict:
        marks = []

        def mark(name):
            common.sync(self.dev)
            marks[-1][name] = common.now()

        n = 0
        t0 = common.now()
        while True:
            x = self._tensor(next(self.feed))
            if traced:
                common.sync(self.dev)
                marks.append({"start": common.now()})
                self.state, _ = self.step_fn(self.state, x, mark=mark)
            else:
                self.state, _ = self.step_fn(self.state, x)
            n += 1
            if (max_units is not None and n >= max_units) or (
                    max_units is None and common.now() - t0 >= seconds):
                break
        common.sync(self.dev)
        wall = common.now() - t0
        audio_s = n * self.rows * self.samples / self.cell.traffic["sample_rate"]
        return {"wall_s": wall, "units": n, "attempted": n, "failed": 0, "marks": marks,
                "metrics": {"train_audio_s_per_s": audio_s / wall}}

    def trace_units(self) -> int:
        return self.cell.traffic["trace_steps"]

    def release(self) -> None:
        self.feed.close()
        del self.state, self.step_fn, self.model
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- check -------------------------------------------------------------

    def reference(self, precision: str = "float32", batch_fraction: float = 1.0,
                  tf32: bool = False) -> dict:
        """The reference through the checked steps: its losses, first
        gradient norms and change norms."""
        tcfg = {**self.tcfg, "sample_rate": self.codec["sample_rate"]}
        with common.tf32(tf32):
            tr = rt.Trainer({**self.codec}, tcfg, self.params_g, self.params_d, self.codebooks,
                            self.seed, rc.Numerics(precision), batch_fraction)
            start = [x.detach().clone() for x in rt.leaves(tr.g) + rt.leaves(tr.d)] + [tr.books.clone()]
            losses = []
            for k, batch in enumerate(self.batches):
                out = tr.train_step(torch.from_numpy(batch).to(self.dev))
                losses.append((out["g_total"], out["d_total"]))
                if k == 0:
                    grads = rt.norms(out["g_grads"] + out["d_grads"])
                del out
            end = rt.leaves(tr.g) + rt.leaves(tr.d) + [tr.books]
            change = rt.norms([e.detach() - s for e, s in zip(end, start)])
        n_g = len(rt.leaves(tr.g))
        return {"losses": losses, "grad_norms": grads, "change_norms": change, "n_g": n_g}

    def compare(self, prog: dict, ref: dict) -> dict:
        n_g, g = ref["n_g"], ref["grad_norms"]
        loss = max(rt.rel(p, r) for p, r in zip(prog["losses"][0], ref["losses"][0]))
        parts = [(0, n_g), (n_g, len(g))]
        grad = max(rt.worst_leaf_gap(prog["grad_norms"][a:b], g[a:b]) for a, b in parts)
        change = 0.0
        for a, b in parts:
            med = rt.median(g[a:b])
            keep = [i for i in range(b - a) if g[a + i] >= TINY_GRAD * med]
            change = max(change, rt.worst_leaf_gap(prog["change_norms"][a:b], ref["change_norms"][a:b], keep))
        cb = len(ref["change_norms"]) - 1
        change = max(change, rt.worst_leaf_gap([prog["change_norms"][cb]], [ref["change_norms"][cb]]))
        return {"loss_gap": loss, "grad_norm_gap": grad, "change_norm_gap": change}

    def program(self) -> dict:
        return {"losses": self.losses, "grad_norms": self.grad_norms,
                "change_norms": self.change_norms}

    def check(self) -> dict:
        self.ref = self.reference()
        return self.compare(self.program(), self.ref)

    def control(self) -> dict:
        """The reference with TF32 on (the precision below float32 with TF32
        off), put in the program's place."""
        ref = getattr(self, "ref", None) or self.reference()
        return self.compare(self.reference(tf32=True), ref)

    def faults(self) -> dict:
        """Half of the batch left out, the mean over the rest, planted in the
        reference put in the program's place (a state left unchanged reads
        1 on change_norm_gap and needs no run)."""
        ref = getattr(self, "ref", None) or self.reference()
        return {"half_batch": self.compare(self.reference(batch_fraction=0.5), ref)}

