"""The benchmark's FLOP counts against `torch.utils.flop_counter` on the
port's plain float32 path at a small size, and the bound functions at the
cells' shapes against the values the port's `chip_smoke.py` printed."""

import dataclasses
import json
import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.harness import bounds, flops, seeded, spec

SAMPLES = 3200  # 10 frames


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def _codec(name):
    from nsc_tpu_torch.configs import get_config

    cfg = get_config(name)
    return cfg, dataclasses.asdict(cfg)


@pytest.mark.parametrize("name", ["base_fast", "base_noncausal"])
def test_serve_count_matches_the_counter(name):
    from nsc_tpu_torch import weights
    from nsc_tpu_torch.models.codec import NeuralSpeechCodec

    torch.manual_seed(0)
    cfg, d = _codec(name)
    p, q = weights.from_jax_params(*weights.init_jax_layout(cfg, 0), cfg)
    model = NeuralSpeechCodec(cfg)
    x = torch.randn(2, SAMPLES) * 0.1
    assert _counted(lambda: model.reconstruct(p, q, x)) == flops.serve_flops(d, 2, SAMPLES)
    # 7.18 GFLOP an audio second on the plain path
    assert flops.serve_flops(d, 1, 16000) == pytest.approx(7.1839744e9)


@pytest.mark.parametrize("name", ["base_fast", "base_noncausal"])
def test_codec_training_count_matches_the_counter(name):
    from nsc_tpu_torch import weights
    from nsc_tpu_torch.models.codec import NeuralSpeechCodec
    from nsc_tpu_torch.ops import rvq as R

    cfg, d = _codec(name)
    params, rvq = weights.init_jax_layout(cfg, 0)
    tree = weights.tree_map(lambda t: t.requires_grad_(True), weights.to_tensors(params))
    leaves = []
    weights.tree_map(leaves.append, tree)
    state = R.init_rvq_train(torch.from_numpy(rvq["codebooks"]))
    model = NeuralSpeechCodec(cfg)
    x = torch.randn(2, SAMPLES) * 0.1

    def step():
        recon, fwd, _ = model.forward(tree, state, x)
        torch.autograd.grad(recon.sum() + fwd.commit_loss, leaves)

    frames = SAMPLES // 320
    want = 2 * (flops.fwd_bwd(flops.codec_convs(d, SAMPLES)) + flops.rvq_search_flops(d, frames))
    assert _counted(step) == want


def test_discriminator_counts_match_the_counter():
    from nsc_tpu_torch import weights
    from nsc_tpu_torch.models import discriminators as D

    params = D.init_discriminators(1)
    leaves = []
    weights.tree_map(lambda t: leaves.append(t.requires_grad_(True)), params)
    wav = (torch.randn(3, SAMPLES) * 0.1).requires_grad_(True)
    convs = flops.disc_convs(SAMPLES)
    assert _counted(lambda: D.apply_discriminators(params, wav)) == 3 * sum(c.flops for c in convs)

    def fwd_bwd():
        outs = D.apply_discriminators(params, wav)
        torch.autograd.grad(sum(o[0].sum() for o in outs), leaves + [wav])

    # the counter charges a grouped convolution's weight gradient `groups`
    # times its forward (it leaves the groups out of that product); the work
    # is one forward, as for an ungrouped layer
    extra, cin = 0.0, 1
    groups = []
    for cout, _, _, g in seeded.MSD_LAYERS:
        groups.append(math.gcd(g, cin))
        cin = cout
    for c in convs:
        if c.name.startswith("msd") and not c.name.endswith("out"):
            extra += (groups[int(c.name.split(".")[1])] - 1) * c.flops
    assert extra > 0
    assert _counted(fwd_bwd) == pytest.approx(3 * sum(3 * c.flops for c in convs) + 3 * extra,
                                              rel=1e-12)


def test_train_step_count_is_what_the_step_needs():
    with open(spec.BENCH_DIR / "configs" / "base_fast.json") as f:
        d = json.load(f)["codec"]
    convs = flops.disc_convs(16000)
    fwd = sum(c.flops for c in convs)
    codec = flops.fwd_bwd(flops.codec_convs(d, 16000)) + flops.rvq_search_flops(d, 50)
    want = 64 * codec + 2 * 64 * flops.fwd_bwd(convs) + 64 * fwd
    assert flops.train_step_flops(d, 64, 16000) == pytest.approx(want)
    assert flops.train_step_flops(d, 64, 16000) == pytest.approx(11.640072306688e12)


def test_bounds_at_the_cells_shapes():
    with open(spec.BENCH_DIR / "configs" / "base_fast.json") as f:
        c = json.load(f)
    d, t = c["codec"], c["training"]
    # chip_smoke.py's K1 bound of reconstruct at 64 x 10 s: 3.63 ms (operations)
    assert bounds.k1_bound_s(d, 64, 160000) * 1e3 == pytest.approx(3.632, abs=1e-3)
    # K4's shipped bank a step: 0.0445 ms (bytes)
    assert bounds.k4_step_bound_s(t, 64, 16000) * 1e3 == pytest.approx(0.04445, abs=1e-5)
    # K2 counted once: 2 M K D n_q at 989 TFLOP/s
    assert bounds.k2_bound_s(d, 32000) == pytest.approx(2 * 32000 * 1024 * 128 * 16 / 989e12)
    assert bounds.k2_bound_s(d, 3200) * 1e3 == pytest.approx(0.01357, abs=1e-5)
    names = [s[0] for s in bounds.stage_shapes(d, 160000)]
    assert names == [f"enc{i}" for i in range(4)] + [f"dec{i}" for i in range(4)]
    assert bounds.stage_shapes(d, 160000)[3] == ("enc3", 256, 4000)
    assert bounds.stage_shapes(d, 160000)[4] == ("dec0", 256, 4000)
