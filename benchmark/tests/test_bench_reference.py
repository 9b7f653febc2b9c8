"""The plain reference against the port's plain float32 path at a small
size on the CPU, on the benchmark's own seeded weights, and a whole run of
each kind of cell driven on the CPU at a tiny size."""

import dataclasses
import time

import numpy as np
import pytest
import torch

from benchmark.harness import common, runner, seeded
from benchmark.reference import codec as rc
from benchmark.tests import bench_cells


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(saved)


@pytest.mark.parametrize("name", ["base_fast", "base_noncausal", "tiny_test"])
def test_codec_matches_the_port(name):
    from nsc_tpu_torch import api
    from nsc_tpu_torch.configs import get_config
    from nsc_tpu_torch.kernels import rvq as KR

    cfg = get_config(name)
    d = dataclasses.asdict(cfg)
    gen = seeded.generator(5, "cpu")
    params, rvq = seeded.codec_weights(d, gen, "cpu")
    bundle = api.bundle_from_jax(cfg, params, rvq, device="cpu")
    x = torch.randn(2, 20 * cfg.hop, generator=torch.Generator().manual_seed(1)) * 0.1
    with torch.no_grad():
        z_port = bundle.model.latents(bundle.params, x)
        z_ref = rc.encode_latents(params, x, d)
        assert torch.allclose(z_ref, z_port, rtol=1e-4, atol=1e-5 * z_ref.abs().max())
        books = rvq["codebooks"]
        idx_ref = rc.quantize(books, z_ref.reshape(-1, z_ref.shape[-1]))
        idx_port = KR.quantize_plain(books, z_ref.reshape(-1, z_ref.shape[-1]).contiguous())
        assert torch.equal(idx_ref.int(), idx_port)
        idx = idx_ref.reshape(2, -1, books.shape[0])
        wav_port = bundle.model.decode(bundle.params, bundle.rvq, idx.int())
        zq = rc.dequantize(books, idx.reshape(-1, books.shape[0])).reshape(2, -1, books.shape[-1])
        wav_ref = rc.decode_latents(params, zq, d)
        assert torch.allclose(wav_ref, wav_port, rtol=1e-4, atol=1e-5)
        # the gaps of the reference's own choice are 0
        gaps = rc.index_gaps(books, z_ref.reshape(-1, z_ref.shape[-1]), idx_ref)
        assert max(g.max().item() for g in gaps) == 0.0


def test_data_codebooks_sit_among_the_latents():
    d = bench_cells.tiny_config()["codec"]
    gen = seeded.generator(3, "cpu")
    params, rvq = seeded.codec_weights(d, gen, "cpu")
    books = rvq["codebooks"]
    assert books.shape == (d["num_quantizers"], d["codebook_size"], d["codebook_dim"])
    x = torch.randn(4, 64 * 4) * 0.1
    z = rc.encode_latents(params, x, d).reshape(-1, d["latent_dim"])
    assert books[0].norm(dim=-1).mean() < 3 * z.norm(dim=-1).mean()
    # the same seed makes the same weights
    again = seeded.codec_weights(d, seeded.generator(3, "cpu"), "cpu")[1]["codebooks"]
    assert torch.equal(books, again)


def _limits(names):
    # tiny_test's 4 channels and 16 codes are not the cells' shapes: these
    # runs test the path, the cells' limits hold the numbers
    return {k: {"limit": 4.0} for k in names}


def test_offline_run_on_the_cpu():
    c = bench_cells.cell("offline", {"batch": 4, "clip_seconds": 0.2, "pool_batches": 2,
                                     "warm_batches": 1, "kept_batches": 2},
                         _limits(["rvq_gap", "wav_err"]))
    r = runner.run(c, 2**31 + 7, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert r["correct"] and r["attempted"] >= 4 and r["failed"] == 0
    assert set(r["metrics"]) == {"serve_rtf", "setup_s"}
    # the waveform's gap over the gap bf16 rounding alone makes
    assert r["checks"]["wav_err"]["value"] < 4


def test_live_run_on_the_cpu():
    c = bench_cells.cell("live", {"streams": 3, "chunk_seconds": 0.05, "pool_seconds": 0.2,
                                  "warm_rounds": 1, "check_streams": 2},
                         _limits(["rvq_gap", "wav_err"]))
    r = runner.run(c, 12, 0.3, False, torch.device("cpu"), time.perf_counter())
    assert r["correct"] and set(r["metrics"]) == {"stream_rtf", "stream_chunk_p95_ms", "setup_s"}
    assert r["checks"]["wav_err"]["value"] < 4


def test_train_run_on_the_cpu():
    r = runner.run(bench_cells.train_cell(_limits(["loss_gap", "grad_norm_gap", "change_norm_gap"])), 2**31 + 3, 0.1, False, torch.device("cpu"), time.perf_counter())
    assert r["correct"]
    assert r["checks"]["loss_gap"]["value"] < 1e-3
    assert r["checks"]["grad_norm_gap"]["value"] < 1e-2


def test_the_window_feeds_the_same_state(monkeypatch):
    """The checked steps and the window go through one step function on
    one state: the window's first step is step `checked_steps`."""
    from benchmark.harness.train import Train

    d = Train(bench_cells.train_cell({}), 4, "cpu")
    d.setup()
    assert d.state["step"] == d.cell.traffic["checked_steps"]
    w = d.window(0.0)
    assert d.state["step"] == d.cell.traffic["checked_steps"] + w["units"]
    d.release()
    assert len(d.batches) == 3 and not np.array_equal(d.batches[0], d.batches[1])


def test_tf32_switch_restores():
    before = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    with common.tf32(True):
        assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32
    assert (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32) == before
