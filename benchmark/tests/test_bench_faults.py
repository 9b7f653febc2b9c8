"""A run of each cell driven on the CPU at a small size (its configuration
and limits as they stand, its traffic cut), past the look for a card: with
the timed path sound `correct` comes out true, and with the timed path
broken underneath it comes out false, once for each fault the cell can
have."""

import time

import pytest
import torch

from benchmark.harness import runner
from benchmark.tests import bench_cells


@pytest.fixture(autouse=True)
def _threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(saved)


def _run(workload, seed=22):
    cell = bench_cells.small_cell(workload)
    return runner.run(cell, seed, 0.1, False, torch.device("cpu"), time.perf_counter())


def _alter_an_index(monkeypatch):
    from nsc_tpu_torch.kernels import rvq as KR

    real = KR.quantize

    def quantize(books, z):
        idx = real(books, z).clone()
        idx[0, 0] = (idx[0, 0] + 1) % books.shape[1]
        return idx

    monkeypatch.setattr(KR, "quantize", quantize)


def _half_the_batch(monkeypatch):
    from nsc_tpu_torch.models.codec import NeuralSpeechCodec

    real = NeuralSpeechCodec.encode

    def encode(self, params, rvq, wav, n_q=None):
        half = real(self, params, rvq, wav[: max(1, wav.shape[0] // 2)], n_q)
        return torch.cat([half, half])[: wav.shape[0]]

    monkeypatch.setattr(NeuralSpeechCodec, "encode", encode)


def _alter_an_answer(monkeypatch):
    from nsc_tpu_torch.models.codec import NeuralSpeechCodec

    real = NeuralSpeechCodec.decode

    def decode(self, params, rvq, indices, n_q=None):
        wav = real(self, params, rvq, indices, n_q).clone()
        wav[-1] = 0.0
        return wav

    monkeypatch.setattr(NeuralSpeechCodec, "decode", decode)


def _stream_state_unchanged(monkeypatch):
    from nsc_tpu_torch import streaming

    real = streaming.encoder_stream
    monkeypatch.setattr(streaming, "encoder_stream",
                        lambda params, state, chunk, cfg: (real(params, state, chunk, cfg)[0], state))


def _stream_answer_altered(monkeypatch):
    from nsc_tpu_torch import streaming

    real = streaming.StreamingDecoder.push

    def push(self, indices):
        wav = real(self, indices).copy()
        wav[-1] = 0.0
        return wav

    monkeypatch.setattr(streaming.StreamingDecoder, "push", push)


OFFLINE = {"index_altered": _alter_an_index, "half_the_batch": _half_the_batch,
           "answer_altered": _alter_an_answer}
LIVE = {"index_altered": _alter_an_index, "state_unchanged": _stream_state_unchanged,
        "answer_altered": _stream_answer_altered}


SERVE = ["serve.base_fast.b64x10s", "serve.base_noncausal.b64x10s"]
STREAM = "stream.base_fast.n64x1s"
TRAIN_CELL = "train.base_fast.b64x1s"


@pytest.mark.parametrize("workload", SERVE + [STREAM, TRAIN_CELL])
def test_sound_runs_are_correct(workload):
    # the train cell's 2 rows on the CPU read grad_norm_gap ~3e-4 (seed
    # 22) against its 4.5e-4: the card's 64 rows read under 1e-4
    assert _run(workload)["correct"]


@pytest.mark.parametrize("workload", SERVE)
@pytest.mark.parametrize("fault", sorted(OFFLINE))
def test_offline_faults_are_not_correct(workload, fault, monkeypatch):
    OFFLINE[fault](monkeypatch)
    assert not _run(workload)["correct"]


@pytest.mark.parametrize("fault", sorted(LIVE))
def test_live_faults_are_not_correct(fault, monkeypatch):
    LIVE[fault](monkeypatch)
    assert not _run(STREAM)["correct"]


def _step_state_unchanged(monkeypatch):
    from nsc_tpu_torch.train import train

    real = train.make_train_step

    def make(model, tcfg, **kw):
        step = real(model, tcfg, **kw)

        def unchanged(state, batch, **k):
            keep = [x.detach().clone() for x in train.tree_leaves(state["params_g"])
                    + train.tree_leaves(state["params_d"])]
            books = state["rvq"]
            state, metrics = step(state, batch, **k)
            with torch.no_grad():
                for x, old in zip(train.tree_leaves(state["params_g"])
                                  + train.tree_leaves(state["params_d"]), keep):
                    x.copy_(old)
            state["rvq"] = books
            return state, metrics

        return unchanged

    monkeypatch.setattr(train, "make_train_step", make)


def _step_half_batch(monkeypatch):
    from nsc_tpu_torch.train import train

    real = train.make_train_step

    def make(model, tcfg, **kw):
        step = real(model, tcfg, **kw)
        return lambda state, batch, **k: step(state, batch[: batch.shape[0] // 2], **k)

    monkeypatch.setattr(train, "make_train_step", make)


TRAIN = {"state_unchanged": _step_state_unchanged, "half_the_batch": _step_half_batch}


@pytest.mark.parametrize("fault", sorted(TRAIN))
def test_train_faults_are_not_correct(fault, monkeypatch):
    TRAIN[fault](monkeypatch)
    assert not _run(TRAIN_CELL)["correct"]
