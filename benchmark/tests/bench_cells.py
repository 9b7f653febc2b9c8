"""Cells for the CPU tests: the port's `tiny_test` configuration, written as
a configuration file would be, under the kinds of traffic the benchmark
has, at sizes a CPU test holds."""

from __future__ import annotations

import dataclasses
import json

from benchmark.harness import spec


def tiny_config(name: str = "tiny_test", training: bool = False) -> dict:
    from nsc_tpu_torch import api
    from nsc_tpu_torch.configs import TrainConfig, get_config

    cfg = get_config(name)
    s = api.serving_config(cfg)
    js = lambda d: {k: list(v) if isinstance(v, tuple) else v for k, v in d.items()}  # noqa: E731
    out = {"name": name, "codec": js(dataclasses.asdict(cfg)),
           "serving": {k: getattr(s, k) for k in ("compute_dtype", "rvq_backend", "unit_backend",
                                                   "activation")}}
    if training:
        t = js(dataclasses.asdict(TrainConfig()))
        t.pop("seed")
        out["training"] = t
    return out


def cell(kind: str, traffic: dict, limits: dict, config: dict = None) -> spec.Cell:
    base = {"offline": "offline_b64x10s", "live": "live_n64x1s", "train": "train_b64x1s"}[kind]
    with open(spec.BENCH_DIR / "traffic" / f"{base}.json") as f:
        t = json.load(f)
    t.update(traffic)
    bench = spec.load_benchmark()
    e2e = {"offline": ["serve_rtf"], "live": ["stream_rtf", "stream_chunk_p95_ms"],
           "train": ["train_audio_s_per_s"]}[kind] + ["setup_s"]
    return spec.Cell(name=f"tiny.{kind}", chips=1, config=config or tiny_config(),
                     traffic=t, limits=limits,
                     end_to_end=[m for m in bench["end_to_end"] if m["name"] in e2e],
                     per_layer=[])


def train_cell(limits: dict) -> spec.Cell:
    """The training kind on tiny_test, 4 rows of 0.128 s (the shortest
    segment the loss bank's 2048-point frames take)."""
    cfg = tiny_config(training=True)
    cfg["training"].update(batch_size=4, segment_seconds=0.128, codebook_init="random")
    return cell("train", {"batch": 4, "segment_seconds": 0.128, "trace_steps": 1}, limits,
                config=cfg)


SMALL = {
    "offline": {"batch": 2, "clip_seconds": 0.2, "pool_batches": 1, "warm_batches": 1,
                "kept_batches": 1},
    "live": {"streams": 2, "chunk_seconds": 0.1, "pool_seconds": 0.4, "warm_rounds": 1,
             "check_streams": 2},
    "train": {"batch": 2, "segment_seconds": 0.16},
}


def small_cell(workload: str) -> spec.Cell:
    """A cell of `BENCHMARK.json` as it stands (configuration, limits),
    its traffic cut to a size a CPU test holds."""
    c = spec.find_cell(spec.load_benchmark(), workload)
    c.traffic.update(SMALL[c.traffic["kind"]])
    if c.traffic["kind"] == "train":
        c.config = {**c.config, "training": {**c.config["training"], "batch_size": 2,
                                             "segment_seconds": 0.16}}
    return c
