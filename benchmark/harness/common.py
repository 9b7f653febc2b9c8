"""Small pieces the kinds of traffic share."""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch


@contextlib.contextmanager
def tf32(enabled: bool):
    """TF32 on or off for cuDNN convolutions and cuBLAS matmuls inside the
    block; the previous settings come back after it."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def now() -> float:
    return time.perf_counter()


def port_config(config: dict, part: str):
    """The port's registered configuration named by a configuration file,
    checked field by field against the file's "codec" fields, with the
    file's `part` ("serving" or "training") applied as the port applies
    it; raises where the file and the port disagree."""
    from nsc_tpu_torch import api
    from nsc_tpu_torch.configs import get_config

    cfg = get_config(config["codec"]["name"])
    have = dataclasses.asdict(cfg)
    want = {k: list(v) if isinstance(v, (list, tuple)) else v for k, v in config["codec"].items()}
    have = {k: list(v) if isinstance(v, tuple) else v for k, v in have.items()}
    if have != want:
        diff = sorted(k for k in set(have) | set(want) if have.get(k) != want.get(k))
        raise ValueError(f"configuration file differs from the port's {cfg.name!r} in {diff}")
    if part == "serving":
        cfg = api.serving_config(cfg)
        for k, v in config["serving"].items():
            if getattr(cfg, k) != v:
                raise ValueError(f"serving {k}: the file says {v!r}, the port runs {getattr(cfg, k)!r}")
    return cfg


def run_codec(config: dict, part: str) -> dict:
    """The codec fields as a run of `part` has them (the file's "codec"
    with its `part` overrides), for the reference and the counts."""
    return {**config["codec"], **config.get(part, {})} if part == "serving" else dict(config["codec"])
