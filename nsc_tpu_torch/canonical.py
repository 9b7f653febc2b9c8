"""Canonical-index pins for the port (counterpart of `nsc_tpu/canonical.py`).

The archived indices of a checkpoint are whatever its serving path
(`api.load_model(..., serving=True)`) produces. The serving path's indices
on two fixed probes are pinned beside the export, and a later run on the
same card and software must reproduce them bit for bit.

The port's pin is its own: `canonical_idx_gpu.npz` beside the export of the
checkpoint (`scripts/torch_write_gpu_pin.py` writes it on the card). The
JAX package's TPU pins (`canonical_idx.npz` beside the orbax stores) are a
different serving graph and not a target. A pin records the backend it was
made on (`backend`: the card's name and the torch, CUDA and cuDNN
versions, or "cpu"); `check_pin` labels a check on another backend as a
diagnostic, as the JAX package does, and says whether the backends are
equal (`PinCheck.same_backend`).

The probes are the JAX package's, bit for bit: 8 rows x 10 s of seed-0
noise (`probe_input`) and of the port's `SyntheticSourceV2` speech-like
generator (`speech_probe_input`), which draws the JAX generator's numbers.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np
import torch

PIN_NAME = "canonical_idx_gpu.npz"
# Changing any of these constants invalidates every existing pin.
PIN_VERSION = 1
_PROBE_BATCH = 8
_PROBE_SECONDS = 10.0
_PROBE_SEED = 0
_PROBE_SCALE = 0.1


def probe_input(cfg, batch: int = _PROBE_BATCH) -> np.ndarray:
    """The fixed (batch, 10 s) noise probe the pin is defined over."""
    t = int(_PROBE_SECONDS * cfg.sample_rate)
    rng = np.random.RandomState(_PROBE_SEED)
    return (rng.randn(_PROBE_BATCH, t) * _PROBE_SCALE).astype(np.float32)[:batch]


def speech_probe_input(cfg, batch: int = _PROBE_BATCH) -> np.ndarray:
    """The fixed (batch, 10 s) speech-like probe: synthetic-v2 utterances
    from seed 0. Its bytes depend on `train/data.py::SyntheticSourceV2`:
    changing that generator invalidates the speech half of every pin."""
    from nsc_tpu_torch.train.data import SyntheticSourceV2

    t = int(_PROBE_SECONDS * cfg.sample_rate)
    src = SyntheticSourceV2(cfg.sample_rate, _PROBE_SEED)
    return next(src.batches(_PROBE_BATCH, t))[:batch].astype(np.float32)


def pin_path(checkpoint_dir: str) -> str:
    return os.path.join(checkpoint_dir, PIN_NAME)


def backend(device) -> str:
    """Where indices were computed: the card's name with the torch, CUDA
    and cuDNN versions, or "cpu"."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev.type
    return (f"{torch.cuda.get_device_name(dev)} torch {torch.__version__} "
            f"cuda {torch.version.cuda} cudnn {torch.backends.cudnn.version()}")


def write_pin(bundle, checkpoint_dir: str) -> str:
    """Encode both probes through `bundle` and pin the indices beside the
    checkpoint. `bundle` must be the serving bundle of this checkpoint
    (`api.load_model(..., serving=True)`): the pin defines the archival
    indices, so it comes from the graph that serves."""
    from nsc_tpu_torch import api

    idx = api.encode(bundle, probe_input(bundle.cfg))
    idx_speech = api.encode(bundle, speech_probe_input(bundle.cfg))
    path = pin_path(checkpoint_dir)
    np.savez_compressed(
        path,
        version=np.int32(PIN_VERSION),
        indices=idx.astype(np.int32),
        indices_speech=idx_speech.astype(np.int32),
        fingerprint=np.uint32(api.codebook_fingerprint(bundle.rvq)),
        config=np.array(bundle.cfg.name),
        backend=np.array(backend(bundle.device)),
    )
    return path


class PinCheck(NamedTuple):
    """`check_pin`'s result: nsc_tpu's (exact, match_rate, status), and
    whether the pin was made on this run's backend (only then is `exact`
    the archival contract; elsewhere it is a diagnostic)."""

    exact: Optional[bool]
    match_rate: float
    status: str
    same_backend: bool


def check_pin(bundle, checkpoint_dir: str) -> PinCheck:
    """Re-encode both probes through `bundle` and compare with the pin.

    exact is True/False when a comparable pin exists, None when it does not
    (no pin file, another version, or other codebooks); status is a short
    reason."""
    from nsc_tpu_torch import api

    path = pin_path(checkpoint_dir)
    if not os.path.exists(path):
        return PinCheck(None, 0.0, "no canonical pin at checkpoint", False)
    here = backend(bundle.device)
    with np.load(path, allow_pickle=False) as z:
        same = str(z["backend"]) == here
        if int(z["version"]) != PIN_VERSION:
            return PinCheck(None, 0.0, f"pin version {int(z['version'])} unsupported", same)
        if int(z["fingerprint"]) != api.codebook_fingerprint(bundle.rvq):
            return PinCheck(None, 0.0, "pin was made from different codebooks", same)
        pinned = {"noise": z["indices"], "speech": z["indices_speech"]}
        pin_backend = str(z["backend"])
    matched = 0
    for name, probe in (("noise", probe_input), ("speech", speech_probe_input)):
        idx = api.encode(bundle, probe(bundle.cfg, batch=pinned[name].shape[0]))
        if idx.shape != pinned[name].shape:
            return PinCheck(False, 0.0, f"{name}-probe shape {idx.shape} != pinned "
                            f"{pinned[name].shape}", same)
        matched += int((idx == pinned[name]).sum())
    rate = matched / sum(v.size for v in pinned.values())
    status = "vs pinned canonical indices (noise + speech probes)"
    if not same:
        # the pin defines indices on the backend that wrote it; elsewhere
        # the check is a diagnostic of another float schedule
        status += f" (pin from '{pin_backend}', checking on '{here}')"
    return PinCheck(bool(rate == 1.0), rate, status, same)
