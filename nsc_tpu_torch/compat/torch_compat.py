"""Reference-layout torch checkpoints -> the port's parameters (counterpart
of `nsc_tpu/compat/torch_compat.py`).

A state dict in the layout of the JAX package's PyTorch twin
(`nsc_tpu/compat/torch_model.py::TorchCodec`, the reference
implementation's module names) is mapped onto the JAX package's parameter
layout by the table below (`to_jax_layout`, numpy arrays), then converted
like any JAX-layout tree (`weights.from_jax_params`). No JAX is involved.

Layout rules:
  Conv1d weight          (Cout, Cin, K) -> (K, Cin, Cout)   transpose(2, 1, 0)
  ConvTranspose1d weight (Cin, Cout, K) -> (K, Cin, Cout)   transpose(2, 0, 1)
  weight-norm g          (Cout, 1, 1) / (1, Cout, 1) -> (Cout,)
  snake alpha            (C,) -> (C,)
  rvq codebooks          (n_q, K, D) -> (n_q, K, D)

If the real reference checkpoints use other key spellings, only
`_TORCH_KEY_ALIASES` should need entries.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from nsc_tpu_torch import weights
from nsc_tpu_torch.configs import CodecConfig

# alternate key spellings a real reference checkpoint might use
_TORCH_KEY_ALIASES: Dict[str, str] = {}


class ConversionError(KeyError):
    pass


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t)


def _c(a: np.ndarray) -> np.ndarray:
    """A C-contiguous copy of a transposed view: the weight-norm of
    `weights.from_jax_params` then sums in the JAX layout's order."""
    return np.ascontiguousarray(a)


def _get(sd: Mapping[str, Any], key: str) -> np.ndarray:
    key = _TORCH_KEY_ALIASES.get(key, key)
    if key not in sd:
        raise ConversionError(
            f"torch checkpoint missing key {key!r} (have e.g. {sorted(sd)[:5]}...)"
        )
    return _np(sd[key])


def _conv(sd, prefix: str) -> Dict[str, np.ndarray]:
    """A weight-normed or plain Conv1d at `prefix` -> the JAX conv layout."""
    if f"{prefix}.v" in sd or _TORCH_KEY_ALIASES.get(f"{prefix}.v") in sd:
        return {"v": _c(_get(sd, f"{prefix}.v").transpose(2, 1, 0)),
                "g": _get(sd, f"{prefix}.g").reshape(-1), "b": _get(sd, f"{prefix}.b")}
    return {"w": _c(_get(sd, f"{prefix}.w").transpose(2, 1, 0)), "b": _get(sd, f"{prefix}.b")}


def _conv_t(sd, prefix: str) -> Dict[str, np.ndarray]:
    """A weight-normed ConvTranspose1d at `prefix` -> the JAX conv layout."""
    return {"v": _c(_get(sd, f"{prefix}.v").transpose(2, 0, 1)),
            "g": _get(sd, f"{prefix}.g").reshape(-1), "b": _get(sd, f"{prefix}.b")}


def _act(sd, prefix: str, cfg: CodecConfig):
    if cfg.activation not in ("snake", "snake_fast"):
        return None
    return {"alpha": _get(sd, f"{prefix}.alpha")}


def _unit(sd, prefix: str, cfg: CodecConfig):
    return {"act1": _act(sd, f"{prefix}.act1", cfg), "conv1": _conv(sd, f"{prefix}.conv1"),
            "act2": _act(sd, f"{prefix}.act2", cfg), "conv2": _conv(sd, f"{prefix}.conv2")}


def to_jax_layout(state_dict: Mapping[str, Any], cfg: CodecConfig) -> Tuple[Dict, Dict]:
    """A `TorchCodec`-layout state dict -> (params, rvq) in the JAX
    package's layout, as numpy arrays. The RVQ state carries EMA statistics
    made from the codebooks (count 1 per code, sums equal to the codebooks),
    as the JAX package's converter seeds them for finetuning."""
    sd = state_dict
    n_units = len(cfg.dilations)
    encoder = {"stem": _conv(sd, "encoder.stem"), "stages": [
        {"units": [_unit(sd, f"encoder.stages.{i}.units.{j}", cfg) for j in range(n_units)],
         "down_act": _act(sd, f"encoder.stages.{i}.down_act", cfg),
         "down": _conv(sd, f"encoder.stages.{i}.down")}
        for i in range(len(cfg.strides))]}
    encoder["final_act"] = _act(sd, "encoder.final_act", cfg)
    encoder["final"] = _conv(sd, "encoder.final")
    decoder = {"stem": _conv(sd, "decoder.stem"), "stages": [
        {"up_act": _act(sd, f"decoder.stages.{i}.up_act", cfg),
         "up": _conv_t(sd, f"decoder.stages.{i}.up"),
         "units": [_unit(sd, f"decoder.stages.{i}.units.{j}", cfg) for j in range(n_units)]}
        for i in range(len(cfg.strides))]}
    decoder["final_act"] = _act(sd, "decoder.final_act", cfg)
    decoder["final"] = _conv(sd, "decoder.final")

    codebooks = _get(sd, "rvq.codebooks").astype(np.float32)
    rvq = {"codebooks": codebooks, "ema_count": np.ones(codebooks.shape[:2], np.float32),
           "ema_sum": codebooks.copy()}
    params = {"encoder": encoder, "decoder": decoder}
    if cfg.codebook_dim != cfg.latent_dim:
        # torch Linear weights are (out, in); the projections apply z @ W
        params["proj_in"] = _c(_get(sd, "proj_in.weight").T.astype(np.float32))
        params["proj_out"] = _c(_get(sd, "proj_out.weight").T.astype(np.float32))
    return params, rvq


def convert_torch_checkpoint(state_dict: Mapping[str, Any], cfg: CodecConfig) -> Tuple[Dict, Dict]:
    """A `TorchCodec`-layout state dict -> the port's (params, rvq), float32
    CPU tensors (`weights.from_jax_params`). `api.bundle_from_jax(cfg,
    *to_jax_layout(sd, cfg))` makes a bundle of it."""
    return weights.from_jax_params(*to_jax_layout(state_dict, cfg), cfg)


def load_torch_checkpoint_file(path: str, cfg: CodecConfig) -> Tuple[Dict, Dict]:
    """A .pt/.pth file of such a state dict (or of {"state_dict": ...}),
    loaded with `weights_only=True`, converted."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    return convert_torch_checkpoint(obj, cfg)
