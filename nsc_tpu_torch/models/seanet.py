"""SEANet-style encoder and decoder over the (N, C, T) layout (counterpart
of `nsc_tpu/models/seanet.py`).

  Encoder: stem conv -> per stage [residual units (dilated) -> act ->
  strided down-conv] (channels double) -> act -> final conv to latent_dim.
  Decoder: the mirror, with transposed up-convs, ending in tanh.

`_unit_stack` sends a stage's residual units to the residual-stack kernel
(`nsc_tpu_torch.kernels.residual_stack`) when the caller asks for it and the
stage is structurally supported (k=3 conv1, snake-family activation, causal
padding, no int8 quantization); otherwise each unit runs op by op. The
standalone activations between stages stay plain PyTorch ops.

Params (see `nsc_tpu_torch.weights`): conv {'w': (Cout, Cin, K), 'b'},
transposed conv {'w': (Cin, Cout, K), 'b'}, activation alpha (C,) or None,
and per stage 'stack', the units packed for the kernel.
`materialize_encoder`/`materialize_decoder` make them (without 'stack')
from a tree of tensors in the JAX package's layout, differentiably.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from nsc_tpu_torch.configs import CodecConfig
from nsc_tpu_torch.kernels import residual_stack as RS
from nsc_tpu_torch.ops import conv as C

Params = Dict[str, Any]


def _pad_mode(cfg: CodecConfig) -> str:
    return "causal" if cfg.causal else "same"


def _act(cfg: CodecConfig, x: torch.Tensor, alpha) -> torch.Tensor:
    return C.activation(cfg.activation, x, alpha)


def stack_supported(cfg: CodecConfig, padding: str) -> bool:
    """Whether the residual-stack kernel computes this config's stages."""
    return (
        cfg.residual_kernel == 3
        and cfg.activation in ("snake", "snake_fast")
        and padding == "causal"
        and cfg.quant == "none"
    )


def _apply_residual_unit(
    p: Params, x: torch.Tensor, dilation: int, cfg: CodecConfig, padding: str
) -> torch.Tensor:
    h = _act(cfg, x, p["act1"])
    h = C.conv1d(h, p["conv1"], dilation=dilation, padding=padding)
    h = _act(cfg, h, p["act2"])
    h = C.conv1d(h, p["conv2"], padding=padding)
    return x + h


def _unit_stack(
    cfg: CodecConfig, h: torch.Tensor, stage: Params, padding: str,
    use_kernel: bool,
) -> torch.Tensor:
    if use_kernel and stack_supported(cfg, padding):
        return RS.residual_stack(
            h.contiguous(), stage["stack"], cfg.dilations,
            fast=cfg.activation == "snake_fast",
        )
    for unit, dil in zip(stage["units"], cfg.dilations):
        h = _apply_residual_unit(unit, h, dil, cfg, padding)
    return h


def _alpha(p):
    return None if p is None else p["alpha"]


def materialize_units(units) -> List[Params]:
    return [
        {"act1": _alpha(u["act1"]), "conv1": C.conv_params(u["conv1"]),
         "act2": _alpha(u["act2"]), "conv2": C.conv_params(u["conv2"])}
        for u in units
    ]


def materialize_encoder(tree: Params) -> Params:
    """An encoder tree in the JAX package's layout (tensors) -> the port's."""
    return {
        "stem": C.conv_params(tree["stem"]),
        "stages": [
            {"units": materialize_units(s["units"]), "down_act": _alpha(s["down_act"]),
             "down": C.conv_params(s["down"])}
            for s in tree["stages"]
        ],
        "final_act": _alpha(tree["final_act"]),
        "final": C.conv_params(tree["final"]),
    }


def materialize_decoder(tree: Params) -> Params:
    """A decoder tree in the JAX package's layout (tensors) -> the port's."""
    return {
        "stem": C.conv_params(tree["stem"]),
        "stages": [
            {"units": materialize_units(s["units"]), "up_act": _alpha(s["up_act"]),
             "up": C.conv_transpose_params(s["up"])}
            for s in tree["stages"]
        ],
        "final_act": _alpha(tree["final_act"]),
        "final": C.conv_params(tree["final"]),
    }


def stage_widths(cfg: CodecConfig) -> List[int]:
    """Channel width entering each encoder stage; doubles per stage."""
    return [cfg.base_width * (2**i) for i in range(len(cfg.strides))]


def encoder_final_width(cfg: CodecConfig) -> int:
    return cfg.base_width * (2 ** len(cfg.strides))


def apply_encoder(
    p: Params, x: torch.Tensor, cfg: CodecConfig, *, use_kernel: bool = False
) -> torch.Tensor:
    """(N, 1, T) waveform -> (N, latent_dim, T/hop) latents."""
    pad = _pad_mode(cfg)
    h = C.conv1d(x, p["stem"], padding=pad)
    for stage, stride in zip(p["stages"], cfg.strides):
        h = _unit_stack(cfg, h, stage, pad, use_kernel)
        h = _act(cfg, h, stage["down_act"])
        h = C.conv1d(h, stage["down"], stride=stride, padding=pad)
    h = _act(cfg, h, p["final_act"])
    return C.conv1d(h, p["final"], padding=pad)


def apply_decoder(
    p: Params, z: torch.Tensor, cfg: CodecConfig, *, use_kernel: bool = False
) -> torch.Tensor:
    """(N, latent_dim, F) latents -> (N, 1, F*hop) waveform in (-1, 1)."""
    pad = _pad_mode(cfg)
    h = C.conv1d(z, p["stem"], padding=pad)
    for stage, stride in zip(p["stages"], reversed(cfg.strides)):
        h = _act(cfg, h, stage["up_act"])
        h = C.conv_transpose1d(h, stage["up"], stride=stride, causal=cfg.causal)
        h = _unit_stack(cfg, h, stage, pad, use_kernel)
    h = _act(cfg, h, p["final_act"])
    h = C.conv1d(h, p["final"], padding=pad)
    return torch.tanh(h)
