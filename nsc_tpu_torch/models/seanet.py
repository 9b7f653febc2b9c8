"""SEANet-style encoder and decoder over the (N, C, T) layout (counterpart
of `nsc_tpu/models/seanet.py`).

  Encoder: stem conv -> per stage [residual units (dilated) -> act ->
  strided down-conv] (channels double) -> act -> final conv to latent_dim.
  Decoder: the mirror, with transposed up-convs, ending in tanh.

`unit_route(cfg)` reads the config's `unit_backend` under the JAX
package's gates and names where the stages' residual units run:

  "residual_stack"     ("auto", "pallas_ct") K1 per stage, (N, C, T);
  "residual_stack_cl"  ("pallas_fused") K6 per stage, on (N, T, C): the
                       stage transposes in and out (two plain copies);
  "fused_stage"        ("pallas_ct_fused") K5 per stage, with the encoder's
                       down_act + down conv of the previous stage fused in
                       as a head and the decoder's up_act + up conv of the
                       next stage as a tail (`apply_encoder_fused`,
                       `apply_decoder_fused`);
  "reference"          op by op (also where a gate fails).

The standalone activations and convs between kernels stay plain PyTorch
ops. Each conv goes through `_conv` / `_conv_transpose`, the JAX package's
dispatch: int8 W8A8 (`ops.quant`) when cfg.quant is "int8", else the
stacked matmul forms (`ops.fastconv`) for causal convs when
cfg.conv_backend is "stacked", else `ops.conv`. An int8 or "stacked"
config runs its units op by op or, with "stacked", through K1/K6 (which
take the units' convs themselves); K5 needs "reference" convs.

Params (see `nsc_tpu_torch.weights`): conv {'w': (Cout, Cin, K), 'b'},
transposed conv {'w': (Cin, Cout, K), 'b'}, activation alpha (C,) or None,
and per stage what the route runs: 'stack' (K1, compute dtype),
'stack_cl' (K6, float32) or 'fused' (K5; `pack_stages`).
`materialize_encoder`/`materialize_decoder` make them (without the packed
entries) from a tree of tensors in the JAX package's layout,
differentiably.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

from nsc_tpu_torch.configs import CodecConfig
from nsc_tpu_torch.kernels import fused_stage as FS
from nsc_tpu_torch.kernels import residual_stack as RS
from nsc_tpu_torch.ops import conv as C
from nsc_tpu_torch.ops import fastconv as FC
from nsc_tpu_torch.ops import quant as Q

Params = Dict[str, Any]


def _pad_mode(cfg: CodecConfig) -> str:
    return "causal" if cfg.causal else "same"


def _act(cfg: CodecConfig, x: torch.Tensor, alpha) -> torch.Tensor:
    return C.activation(cfg.activation, x, alpha)


def _conv(cfg: CodecConfig, x: torch.Tensor, p: Params, *, stride: int = 1,
          dilation: int = 1, padding: str = "causal") -> torch.Tensor:
    """Conv dispatch: int8 W8A8, the stacked matmul (causal only), or the
    plain conv."""
    if cfg.quant == "int8":
        return Q.conv1d_int8(x, p, stride=stride, dilation=dilation, padding=padding)
    if cfg.conv_backend == "stacked" and padding == "causal":
        return FC.stacked_conv1d(x, p, stride=stride, dilation=dilation, stack=cfg.conv_stack)
    return C.conv1d(x, p, stride=stride, dilation=dilation, padding=padding)


def _conv_transpose(cfg: CodecConfig, x: torch.Tensor, p: Params, *, stride: int) -> torch.Tensor:
    """Transposed conv dispatch: int8 or polyphase when causal, else the
    plain one."""
    if cfg.quant == "int8" and cfg.causal:
        return Q.conv_transpose1d_int8(x, p, stride=stride)
    if cfg.conv_backend == "stacked" and cfg.causal:
        return FC.polyphase_conv_transpose1d(x, p, stride=stride)
    return C.conv_transpose1d(x, p, stride=stride, causal=cfg.causal)


UNIT_ROUTES = ("reference", "residual_stack", "residual_stack_cl", "fused_stage")

# The JAX package's CARRY_CT: K5's receptive-field gate, sum(2d) <= 128.
FUSED_MAX_HALO = 128


def stack_supported(cfg: CodecConfig, padding: str) -> bool:
    """Whether the residual-stack kernels (K1, K6) compute this config's
    stages."""
    return (
        cfg.residual_kernel == 3
        and cfg.activation in ("snake", "snake_fast")
        and padding == "causal"
        and cfg.quant == "none"
    )


def fused_boundary_supported(cfg: CodecConfig) -> bool:
    """The gate of the JAX package's `_fused_boundary_mode`: causal, snake
    family, no int8, reference convs, every stage width and the encoder's
    final width a multiple of 16 (bf16) or 8 (float32), k=3 units with
    sum(2d) <= 128."""
    min_c = 16 if cfg.compute_dtype == "bfloat16" else 8
    widths = stage_widths(cfg) + [encoder_final_width(cfg)]
    return (
        cfg.causal
        and cfg.activation in ("snake", "snake_fast")
        and cfg.quant == "none"
        and cfg.conv_backend == "reference"
        and all(w >= min_c and w % min_c == 0 for w in widths)
        and cfg.residual_kernel == 3
        and sum(2 * d for d in cfg.dilations) <= FUSED_MAX_HALO
    )


def unit_route(cfg: CodecConfig) -> str:
    """Where the stages' residual units run for `cfg.unit_backend` (see the
    module doc). As in the JAX package, "pallas_ct_fused" outside its gate
    runs op by op, not K1."""
    supported = stack_supported(cfg, _pad_mode(cfg))
    if cfg.unit_backend in ("auto", "pallas_ct") and supported:
        return "residual_stack"
    if cfg.unit_backend == "pallas_fused" and supported:
        return "residual_stack_cl"
    if cfg.unit_backend == "pallas_ct_fused" and fused_boundary_supported(cfg):
        return "fused_stage"
    return "reference"


def pack_stages(part: str, stages: List[Params], route: str, dtype: torch.dtype,
                fast: bool) -> None:
    """Add to each stage of `part` ("encoder" or "decoder") the packed
    weights its route runs in compute dtype `dtype` with snake_fast (`fast`)
    or snake: K1's units in `dtype`; K6's float32 units; or K5's float32
    units with, in the encoder after stage 0, a head made from the previous
    stage's down_act/down and, in the decoder before the last stage, a tail
    made from the next stage's up_act/up (in `dtype`). K6's and K5's unit
    weights are stored as bf16 planes where the run takes the tensor-core
    chain (`RS.tensor_cores`, `FS.tensor_cores`)."""
    for i, stage in enumerate(stages):
        if route == "residual_stack":
            stage["stack"] = RS.pack_stage(stage["units"], dtype)
        elif route == "residual_stack_cl":
            c = stage["units"][0]["conv1"]["w"].shape[0]
            stage["stack_cl"] = RS.pack_stage(stage["units"], torch.float32,
                                              planes=RS.tensor_cores(dtype, fast, c))
        elif route == "fused_stage":
            head = tail = None
            if part == "encoder" and i > 0:
                prev = stages[i - 1]
                head = FS.pack_head(prev["down_act"], prev["down"], dtype)
            if part == "decoder" and i + 1 < len(stages):
                nxt = stages[i + 1]
                tail = FS.pack_tail(nxt["up_act"], nxt["up"], dtype)
            stage["fused"] = FS.pack(stage["units"], head, tail, dtype, fast)


def _apply_residual_unit(
    p: Params, x: torch.Tensor, dilation: int, cfg: CodecConfig, padding: str
) -> torch.Tensor:
    h = _act(cfg, x, p["act1"])
    h = _conv(cfg, h, p["conv1"], dilation=dilation, padding=padding)
    h = _act(cfg, h, p["act2"])
    h = _conv(cfg, h, p["conv2"], padding=padding)
    return x + h


def _unit_stack(
    cfg: CodecConfig, h: torch.Tensor, stage: Params, padding: str, route: str,
) -> torch.Tensor:
    fast = cfg.activation == "snake_fast"
    if route == "residual_stack":
        return RS.residual_stack(h.contiguous(), stage["stack"], cfg.dilations, fast)
    if route == "residual_stack_cl":
        out = RS.residual_stack_cl(
            h.transpose(1, 2).contiguous(), stage["stack_cl"], cfg.dilations, fast
        )
        return out.transpose(1, 2).contiguous()
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
    p: Params, x: torch.Tensor, cfg: CodecConfig, *, units: str = "reference"
) -> torch.Tensor:
    """(N, 1, T) waveform -> (N, latent_dim, T/hop) latents; `units` is the
    route of the residual units (`unit_route`)."""
    pad = _pad_mode(cfg)
    h = _conv(cfg, x, p["stem"], padding=pad)
    if units == "fused_stage":
        return apply_encoder_fused(p, h, cfg)
    for stage, stride in zip(p["stages"], cfg.strides):
        h = _unit_stack(cfg, h, stage, pad, units)
        h = _act(cfg, h, stage["down_act"])
        h = _conv(cfg, h, stage["down"], stride=stride, padding=pad)
    h = _act(cfg, h, p["final_act"])
    return _conv(cfg, h, p["final"], padding=pad)


def apply_encoder_fused(p: Params, h: torch.Tensor, cfg: CodecConfig) -> torch.Tensor:
    """The post-stem encoder through K5: stage 0 has no head, stage i > 0
    takes stage i-1's down_act + down conv as its head. The last down_act +
    down conv and the final act + conv stay outside."""
    fast = cfg.activation == "snake_fast"
    for stage in p["stages"]:
        h = FS.fused_stage(h.contiguous(), stage["fused"], cfg.dilations, fast)
    last = p["stages"][-1]
    h = _act(cfg, h, last["down_act"])
    h = C.conv1d(h, last["down"], stride=cfg.strides[-1], padding="causal")
    h = _act(cfg, h, p["final_act"])
    return C.conv1d(h, p["final"], padding="causal")


def apply_decoder(
    p: Params, z: torch.Tensor, cfg: CodecConfig, *, units: str = "reference"
) -> torch.Tensor:
    """(N, latent_dim, F) latents -> (N, 1, F*hop) waveform in (-1, 1);
    `units` is the route of the residual units (`unit_route`)."""
    if units == "fused_stage":
        return apply_decoder_fused(p, z, cfg)
    pad = _pad_mode(cfg)
    h = _conv(cfg, z, p["stem"], padding=pad)
    for stage, stride in zip(p["stages"], reversed(cfg.strides)):
        h = _act(cfg, h, stage["up_act"])
        h = _conv_transpose(cfg, h, stage["up"], stride=stride)
        h = _unit_stack(cfg, h, stage, pad, units)
    h = _act(cfg, h, p["final_act"])
    h = _conv(cfg, h, p["final"], padding=pad)
    return torch.tanh(h)


def apply_decoder_fused(p: Params, z: torch.Tensor, cfg: CodecConfig) -> torch.Tensor:
    """The decoder through K5: the stem and stages[0]'s up_act + up conv
    stay outside, stage i < last takes stage i+1's up_act + up conv as its
    tail, and the final act + conv + tanh stay outside."""
    fast = cfg.activation == "snake_fast"
    stages = p["stages"]
    h = C.conv1d(z, p["stem"], padding="causal")
    h = _act(cfg, h, stages[0]["up_act"])
    h = C.conv_transpose1d(h, stages[0]["up"], stride=cfg.strides[-1], causal=True)
    for stage in stages:
        h = FS.fused_stage(h.contiguous(), stage["fused"], cfg.dilations, fast)
    h = _act(cfg, h, p["final_act"])
    h = C.conv1d(h, p["final"], padding="causal")
    return torch.tanh(h)
