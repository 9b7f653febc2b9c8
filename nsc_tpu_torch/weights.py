"""Codec weights for the port: conversion from the JAX package's parameter
tree, and a seeded initialization.

`from_jax_params(params, rvq, cfg)` takes the JAX pytrees as nested dicts of
arrays (numpy, or anything `np.asarray` takes) in the JAX layout:

  conv            {'v': (K, Cin, Cout), 'g': (Cout,), 'b'} or {'w', 'b'}
  snake           {'alpha': (C,)}
  rvq             {'codebooks': (n_q, K, D), ...}
  proj_in/out     (latent_dim, codebook_dim) / (codebook_dim, latent_dim)

and returns the port's dicts of float32 CPU tensors, with weight-norm
materialized once (eps 1e-12, `ops.conv.materialize_weight`):

  conv            {'w': (Cout, Cin, K), 'b': (Cout,)}
  transposed conv {'w': (Cin, Cout, K), 'b': (Cout,)}
  activation      alpha (C,) or None (elu)

Each stage also gets its units packed for the kernel route that
`KernelOptions.for_config(cfg)` selects from `cfg.unit_backend`, and only
for that one (`seanet.pack_stages`): 'stack' for K1 (compute dtype),
'stack_cl' for K6 (float32 units) or 'fused' for K5 (float32 units, with a
head or tail in the compute dtype); K6's and K5's unit weights are stored
as bf16 planes where the config's run takes the tensor-core chain.

`train_state_from_jax` / `train_state_to_jax` carry the training trees
(weight-norm kept as (v, g) leaves, the whole RVQ state) between the two
packages.

`init_jax_layout(cfg, seed)` makes weights with the same distributions as
the JAX package's init (uniform(-1/sqrt(fan_in), 1/sqrt(fan_in)) convs with
g = ||v||, alpha = 1, N(0, 1) codebooks, scaled-normal projections) from a
`torch.Generator`; they differ from the JAX init's numbers.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch

from nsc_tpu_torch.configs import CodecConfig
from nsc_tpu_torch.models import seanet
from nsc_tpu_torch.models.codec import DTYPES, KernelOptions
from nsc_tpu_torch.ops import conv as C
from nsc_tpu_torch.ops import rvq as rvq_ops

Tree = Dict[str, Any]


def _t(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float32).clone()
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def tree_map(fn, tree):
    """Apply `fn` to every leaf of a nested dict/list/tuple tree; None
    leaves (elu activations) stay None."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def to_tensors(tree):
    """Arrays (numpy, or anything `np.asarray` takes) -> float32 CPU tensors."""
    return tree_map(_t, tree)


def to_numpy(tree):
    """Tensors -> numpy arrays (the JAX package's layout when the tree is a
    training tree)."""
    return tree_map(
        lambda x: x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x, tree
    )


def conv_from_jax(p: Tree) -> Dict[str, torch.Tensor]:
    """A JAX conv {'v', 'g', 'b'} or {'w', 'b'} -> {'w': (Cout, Cin, K), 'b'}."""
    return C.conv_params(to_tensors(p))


def conv_transpose_from_jax(p: Tree) -> Dict[str, torch.Tensor]:
    """A JAX transposed conv -> {'w': (Cin, Cout, K), 'b'}."""
    return C.conv_transpose_params(to_tensors(p))


def units_from_jax(units) -> list:
    """A stage's JAX residual units -> the port's materialized units. The
    route packs them (`seanet.pack_stages`, `kernels.residual_stack.pack_stage`,
    `kernels.fused_stage.pack`)."""
    return seanet.materialize_units(to_tensors(units))


def from_jax_params(params: Tree, rvq: Tree, cfg: CodecConfig) -> Tuple[Tree, Tree]:
    """JAX parameter/quantizer trees -> the port's (params, rvq)."""
    dtype = DTYPES[cfg.compute_dtype]
    tree = to_tensors(params)
    out = {
        "encoder": seanet.materialize_encoder(tree["encoder"]),
        "decoder": seanet.materialize_decoder(tree["decoder"]),
    }
    route = KernelOptions.for_config(cfg).units
    for part in ("encoder", "decoder"):
        seanet.pack_stages(part, out[part]["stages"], route, dtype,
                           cfg.activation == "snake_fast")
    for name in ("proj_in", "proj_out"):
        if name in tree:
            out[name] = tree[name]
    return out, {"codebooks": _t(rvq["codebooks"])}


# ---------------------------------------------------------------------------
# training trees
# ---------------------------------------------------------------------------


def train_state_from_jax(params_g: Tree, params_d: Tree, rvq: Tree) -> Tree:
    """The JAX package's training trees -> the port's, as float32 CPU
    tensors in the same layout: weight-norm stays (v, g) leaves (the codec
    and the discriminators materialize it on every call), and the RVQ state
    is whole (codebooks, ema_count, ema_sum; missing EMA stats start as the
    JAX package's `init_rvq` makes them)."""
    rvq_t = to_tensors(rvq)
    if "ema_count" not in rvq_t:
        rvq_t = rvq_ops.init_rvq_train(rvq_t["codebooks"])
    return {
        "params_g": to_tensors(params_g),
        "params_d": to_tensors(params_d),
        "rvq": rvq_t,
    }


def train_state_to_jax(state: Tree) -> Tree:
    """The inverse of `train_state_from_jax` for the parameter and RVQ trees
    (and any optimizer moments beside them): numpy arrays in the JAX
    package's layout."""
    return {k: to_numpy(v) for k, v in state.items() if k in (
        "params_g", "params_d", "rvq", "opt_g", "opt_d")}


# ---------------------------------------------------------------------------
# seeded init (JAX layout, so it goes through the same conversion)
# ---------------------------------------------------------------------------


def _init_conv(g: torch.Generator, k: int, cin: int, cout: int, wn: bool) -> Tree:
    bound = 1.0 / math.sqrt(cin * k)
    w = (torch.rand((k, cin, cout), generator=g) * 2 - 1) * bound
    b = (torch.rand((cout,), generator=g) * 2 - 1) * bound
    if wn:
        return {"v": w.numpy(), "g": torch.sqrt((w * w).sum((0, 1))).numpy(),
                "b": b.numpy()}
    return {"w": w.numpy(), "b": b.numpy()}


def _init_act(cfg: CodecConfig, ch: int):
    if cfg.activation in ("snake", "snake_fast"):
        return {"alpha": np.ones((ch,), np.float32)}
    return None


def _init_unit(g, ch: int, cfg: CodecConfig, wn: bool) -> Tree:
    return {
        "act1": _init_act(cfg, ch),
        "conv1": _init_conv(g, cfg.residual_kernel, ch, ch, wn),
        "act2": _init_act(cfg, ch),
        "conv2": _init_conv(g, 1, ch, ch, wn),
    }


def init_jax_layout(cfg: CodecConfig, seed: int = 0) -> Tuple[Tree, Tree]:
    """Random weights in the JAX package's layout, from `seed`."""
    g = torch.Generator().manual_seed(seed)
    wn = cfg.norm == "weight_norm"
    units = lambda ch: [_init_unit(g, ch, cfg, wn) for _ in cfg.dilations]  # noqa: E731
    enc_stages = []
    for ch, stride in zip(seanet.stage_widths(cfg), cfg.strides):
        enc_stages.append({
            "units": units(ch),
            "down_act": _init_act(cfg, ch),
            "down": _init_conv(g, 2 * stride, ch, 2 * ch, wn),
        })
    fw = seanet.encoder_final_width(cfg)
    encoder = {
        "stem": _init_conv(g, cfg.stem_kernel, cfg.channels, cfg.base_width, wn),
        "stages": enc_stages,
        "final_act": _init_act(cfg, fw),
        "final": _init_conv(g, cfg.last_kernel, fw, cfg.latent_dim, wn),
    }
    dec_stages = []
    for i, stride in enumerate(reversed(cfg.strides)):
        ch = fw // (2**i)
        dec_stages.append({
            "up_act": _init_act(cfg, ch),
            "up": _init_conv(g, 2 * stride, ch, ch // 2, wn),
            "units": units(ch // 2),
        })
    decoder = {
        "stem": _init_conv(g, cfg.last_kernel, cfg.latent_dim, fw, wn),
        "stages": dec_stages,
        "final_act": _init_act(cfg, cfg.base_width),
        "final": _init_conv(g, cfg.stem_kernel, cfg.base_width, cfg.channels, wn),
    }
    params: Tree = {"encoder": encoder, "decoder": decoder}
    if cfg.codebook_dim != cfg.latent_dim:
        params["proj_in"] = (
            torch.randn((cfg.latent_dim, cfg.codebook_dim), generator=g)
            / math.sqrt(cfg.latent_dim)
        ).numpy()
        params["proj_out"] = (
            torch.randn((cfg.codebook_dim, cfg.latent_dim), generator=g)
            / math.sqrt(cfg.codebook_dim)
        ).numpy()
    rvq = {k: v.numpy() for k, v in rvq_ops.init_rvq(cfg, g).items()}
    return params, rvq


def to_device(tree, device):
    """Move every tensor of a nested dict/list tree to `device`."""
    return tree_map(lambda x: x.to(device) if isinstance(x, torch.Tensor) else x, tree)
