"""Layer-by-layer parity of the port against nsc_tpu: which layer diverges
first.

`first_divergence(jparams, jrvq, jcfg, bundle, wav)` walks the encoder and
then the decoder as `nsc_tpu/models/seanet.py::apply_encoder` /
`apply_decoder` do, once with nsc_tpu's own layer functions (`_conv`,
`_unit_stack`, `_act`, `_conv_transpose`, eagerly) and once with the port's
(`nsc_tpu_torch/models/seanet.py`, on the bundle's parameters and kernel
route), and compares every layer's output:

  encoder.stem, encoder.stage{i}.units, encoder.stage{i}.down_act,
  encoder.stage{i}.down, encoder.final (final act + conv), rvq (the
  indices; the latents pass nsc_tpu's projection first), decoder.stem
  (dequantized nsc_tpu indices, projected), decoder.stage{i}.up_act,
  decoder.stage{i}.up, decoder.stage{i}.units, decoder.final (final act,
  conv, tanh).

Both walks start every layer from their own previous output, and the
decoder from nsc_tpu's indices on both sides, so an index flip in the RVQ
does not show as a decoder divergence. A layer diverges when
max|port - nsc_tpu| > rtol x max|nsc_tpu| + atol (indices: any difference).
Returns None or (layer name, max abs difference, max |nsc_tpu|). A helper
for the tests' failure messages, not a test file.
"""

from typing import Optional, Tuple

import jax.numpy as jnp
import numpy as np
import torch

from nsc_tpu.models import seanet as JS
from nsc_tpu.ops import rvq as JR
from nsc_tpu_torch.models import seanet as PS


def _jax_layers(p, rvq, cfg, wav):
    pad = "causal" if cfg.causal else "same"
    out = []
    h = JS._conv(cfg, jnp.asarray(wav)[..., None].astype(cfg.compute_dtype), p["encoder"]["stem"],
                 padding=pad)
    out.append(("encoder.stem", h))
    for i, (st, stride) in enumerate(zip(p["encoder"]["stages"], cfg.strides)):
        h = JS._unit_stack(cfg, h, st["units"], pad)
        out.append((f"encoder.stage{i}.units", h))
        h = JS._act(cfg, h, st["down_act"])
        out.append((f"encoder.stage{i}.down_act", h))
        h = JS._conv(cfg, h, st["down"], stride=stride, padding=pad)
        out.append((f"encoder.stage{i}.down", h))
    h = JS._act(cfg, h, p["encoder"]["final_act"])
    h = JS._conv(cfg, h, p["encoder"]["final"], padding=pad)
    out.append(("encoder.final", h))
    z = h.astype(jnp.float32)
    if "proj_in" in p:
        z = z @ p["proj_in"]
    idx = JR.quantize(rvq, z)
    out.append(("rvq", idx))
    zq = JR.dequantize(rvq, idx)
    if "proj_out" in p:
        zq = zq @ p["proj_out"]
    h = JS._conv(cfg, zq.astype(cfg.compute_dtype), p["decoder"]["stem"], padding=pad)
    out.append(("decoder.stem", h))
    for i, (st, stride) in enumerate(zip(p["decoder"]["stages"], reversed(cfg.strides))):
        h = JS._act(cfg, h, st["up_act"])
        out.append((f"decoder.stage{i}.up_act", h))
        h = JS._conv_transpose(cfg, h, st["up"], stride=stride)
        out.append((f"decoder.stage{i}.up", h))
        h = JS._unit_stack(cfg, h, st["units"], pad)
        out.append((f"decoder.stage{i}.units", h))
    h = JS._act(cfg, h, p["decoder"]["final_act"])
    h = jnp.tanh(JS._conv(cfg, h, p["decoder"]["final"], padding=pad))
    out.append(("decoder.final", h))
    return [(k, np.asarray(v.astype(jnp.float32) if v.dtype != jnp.int32 else v)) for k, v in out]


def _port_layers(bundle, wav, jidx):
    cfg, p, model = bundle.cfg, bundle.params, bundle.model
    route, pad = model.kernels.units, PS._pad_mode(cfg)
    cl = lambda t: t.float().transpose(1, 2).numpy()  # noqa: E731  (N, C, T) -> (N, T, C)
    out = []
    with torch.inference_mode():
        h = PS._conv(cfg, model._shape_wav(torch.from_numpy(wav)), p["encoder"]["stem"], padding=pad)
        out.append(("encoder.stem", cl(h)))
        for i, (st, stride) in enumerate(zip(p["encoder"]["stages"], cfg.strides)):
            h = PS._unit_stack(cfg, h, st, pad, route)
            out.append((f"encoder.stage{i}.units", cl(h)))
            h = PS._act(cfg, h, st["down_act"])
            out.append((f"encoder.stage{i}.down_act", cl(h)))
            h = PS._conv(cfg, h, st["down"], stride=stride, padding=pad)
            out.append((f"encoder.stage{i}.down", cl(h)))
        h = PS._act(cfg, h, p["encoder"]["final_act"])
        h = PS._conv(cfg, h, p["encoder"]["final"], padding=pad)
        out.append(("encoder.final", cl(h)))
        z = model._project_in(p, h.transpose(1, 2))
        from nsc_tpu_torch.ops import rvq as PR

        out.append(("rvq", PR.quantize(bundle.rvq, z, kernel=model.kernels.rvq).numpy()))
        zq = PR.dequantize(bundle.rvq, torch.from_numpy(np.array(jidx)), kernel=model.kernels.rvq)
        h = PS._conv(cfg, model._project_out(p, zq).to(model.compute_dtype).transpose(1, 2),
                     p["decoder"]["stem"], padding=pad)
        out.append(("decoder.stem", cl(h)))
        for i, (st, stride) in enumerate(zip(p["decoder"]["stages"], reversed(cfg.strides))):
            h = PS._act(cfg, h, st["up_act"])
            out.append((f"decoder.stage{i}.up_act", cl(h)))
            h = PS._conv_transpose(cfg, h, st["up"], stride=stride)
            out.append((f"decoder.stage{i}.up", cl(h)))
            h = PS._unit_stack(cfg, h, st, pad, route)
            out.append((f"decoder.stage{i}.units", cl(h)))
        h = PS._act(cfg, h, p["decoder"]["final_act"])
        h = torch.tanh(PS._conv(cfg, h, p["decoder"]["final"], padding=pad))
        out.append(("decoder.final", cl(h)))
    return out


def first_divergence(jparams, jrvq, jcfg, bundle, wav: np.ndarray, *, rtol: float = 1e-4,
                     atol: float = 1e-5) -> Optional[Tuple[str, float, float]]:
    """The first layer where the port leaves nsc_tpu (see the module doc),
    or None. `wav`: (N, T) float32, T a multiple of the hop."""
    ref = _jax_layers(jparams, jrvq, jcfg, wav)
    jidx = dict(ref)["rvq"]
    got = _port_layers(bundle, wav, jidx)
    for (name, r), (name2, g) in zip(ref, got):
        assert name == name2, (name, name2)
        if r.shape != g.shape:
            return name, float("inf"), float(np.abs(r).max())
        if name == "rvq":
            if not np.array_equal(r, g):
                return name, float(np.abs(r.astype(np.int64) - g).max()), float(r.max())
            continue
        err, scale = float(np.abs(g - r).max()), float(np.abs(r).max())
        if err > rtol * scale + atol:
            return name, err, scale
    return None


def describe(result) -> str:
    """A failure message's words for `first_divergence`'s result."""
    if result is None:
        return "no layer diverges (first_divergence: None)"
    name, err, scale = result
    return f"first diverging layer: {name} (max abs diff {err:.3g}, max |nsc_tpu| {scale:.3g})"
