"""1D convolution and activation ops over the port's (N, C, T) layout.

Counterpart of `nsc_tpu/ops/conv.py`, with the same numerics:

  * weight-norm is materialized as w = v * g / sqrt(sum(v^2) + 1e-12) over
    the (K, Cin) axes, in float32 (`materialize_weight`, on the JAX
    package's (K, Cin, Cout) layout; `nsc_tpu_torch.weights` then lays the
    result out for PyTorch);
  * a conv casts its weight to the activation dtype and adds the bias after
    the conv, in the activation dtype (not fused into the conv);
  * causal padding is left-padding by (K-1)*dilation; 'same' puts the
    smaller half on the left;
  * a transposed conv produces the full (T-1)*stride + K output and trims
    K - stride samples: on the right when causal, split over both edges
    otherwise, so the output length is exactly T*stride;
  * `snake_fast` reproduces the JAX op's dtype order: alpha is cast to x's
    dtype before alpha*x, the polynomial runs in float32 and returns x's
    dtype, and 1/(alpha+1e-9) is computed in float32, then cast.

Weights: conv (Cout, Cin, K), transposed conv (Cin, Cout, K), bias (Cout,),
snake alpha (C,), all float32.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]

# Constants rounded to float32 once, so a product with a float32 tensor gives
# the same bits whether PyTorch evaluates it in float32 or in double.
_INV_PI = float(np.float32(1.0 / math.pi))
_PI = float(np.float32(math.pi))
# Chebyshev-node fit of sin^2(sqrt(u))/u on u in [0, (pi/2)^2] (the JAX
# package's `_SIN_SQ_C*`): u*Q3(u) approximates sin^2 of the reduced argument.
SIN_SQ_C3 = float(np.float32(-0.00254553))
SIN_SQ_C2 = float(np.float32(0.04350543))
SIN_SQ_C1 = float(np.float32(-0.33287596))
SIN_SQ_C0 = float(np.float32(0.99996482))


def materialize_weight(params: Params) -> torch.Tensor:
    """Resolve a weight-norm (v, g) pair, or a plain 'w', to a concrete
    float32 (K, Cin, Cout) weight (the JAX package's layout)."""
    if "w" in params:
        return params["w"].float()
    v, g = params["v"].float(), params["g"].float()
    norm = torch.sqrt(torch.sum(v * v, dim=(0, 1), keepdim=True) + 1e-12)
    return v * (g[None, None, :] / norm)


def _with_scale(out: Params, p: Params) -> Params:
    """Carry an int8 calibration leaf ("a_s", `ops.quant`) across."""
    if "a_s" in p:
        out["a_s"] = p["a_s"]
    return out


def conv_params(p: Params) -> Params:
    """A conv in the JAX package's layout ({'v', 'g', 'b'} or {'w', 'b'},
    weight (K, Cin, Cout), and an "a_s" leaf if calibrated) -> {'w': (Cout,
    Cin, K), 'b'[, 'a_s']}. Differentiable: training materializes
    weight-norm on every step through it."""
    return _with_scale({"w": materialize_weight(p).permute(2, 1, 0).contiguous(), "b": p["b"]}, p)


def conv_transpose_params(p: Params) -> Params:
    """A transposed conv in the JAX package's layout -> {'w': (Cin, Cout, K),
    'b'[, 'a_s']}; the weight-norm is per output channel, as in the JAX
    package."""
    return _with_scale({"w": materialize_weight(p).permute(1, 2, 0).contiguous(), "b": p["b"]}, p)


def conv1d(
    x: torch.Tensor, p: Params, *, stride: int = 1, dilation: int = 1,
    padding: str = "causal",
) -> torch.Tensor:
    """(N, Cin, T) -> (N, Cout, T'). padding: 'causal' | 'same' | 'valid'."""
    w = p["w"]
    eff = (w.shape[-1] - 1) * dilation
    if padding == "causal":
        pads = (eff, 0)
    elif padding == "same":
        pads = (eff // 2, eff - eff // 2)
    elif padding == "valid":
        pads = (0, 0)
    else:
        raise ValueError(f"bad padding {padding!r}")
    if pads != (0, 0):
        x = F.pad(x, pads)
    y = F.conv1d(x, w.to(x.dtype), stride=stride, dilation=dilation)
    if "b" in p:
        y = y + p["b"].to(y.dtype)[None, :, None]
    return y


def conv_transpose1d(
    x: torch.Tensor, p: Params, *, stride: int, causal: bool = True
) -> torch.Tensor:
    """(N, Cin, T) -> (N, Cout, T*stride) transposed conv (upsampling)."""
    w = p["w"]
    k = w.shape[-1]
    if k < stride:
        raise ValueError("kernel must be >= stride for exact-length upsampling")
    y = F.conv_transpose1d(x, w.to(x.dtype), stride=stride)
    trim = k - stride
    if trim > 0:
        if causal:
            y = y[..., :-trim]
        else:
            left = trim // 2
            y = y[..., left : left + x.shape[-1] * stride]
    if "b" in p:
        y = y + p["b"].to(y.dtype)[None, :, None]
    return y


def _col(alpha: torch.Tensor) -> torch.Tensor:
    return alpha.reshape(1, -1, 1)


def snake(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """x + sin^2(alpha*x)/alpha, per-channel alpha, in x's dtype."""
    a = _col(alpha).to(x.dtype)
    s = torch.sin(a * x)
    return x + s * s / (a + 1e-9)


def sin_sq_poly(f: torch.Tensor) -> torch.Tensor:
    """sin^2(f) for float32 f: one round-half-even range reduction to
    [-pi/2, pi/2], then the even polynomial u*Q3(u), u = r^2."""
    r = f - torch.round(f * _INV_PI) * _PI
    u = r * r
    q = SIN_SQ_C0 + u * (SIN_SQ_C1 + u * (SIN_SQ_C2 + u * SIN_SQ_C3))
    return u * q


def snake_fast(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Snake with the polynomial sin^2 (the standalone form of the JAX
    package's `ops.conv.snake_fast`)."""
    a32 = _col(alpha).float()
    inv = (1.0 / (a32 + 1e-9)).to(x.dtype)
    t = a32.to(x.dtype) * x
    return x + sin_sq_poly(t.float()).to(x.dtype) * inv


def activation(
    name: str, x: torch.Tensor, alpha: Optional[torch.Tensor]
) -> torch.Tensor:
    if name == "snake":
        return snake(x, alpha)
    if name == "snake_fast":
        return snake_fast(x, alpha)
    if name == "elu":
        return F.elu(x)
    raise ValueError(f"unknown activation {name!r}")
