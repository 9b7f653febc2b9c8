"""Residual-unit stack of one SEANet stage: the CUDA kernels
`csrc/residual_stack.cu` (K1, (B, C, T)) and `csrc/residual_stack_cl.cu`
(K6, channels last), their plain PyTorch versions, and the wrappers.

For each unit u with dilation d:

    x += W2[u] . act(W1[u] *_d act(x) + b1[u]) + b2[u]

where `*_d` is a causal dilated k=3 C->C conv (zero input for t < 0), W2 is
1x1 and act is snake or snake_fast with per-unit alphas.

K1 follows the JAX package's `ops/pallas/residual_stack.py::
residual_stack_ct_pallas` (x (B, C, T)):

  * weights are in x's dtype; products accumulate in float32; each bias is
    added to the float32 sum, which is then cast to x's dtype;
  * snake_fast (the in-kernel form) computes alpha*x, the polynomial and
    1/(alpha+1e-9) in float32 and casts only the term (u*q)*inv to x's dtype
    before the add; the activation is in x's dtype;
  * snake computes in float32 and its result stays float32 (x promotes);
  * the residual add is in x's dtype.

K6 follows `residual_stack_pallas` (x (B, T, C)), which differs from K1 in
two rounding points:

  * snake_fast divides, (u*q) / (alpha+1e-9), where K1 multiplies by the
    reciprocal;
  * the weights stay float32 (`pack_stage(units, torch.float32)`), so in
    bf16 serving a product is a bf16 activation times a float32 weight,
    summed in float32. This is what the JAX package computes on the CPU
    under "highest" matmul precision, which its tests use; the TPU's
    default dot precision would round the weights to bf16.

Parameters are packed per stage by `pack_stage`: w1 (U, 3, Cin, Cout) and
w2 (U, Cin, Cout) in the weight dtype; b1, a1, b2, a2 (U, C) float32.
The plain versions run their float32 convolutions under
`float32_numerics()` (no TF32), as the kernels' sums are true float32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from nsc_tpu_torch import kernels
from nsc_tpu_torch.ops.conv import sin_sq_poly
from nsc_tpu_torch.ops.precision import float32_numerics

Packed = Dict[str, torch.Tensor]


def pack_stage(units: Sequence[dict], dtype: torch.dtype) -> Packed:
    """Stack a stage's residual-unit params (port layout: conv weights
    (Cout, Cin, K)) into the kernels' layout, weights in `dtype`."""
    return {
        "w1": torch.stack([u["conv1"]["w"].permute(2, 1, 0) for u in units])
        .to(dtype).contiguous(),
        "b1": torch.stack([u["conv1"]["b"] for u in units]).float().contiguous(),
        "a1": torch.stack([u["act1"] for u in units]).float().contiguous(),
        "w2": torch.stack([u["conv2"]["w"][:, :, 0].t() for u in units])
        .to(dtype).contiguous(),
        "b2": torch.stack([u["conv2"]["b"] for u in units]).float().contiguous(),
        "a2": torch.stack([u["act2"] for u in units]).float().contiguous(),
    }


def act(x: torch.Tensor, alpha: torch.Tensor, fast: bool, divide: bool = False) -> torch.Tensor:
    """The in-kernel activation of x (B, C, T); alpha (C,) float32.
    snake_fast returns x's dtype, snake float32 (see module doc);
    `divide` selects K6's (u*q)/(alpha+eps) over K1's (u*q)*inv."""
    a = alpha.float().reshape(1, -1, 1)
    if fast:
        sq = sin_sq_poly(a * x.float())
        term = sq / (a + 1e-9) if divide else sq * (1.0 / (a + 1e-9))
        return x + term.to(x.dtype)
    s = torch.sin(a * x.float())
    return x.float() + s * s / (a + 1e-9)


def unit_chain_plain(
    x: torch.Tensor, p: Packed, dilations: Sequence[int], fast: bool,
    divide: bool = False,
) -> torch.Tensor:
    """The units on x (B, C, T) with the packed weights as they are (their
    dtype's values, products in float32): the plain body of K1, K5 and K6.
    Run it under `float32_numerics()`."""
    dt = x.dtype
    w1, w2 = p["w1"].float(), p["w2"].float()
    h = x
    for u, d in enumerate(dilations):
        a = act(h, p["a1"][u], fast, divide).float()
        y = F.conv1d(F.pad(a, (2 * d, 0)), w1[u].permute(2, 1, 0), dilation=d)
        y = (y + p["b1"][u].reshape(1, -1, 1)).to(dt)
        a2 = act(y, p["a2"][u], fast, divide).float()
        z = F.conv1d(a2, w2[u].t()[:, :, None])
        z = (z + p["b2"][u].reshape(1, -1, 1)).to(dt)
        h = h + z
    return h


@float32_numerics()
def residual_stack_plain(
    x: torch.Tensor, p: Packed, dilations: Sequence[int], fast: bool
) -> torch.Tensor:
    """Plain PyTorch version of K1: same function, same rounding points,
    weights rounded to x's dtype."""
    q = {**p, "w1": p["w1"].to(x.dtype), "w2": p["w2"].to(x.dtype)}
    return unit_chain_plain(x, q, dilations, fast)


@float32_numerics()
def residual_stack_cl_plain(
    x: torch.Tensor, p: Packed, dilations: Sequence[int], fast: bool
) -> torch.Tensor:
    """Plain PyTorch version of K6: x (B, T, C) -> (B, T, C), float32
    weights, snake_fast by division."""
    h = unit_chain_plain(x.transpose(1, 2), p, dilations, fast, divide=True)
    return h.transpose(1, 2).contiguous()


MAX_UNITS = 8
MAX_CHANNELS = 1024


def check_supported(c: int, dilations: Sequence[int]) -> None:
    """Raise on a stage the CUDA kernels cannot take."""
    if not 1 <= len(dilations) <= MAX_UNITS:
        raise ValueError(f"the residual-unit kernels take 1..{MAX_UNITS} units")
    if any(d < 1 for d in dilations):
        raise ValueError(f"dilations must be >= 1, got {dilations}")
    check_width(c)


def check_width(c: int) -> None:
    if c % 4 or not 4 <= c <= MAX_CHANNELS:
        raise ValueError(
            f"the residual-unit kernels need C % 4 == 0 and 4 <= C <= "
            f"{MAX_CHANNELS}, got C={c}"
        )


def check_tensors(want: dict, p: Packed, device: torch.device) -> None:
    """Each p[name] must have want[name] = (shape, dtype) and be contiguous
    on `device`."""
    for name, (shape, dtype) in want.items():
        ten = p[name]
        if tuple(ten.shape) != tuple(shape) or ten.dtype != dtype:
            raise ValueError(
                f"{name}: want {tuple(shape)} {dtype}, got {tuple(ten.shape)} {ten.dtype}"
            )
        if ten.device != device or not ten.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {device}")


def check_x(x: torch.Tensor) -> None:
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous 3-d tensor, got {tuple(x.shape)}")


def units_spec(u: int, c: int, wdtype: torch.dtype) -> dict:
    """The packed units' shapes and dtypes (see `pack_stage`)."""
    f32 = torch.float32
    return {
        "w1": ((u, 3, c, c), wdtype), "w2": ((u, c, c), wdtype),
        "b1": ((u, c), f32), "a1": ((u, c), f32),
        "b2": ((u, c), f32), "a2": ((u, c), f32),
    }


def unit_pointers(p: Packed) -> list:
    return [p[k].data_ptr() for k in ("w1", "b1", "a1", "w2", "b2", "a2")]


def dilation_array(dilations: Sequence[int]):
    """A host int array for a C entry point (pass it through `ctypes.cast`)."""
    return (ctypes.c_int * len(dilations))(*dilations)


def _launch(entry: str, counter: str, x: torch.Tensor, p: Packed,
            dilations: Sequence[int], fast: bool, channels_last: bool,
            wdtype: torch.dtype):
    """Launch K1 (x (B, C, T)) or K6 (x (B, T, C), `channels_last`)."""
    from nsc_tpu_torch.kernels import _build

    check_x(x)
    b, c, t = (x.shape[0], x.shape[2], x.shape[1]) if channels_last else x.shape
    check_supported(c, dilations)
    check_tensors(units_spec(len(dilations), c, wdtype), p, x.device)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    dil = dilation_array(dilations)
    err = getattr(_build.library(), entry)(
        x.data_ptr(), out.data_ptr(), *unit_pointers(p),
        ctypes.cast(dil, ctypes.c_void_p),
        b, c, t, len(dilations), int(x.dtype == torch.bfloat16), int(fast),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, entry)
    kernels.LAUNCHES[counter] += 1
    return out


def on_card(name: str, x: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (the
    plain version); raises on any other device."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")
    return x.device.type == "cuda"


def residual_stack(
    x: torch.Tensor, p: Packed, dilations: Sequence[int], fast: bool
) -> torch.Tensor:
    """K1: x (B, C, T) -> (B, C, T) through all residual units of one stage;
    weights in x's dtype."""
    if not on_card("residual_stack", x):
        return residual_stack_plain(x, p, dilations, fast)
    return _launch("nsc_residual_stack", "residual_stack", x, p,
                   tuple(int(d) for d in dilations), bool(fast), False, x.dtype)


def residual_stack_cl(
    x: torch.Tensor, p: Packed, dilations: Sequence[int], fast: bool
) -> torch.Tensor:
    """K6: x (B, T, C) -> (B, T, C) through all residual units of one
    stage; float32 weights."""
    if not on_card("residual_stack_cl", x):
        return residual_stack_cl_plain(x, p, dilations, fast)
    return _launch("nsc_residual_stack_cl", "residual_stack_cl", x, p,
                   tuple(int(d) for d in dilations), bool(fast), True, torch.float32)
