"""Residual-unit stack of one SEANet stage: the CUDA kernel
`csrc/residual_stack.cu`, its plain PyTorch version, and the wrapper.

For each unit u with dilation d (x is (B, C, T)):

    x += W2[u] . act(W1[u] *_d act(x) + b1[u]) + b2[u]

where `*_d` is a causal dilated k=3 C->C conv (zero input for t < 0), W2 is
1x1 and act is snake or snake_fast with per-unit alphas. Numerics follow the
JAX package's `ops/pallas/residual_stack.py::residual_stack_ct_pallas`:

  * weights are in x's dtype; products accumulate in float32; each bias is
    added to the float32 sum, which is then cast to x's dtype;
  * snake_fast (the in-kernel form) computes alpha*x, the polynomial and
    1/(alpha+1e-9) in float32 and casts only the term (u*q)*inv to x's dtype
    before the add; the activation is in x's dtype;
  * snake computes in float32 and its result stays float32 (x promotes);
  * the residual add is in x's dtype.

Parameters are packed per stage by `pack_stage`: w1 (U, 3, Cin, Cout) and
w2 (U, Cin, Cout) in x's dtype; b1, a1, b2, a2 (U, C) float32.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch
import torch.nn.functional as F

from nsc_tpu_torch import kernels
from nsc_tpu_torch.ops.conv import sin_sq_poly

Packed = Dict[str, torch.Tensor]


def pack_stage(units: Sequence[dict], dtype: torch.dtype) -> Packed:
    """Stack a stage's residual-unit params (port layout: conv weights
    (Cout, Cin, K)) into the kernel's layout."""
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


def _act(x: torch.Tensor, alpha: torch.Tensor, fast: bool) -> torch.Tensor:
    """The in-kernel activation (see module doc); alpha (C,) float32."""
    a = alpha.float().reshape(1, -1, 1)
    if fast:
        term = (sin_sq_poly(a * x.float()) * (1.0 / (a + 1e-9))).to(x.dtype)
        return x + term
    s = torch.sin(a * x.float())
    return x.float() + s * s / (a + 1e-9)


def residual_stack_plain(
    x: torch.Tensor, p: Packed, dilations: Sequence[int], fast: bool
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: same function, same rounding
    points, float32 convs (TF32 must be off when run on a card)."""
    dt = x.dtype
    w1, w2 = p["w1"].to(dt).float(), p["w2"].to(dt).float()
    h = x
    for u, d in enumerate(dilations):
        a = _act(h, p["a1"][u], fast).float()
        y = F.conv1d(F.pad(a, (2 * d, 0)), w1[u].permute(2, 1, 0), dilation=d)
        y = (y + p["b1"][u].reshape(1, -1, 1)).to(dt)
        a2 = _act(y, p["a2"][u], fast).float()
        z = F.conv1d(a2, w2[u].t()[:, :, None])
        z = (z + p["b2"][u].reshape(1, -1, 1)).to(dt)
        h = h + z
    return h


MAX_UNITS = 8
MAX_CHANNELS = 1024


def check_supported(c: int, dilations: Sequence[int]) -> None:
    """Raise on a stage the CUDA kernel cannot take."""
    if not 1 <= len(dilations) <= MAX_UNITS:
        raise ValueError(f"residual_stack kernel takes 1..{MAX_UNITS} units")
    if any(d < 1 for d in dilations):
        raise ValueError(f"dilations must be >= 1, got {dilations}")
    if c % 4 or not 4 <= c <= MAX_CHANNELS:
        raise ValueError(
            f"residual_stack kernel needs C % 4 == 0 and 4 <= C <= "
            f"{MAX_CHANNELS}, got C={c}"
        )


def _launch(x: torch.Tensor, p: Packed, dilations: Sequence[int], fast: bool):
    from nsc_tpu_torch.kernels import _build

    b, c, t = x.shape
    u = len(dilations)
    check_supported(c, dilations)
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"x must be bfloat16 or float32, got {x.dtype}")
    want = {
        "w1": ((u, 3, c, c), x.dtype), "w2": ((u, c, c), x.dtype),
        "b1": ((u, c), torch.float32), "a1": ((u, c), torch.float32),
        "b2": ((u, c), torch.float32), "a2": ((u, c), torch.float32),
    }
    for name, (shape, dtype) in want.items():
        ten = p[name]
        if tuple(ten.shape) != shape or ten.dtype != dtype:
            raise ValueError(
                f"{name}: want {shape} {dtype}, got {tuple(ten.shape)} {ten.dtype}"
            )
        if ten.device != x.device or not ten.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x.device}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous (B, C, T)")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _build.library()
    dil = (ctypes.c_int * u)(*dilations)
    err = lib.nsc_residual_stack(
        x.data_ptr(), out.data_ptr(), p["w1"].data_ptr(), p["b1"].data_ptr(),
        p["a1"].data_ptr(), p["w2"].data_ptr(), p["b2"].data_ptr(),
        p["a2"].data_ptr(), ctypes.cast(dil, ctypes.c_void_p),
        b, c, t, u, int(x.dtype == torch.bfloat16), int(fast),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "nsc_residual_stack")
    kernels.LAUNCHES["residual_stack"] += 1
    return out


def residual_stack(
    x: torch.Tensor, p: Packed, dilations: Sequence[int], fast: bool
) -> torch.Tensor:
    """x (B, C, T) -> (B, C, T) through all residual units of one stage."""
    if x.device.type == "cpu":
        return residual_stack_plain(x, p, dilations, fast)
    if x.device.type == "cuda":
        return _launch(x, p, tuple(int(d) for d in dilations), bool(fast))
    raise ValueError(f"residual_stack: unsupported device {x.device}")
