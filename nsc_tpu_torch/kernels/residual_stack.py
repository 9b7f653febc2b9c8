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

Parameters are packed per stage by `pack_stage`: b1, a1, b2, a2 (U, C)
float32, and either w1 (U, 3, Cin, Cout) and w2 (U, Cin, Cout) in the
weight dtype or, for float32 weights that feed the tensor cores
(`planes=True`, which the packer's caller takes from `tensor_cores`), w1p
(3, U, 3, Cin, Cout) and w2p (3, U, Cin, Cout): each weight split into three
bf16 planes hi + mid + lo == w (`split_planes`), which the plain versions
sum back to w exactly (`unit_weights`).
The plain versions run their float32 convolutions under
`float32_numerics()` (no TF32), as the kernels' sums are true float32.

Which chain a launch runs is a static rule (`tensor_cores`): bf16 x with
snake_fast at widths C % 16 == 0, 16 <= C <= 256 runs the tensor-core chain
(bf16 weights: one MMA per product; float32 weights: three, one per plane),
every other case the SIMT chain. `stack_plan` restates the kernels'
shared-memory planning (`nsc_stack_plan`, which a card test holds it to),
so a shape that cannot fit raises before launch.
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


def split_planes(w: torch.Tensor) -> torch.Tensor:
    """float32 w -> (3, *w.shape) bf16 planes hi, mid, lo with hi + mid + lo
    == w exactly in float32. Each plane keeps the top 8 significant bits of
    what the planes before it left (truncation, so hi never overflows), and
    a bf16 x bf16 product is exact in float32, so three MMAs into one
    float32 sum give a * w exactly, up to the order of the sum. Exact for
    w == 0 and every |w| >= 2^-110; below that, residual bits under bf16's
    smallest subnormal (2^-133) are lost."""
    w = w.float().contiguous()

    def trunc(v):
        return (v.view(torch.int32) & -65536).view(torch.float32)

    hi = trunc(w)
    rest = w - hi
    mid = trunc(rest)
    return torch.stack([hi, mid, rest - mid]).to(torch.bfloat16).contiguous()


def pack_stage(units: Sequence[dict], dtype: torch.dtype, planes: bool = False) -> Packed:
    """Stack a stage's residual-unit params (port layout: conv weights
    (Cout, Cin, K)) into the kernels' layout, weights in `dtype`; with
    `planes` (float32 weights only) the weights are stored as their bf16
    planes w1p and w2p, which the tensor-core chain of K5 and K6 reads, in
    place of w1 and w2."""
    p = {
        "w1": torch.stack([u["conv1"]["w"].permute(2, 1, 0) for u in units])
        .to(dtype).contiguous(),
        "b1": torch.stack([u["conv1"]["b"] for u in units]).float().contiguous(),
        "a1": torch.stack([u["act1"] for u in units]).float().contiguous(),
        "w2": torch.stack([u["conv2"]["w"][:, :, 0].t() for u in units])
        .to(dtype).contiguous(),
        "b2": torch.stack([u["conv2"]["b"] for u in units]).float().contiguous(),
        "a2": torch.stack([u["act2"] for u in units]).float().contiguous(),
    }
    if planes:
        if dtype != torch.float32:
            raise ValueError("weight planes split float32 weights only")
        p["w1p"], p["w2p"] = split_planes(p.pop("w1")), split_planes(p.pop("w2"))
    return p


def unit_weights(p: Packed):
    """(w1, w2) of packed units in float32: the weights, or the exact sum of
    their planes."""
    if "w1p" in p:
        return tuple((q[0].float() + q[1].float()) + q[2].float() for q in (p["w1p"], p["w2p"]))
    return p["w1"].float(), p["w2"].float()


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
    w1, w2 = unit_weights(p)
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

# Shared-memory planning, as `csrc/stage_units.cuh` does it: a block of
# THREADS threads. The SIMT chain's time tile is the largest multiple of 32
# (at most 1024) that fits first within TWO_BLOCKS (two blocks per SM), then
# within MAX_SMEM, beside the weight stages; the tensor-core chain's is
# `tc_pick_tile`.
MAX_SMEM = 232448
TWO_BLOCKS = 112 * 1024
THREADS, WARPS = 256, 8
SIMT_KC = 16  # SIMT chain: float32 weight rows staged per step
TC_NJ = 4     # tensor-core chain: n8 tiles per warp, at most
TC_MI_UNITS = 4


def tensor_cores(dtype: torch.dtype, fast: bool, *widths: int) -> bool:
    """The static rule: bf16 x with snake_fast runs the tensor-core chain
    when every width (the units' C, and K5's C_out) is a multiple of 16 in
    [16, 256]; everything else runs the SIMT chain."""
    return (dtype == torch.bfloat16 and fast
            and all(16 <= w <= 256 and w % 16 == 0 for w in widths))


def units_kc(planes: int, c: int) -> int:
    """Tensor-core weight rows per pipeline stage (`units_kc` in the header)."""
    return 16 if planes == 3 and c > 128 else 32


def tc_rows(n: int, mi: int) -> int:
    """Rows of one output chunk of the tensor-core tiling of width n."""
    wn = -(-(n // 8) // TC_NJ)
    return WARPS // wn * 16 * mi


def tc_wbuf_bytes(planes: int, kc: int, n: int) -> int:
    return 2 * planes * kc * (n + 8) * 2


def tc_consts_bytes(c: int) -> int:
    """The tensor-core chain's per-unit constants: 6 floats per channel."""
    return 6 * 4 * c


def pick_tile(c: int, halo: int, elem_bytes: int, extra: int) -> int:
    """The time tile (`pick_tile` in the header); 0 if nothing fits."""
    last = 0
    for budget in (TWO_BLOCKS, MAX_SMEM):
        if budget <= extra:
            continue
        last = (budget - extra) // (c * elem_bytes) - halo
        if last >= 32:
            return 1024 if last > 1024 else last // 32 * 32
    return last if last >= 1 else 0


def tc_pick_tile(c: int, halo: int, extra: int) -> int:
    """The time tile of a tensor-core kernel (`tc_pick_tile` in the header):
    one block per SM, so the whole MAX_SMEM, at most 1024 + halo rows, cut
    to 2 + a multiple of the units' chunk rows where that wastes fewer
    computed rows per output; 0 if nothing fits."""
    if extra >= MAX_SMEM:
        return 0
    rows = min((MAX_SMEM - extra) // (4 * c), 1024 + halo)
    if rows - halo < 1:
        return 0
    mt = tc_rows(c, TC_MI_UNITS)
    aligned = (rows - 2) // mt * mt + 2
    cost_rows = -(-(rows - 2) // mt) * mt
    if aligned - halo >= 1 and (aligned - halo) * cost_rows > (rows - halo) * (aligned - 2):
        rows = aligned
    return rows - halo


def act_bytes(dtype: torch.dtype, fast: bool) -> int:
    """Bytes of one element of the stream plus one of the activations."""
    return dtype.itemsize + (dtype.itemsize if fast else 4)


def stack_plan(c: int, halo: int, dtype: torch.dtype, fast: bool, planes: int):
    """(tile, shared-memory bytes) of a K1 (planes=1) or K6 (planes=3)
    launch; tile 0 if it does not fit."""
    if tensor_cores(dtype, fast, c):
        extra = tc_wbuf_bytes(planes, units_kc(planes, c), c) + tc_consts_bytes(c)
        tile = tc_pick_tile(c, halo, extra)
        return tile, 4 * c * (tile + halo) + extra
    extra = SIMT_KC * c * 4
    elem = act_bytes(dtype, fast)
    tile = pick_tile(c, halo, elem, extra)
    return tile, c * (tile + halo) * elem + extra


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


def check_plan(tile: int, what: str) -> None:
    if tile < 1:
        raise ValueError(f"{what}: the stage does not fit one block's {MAX_SMEM} bytes "
                         f"of shared memory")


def check_tensors(want: dict, p: Packed, device: torch.device) -> None:
    """Each p[name] must have want[name] = (shape, dtype) and be contiguous
    on `device`."""
    for name, (shape, dtype) in want.items():
        if name not in p:
            raise ValueError(f"{name}: missing from the packed weights")
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


def units_spec(u: int, c: int, wdtype: torch.dtype, planes: bool = False) -> dict:
    """The packed units' shapes and dtypes (see `pack_stage`)."""
    f32 = torch.float32
    if planes:
        spec = {"w1p": ((3, u, 3, c, c), torch.bfloat16), "w2p": ((3, u, c, c), torch.bfloat16)}
    else:
        spec = {"w1": ((u, 3, c, c), wdtype), "w2": ((u, c, c), wdtype)}
    spec.update({"b1": ((u, c), f32), "a1": ((u, c), f32), "b2": ((u, c), f32), "a2": ((u, c), f32)})
    return spec


def check_planes(p: Packed, what: str) -> None:
    if "w1p" not in p or "w2p" not in p:
        raise ValueError(f"{what}: bf16 x with snake_fast runs the tensor-core chain, which "
                         f"needs the weight planes (pack_stage(..., planes=True))")


def plane_pointers(p: Packed, on: bool) -> list:
    return [p["w1p"].data_ptr(), p["w2p"].data_ptr()] if on else [None, None]


def unit_pointers(p: Packed) -> list:
    """The units' pointers in the C entry points' order; null for weights
    stored as planes."""
    return [p[k].data_ptr() if k in p else None for k in ("w1", "b1", "a1", "w2", "b2", "a2")]


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
    # K6's tensor-core chain reads the float32 weights' bf16 planes
    planes = channels_last and tensor_cores(x.dtype, fast, c)
    if planes:
        check_planes(p, entry)
        if x.data_ptr() % 16:
            raise ValueError(f"{entry}: x must be 16-byte aligned")
    check_tensors(units_spec(len(dilations), c, wdtype, planes), p, x.device)
    check_plan(stack_plan(c, sum(2 * d for d in dilations), x.dtype, fast,
                          3 if channels_last else 1)[0], entry)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    dil = dilation_array(dilations)
    extra = plane_pointers(p, planes) if channels_last else []
    err = getattr(_build.library(), entry)(
        x.data_ptr(), out.data_ptr(), *unit_pointers(p), *extra,
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
