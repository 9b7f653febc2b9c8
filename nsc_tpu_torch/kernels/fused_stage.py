"""One SEANet stage with its boundary convs fused in (K5): the CUDA kernel
`csrc/fused_stage.cu`, its plain PyTorch version, the packers and the
wrapper.

Counterpart of the JAX package's `ops/pallas/residual_stack.py::
fused_stage_ct_pallas` with `pack_head_params` and `pack_tail_params`.
x is (B, C_in, T_in). In order:

  head (optional; an encoder stage after the first): the previous stage's
    down_act, then its causal strided conv, k = 2S, stride S,
    C_in -> C_mid, on a = act(x):
        h[t'] = b + sum_k w[k]^T a[S t' + k - (2S - 1)],  t' < ceil(T_in/S)
    (a is zero outside [0, T_in)); the bias is added to the float32 sum,
    then the result is cast to x's dtype;
  units: K1's chain (`kernels.residual_stack`: in-kernel snake with the
    reciprocal, biases added in float32, residual add in x's dtype), with
    float32 unit weights, not cast to x's dtype;
  tail (optional; a decoder stage before the last): the next stage's
    up_act, then its causal transposed conv, k = 2S, stride S,
    C_mid -> C_out, on a = act(h):
        out[S u + p] = b + w[p]^T a[u] + w[S + p]^T a[u - 1],  a[-1] = 0
    giving (B, C_out, T * S), cast to x's dtype like the head.

Head and tail weights are in x's dtype (the compute dtype); their biases
and alphas are float32. The JAX function's phase decomposition of the
head's input and de-interleave of the tail's output are layout steps for
the TPU's compiler: the function is the same without them.

Packed (`pack`): {"units": pack_stage(units, float32, planes),
  "head": {"w": (2S, C_in, C_mid), "b": (C_mid,), "alpha": (C_in,)},
  "tail": {"w": (S, 2, C_mid, C_out) with w[p, j] = conv tap S*j + p,
           "b": (C_out,), "alpha": (C_mid,)}}; "head"/"tail" only where
the stage has them. The chain is a static rule (`tensor_cores`): bf16 x
with snake_fast where C_mid and C_out are multiples of 16 in [16, 256] and
C_in a multiple of 16 runs the tensor-core chain, which reads the units'
weights as bf16 planes; every other case runs the SIMT chain, which reads
them in float32. `pack` takes the compute dtype and activation and stores
the units' weights in the one form their chain reads. `stage_plan` restates
the kernel's shared-memory planning (`nsc_fused_stage_plan`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from nsc_tpu_torch import kernels
from nsc_tpu_torch.kernels import residual_stack as RS
from nsc_tpu_torch.ops.precision import float32_numerics

Packed = dict


def pack_head(alpha: torch.Tensor, conv: dict, dtype: torch.dtype) -> Packed:
    """down_act alpha (C_in,) + strided down conv {'w': (C_mid, C_in, 2S),
    'b'} -> the head's operands, weight in `dtype`."""
    return {
        "w": conv["w"].permute(2, 1, 0).to(dtype).contiguous(),
        "b": conv["b"].float().contiguous(),
        "alpha": alpha.float().contiguous(),
    }


def pack_tail(alpha: torch.Tensor, conv_t: dict, dtype: torch.dtype) -> Packed:
    """up_act alpha (C_mid,) + transposed up conv {'w': (C_mid, C_out, 2S),
    'b'} -> the tail's operands, weight (S, 2, C_mid, C_out) in `dtype`."""
    w = conv_t["w"].permute(2, 0, 1)  # (2S, C_mid, C_out), tap k = S*j + p
    s = w.shape[0] // 2
    return {
        "w": w.reshape(2, s, *w.shape[1:]).transpose(0, 1).to(dtype).contiguous(),
        "b": conv_t["b"].float().contiguous(),
        "alpha": alpha.float().contiguous(),
    }


def dims(c_mid: int, head: Optional[Packed], tail: Optional[Packed]):
    """(C_out, s_head, s_tail) of a stage from its packed head and tail."""
    s_head = head["w"].shape[0] // 2 if head is not None else 0
    s_tail, c_out = (tail["w"].shape[0], tail["w"].shape[-1]) if tail is not None else (0, c_mid)
    return c_out, s_head, s_tail


def pack(units: Sequence[dict], head: Optional[Packed], tail: Optional[Packed],
         dtype: torch.dtype = torch.float32, fast: bool = False) -> Packed:
    """The stage's operands for a run in compute dtype `dtype` with snake
    (`fast` False) or snake_fast: the units' float32 weights as bf16 planes
    where that run takes the tensor-core chain, else as they are."""
    c_mid = units[0]["conv1"]["w"].shape[0]
    c_in = head["w"].shape[1] if head is not None else c_mid
    c_out, s_head, s_tail = dims(c_mid, head, tail)
    planes = tensor_cores(dtype, fast, c_in, c_mid, c_out, s_head, s_tail)
    p = {"units": RS.pack_stage(units, torch.float32, planes)}
    if head is not None:
        p["head"] = head
    if tail is not None:
        p["tail"] = tail
    return p


@float32_numerics()
def fused_stage_plain(
    x: torch.Tensor, p: Packed, dilations: Sequence[int], fast: bool
) -> torch.Tensor:
    """Plain PyTorch version of K5: same function, same rounding points."""
    dt = x.dtype
    h = x
    head = p.get("head")
    if head is not None:
        w = head["w"].float()  # (2S, C_in, C_mid)
        s = w.shape[0] // 2
        a = RS.act(x, head["alpha"], fast).float()
        y = F.conv1d(F.pad(a, (2 * s - 1, 0)), w.permute(2, 1, 0), stride=s)
        h = (y + head["b"].reshape(1, -1, 1)).to(dt)
    h = RS.unit_chain_plain(h, p["units"], dilations, fast)
    tail = p.get("tail")
    if tail is not None:
        w = tail["w"].float()  # (S, 2, C_mid, C_out)
        s = w.shape[0]
        w = w.transpose(0, 1).reshape(2 * s, *w.shape[2:]).permute(1, 2, 0)
        a = RS.act(h, tail["alpha"], fast).float()
        y = F.conv_transpose1d(a, w, stride=s)[..., : h.shape[-1] * s]
        h = (y + tail["b"].reshape(1, -1, 1)).to(dt)
    return h


HEAD_MI, TAIL_MI, EDGE_KC = 2, 1, 64  # the tensor-core head's and tail's tiling
SLAB_BUDGET, MAX_SLAB_CHANNELS = 16384, 8  # the SIMT head's sample slab


def tensor_cores(dtype: torch.dtype, fast: bool, c_in: int, c_mid: int, c_out: int,
                 s_head: int, s_tail: int) -> bool:
    """Whether the stage takes the tensor-core instantiation."""
    return (RS.tensor_cores(dtype, fast, c_mid, *((c_out,) if s_tail else ()))
            and (not s_head or c_in % 16 == 0))


def stage_plan(c_in: int, c_mid: int, c_out: int, s_head: int, s_tail: int, halo: int,
               dtype: torch.dtype, fast: bool):
    """(tile, shared-memory bytes) of a K5 launch, as the kernel plans it;
    `halo` is the units' sum(2d). Tile 0 if it does not fit."""
    halo += 1 if s_tail else 0
    if tensor_cores(dtype, fast, c_in, c_mid, c_out, s_head, s_tail):
        wbuf = RS.tc_wbuf_bytes(3, RS.units_kc(3, c_mid), c_mid)
        slab = stage = 0
        if s_head:
            wbuf = max(wbuf, RS.tc_wbuf_bytes(1, EDGE_KC, c_mid))
            group = next(g for g in (64, 32, 16) if c_in % g == 0)
            slab = s_head * (RS.tc_rows(c_mid, HEAD_MI) + 1) * group * 2
        if s_tail:
            wbuf = max(wbuf, RS.tc_wbuf_bytes(1, EDGE_KC, c_out))
            stage = s_tail * RS.tc_rows(c_out, TAIL_MI) * (c_out + 8) * 2
        extra = wbuf + max(slab, stage) + RS.tc_consts_bytes(c_mid)
        tile = RS.tc_pick_tile(c_mid, halo, extra)
        return tile, 4 * c_mid * (tile + halo) + extra
    elem = RS.act_bytes(dtype, fast)
    extra = RS.SIMT_KC * max(c_mid, c_out) * 4
    if s_head:
        nc = RS.THREADS // (c_mid // 4) * 8
        per_channel = (s_head * nc + s_head) * 4
        extra += min(max(SLAB_BUDGET // per_channel, 1), MAX_SLAB_CHANNELS) * per_channel
    tile = RS.pick_tile(c_mid, halo, elem, extra)
    return tile, c_mid * (tile + halo) * elem + extra


def _launch(x: torch.Tensor, p: Packed, dilations: Sequence[int], fast: bool):
    from nsc_tpu_torch.kernels import _build

    RS.check_x(x)
    b, c_in, t_in = x.shape
    units, head, tail = p["units"], p.get("head"), p.get("tail")
    c_mid = units["b1"].shape[-1]
    RS.check_supported(c_mid, dilations)
    f32 = torch.float32
    c_out, s_head, s_tail = dims(c_mid, head, tail)
    if head is not None:
        if s_head < 1:
            raise ValueError(f"head weight must be (2S, C_in, C_mid), got {tuple(head['w'].shape)}")
        RS.check_tensors({"w": ((2 * s_head, c_in, c_mid), x.dtype), "b": ((c_mid,), f32),
                          "alpha": ((c_in,), f32)}, head, x.device)
    elif c_in != c_mid:
        raise ValueError(f"without a head x must have the units' {c_mid} channels, got {c_in}")
    if tail is not None:
        if s_tail < 1:
            raise ValueError(f"tail weight must be (S, 2, C_mid, C_out), got {tuple(tail['w'].shape)}")
        RS.check_width(c_out)
        RS.check_tensors({"w": ((s_tail, 2, c_mid, c_out), x.dtype), "b": ((c_out,), f32),
                          "alpha": ((c_mid,), f32)}, tail, x.device)
    planes = tensor_cores(x.dtype, fast, c_in, c_mid, c_out, s_head, s_tail)
    if planes:
        RS.check_planes(units, "nsc_fused_stage")
    RS.check_tensors(RS.units_spec(len(dilations), c_mid, f32, planes), units, x.device)
    RS.check_plan(stage_plan(c_in, c_mid, c_out, s_head, s_tail, sum(2 * d for d in dilations),
                             x.dtype, fast)[0], "nsc_fused_stage")
    t_u = -(-t_in // max(s_head, 1))
    out = torch.empty(b, c_out, t_u * max(s_tail, 1), dtype=x.dtype, device=x.device)
    if out.numel() == 0:
        return out

    def ptr(part, name):
        return None if part is None else part[name].data_ptr()

    dil = RS.dilation_array(dilations)
    err = _build.library().nsc_fused_stage(
        x.data_ptr(), out.data_ptr(),
        ptr(head, "w"), ptr(head, "b"), ptr(head, "alpha"),
        *RS.unit_pointers(units), *RS.plane_pointers(units, planes),
        ptr(tail, "alpha"), ptr(tail, "w"), ptr(tail, "b"),
        ctypes.cast(dil, ctypes.c_void_p),
        b, c_in, c_mid, c_out, t_in, len(dilations), s_head, s_tail,
        int(x.dtype == torch.bfloat16), int(fast),
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "nsc_fused_stage")
    kernels.LAUNCHES["fused_stage"] += 1
    return out


def fused_stage(
    x: torch.Tensor, p: Packed, dilations: Sequence[int], fast: bool
) -> torch.Tensor:
    """K5: x (B, C_in, T_in) -> (B, C_out, ceil(T_in/S_head) * S_tail)."""
    if not RS.on_card("fused_stage", x):
        return fused_stage_plain(x, p, dilations, fast)
    return _launch(x, p, tuple(int(d) for d in dilations), bool(fast))
