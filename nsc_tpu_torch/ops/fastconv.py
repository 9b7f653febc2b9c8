"""Convolutions as one large matrix product each (counterpart of
`nsc_tpu/ops/fastconv.py`; `conv_backend="stacked"`).

  * dilation d      -> phase decomposition: d interleaved streams, each a
                       dense (dilation-1) conv. Exact, no extra FLOPs.
  * stride-1 conv   -> output stacking: S consecutive outputs become one
                       matmul row block against a block-Toeplitz weight
                       ((S + k - 1) * Cin x S * Cout).
  * strided conv    -> the same stacking with stride-aligned context groups.
  * transposed conv -> polyphase synthesis: all `stride` output phases of a
                       frame from one matmul (ceil(k/s) input frames x
                       s * Cout).

Each is the same float sums as `ops.conv` with the taps in another order
inside a dot product. The product is one `torch.matmul` in float32 (the
operands in the activation dtype, as the JAX package's dot_general with a
float32 accumulator), cast back to the activation dtype; the bias is added
after, as in `ops.conv`. Plain PyTorch, differentiable. Public layouts are
the port's: x (N, C, T), conv weight (Cout, Cin, K), transposed conv weight
(Cin, Cout, K); inside, the JAX package's (N, T, C) and (K, Cin, Cout).

Shape constraints (asserted, as in the JAX package): T divisible by the
stride, and the kernel's context within one stack of outputs.
"""

from __future__ import annotations

import functools
import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


@functools.lru_cache(maxsize=256)
def _toeplitz_map(k: int, stride: int, stack: int, ctx_len: int, window: int):
    """(window, stack) tap index and validity of the block-Toeplitz weight:
    output slot q at window row j uses tap j - ctx_len - q*stride + (k-1)
    when 0 <= tap < k."""
    j = np.arange(window)[:, None]
    q = np.arange(stack)[None, :]
    tap = j - ctx_len - q * stride + (k - 1)
    valid = (tap >= 0) & (tap < k)
    return np.clip(tap, 0, k - 1), valid


def _block_toeplitz(w: torch.Tensor, stride: int, stack: int, ctx_len: int) -> torch.Tensor:
    """w (k, Cin, Cout) -> (window, Cin, stack, Cout) block weight."""
    k = w.shape[0]
    window = ctx_len + stack * stride
    tap, valid = _toeplitz_map(k, stride, stack, ctx_len, window)
    wb = w[torch.from_numpy(tap).to(w.device)]  # (window, stack, Cin, Cout)
    wb = wb * torch.from_numpy(valid).to(w.device, w.dtype)[:, :, None, None]
    return wb.permute(0, 2, 1, 3)


def _matmul(a: torch.Tensor, b: torch.Tensor, dtype) -> torch.Tensor:
    return torch.matmul(a.float(), b.float()).to(dtype)


def _stacked(x: torch.Tensor, w: torch.Tensor, stride: int, dilation: int,
             stack: int) -> torch.Tensor:
    """x (N, T, Cin), w (K, Cin, Cout) in x's dtype -> (N, T/stride, Cout),
    without the bias."""
    k = w.shape[0]
    if dilation > 1:
        assert stride == 1, "dilated strided convs not used by this model"
        b, t, c = x.shape
        pad_t = (-t) % dilation
        if pad_t:
            # right-pad to a phase multiple: future zeros cannot reach causal
            # outputs, so trimming afterwards is exact
            return _stacked(F.pad(x, (0, 0, 0, pad_t)), w, 1, dilation, stack)[:, :t]
        xs = x.reshape(b, t // dilation, dilation, c).transpose(1, 2).reshape(
            b * dilation, t // dilation, c)
        y = _stacked(xs, w, 1, 1, stack)
        co = y.shape[-1]
        return y.reshape(b, dilation, t // dilation, co).transpose(1, 2).reshape(b, t, co)

    b, t, c = x.shape
    co = w.shape[2]
    s = stride
    assert t % s == 0, (t, s)
    t_out = t // s
    stack = min(stack, t_out)
    pad_t = (-t_out % stack) * s
    if pad_t:
        # right-pad to a whole number of output tiles; causal outputs in
        # [0, t_out) are unaffected by the zeros, so trimming is exact
        return _stacked(F.pad(x, (0, 0, 0, pad_t)), w, s, 1, stack)[:, :t_out]
    g = t_out // stack
    tile = stack * s  # input samples per output tile
    ctx_len = math.ceil((k - 1) / s) * s
    assert ctx_len <= tile, (
        f"kernel {k} too large for stack {stack} at stride {s}; raise conv_stack"
    )
    window = ctx_len + tile
    xp = F.pad(x, (0, 0, ctx_len, 0))
    main = x.reshape(b, g, tile, c)
    ctx = xp[:, :t].reshape(b, g, tile, c)[:, :, :ctx_len]
    frames = torch.cat([ctx, main], dim=2)  # (B, G, window, C)
    wb = _block_toeplitz(w, s, stack, ctx_len)  # (window, C, stack, Cout)
    y = _matmul(frames.reshape(b * g, window * c), wb.reshape(window * c, stack * co), x.dtype)
    return y.reshape(b, t_out, co)


def stacked_conv1d(
    x: torch.Tensor, p: Params, *, stride: int = 1, dilation: int = 1, stack: int = 8,
) -> torch.Tensor:
    """Causal conv (N, Cin, T) -> (N, Cout, T/stride) as one matmul; the
    same result as `ops.conv.conv1d(..., padding="causal")` up to the order
    of the float sums."""
    w = p["w"].permute(2, 1, 0).to(x.dtype)  # (K, Cin, Cout)
    y = _stacked(x.transpose(1, 2), w, stride, dilation, stack).transpose(1, 2)
    if "b" in p:
        y = y + p["b"].to(y.dtype)[None, :, None]
    return y


def polyphase_conv_transpose1d(x: torch.Tensor, p: Params, *, stride: int) -> torch.Tensor:
    """Causal transposed conv (N, Cin, F) -> (N, Cout, F*stride) as one
    matmul; the same result as `ops.conv.conv_transpose1d(causal=True)` up
    to the order of the float sums."""
    w = p["w"].permute(2, 0, 1).to(x.dtype)  # (K, Cin, Cout)
    k, c, co = w.shape
    s = stride
    n_frames = math.ceil(k / s)  # input frames contributing to one output frame
    xt = x.transpose(1, 2)  # (N, F, C)
    b, f, _ = xt.shape
    views = [xt] + [F.pad(xt, (0, 0, m, 0))[:, :f] for m in range(1, n_frames)]
    frames = torch.stack(views, dim=2)  # (B, F, n_frames, C); [:, :, m] = x[i - m]
    tap = np.arange(n_frames)[:, None] * s + np.arange(s)[None, :]
    valid = torch.from_numpy(tap < k).to(w.device, w.dtype)
    wt = w[torch.from_numpy(np.clip(tap, 0, k - 1)).to(w.device)]  # (n_frames, s, C, Cout)
    wt = (wt * valid[:, :, None, None]).permute(0, 2, 1, 3)  # (n_frames, C, s, Cout)
    y = _matmul(frames.reshape(b * f, n_frames * c), wt.reshape(n_frames * c, s * co), x.dtype)
    y = y.reshape(b, f * s, co).transpose(1, 2)
    if "b" in p:
        y = y + p["b"].to(y.dtype)[None, :, None]
    return y
