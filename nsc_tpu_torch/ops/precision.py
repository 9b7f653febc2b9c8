"""Float32 numerics for the port's float32 contract.

PyTorch lets cuDNN run float32 convolutions in TF32 by default
(`torch.backends.cudnn.allow_tf32` is True), which keeps about three
decimal digits. The codec's inference methods, the train step and the
step-0 data init run under `float32_numerics()`, so their float32 convs
and matmuls are true float32 whatever the caller's settings; bf16 work is
not affected by the flags.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float32_numerics():
    """TF32 off for cuDNN convolutions and cuBLAS matmuls inside the block;
    the previous settings come back after it. Also a decorator."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
