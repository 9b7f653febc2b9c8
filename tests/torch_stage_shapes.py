"""Stage shapes of the shipped configs, as the stage kernels see them, for
the tests of the stage kernels' shared-memory planner (on the CPU in
`test_torch_tensor_cores.py`, against the kernels' own plan on a card in
`test_torch_cuda.py`). Imports torch and the port only."""

import torch

from nsc_tpu_torch.models import seanet as PS

SHIPPED = ("tiny_test", "small", "small_factorized", "base", "base_fast", "base_fast_f")

# Stage shapes that do not fit one block's 227 KB: ("stack", the arguments
# of `RS.stack_plan`) or ("fused", those of `FS.stage_plan`)
PLANNER_REJECTS = [
    ("stack", (1024, 2000, torch.float32, False, 1)),
    ("stack", (1024, 300, torch.float32, True, 3)),
    ("fused", (1024, 1024, 1024, 8, 0, 2000, torch.float32, False)),
]


def stage_shapes(cfg):
    """(C_in, C_mid, C_out, s_head, s_tail) of every stage of a config, as
    K5 sees them; K1 and K6 see (C_mid, C_mid, C_mid, 0, 0)."""
    enc_w = PS.stage_widths(cfg)
    dec_w = [PS.encoder_final_width(cfg) // 2 ** (i + 1) for i in range(len(cfg.strides))]
    up = tuple(reversed(cfg.strides))
    shapes = [(enc_w[i - 1] if i else enc_w[0], c, c, cfg.strides[i - 1] if i else 0, 0)
              for i, c in enumerate(enc_w)]
    shapes += [(c, c, dec_w[i + 1] if i + 1 < len(dec_w) else c, 0,
                up[i + 1] if i + 1 < len(dec_w) else 0) for i, c in enumerate(dec_w)]
    return shapes
