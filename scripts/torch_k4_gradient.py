"""Where the multi-resolution loss gradient through the port's |STFT| kernel
(K4) parts from the float32 plain path and from float64, on a CUDA card.

The loss's log-magnitude term is an L1, so its gradient flips sign where a
bin's reconstruction and target magnitudes nearly tie, and any float32
forward moves single entries of the gradient. This report puts numbers on
that, for the inputs `chip_smoke.py` checks (base_fast, TrainConfig's
batch of synthetic speech as the target, the target plus 0.05 x N(0, 1)
noise from a seeded generator as the reconstruction).

Routes: "kernel" is K4 as the loss runs it (its forward, and the backward
through the spectrum that forward computed); "kernel_recompute" is K4's
forward with the backward earlier versions of the port ran (the float32
plain path recomputed and differentiated); "plain" the float32 matmul-DFT
path; "rfft" the float32 rfft path.

One line of JSON each:

  * per resolution: the forward's max abs error / max against float64 for
    each route;
  * the whole loss: each route's relative L2 distance to the float64
    gradient, e(g) = ||g - g64||_2 / ||g64||_2, and K4's over the float32
    plain path's, the figures `chip_smoke.py` gates (e(g_K4) <= 1.25 x
    e(g_plain) and e(g_K4) <= a fixed limit, at every seed); beside them,
    not gated, max |g - g'| / max |g'| between the routes' gradients, each
    route's max-abs distance to float64, and at the entry where K4 and the
    plain path differ most, the four gradients;
  * per resolution, the same distances of the one-resolution loss.

    python3 scripts/torch_k4_gradient.py [--seeds 2 3 4 5 6]

Each seed draws another noise (`chip_smoke.py` checks seeds 2-6). The numbers
are reported, not checked.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from nsc_tpu_torch.configs import TrainConfig, get_config  # noqa: E402
from nsc_tpu_torch.kernels import stft as KS  # noqa: E402
from nsc_tpu_torch.losses import spectral as SP  # noqa: E402
from nsc_tpu_torch.ops import stft as S  # noqa: E402
from nsc_tpu_torch.ops.precision import float32_numerics  # noqa: E402
from nsc_tpu_torch.train import data as data_lib  # noqa: E402
from nsc_tpu_torch.train import loop as L  # noqa: E402

class _Recompute(torch.autograd.Function):
    """K4's forward with the backward of earlier versions of the port: the
    float32 plain path recomputed and differentiated, so the loss's dL/d|X|
    comes from the kernel's magnitudes and the Jacobian from the plain
    path's spectrum."""

    @staticmethod
    def forward(ctx, x, n_fft, hop):
        ctx.save_for_backward(x)
        ctx.n_fft, ctx.hop = n_fft, hop
        return KS.launch(x, n_fft, hop)

    @staticmethod
    def backward(ctx, grad):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xx = x.detach().requires_grad_(True)
            y = KS.stft_magnitude_plain(xx, ctx.n_fft, ctx.hop)
            return torch.autograd.grad(y, xx, grad)[0], None, None


ROUTES = {"kernel": KS.stft_magnitude, "kernel_recompute": _Recompute.apply,
          "plain": KS.stft_magnitude_plain,
          "rfft": lambda x, n_fft, hop: S.stft_magnitude(x, n_fft, hop)}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def grad(loss, x, stft):
    x = x.clone().requires_grad_(True)
    return torch.autograd.grad(loss(x, stft), x)[0]


def dist(g, ref) -> float:
    return ((g.double() - ref.double()).abs().max() / ref.double().abs().max()).item()


def l2_dist(g, ref) -> float:
    """||g - ref||_2 / ||ref||_2 in float64."""
    return ((g.double() - ref.double()).norm() / ref.double().norm()).item()


def report(target, pred, sizes, seed) -> None:
    for n in sizes:
        with torch.no_grad(), float32_numerics():
            m64 = KS.stft_magnitude_plain(pred.double(), n, n // 4)
            emit({"seed": seed, "n_fft": n, "forward_max_abs_err_over_max_vs_float64": {
                name: dist(fn(pred, n, n // 4), m64) for name, fn in ROUTES.items()}})

    def loss_of(fft_sizes):
        cfg = SP.MultiResSTFTConfig(fft_sizes=fft_sizes)
        return lambda p, st: SP.multi_res_stft_loss(p, target, cfg, stft=st)

    loss = loss_of(tuple(sizes))
    with float32_numerics():
        g = {name: grad(loss, pred, fn) for name, fn in ROUTES.items()}
        g64 = grad(loss, pred.double(), KS.stft_magnitude_plain)
    d = (g["kernel"] - g["plain"]).abs()
    i = int(d.argmax())
    scale = g["plain"].abs().max()
    emit({"seed": seed, "loss": "multi_res_stft",
          "kernel_vs_plain_over_max": (d.max() / scale).item(),
          "rfft_vs_plain_over_max": ((g["rfft"] - g["plain"]).abs().max() / scale).item(),
          "entries_kernel_vs_plain_over_2e-3": int((d > 2e-3 * scale).sum()),
          "l2_dist_to_float64": (l2 := {name: l2_dist(v, g64) for name, v in g.items()}),
          "kernel_over_plain_l2": l2["kernel"] / l2["plain"],
          "dist_to_float64_over_max": {name: dist(v, g64) for name, v in g.items()},
          "at_worst_entry": {"index": list(divmod(i, pred.shape[1])),
                             **{name: v.flatten()[i].item() for name, v in g.items()},
                             "float64": g64.flatten()[i].item()}})
    for n in sizes:
        one = loss_of((n,))
        with float32_numerics():
            gn = {name: grad(one, pred, fn) for name, fn in ROUTES.items()}
            gn64 = grad(one, pred.double(), KS.stft_magnitude_plain)
        emit({"seed": seed, "loss": f"stft_{n}",
              "kernel_vs_plain_over_max": dist(gn["kernel"], gn["plain"]),
              "l2_dist_to_float64": {name: l2_dist(v, gn64) for name, v in gn.items()},
              "dist_to_float64_over_max": {name: dist(v, gn64) for name, v in gn.items()}})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[2, 3, 4, 5, 6],
                    help="seeds of the noise added to the target (chip_smoke.py checks 2-6)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    cfg, tcfg = get_config("base_fast"), TrainConfig()
    seg = L.segment_length(cfg, tcfg.segment_seconds)
    source = data_lib.make_source("synthetic", cfg.sample_rate, tcfg.seed)
    target = torch.from_numpy(next(source.batches(tcfg.batch_size, seg))).to(dev)
    for seed in args.seeds:
        gen = torch.Generator(device=dev).manual_seed(seed)
        pred = target + 0.05 * torch.randn(target.shape, device=dev, generator=gen)
        report(target, pred, tcfg.stft_fft_sizes, seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
