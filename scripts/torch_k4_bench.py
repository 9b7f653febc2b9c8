"""Time the port's STFT-magnitude kernel (K4) on a CUDA card, and keep a
digest of its outputs so that two trees of the port can be held against
each other bit for bit.

    python3 scripts/torch_k4_bench.py [--tree DIR] [--save FILE]
    python3 scripts/torch_k4_bench.py --compare FILE FILE [FILE ...]

The options and the turns are scripts/torch_tree_bench.py's. The script
calls only what every tree of the port since its FFT route has
(`kernels.stft.launch`, `route`). Where two trees ran a shape, the
magnitudes (and the spectrum, where kept) must be equal bit for bit.

Inputs, from fixed seeds: the training step's launch shapes (the shipped
bank n_fft 2048-128 and the mel STFT's 1024, hop n_fft/4) on 64 x 1 s of
N(0, 0.3^2) noise (the target) and on it plus 0.05 N(0, 1) (the
reconstruction, with the spectrum kept, as the loss launches it), every
power of two 16-4096 at B = 2 on a T that no hop divides, the long and
odd windows (8192, 12000, 441, 2018, hop n_fft/4) on the target, the
chirp-z cluster route's shapes (8191, 11025, 30000, 31999, hop n_fft/4;
the DFT remainder's in trees before that route) on the target, and the
two-level chirp-z route's shapes (60001 and 115202 on 4 x 4 s, 131072 on
4 x 8 s, 262145 on 2 x 20 s of N(0, 0.3^2) noise, hop n_fft/4; the DFT
remainder's in trees before that route). Only shapes on a tree's FFT
route keep a digest (so two trees whose routes differ at a shape are not
compared there); every shape is timed, with the route the tree took.

One JSON line per run: the card, each shape's route and ms (CUDA events,
mean of 20 launches after one; 3 on the DFT remainder) and graph_ms (the
same launches captured in a CUDA graph: the card's time without the
host's), on the two-level route each of its four kernels' ms from
`torch.profiler` (mean of 5 launches; None where the profiler saw no
device time), and K4's ms and graph_ms per training step (the 12
launches).
"""

from __future__ import annotations

import hashlib
import json
import re
import sys

import torch_tree_bench as TB


def kernel_split(torch, fn, reps: int = 5) -> dict | None:
    """Each kernel of the two-level route's launch: its mean device ms over
    `reps` launches (after one) from `torch.profiler`, or None where the
    profiler saw none of them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"bluestein_global_(\w+?)_kernel", e.key)
        us = getattr(e, "device_time_total", None) or getattr(e, "cuda_time_total", 0)
        if m and us:
            out[m.group(1)] = out.get(m.group(1), 0.0) + us / 1e3 / reps
    return out or None


def run(tree: str, save: str | None) -> dict:
    TB.import_tree(tree)
    import torch

    from nsc_tpu_torch.kernels import stft as KS

    if not torch.cuda.is_available():
        raise SystemExit("torch_k4_bench: CUDA is not available")
    dev = torch.device("cuda", 0)
    out = {"tree": tree, "card": TB.card(), "shapes": {}, "train_step_ms": 0.0,
           "train_step_graph_ms": 0.0}
    digests = {}
    g = torch.Generator(device=dev).manual_seed(0)
    target = torch.randn(64, 16000, device=dev, generator=g) * 0.3
    pred = target + 0.05 * torch.randn(64, 16000, device=dev, generator=g)
    bank = (("stft_2048", 2048), ("stft_1024", 1024), ("stft_512", 512), ("stft_256", 256),
            ("stft_128", 128), ("mel_1024", 1024))
    cases = [(f"train_{label}_{what}", x, n, n // 4, what == "pred")
             for label, n in bank for what, x in (("pred", pred), ("target", target))]
    for n in (16, 32, 64, 128, 256, 512, 1024, 2048, 4096):
        x = torch.randn(2, 3 * n + 101, device=dev, generator=g) * 0.3
        cases.append((f"pow2_{n}", x, n, n // 4, True))
    cases += [(f"long_{n}", target, n, n // 4, False) for n in (8192, 12000, 441, 2018)]
    cases += [(f"cluster_{n}", target, n, n // 4, False) for n in (8191, 11025, 30000, 31999)]
    for n, b, t in ((60001, 4, 64000), (115202, 4, 64000), (131072, 4, 128000),
                    (262145, 2, 320000)):
        x = torch.randn(b, t, device=dev, generator=g) * 0.3
        cases.append((f"global_{n}", x, n, n // 4, False))
    with torch.no_grad():
        for name, x, n_fft, hop, spectrum in cases:
            route = KS.route(n_fft)
            got = KS.launch(x, n_fft, hop, spectrum=spectrum)
            torch.cuda.synchronize()
            parts = got if spectrum else (got,)
            if route == "fft":
                digests[name] = [hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()
                                 for t in parts]
            fn = lambda: KS.launch(x, n_fft, hop, spectrum=spectrum)  # noqa: E731
            reps = 3 if route == "dft" else 20
            ms, gms = TB.events_ms(torch, fn, reps), TB.graph_ms(torch, fn, reps)
            out["shapes"][name] = {"n_fft": n_fft, "hop": hop, "B": x.shape[0], "T": x.shape[1],
                                   "spectrum": spectrum, "route": route, "ms": ms,
                                   "graph_ms": gms}
            if route == "bluestein_global":
                out["shapes"][name]["kernels_ms"] = kernel_split(torch, fn)
            if name.startswith("train_"):
                out["train_step_ms"] += ms
                out["train_step_graph_ms"] += gms
    if save:
        with open(save, "w") as f:
            json.dump(digests, f)
    return out


def _load(name):
    with open(name) as f:
        return json.load(f)


if __name__ == "__main__":
    sys.exit(TB.main(__doc__.split("\n\n")[0], run, _load, lambda a, b: a == b))
