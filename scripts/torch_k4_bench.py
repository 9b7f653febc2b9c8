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
reconstruction, with the spectrum kept, as the loss launches it), and every
power of two 16-4096 at B = 2 on a T that no hop divides. Shapes outside a
tree's FFT route are skipped.

One JSON line per run: the card, each shape's ms (CUDA events, mean of 20
launches after one), and K4's ms per training step (the 12 launches).
"""

from __future__ import annotations

import hashlib
import json
import sys

import torch_tree_bench as TB


def run(tree: str, save: str | None) -> dict:
    TB.import_tree(tree)
    import torch

    from nsc_tpu_torch.kernels import stft as KS

    if not torch.cuda.is_available():
        raise SystemExit("torch_k4_bench: CUDA is not available")
    dev = torch.device("cuda", 0)
    out = {"tree": tree, "card": TB.card(), "shapes": {}, "train_step_ms": 0.0}
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
    with torch.no_grad():
        for name, x, n_fft, hop, spectrum in cases:
            if KS.route(n_fft) != "fft":
                continue
            got = KS.launch(x, n_fft, hop, spectrum=spectrum)
            torch.cuda.synchronize()
            parts = got if spectrum else (got,)
            digests[name] = [hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest() for t in parts]
            ms = TB.events_ms(torch, lambda: KS.launch(x, n_fft, hop, spectrum=spectrum), 20)
            out["shapes"][name] = {"n_fft": n_fft, "hop": hop, "B": x.shape[0], "T": x.shape[1],
                                   "spectrum": spectrum, "ms": ms}
            if name.startswith("train_"):
                out["train_step_ms"] += ms
    if save:
        with open(save, "w") as f:
            json.dump(digests, f)
    return out


def _load(name):
    with open(name) as f:
        return json.load(f)


if __name__ == "__main__":
    sys.exit(TB.main(__doc__.split("\n\n")[0], run, _load, lambda a, b: a == b))
