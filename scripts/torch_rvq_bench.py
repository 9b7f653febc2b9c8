"""Time the port's RVQ kernels on a CUDA card, and keep K2's indices so that
two trees of the port can be held against each other.

    python3 scripts/torch_rvq_bench.py [--tree DIR] [--save FILE]
    python3 scripts/torch_rvq_bench.py --compare FILE FILE [FILE ...]

The options and the turns are scripts/torch_tree_bench.py's. The script
calls only what every tree of the port has (`api.load_model`, the codec's
`latents`, `kernels.rvq.quantize` / `dequantize` / `dequantize_plain`).
K2's indices must be equal where two trees ran a shape (each run's own line
has its times).

Inputs, from fixed seeds:
  * serving: `base_fast`'s serving codebooks (seed 0) and its latents of
    64 x 10 s of `randn * 0.1` audio (seed 0), as `chip_smoke.py` makes them
    (M 32,000, 16 x 1024 x 128); K3 on K2's indices of them;
  * random: N(0, 1) books and frames at 16 x 1024 x 128, and at the widths
    past 128 that K2's streamed plan takes (8 x 1024 x 256, 4 x 1024 x 384),
    M 32,000; K3 on uniform random indices at 16 x 1024 x 128.
A tree whose K2 refuses a width records "refused" for it.

One JSON line per run: the card, and per shape K2's ms (CUDA events, mean
of 10 launches after one) or K3's ms (mean of 100), with K3 checked
bit-exact against the plain version.
"""

from __future__ import annotations

import sys

import torch_tree_bench as TB


def run(tree: str, save: str | None) -> dict:
    TB.import_tree(tree)
    import numpy as np
    import torch

    from nsc_tpu_torch import api
    from nsc_tpu_torch.kernels import rvq as KR

    if not torch.cuda.is_available():
        raise SystemExit("torch_rvq_bench: CUDA is not available")
    dev = torch.device("cuda", 0)
    out = {"tree": tree, "card": TB.card(), "quantize": {}, "dequantize": {}}
    kept = {}
    with torch.no_grad():
        bundle = api.load_model("base_fast", serving=True, device=dev)
        wav = torch.from_numpy(
            np.random.RandomState(0).randn(64, 160000).astype(np.float32) * 0.1).to(dev)
        z = bundle.model.latents(bundle.params, wav)
        cases = {"serving": (bundle.rvq["codebooks"].contiguous(),
                             z.reshape(-1, z.shape[-1]).float().contiguous())}
        del bundle, wav, z
        g = torch.Generator(device=dev).manual_seed(11)
        for n_q, k, d in ((16, 1024, 128), (8, 1024, 256), (4, 1024, 384)):
            cases[f"random_{n_q}x{k}x{d}"] = (torch.randn(n_q, k, d, device=dev, generator=g),
                                              torch.randn(32000, d, device=dev, generator=g))
        for name, (books, zz) in cases.items():
            try:
                idx = KR.quantize(books, zz)
            except ValueError as e:
                out["quantize"][name] = {"refused": str(e)}
                continue
            torch.cuda.synchronize()
            kept[name] = idx.cpu()
            out["quantize"][name] = {
                "shape": list(books.shape), "M": zz.shape[0],
                "ms": TB.events_ms(torch, lambda: KR.quantize(books, zz), 10)}
        books = cases["serving"][0]
        uniform = torch.randint(0, books.shape[1], (32000, books.shape[0]), device=dev,
                                generator=g, dtype=torch.int32)
        for name, ii in (("serving", kept["serving"].to(dev)), ("uniform", uniform)):
            got = KR.dequantize(books, ii)
            torch.cuda.synchronize()
            out["dequantize"][name] = {
                "bit_exact": bool(torch.equal(got, KR.dequantize_plain(books, ii))),
                "ms": TB.events_ms(torch, lambda: KR.dequantize(books, ii), 100)}
    if save:
        torch.save(kept, save)
    return out


if __name__ == "__main__":
    import torch

    sys.exit(TB.main(__doc__.split("\n\n")[0], run, torch.load, torch.equal))
