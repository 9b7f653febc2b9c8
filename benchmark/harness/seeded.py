"""Weights and inputs made from the run's seed, on the device, in a few
large calls of one `torch.Generator`.

Weights are float32 in the layout the port's public load path
(`nsc_tpu_torch.api.bundle_from_jax`, `weights.train_state_from_jax`) and
the benchmark's plain reference both take:

  conv   {'v': (K, Cin, Cout), 'g': (Cout,), 'b': (Cout,)}: v and b uniform
         in +-1/sqrt(fan_in), g = |v| over (K, Cin) (so w = v at the start)
  snake  {'alpha': (C,)} uniform in [0.5, 1.5)
  rvq    {'codebooks': (n_q, K, D)} drawn from the data, as a trained
         codec's are: the plain reference encoder's latents of
         CODEBOOK_ROWS x CODEBOOK_FRAMES frames of N(0, 0.1^2) noise, and
         per book K distinct frames' residuals left by the books before it
         (each frame's nearest codeword subtracted), the frames a random
         permutation; N(0, 1) books would sit far from every latent and
         make each frame's choice a near tie between a few small codes

The discriminators' convs are {'v': (*kernel, Cin/groups, Cout), 'g', 'b'}
with the same distributions (the widths of `nsc_tpu_torch.models.
discriminators`, written out here).
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from benchmark.reference import codec as ref

CODEBOOK_ROWS, CODEBOOK_FRAMES, CODEBOOK_AMPLITUDE = 32, 64, 0.1

# MSD layers (out_ch, kernel, stride, groups) and MPD widths of the
# HiFi-GAN-style discriminators the port trains against
MSD_LAYERS = ((16, 15, 1, 1), (64, 41, 4, 4), (256, 41, 4, 16), (1024, 41, 4, 64), (1024, 5, 1, 1))
MPD_CHANNELS = (32, 128, 512, 1024)


class _Spec:
    """Leaves to fill: ('conv', kernel, cin_per_group, cout) or ('snake', C)."""

    def __init__(self):
        self.leaves: List[Tuple[dict, tuple]] = []

    def conv(self, kernel, cin, cout, groups=1) -> dict:
        d: dict = {}
        self.leaves.append((d, ("conv", tuple(kernel), cin // groups, cout)))
        return d

    def snake(self, c) -> dict:
        d: dict = {}
        self.leaves.append((d, ("snake", c)))
        return d

    def fill(self, gen: torch.Generator, device) -> None:
        sizes = []
        for _, s in self.leaves:
            sizes.append(math.prod(s[1]) * s[2] * s[3] + s[3] if s[0] == "conv" else s[1])
        flat = torch.rand(sum(sizes), generator=gen, device=device)
        off = 0
        for (d, s), n in zip(self.leaves, sizes):
            u = flat[off:off + n]
            off += n
            if s[0] == "snake":
                d["alpha"] = u + 0.5
                continue
            _, kernel, cin, cout = s
            bound = 1.0 / math.sqrt(cin * math.prod(kernel))
            v = ((u[:-cout] * 2 - 1) * bound).reshape(*kernel, cin, cout)
            d["v"] = v
            d["g"] = torch.sqrt(torch.sum(v * v, dim=tuple(range(v.dim() - 1))))
            d["b"] = (u[-cout:] * 2 - 1) * bound


def _stage_widths(cfg: dict) -> List[int]:
    return [cfg["base_width"] * 2 ** i for i in range(len(cfg["strides"]))]


def codec_weights(cfg: dict, gen: torch.Generator, device) -> Tuple[dict, dict]:
    """(params, rvq) of the codec `cfg` (a configuration file's "codec"
    fields with the run's overrides)."""
    sp = _Spec()

    def units(ch):
        return [{"act1": sp.snake(ch), "conv1": sp.conv((cfg["residual_kernel"],), ch, ch),
                 "act2": sp.snake(ch), "conv2": sp.conv((1,), ch, ch)} for _ in cfg["dilations"]]

    fw = cfg["base_width"] * 2 ** len(cfg["strides"])
    encoder = {
        "stem": sp.conv((cfg["stem_kernel"],), cfg["channels"], cfg["base_width"]),
        "stages": [{"units": units(ch), "down_act": sp.snake(ch), "down": sp.conv((2 * s,), ch, 2 * ch)}
                   for ch, s in zip(_stage_widths(cfg), cfg["strides"])],
        "final_act": sp.snake(fw),
        "final": sp.conv((cfg["last_kernel"],), fw, cfg["latent_dim"]),
    }
    dec_stages = []
    for i, s in enumerate(reversed(cfg["strides"])):
        ch = fw // 2 ** i
        dec_stages.append({"up_act": sp.snake(ch), "up": sp.conv((2 * s,), ch, ch // 2),
                           "units": units(ch // 2)})
    decoder = {
        "stem": sp.conv((cfg["last_kernel"],), cfg["latent_dim"], fw),
        "stages": dec_stages,
        "final_act": sp.snake(cfg["base_width"]),
        "final": sp.conv((cfg["stem_kernel"],), cfg["base_width"], cfg["channels"]),
    }
    if cfg["codebook_dim"] != cfg["latent_dim"]:
        raise ValueError("factorized codebooks are not made by this benchmark yet")
    sp.fill(gen, device)
    params = {"encoder": encoder, "decoder": decoder}
    return params, {"codebooks": data_codebooks(params, cfg, gen, device)}


def data_codebooks(params: dict, cfg: dict, gen: torch.Generator, device) -> torch.Tensor:
    """(n_q, K, D) books from the residuals of the reference encoder's
    latents of noise (see the module doc)."""
    hop = math.prod(cfg["strides"])
    x = torch.randn((CODEBOOK_ROWS, CODEBOOK_FRAMES * hop), generator=gen,
                    device=device) * CODEBOOK_AMPLITUDE
    k = cfg["codebook_size"]
    with torch.no_grad():
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            r = ref.encode_latents(params, x, cfg).reshape(-1, cfg["latent_dim"])
            if r.shape[0] < k:
                raise ValueError("fewer frames than codewords")
            books = []
            for _ in range(cfg["num_quantizers"]):
                cb = r[torch.randperm(r.shape[0], generator=gen, device=device)[:k]].clone()
                r = r - cb[ref.quantize(cb[None], r)[:, 0]]
                books.append(cb)
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    return torch.stack(books)


def discriminator_weights(gen: torch.Generator, device, periods=(2, 3, 5, 7, 11),
                          msd_scales: int = 3) -> Dict[str, list]:
    """MPD (one per period) and MSD (one per scale) weights, width 1x."""
    sp = _Spec()
    mpd = []
    for _ in periods:
        layers, cin = [], 1
        for cout in MPD_CHANNELS:
            layers.append(sp.conv((5, 1), cin, cout))
            cin = cout
        layers.append(sp.conv((3, 1), cin, 1))
        mpd.append(layers)
    msd = []
    for _ in range(msd_scales):
        layers, cin = [], 1
        for cout, k, _, groups in MSD_LAYERS:
            g = math.gcd(groups, cin)
            layers.append(sp.conv((k,), cin, cout, g))
            cin = cout
        layers.append(sp.conv((3,), cin, 1))
        msd.append(layers)
    sp.fill(gen, device)
    return {"mpd": mpd, "msd": msd}


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))

