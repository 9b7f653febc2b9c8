"""Plain float32 reference of one GAN training step of the codec, written as
a frozen copy of the step's published semantics (imports nothing of the
program under test):

  1. generator: encoder -> residual quantizer (straight through, depths of
     quantizer dropout, EMA statistics) -> decoder; losses 0.1 time L1 +
     15 log-mel L1 + 2 multi-resolution STFT (spectral convergence +
     log-magnitude L1) + 1 commitment + 1 least-squares adversarial + 2
     feature matching, the discriminators at their old weights;
  2. discriminators: least-squares loss on the real and the detached
     generated rows, at the same old weights;
  3. both optimizers: clip by global norm 1 (g max/|g| where |g| >= max),
     then Adam (b1 0.5, b2 0.9, eps 1e-8, constant rate), the generator
     first; between them the EMA codebook update (decay 0.99, eps 1e-5,
     codes under count 2 reseeded from the step's latents with count
     min(2 / 0.99^20, 8)).

Magnitudes are |STFT| = sqrt(re^2 + im^2 + 1e-8) of reflect-padded frames
under the periodic Hann window, by `torch.fft.rfft` in float64 and rounded
once to float32 (the log-magnitude L1 turns a float32 rounding of a
magnitude at a bin where the two spectra nearly tie into a flipped sign
of its gradient); the mel filterbank is HTK-scale triangles built in
float64 and rounded to float32.

Each step's random draws come from a CPU `torch.Generator` seeded with
(seed * 1,000,003 + step) mod 2^63: first the depths (randint(1, n_q + 1,
N), then rand(N) < 0.5 picks the rows that train at that depth rather than
full depth), then the reseed candidates (randint(0, N F, (n_q, K)) rows of
the step's latents).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import codec as rc

LRELU = 0.1
MSD_LAYERS = ((16, 15, 1, 1), (64, 41, 4, 4), (256, 41, 4, 16), (1024, 41, 4, 64), (1024, 5, 1, 1))


def leaves(tree) -> List[torch.Tensor]:
    """Tensor leaves in a fixed order: dict keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# spectra
# ---------------------------------------------------------------------------


def hann(n: int, device) -> torch.Tensor:
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)
    return torch.from_numpy(w).to(device)


def stft_mag(x: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """(N, T) -> (N, frames, n_fft // 2 + 1) float32, frames centred at
    f hop, computed in float64."""
    p = n_fft // 2
    xp = F.pad(x.double()[:, None, :], (p, p), mode="reflect")[:, 0, :]
    frames = xp.unfold(-1, n_fft, hop) * hann(n_fft, x.device)
    z = torch.fft.rfft(frames, dim=-1)
    return torch.sqrt(z.real * z.real + z.imag * z.imag + 1e-8).float()


def mel_filterbank(sr: int, n_fft: int, n_mels: int, device) -> torch.Tensor:
    hz2mel = lambda f: 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)  # noqa: E731
    mel2hz = lambda m: 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)  # noqa: E731
    hz = mel2hz(np.linspace(hz2mel(0.0), hz2mel(sr / 2.0), n_mels + 2))
    bins = np.fft.rfftfreq(n_fft, 1.0 / sr)
    fb = np.zeros((len(bins), n_mels), dtype=np.float32)
    for m in range(n_mels):
        lo, c, hi = hz[m], hz[m + 1], hz[m + 2]
        fb[:, m] = np.maximum(0.0, np.minimum((bins - lo) / max(c - lo, 1e-9),
                                              (hi - bins) / max(hi - c, 1e-9)))
    return torch.from_numpy(fb).to(device)


def mel_loss(pred, target, tcfg, sr):
    n = tcfg["mel_fft_size"]
    fb = mel_filterbank(sr, n, tcfg["mel_bins"], pred.device)
    logmel = lambda x: torch.log(stft_mag(x, n, n // 4) @ fb + 1e-5)  # noqa: E731
    return torch.mean(torch.abs(logmel(pred) - logmel(target)))


def multi_res_stft_loss(pred, target, sizes, eps=1e-5):
    total = pred.new_zeros(())
    for n in sizes:
        p, t = stft_mag(pred, n, n // 4), stft_mag(target, n, n // 4)
        sc = torch.linalg.norm(t - p, dim=(-2, -1)) / (torch.linalg.norm(t, dim=(-2, -1)) + eps)
        l1 = torch.mean(torch.abs(torch.log(t + eps) - torch.log(p + eps)), dim=(-2, -1))
        total = total + torch.mean(sc) + torch.mean(l1)
    return total / len(sizes)


# ---------------------------------------------------------------------------
# discriminators (HiFi-GAN style: multi-period and multi-scale)
# ---------------------------------------------------------------------------


def _w(p):
    v, g = p["v"], p["g"]
    w = v * (g / torch.sqrt(torch.sum(v * v, dim=tuple(range(v.dim() - 1)), keepdim=True) + 1e-12))
    return w.permute(v.dim() - 1, v.dim() - 2, *range(v.dim() - 2))


def _mpd(layers, wav, period):
    n, t = wav.shape
    x = wav[:, None, :]
    pad = (-t) % period
    if pad:
        x = F.pad(x, (0, pad), mode="reflect" if pad < t else "constant")
    x = x.reshape(n, 1, -1, period)
    feats = []
    for i, p in enumerate(layers[:-1]):
        stride = (3, 1) if i < len(layers) - 2 else (1, 1)
        x = F.leaky_relu(F.conv2d(x, _w(p), p["b"], stride=stride, padding=(2, 0)), LRELU)
        feats.append(x)
    x = F.conv2d(x, _w(layers[-1]), layers[-1]["b"], padding=(1, 0))
    feats.append(x)
    return x.reshape(n, -1), feats


def _msd(layers, wav):
    x = wav[:, None, :]
    feats = []
    for p, (_, k, stride, _) in zip(layers[:-1], MSD_LAYERS):
        groups = x.shape[1] // p["v"].shape[-2]
        x = F.leaky_relu(F.conv1d(x, _w(p), p["b"], stride=stride, padding=(k - 1) // 2,
                                  groups=groups), LRELU)
        feats.append(x)
    x = F.conv1d(x, _w(layers[-1]), layers[-1]["b"], padding=1)
    feats.append(x)
    return x.reshape(x.shape[0], -1), feats


def discriminate(params, wav, periods):
    outs = [_mpd(layers, wav, p) for layers, p in zip(params["mpd"], periods)]
    x = wav
    for i, layers in enumerate(params["msd"]):
        if i:
            x = F.avg_pool1d(x[:, None, :], 4, 2, 1, count_include_pad=True)[:, 0, :]
        outs.append(_msd(layers, x))
    return outs


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def step_generator(seed: int, step: int) -> torch.Generator:
    return torch.Generator().manual_seed((seed * 1_000_003 + step) % (2**63))


def rvq_forward(books, z, depth):
    """Straight-through quantization with per-row depths; EMA counts and
    sums of the residuals each book saw, masked by depth."""
    n, f, d = z.shape
    n_q, k, _ = books.shape
    r = z.reshape(n * f, d).detach()
    idx = rc.quantize(books, r)
    mask = (torch.arange(n_q, device=z.device)[:, None] < depth.to(z.device)[None, :]).float()
    mask = torch.repeat_interleave(mask, f, dim=1)
    acc = torch.zeros_like(r)
    counts, sums = [], []
    for q in range(n_q):
        iq, mq = idx[:, q], mask[q]
        quant = books[q][iq]
        counts.append(torch.zeros(k, device=z.device).index_add_(0, iq, mq))
        sums.append(torch.zeros(k, d, device=z.device).index_add_(0, iq, r * mq[:, None]))
        acc = acc + quant * mq[:, None]
        r = r - quant
    zq = acc.reshape(n, f, d)
    commit = torch.mean(torch.square(z - zq))
    return z + (zq - z).detach(), commit, torch.stack(counts), torch.stack(sums)


def clip_adam(params, grads, opt, tcfg):
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    clip = norm >= tcfg["grad_clip"]
    b1, b2 = tcfg["adam_b1"], tcfg["adam_b2"]
    opt["count"] += 1
    c = opt["count"]
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(c))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(c))
    lr = float(np.float32(tcfg["lr"]))
    clipped = []
    with torch.no_grad():
        for p, g, m, v in zip(leaves(params), grads, opt["m"], opt["v"]):
            g = torch.where(clip, (g / norm) * tcfg["grad_clip"], g)
            clipped.append(g)
            m.mul_(b1).add_((1.0 - b1) * g)
            v.mul_(b2).add_((1.0 - b2) * (g * g))
            p.add_(-lr * ((m / bc1) / (torch.sqrt(v / bc2) + 1e-8)))
    return clipped


class Trainer:
    """The reference's state (float32 leaves on one device) and its step.
    `batch_fraction` < 1 plants the fault "part of the batch left out, the
    mean over the rest"."""

    def __init__(self, codec_cfg: dict, tcfg: dict, params_g, params_d, codebooks,
                 seed: int, num=rc.FLOAT32, batch_fraction: float = 1.0):
        clone = lambda t: t.detach().clone().float().requires_grad_(True)  # noqa: E731
        self.cfg, self.tcfg, self.seed, self.num = codec_cfg, tcfg, seed, num
        self.batch_fraction = batch_fraction
        self.g = _tree_map(clone, params_g)
        self.d = _tree_map(clone, params_d)
        self.books = codebooks.detach().clone().float()
        self.ema_count = torch.zeros(self.books.shape[:2], device=self.books.device)
        self.ema_sum = self.books.clone()
        zeros = lambda t: torch.zeros_like(t, requires_grad=False)  # noqa: E731
        self.opt_g = {"count": 0, "m": [zeros(x) for x in leaves(self.g)], "v": [zeros(x) for x in leaves(self.g)]}
        self.opt_d = {"count": 0, "m": [zeros(x) for x in leaves(self.d)], "v": [zeros(x) for x in leaves(self.d)]}
        self.step = 0

    def _generator(self, batch, depth):
        cfg, t, num = self.cfg, self.tcfg, self.num
        z = _encode(self.g, batch, cfg, num)
        zq, commit, counts, sums = rvq_forward(self.books, z, depth)
        recon = _decode(self.g, zq, cfg, num)
        l_time = torch.mean(torch.abs(recon - batch))
        l_mel = mel_loss(recon, batch, t, cfg["sample_rate"])
        l_stft = multi_res_stft_loss(recon, batch, t["stft_fft_sizes"])
        outs = discriminate(self.d, torch.cat([batch, recon]), t["mpd_periods"])
        n = batch.shape[0]
        real = [(lg[:n], [f[:n] for f in fs]) for lg, fs in outs]
        fake = [(lg[n:], [f[n:] for f in fs]) for lg, fs in outs]
        adv = sum(torch.mean(torch.square(1.0 - lf)) for lf, _ in fake) / len(fake)
        fm, k = 0.0, 0
        for (_, fr), (_, ff) in zip(real, fake):
            for r, f in zip(fr[:-1], ff[:-1]):
                r = r.detach()
                fm = fm + torch.mean(torch.abs(r - f)) / (torch.mean(torch.abs(r)) + 1e-6)
                k += 1
        fm = fm / k
        total = (t["weight_l1_time"] * l_time + t["weight_mel"] * l_mel + t["weight_stft"] * l_stft
                 + t["weight_commit"] * commit + t["weight_adv"] * adv + t["weight_fm"] * fm)
        return total, recon, z, counts, sums

    def train_step(self, batch: torch.Tensor) -> Dict[str, object]:
        """One step on `batch` (N, T); returns the losses and the clipped
        gradients as the optimizers got them."""
        t = self.tcfg
        gen = step_generator(self.seed, self.step)
        n_full = batch.shape[0]
        n_q = self.books.shape[0]
        rd = torch.randint(1, n_q + 1, (n_full,), generator=gen)
        use = torch.rand(n_full, generator=gen) < t["quantizer_dropout"]
        depth = torch.where(use, rd, torch.full_like(rd, n_q))
        keep = max(1, int(round(n_full * self.batch_fraction)))
        batch, depth = batch[:keep], depth[:keep]

        total, recon, z, counts, sums = self._generator(batch, depth)
        g_grads = list(torch.autograd.grad(total, leaves(self.g)))
        fake = recon.detach()
        outs = discriminate(self.d, torch.cat([batch, fake]), t["mpd_periods"])
        n = batch.shape[0]
        d_total = sum(torch.mean(torch.square(1.0 - lg[:n])) + torch.mean(torch.square(lg[n:]))
                      for lg, _ in outs) / len(outs)
        d_grads = list(torch.autograd.grad(d_total, leaves(self.d)))
        g_used = clip_adam(self.g, g_grads, self.opt_g, {**t, "lr": t["lr_g"]})
        with torch.no_grad():
            pool = z.detach().reshape(-1, z.shape[-1])
            picks = torch.randint(0, pool.shape[0], (n_q, self.books.shape[1]), generator=gen)
            self._ema(counts, sums, pool[picks.to(pool.device)])
        d_used = clip_adam(self.d, d_grads, self.opt_d, {**t, "lr": t["lr_d"]})
        self.step += 1
        return {"g_total": total.item(), "d_total": d_total.item(), "g_grads": g_used,
                "d_grads": d_used}

    def _ema(self, counts, sums, candidates):
        cfg = self.cfg
        decay, eps, thr = cfg["ema_decay"], cfg["ema_eps"], cfg["threshold_dead_code"]
        count = decay * self.ema_count + (1.0 - decay) * counts
        total_sum = decay * self.ema_sum + (1.0 - decay) * sums
        total = torch.sum(count, dim=-1, keepdim=True)
        k = count.shape[-1]
        books = total_sum / ((count + eps) / (total + k * eps) * total)[..., None]
        dead = (count < thr)[..., None]
        grace = min(thr / decay**20, 4.0 * thr)
        self.books = torch.where(dead, candidates, books)
        self.ema_sum = torch.where(dead, candidates * grace, total_sum)
        self.ema_count = torch.where(dead[..., 0], torch.full_like(count, grace), count)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _encode(tree, wav, cfg, num):
    return rc.encode_latents(tree, wav, cfg, num)


def _decode(tree, zq, cfg, num):
    return rc.decode_latents(tree, zq, cfg, num)


def worst_leaf_gap(prog: List[float], refs: List[float], keep=None) -> float:
    """max over leaves of |prog - ref| / max(ref, median ref): the gap
    between the two sides' norms of each leaf, against the reference's norm
    of that leaf or of the median leaf, whichever is larger."""
    r = torch.tensor(refs, dtype=torch.float64)
    p = torch.tensor(prog, dtype=torch.float64)
    if keep is not None:
        k = torch.tensor(keep)
        r, p = r[k], p[k]
    den = torch.clamp(r, min=float(torch.median(r)))
    return float(torch.max(torch.abs(p - r) / den))


def norms(ts) -> List[float]:
    return [float(torch.linalg.norm(t.double())) for t in ts]


def median(xs) -> float:
    return float(np.median(np.asarray(xs, dtype=np.float64)))


def rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)

