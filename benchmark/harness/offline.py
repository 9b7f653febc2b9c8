"""Offline batch compression through the port's API, in a closed loop:
`api.encode` of a batch of clips, then `api.decode` of its indices, back to
back; the indices and the waveforms come back to the host each time.

Traffic file keys: "batch" clips of "clip_seconds" s at "sample_rate",
N(0, amplitude^2) noise from the seed, "pool_batches" distinct batches
cycled, "warm_batches" at set-up, "kept_batches" kept for the check (a
reservoir sample over the window, drawn from the seed), "trace_batches" in
a traced window.

The check (`check`) runs the plain float32 reference once the window has
closed and the program is freed: the reference's latents of each kept
clip, and along the residual chain the program's indices make from them,
how much worse each chosen codeword is than the best one ("rvq_gap", the
widest over every frame and book); and the reference decoder's waveform of
the program's indices against the program's ("wav_err", the widest L2 gap
of a clip over the gap that the same decoder with bf16 rounding makes, in
that clip or in the median clip, whichever is larger).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import common, seeded
from benchmark.reference import codec as ref


class Offline:
    part = "serving"
    block = 16  # rows a block of the reference

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.dev = cell, int(seed), torch.device(device)
        t = cell.traffic
        self.rows = t["batch"]
        self.samples = int(round(t["clip_seconds"] * t["sample_rate"]))
        self.codec = common.run_codec(cell.config, self.part)

    # -- set-up ------------------------------------------------------------

    def setup(self) -> None:
        from nsc_tpu_torch import api

        t = self.cell.traffic
        port_cfg = common.port_config(self.cell.config, self.part)
        if port_cfg.sample_rate != t["sample_rate"]:
            raise ValueError("traffic sample rate differs from the configuration's")
        gen = seeded.generator(self.seed, self.dev)
        self.params, self.rvq = seeded.codec_weights(self.codec, gen, self.dev)
        self.bundle = api.bundle_from_jax(port_cfg, self.params, self.rvq, device=self.dev)
        pool = torch.randn((t["pool_batches"], self.rows, self.samples), generator=gen,
                           device=self.dev) * t["amplitude"]
        self.pool = pool.cpu().numpy()
        del pool
        for i in range(t["warm_batches"]):
            self._batch(i)
        common.sync(self.dev)

    def _batch(self, i: int):
        from nsc_tpu_torch import api

        idx = api.encode(self.bundle, self.pool[i % len(self.pool)])
        return idx, api.decode(self.bundle, idx)

    # -- window ------------------------------------------------------------

    def window(self, seconds: float, max_units=None, traced: bool = False) -> dict:
        """Batches back to back until `seconds` have passed (or `max_units`
        batches are done); a reservoir of kept outputs."""
        rng = np.random.RandomState(self.seed % 2**32)
        keep = self.cell.traffic["kept_batches"]
        self.kept = []
        n = 0
        t0 = common.now()
        while True:
            idx, wav = self._batch(n)
            if len(self.kept) < keep:
                self.kept.append((n, idx, wav))
            else:
                j = rng.randint(0, n + 1)
                if j < keep:
                    self.kept[j] = (n, idx, wav)
            n += 1
            if (max_units is not None and n >= max_units) or (
                    max_units is None and common.now() - t0 >= seconds):
                break
        wall = common.now() - t0
        audio_s = n * self.rows * self.samples / self.cell.traffic["sample_rate"]
        return {"wall_s": wall, "units": n, "attempted": n * self.rows, "failed": 0,
                "metrics": {"serve_rtf": audio_s / wall}}

    def trace_units(self) -> int:
        return self.cell.traffic["trace_batches"]

    def release(self) -> None:
        del self.bundle
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # -- check -------------------------------------------------------------

    def judge(self, x: np.ndarray, idx: np.ndarray, wav: np.ndarray, block: int = 16):
        """Of clips x (N, T), indices (N, F, n_q) and waveforms (N, T), the
        reference in float32 (TF32 off): the widest index gap, and per clip
        the L2 norm of the waveform's gap from the reference decoder's of
        the same indices, and of the gap that decoder's bf16 rounding makes."""
        books = self.rvq["codebooks"]
        bf16 = ref.Numerics("bf16")
        gap, diff, norm = 0.0, [], []
        with common.tf32(False), torch.no_grad():
            for r0 in range(0, x.shape[0], block):
                xb = torch.from_numpy(np.ascontiguousarray(x[r0:r0 + block])).to(self.dev)
                ib = torch.from_numpy(np.ascontiguousarray(idx[r0:r0 + block])).to(self.dev)
                wb = torch.from_numpy(np.ascontiguousarray(wav[r0:r0 + block])).to(self.dev)
                n, f, q = ib.shape
                z = ref.encode_latents(self.params, xb, self.codec)
                gaps = ref.index_gaps(books, z.reshape(n * f, -1), ib.reshape(n * f, q))
                gap = max(gap, max(g.max().item() for g in gaps))
                zq = ref.dequantize(books, ib.reshape(n * f, q)).reshape(n, f, -1)
                wr = ref.decode_latents(self.params, zq, self.codec)
                w16 = ref.decode_latents(self.params, zq, self.codec, bf16)
                diff += torch.linalg.norm(wb - wr, dim=-1).tolist()
                norm += torch.linalg.norm(w16 - wr, dim=-1).tolist()
        return gap, diff, norm

    def compared(self, outputs) -> dict:
        """rvq_gap: the widest index gap; wav_err: the widest waveform gap
        of a clip over the gap bf16 rounding makes in that clip or in the
        median clip, whichever is larger. Against the waveform's own norm the
        gap swings 6x from seed to seed with the random decoder's gain, the
        lower precision's gap with it; against bf16's own gap it does not."""
        gap, diff, norm = 0.0, [], []
        for g, d, n in outputs:
            gap, diff, norm = max(gap, g), diff + d, norm + n
        d, n = np.asarray(diff), np.asarray(norm)
        return {"rvq_gap": gap, "wav_err": float(np.max(d / np.maximum(n, np.median(n))))}

    def checked(self):
        """(clips, indices, waveforms) of what the window produced that the
        check compares."""
        for i, idx, wav in self.kept:
            yield self.pool[i % len(self.pool)], idx, wav

    def check(self) -> dict:
        return self.compared([self.judge(x, idx, wav, self.block) for x, idx, wav in self.checked()])

    def control(self, precision: str = "fp8") -> dict:
        """The reference in `precision` put in the program's place, on the
        checked clips, judged as the program is."""
        num = ref.Numerics(precision)
        books = self.rvq["codebooks"]
        outputs = []
        for x, _, _ in self.checked():
            idx, wav = [], []
            with common.tf32(False), torch.no_grad():
                for r0 in range(0, x.shape[0], self.block):
                    xb = torch.from_numpy(np.ascontiguousarray(x[r0:r0 + self.block])).to(self.dev)
                    z = ref.encode_latents(self.params, xb, self.codec, num)
                    n, f, d = z.shape
                    ib = ref.quantize(books, z.reshape(n * f, d))
                    zq = ref.dequantize(books, ib).reshape(n, f, d)
                    idx.append(ib.reshape(n, f, -1).cpu().numpy())
                    wav.append(ref.decode_latents(self.params, zq, self.codec, num).cpu().numpy())
            outputs.append(self.judge(x, np.concatenate(idx), np.concatenate(wav), self.block))
        return self.compared(outputs)
