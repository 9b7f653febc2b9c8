"""Live streams through one `StreamingEncoder` / `StreamingDecoder` pair of
the port at batch "streams", in a closed loop: each round pushes one chunk
of every stream through the encoder, then its indices through the decoder;
the next round starts when the decoded audio is on the host.

Traffic file keys: "streams", "chunk_seconds" at "sample_rate", "queue"
(chunks a push; 1), N(0, amplitude^2) noise from the seed in a host pool of
"pool_seconds" per stream that the rounds walk through and wrap,
"warm_rounds" through a pair that is then dropped, "check_streams" streams
drawn from the seed whose every index and sample is kept for the check,
"trace_rounds" in a traced window.

The check runs the plain float32 reference over each checked stream's
whole input as one sequence (what the streamed indices and audio must
equal, the streaming path being causal): "rvq_gap" along the chain of the
streamed indices from the reference latents, and "wav_err" of the
streamed audio against the reference decoder's of the streamed indices
(as `offline.Offline.compared` takes them).
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import common, seeded
from benchmark.harness.offline import Offline


class Live(Offline):
    part = "serving"
    block = 1

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.dev = cell, int(seed), torch.device(device)
        t = cell.traffic
        if t["queue"] != 1:
            raise ValueError("only queue 1 is driven")
        self.rows = t["streams"]
        self.chunk = int(round(t["chunk_seconds"] * t["sample_rate"]))
        self.codec = common.run_codec(cell.config, self.part)

    def setup(self) -> None:
        from nsc_tpu_torch import api

        t = self.cell.traffic
        port_cfg = common.port_config(self.cell.config, self.part)
        if self.chunk % port_cfg.hop:
            raise ValueError("the chunk is not a multiple of the hop")
        gen = seeded.generator(self.seed, self.dev)
        self.params, self.rvq = seeded.codec_weights(self.codec, gen, self.dev)
        self.bundle = api.bundle_from_jax(port_cfg, self.params, self.rvq, device=self.dev)
        n_chunks = int(round(t["pool_seconds"] / t["chunk_seconds"]))
        pool = torch.randn((self.rows, n_chunks * self.chunk), generator=gen,
                           device=self.dev) * t["amplitude"]
        self.pool = pool.cpu().numpy()
        del pool
        self.checked_rows = np.sort(np.random.RandomState(self.seed % 2**32).choice(
            self.rows, t["check_streams"], replace=False))
        enc, dec = self._pair()
        for r in range(t["warm_rounds"]):
            dec.push(enc.push(self._chunk(r)))
        common.sync(self.dev)

    def _pair(self):
        from nsc_tpu_torch.streaming import StreamingDecoder, StreamingEncoder

        b = self.bundle
        return (StreamingEncoder(b.model, b.params, b.rvq),
                StreamingDecoder(b.model, b.params, b.rvq))

    def _chunk(self, r: int) -> np.ndarray:
        n = self.pool.shape[1] // self.chunk
        s = (r % n) * self.chunk
        return self.pool[:, s:s + self.chunk]

    def window(self, seconds: float, max_units=None, traced: bool = False) -> dict:
        enc, dec = self._pair()
        lat, self.kept_idx, self.kept_wav = [], [], []
        n = 0
        t0 = common.now()
        while True:
            a = common.now()
            idx = enc.push(self._chunk(n))
            wav = dec.push(idx)
            lat.append(common.now() - a)
            self.kept_idx.append(idx[self.checked_rows])
            self.kept_wav.append(wav[self.checked_rows])
            n += 1
            if (max_units is not None and n >= max_units) or (
                    max_units is None and common.now() - t0 >= seconds):
                break
        wall = common.now() - t0
        self.units = n
        audio_s = n * self.rows * self.chunk / self.cell.traffic["sample_rate"]
        return {"wall_s": wall, "units": n, "attempted": n * self.rows, "failed": 0,
                "metrics": {"stream_rtf": audio_s / wall,
                            "stream_chunk_p95_ms": 1e3 * float(np.percentile(lat, 95))}}

    def trace_units(self) -> int:
        return self.cell.traffic["trace_rounds"]

    def checked(self):
        """The checked streams' whole inputs (S, rounds x chunk), with their
        streamed indices and audio."""
        x = np.concatenate([self._chunk(r)[self.checked_rows] for r in range(self.units)], axis=1)
        yield x, np.concatenate(self.kept_idx, axis=1), np.concatenate(self.kept_wav, axis=1)
