"""The codec model: encoder + RVQ + decoder (counterpart of
`nsc_tpu/models/codec.py`).

`NeuralSpeechCodec` holds only the config and the kernel options; weights
live in two dicts passed explicitly (see `nsc_tpu_torch.weights`):

  params = {'encoder': ..., 'decoder': ..., ['proj_in', 'proj_out']}
  rvq    = {'codebooks': (n_q, K, D) float32}

Public layouts are the JAX package's: waveforms (N, T), indices
(N, F, n_q) int32, latents (N, F, D). Inside, activations are (N, C, T).

Training (`forward`) takes the training tree instead: the JAX package's
layout, weight-norm as (v, g) leaves, materialized on every call so the
gradient reaches v and g (see `nsc_tpu_torch.weights.train_state_from_jax`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from nsc_tpu_torch.configs import CodecConfig
from nsc_tpu_torch.models import seanet
from nsc_tpu_torch.ops import rvq as rvq_ops
from nsc_tpu_torch.ops.precision import float32_numerics

Params = Dict[str, Any]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class KernelOptions:
    """Which hand-written kernels the inference methods run.

    units: the route of the SEANet stages' residual units (`seanet.
      UNIT_ROUTES`): "residual_stack" (K1), "residual_stack_cl" (K6),
      "fused_stage" (K5, boundary convs fused in) or "reference" (op by op).
    rvq: K2/K3 for the RVQ search and sum.

    `for_config` selects them from the config's `unit_backend` and
    `rvq_backend` under the JAX package's gates (`seanet.unit_route`);
    `CodecConfig` itself keeps the JAX package's fields only. The weights
    carry only what the selected route runs (`weights.from_jax_params`)."""

    units: str = "reference"
    rvq: bool = False

    def __post_init__(self):
        if self.units not in seanet.UNIT_ROUTES:
            raise ValueError(f"units must be one of {seanet.UNIT_ROUTES}, got {self.units!r}")

    @classmethod
    def for_config(cls, cfg: CodecConfig) -> "KernelOptions":
        return cls(units=seanet.unit_route(cfg), rvq=cfg.rvq_backend == "pallas")


@dataclasses.dataclass(frozen=True)
class NeuralSpeechCodec:
    cfg: CodecConfig
    kernels: Optional[KernelOptions] = None

    def __post_init__(self):
        if self.cfg.quant not in ("none", "int8"):
            raise ValueError(f"quant must be 'none' or 'int8', got {self.cfg.quant!r}")
        if self.kernels is None:
            object.__setattr__(self, "kernels", KernelOptions.for_config(self.cfg))

    # -- inference ---------------------------------------------------------
    # Each inference method runs under `float32_numerics()`: the float32
    # convs and matmuls (all of the float32 path; the projections and the
    # RVQ's float32 parts of the bf16 path) are true float32 whatever the
    # caller's TF32 settings, which come back after the call.

    @float32_numerics()
    def encode(
        self, params: Params, rvq: rvq_ops.RVQState, wav: torch.Tensor,
        n_q: Optional[int] = None,
    ) -> torch.Tensor:
        """(N, T) or (N, T, 1) waveform -> (N, F, n_q) int32 indices."""
        return rvq_ops.quantize(
            rvq, self.latents(params, wav), n_q=n_q, kernel=self.kernels.rvq
        )

    @float32_numerics()
    def latents(self, params: Params, wav: torch.Tensor) -> torch.Tensor:
        """(N, T) waveform -> (N, F, D) pre-quantization latents (projected
        into codebook space for factorized configs)."""
        x = self._shape_wav(wav)
        z = seanet.apply_encoder(
            params["encoder"], x, self.cfg, units=self.kernels.units
        )
        return self._project_in(params, z.transpose(1, 2))

    @float32_numerics()
    def decode(
        self, params: Params, rvq: rvq_ops.RVQState, indices: torch.Tensor,
        n_q: Optional[int] = None,
    ) -> torch.Tensor:
        """(N, F, n_q) indices -> (N, F*hop) float32 waveform."""
        z = rvq_ops.dequantize(rvq, indices, n_q=n_q, kernel=self.kernels.rvq)
        return self._decode_z(params, z)

    @float32_numerics()
    def reconstruct(
        self, params: Params, rvq: rvq_ops.RVQState, wav: torch.Tensor,
        n_q: Optional[int] = None,
    ) -> torch.Tensor:
        """encode -> decode (the serving benchmark path)."""
        return self.decode(params, rvq, self.encode(params, rvq, wav, n_q), n_q)

    @float32_numerics()
    def decode_latents(self, params: Params, z: torch.Tensor) -> torch.Tensor:
        """(N, F, D) codebook-space latents -> (N, F*hop) waveform, skipping
        quantization (the infinite-bitrate bound of the autoencoder)."""
        return self._decode_z(params, z.float())

    # -- training ----------------------------------------------------------

    def forward(
        self, tree: Params, rvq: rvq_ops.RVQState, wav: torch.Tensor,
        *, depth: Optional[torch.Tensor] = None, axis=None,
    ) -> Tuple[torch.Tensor, rvq_ops.RVQForward, torch.Tensor]:
        """The differentiable training pass: encoder -> RVQ forward (straight
        through, EMA stats) -> decoder, residual units op by op (the stack
        kernel has no backward). Returns (reconstruction (N, T), RVQ
        forward, latents (N, F, D) in codebook space). With `axis` (a
        `parallel.Mesh`) the RVQ's EMA stats are summed over its ranks."""
        z = self.train_latents(tree, wav)
        fwd = rvq_ops.forward(rvq, z, depth=depth, axis=axis)
        zq = self._project_out(tree, fwd.quantized).to(self.compute_dtype)
        dec = seanet.materialize_decoder(tree["decoder"])
        recon = seanet.apply_decoder(dec, zq.transpose(1, 2), self.cfg)
        return recon[:, 0, :], fwd, z

    def train_latents(self, tree: Params, wav: torch.Tensor) -> torch.Tensor:
        """`latents` on the training tree: (N, T) -> (N, F, D) in codebook
        space, differentiable."""
        enc = seanet.materialize_encoder(tree["encoder"])
        z = seanet.apply_encoder(enc, self._shape_wav(wav), self.cfg)
        return self._project_in(tree, z.transpose(1, 2))

    # -- helpers -----------------------------------------------------------

    @property
    def compute_dtype(self) -> torch.dtype:
        return DTYPES[self.cfg.compute_dtype]

    @property
    def factorized(self) -> bool:
        return self.cfg.codebook_dim != self.cfg.latent_dim

    def _decode_z(self, params: Params, z: torch.Tensor) -> torch.Tensor:
        z = self._project_out(params, z).to(self.compute_dtype)
        wav = seanet.apply_decoder(
            params["decoder"], z.transpose(1, 2), self.cfg, units=self.kernels.units
        )
        return wav[:, 0, :].float()

    def _project_in(self, params: Params, z: torch.Tensor) -> torch.Tensor:
        """latent -> codebook space, in float32 (identity if not factorized)."""
        if not self.factorized:
            return z
        return torch.matmul(z.float(), params["proj_in"].float())

    def _project_out(self, params: Params, zq: torch.Tensor) -> torch.Tensor:
        if not self.factorized:
            return zq
        return torch.matmul(zq.float(), params["proj_out"].float())

    def _shape_wav(self, wav: torch.Tensor) -> torch.Tensor:
        """(N, T) or (N, T, channels) -> (N, channels, T) in compute dtype."""
        if wav.dim() == 2:
            wav = wav[..., None]
        if wav.dim() != 3 or wav.shape[-1] != self.cfg.channels:
            raise ValueError(
                f"expected (N, T) or (N, T, {self.cfg.channels}), got "
                f"{tuple(wav.shape)}"
            )
        return wav.transpose(1, 2).to(self.compute_dtype).contiguous()

    def frames_for_samples(self, t: int) -> int:
        return (t - 1) // self.cfg.hop + 1
