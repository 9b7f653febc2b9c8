"""Codec configurations: a frozen config dataclass and a registry of named
variants.

This is the PyTorch port's own copy of the codec architecture configs. Field
names, defaults and the named variants are identical to the JAX package's, so
a config name means the same model (and the same bitstream identity) in both.
Training hyperparameters are not part of it.

Fields that name lowerings of the JAX package (`conv_backend`, `conv_stack`,
`rvq_backend`, `unit_backend`) are kept so the two configs stay identical.
The port reads `unit_backend` and `rvq_backend` only as "serving wants the
kernel"; which CUDA kernel runs is decided by
`nsc_tpu_torch.models.codec.KernelOptions`.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """Architecture of one codec variant (SEANet-style conv AE + RVQ).

    Derived quantities:
      hop = prod(strides)           # samples per latent frame
      frame_rate = sample_rate/hop  # latent frames per second
      bitrate(n_q) = frame_rate * n_q * log2(codebook_size)
    """

    name: str = "base"
    sample_rate: int = 16_000
    channels: int = 1

    # --- encoder/decoder conv stack ---
    base_width: int = 32           # channels after the stem conv
    strides: Tuple[int, ...] = (2, 4, 5, 8)   # hop 320 -> 50 Hz frames @16k
    stem_kernel: int = 7
    residual_kernel: int = 3
    dilations: Tuple[int, ...] = (1, 3, 9)    # per residual unit in a stage
    last_kernel: int = 3           # final encoder conv / first decoder conv
    latent_dim: int = 128
    activation: str = "snake"      # "snake" | "snake_fast" | "elu"
    causal: bool = True
    norm: str = "weight_norm"      # "weight_norm" | "none"

    # --- residual vector quantizer ---
    num_quantizers: int = 16       # max RVQ depth; variable at inference
    codebook_size: int = 1024
    codebook_dim: int = 128        # == latent_dim unless factorized
    ema_decay: float = 0.99
    ema_eps: float = 1e-5
    threshold_dead_code: float = 2.0

    # --- numerics and lowerings ---
    compute_dtype: str = "float32"  # "bfloat16" on the serving path
    param_dtype: str = "float32"
    conv_backend: str = "reference"
    conv_stack: int = 16
    rvq_backend: str = "xla"        # "pallas" = serving wants the RVQ kernels
    unit_backend: str = "reference"  # "auto"/"pallas_ct" = wants the stack kernel
    quant: str = "none"

    @property
    def hop(self) -> int:
        h = 1
        for s in self.strides:
            h *= s
        return h

    @property
    def frame_rate(self) -> float:
        return self.sample_rate / self.hop

    @property
    def bits_per_codebook(self) -> int:
        return (self.codebook_size - 1).bit_length()

    def bitrate(self, n_q: int | None = None) -> float:
        n_q = self.num_quantizers if n_q is None else n_q
        return self.frame_rate * n_q * self.bits_per_codebook


_REGISTRY: Dict[str, Callable[[], CodecConfig]] = {}


def register_config(name: str):
    def deco(fn: Callable[[], CodecConfig]):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_config(name: str) -> CodecConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown config {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_configs() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


@register_config("base")
def _base() -> CodecConfig:
    """Full model: 16 books x 1024 -> up to 8 kbps at 50 Hz frames."""
    return CodecConfig(name="base")


@register_config("small")
def _small() -> CodecConfig:
    """Smallest bitrate/codebook config: 2 books, narrow."""
    return CodecConfig(
        name="small",
        base_width=16,
        strides=(2, 4, 5, 8),
        latent_dim=64,
        codebook_dim=64,
        num_quantizers=2,
        codebook_size=256,
    )


@register_config("small_factorized")
def _small_factorized() -> CodecConfig:
    """Small variant with factorized codes: nearest-neighbour search in a
    16-dim projected space."""
    return CodecConfig(
        name="small_factorized",
        base_width=16,
        strides=(2, 4, 5, 8),
        latent_dim=64,
        codebook_dim=16,
        num_quantizers=2,
        codebook_size=256,
    )


@register_config("base_fast")
def _base_fast() -> CodecConfig:
    """Flagship serving model: the `base` architecture trained with the
    polynomial-sine snake (`snake_fast`), so the serving path runs the
    checkpoint's own activation."""
    return CodecConfig(name="base_fast", activation="snake_fast")


@register_config("base_fast_f")
def _base_fast_f() -> CodecConfig:
    """Factorized flagship: nearest-neighbour search in a 32-dim projected
    space instead of the 128-dim latent space."""
    return CodecConfig(
        name="base_fast_f", activation="snake_fast", codebook_dim=32
    )


@register_config("base_noncausal")
def _base_noncausal() -> CodecConfig:
    """Non-causal (offline) variant: symmetric 'same' padding."""
    return CodecConfig(name="base_noncausal", causal=False)


@register_config("tiny_test")
def _tiny_test() -> CodecConfig:
    """CPU-fast config for tests only."""
    return CodecConfig(
        name="tiny_test",
        base_width=4,
        strides=(2, 2),
        dilations=(1, 3),
        latent_dim=8,
        codebook_dim=8,
        num_quantizers=2,
        codebook_size=16,
    )
