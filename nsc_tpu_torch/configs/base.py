"""Codec and training configurations: frozen config dataclasses and a
registry of named codec variants.

This is the PyTorch port's own copy of the codec architecture configs. Field
names, defaults and the named variants are identical to the JAX package's, so
a config name means the same model (and the same bitstream identity) in both.
`TrainConfig` is the port's copy of the training hyperparameters.

Fields that name lowerings of the JAX package (`conv_backend`, `conv_stack`,
`rvq_backend`, `unit_backend`) are kept so the two configs stay identical.
`nsc_tpu_torch.models.codec.KernelOptions.for_config` reads `unit_backend`
as the route of the residual units, under the JAX package's gates ("auto"/
"pallas_ct": K1, "pallas_fused": K6, "pallas_ct_fused": K5, otherwise op
by op), and `rvq_backend == "pallas"` as the RVQ kernels.
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
    rvq_backend: str = "xla"        # "pallas" = the RVQ kernels (K2, K3)
    unit_backend: str = "reference"  # route of the residual units: see KernelOptions
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


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (the port's copy of the JAX package's
    `TrainConfig`: same fields, same defaults).

    The port reads `stft_backend` only as "the loss STFT goes through the
    STFT-magnitude kernel wrapper" (`nsc_tpu_torch.kernels.stft`), whatever
    its value: the wrapper launches the CUDA kernel on a card and runs its
    plain version on CPU tensors. The JAX package's values ("xla",
    "pallas", "pallas_interpret") choose its own lowerings in the parity
    tests.
    """

    batch_size: int = 64
    segment_seconds: float = 1.0
    lr_g: float = 3e-4
    lr_d: float = 3e-4
    adam_b1: float = 0.5
    adam_b2: float = 0.9
    steps: int = 400_000
    # linear warmup over warmup_steps, then (if lr_decay_steps > 0) cosine
    # decay to lr * lr_end_factor at lr_decay_steps; both 0 = constant LR
    warmup_steps: int = 0
    lr_decay_steps: int = 0
    lr_end_factor: float = 0.01
    grad_clip: float = 1.0
    seed: int = 0

    # loss weights
    weight_l1_time: float = 0.1
    weight_mel: float = 15.0
    weight_stft: float = 2.0
    weight_commit: float = 1.0
    weight_adv: float = 1.0
    weight_fm: float = 2.0

    # GAN schedule and discriminator ensemble
    use_gan: bool = True
    disc_start_step: int = 0
    disc_width_mult: float = 1.0
    mpd_periods: Tuple[int, ...] = (2, 3, 5, 7, 11)
    msd_scales: int = 3

    # spectral losses
    stft_fft_sizes: Tuple[int, ...] = (2048, 1024, 512, 256, 128)
    mel_fft_size: int = 1024
    mel_bins: int = 80
    stft_backend: str = "xla"

    # per-sample random RVQ depth with this probability
    quantizer_dropout: float = 0.5
    # step-0 codebook init: "data" (residual sampling + Lloyd) | "random"
    codebook_init: str = "data"

    checkpoint_every: int = 2000
    full_state_every: int = 10_000
    log_every: int = 50
    keep_checkpoints: int = 3
    keep_period: int = 0
    best_metric: str = "loss/mel"


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
