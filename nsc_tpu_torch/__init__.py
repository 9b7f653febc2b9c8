"""nsc_tpu_torch: the neural speech codec in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a) on the serving and training paths
(training: `python -m nsc_tpu_torch.train`).

The JAX package `nsc_tpu` is the reference this port is tested against; the
port imports nothing of it and nothing of JAX. Entry points run on CUDA
unless the caller passes `device="cpu"`. Importing the package builds
nothing: the kernels are compiled on their first launch.
"""

__version__ = "0.1.0"

from nsc_tpu_torch.api import (  # noqa: F401,E402
    ModelBundle,
    codebook_fingerprint,
    compress,
    decode,
    decompress,
    encode,
    list_models,
    load_model,
    quantize_model,
    serving_config,
    streaming_compress,
    streaming_decompress,
)
