"""Hand-written CUDA kernels of the serving and training paths, with their
plain PyTorch versions.

Each wrapper takes its plain version only for tensors on the CPU; on a CUDA
tensor it launches its kernel (built from `nsc_tpu_torch/csrc` on first use)
or raises. `LAUNCHES` counts kernel launches per wrapper, so a run can show
that it went through the kernels.
"""

# "int_mm" counts the int8 products of `ops.quant` on CUDA: library calls
# (torch._int_mm), not kernels of this package; the JAX package computes
# that product outside any Pallas kernel.
LAUNCHES = {
    "residual_stack": 0,
    "rvq_quantize": 0,
    "rvq_split_planes": 0,
    "rvq_dequantize": 0,
    "stft_magnitude": 0,
    "stft_magnitude_dft": 0,
    "residual_stack_cl": 0,
    "fused_stage": 0,
    "int_mm": 0,
}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
