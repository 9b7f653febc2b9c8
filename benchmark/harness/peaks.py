"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet, dense rates), against which every roofline share and `mfu` is read."""

PEAK_BF16_FLOPS = 989e12   # tensor cores, bf16 and fp16
PEAK_F32_FLOPS = 67e12     # float32 outside the tensor cores
PEAK_BYTES = 3.35e12       # HBM3 bytes per second
