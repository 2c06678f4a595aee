"""Published peaks of the chip the benchmark runs on.

NVIDIA H100 SXM5 data sheet, dense rates without sparsity, at the full
power limit of 700 W: 67 TFLOP/s float32 outside the tensor cores, 495
TFLOP/s TF32, 989 TFLOP/s bf16 / fp16, 3.35 TB/s of HBM3.  A card set
below 700 W runs slower under load: a share of these peaks is stated with
the card's power limit beside it.
"""

FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
