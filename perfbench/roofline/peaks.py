"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit): HBM3 at 3.35 TB/s and 67 TFLOP/s of float32
outside the tensor cores, the only rate the port's float32 kernels and
products can use with TF32 off."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
