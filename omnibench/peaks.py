"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates at the full 700 W limit): float32 outside the tensor cores, and HBM3
bandwidth.  The frame loop runs in float32 with TF32 off."""

F32_FLOPS = 67e12
HBM_BYTES_S = 3.35e12
