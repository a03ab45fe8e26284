"""The published bfloat16 peak of one NVIDIA H100 SXM (NVIDIA's data
sheet: dense tensor-core rate, without sparsity, at the full 700 W
limit).  The region-description pod computes in bfloat16."""

BF16_FLOPS = 989e12
