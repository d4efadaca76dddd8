"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at its 700 W limit). The configurations run f32
with TF32 off, so their work is held to the f32 rate outside the tensor
cores."""
F32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12
