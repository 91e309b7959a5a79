"""The published float32 peak of one NVIDIA H100 SXM (NVIDIA's data sheet, dense,
at the full 700 W power limit) and the work counts of the kernels'
rooflines, kept with the benchmark."""

FP32_FLOPS = 67e12          # float32 outside the tensor cores
# floating-point operations of one Moeller-Trumbore ray-triangle test: two
# cross products (18), four dot products (determinant, u, v, t: 20), o - p0
# (3), the reciprocal and three scalings (4), u + v (1)
MT_FLOPS = 46
