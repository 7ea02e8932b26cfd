"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
700 W), the yardstick of every roofline share the benchmark reports."""

H100_BYTES_PER_S = 3.35e12      # HBM3
H100_BF16_OPS_PER_S = 989e12    # tensor cores, dense
H100_F32_OPS_PER_S = 67e12      # outside the tensor cores
