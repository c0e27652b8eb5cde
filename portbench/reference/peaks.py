"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates,
at the full 700 W): what the roofline and MFU readers divide by."""

BF16_FLOPS = 989e12    # tensor cores, bf16 / fp16
F32_FLOPS = 67e12      # float32 outside the tensor cores
HBM_BYTES = 3.35e12    # HBM3 bytes a second
