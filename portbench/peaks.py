"""Published peaks of one NVIDIA H100 SXM (data sheet; dense, no sparsity;
at its 700 W power limit). The float32 configurations' rooflines and MFU
take the dense TF32 rate: cuDNN runs their convolutions in TF32, the fastest
precision float32 allows."""

H100 = {
    "hbm_bytes_per_s": 3.35e12,
    "tf32_flops": 495e12,
    "bf16_flops": 989e12,
    "f32_flops": 67e12,
    "memory_bytes": 80e9,
}
