"""The card's peaks, from NVIDIA's data sheet of the H100 SXM (dense, no
sparsity, at its full 700 W): what a roofline share or an MFU is taken
against. The precision of a configuration picks the tensor-core rate: a
float32 product runs no faster on the card than in TF32."""

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12               # outside the tensor cores
TENSOR_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
