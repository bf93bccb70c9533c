"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit).  A share is read
against these, with the card's power limit recorded beside it."""

BF16_FLOPS = 989e12       # bfloat16 products on the tensor cores
TF32_FLOPS = 495e12       # float32 products: TF32 on the tensor cores, so
#                           no implementation of fp32 work can read > 100%
HBM_BYTES = 3.35e12       # HBM3 bandwidth, bytes a second

