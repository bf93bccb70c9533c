"""chameleon-34b [vlm] — early-fusion, VQ image tokens. [arXiv:2405.09818]

Early fusion IS token-level: image patches arrive as VQ codebook ids inside
the 65536 vocab; the VQ codec itself is the stubbed modality frontend
(DESIGN.md carve-out). The backbone below is the full 34B decoder.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", arch_type="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=65536, mlp="swiglu",
    source="arXiv:2405.09818",
)
