"""glm4-9b [dense] — RoPE, GQA kv=2. [hf:THUDM/glm-4-9b]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="glm4-9b", arch_type="dense",
    n_layers=40, d_model=4096, n_heads=32, n_kv_heads=2,
    d_ff=13696, vocab=151552, mlp="swiglu",
    source="hf:THUDM/glm-4-9b",
)
