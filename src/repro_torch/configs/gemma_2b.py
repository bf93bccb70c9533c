"""gemma-2b [dense] — GeGLU, head_dim=256, MQA. [arXiv:2403.08295]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", arch_type="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=256000, mlp="geglu", tie_embeddings=True,
    source="arXiv:2403.08295",
)
