"""mixtral-8x7b [moe] — 8 experts top-2, SWA. [arXiv:2401.04088]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="mixtral-8x7b", arch_type="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=32000, mlp="swiglu", sliding_window=4096,
    moe=MoEConfig(n_experts=8, top_k=2, capacity_factor=1.25),
    source="arXiv:2401.04088",
)
