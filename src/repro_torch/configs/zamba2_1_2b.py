"""zamba2-1.2b [hybrid] — Mamba2 + SHARED attention blocks. [arXiv:2411.15242]

38 Mamba2 blocks; a single parameter-shared attention+MLP block is invoked
every ``hybrid_attn_every`` layers (Zamba's weight-shared global block).
kv=32 (MHA in the shared block).
"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", arch_type="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=32000, mlp="geglu",
    ssm=SSMConfig(state_dim=64, head_dim=64, n_groups=1, expand=2, chunk=128),
    hybrid_attn_every=6, sliding_window=4096,  # shared block uses SWA at 500k
    source="arXiv:2411.15242",
)
