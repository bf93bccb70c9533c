"""mamba2-1.3b [ssm] — SSD (state-space duality), attn-free. [arXiv:2405.21060]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b", arch_type="ssm",
    n_layers=48, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280, mlp="none",
    ssm=SSMConfig(state_dim=128, head_dim=64, n_groups=1, expand=2, chunk=128),
    source="arXiv:2405.21060",
)
