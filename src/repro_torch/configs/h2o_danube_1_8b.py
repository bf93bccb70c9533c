"""h2o-danube-1.8b [dense] — llama+mistral mix, SWA. [arXiv:2401.16818]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", arch_type="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab=32000, mlp="swiglu", sliding_window=4096,
    source="arXiv:2401.16818",
)
