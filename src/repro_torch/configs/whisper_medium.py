"""whisper-medium [audio] — enc-dec, conv frontend STUB. [arXiv:2212.04356]

input_specs() provides precomputed mel/conv frame embeddings [B, 1500, 1024]
(DESIGN.md carve-out); encoder is bidirectional, decoder causal + cross-attn.
"""
from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium", arch_type="audio",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865, mlp="gelu", rope_theta=0.0,  # learned abs pos
    encoder=EncoderConfig(n_layers=24, enc_len=1500),
    source="arXiv:2212.04356",
)
