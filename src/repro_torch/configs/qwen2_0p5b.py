"""Arch config: qwen2-0.5b (registered on import of `repro_torch.configs`)."""
from repro_torch.config import ModelConfig, register

qwen2_0p5b = register(ModelConfig(
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab=151936, qkv_bias=True, tie_embeddings=True, act="swiglu",
    norm="rmsnorm", rope_theta=1000000.0,
))  # [arXiv:2407.10671]
