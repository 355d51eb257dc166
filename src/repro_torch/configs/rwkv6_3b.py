"""Arch config: rwkv6-3b (registered on import of `repro_torch.configs`)."""
from repro_torch.config import ModelConfig, register

rwkv6_3b = register(ModelConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=0, d_ff=8960, vocab=65536,
    rwkv_head_k=64, norm="layernorm",
))  # [arXiv:2404.05892] — Finch, attention-free
