"""Arch config: zamba2-2.7b (registered on import of `repro_torch.configs`)."""
from repro_torch.config import ModelConfig, register

zamba2_2p7b = register(ModelConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32000, ssm_state=64, ssm_headdim=64, ssm_expand=2, ssm_conv=4,
    attn_every=6, act="geglu", norm="rmsnorm",
))  # [arXiv:2411.15242] — Mamba2 backbone + shared attention blocks
