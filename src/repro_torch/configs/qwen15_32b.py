"""Arch config: qwen1.5-32b (registered on import of `repro_torch.configs`)."""
from repro_torch.config import ModelConfig, register

qwen15_32b = register(ModelConfig(
    name="qwen1.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40, d_ff=27392,
    vocab=152064, qkv_bias=True, act="swiglu", norm="rmsnorm",
    rope_theta=1000000.0,
))
