"""Arch config: stablelm-3b (registered on import of `repro_torch.configs`)."""
from repro_torch.config import ModelConfig, register

stablelm_3b = register(ModelConfig(
    name="stablelm-3b", family="dense",
    n_layers=32, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=6912,
    vocab=50304, act="swiglu", norm="layernorm", partial_rotary=0.25,
))  # [hf:stabilityai/stablelm-*]
