"""Arch config: qwen2-vl-72b (registered on import of `repro_torch.configs`)."""
from repro_torch.config import ModelConfig, register

qwen2_vl_72b = register(ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=29568,
    vocab=152064, qkv_bias=True, act="swiglu", norm="rmsnorm",
    rope_theta=1000000.0, mrope_sections=(16, 24, 24),
))  # [arXiv:2409.12191] — M-RoPE; vision tower stubbed (patch embeddings)
