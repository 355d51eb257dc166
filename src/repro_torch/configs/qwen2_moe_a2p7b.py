"""Arch config: qwen2-moe-a2.7b (registered on import of `repro_torch.configs`)."""
from repro_torch.config import ModelConfig, register

qwen2_moe_a2p7b = register(ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=5632,
    vocab=151936, n_experts=60, top_k=4, n_shared_experts=4, d_ff_expert=1408,
    qkv_bias=True, act="swiglu", norm="rmsnorm", rope_theta=1000000.0,
))  # [hf:Qwen/Qwen1.5-MoE-A2.7B]
