"""Arch config: dbrx-132b (registered on import of `repro_torch.configs`)."""
from repro_torch.config import ModelConfig, register

dbrx_132b = register(ModelConfig(
    name="dbrx-132b", family="moe",
    n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=10752,
    vocab=100352, n_experts=16, top_k=4, d_ff_expert=10752,
    act="swiglu", norm="layernorm", rope_theta=500000.0,
))  # [hf:databricks/dbrx-base]
