"""Arch config: gemma-2b (registered on import of `repro_torch.configs`)."""
from repro_torch.config import ModelConfig, register

gemma_2b = register(ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=256000, act="geglu", norm="rmsnorm",
    embed_scale=True, rms_one_offset=True, tie_embeddings=True,
))  # [arXiv:2403.08295] — MQA, GeGLU, head_dim=256
