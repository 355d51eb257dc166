"""Arch config: whisper-base (registered on import of `repro_torch.configs`)."""
from repro_torch.config import ModelConfig, register

whisper_base = register(ModelConfig(
    name="whisper-base", family="encdec",
    n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    d_ff=2048, vocab=51865, act="gelu_mlp", norm="layernorm",
    partial_rotary=0.0, max_source_len=1500, max_seq=32768,
))  # [arXiv:2212.04356] — conv frontend stubbed (frame embeddings provided)
