"""Model configurations of the language-model path: one dataclass drives the
model build.  Architecture configs live in `repro_torch.configs.<id>` and
register themselves.

A copy of the reference's ``repro.config`` (``ModelConfig``, ``ShapeConfig``,
``SHAPES``, ``TrainConfig``, the registry) that keeps every field, so a
test can compare ``dataclasses.asdict`` field by field.  The port does not
read ``use_pallas``: on CUDA the WKV scan always runs on the Hopper kernel.
``TrainConfig.grad_compression='int8_ef'`` compresses the sharded train
step's cross-pod gradient reduction (`distributed.collectives`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ModelConfig", "ShapeConfig", "TrainConfig", "register", "get_config",
           "list_configs", "SHAPES"]


@dataclasses.dataclass
class ModelConfig:
    name: str
    family: str = "dense"  # dense | moe | hybrid | encdec | vlm | ssm
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: Optional[int] = None  # None -> MHA
    head_dim: Optional[int] = None  # None -> d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1000
    act: str = "swiglu"  # swiglu | geglu | gelu_mlp
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    qkv_bias: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    partial_rotary: float = 1.0  # fraction of head_dim that rotates
    mrope_sections: Optional[tuple[int, ...]] = None  # qwen2-vl M-RoPE
    embed_scale: bool = False  # gemma sqrt(d) embedding scale
    rms_one_offset: bool = False  # gemma (1 + w) rmsnorm
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: Optional[int] = None
    router_aux_loss: float = 0.001
    capacity_factor: float = 1.25
    # --- SSM / RWKV ---
    ssm_state: int = 0
    ssm_headdim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_groups: int = 1
    rwkv_head_k: int = 64
    attn_every: int = 0  # zamba2: shared attention block interval
    # --- enc-dec ---
    n_enc_layers: int = 0
    max_source_len: int = 1500  # whisper frame count after conv stub
    # --- numerics / runtime ---
    dtype: str = "bfloat16"
    param_dtype: str = "float32"
    remat: bool = True
    scan_layers: bool = True
    attn_chunk: int = 1024  # blockwise attention query-chunk
    kv_cache_dtype: str = "model"  # model | int8 (per-position-head scales)
    use_pallas: bool = False  # kept for parity with the reference; not read
    logit_softcap: float = 0.0
    max_seq: int = 8192

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads if self.n_kv_heads is not None else self.n_heads

    @property
    def hd(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    def reduced(self, **over) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        kw = dataclasses.asdict(self)
        kw.update(
            n_layers=min(self.n_layers, 2 if self.attn_every == 0 else self.attn_every),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.kv_heads, 4) if self.kv_heads < self.n_heads else 4,
            head_dim=32,
            d_ff=256,
            vocab=512,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            d_ff_expert=128 if self.d_ff_expert else None,
            ssm_state=min(self.ssm_state, 16),
            ssm_headdim=16,
            rwkv_head_k=16,
            n_enc_layers=min(self.n_enc_layers, 2),
            max_source_len=64,
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            dtype="float32",
            param_dtype="float32",
            attn_chunk=64,
            remat=False,
            max_seq=256,
        )
        if self.mrope_sections:
            kw["mrope_sections"] = (4, 6, 6)
        kw.update(over)
        kw["name"] = self.name + "-smoke"
        return ModelConfig(**kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass
class TrainConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    schedule: str = "cosine"
    microbatch: int = 0  # 0 = no accumulation
    seed: int = 0
    checkpoint_every: int = 200
    keep_checkpoints: int = 3
    grad_compression: str = "none"  # none | int8_ef (pod axis)
    log_every: int = 10


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (registers the port's configs)

    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs() -> list[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)
