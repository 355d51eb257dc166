"""Model configurations.  Importing this package registers the ten language-model
configs (`repro_torch.config.get_config`); the paper's equivariant model
configs are `configs.gaunt_ff`'s, re-exported here."""
from repro_torch.configs.dbrx_132b import dbrx_132b  # noqa: F401
from repro_torch.configs.qwen2_moe_a2p7b import qwen2_moe_a2p7b  # noqa: F401
from repro_torch.configs.qwen15_32b import qwen15_32b  # noqa: F401
from repro_torch.configs.qwen2_0p5b import qwen2_0p5b  # noqa: F401
from repro_torch.configs.stablelm_3b import stablelm_3b  # noqa: F401
from repro_torch.configs.gemma_2b import gemma_2b  # noqa: F401
from repro_torch.configs.zamba2_2p7b import zamba2_2p7b  # noqa: F401
from repro_torch.configs.rwkv6_3b import rwkv6_3b  # noqa: F401
from repro_torch.configs.whisper_base import whisper_base  # noqa: F401
from repro_torch.configs.qwen2_vl_72b import qwen2_vl_72b  # noqa: F401
from repro_torch.configs.gaunt_ff import (  # noqa: F401
    gaunt_equiformer_selfmix, gaunt_mace_ff, gaunt_segnn_nbody)

ALL_LM_ARCHS = [
    "dbrx-132b", "qwen2-moe-a2.7b", "qwen1.5-32b", "qwen2-0.5b",
    "stablelm-3b", "gemma-2b", "zamba2-2.7b", "whisper-base",
    "qwen2-vl-72b", "rwkv6-3b",
]

# archs with sub-quadratic decode (their state does not grow with the sequence)
SUBQUADRATIC = {"zamba2-2.7b", "rwkv6-3b"}
