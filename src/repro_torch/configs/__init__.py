"""Model configurations.  Importing this package registers the language-model
configs the port carries (`repro_torch.config.get_config`); the force-field
configs are imported from `configs.gaunt_ff` directly."""
from repro_torch.configs.rwkv6_3b import rwkv6_3b  # noqa: F401
from repro_torch.configs.zamba2_2p7b import zamba2_2p7b  # noqa: F401
