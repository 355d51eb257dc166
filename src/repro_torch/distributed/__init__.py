"""Distribution of the port on `torch.distributed`: the partitioning rules
and row-parallel dispatch (`sharding`), the int8 error-feedback cross-pod
reduction (`collectives`), elastic resharding (`elastic`) and the
fault-tolerance helpers that serving and the training loop use
(`fault_tolerance`)."""
from .sharding import (  # noqa: F401
    param_shardings,
    batch_shardings,
    cache_shardings,
    choose_pspec,
    DP_AXES,
)
