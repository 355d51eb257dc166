"""Force-field serving: the engine, its scheduler, size-bucketed slot pools
(each bucket's step a CUDA graph on the card), metrics, fault injection and
replica failover.  The LM ``ServeEngine`` and ``Request`` are not ported
yet."""
from .engine import EquivariantRequest, EquivariantServeEngine  # noqa: F401
from .faults import FaultPlan, InjectedFault, injected  # noqa: F401
from .metrics import ServeMetrics, percentile  # noqa: F401
from .pools import BucketSpec, BucketedPools, SlotPool, default_buckets  # noqa: F401
from .replicas import ReplicaSet  # noqa: F401
from .scheduler import AdmissionQueue, Scheduler  # noqa: F401
