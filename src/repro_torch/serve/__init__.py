"""Serving: the LM `ServeEngine` (its decode step a CUDA graph on the card)
and the force-field engine with its scheduler, size-bucketed slot pools
(each bucket's step a CUDA graph on the card), metrics, fault injection and
replica failover."""
from .engine import EquivariantRequest, EquivariantServeEngine, Request, ServeEngine  # noqa: F401
from .faults import FaultPlan, InjectedFault, injected  # noqa: F401
from .metrics import ServeMetrics, percentile  # noqa: F401
from .pools import BucketSpec, BucketedPools, SlotPool, default_buckets  # noqa: F401
from .replicas import ReplicaSet  # noqa: F401
from .scheduler import AdmissionQueue, Scheduler  # noqa: F401
