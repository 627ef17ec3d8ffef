"""repro_torch.runtime — fault tolerance: restart, preemption,
stragglers (``runtime.fault_tolerance``), plus the deterministic
fault-injection harness (``runtime.chaos``) and the lock-discipline
annotation (``runtime.guards``), copied from ``repro.runtime``."""

from .chaos import (
    BatchFaults,
    CrashSchedule,
    InjectedCrash,
    TransientError,
    TransientFaults,
    flip_bit,
    flip_bits,
    truncate,
)
from .fault_tolerance import (
    Preemption,
    PreemptionSchedule,
    StragglerMonitor,
    TrainLoop,
)
from .guards import guarded_by

__all__ = [
    "BatchFaults",
    "CrashSchedule",
    "InjectedCrash",
    "Preemption",
    "PreemptionSchedule",
    "StragglerMonitor",
    "TrainLoop",
    "TransientError",
    "TransientFaults",
    "flip_bit",
    "flip_bits",
    "guarded_by",
    "truncate",
]
