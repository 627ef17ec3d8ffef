"""repro_torch.runtime — the deterministic fault-injection harness
(``runtime.chaos``) and the lock-discipline annotation
(``runtime.guards``), copied from ``repro.runtime``."""

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
from .guards import guarded_by

__all__ = [
    "BatchFaults",
    "CrashSchedule",
    "InjectedCrash",
    "TransientError",
    "TransientFaults",
    "flip_bit",
    "flip_bits",
    "guarded_by",
    "truncate",
]
