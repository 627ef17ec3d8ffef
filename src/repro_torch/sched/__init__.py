"""Continuous-batching request scheduler + self-driving codebook
lifecycle — the port of ``repro.sched``.

The package layers an ONLINE front onto the serving session
(``serving.server.ForestServer``) and the codebook lifecycle machinery
(``store.lifecycle``):

* :mod:`repro_torch.sched.clock` — wall/virtual clock injection; everything
  below reads time through it, so tests are bit-deterministic.
* :mod:`repro_torch.sched.queue` — per-tenant FIFO with bounded admission.
* :mod:`repro_torch.sched.batcher` — dual-trigger (rows budget / SLO
  deadline) micro-batch formation, tenant-coherent and plan-cache
  friendly.
* :mod:`repro_torch.sched.executor` — plan(k+1)/execute(k) overlap with
  ``serve_safe`` per-request semantics and batch-level fault isolation.
* :mod:`repro_torch.sched.driver` — autonomous drift-poll -> journaled
  recluster -> rate-limited migration loop.
* :mod:`repro_torch.sched.scheduler` — the facade tying them together.

Port note: every module is copied from the reference with its relative
imports; names, signatures and semantics are the reference's.  Nothing
here takes a ``device``: the ``ForestServer`` a ``Scheduler`` wraps
carries it, resolved once when the server and its store are built.
Under overlap the serve path (``serve_safe`` -> K1 on the card) runs
on the ``sched-executor`` thread while the pump thread pre-plans the
next batch; the residency ``Prefetcher``, when attached, is a third
thread that does host work only.
"""
from .batcher import MicroBatch, MicroBatcher
from .clock import VirtualClock, WallClock
from .driver import LifecycleDriver
from .executor import PipelinedExecutor
from .queue import AdmissionError, RequestQueue, SchedRequest
from .scheduler import Scheduler

__all__ = [
    "AdmissionError",
    "LifecycleDriver",
    "MicroBatch",
    "MicroBatcher",
    "PipelinedExecutor",
    "RequestQueue",
    "SchedRequest",
    "Scheduler",
    "VirtualClock",
    "WallClock",
]
