"""repro_torch.store — the multi-tenant compressed forest store, ported.

The paper's subscriber scenario at fleet scale: one fleet-level shared
codebook (Bregman clustering over the UNION of all users' empirical
models), per-user delta encoding that references shared clusters and ships
only residual streams, a cached decode runtime, a device-resident tile
arena (torch tensors on an explicit device) for the pipelined and sharded
serving engines, and a codebook LIFECYCLE (``store.lifecycle``):
versioned codebook generations, a drift monitor, and online
re-clustering that migrates user deltas bit-exactly onto a successor
codebook, made crash-safe by the RFJ1 journal.

Durability (``store.durable``): the fleet's on-disk tier — parity-
protected slab files indexed by an epoch-versioned RFN1 manifest, atomic
commits, crash recovery, parity repair of any single corrupt-or-missing
shard, background scrubbing, and lazy per-user loading into a store on
an explicit device.  Residency (``store.residency``) holds host memory
to a byte budget, demoting cold users back to disk and dropping their
arena runs; ``store.streaming`` builds a durable fleet in bounded waves.

Serving goes through ``repro_torch.serving.ForestServer``; the on-disk
formats (RFS1/RFD1/RFT1/RFM1/RFJ1/RFN1) are those of ``docs/format.md``,
byte for byte.
"""

from ..core.framing import UnrepairableError, atomic_write_bytes
from .arena import TileArena
from .codebook import SharedCodebook, SharedComponent, build_shared_codebook
from .delta import UserDelta, encode_user_delta, hydrate, reconstruct_user
from .durable import DurableStore, Scrubber, attach_auto_repair, xor_parity
from .fleet import make_drifted_fleet, make_request_batch, make_synthetic_fleet
from .lifecycle import (
    MigrationJournal,
    ReclusterResult,
    RemapTable,
    drift_report,
    extend_codebook_from_forests,
    migrate_user,
    migrate_users,
    recluster,
    resume_recluster,
)
from .residency import Prefetcher, ResidencyManager, attach_residency
from .runtime import ForestStore, TileCache, build_store, make_schema_arena
from .streaming import build_store_streaming

__all__ = [
    "DurableStore",
    "ForestStore",
    "MigrationJournal",
    "Prefetcher",
    "ReclusterResult",
    "RemapTable",
    "ResidencyManager",
    "Scrubber",
    "SharedCodebook",
    "SharedComponent",
    "TileArena",
    "TileCache",
    "UnrepairableError",
    "UserDelta",
    "atomic_write_bytes",
    "attach_auto_repair",
    "attach_residency",
    "build_shared_codebook",
    "build_store",
    "build_store_streaming",
    "drift_report",
    "extend_codebook_from_forests",
    "encode_user_delta",
    "hydrate",
    "make_drifted_fleet",
    "make_request_batch",
    "make_schema_arena",
    "make_synthetic_fleet",
    "migrate_user",
    "migrate_users",
    "recluster",
    "reconstruct_user",
    "resume_recluster",
    "xor_parity",
]
