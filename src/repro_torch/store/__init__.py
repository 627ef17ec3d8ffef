"""repro_torch.store — the multi-tenant compressed forest store, ported.

The paper's subscriber scenario at fleet scale: one fleet-level shared
codebook (Bregman clustering over the UNION of all users' empirical
models), per-user delta encoding that references shared clusters and ships
only residual streams, a cached decode runtime, and a device-resident tile
arena (torch tensors on an explicit device) for the pipelined and sharded
serving engines.  ``drift_report`` is the codebook-lifecycle monitor the
serving session's ``stats()`` reads.

Serving goes through ``repro_torch.serving.ForestServer``; the RFS1 /
RFD1 / RFT1 frames are those of ``docs/format.md``, byte for byte.

Not ported yet, and raising ``NotImplementedError`` when named: the
codebook lifecycle's recluster, migration and remap (ROADMAP Queue 1 item
7), and the durable tier, residency and streaming builds (item 8).
"""

from ..core.framing import UnrepairableError, atomic_write_bytes
from .arena import TileArena
from .codebook import SharedCodebook, SharedComponent, build_shared_codebook
from .delta import UserDelta, encode_user_delta, hydrate, reconstruct_user
from .fleet import make_drifted_fleet, make_request_batch, make_synthetic_fleet
from .lifecycle import drift_report
from .runtime import ForestStore, TileCache, build_store, make_schema_arena

__all__ = [
    "ForestStore",
    "SharedCodebook",
    "SharedComponent",
    "TileArena",
    "TileCache",
    "UnrepairableError",
    "UserDelta",
    "atomic_write_bytes",
    "build_shared_codebook",
    "build_store",
    "drift_report",
    "encode_user_delta",
    "hydrate",
    "make_drifted_fleet",
    "make_request_batch",
    "make_schema_arena",
    "make_synthetic_fleet",
    "reconstruct_user",
]

#: The reference's store names that later slices port, by ROADMAP Queue 1
#: item.
_LATER = {
    **dict.fromkeys(
        ("MigrationJournal", "ReclusterResult", "RemapTable",
         "extend_codebook_from_forests", "migrate_user", "migrate_users",
         "recluster", "resume_recluster"),
        7,
    ),
    **dict.fromkeys(
        ("DurableStore", "Scrubber", "attach_auto_repair", "xor_parity",
         "Prefetcher", "ResidencyManager", "attach_residency",
         "build_store_streaming"),
        8,
    ),
}


def __getattr__(name: str):
    item = _LATER.get(name)
    if item is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    raise NotImplementedError(
        f"repro_torch.store.{name} is not ported yet: ROADMAP Queue 1 item "
        f"{item}"
    )
