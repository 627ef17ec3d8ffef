"""repro_torch.store — the store pieces single-forest serving needs: the
device tile arena (torch tensors on an explicit device), the decoded tile
cache, the shared GreedyDual policy, and the synthetic fleet generator.
The fleet registry (shared codebooks, user deltas, lifecycle, durable
tier) waits for later slices (ROADMAP Queue 1 items 5-8)."""

from .arena import TileArena
from .fleet import make_drifted_fleet, make_request_batch, make_synthetic_fleet
from .runtime import ForestStore, TileCache, build_store, make_schema_arena

__all__ = [
    "ForestStore",
    "TileArena",
    "TileCache",
    "build_store",
    "make_drifted_fleet",
    "make_request_batch",
    "make_schema_arena",
    "make_synthetic_fleet",
]
