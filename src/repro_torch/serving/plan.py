"""The serving session's plan IR (ISSUE 4 tentpole).

``ForestServer.plan(requests)`` compiles a mixed-user request batch into an
explicit ``ServePlan``: grouped users (segment ids), the segment-sort
permutation, per-request row slices, padded shapes, and a resolved
``EngineChoice`` picked by a COST MODEL instead of string kwargs.  Plans
are pure host metadata — hashable by the batch's user-run signature — so
``PlanCache`` can memoize both the plan and (keyed by the same signature)
the arena-gathered device pack it resolves to at execute time.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from .pack import batch_layout

#: Per-engine (block_trees, block_obs) sweet spots (PR 3 tuning).
ENGINE_BLOCKS = {
    "simple": (32, 256),
    "pipelined": (8, 128),
    "sharded": (8, 128),
}

#: Sharding only pays when the greedy bin-pack spreads the batch's trees
#: reasonably evenly — below this predicted speedup the collective plus
#: replicated-batch overhead wins and the cost model stays single-device.
MIN_SHARD_SPEEDUP = 1.3

#: Tree totals below this aren't worth a cross-device collective.
MIN_SHARD_TREES = 64

@dataclass(frozen=True)
class EngineChoice:
    """A resolved serving engine: name + block sizes.  ``reason`` records
    why the cost model picked it (excluded from equality/hash so plans
    keyed on the choice don't fragment on prose)."""

    name: str  # "simple" | "pipelined" | "sharded"
    block_trees: int
    block_obs: int
    reason: str = field(default="", compare=False)


@dataclass
class ServePlan:
    """The plan half of the plan/execute IR: everything about a request
    batch that does not depend on the row VALUES — grouping, sort order,
    padded shapes, engine choice — plus the hashable ``signature`` the
    cross-batch ``PlanCache`` keys gathered packs by."""

    signature: tuple  # ((user, rows)..., engine, block_trees, block_obs)
    user_tokens: tuple[int, ...]  # per-user versions (aligned with users):
    # the plan's validity token — only a change to one of ITS users'
    # registrations makes it stale (partial invalidation)
    request_users: tuple[str, ...]
    row_counts: tuple[int, ...]
    users: tuple[str, ...]  # first-appearance order == segment ids
    seg_trees: np.ndarray  # (S,) int64 per-user tree counts
    row_slices: tuple[slice, ...]
    n_rows: int
    obs_seg: np.ndarray  # (N,) int32 segment id per row (request order)
    order: np.ndarray  # stable segment-sort permutation
    oseg_s: np.ndarray  # (N,) int32 sorted segment ids
    engine: EngineChoice
    t_pad: int  # tree rows after padding to a block_trees multiple
    n_row_blocks: int  # ceil(N / block_obs) — the kernel grid's row axis

    @property
    def n_users(self) -> int:
        return len(self.users)


def choose_engine(
    store,
    seg_trees: np.ndarray,
    n_rows: int,
    engine: str | None = None,
    block_trees: int | None = None,
    block_obs: int | None = None,
    n_devices: int = 1,
) -> EngineChoice:
    """Resolve the engine for a batch.  ``engine=None`` asks the cost
    model: ``simple`` when the store schema cannot use the fused arena,
    ``sharded`` when >1 device AND the greedy bin-pack predicts at least
    ``MIN_SHARD_SPEEDUP`` over one device, else ``pipelined``.  Explicit
    names are validated but honoured (the escape hatch the legacy string
    kwargs become).  ``n_devices`` is the length of the session's device
    list (the reference counts the devices JAX sees)."""
    if engine is not None:
        if engine not in ENGINE_BLOCKS:
            raise ValueError(f"unknown serving engine {engine!r}")
        if engine != "simple" and store.arena is None:
            raise ValueError(
                f"engine={engine!r} needs the fused tile arena, which this "
                "store's schema cannot use (packed code word >= 2**24); "
                "use engine='simple'"
            )
        reason = "explicitly requested"
    elif store.arena is None:
        engine = "simple"
        reason = "store schema cannot pack the fused arena layout"
    else:
        n_dev = n_devices
        total_trees = int(np.asarray(seg_trees).sum())
        if n_dev <= 1:
            engine, reason = "pipelined", "single device"
        elif total_trees < MIN_SHARD_TREES:
            engine = "pipelined"
            reason = (
                f"{total_trees} trees below the {MIN_SHARD_TREES}-tree "
                "sharding floor"
            )
        else:
            from ..kernels.tree_predict.ops import estimate_shard_speedup

            speedup = estimate_shard_speedup(seg_trees, n_dev)
            if speedup >= MIN_SHARD_SPEEDUP:
                engine = "sharded"
                reason = (
                    f"{n_dev} devices, predicted {speedup:.2f}x from the "
                    "tree bin-pack"
                )
            else:
                engine = "pipelined"
                reason = (
                    f"shard load imbalance (predicted {speedup:.2f}x < "
                    f"{MIN_SHARD_SPEEDUP}x)"
                )
    bt_default, bo_default = ENGINE_BLOCKS[engine]
    return EngineChoice(
        engine,
        bt_default if block_trees is None else int(block_trees),
        bo_default if block_obs is None else int(block_obs),
        reason,
    )


def build_plan(
    store,
    request_users: Sequence[str],
    row_counts: Sequence[int],
    engine: str | None = None,
    block_trees: int | None = None,
    block_obs: int | None = None,
    n_devices: int = 1,
) -> ServePlan:
    """Compile a batch signature into a ``ServePlan`` (pure host work).
    ``n_devices`` is the length of the session's device list."""
    request_users = tuple(request_users)
    row_counts = tuple(int(n) for n in row_counts)
    users, _seg_of, obs_seg, row_slices, order, oseg_s = batch_layout(
        request_users, row_counts
    )
    seg_trees = np.array(
        [store.n_trees(u) for u in users], np.int64
    ) if users else np.zeros(0, np.int64)
    n_rows = int(obs_seg.shape[0])
    choice = choose_engine(
        store, seg_trees, n_rows,
        engine=engine, block_trees=block_trees, block_obs=block_obs,
        n_devices=n_devices,
    )
    t = int(seg_trees.sum())
    t_pad = max(
        -(-t // choice.block_trees) * choice.block_trees, choice.block_trees
    )
    bo = min(choice.block_obs, n_rows) if n_rows else choice.block_obs
    signature = (
        tuple(zip(request_users, row_counts)),
        choice.name, choice.block_trees, choice.block_obs,
    )
    return ServePlan(
        signature=signature,
        user_tokens=tuple(store.user_version(u) for u in users),
        request_users=request_users,
        row_counts=row_counts,
        users=tuple(users),
        seg_trees=seg_trees,
        row_slices=tuple(row_slices),
        n_rows=n_rows,
        obs_seg=obs_seg,
        order=order,
        oseg_s=oseg_s,
        engine=choice,
        t_pad=t_pad,
        n_row_blocks=max(-(-n_rows // bo), 1) if n_rows else 0,
    )
