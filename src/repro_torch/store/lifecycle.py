"""Codebook lifecycle: drift monitoring, online re-clustering, in-place
delta migration — the port of ``repro.store.lifecycle``.

``build_store`` freezes the fleet codebook at build time, so every user
onboarded afterwards pays for symbols the fleet never produced with
USER-LOCAL fallback clusters shipped inside their delta — duplicated
across every late user, eroding exactly the shared-dictionary win the
store exists for.  This module makes the codebook a LIVING artifact:

* ``drift_report`` — the monitor: fraction of users on fallback clusters
  and the delta bytes spent on fallback artifacts (local codebook tables,
  streams coded under them, extra fit values) vs. the fleet-codebook
  baseline, plus a recluster recommendation.
* ``recluster`` — builds a successor codebook generation and migrates
  every delta onto it, bit-exact per user:

  - ``mode="extend"`` (online): generation g+1 KEEPS every generation-g
    cluster verbatim and appends clusters Bregman-fit (``core.bregman``
    chunked engine) to the pooled fallback models, with the regression
    fleet value table growing append-only.  The remap is the identity, so
    users without fallbacks migrate by RELABELING — new generation stamp,
    byte-identical streams, warm caches (decoded tiles, arena runs,
    serving packs) all preserved.
  - ``mode="full"`` (rebuild): generation g+1 re-runs fleet-scale
    clustering over the union of every user's reconstructed forest.
    Unchanged clusters are matched into a remap table; users whose
    references all survive still relabel, everyone else re-encodes.

* ``migrate_user`` / ``migrate_users`` — incremental migration: old and
  new generations coexist (the store retains a superseded codebook until
  its last delta migrates), so a serving session can cross a migration
  mid-flight, mixing generations in one batch.

Every migration path verifies bit-exact reconstruction against the
pre-migration forest before registering the new delta, and picks the
SMALLER of the re-encoded and relabeled candidates, so a recluster can
only shrink a user's delta bytes.

Port note: copied from the reference with its relative imports.  The
functions that cluster (``engine`` / ``chunk_size``) also take the
``device`` that ``core.bregman``'s dense engine runs on: the store's own
device where a store is given, else ``"cuda"``.  The default engine,
``"chunked"``, is host float64 numpy and ignores it, so codebook bytes
after a recluster equal the reference's.  The RFM1 remap table and the
RFJ1 journal are the reference's frames, byte for byte.
"""
from __future__ import annotations

import dataclasses
import io
import os
import struct
import time
from dataclasses import dataclass, field
from typing import Callable, Sequence

import numpy as np
import torch

from ..core.framing import (
    IntegrityError,
    atomic_write_bytes,
    check_crc,
    expect_magic,
    read_arr,
    read_bytes,
    read_struct,
    read_u16,
    read_u32,
    with_crc,
    write_arr,
    write_bytes,
    write_u16,
    write_u32,
)
from ..core.stats import (
    alpha_fits,
    alpha_splits,
    alpha_vars,
    extract_records,
    fit_counts,
    split_counts,
    var_name_counts,
)
from .codebook import (
    SharedCodebook,
    SharedComponent,
    build_shared_codebook,
    cluster_codebooks,
    fit_value_ids,
)
from .delta import DeltaComponent, UserDelta, encode_user_delta
from .runtime import ForestStore

_REMAP_MAGIC = b"RFM1"


# ---------------------------------------------------------------------------
# drift monitor
# ---------------------------------------------------------------------------

def _delta_components(delta: UserDelta) -> list[DeltaComponent]:
    return [delta.vars_dc, *delta.splits_dc.values(), delta.fits_dc]


def _arr_bytes(a: np.ndarray) -> int:
    """Exact on-disk size of one ARR record (docs/format.md)."""
    buf = io.BytesIO()
    write_arr(buf, np.asarray(a))
    return buf.tell()


def user_fallback_report(store: ForestStore, user_id: str) -> dict:
    """Fallback accounting for one user's delta: how many user-local
    clusters it ships, and how many delta bytes those cost (local codebook
    tables + residual streams coded under them + extra fit values) — the
    spend the fleet codebook was supposed to amortize."""
    delta = store.delta(user_id)
    shared = store.codebook_for(delta.codebook_generation)
    pairs = [
        (delta.vars_dc, shared.vars_comp),
        *(
            (dc, shared.splits_comp.get(v))
            for v, dc in delta.splits_dc.items()
        ),
        (delta.fits_dc, shared.fits_comp),
    ]
    n_local = 0
    table_bytes = 0
    stream_bytes = 0
    for dc, comp in pairs:
        s = comp.n_clusters if comp is not None else 0
        n_local += dc.n_local
        tables = (
            dc.local_lengths if dc.coder == "huffman" else dc.local_freqs
        )
        table_bytes += sum(_arr_bytes(t) for t in tables)
        for ref, stream in zip(dc.refs, dc.streams):
            if int(ref) >= s:
                stream_bytes += len(stream)
    extra_bytes = 8 * int(delta.extra_fit_values.size)
    fallback_bytes = table_bytes + stream_bytes + extra_bytes
    return {
        "n_local_clusters": n_local,
        "n_extra_fit_values": int(delta.extra_fit_values.size),
        "local_table_bytes": table_bytes,
        "local_stream_bytes": stream_bytes,
        "extra_fit_value_bytes": extra_bytes,
        "fallback_bytes": fallback_bytes,
        "uses_fallback": bool(
            n_local > 0 or delta.extra_fit_values.size > 0
        ),
        "codebook_generation": delta.codebook_generation,
    }


def drift_report(
    store: ForestStore,
    recluster_threshold: float = 0.2,
    exclude: Sequence[str] = (),
) -> dict:
    """The codebook drift monitor: how far the fleet has moved from the
    codebook it was clustered for.

    Reports the fraction of users carrying user-local fallback clusters,
    the delta bytes those fallbacks cost against the fleet-codebook
    baseline (``fallback_overhead_fraction`` of all delta bytes), and
    ``recommend_recluster`` once the fallback user fraction crosses
    ``recluster_threshold``.

    ``exclude`` names users to leave out of the accounting entirely —
    the serving layer passes its quarantined users here, since a delta
    that fails integrity checks cannot be decoded for fallback
    accounting (they are counted in ``n_excluded_users``, not treated as
    fallback users).

    The whole report is memoized on ``store.version`` (plus the
    threshold/exclude arguments), and the per-user fallback accounting —
    the expensive part: a full delta decode + re-serialize per user — is
    memoized per user on ``(user_version, codebook_generation)``.  The
    per-user key matters: a relabel migration rewrites the delta WITHOUT
    bumping the user's registry version (relabeled bytes decode
    identically), but it does change ``codebook_generation``, which the
    report must see.  An unchanged fleet therefore polls for free, and a
    mid-migration fleet recomputes only the users that moved — what lets
    the scheduler's ``LifecycleDriver`` poll aggressively."""
    memo_key = (store.version, recluster_threshold, tuple(sorted(exclude)))
    memo = getattr(store, "_drift_report_cache", None)
    if memo is not None and memo[0] == memo_key:
        return memo[1]
    user_cache = getattr(store, "_fallback_report_cache", None)
    if user_cache is None:
        user_cache = store._fallback_report_cache = {}
    excluded = {u for u in exclude if u in store.user_ids}
    users = [u for u in store.user_ids if u not in excluded]
    per_user = {}
    delta_bytes = {}
    for u in users:
        key = (
            store.user_version(u), store.delta(u).codebook_generation
        )
        hit = user_cache.get(u)
        if hit is None or hit[0] != key:
            hit = (
                key,
                user_fallback_report(store, u),
                len(store.delta(u).to_bytes()),
            )
            user_cache[u] = hit
        per_user[u] = hit[1]
        delta_bytes[u] = hit[2]
    for u in list(user_cache):
        if u not in store.user_ids:
            del user_cache[u]
    n_fallback = sum(1 for r in per_user.values() if r["uses_fallback"])
    fallback_bytes = sum(r["fallback_bytes"] for r in per_user.values())
    total_delta_bytes = sum(delta_bytes.values())
    current = store.generation
    pending = sum(
        1 for r in per_user.values()
        if r["codebook_generation"] != current
    )
    frac = n_fallback / len(users) if users else 0.0
    report = {
        "n_users": len(users),
        "n_excluded_users": len(excluded),
        "codebook_generation": current,
        "generations": store.generations,
        "n_pending_migration": pending,
        "n_fallback_users": n_fallback,
        "fallback_user_fraction": frac,
        "fallback_bytes": fallback_bytes,
        "delta_bytes_total": total_delta_bytes,
        "fallback_overhead_fraction": (
            fallback_bytes / total_delta_bytes if total_delta_bytes else 0.0
        ),
        "recluster_threshold": recluster_threshold,
        "recommend_recluster": frac >= recluster_threshold and n_fallback > 0,
        "per_user": per_user,
    }
    store._drift_report_cache = (memo_key, report)
    return report


# ---------------------------------------------------------------------------
# remap table
# ---------------------------------------------------------------------------

@dataclass
class RemapTable:
    """Cluster-id remap between two codebook generations.

    ``vars_map[k]`` / ``splits_map[v][k]`` / ``fits_map[k]`` give the
    new-generation cluster id whose codebook is BYTE-IDENTICAL to old
    cluster ``k`` (so streams coded under k decode unchanged under the
    mapped id), or -1 when no identical twin exists.  ``extend``-mode
    reclustering yields the identity map by construction; ``full`` mode
    matches twins by table equality.

    ``fit_table_prefix`` records whether the new generation's regression
    fleet value table extends the old one append-only — the condition for
    relabeling a regression user's fit streams without re-encoding.

    Serializes as one RFM1 frame (normative spec: docs/format.md).
    """

    old_generation: int
    new_generation: int
    vars_map: np.ndarray  # (K_old_vars,) int32; -1 = no identical twin
    splits_map: dict[int, np.ndarray] = field(default_factory=dict)
    fits_map: np.ndarray = field(
        default_factory=lambda: np.zeros(0, np.int32)
    )
    fit_table_prefix: bool = True

    @property
    def is_identity(self) -> bool:
        """True when every old cluster maps to itself (extend mode)."""
        maps = [self.vars_map, self.fits_map, *self.splits_map.values()]
        return all(np.array_equal(m, np.arange(len(m))) for m in maps)

    def to_bytes(self) -> bytes:
        """Serialize as one RFM1 frame (normative spec: docs/format.md)."""
        out = io.BytesIO()
        out.write(_REMAP_MAGIC)
        write_u16(out, self.old_generation)
        write_u16(out, self.new_generation)
        out.write(struct.pack("<B", 1 if self.fit_table_prefix else 0))
        write_arr(out, self.vars_map.astype(np.int32))
        write_u16(out, len(self.splits_map))
        for v, m in sorted(self.splits_map.items()):
            write_u16(out, v)
            write_arr(out, m.astype(np.int32))
        write_arr(out, self.fits_map.astype(np.int32))
        return with_crc(out.getvalue())

    @classmethod
    def from_bytes(cls, data: bytes) -> "RemapTable":
        """Parse one RFM1 frame (normative spec: docs/format.md).  The
        CRC32 trailer is verified when present; corruption raises a typed
        ``core.framing.IntegrityError`` / ``TruncatedFrameError``."""
        inp = io.BytesIO(check_crc(data, "RFM1 remap table"))
        expect_magic(inp, _REMAP_MAGIC, "RFM1 remap table")
        old_gen = read_u16(inp)
        new_gen = read_u16(inp)
        (prefix,) = read_struct(inp, "<B", "RFM1 fit-table-prefix flag")
        vars_map = read_arr(inp).astype(np.int32)
        splits_map = {}
        for _ in range(read_u16(inp)):
            v = read_u16(inp)
            splits_map[v] = read_arr(inp).astype(np.int32)
        fits_map = read_arr(inp).astype(np.int32)
        return cls(
            old_generation=old_gen,
            new_generation=new_gen,
            vars_map=vars_map,
            splits_map=splits_map,
            fits_map=fits_map,
            fit_table_prefix=bool(prefix),
        )


def _tables_equal(a: np.ndarray, b: np.ndarray) -> bool:
    """Codebook-table equality modulo trailing uncodable symbols (length 0
    / frequency 0 tails encode the same canonical code)."""
    a = np.trim_zeros(np.asarray(a), "b")
    b = np.trim_zeros(np.asarray(b), "b")
    return np.array_equal(a, b)


def _component_remap(
    old: SharedComponent | None, new: SharedComponent | None
) -> np.ndarray:
    """(K_old,) map of old cluster ids onto byte-identical new clusters
    (-1 where none exists)."""
    if old is None or old.n_clusters == 0:
        return np.zeros(0, np.int32)
    k_old = old.n_clusters
    out = np.full(k_old, -1, np.int32)
    if new is None or new.coder != old.coder:
        return out
    old_tabs = old.codebook_lengths if old.coder == "huffman" else old.freqs
    new_tabs = new.codebook_lengths if new.coder == "huffman" else new.freqs
    for i, ot in enumerate(old_tabs):
        for j, nt in enumerate(new_tabs):
            if _tables_equal(ot, nt):
                out[i] = j
                break
    return out


def build_remap(
    old: SharedCodebook, new: SharedCodebook
) -> RemapTable:
    """Match every old cluster to a byte-identical new cluster (per
    component) and record regression fit-table compatibility."""
    n_old = len(old.fleet_fit_values)
    prefix = len(new.fleet_fit_values) >= n_old and np.array_equal(
        new.fleet_fit_values[:n_old], old.fleet_fit_values
    )
    return RemapTable(
        old_generation=old.generation,
        new_generation=new.generation,
        vars_map=_component_remap(old.vars_comp, new.vars_comp),
        splits_map={
            v: _component_remap(c, new.splits_comp.get(v))
            for v, c in old.splits_comp.items()
        },
        fits_map=_component_remap(old.fits_comp, new.fits_comp),
        fit_table_prefix=prefix,
    )


# ---------------------------------------------------------------------------
# relabeling (migration without re-encoding)
# ---------------------------------------------------------------------------

def _relabel_component(
    dc: DeltaComponent, comp_map: np.ndarray, s_old: int, s_new: int
) -> DeltaComponent | None:
    """Rename one component's cluster references onto the new generation:
    shared refs go through the remap (fail on any missing twin), local
    refs re-base from ``s_old + j`` to ``s_new + j``.  Streams, local
    tables, and symbol counts are untouched."""

    def rename(arr: np.ndarray) -> np.ndarray | None:
        out = arr.astype(np.int32).copy()
        shared = (arr >= 0) & (arr < s_old)
        local = arr >= s_old
        if shared.any():
            mapped = comp_map[arr[shared]] if len(comp_map) else np.full(
                int(shared.sum()), -1, np.int32
            )
            if (mapped < 0).any():
                return None
            out[shared] = mapped
        out[local] = s_new + (arr[local] - s_old)
        return out

    kid = rename(np.asarray(dc.kid_to_ref))
    refs = rename(np.asarray(dc.refs))
    if kid is None or refs is None:
        return None
    return DeltaComponent(
        coder=dc.coder,
        kid_to_ref=kid.astype(np.int16),
        local_lengths=list(dc.local_lengths),
        local_freqs=list(dc.local_freqs),
        refs=refs.astype(np.int16),
        n_symbols=list(dc.n_symbols),
        streams=list(dc.streams),
    )


def relabel_delta(
    delta: UserDelta,
    old: SharedCodebook,
    new: SharedCodebook,
    remap: RemapTable,
) -> UserDelta | None:
    """Migrate a delta to the new generation by RENAMING cluster ids only
    — every stream byte, local table, and fit map is carried verbatim, so
    the decoded artifact is bit-identical and warm caches stay valid.

    Returns ``None`` when renaming cannot be lossless: a referenced shared
    cluster has no byte-identical twin in the new generation, or (for
    regression) the fit streams' symbol ids would shift — the new fleet
    value table must extend the old append-only, and a user carrying
    extra values needs the extra-id base ``len(fleet)`` unchanged."""
    if old.task == "regression":
        if not remap.fit_table_prefix:
            return None
        if delta.extra_fit_values.size and len(new.fleet_fit_values) != len(
            old.fleet_fit_values
        ):
            # extra symbol ids are based at len(fleet): growing the table
            # would re-point them at other users' onboarded values
            return None
    vars_dc = _relabel_component(
        delta.vars_dc, remap.vars_map,
        old.vars_comp.n_clusters, new.vars_comp.n_clusters,
    )
    if vars_dc is None:
        return None
    splits_dc: dict[int, DeltaComponent] = {}
    for v, dc in delta.splits_dc.items():
        s_old = (
            old.splits_comp[v].n_clusters if v in old.splits_comp else 0
        )
        s_new = (
            new.splits_comp[v].n_clusters if v in new.splits_comp else 0
        )
        comp_map = remap.splits_map.get(v, np.zeros(0, np.int32))
        rdc = _relabel_component(dc, comp_map, s_old, s_new)
        if rdc is None:
            return None
        splits_dc[v] = rdc
    fits_dc = _relabel_component(
        delta.fits_dc, remap.fits_map,
        old.fits_comp.n_clusters, new.fits_comp.n_clusters,
    )
    if fits_dc is None:
        return None
    return dataclasses.replace(
        delta,
        codebook_generation=new.generation,
        vars_dc=vars_dc,
        splits_dc=splits_dc,
        fits_dc=fits_dc,
    )


# ---------------------------------------------------------------------------
# successor codebook construction
# ---------------------------------------------------------------------------

def _uncodable_rows(counts: np.ndarray, comp: SharedComponent) -> np.ndarray:
    """Mask of count rows NO cluster of ``comp`` can code (a row is
    codable by a cluster iff every symbol it emits has a codeword) — the
    exact condition that forces a user-local fallback at encode time."""
    if comp is None or comp.n_clusters == 0:
        return np.ones(len(counts), bool)
    cost = comp.cost_table()  # (K, B_comp)
    if counts.shape[1] > cost.shape[1]:
        pad = np.full(
            (cost.shape[0], counts.shape[1] - cost.shape[1]), np.inf
        )
        cost = np.concatenate([cost, pad], axis=1)
    emits = counts > 0  # (U, B)
    uncodable_by = emits[:, None, :] & ~np.isfinite(cost)[None, :, :]
    return uncodable_by.any(-1).all(-1)


def _extend_component(
    old: SharedComponent | None,
    rows: list[np.ndarray],
    alphabet: int,
    alpha_bits: float,
    coder: str,
    k_max: int,
    seed: int,
    engine: str,
    chunk_size: int,
    device: str | torch.device = "cuda",
) -> SharedComponent:
    """Generation g+1 of one component: generation-g cluster tables kept
    VERBATIM (identity remap), plus clusters Bregman-fit to the pooled
    rows generation g cannot code."""
    new = SharedComponent(coder, alphabet)
    if old is not None:
        new.codebook_lengths = list(old.codebook_lengths)
        new.freqs = list(old.freqs)
    pool = [r for r in rows if len(r)]
    if pool:
        stacked = np.concatenate(pool).astype(np.float64)
        uncod = _uncodable_rows(stacked, old)
        if uncod.any():
            _, lengths, freqs = cluster_codebooks(
                stacked[uncod], alpha_bits, coder, k_max, seed,
                engine, chunk_size, device=device,
            )
            new.codebook_lengths.extend(lengths)
            new.freqs.extend(freqs)
    return new


def extend_codebook(
    store: ForestStore,
    k_max: int = 16,
    seed: int = 0,
    engine: str = "chunked",
    chunk_size: int = 65536,
    device: str | torch.device | None = None,
) -> tuple[SharedCodebook, RemapTable]:
    """Build the ONLINE successor codebook: keep every current cluster
    verbatim and append clusters fit to the fallback models (the models
    the frozen codebook cannot code), with the regression fleet value
    table growing append-only.  The remap is the identity, so clean users
    relabel instead of re-encoding.  ``device`` (default: the store's)
    runs the dense clustering engine."""
    fallback_users = [
        u for u in store.user_ids
        if user_fallback_report(store, u)["uses_fallback"]
    ]
    forests = [store.reconstruct(u) for u in fallback_users]
    return extend_codebook_from_forests(
        store.shared, forests, k_max=k_max, seed=seed,
        engine=engine, chunk_size=chunk_size,
        device=store.device if device is None else device,
    )


def extend_codebook_from_forests(
    old: SharedCodebook,
    forests: Sequence,
    k_max: int = 16,
    seed: int = 0,
    engine: str = "chunked",
    chunk_size: int = 65536,
    device: str | torch.device = "cuda",
) -> tuple[SharedCodebook, RemapTable]:
    """``extend_codebook`` taking the uncodable forests DIRECTLY — the
    streaming-build entry point (``store.streaming``): each wave extends
    the fleet codebook with exactly the wave's uncodable models without a
    registry holding the whole fleet in memory.  Generation-g clusters
    are kept verbatim (identity remap), appended clusters are Bregman-fit
    to the pooled uncodable rows, and the regression fleet value table
    grows append-only.  ``device`` runs the dense clustering engine."""
    d = old.n_features
    forests = list(forests)
    recs = [extract_records(f) for f in forests]
    t_max = max(
        [old.t_max]
        + [int(r.depth.max()) + 1 if len(r.depth) else 1 for r in recs]
    )
    n_train = max(
        [old.n_train_obs] + [f.meta.n_train_obs for f in forests]
    )

    # ---- regression: grow the fleet value table append-only --------------
    if old.task == "regression":
        extras: list[np.ndarray] = []
        for f in forests:
            hit, _ = fit_value_ids(old.fleet_fit_values, f.fit_values)
            extras.append(np.asarray(f.fit_values, np.float64)[~hit])
        new_vals = (
            np.unique(np.concatenate(extras)) if extras else np.zeros(0)
        )
        fleet_values = np.concatenate([old.fleet_fit_values, new_vals])
        n_fit_syms = len(fleet_values)
        fits_coder = "huffman"
    else:
        fleet_values = old.fleet_fit_values
        n_fit_syms = old.n_classes
        fits_coder = old.fits_comp.coder

    # ---- per-component uncodable-model pools -----------------------------
    vars_rows, fits_rows = [], []
    splits_rows: dict[int, list[np.ndarray]] = {}
    for f, r in zip(forests, recs):
        u_t_max = int(r.depth.max()) + 1 if len(r.depth) else 1
        vc = var_name_counts(r, d, u_t_max)
        vars_rows.append(vc[vc.sum(-1) > 0])
        for v, cnts in split_counts(
            r, d, u_t_max, old.n_bins_per_feature
        ).items():
            splits_rows.setdefault(v, []).append(cnts[cnts.sum(-1) > 0])
        if old.task == "regression":
            _, ids = fit_value_ids(fleet_values, f.fit_values)
            syms = ids[r.fit.astype(np.int64)]
        else:
            syms = r.fit.astype(np.int64)
        rf = type(r)(
            tree_id=r.tree_id, depth=r.depth, father_var=r.father_var,
            var=r.var, split=r.split, fit=syms, is_leaf=r.is_leaf,
        )
        fc = fit_counts(rf, d, u_t_max, n_fit_syms)
        fits_rows.append(fc[fc.sum(-1) > 0])

    vars_comp = _extend_component(
        old.vars_comp, vars_rows, d, alpha_vars(d), "huffman",
        k_max, seed, engine, chunk_size, device,
    )
    splits_comp = dict(old.splits_comp)
    for v, rows in splits_rows.items():
        a = alpha_splits(
            not bool(old.categorical[v]), n_train,
            int(old.n_bins_per_feature[v]),
        )
        splits_comp[v] = _extend_component(
            old.splits_comp.get(v), rows, int(old.n_bins_per_feature[v]),
            a, "huffman", k_max, seed, engine, chunk_size, device,
        )
    fits_comp = _extend_component(
        old.fits_comp, fits_rows, n_fit_syms,
        alpha_fits(old.task, n_fit_syms), fits_coder,
        k_max, seed, engine, chunk_size, device,
    )

    new = SharedCodebook(
        n_features=d,
        task=old.task,
        n_classes=old.n_classes,
        t_max=t_max,
        n_train_obs=n_train,
        n_bins_per_feature=old.n_bins_per_feature,
        categorical=old.categorical,
        vars_comp=vars_comp,
        splits_comp=splits_comp,
        fits_comp=fits_comp,
        fleet_fit_values=fleet_values,
        generation=old.generation + 1,
    )
    return new, build_remap(old, new)


def rebuild_codebook(
    store: ForestStore,
    k_max: int = 16,
    seed: int = 0,
    engine: str = "chunked",
    chunk_size: int = 65536,
    device: str | torch.device | None = None,
) -> tuple[SharedCodebook, RemapTable]:
    """Build the FULL-REBUILD successor codebook: fleet-scale Bregman
    clustering from scratch over every user's reconstructed forest.
    Clusters that happen to survive byte-identically land in the remap;
    everything else forces a re-encode at migration.  ``device``
    (default: the store's) runs the dense clustering engine."""
    old = store.shared
    forests = [store.reconstruct(u) for u in store.user_ids]
    if not forests:
        # nothing to cluster: the successor is the current codebook,
        # renamed — installing it is a no-op generation bump
        new = dataclasses.replace(old, generation=old.generation + 1)
        return new, build_remap(old, new)
    new = build_shared_codebook(
        forests, k_max=k_max, seed=seed, engine=engine,
        chunk_size=chunk_size, generation=old.generation + 1,
        device=store.device if device is None else device,
    )
    return new, build_remap(old, new)


# ---------------------------------------------------------------------------
# migration
# ---------------------------------------------------------------------------

def migrate_user(
    store: ForestStore,
    user_id: str,
    remap: RemapTable,
    seed: int = 0,
    verify: bool = True,
) -> dict:
    """Migrate one user's delta onto the current codebook generation.

    Builds up to two candidates — a RELABELED delta (cluster ids renamed,
    streams verbatim, warm caches preserved) and, when the user carries
    fallback artifacts or cannot relabel, a RE-ENCODED delta against the
    new generation — and registers the smaller one.  Reconstruction is
    verified bit-exact against the pre-migration forest before anything
    is replaced.  Returns a per-user migration record."""
    delta = store.delta(user_id)
    new = store.shared
    if delta.codebook_generation == new.generation:
        n = len(delta.to_bytes())
        return {"status": "current", "bytes_before": n, "bytes": n}
    if delta.codebook_generation != remap.old_generation:
        raise ValueError(
            f"user {user_id!r} is on generation "
            f"{delta.codebook_generation}; remap covers "
            f"{remap.old_generation} -> {remap.new_generation}"
        )
    old = store.codebook_for(delta.codebook_generation)
    bytes_before = len(delta.to_bytes())

    relabeled = relabel_delta(delta, old, new, remap)
    uses_fallback = user_fallback_report(store, user_id)["uses_fallback"]
    # the full entropy decode is only paid when actually needed: to build
    # the re-encode candidate, or to verify — a clean relabel with
    # verify=False migrates without decoding at all
    original = None
    if relabeled is None or uses_fallback or verify:
        original = store.reconstruct(user_id)
    reencoded = None
    if relabeled is None or uses_fallback:
        reencoded = encode_user_delta(original, new, seed=seed)

    candidates: list[tuple[int, str, UserDelta]] = []
    if relabeled is not None:
        candidates.append((len(relabeled.to_bytes()), "relabeled", relabeled))
    if reencoded is not None:
        candidates.append((len(reencoded.to_bytes()), "reencoded", reencoded))
    # ties favour the relabeled candidate: it keeps warm caches alive
    n_bytes, status, chosen = min(candidates, key=lambda c: (c[0], c[1] != "relabeled"))

    if verify:
        from .delta import reconstruct_user

        got = reconstruct_user(chosen, new)
        if not got.equals(original):
            raise AssertionError(
                f"migration of {user_id!r} is not bit-exact "
                f"({status} candidate)"
            )
    if status == "relabeled":
        store.replace_delta_relabeled(user_id, chosen)
    else:
        store.add_delta(user_id, chosen)
    return {
        "status": status,
        "bytes_before": bytes_before,
        "bytes": n_bytes,
    }


def migrate_users(
    store: ForestStore,
    users: Sequence[str],
    remap: RemapTable,
    seed: int = 0,
    verify: bool = True,
) -> dict[str, dict]:
    """Migrate several users (see ``migrate_user``), garbage-collecting
    codebook generations whose last delta migrated away."""
    records = {
        u: migrate_user(store, u, remap, seed=seed, verify=verify)
        for u in users
    }
    store.drop_unreferenced_codebooks()
    return records


# ---------------------------------------------------------------------------
# crash-safe migration journal
# ---------------------------------------------------------------------------

_JOURNAL_MAGIC = b"RFJ1"

#: journal state machine: ``idle`` (nothing logged) -> ``built``
#: (successor codebook + remap constructed and serialized into the
#: journal) -> ``installed`` (codebook installed in the store; per-user
#: migration in flight) -> ``committed`` (every user migrated; GC safe).
_JOURNAL_STATES = ("idle", "built", "installed", "committed")


@dataclass
class MigrationJournal:
    """Write-ahead journal making ``recluster`` crash-safe.

    Every state transition of a recluster run is logged BEFORE the store
    mutation it describes takes effect, so a crash at any point leaves
    enough information to finish (roll forward) or undo (roll back) the
    run via ``resume_recluster``:

    * ``log_built`` serializes the successor codebook and remap table
      into the journal — a crash after build never repeats the expensive
      fleet-scale clustering.
    * ``log_migrate_intent`` records a user's PRE-migration delta bytes
      before their delta is replaced — a crash mid-migration rolls the
      user back to those exact bytes, then re-migrates.
    * ``log_migrate_commit`` marks the user durably migrated.
    * ``log_committed`` marks the whole run complete; only after this may
      superseded codebook generations be garbage-collected.

    With ``path`` set, every transition atomically rewrites the journal
    file (write-to-temp + ``os.replace``), so the journal survives
    process crashes, not just injected ones.  Serializes as one RFJ1
    frame with a CRC32 trailer (docs/format.md §8).
    """

    state: str = "idle"
    mode: str = ""
    old_generation: int = 0
    new_generation: int = 0
    codebook_bytes: bytes = b""
    remap_bytes: bytes = b""
    #: user -> {"intent": pre-migration delta bytes, "committed": bool,
    #:          "status": migrate_user status once committed}
    entries: dict[str, dict] = field(default_factory=dict)
    path: str | None = None

    # -- state transitions -------------------------------------------------

    def log_built(
        self, mode: str, codebook: SharedCodebook, remap: RemapTable
    ) -> None:
        self.mode = mode
        self.old_generation = remap.old_generation
        self.new_generation = remap.new_generation
        self.codebook_bytes = codebook.to_bytes()
        self.remap_bytes = remap.to_bytes()
        self.state = "built"
        self._persist()

    def log_installed(self) -> None:
        self.state = "installed"
        self._persist()

    def log_migrate_intent(self, user_id: str, delta_bytes: bytes) -> None:
        e = self.entries.get(user_id)
        if e is not None and e["committed"]:
            return  # already durably migrated — keep the commit record
        self.entries[user_id] = {
            "intent": delta_bytes, "committed": False, "status": "",
        }
        self._persist()

    def log_migrate_commit(self, user_id: str, status: str) -> None:
        self.entries[user_id]["committed"] = True
        self.entries[user_id]["status"] = status
        self._persist()

    def log_committed(self) -> None:
        self.state = "committed"
        self._persist()

    @property
    def uncommitted_users(self) -> list[str]:
        """Users whose migration intent was logged but never committed —
        the ones ``resume_recluster`` rolls back before re-migrating."""
        return sorted(
            u for u, e in self.entries.items() if not e["committed"]
        )

    def summary(self) -> dict:
        """Compact journal status for ``ForestServer.stats()["health"]``."""
        return {
            "state": self.state,
            "mode": self.mode,
            "old_generation": self.old_generation,
            "new_generation": self.new_generation,
            "n_entries": len(self.entries),
            "n_committed": sum(
                1 for e in self.entries.values() if e["committed"]
            ),
            "uncommitted_users": self.uncommitted_users,
        }

    # -- persistence -------------------------------------------------------

    def _persist(self) -> None:
        if self.path is None:
            return
        # the shared atomic-write helper fsyncs the file AND its
        # directory, so a power loss right after the rename cannot
        # resurrect a stale journal
        atomic_write_bytes(self.path, self.to_bytes())

    @classmethod
    def load(cls, path: str) -> "MigrationJournal":
        """Load a persisted journal; the loaded journal keeps persisting
        to the same path."""
        with open(path, "rb") as f:
            j = cls.from_bytes(f.read())
        j.path = path
        return j

    def to_bytes(self) -> bytes:
        """Serialize as one RFJ1 frame (normative spec: docs/format.md)."""
        out = io.BytesIO()
        out.write(_JOURNAL_MAGIC)
        out.write(struct.pack("<B", _JOURNAL_STATES.index(self.state)))
        write_bytes(out, self.mode.encode("utf-8"))
        write_u16(out, self.old_generation)
        write_u16(out, self.new_generation)
        write_bytes(out, self.codebook_bytes)
        write_bytes(out, self.remap_bytes)
        write_u32(out, len(self.entries))
        for u, e in sorted(self.entries.items()):
            write_bytes(out, u.encode("utf-8"))
            out.write(struct.pack("<B", 1 if e["committed"] else 0))
            write_bytes(out, e["status"].encode("utf-8"))
            write_bytes(out, e["intent"])
        return with_crc(out.getvalue())

    @classmethod
    def from_bytes(cls, data: bytes) -> "MigrationJournal":
        """Parse one RFJ1 frame (normative spec: docs/format.md)."""
        inp = io.BytesIO(check_crc(data, "RFJ1 migration journal"))
        expect_magic(inp, _JOURNAL_MAGIC, "RFJ1 migration journal")
        (state_i,) = read_struct(inp, "<B", "RFJ1 state")
        if state_i >= len(_JOURNAL_STATES):
            raise IntegrityError(
                f"RFJ1 journal has unknown state code {state_i}"
            )
        mode = read_bytes(inp).decode("utf-8")
        old_gen = read_u16(inp)
        new_gen = read_u16(inp)
        codebook_bytes = read_bytes(inp)
        remap_bytes = read_bytes(inp)
        entries: dict[str, dict] = {}
        for _ in range(read_u32(inp)):
            u = read_bytes(inp).decode("utf-8")
            (committed,) = read_struct(inp, "<B", "RFJ1 entry flag")
            status = read_bytes(inp).decode("utf-8")
            intent = read_bytes(inp)
            entries[u] = {
                "intent": intent,
                "committed": bool(committed),
                "status": status,
            }
        return cls(
            state=_JOURNAL_STATES[state_i],
            mode=mode,
            old_generation=old_gen,
            new_generation=new_gen,
            codebook_bytes=codebook_bytes,
            remap_bytes=remap_bytes,
            entries=entries,
        )


# ---------------------------------------------------------------------------
# the lifecycle operation
# ---------------------------------------------------------------------------

@dataclass
class ReclusterResult:
    """What one ``recluster`` run did, for dashboards and benchmarks."""

    mode: str
    old_generation: int
    new_generation: int
    n_users: int
    n_relabeled: int
    n_reencoded: int
    n_pending: int  # users left on the old generation (migrate=False)
    bytes_before: int
    bytes_after: int
    verified_bit_exact: bool
    wall_time_s: float
    remap: RemapTable
    per_user: dict[str, dict]


def _migrate_journaled(
    store: ForestStore,
    remap: RemapTable,
    journal: MigrationJournal,
    step,
    seed: int,
    verify: bool,
) -> dict[str, dict]:
    """The journaled per-user migration loop shared by ``recluster`` and
    ``resume_recluster``: intent is logged BEFORE each user's delta is
    replaced, commit AFTER — and superseded-generation GC happens only
    once the whole run is journal-committed (never mid-flight, unlike
    ``migrate_users``)."""
    per_user: dict[str, dict] = {}
    for u in store.user_ids:
        already = journal.entries.get(u)
        if already is not None and already["committed"]:
            # durably migrated by a previous (crashed) attempt
            n = len(store.delta(u).to_bytes())
            per_user[u] = {
                "status": already["status"] or "current",
                "bytes_before": n,
                "bytes": n,
            }
            continue
        journal.log_migrate_intent(u, store.delta(u).to_bytes())
        step(f"migrate:{u}")
        per_user[u] = migrate_user(store, u, remap, seed=seed, verify=verify)
        step(f"migrated:{u}")
        journal.log_migrate_commit(u, per_user[u]["status"])
    step("commit")
    journal.log_committed()
    step("gc")
    store.drop_unreferenced_codebooks()
    return per_user


def _recluster_result(
    store: ForestStore,
    mode: str,
    remap: RemapTable,
    per_user: dict[str, dict],
    bytes_before: int,
    verified: bool,
    elapsed_s: float,
) -> ReclusterResult:
    statuses = [r["status"] for r in per_user.values()]
    n_pending = sum(
        1 for u in store.user_ids
        if store.delta(u).codebook_generation != remap.new_generation
    )
    return ReclusterResult(
        mode=mode,
        old_generation=remap.old_generation,
        new_generation=remap.new_generation,
        n_users=len(store.user_ids),
        n_relabeled=statuses.count("relabeled"),
        n_reencoded=statuses.count("reencoded"),
        n_pending=n_pending,
        bytes_before=bytes_before,
        bytes_after=store.size_report()["total_bytes"],
        verified_bit_exact=verified,
        wall_time_s=elapsed_s,
        remap=remap,
        per_user=per_user,
    )


def recluster(
    store: ForestStore,
    mode: str = "extend",
    k_max: int = 16,
    seed: int = 0,
    engine: str = "chunked",
    chunk_size: int = 65536,
    migrate: bool = True,
    verify: bool = True,
    journal: MigrationJournal | None = None,
    on_step=None,
    timer: Callable[[], float] = time.perf_counter,
    device: str | torch.device | None = None,
) -> ReclusterResult:
    """Re-run fleet-scale clustering and migrate the store onto the
    successor codebook generation, bit-exactly.

    ``mode="extend"`` keeps every current cluster and appends clusters fit
    to the fallback models (identity remap: clean users relabel, warm
    caches survive); ``mode="full"`` rebuilds the codebook from the whole
    user union (maximal compression, most re-encoding).  With
    ``migrate=False`` only the successor codebook is installed — call
    ``migrate_users`` to move deltas over incrementally; the old
    generation stays resident (and serialized) until its last delta
    migrates.

    Crash safety: every phase is logged to ``journal`` (a fresh
    in-memory ``MigrationJournal`` when not given) before the store
    mutation it describes, and superseded codebook generations are
    garbage-collected strictly AFTER the journal commits — a crash at any
    point leaves the old generation resident and ``resume_recluster``
    able to roll the run forward (or roll uncommitted per-user
    migrations back) to a bit-exact store.  ``on_step(name)`` is called
    at each phase boundary (``build``, ``install``, ``migrate:<user>``,
    ``migrated:<user>``, ``commit``, ``gc``) — the fault-injection
    harness (``runtime.chaos.CrashSchedule``) hooks in here.  ``device``
    (default: the store's) runs the dense clustering engine."""
    if mode not in ("extend", "full"):
        raise ValueError(f"unknown recluster mode {mode!r}")
    pending = {
        u for u in store.user_ids
        if store.delta(u).codebook_generation != store.generation
    }
    if pending:
        # the remap this run produces covers current -> current+1 only;
        # users still on an older generation would be stranded behind it
        raise ValueError(
            f"{len(pending)} user(s) still reference generation(s) "
            f"{sorted(store.generations)[:-1]}; finish the pending "
            "migration (lifecycle.migrate_users) before re-clustering "
            "again"
        )
    step = on_step if on_step is not None else (lambda name: None)
    if journal is None:
        journal = MigrationJournal()
    store.journal = journal
    t0 = timer()
    bytes_before = store.size_report()["total_bytes"]
    build = extend_codebook if mode == "extend" else rebuild_codebook
    step("build")
    new, remap = build(
        store, k_max=k_max, seed=seed, engine=engine, chunk_size=chunk_size,
        device=device,
    )
    journal.log_built(mode, new, remap)
    step("install")
    store.install_codebook(new)
    journal.log_installed()
    per_user: dict[str, dict] = {}
    if migrate:
        per_user = _migrate_journaled(
            store, remap, journal, step, seed, verify
        )
    return _recluster_result(
        store, mode, remap, per_user, bytes_before,
        bool(verify and migrate), timer() - t0,
    )


def resume_recluster(
    store: ForestStore,
    journal: MigrationJournal,
    seed: int = 0,
    verify: bool = True,
    on_step=None,
    timer: Callable[[], float] = time.perf_counter,
) -> ReclusterResult:
    """Finish (or undo) a recluster run that crashed mid-flight, from its
    journal.  Idempotent: safe to call again after a crash DURING
    resumption, and a no-op on an already-committed journal.

    * state ``committed`` — the run finished; re-run the (idempotent)
      superseded-generation GC and return.
    * state ``built`` — the successor codebook and remap were journaled
      but never installed: deserialize them from the journal (the
      expensive clustering is NOT repeated), install, and migrate.
    * state ``installed`` — migration was in flight: every user whose
      intent was logged but never committed is ROLLED BACK to the exact
      pre-migration delta bytes recorded in the journal (the old
      codebook generation is guaranteed resident, because GC is deferred
      until commit), then migration re-runs; already-committed users are
      skipped via their journal record.
    * state ``idle`` — nothing was logged before the crash; the run never
      mutated the store, so there is nothing to resume (re-run
      ``recluster``, passing the same journal).
    """
    step = on_step if on_step is not None else (lambda name: None)
    store.journal = journal
    t0 = timer()
    bytes_before = store.size_report()["total_bytes"]
    if journal.state == "idle":
        raise ValueError(
            "journal is empty — the crashed run never mutated the store; "
            "re-run recluster() instead of resuming"
        )
    remap = RemapTable.from_bytes(journal.remap_bytes)
    if journal.state == "committed":
        step("gc")
        store.drop_unreferenced_codebooks()
        per_user = {
            u: {"status": e["status"] or "current"}
            for u, e in journal.entries.items()
        }
        for u, r in per_user.items():
            if u in store.user_ids:
                n = len(store.delta(u).to_bytes())
                r["bytes_before"] = n
                r["bytes"] = n
        return _recluster_result(
            store, journal.mode, remap, per_user, bytes_before, False,
            timer() - t0,
        )
    if journal.state == "built":
        # crashed between build and install — roll the install forward
        # from the journaled codebook bytes
        if store.generation < journal.new_generation:
            step("install")
            store.install_codebook(
                SharedCodebook.from_bytes(journal.codebook_bytes)
            )
        journal.log_installed()
    # state == "installed": roll back every uncommitted migration to the
    # exact pre-migration bytes, then re-migrate
    for u in journal.uncommitted_users:
        if u not in store.user_ids:
            continue
        intent = journal.entries[u]["intent"]
        if store.delta(u).to_bytes() != intent:
            step(f"rollback:{u}")
            store.add_delta(u, UserDelta.from_bytes(intent))
    per_user = _migrate_journaled(store, remap, journal, step, seed, verify)
    return _recluster_result(
        store, journal.mode, remap, per_user, bytes_before, verify,
        timer() - t0,
    )
