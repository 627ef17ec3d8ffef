"""Codebook lifecycle, the part the serving session needs — the port of
``repro.store.lifecycle``'s drift monitor.

``drift_report`` measures how far the fleet has moved from the codebook
it was clustered for: the fraction of users on user-local fallback
clusters and the delta bytes those fallbacks cost against the
fleet-codebook baseline, plus a recluster recommendation.
``ForestStore.drift_stats`` (and so ``ForestServer.stats()``) reads it.

The rest of the reference module — ``recluster`` in its extend and full
modes, incremental migration, the RFM1 remap table and the RFJ1 journal
— is ROADMAP Queue 1 item 7; ``repro_torch.store`` raises
``NotImplementedError`` where they are named.
"""
from __future__ import annotations

import io
from typing import Sequence

import numpy as np

from ..core.framing import write_arr
from .delta import DeltaComponent, UserDelta
from .runtime import ForestStore

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
