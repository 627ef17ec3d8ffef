"""Streaming (wave-bounded) store construction — the port of
``repro.store.streaming``.

``build_store`` holds the whole fleet in memory: every forest, every
delta, plus the clustering working set.  At 10^5 users that is exactly
the high-water mark the residency budget exists to avoid — so
construction must be bounded too.  ``build_store_streaming`` folds users
into the fleet codebook in WAVES:

* wave 0 builds the initial shared codebook from its own forests
  (fleet-scale Bregman clustering, the same chunked assignment engine
  ``core.bregman`` uses for minibatch construction) and commits the
  codebook + the wave's RFD1 delta shards to a ``DurableStore``;
* every later wave encodes against the CURRENT codebook; if any of its
  models are uncodable (fallback), the codebook is EXTENDED for exactly
  those models — generation-g clusters verbatim, appended clusters
  Bregman-fit to the wave's uncodable rows, regression value table
  growing append-only (``lifecycle.extend_codebook_from_forests``, the
  same append-only contract as ``recluster(mode="extend")``) — and the
  fallback users re-encode clean against the new generation;
* each wave lands as ONE durable commit (an atomic epoch bump): a crash
  mid-wave recovers to the previous wave's epoch, never a torn fleet.

Memory never holds more than one wave of forests + deltas + the current
codebook.  Users committed in earlier waves stay on the generation they
were encoded for — mixed-generation serving handles that natively, and
``lifecycle.migrate_users`` consolidates lazily once the fleet is live.

Port note: copied from the reference with its relative imports; the
``device`` runs the codebook builds' dense clustering engine and nothing
else (the default chunked engine is host numpy, and what the build
writes is host bytes on disk).
"""
from __future__ import annotations

import itertools
from typing import Callable, Iterable

import torch

from .codebook import build_shared_codebook
from .delta import UserDelta, encode_user_delta
from .durable import DurableStore
from .lifecycle import extend_codebook_from_forests


def _uses_fallback(delta: UserDelta) -> bool:
    """True when a delta ships user-local clusters or extra fit values —
    the models the current codebook cannot code cleanly."""
    comps = [delta.vars_dc, *delta.splits_dc.values(), delta.fits_dc]
    return (
        any(dc.n_local for dc in comps)
        or delta.extra_fit_values.size > 0
    )


def build_store_streaming(
    forests: "Iterable[tuple[str, object]] | dict",
    path: str,
    wave_users: int = 256,
    k_max: int = 16,
    seed: int = 0,
    engine: str = "chunked",
    chunk_size: int = 65536,
    slab_shards: int = 8,
    extend: bool = True,
    on_wave: Callable[[dict], None] | None = None,
    on_step: Callable[[str], None] | None = None,
    device: str | torch.device = "cuda",
) -> DurableStore:
    """Build a durable fleet from an ITERABLE of ``(user_id, forest)``
    pairs in waves of ``wave_users``, never holding more than one wave
    in memory (see module docstring).  ``extend=False`` pins the wave-0
    codebook (fallback users then keep their user-local clusters, as a
    frozen codebook would force).  ``on_wave`` receives one summary dict
    per committed wave.  Returns the ``DurableStore``; serve it with
    ``load_store()`` (+ ``residency.attach_residency`` for a bounded
    host tier).  ``device`` runs the dense clustering engine of the
    codebook builds."""
    if wave_users < 1:
        raise ValueError(f"wave_users must be positive, got {wave_users}")
    items = forests.items() if isinstance(forests, dict) else forests
    it = iter(items)
    durable: DurableStore | None = None
    codebook = None
    wave_idx = 0
    while True:
        wave = list(itertools.islice(it, wave_users))
        if not wave:
            break
        if codebook is None:
            codebook = build_shared_codebook(
                [f for _, f in wave], k_max=k_max, seed=seed,
                engine=engine, chunk_size=chunk_size, device=device,
            )
            durable = DurableStore.create(path, slab_shards=slab_shards)
            durable.put_codebook(codebook)
        deltas = [
            (u, encode_user_delta(f, codebook, seed=seed)) for u, f in wave
        ]
        extended = False
        if extend:
            fb = [i for i, (_, d) in enumerate(deltas)
                  if _uses_fallback(d)]
            if fb:
                codebook, _ = extend_codebook_from_forests(
                    codebook, [wave[i][1] for i in fb],
                    k_max=k_max, seed=seed,
                    engine=engine, chunk_size=chunk_size, device=device,
                )
                durable.put_codebook(codebook)
                extended = True
                for i in fb:
                    u, f = wave[i]
                    deltas[i] = (
                        u, encode_user_delta(f, codebook, seed=seed)
                    )
        for u, d in deltas:
            durable.put_delta(u, d)
        # one atomic epoch per wave; on_step feeds the chaos harness
        epoch = durable.commit(on_step=on_step)
        if on_wave is not None:
            on_wave({
                "wave": wave_idx,
                "users": len(wave),
                "generation": codebook.generation,
                "extended": extended,
                "epoch": epoch,
            })
        wave_idx += 1
    if durable is None:
        raise ValueError(
            "streaming build needs at least one (user_id, forest) pair"
        )
    return durable
