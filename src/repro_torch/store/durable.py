"""Durable self-healing shard store — the port of ``repro.store.durable``.

The on-disk tier of the fleet: per-user RFD1 delta shards and per-
generation codebook shards packed into immutable **slab files**, indexed
by a versioned **RFN1 manifest** (per-shard offset, length, CRC32,
codebook generation, user id), with one **XOR parity shard** per slab so
any single corrupt-or-missing shard reconstructs bit-exact.  Normative
byte spec: ``docs/format.md`` §10; design: ``docs/architecture.md``.

Durability model
----------------
* **Every file write is atomic + durable** (``core.framing.
  atomic_write_bytes``: temp file + fsync + rename + directory fsync).
  Slab, parity, and manifest files are written WHOLE and never appended
  or patched in place — the only mutation the format knows is "replace a
  complete file".
* **Commits are manifest swaps.** A commit writes the new slabs and
  their parity files first, then a successor manifest with a strictly
  larger epoch, then garbage-collects.  A crash at ANY step leaves
  either the old manifest (pre-state) or the new one (post-state) as the
  highest readable epoch; ``DurableStore.open`` picks the highest
  manifest that passes its CRC trailer and deletes newer torn ones plus
  any orphaned slab files — rollback is deletion, never parsing of
  partial state.
* **Single faults repair, double faults raise.**  Parity is the XOR of a
  slab's shard payloads zero-padded to the longest.  One bad shard in a
  group reconstructs bit-exact (verified against the manifest CRC32 and
  healed on disk); a second fault in the same group — including a lost
  parity file when a data shard is also bad — raises a typed
  ``UnrepairableError``.  Detected-but-unrepairable NEVER degrades into
  a silent wrong forest.

Residency (first rung of the disk -> host RAM -> HBM ladder):
``load_store`` materializes a ``ForestStore`` whose per-user deltas stay
ON DISK until first touched — a ``_LazyShard`` placeholder carries the
manifest's generation stamp (so ``referenced_generations`` stays cheap)
and loads + self-replaces on first real access.

Background repair: ``Scrubber`` walks shard and parity CRCs with a
bounded per-tick budget and repairs what it finds;
``repro_torch.sched.LifecycleDriver`` schedules ticks in low-load gaps.
Serving repair:
``attach_auto_repair`` gives ``ForestServer.serve_safe`` a quarantine ->
parity-repair -> verify -> release path.

Single-writer: one process owns a store directory at a time (matching
the journal's model); readers of a crashed writer recover via ``open``.

Port note: copied from the reference with its relative imports.  Every
byte on disk is host bytes and files, written and read exactly as the
reference does; the one device is the ``ForestStore`` that
``load_store(device=...)`` builds (its tile arena lives there, default
``"cuda"``).
"""
from __future__ import annotations

import dataclasses
import io
import os
import re
import struct
import threading
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import numpy as np
import torch

from ..core.framing import (
    FramingError,
    IntegrityError,
    UnrepairableError,
    atomic_write_bytes,
    check_crc,
    expect_magic,
    fsync_dir,
    read_bytes,
    read_struct,
    read_u16,
    read_u32,
    with_crc,
    write_bytes,
    write_u16,
    write_u32,
)
from ..runtime.guards import guarded_by
from .codebook import SharedCodebook
from .delta import UserDelta
from .runtime import ForestStore

MANIFEST_MAGIC = b"RFN1"

#: shard kinds (u8 on the wire)
KIND_CODEBOOK = 0
KIND_DELTA = 1

_KIND_NAMES = {KIND_CODEBOOK: "codebook", KIND_DELTA: "delta"}

#: every file name this module may create or delete — GC touches nothing
#: else in the directory (a recluster journal can share it safely)
_OWNED_RE = re.compile(
    r"^(manifest-\d{8}\.rfn|slab-\d{8}\.rfb|parity-\d{8}\.rfb)(\.tmp)?$"
)
_MANIFEST_RE = re.compile(r"^manifest-(\d{8})\.rfn$")


def _crc(data: bytes) -> int:
    return zlib.crc32(data) & 0xFFFFFFFF


def _manifest_name(epoch: int) -> str:
    return f"manifest-{epoch:08d}.rfn"


def _slab_name(slab_id: int) -> str:
    return f"slab-{slab_id:08d}.rfb"


def _parity_name(slab_id: int) -> str:
    return f"parity-{slab_id:08d}.rfb"


def xor_parity(payloads: list[bytes]) -> bytes:
    """XOR of ``payloads`` zero-padded to the longest — the parity shard
    of one slab group.  With every sibling and the parity intact, any
    single payload is recoverable as ``parity XOR (all siblings)``."""
    if not payloads:
        return b""
    length = max(len(p) for p in payloads)
    acc = np.zeros(length, dtype=np.uint8)
    for p in payloads:
        a = np.frombuffer(p, dtype=np.uint8)
        acc[: len(a)] ^= a
    return acc.tobytes()


# ---------------------------------------------------------------------------
# RFN1 manifest
# ---------------------------------------------------------------------------

@dataclass
class ShardEntry:
    """One shard's index record: where its bytes live inside its slab and
    what they must hash to.  ``name`` is the user id for delta shards and
    ``""`` for codebook shards (identified by ``generation``).  Dead
    entries (``live=False``, superseded or tombstoned) keep their bytes
    in the slab until compaction — parity covers dead shards too, so a
    live sibling stays repairable."""

    shard_id: int
    kind: int
    name: str
    generation: int
    offset: int
    length: int
    crc: int
    live: bool = True

    @property
    def key(self) -> tuple:
        """Logical identity: one live shard per key per manifest."""
        if self.kind == KIND_DELTA:
            return (KIND_DELTA, self.name)
        return (KIND_CODEBOOK, self.generation)

    def describe(self) -> str:
        what = _KIND_NAMES.get(self.kind, f"kind{self.kind}")
        who = self.name if self.kind == KIND_DELTA else f"gen{self.generation}"
        return f"shard {self.shard_id} ({what} {who})"


@dataclass
class SlabEntry:
    """One slab file = the concatenation of its shards' payloads in
    offset order, plus a sibling parity file of ``parity_len`` bytes
    (the longest shard's length) whose CRC32 is pinned here."""

    slab_id: int
    parity_len: int
    parity_crc: int
    shards: list = field(default_factory=list)


@dataclass
class Manifest:
    """The RFN1 frame: the complete, CRC-sealed index of one fleet state.

    ``epoch`` is strictly monotonic across commits; recovery picks the
    highest epoch whose frame passes its CRC trailer.  ``slab_shards`` is
    the parity-group width k (shards per slab at write time);
    ``next_shard_id`` / ``next_slab_id`` are the allocators, persisted so
    ids never recycle within a manifest lineage."""

    epoch: int
    slab_shards: int
    next_shard_id: int
    next_slab_id: int
    slabs: list = field(default_factory=list)

    def entries(self) -> Iterator[tuple["SlabEntry", "ShardEntry"]]:
        """Yield ``(slab, shard_entry)`` over every shard, dead or live."""
        for slab in self.slabs:
            for e in slab.shards:
                yield slab, e

    def live_entries(self) -> Iterator[tuple["SlabEntry", "ShardEntry"]]:
        for slab, e in self.entries():
            if e.live:
                yield slab, e

    def live_bytes(self) -> int:
        return sum(e.length for _, e in self.live_entries())

    def dead_bytes(self) -> int:
        return sum(e.length for _, e in self.entries() if not e.live)

    def to_bytes(self) -> bytes:
        out = io.BytesIO()
        out.write(MANIFEST_MAGIC)
        write_u32(out, self.epoch)
        write_u16(out, self.slab_shards)
        write_u32(out, self.next_shard_id)
        write_u32(out, self.next_slab_id)
        write_u32(out, len(self.slabs))
        for slab in self.slabs:
            write_u32(out, slab.slab_id)
            write_u32(out, slab.parity_len)
            write_u32(out, slab.parity_crc)
            write_u16(out, len(slab.shards))
            for e in slab.shards:
                write_u32(out, e.shard_id)
                # packed "<BB" to mirror the reader's read_struct exactly
                # (byte-identical to the old bytes([...]) idiom)
                out.write(struct.pack("<BB", e.kind, 1 if e.live else 0))
                write_u16(out, e.generation)
                write_bytes(out, e.name.encode("utf-8"))
                write_u32(out, e.offset)
                write_u32(out, e.length)
                write_u32(out, e.crc)
        return with_crc(out.getvalue())

    @classmethod
    def from_bytes(cls, data: bytes) -> "Manifest":
        payload = check_crc(data, "RFN1 manifest")
        if payload == data:
            # manifests are born with trailers — a missing one means the
            # file lost its tail, not a legacy frame
            raise IntegrityError("RFN1 manifest: missing CRC trailer")
        inp = io.BytesIO(payload)
        expect_magic(inp, MANIFEST_MAGIC, "RFN1 manifest")
        epoch = read_u32(inp)
        slab_shards = read_u16(inp)
        next_shard_id = read_u32(inp)
        next_slab_id = read_u32(inp)
        n_slabs = read_u32(inp)
        slabs = []
        for _ in range(n_slabs):
            slab_id = read_u32(inp)
            parity_len = read_u32(inp)
            parity_crc = read_u32(inp)
            n_shards = read_u16(inp)
            shards = []
            for _ in range(n_shards):
                shard_id = read_u32(inp)
                kind, live = read_struct(inp, "<BB", "RFN1 shard flags")
                if kind not in _KIND_NAMES:
                    raise IntegrityError(f"RFN1 manifest: bad shard kind {kind}")
                generation = read_u16(inp)
                name = read_bytes(inp).decode("utf-8")
                offset = read_u32(inp)
                length = read_u32(inp)
                crc = read_u32(inp)
                shards.append(ShardEntry(
                    shard_id, kind, name, generation,
                    offset, length, crc, bool(live),
                ))
            slabs.append(SlabEntry(slab_id, parity_len, parity_crc, shards))
        return cls(epoch, slab_shards, next_shard_id, next_slab_id, slabs)


# ---------------------------------------------------------------------------
# lazy residency
# ---------------------------------------------------------------------------

class _LazyShard:
    """Disk-resident stand-in for a ``UserDelta``: carries the manifest's
    generation stamp (so ``ForestStore.referenced_generations`` — which
    scans raw dict values — never touches disk) and loads + self-replaces
    in the owning map on first real attribute access.  ``to_bytes`` short-
    circuits to the raw shard bytes, so ``size_report`` / ``sync`` on a
    cold store stream bytes without decoding anything."""

    __slots__ = ("_durable", "_map", "_user", "_shard_id",
                 "codebook_generation", "_real")

    def __init__(self, durable: "DurableStore", owner_map: dict,
                 user_id: str, shard_id: int, generation: int) -> None:
        self._durable = durable
        self._map = owner_map
        self._user = user_id
        self._shard_id = shard_id
        self.codebook_generation = generation
        self._real = None

    def _load(self) -> UserDelta:
        if self._real is None:
            res = self._durable.residency
            t0 = res.clock_now() if res is not None else 0.0
            data = self._durable.read_shard(self._shard_id)
            real = UserDelta.from_bytes(data)
            self._real = real
            dict.__setitem__(self._map, self._user, real)
            if res is not None:
                # serve-path cold load: account the resident bytes and
                # let the budget react (residency.ResidencyManager)
                res.notify_loaded(self._user, len(data),
                                  res.clock_now() - t0)
        return self._real

    def to_bytes(self) -> bytes:
        if self._real is not None:
            return self._real.to_bytes()
        return self._durable.read_shard(self._shard_id)

    def __getattr__(self, name: str) -> Any:
        # only fires for names not in __slots__: proxy through the loaded
        # delta (corrupt shards raise typed IntegrityError right here —
        # exactly where serve_safe's probe expects decode faults)
        return getattr(self._load(), name)


class _LazyDeltaMap(dict):
    """The ``ForestStore._deltas`` dict of a lazily-loaded store.

    ``__getitem__`` MATERIALIZES: every path that takes a delta out of
    the registry (``store.delta``, migration's ``dataclasses.replace``,
    decode paths) gets a real ``UserDelta``.  Raw-value scans
    (``values()`` / ``items()``) still see placeholders — by design, so
    generation scans and byte-level sync stay out-of-core."""

    def __init__(self, durable: "DurableStore") -> None:
        super().__init__()
        self._durable = durable

    def __getitem__(self, key: str) -> UserDelta:
        v = super().__getitem__(key)
        if isinstance(v, _LazyShard):
            v = v._load()
        return v

    def n_loaded(self) -> int:
        return sum(1 for v in super().values()
                   if not isinstance(v, _LazyShard))


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

class DurableStore:
    """Atomic, parity-protected on-disk fleet (see module docstring).

    Mutation protocol: stage (``put_codebook`` / ``put_delta`` /
    ``remove_user`` / ``sync``) then ``commit`` — staged state lives in
    memory only until the commit's manifest swap lands, so a crash
    mid-commit loses nothing but the staging (retryable) and can never
    tear the on-disk fleet.  ``read_shard(repair=False)`` raises a typed
    ``IntegrityError`` on any mismatch (feeding quarantine);
    ``repair=True`` additionally attempts parity reconstruction.

    ``read_fault`` / ``write_fault`` are chaos hooks
    (``runtime.chaos.DiskFaults``): the first maps ``(shard_id, bytes) ->
    bytes`` on every shard read, the second sees ``(path, nbytes)``
    before every file write and may raise ``OSError`` (ENOSPC).
    """

    def __init__(self, path: str, manifest: Manifest,
                 recovery: Manifest | None = None,
                 read_fault: Callable | None = None,
                 write_fault: Callable | None = None) -> None:
        self.path = str(path)
        self.manifest = manifest
        # previous manifest: its files survive GC until the NEXT commit,
        # so recovery always has a complete fallback epoch on disk
        self._recovery = recovery
        self.read_fault = read_fault
        self.write_fault = write_fault
        self._pending: dict[tuple, tuple] = {}   # key -> (kind, name, gen, bytes)
        self._tombstones: set[tuple] = set()
        self._index = None                        # shard_id -> (slab, entry)
        self.n_commits = 0
        self.n_repairs = 0
        self.n_parity_rebuilds = 0
        # residency budget manager (store.residency.attach_residency):
        # the _LazyShard load path reports cold loads through it
        self.residency = None

    # ---------------- lifecycle -------------------------------------------

    @classmethod
    def create(cls, path: str, store: ForestStore | None = None,
               slab_shards: int = 8,
               read_fault: Callable | None = None,
               write_fault: Callable | None = None) -> "DurableStore":
        """Initialize a fresh store directory (epoch 0 = empty manifest,
        written first so a kill at any later create step recovers to a
        valid empty store), optionally seeding it from an in-memory
        ``ForestStore`` (one commit -> epoch 1)."""
        if slab_shards < 1:
            raise ValueError("slab_shards must be >= 1")
        os.makedirs(path, exist_ok=True)
        if any(_MANIFEST_RE.match(f) for f in os.listdir(path)):
            raise ValueError(
                f"{path!r} already holds a durable store — use open()"
            )
        manifest = Manifest(epoch=0, slab_shards=slab_shards,
                            next_shard_id=1, next_slab_id=1, slabs=[])
        d = cls(path, manifest, None, read_fault, write_fault)
        d._write_file(_manifest_name(0), manifest.to_bytes())
        if store is not None:
            d.sync(store)
        return d

    @classmethod
    def open(cls, path: str,
             read_fault: Callable | None = None,
             write_fault: Callable | None = None) -> "DurableStore":
        """Recover the store: highest-epoch manifest passing its CRC wins;
        torn or corrupt newer manifests and orphaned slab files from an
        interrupted commit are rolled back (deleted).  Raises a typed
        ``IntegrityError`` when no manifest is readable."""
        try:
            names = os.listdir(path)
        except OSError as exc:
            raise IntegrityError(f"cannot open durable store: {exc}") from exc
        candidates = sorted(
            (int(m.group(1)), f)
            for f in names if (m := _MANIFEST_RE.match(f))
        )
        chosen = None
        older: list[tuple[int, str]] = []
        errors: list[str] = []
        for epoch, fname in reversed(candidates):
            if chosen is not None:
                older.append((epoch, fname))
                continue
            try:
                with open(os.path.join(path, fname), "rb") as f:
                    chosen = Manifest.from_bytes(f.read())
            except (OSError, FramingError) as exc:
                errors.append(f"{fname}: {type(exc).__name__}: {exc}")
        if chosen is None:
            detail = f" ({'; '.join(errors)})" if errors else ""
            raise IntegrityError(
                f"no readable RFN1 manifest in {path!r}{detail}"
            )
        recovery = None
        for _, fname in older:          # newest readable older epoch
            try:
                with open(os.path.join(path, fname), "rb") as f:
                    recovery = Manifest.from_bytes(f.read())
                break
            except (OSError, FramingError):
                continue
        d = cls(path, chosen, recovery, read_fault, write_fault)
        d._gc()
        return d

    # ---------------- staging ---------------------------------------------

    def put_codebook(self, codebook: SharedCodebook) -> None:
        """Stage one codebook generation for the next commit."""
        self._stage(KIND_CODEBOOK, "", codebook.generation,
                    codebook.to_bytes())

    def put_delta(self, user_id: str, delta: Any) -> None:
        """Stage one user's delta (accepts a ``UserDelta`` or a lazy
        placeholder — anything with ``to_bytes`` + ``codebook_generation``)."""
        self._stage(KIND_DELTA, user_id, delta.codebook_generation,
                    delta.to_bytes())

    def put_delta_bytes(self, user_id: str, data: bytes,
                        generation: int) -> None:
        """Stage pre-serialized RFD1 bytes (the out-of-core path: no
        decode needed to move a user between stores)."""
        self._stage(KIND_DELTA, user_id, generation, bytes(data))

    def remove_user(self, user_id: str) -> None:
        """Stage a tombstone: the user's shard goes dead at next commit
        (bytes reclaimed at compaction)."""
        key = (KIND_DELTA, user_id)
        self._pending.pop(key, None)
        self._tombstones.add(key)

    def remove_codebook(self, generation: int) -> None:
        """Stage a codebook tombstone (only for generations no delta
        references — mirrors ``drop_unreferenced_codebooks``)."""
        key = (KIND_CODEBOOK, generation)
        self._pending.pop(key, None)
        self._tombstones.add(key)

    def _stage(self, kind: int, name: str, generation: int,
               data: bytes) -> None:
        key = (kind, name) if kind == KIND_DELTA else (kind, generation)
        self._tombstones.discard(key)
        self._pending[key] = (kind, name, generation, data)

    def sync(self, store: ForestStore, on_step: Callable | None = None) -> dict:
        """Make the on-disk fleet mirror ``store``: stage every codebook
        and delta whose bytes differ from the live shard (byte-level
        compare via length+CRC — lazy placeholders stream without
        decoding), tombstone what the store no longer holds, and commit
        if anything changed.  Returns staging counts + the new epoch."""
        report = {"codebooks": 0, "deltas": 0, "removed": 0,
                  "unchanged": 0, "epoch": self.manifest.epoch}
        live = {e.key: e for _, e in self.manifest.live_entries()}
        want: set[tuple] = set()
        for gen in store.generations:
            data = store.codebook_for(gen).to_bytes()
            key = (KIND_CODEBOOK, gen)
            want.add(key)
            e = live.get(key)
            if e is not None and e.length == len(data) and e.crc == _crc(data):
                report["unchanged"] += 1
            else:
                self._stage(KIND_CODEBOOK, "", gen, data)
                report["codebooks"] += 1
        for user_id, d in store._deltas.items():
            data = d.to_bytes()
            gen = d.codebook_generation
            key = (KIND_DELTA, user_id)
            want.add(key)
            e = live.get(key)
            if (e is not None and e.length == len(data)
                    and e.crc == _crc(data) and e.generation == gen):
                report["unchanged"] += 1
            else:
                self._stage(KIND_DELTA, user_id, gen, data)
                report["deltas"] += 1
        for key in live:
            if key not in want and key not in self._pending:
                self._tombstones.add(key)
                report["removed"] += 1
        if self._pending or self._tombstones:
            report["epoch"] = self.commit(on_step=on_step)
        return report

    # ---------------- commit / compact ------------------------------------

    def commit(self, on_step: Callable | None = None) -> int:
        """Apply staged puts/tombstones as one atomic epoch bump.

        Write order (each step name fed to ``on_step`` BEFORE its write,
        for crash-schedule injection): ``slab:<id>`` and ``parity:<id>``
        per new slab, then ``manifest``, then ``gc``.  Until the manifest
        lands, disk state is the old epoch plus unreferenced new files —
        ``open`` rolls those back.  After it lands, the commit is final;
        GC is pure cleanup."""
        pending = [self._pending[k] for k in sorted(self._pending,
                                                    key=lambda k: (k[0], str(k[1])))]
        return self._commit(pending, set(self._tombstones), on_step,
                            replace=False)

    def compact(self, on_step: Callable | None = None) -> dict:
        """Rewrite every LIVE shard into fresh dense slabs (reclaiming
        dead bytes), repairing any single-fault shard it reads along the
        way.  Same crash-safety as ``commit``: one manifest swap, old
        slabs garbage-collected after.  Staged-but-uncommitted changes
        are committed first."""
        if self._pending or self._tombstones:
            self.commit()
        before = self.stats()
        live = []
        for _, e in self.manifest.live_entries():
            live.append((e.kind, e.name, e.generation,
                         self.read_shard(e.shard_id, repair=True)))
        live.sort(key=lambda t: (t[0], t[2] if t[0] == KIND_CODEBOOK else 0,
                                 t[1]))
        epoch = self._commit(live, set(), on_step, replace=True)
        after = self.stats()
        return {
            "epoch": epoch,
            "slabs_before": before["n_slabs"],
            "slabs_after": after["n_slabs"],
            "bytes_before": before["live_bytes"] + before["dead_bytes"],
            "bytes_after": after["live_bytes"] + after["dead_bytes"],
            "dead_bytes_reclaimed": before["dead_bytes"],
            "live_shards": after["live_shards"],
        }

    def _commit(self, pending: list, tombstones: set,
                on_step: Callable | None, replace: bool) -> int:
        step = on_step if on_step is not None else (lambda name: None)
        man = self.manifest
        dead_keys = set(tombstones)
        for kind, name, gen, _ in pending:
            dead_keys.add((kind, name) if kind == KIND_DELTA
                          else (kind, gen))
        next_sid = man.next_shard_id
        next_slab = man.next_slab_id
        k = man.slab_shards
        new_slabs = []
        for i in range(0, len(pending), k):
            chunk = pending[i:i + k]
            entries, payloads, off = [], [], 0
            for kind, name, gen, data in chunk:
                entries.append(ShardEntry(next_sid, kind, name, gen,
                                          off, len(data), _crc(data), True))
                next_sid += 1
                payloads.append(data)
                off += len(data)
            parity = xor_parity(payloads)
            slab_id = next_slab
            next_slab += 1
            step(f"slab:{slab_id}")
            self._write_file(_slab_name(slab_id), b"".join(payloads))
            step(f"parity:{slab_id}")
            self._write_file(_parity_name(slab_id), parity)
            new_slabs.append(SlabEntry(slab_id, len(parity), _crc(parity),
                                       entries))
        if replace:
            old_slabs = []
        else:
            old_slabs = [
                SlabEntry(s.slab_id, s.parity_len, s.parity_crc, [
                    dataclasses.replace(
                        e, live=e.live and e.key not in dead_keys)
                    for e in s.shards
                ])
                for s in man.slabs
            ]
        new_man = Manifest(man.epoch + 1, man.slab_shards,
                           next_sid, next_slab, old_slabs + new_slabs)
        step("manifest")
        self._write_file(_manifest_name(new_man.epoch), new_man.to_bytes())
        # the swap: everything before this line was invisible to recovery
        self._recovery = man
        self.manifest = new_man
        self._pending = {}
        self._tombstones = set()
        self._index = None
        self.n_commits += 1
        step("gc")
        self._gc()
        return new_man.epoch

    def _write_file(self, name: str, data: bytes) -> None:
        path = os.path.join(self.path, name)
        if self.write_fault is not None:
            self.write_fault(path, len(data))
        atomic_write_bytes(path, data)

    def _gc(self) -> list[str]:
        """Delete every file this module owns that neither the current
        nor the recovery manifest references.  Unknown files (journals,
        anything not matching our name patterns) are never touched."""
        keep = set()
        for man in (self.manifest, self._recovery):
            if man is None:
                continue
            keep.add(_manifest_name(man.epoch))
            for slab in man.slabs:
                keep.add(_slab_name(slab.slab_id))
                keep.add(_parity_name(slab.slab_id))
        removed = []
        try:
            names = os.listdir(self.path)
        except OSError:
            return removed
        for fname in sorted(names):
            if not _OWNED_RE.match(fname):
                continue
            if fname.endswith(".tmp") or fname not in keep:
                try:
                    os.remove(os.path.join(self.path, fname))
                    removed.append(fname)
                except OSError:
                    pass
        if removed:
            fsync_dir(self.path)
        return removed

    # ---------------- reads, repair ---------------------------------------

    def _build_index(self) -> None:
        by_id, by_user, by_slab = {}, {}, {}
        for slab in self.manifest.slabs:
            by_slab[slab.slab_id] = slab
            for e in slab.shards:
                by_id[e.shard_id] = (slab, e)
                if e.live and e.kind == KIND_DELTA:
                    by_user[e.name] = e
        self._index = (by_id, by_user, by_slab)

    def _locate(self, shard_id: int) -> tuple["SlabEntry", "ShardEntry"]:
        if self._index is None:
            self._build_index()
        try:
            return self._index[0][shard_id]
        except KeyError:
            raise KeyError(f"unknown shard id {shard_id}") from None

    def _slab(self, slab_id: int) -> SlabEntry:
        if self._index is None:
            self._build_index()
        try:
            return self._index[2][slab_id]
        except KeyError:
            raise KeyError(f"unknown slab id {slab_id}") from None

    def shard_for_user(self, user_id: str) -> "ShardEntry | None":
        """The live delta ``ShardEntry`` for ``user_id``, or ``None``."""
        if self._index is None:
            self._build_index()
        return self._index[1].get(user_id)

    def codebook_entries(self) -> list:
        """Live codebook shard entries, ascending generation."""
        return sorted((e for _, e in self.manifest.live_entries()
                       if e.kind == KIND_CODEBOOK),
                      key=lambda e: e.generation)

    def delta_entries(self) -> list:
        """Live delta shard entries, sorted by user id."""
        return sorted((e for _, e in self.manifest.live_entries()
                       if e.kind == KIND_DELTA),
                      key=lambda e: e.name)

    def shard_location(self, shard_id: int) -> tuple[str, int, int]:
        """``(slab_path, offset, length)`` of one shard's bytes — how
        tests and benches aim ``DiskFaults`` at a specific shard."""
        slab, e = self._locate(shard_id)
        return (os.path.join(self.path, _slab_name(slab.slab_id)),
                e.offset, e.length)

    def parity_location(self, slab_id: int) -> str:
        return os.path.join(self.path, _parity_name(slab_id))

    def read_shard(self, shard_id: int, repair: bool = False) -> bytes:
        """Read + CRC-verify one shard's bytes.  On any fault (missing or
        truncated slab file, CRC mismatch): raise a typed
        ``IntegrityError`` when ``repair=False`` — the serving layer's
        quarantine signal — or attempt parity reconstruction when
        ``repair=True`` (which raises ``UnrepairableError`` on a double
        fault and heals the slab file on success)."""
        slab, e = self._locate(shard_id)
        try:
            return self._read_verified(slab, e)
        except IntegrityError:
            if not repair:
                raise
        return self.repair_shard(shard_id)

    def _read_verified(self, slab: SlabEntry, e: ShardEntry) -> bytes:
        path = os.path.join(self.path, _slab_name(slab.slab_id))
        try:
            with open(path, "rb") as f:
                f.seek(e.offset)
                data = f.read(e.length)
        except OSError as exc:
            raise IntegrityError(
                f"{e.describe()}: slab file unreadable: {exc}"
            ) from exc
        if len(data) != e.length:
            raise IntegrityError(
                f"{e.describe()}: slab truncated (wanted {e.length} bytes "
                f"at offset {e.offset}, got {len(data)})"
            )
        if self.read_fault is not None:
            data = self.read_fault(e.shard_id, data)
        if _crc(data) != e.crc:
            raise IntegrityError(f"{e.describe()}: CRC mismatch")
        return data

    def _read_parity(self, slab: SlabEntry) -> bytes:
        path = os.path.join(self.path, _parity_name(slab.slab_id))
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError as exc:
            raise IntegrityError(
                f"parity {slab.slab_id}: unreadable: {exc}"
            ) from exc
        if len(data) != slab.parity_len:
            raise IntegrityError(
                f"parity {slab.slab_id}: wrong length ({len(data)} != "
                f"{slab.parity_len})"
            )
        if _crc(data) != slab.parity_crc:
            raise IntegrityError(f"parity {slab.slab_id}: CRC mismatch")
        return data

    def repair_shard(self, shard_id: int) -> bytes:
        """Reconstruct one shard from its slab siblings + parity, verify
        bit-exactness against the manifest CRC32, and heal the slab file
        on disk.  Raises ``UnrepairableError`` when any sibling or the
        parity shard is ALSO damaged (double fault) — detected corruption
        never silently degrades."""
        slab, victim = self._locate(shard_id)
        faults: list[str] = []
        siblings: dict[int, bytes] = {}
        for e in slab.shards:
            if e.shard_id == victim.shard_id:
                continue
            try:
                siblings[e.shard_id] = self._read_verified(slab, e)
            except IntegrityError as exc:
                faults.append(str(exc))
        parity = None
        try:
            parity = self._read_parity(slab)
        except IntegrityError as exc:
            faults.append(str(exc))
        if faults:
            raise UnrepairableError(
                f"slab {slab.slab_id}: cannot reconstruct "
                f"{victim.describe()} — XOR repair needs every sibling and "
                f"the parity shard intact, but: {'; '.join(faults)}"
            )
        acc = np.frombuffer(parity, dtype=np.uint8).copy()
        for data in siblings.values():
            a = np.frombuffer(data, dtype=np.uint8)
            acc[: len(a)] ^= a
        recon = acc[: victim.length].tobytes()
        if _crc(recon) != victim.crc:
            raise UnrepairableError(
                f"slab {slab.slab_id}: reconstruction of "
                f"{victim.describe()} fails its manifest CRC — more than "
                f"one region of the group is corrupt"
            )
        ordered = sorted(slab.shards, key=lambda e: e.offset)
        blob = b"".join(
            recon if e.shard_id == victim.shard_id else siblings[e.shard_id]
            for e in ordered
        )
        self._write_file(_slab_name(slab.slab_id), blob)
        self.n_repairs += 1
        return recon

    def rebuild_parity(self, slab_id: int) -> bytes:
        """Recompute + rewrite one slab's parity file from its (verified)
        data shards — the repair path for a lost or corrupted parity
        shard.  Raises ``IntegrityError`` if any data shard is itself bad
        (repair that shard first; if BOTH are bad the group is
        unrepairable)."""
        slab = self._slab(slab_id)
        payloads = [self._read_verified(slab, e)
                    for e in sorted(slab.shards, key=lambda e: e.offset)]
        parity = xor_parity(payloads)
        if len(parity) != slab.parity_len or _crc(parity) != slab.parity_crc:
            raise IntegrityError(
                f"parity {slab_id}: recomputed parity disagrees with the "
                f"manifest — slab data is inconsistent"
            )
        self._write_file(_parity_name(slab_id), parity)
        self.n_parity_rebuilds += 1
        return parity

    # ---------------- loading ---------------------------------------------

    def load_store(self, tile_cache_trees: int = 4096,
                   arena_capacity_trees: int = 16384,
                   lazy: bool = True,
                   device: str | torch.device = "cuda") -> ForestStore:
        """Materialize a ``ForestStore`` on ``device`` from the committed
        fleet.

        Codebooks load (and self-repair) eagerly — they are shared and
        load-bearing.  With ``lazy=True`` (default) per-user deltas stay
        on disk behind ``_LazyShard`` placeholders: open cost is the
        manifest + codebooks, independent of fleet size, and a corrupt
        delta surfaces as a typed error at FIRST ACCESS, where
        ``serve_safe``'s quarantine + auto-repair path handles it."""
        cb_entries = self.codebook_entries()
        if not cb_entries:
            raise IntegrityError(
                "durable store holds no live codebook shard"
            )
        codebooks = [
            SharedCodebook.from_bytes(self.read_shard(e.shard_id, repair=True))
            for e in cb_entries
        ]
        store = ForestStore(codebooks[-1], tile_cache_trees,
                            arena_capacity_trees, device=device)
        for cb in codebooks[:-1]:
            store._retained[cb.generation] = cb
        gens = {cb.generation for cb in codebooks}
        lazy_map = _LazyDeltaMap(self)
        store._deltas = lazy_map
        for e in self.delta_entries():
            if e.generation not in gens:
                raise IntegrityError(
                    f"{e.describe()} references codebook generation "
                    f"{e.generation}, but no such codebook shard is live"
                )
            if lazy:
                dict.__setitem__(
                    lazy_map, e.name,
                    _LazyShard(self, lazy_map, e.name, e.shard_id,
                               e.generation),
                )
            else:
                store.add_delta(
                    e.name,
                    UserDelta.from_bytes(self.read_shard(e.shard_id,
                                                         repair=True)),
                )
        return store

    # ---------------- introspection ---------------------------------------

    def stats(self) -> dict:
        man = self.manifest
        live = list(man.live_entries())
        return {
            "path": self.path,
            "epoch": man.epoch,
            "slab_shards": man.slab_shards,
            "n_slabs": len(man.slabs),
            "live_shards": len(live),
            "dead_shards": sum(1 for _, e in man.entries() if not e.live),
            "live_bytes": man.live_bytes(),
            "dead_bytes": man.dead_bytes(),
            "n_users": sum(1 for _, e in live if e.kind == KIND_DELTA),
            "n_codebooks": sum(1 for _, e in live if e.kind == KIND_CODEBOOK),
            "pending": len(self._pending),
            "tombstones": len(self._tombstones),
            "n_commits": self.n_commits,
            "n_repairs": self.n_repairs,
            "n_parity_rebuilds": self.n_parity_rebuilds,
        }


# ---------------------------------------------------------------------------
# background scrubbing
# ---------------------------------------------------------------------------

@guarded_by(
    "_lock",
    "_items", "_cursor", "passes", "shards_scanned", "parities_scanned",
    "repairs", "parity_rebuilds", "bytes_scanned", "unrepairable",
    holds=("_refill", "_scan"),
)
class Scrubber:
    """Incremental CRC scrubber with parity repair.

    Walks every shard AND every parity file of the manifest (dead shards
    included — parity covers them, so a live sibling's repairability
    depends on their bytes too) a bounded number of items per ``tick``;
    on a verification failure it repairs from parity (``repair_shard``) /
    recomputes parity (``rebuild_parity``), and records a typed
    unrepairable fault — never ignores one.  A completed walk starts the
    next pass from the then-current manifest, so compactions mid-pass
    simply retire stale queue items (skipped via their vanished ids).

    A scheduler (``repro_torch.sched.LifecycleDriver``) calls
    ``tick`` in low-load gaps; tests and benches call ``scrub_all``.
    ``tick``/``scrub_all`` run on the pump
    thread while ``stats`` may be read from any thread, so the walk
    state and counters are guarded by ``_lock``."""

    def __init__(self, durable: DurableStore,
                 shards_per_tick: int = 64) -> None:
        self.durable = durable
        self.shards_per_tick = shards_per_tick
        self._lock = threading.Lock()
        self._items: list = []
        self._cursor = 0
        self.passes = 0
        self.shards_scanned = 0
        self.parities_scanned = 0
        self.repairs = 0
        self.parity_rebuilds = 0
        self.bytes_scanned = 0
        self.unrepairable: list = []

    def _refill(self) -> None:
        items = []
        for slab in self.durable.manifest.slabs:
            for e in slab.shards:
                items.append(("shard", slab.slab_id, e.shard_id))
            items.append(("parity", slab.slab_id, None))
        self._items = items
        self._cursor = 0

    def tick(self, budget: int | None = None) -> dict:
        """Scan up to ``budget`` items (default ``shards_per_tick``);
        returns this tick's counts."""
        budget = self.shards_per_tick if budget is None else budget
        out = {"scanned": 0, "repaired": 0, "parity_rebuilt": 0,
               "unrepairable": 0}
        with self._lock:
            while budget > 0:
                if self._cursor >= len(self._items):
                    self._refill()
                    if self._items:
                        self.passes += 1
                    else:
                        break
                item = self._items[self._cursor]
                self._cursor += 1
                budget -= 1
                self._scan(item, out)
        return out

    def scrub_all(self) -> dict:
        """One complete pass over the current manifest, in one call."""
        out = {"scanned": 0, "repaired": 0, "parity_rebuilt": 0,
               "unrepairable": 0}
        with self._lock:
            self._refill()
            if self._items:
                self.passes += 1
            while self._cursor < len(self._items):
                item = self._items[self._cursor]
                self._cursor += 1
                self._scan(item, out)
        return out

    def _scan(self, item: tuple, out: dict) -> None:
        # caller holds self._lock (declared via guarded_by holds=)
        kind, slab_id, shard_id = item
        try:
            if kind == "shard":
                data = self.durable.read_shard(shard_id)
                self.shards_scanned += 1
                self.bytes_scanned += len(data)
            else:
                slab = self.durable._slab(slab_id)
                parity = self.durable._read_parity(slab)
                self.parities_scanned += 1
                self.bytes_scanned += len(parity)
            out["scanned"] += 1
        except KeyError:
            # shard/slab vanished (compaction mid-pass): stale item
            return
        except IntegrityError:
            out["scanned"] += 1
            try:
                if kind == "shard":
                    self.shards_scanned += 1
                    self.durable.repair_shard(shard_id)
                    self.repairs += 1
                    out["repaired"] += 1
                else:
                    self.parities_scanned += 1
                    self.durable.rebuild_parity(slab_id)
                    self.parity_rebuilds += 1
                    out["parity_rebuilt"] += 1
            except (UnrepairableError, IntegrityError) as exc:
                self.unrepairable.append(
                    (f"{kind}:{shard_id if kind == 'shard' else slab_id}",
                     str(exc))
                )
                out["unrepairable"] += 1

    def stats(self) -> dict:
        with self._lock:
            return {
                "passes": self.passes,
                "queue_position": self._cursor,
                "queue_length": len(self._items),
                "shards_scanned": self.shards_scanned,
                "parities_scanned": self.parities_scanned,
                "repairs": self.repairs,
                "parity_rebuilds": self.parity_rebuilds,
                "bytes_scanned": self.bytes_scanned,
                "unrepairable": list(self.unrepairable),
            }


# ---------------------------------------------------------------------------
# serving integration: quarantine -> parity repair -> verify -> release
# ---------------------------------------------------------------------------

def attach_auto_repair(
    server: Any, durable: DurableStore
) -> Callable[[str], bool]:
    """Wire a ``ForestServer``'s quarantine to the durable store's parity
    repair: when ``serve_safe`` quarantines (or is about to quarantine) a
    user, the repairer re-reads the user's shard with ``repair=True``
    (bit-exact by manifest CRC), re-parses the RFD1 frame, and
    re-registers the delta — bumping the user's version so the existing
    quarantine refresh releases them; the probe then re-verifies the
    decode end-to-end before serving.  An ``UnrepairableError`` (double
    fault) propagates into the server's repair-failure accounting and the
    user STAYS quarantined — never served wrong.  Returns the repairer
    (also installed on the server)."""
    store = server.store

    def repair(user_id: str) -> bool:
        entry = durable.shard_for_user(user_id)
        if entry is None:
            return False
        data = durable.read_shard(entry.shard_id, repair=True)
        delta = UserDelta.from_bytes(data)
        store.add_delta(user_id, delta)
        return True

    server.attach_repairer(repair)
    return repair
