"""The port's durable tier (``repro_torch.store.durable``) against the JAX
reference on the CPU.

* Frames: the RFN1 manifest, the slab files and their XOR parity files
  that either package writes for the same fleet are equal byte for byte,
  and each package reads the other's.
* A durable directory written by one package opens in the other, lazily
  and eagerly, bit-exact per user.
* The port's own copies of ``tests/test_durable.py``'s checks (atomic
  writes, the manifest, create / open / commit, parity repair, the
  scrubber and its scheduling by ``repro_torch.sched.LifecycleDriver``
  in low-load gaps, crash sweeps and serving's quarantine -> repair ->
  release), unweakened, on ``device="cpu"``.
"""
import os
import shutil

import numpy as np
import pytest

from repro.core.framing import IntegrityError as RefIntegrityError
from repro.serving import ForestServer as RefServer
from repro.store import DurableStore as RefDurable
from repro.store import build_store as ref_build_store
from repro.store import make_synthetic_fleet as ref_fleet
from repro.store.durable import Manifest as RefManifest
from repro.store.durable import xor_parity as ref_xor_parity
from repro_torch.core import framing
from repro_torch.core.framing import (
    IntegrityError,
    UnrepairableError,
    atomic_write_bytes,
)
from repro_torch.runtime.chaos import (
    CrashSchedule,
    DiskFaults,
    InjectedCrash,
    record_steps,
)
from repro_torch.serving import ForestServer
from repro_torch.store import MigrationJournal, build_store, make_synthetic_fleet
from repro_torch.store.durable import (
    KIND_CODEBOOK,
    KIND_DELTA,
    DurableStore,
    Manifest,
    Scrubber,
    attach_auto_repair,
    xor_parity,
)

CPU = "cpu"
FLEET_KW = dict(n_users=6, d=5, n_bins=12, seed=3, n_trees=(3, 5),
                max_depth=3)


@pytest.fixture(scope="module")
def store0():
    """The port's store of ``tests/test_durable.py``'s fleet: the store
    every check holds the durable tier to."""
    return build_store(make_synthetic_fleet(**FLEET_KW), seed=0, device=CPU)


@pytest.fixture(scope="module")
def jax_store():
    """The reference's store of the same fleet."""
    return ref_build_store(ref_fleet(**FLEET_KW), seed=0)


@pytest.fixture(scope="module")
def bytes0(store0):
    return {u: store0.delta(u).to_bytes() for u in store0.user_ids}


@pytest.fixture()
def durable(tmp_path, store0):
    return DurableStore.create(str(tmp_path / "fleet"), store0)


def _assert_fleet_bit_exact(durable, bytes0, users=None):
    loaded = durable.load_store(lazy=False, device=CPU)
    expect = set(bytes0) if users is None else set(users)
    assert set(loaded.user_ids) == expect
    for u in loaded.user_ids:
        assert loaded.delta(u).to_bytes() == bytes0[u], u


def _files(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


# ---------------------------------------------------------------------------
# differential: frames and directories across the two packages
# ---------------------------------------------------------------------------

def test_same_fleet_same_deltas(store0, jax_store):
    assert store0.to_bytes() == jax_store.to_bytes()


@pytest.mark.parametrize("slab_shards", [1, 3, 8])
def test_directories_equal_byte_for_byte(tmp_path, store0, jax_store,
                                         slab_shards):
    """Manifest, slabs and parity files: the same names, the same bytes."""
    port = DurableStore.create(str(tmp_path / "port"), store0,
                               slab_shards=slab_shards)
    ref = RefDurable.create(str(tmp_path / "ref"), jax_store,
                            slab_shards=slab_shards)
    assert port.manifest.to_bytes() == ref.manifest.to_bytes()
    assert _files(port.path) == _files(ref.path)
    assert port.stats() == {**ref.stats(), "path": port.path}


def test_manifest_frames_cross_decode(durable, tmp_path, jax_store):
    ref = RefDurable.create(str(tmp_path / "ref"), jax_store)
    ours, theirs = durable.manifest.to_bytes(), ref.manifest.to_bytes()
    assert RefManifest.from_bytes(ours).to_bytes() == ours
    assert Manifest.from_bytes(theirs).to_bytes() == theirs
    got = Manifest.from_bytes(theirs)
    assert [(e.shard_id, e.kind, e.name, e.generation, e.offset, e.length,
             e.crc, e.live) for _, e in got.entries()] == [
        (e.shard_id, e.kind, e.name, e.generation, e.offset, e.length,
         e.crc, e.live) for _, e in ref.manifest.entries()]
    bad = bytearray(theirs)
    bad[10] ^= 0xFF
    with pytest.raises(IntegrityError):
        Manifest.from_bytes(bytes(bad))


@pytest.mark.parametrize("seed", range(4))
def test_xor_parity_equals_reference(seed):
    rng = np.random.default_rng(seed)
    payloads = [rng.integers(0, 256, int(n)).astype(np.uint8).tobytes()
                for n in rng.integers(0, 64, int(rng.integers(1, 9)))]
    assert xor_parity(payloads) == ref_xor_parity(payloads)
    assert xor_parity([]) == ref_xor_parity([]) == b""


@pytest.mark.parametrize("lazy", [True, False])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_directory_opens_in_the_other_package(tmp_path, store0, jax_store,
                                              bytes0, writer, lazy):
    path = str(tmp_path / "fleet")
    if writer == "reference":
        RefDurable.create(path, jax_store, slab_shards=3)
        loaded = DurableStore.open(path).load_store(lazy=lazy, device=CPU)
    else:
        DurableStore.create(path, store0, slab_shards=3)
        loaded = RefDurable.open(path).load_store(lazy=lazy)
    assert loaded.generations == store0.generations
    assert sorted(loaded.user_ids) == sorted(bytes0)
    for u in sorted(bytes0):
        assert loaded.delta(u).to_bytes() == bytes0[u], u
    assert loaded.to_bytes() == store0.to_bytes()


def test_commit_and_compact_keep_directories_equal(tmp_path, store0,
                                                   jax_store):
    """The same staged puts, tombstones and compaction on both packages
    leave the same files."""
    port = DurableStore.create(str(tmp_path / "port"), store0,
                               slab_shards=3)
    ref = RefDurable.create(str(tmp_path / "ref"), jax_store, slab_shards=3)
    users = store0.user_ids
    for d, store in ((port, store0), (ref, jax_store)):
        d.put_delta("late", store.delta(users[0]))
        d.remove_user(users[5])
        d.commit()
    assert _files(port.path) == _files(ref.path)
    assert port.compact() == ref.compact()
    assert _files(port.path) == _files(ref.path)


def test_port_repairs_a_reference_directory(tmp_path, jax_store, bytes0):
    path = str(tmp_path / "fleet")
    RefDurable.create(path, jax_store)
    d = DurableStore.open(path)
    u = jax_store.user_ids[2]
    entry = d.shard_for_user(u)
    spath, off, length = d.shard_location(entry.shard_id)
    DiskFaults().corrupt_region(spath, off, min(length, 16))
    with pytest.raises(RefIntegrityError):
        RefDurable.open(path).read_shard(entry.shard_id)
    assert d.read_shard(entry.shard_id, repair=True) == bytes0[u]
    # healed on disk: the reference reads it again
    assert RefDurable.open(path).read_shard(entry.shard_id) == bytes0[u]


def test_load_store_puts_the_arena_on_the_asked_device(durable):
    store = durable.load_store(device=CPU)
    assert store.device.type == "cpu"
    assert store.arena.device.type == "cpu"


def test_load_store_default_device_is_the_card(durable):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        durable.load_store()


def test_served_lazy_store_equals_reference_session(durable, tmp_path,
                                                    jax_store):
    """A lazily-opened port store serves every engine exactly as the
    reference session serves the reference's lazily-opened copy."""
    RefDurable.create(str(tmp_path / "ref"), jax_store)
    port = ForestServer(durable.load_store(lazy=True, device=CPU),
                        device=CPU)
    ref = RefServer(RefDurable.open(str(tmp_path / "ref")).load_store())
    reqs = _requests_for(jax_store, jax_store.user_ids, rows=7, seed=11)
    for engine in ("pipelined", "simple"):
        got = port.serve(reqs, engine=engine)
        want = ref.serve(reqs, engine=engine)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, np.asarray(w))


# ---------------------------------------------------------------------------
# the shared atomic-write helper
# ---------------------------------------------------------------------------

class TestAtomicWrite:
    def test_write_and_overwrite(self, tmp_path):
        p = str(tmp_path / "x.bin")
        atomic_write_bytes(p, b"one")
        assert open(p, "rb").read() == b"one"
        atomic_write_bytes(p, b"two")
        assert open(p, "rb").read() == b"two"
        assert not os.path.exists(p + ".tmp")

    def test_journal_persist_uses_shared_helper(self, tmp_path, monkeypatch):
        """``MigrationJournal._persist`` routes through the one
        dir-fsyncing helper."""
        calls = []
        real = framing.atomic_write_bytes

        def spy(path, data):
            calls.append(path)
            real(path, data)

        import repro_torch.store.lifecycle as lifecycle
        monkeypatch.setattr(lifecycle, "atomic_write_bytes", spy)
        path = str(tmp_path / "journal.rfj")
        j = MigrationJournal(path=path)
        j.log_migrate_intent("u0", b"delta-bytes")
        assert calls == [path]
        assert MigrationJournal.load(path).to_bytes() == j.to_bytes()


# ---------------------------------------------------------------------------
# RFN1 manifest frame
# ---------------------------------------------------------------------------

class TestManifest:
    def test_roundtrip(self, durable):
        man = durable.manifest
        again = Manifest.from_bytes(man.to_bytes())
        assert again == man

    def test_corruption_is_typed(self, durable):
        data = durable.manifest.to_bytes()
        bad = bytearray(data)
        bad[10] ^= 0xFF
        with pytest.raises(IntegrityError):
            Manifest.from_bytes(bytes(bad))

    def test_missing_trailer_is_typed(self, durable):
        data = durable.manifest.to_bytes()
        with pytest.raises(IntegrityError, match="CRC"):
            Manifest.from_bytes(data[:-8])

    def test_xor_parity_recovers_any_single_payload(self):
        payloads = [b"abcdef", b"xy", b"0123456789", b""]
        parity = xor_parity(payloads)
        assert len(parity) == 10
        for i, victim in enumerate(payloads):
            acc = np.frombuffer(parity, np.uint8).copy()
            for j, p in enumerate(payloads):
                if j != i:
                    a = np.frombuffer(p, np.uint8)
                    acc[: len(a)] ^= a
            assert acc[: len(victim)].tobytes() == victim


# ---------------------------------------------------------------------------
# create / open / commit basics
# ---------------------------------------------------------------------------

class TestDurableBasics:
    def test_create_rejects_existing(self, tmp_path, store0, durable):
        with pytest.raises(ValueError, match="already"):
            DurableStore.create(durable.path, store0)

    def test_open_missing_dir_typed(self, tmp_path):
        with pytest.raises(IntegrityError):
            DurableStore.open(str(tmp_path / "nope"))

    def test_empty_store_roundtrip(self, tmp_path):
        d = DurableStore.create(str(tmp_path / "empty"))
        d2 = DurableStore.open(d.path)
        assert d2.manifest.epoch == 0
        with pytest.raises(IntegrityError, match="no live codebook"):
            d2.load_store(device=CPU)

    def test_eager_roundtrip_bit_exact(self, durable, bytes0):
        _assert_fleet_bit_exact(DurableStore.open(durable.path), bytes0)

    def test_lazy_roundtrip_bit_exact(self, durable, store0, bytes0):
        loaded = DurableStore.open(durable.path).load_store(lazy=True,
                                                            device=CPU)
        assert loaded.generations == store0.generations
        assert set(loaded.user_ids) == set(bytes0)
        for u in sorted(bytes0):
            assert loaded.delta(u).to_bytes() == bytes0[u]

    def test_lazy_load_touches_only_codebooks(self, durable, store0):
        faults = DiskFaults()
        d = DurableStore.open(durable.path, read_fault=faults.on_read)
        loaded = d.load_store(lazy=True, device=CPU)
        n_cb = len(store0.generations)
        assert faults.reads == n_cb  # manifest + codebooks only
        assert loaded._deltas.n_loaded() == 0
        assert loaded.referenced_generations() == {store0.generation}
        assert faults.reads == n_cb
        u = store0.user_ids[0]
        loaded.delta(u)
        assert faults.reads == n_cb + 1
        assert loaded._deltas.n_loaded() == 1
        loaded.delta(u)
        assert faults.reads == n_cb + 1

    def test_replace_and_remove(self, durable, store0, bytes0):
        users = store0.user_ids
        durable.put_delta("extra", store0.delta(users[0]))
        durable.remove_user(users[5])
        epoch = durable.commit()
        assert epoch == durable.manifest.epoch
        assert durable.stats()["dead_shards"] == 1
        want = dict(bytes0)
        del want[users[5]]
        want["extra"] = bytes0[users[0]]
        _assert_fleet_bit_exact(DurableStore.open(durable.path), want)

    def test_epoch_monotonic_and_open_picks_highest(self, durable,
                                                    store0):
        e0 = durable.manifest.epoch
        durable.put_delta("u_a", store0.delta(store0.user_ids[0]))
        e1 = durable.commit()
        durable.put_delta("u_b", store0.delta(store0.user_ids[1]))
        e2 = durable.commit()
        assert e0 < e1 < e2
        assert DurableStore.open(durable.path).manifest.epoch == e2

    def test_torn_manifest_rolls_back_to_previous_epoch(
        self, durable, store0, bytes0
    ):
        durable.put_delta("late", store0.delta(store0.user_ids[0]))
        e2 = durable.commit()
        newest = os.path.join(durable.path, f"manifest-{e2:08d}.rfn")
        DiskFaults(seed=1).torn_write(newest, os.path.getsize(newest) // 2)
        d = DurableStore.open(durable.path)
        assert d.manifest.epoch == e2 - 1
        assert not os.path.exists(newest)
        _assert_fleet_bit_exact(d, bytes0)

    def test_garbage_manifest_file_rolled_back(self, durable, bytes0):
        e = durable.manifest.epoch
        garbage = os.path.join(durable.path, f"manifest-{e + 1:08d}.rfn")
        with open(garbage, "wb") as f:
            f.write(b"not a manifest")
        d = DurableStore.open(durable.path)
        assert d.manifest.epoch == e
        assert not os.path.exists(garbage)
        _assert_fleet_bit_exact(d, bytes0)

    def test_enospc_mid_commit_is_retryable(self, durable, store0,
                                            bytes0):
        e0 = durable.manifest.epoch
        faults = DiskFaults(enospc_after=1)
        durable.write_fault = faults.on_write
        durable.put_delta("late", store0.delta(store0.user_ids[0]))
        with pytest.raises(OSError):
            durable.commit()
        assert durable.manifest.epoch == e0
        _assert_fleet_bit_exact(DurableStore.open(durable.path), bytes0)
        durable.write_fault = None
        durable.commit()
        want = dict(bytes0, late=bytes0[store0.user_ids[0]])
        _assert_fleet_bit_exact(DurableStore.open(durable.path), want)

    def test_sync_is_incremental(self, durable, store0):
        report = durable.sync(store0)
        assert report["codebooks"] == 0 and report["deltas"] == 0
        assert report["unchanged"] == len(store0.user_ids) + 1

    def test_gc_leaves_foreign_files_alone(self, durable, store0):
        foreign = os.path.join(durable.path, "journal.rfj")
        with open(foreign, "wb") as f:
            f.write(b"keep me")
        durable.put_delta("late", store0.delta(store0.user_ids[0]))
        durable.commit()
        durable.compact()
        assert open(foreign, "rb").read() == b"keep me"


# ---------------------------------------------------------------------------
# parity repair
# ---------------------------------------------------------------------------

class TestRepair:
    def _corrupt_user(self, durable, user_id, n=16):
        entry = durable.shard_for_user(user_id)
        path, off, length = durable.shard_location(entry.shard_id)
        DiskFaults().corrupt_region(path, off, min(length, n))
        return entry

    def test_single_corruption_detected_then_repaired(
        self, durable, store0, bytes0
    ):
        u = store0.user_ids[0]
        entry = self._corrupt_user(durable, u)
        with pytest.raises(IntegrityError):
            durable.read_shard(entry.shard_id)
        assert durable.read_shard(entry.shard_id, repair=True) == bytes0[u]
        assert durable.n_repairs == 1
        assert durable.read_shard(entry.shard_id) == bytes0[u]

    def test_truncated_slab_repairs_last_shard(self, durable, store0,
                                               bytes0):
        slab = durable.manifest.slabs[0]
        last = max(slab.shards, key=lambda e: e.offset)
        path, off, _ = durable.shard_location(last.shard_id)
        DiskFaults().torn_write(path, off + 1)
        data = durable.read_shard(last.shard_id, repair=True)
        _crc_ref = [e for e in slab.shards if e.shard_id == last.shard_id]
        assert len(data) == _crc_ref[0].length
        _assert_fleet_bit_exact(durable, bytes0)

    def test_double_fault_is_typed_unrepairable(self, durable, store0):
        u1, u2 = store0.user_ids[0], store0.user_ids[1]
        e1 = self._corrupt_user(durable, u1)
        self._corrupt_user(durable, u2)
        with pytest.raises(UnrepairableError):
            durable.read_shard(e1.shard_id, repair=True)
        with pytest.raises(IntegrityError):
            durable.read_shard(e1.shard_id)

    def test_missing_parity_plus_corrupt_shard_unrepairable(
        self, durable, store0
    ):
        entry = self._corrupt_user(durable, store0.user_ids[0])
        slab_id = durable.manifest.slabs[0].slab_id
        DiskFaults().missing(durable.parity_location(slab_id))
        with pytest.raises(UnrepairableError, match="parity"):
            durable.read_shard(entry.shard_id, repair=True)

    def test_missing_parity_alone_rebuilds(self, durable):
        slab_id = durable.manifest.slabs[0].slab_id
        DiskFaults().missing(durable.parity_location(slab_id))
        scrubber = Scrubber(durable)
        out = scrubber.scrub_all()
        assert out["parity_rebuilt"] == 1
        assert out["unrepairable"] == 0
        assert durable.n_parity_rebuilds == 1
        u = durable.delta_entries()[0]
        path, off, length = durable.shard_location(u.shard_id)
        DiskFaults().corrupt_region(path, off, min(length, 8))
        durable.read_shard(u.shard_id, repair=True)

    def test_missing_single_shard_slab_file_repairs(self, durable,
                                                    store0, bytes0):
        u = store0.user_ids[0]
        durable.put_delta("solo", store0.delta(u))
        durable.commit()
        entry = durable.shard_for_user("solo")
        path, _, _ = durable.shard_location(entry.shard_id)
        DiskFaults().missing(path)
        assert durable.read_shard(entry.shard_id, repair=True) == bytes0[u]
        assert os.path.exists(path)

    def test_missing_multi_shard_slab_file_unrepairable(self, durable,
                                                        store0):
        slab = durable.manifest.slabs[0]
        assert len(slab.shards) > 1
        DiskFaults().missing(
            os.path.join(durable.path, f"slab-{slab.slab_id:08d}.rfb")
        )
        with pytest.raises(UnrepairableError):
            durable.read_shard(slab.shards[0].shard_id, repair=True)

    def test_bit_rot_on_read_hook(self, durable, store0, bytes0):
        u = store0.user_ids[2]
        entry = durable.shard_for_user(u)
        faults = DiskFaults(seed=9, rot_shards=(entry.shard_id,))
        d = DurableStore.open(durable.path, read_fault=faults.on_read)
        with pytest.raises(IntegrityError):
            d.read_shard(entry.shard_id)
        assert d.read_shard(entry.shard_id, repair=True) == bytes0[u]
        assert faults.rotted


# ---------------------------------------------------------------------------
# scrubber
# ---------------------------------------------------------------------------

class TestScrubber:
    def test_incremental_ticks_cover_everything(self, durable):
        man = durable.manifest
        n_items = sum(len(s.shards) + 1 for s in man.slabs)
        scrubber = Scrubber(durable, shards_per_tick=3)
        total = 0
        while scrubber.passes == 0 or scrubber._cursor < len(scrubber._items):
            total += scrubber.tick()["scanned"]
            if total >= n_items:
                break
        stats = scrubber.stats()
        assert stats["shards_scanned"] + stats["parities_scanned"] >= n_items
        assert stats["bytes_scanned"] > 0
        assert stats["repairs"] == 0 and stats["unrepairable"] == []

    def test_scrub_repairs_and_reload_is_bit_exact(self, durable, store0,
                                                   bytes0):
        u = store0.user_ids[3]
        entry = durable.shard_for_user(u)
        path, off, length = durable.shard_location(entry.shard_id)
        DiskFaults().corrupt_region(path, off, min(length, 32))
        out = Scrubber(durable).scrub_all()
        assert out["repaired"] == 1
        assert out["unrepairable"] == 0
        _assert_fleet_bit_exact(durable, bytes0)

    def test_scrub_records_unrepairable(self, durable, store0):
        for u in store0.user_ids[:2]:
            entry = durable.shard_for_user(u)
            path, off, length = durable.shard_location(entry.shard_id)
            DiskFaults().corrupt_region(path, off, min(length, 8))
        scrubber = Scrubber(durable)
        out = scrubber.scrub_all()
        assert out["unrepairable"] == 2
        assert out["repaired"] == 0
        assert len(scrubber.stats()["unrepairable"]) == 2


# ---------------------------------------------------------------------------
# crash sweeps: kill at EVERY write/compaction step
# ---------------------------------------------------------------------------

class TestCrashSweep:
    def _sweep(self, base, snap, op, check):
        steps = record_steps(op)
        assert steps, "operation produced no steps"
        assert steps[-2:] == ["manifest", "gc"]
        for i, name in enumerate(steps):
            shutil.rmtree(base)
            shutil.copytree(snap, base)
            with pytest.raises(InjectedCrash):
                op(CrashSchedule(fail_at=(i,)))
            check(i, name)
        return steps

    def test_commit_crash_at_every_step(self, tmp_path, store0,
                                        bytes0):
        base = str(tmp_path / "fleet")
        users = store0.user_ids
        DurableStore.create(base, store0, slab_shards=3)
        snap = str(tmp_path / "snap")
        shutil.copytree(base, snap)
        post = dict(bytes0)
        del post[users[5]]
        post["late"] = bytes0[users[0]]

        def op(on_step):
            d = DurableStore.open(base)
            d.put_delta("late", DurableStore.open(base)
                        .load_store(device=CPU).delta(users[0]))
            d.remove_user(users[5])
            d.commit(on_step=on_step)

        def check(i, name):
            d = DurableStore.open(base)
            want = bytes0 if name != "gc" else post
            _assert_fleet_bit_exact(d, want)

        steps = self._sweep(base, snap, op, check)
        assert sum(s.startswith("slab:") for s in steps) >= 1

    def test_compact_crash_at_every_step(self, tmp_path, store0,
                                         bytes0):
        base = str(tmp_path / "fleet")
        users = store0.user_ids
        d0 = DurableStore.create(base, store0, slab_shards=3)
        d0.put_delta(users[0], store0.delta(users[0]))
        d0.remove_user(users[5])
        d0.commit()
        assert d0.stats()["dead_bytes"] > 0
        snap = str(tmp_path / "snap")
        shutil.copytree(base, snap)
        live = dict(bytes0)
        del live[users[5]]

        def op(on_step):
            DurableStore.open(base).compact(on_step=on_step)

        def check(i, name):
            d = DurableStore.open(base)
            _assert_fleet_bit_exact(d, live)
            d.compact()
            assert d.stats()["dead_bytes"] == 0
            _assert_fleet_bit_exact(d, live)

        self._sweep(base, snap, op, check)


# ---------------------------------------------------------------------------
# serving: quarantine -> repair -> verify -> release
# ---------------------------------------------------------------------------

def _requests_for(store, users, rows=4, seed=0):
    rng = np.random.default_rng(seed)
    d = store.shared.n_features
    n_bins = int(store.shared.n_bins_per_feature[0])
    return [
        (u, rng.integers(0, n_bins, (rows, d)).astype(np.int32))
        for u in users
    ]


class TestServeAutoRepair:
    def test_corrupt_user_repaired_and_served_exact(self, durable,
                                                    store0):
        victim = store0.user_ids[0]
        entry = durable.shard_for_user(victim)
        path, off, length = durable.shard_location(entry.shard_id)
        DiskFaults().corrupt_region(path, off, min(length, 32))

        server = ForestServer(durable.load_store(lazy=True, device=CPU),
                              device=CPU)
        attach_auto_repair(server, durable)
        requests = _requests_for(store0, store0.user_ids, seed=5)
        statuses = server.serve_safe(requests, engine="simple")
        assert [s.status for s in statuses] == ["ok"] * len(requests)
        health = server.stats()["health"]
        assert health["repairs"] == 1
        assert health["repair_attempts"] >= 1
        assert health["n_quarantined"] == 0
        clean = ForestServer(store0, device=CPU)
        for s, (u, x) in zip(statuses, requests):
            np.testing.assert_array_equal(
                s.prediction, clean.serve([(u, x)], engine="simple")[0]
            )

    def test_unrepairable_user_stays_quarantined(self, durable, store0):
        u1, u2 = store0.user_ids[0], store0.user_ids[1]
        for u in (u1, u2):
            entry = durable.shard_for_user(u)
            path, off, length = durable.shard_location(entry.shard_id)
            DiskFaults().corrupt_region(path, off, min(length, 32))

        server = ForestServer(durable.load_store(lazy=True, device=CPU),
                              device=CPU)
        attach_auto_repair(server, durable)
        requests = _requests_for(store0, store0.user_ids, seed=6)
        statuses = {s.user_id: s.status
                    for s in server.serve_safe(requests, engine="simple")}
        assert statuses[u1] == "quarantined"
        assert statuses[u2] == "quarantined"
        assert all(v == "ok" for k, v in statuses.items()
                   if k not in (u1, u2))
        health = server.stats()["health"]
        assert health["repairs"] == 0
        assert "UnrepairableError" in health["last_repair_error"]
        attempts = server.repair_attempts
        server.serve_safe(requests, engine="simple")
        assert server.repair_attempts == attempts

    def test_repairer_ignores_unknown_users(self, durable, store0):
        server = ForestServer(durable.load_store(lazy=True, device=CPU),
                              device=CPU)
        repair = attach_auto_repair(server, durable)
        assert repair("no_such_user") is False


class TestDriverScrub:
    def _driver(self, durable, **kw):
        from repro_torch.sched.driver import LifecycleDriver

        server = ForestServer(durable.load_store(lazy=True, device=CPU),
                              device=CPU)
        scrubber = Scrubber(durable, shards_per_tick=4)
        driver = LifecycleDriver(
            server, clock=None, scrubber=scrubber,
            scrub_interval_s=2.0, low_load_rows=64, **kw
        )
        return driver, scrubber

    def test_scrub_ticks_in_low_load_gaps_only(self, durable):
        driver, _ = self._driver(durable)
        driver.tick(0.0, pending_rows=1000)   # loaded: no scrub
        assert driver.n_scrub_ticks == 0
        driver.tick(0.1, pending_rows=0)      # idle: scrub
        assert driver.n_scrub_ticks == 1
        driver.tick(0.5, pending_rows=0)      # inside the interval: no
        assert driver.n_scrub_ticks == 1
        driver.tick(2.5, pending_rows=0)      # interval elapsed: scrub
        assert driver.n_scrub_ticks == 2
        assert driver.stats()["scrub"]["bytes_scanned"] > 0

    def test_driver_scrub_repairs_corruption(self, durable, store0, bytes0):
        entry = durable.shard_for_user(store0.user_ids[4])
        path, off, length = durable.shard_location(entry.shard_id)
        DiskFaults().corrupt_region(path, off, min(length, 16))
        driver, scrubber = self._driver(durable)
        t = 0.0
        while scrubber.repairs == 0 and t < 100.0:
            driver.tick(t, pending_rows=0)
            t += 2.5
        assert scrubber.repairs == 1
        assert driver.n_scrub_failures == 0
        _assert_fleet_bit_exact(durable, bytes0)

    def test_scrubber_fault_counted_not_raised(self, durable, monkeypatch):
        driver, scrubber = self._driver(durable)
        monkeypatch.setattr(
            scrubber, "tick",
            lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")),
        )
        driver.tick(0.0, pending_rows=0)
        assert driver.n_scrub_failures == 1
        assert "boom" in driver.last_error


# ---------------------------------------------------------------------------
# durable <-> lifecycle interop
# ---------------------------------------------------------------------------

class TestLifecycleInterop:
    def test_sync_after_mutation_then_reload(self, durable, store0,
                                             bytes0):
        loaded = durable.load_store(lazy=True, device=CPU)
        u = store0.user_ids[0]
        other = store0.delta(store0.user_ids[1])
        loaded.add_delta(u, other)
        report = durable.sync(loaded)
        assert report["deltas"] == 1
        assert report["removed"] == 0
        want = dict(bytes0)
        want[u] = bytes0[store0.user_ids[1]]
        _assert_fleet_bit_exact(DurableStore.open(durable.path), want)

    def test_kind_constants_stable(self):
        assert KIND_CODEBOOK == 0
        assert KIND_DELTA == 1
