"""The port's codebook lifecycle (``repro_torch.store.lifecycle``) against
the JAX reference on the CPU.

* Recluster in extend and full modes on the same drifted fleet gives the
  same codebook bytes, the same RFM1 remap table, the same relabeled /
  re-encoded counts and per-user delta bytes, and the same RFT1 bytes
  afterwards as the reference.
* RFM1 (the remap table) and RFJ1 (the migration journal) written by
  either package are read by the other, and are equal byte for byte.
* Crash at every journal step, then resume: bit-exact on the port; and a
  journal (with its store) that one package left mid-run is resumed by
  the other to the uncrashed run's bytes.
* The port's own copies of ``tests/test_lifecycle.py`` and
  ``tests/test_chaos.py::TestJournaledRecluster``, unweakened, on
  ``device="cpu"``.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from repro.runtime.chaos import CrashSchedule as RefCrashSchedule
from repro.runtime.chaos import InjectedCrash as RefInjectedCrash
from repro.store import DurableStore as RefDurable
from repro.store import ForestStore as RefStore
from repro.store import MigrationJournal as RefJournal
from repro.store import RemapTable as RefRemapTable
from repro.store import build_store as ref_build_store
from repro.store import encode_user_delta as ref_encode_user_delta
from repro.store import make_drifted_fleet as ref_drifted_fleet
from repro.store import recluster as ref_recluster
from repro.store import resume_recluster as ref_resume_recluster
from repro_torch.convert import forest_from_arrays
from repro_torch.core.tree import Forest, ForestMeta, Tree
from repro_torch.runtime.chaos import CrashSchedule, InjectedCrash
from repro_torch.serving import ForestServer
from repro_torch.store import (
    DurableStore,
    ForestStore,
    MigrationJournal,
    RemapTable,
    build_store,
    drift_report,
    encode_user_delta,
    extend_codebook_from_forests,
    make_drifted_fleet,
    make_synthetic_fleet,
    recluster,
    resume_recluster,
)
from repro_torch.store.lifecycle import (
    build_remap,
    migrate_user,
    migrate_users,
    user_fallback_report,
)

CPU = "cpu"
TASKS = ["classification", "regression"]
MODES = ["extend", "full"]


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def drifted_store(task="classification", n_users=10, late_fraction=0.3,
                  seed=0):
    """The port's copy of ``tests/test_lifecycle.py::drifted_store``: a
    store frozen on the initial population with the late users onboarded
    afterwards.  Returns (store, full fleet dict, late user ids)."""
    initial, late = make_drifted_fleet(
        n_users, late_fraction=late_fraction, task=task,
        n_trees=(4, 8), max_depth=4, seed=seed,
    )
    store = build_store(initial, device=CPU)
    for u, f in late.items():
        store.add_user(u, f)
    return store, {**initial, **late}, sorted(late)


def ref_drifted_store(task="classification", n_users=10, late_fraction=0.3,
                      seed=0):
    initial, late = ref_drifted_fleet(
        n_users, late_fraction=late_fraction, task=task,
        n_trees=(4, 8), max_depth=4, seed=seed,
    )
    store = ref_build_store(initial)
    for u, f in late.items():
        store.add_user(u, f)
    return store


def one_tree_on_feature(v: int, d: int = 8, n_bins: int = 16) -> Forest:
    """A forest whose single tree splits ONLY on feature ``v``."""
    tree = Tree(
        feature=np.array([v, -1, -1]),
        threshold=np.array([3, -1, -1]),
        children_left=np.array([1, -1, -1]),
        children_right=np.array([2, -1, -1]),
        node_fit=np.array([0, 1, 0], dtype=np.int64),
    )
    meta = ForestMeta(
        n_features=d, task="classification", n_classes=2,
        n_bins_per_feature=np.full(d, n_bins, np.int32),
        n_train_obs=1000, categorical=np.zeros(d, dtype=bool),
    )
    return Forest(trees=[tree], meta=meta)


# ---------------------------------------------------------------------------
# differential: recluster, RFM1, RFJ1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("task", TASKS)
def test_recluster_equals_reference(task, mode, tmp_path):
    port = drifted_store(task=task, n_users=12)[0]
    ref = ref_drifted_store(task=task, n_users=12)
    assert port.to_bytes() == ref.to_bytes()
    pj = MigrationJournal(path=str(tmp_path / "port.rfj"))
    rj = RefJournal(path=str(tmp_path / "ref.rfj"))
    got = recluster(port, mode=mode, journal=pj)
    want = ref_recluster(ref, mode=mode, journal=rj)
    assert port.shared.to_bytes() == ref.shared.to_bytes()
    assert got.remap.to_bytes() == want.remap.to_bytes()
    for key in ("mode", "old_generation", "new_generation", "n_users",
                "n_relabeled", "n_reencoded", "n_pending", "bytes_before",
                "bytes_after", "verified_bit_exact"):
        assert getattr(got, key) == getattr(want, key), key
    assert got.per_user == want.per_user
    for u in ref.user_ids:
        assert port.delta(u).to_bytes() == ref.delta(u).to_bytes(), u
    assert port.to_bytes() == ref.to_bytes()
    with open(pj.path, "rb") as a, open(rj.path, "rb") as b:
        assert a.read() == b.read()
    assert drift_report(port)["fallback_user_fraction"] == 0.0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("task", TASKS)
def test_remap_frames_cross_decode(task, mode):
    port = drifted_store(task=task)[0]
    ref = ref_drifted_store(task=task)
    ours = recluster(port, mode=mode, migrate=False).remap.to_bytes()
    theirs = ref_recluster(ref, mode=mode, migrate=False).remap.to_bytes()
    assert ours == theirs
    assert RefRemapTable.from_bytes(ours).to_bytes() == ours
    assert RemapTable.from_bytes(theirs).to_bytes() == theirs
    back = RemapTable.from_bytes(theirs)
    assert back.is_identity == (mode == "extend")


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_journal_frames_cross_decode(writer):
    """A hand-driven journal at every state, both directions."""
    make = RefJournal if writer == "reference" else MigrationJournal
    read = MigrationJournal if writer == "reference" else RefJournal
    j = make()
    frames = [j.to_bytes()]
    j.log_built("extend", _FakeCodebook(b"CBYTES"),
                _FakeRemap(1, 2, b"RBYTES"))
    frames.append(j.to_bytes())
    j.log_installed()
    j.log_migrate_intent("alice", b"old-delta")
    j.log_migrate_commit("alice", "relabeled")
    j.log_migrate_intent("bob", b"old-delta-2")
    frames.append(j.to_bytes())
    j.log_committed()
    frames.append(j.to_bytes())
    for frame in frames:
        got = read.from_bytes(frame)
        assert got.to_bytes() == frame
        assert got.summary() == make.from_bytes(frame).summary()
    again = make()
    again.log_built("extend", _FakeCodebook(b"CBYTES"),
                    _FakeRemap(1, 2, b"RBYTES"))
    assert again.to_bytes() == read.from_bytes(frames[1]).to_bytes()


def test_codebook_extension_from_forests_equals_reference():
    port = drifted_store(task="regression")[0]
    ref = ref_drifted_store(task="regression")
    late = [u for u in ref.user_ids
            if user_fallback_report(port, u)["uses_fallback"]]
    assert late
    new, remap = extend_codebook_from_forests(
        port.shared, [port.reconstruct(u) for u in late], device=CPU)
    from repro.store.lifecycle import (
        extend_codebook_from_forests as ref_extend,
    )

    rnew, rremap = ref_extend(ref.shared, [ref.reconstruct(u) for u in late])
    assert new.to_bytes() == rnew.to_bytes()
    assert remap.to_bytes() == rremap.to_bytes()


def test_dense_engine_runs_on_the_stores_device():
    """``device`` defaults to the store's: a CPU store's dense recluster
    runs on the CPU, while the store-less entry asks for the card."""
    store, fleet, _ = drifted_store()
    res = recluster(store, mode="extend", engine="dense")
    assert res.verified_bit_exact
    assert all(store.reconstruct(u).equals(fleet[u]) for u in store.user_ids)
    if not torch.cuda.is_available():
        store2, fleet2, late2 = drifted_store()
        with pytest.raises(RuntimeError, match="CUDA"):
            extend_codebook_from_forests(
                store2.shared, [fleet2[u] for u in late2], engine="dense")


# ---------------------------------------------------------------------------
# crash-safe recluster journal: a journal one package left, the other
# resumes
# ---------------------------------------------------------------------------

def _drifted_pair_bytes():
    kw = dict(n_users=5, d=5, n_bins=12, max_depth=4, seed=3)
    initial, late = ref_drifted_fleet(**kw)
    ref = ref_build_store(initial)
    for u, f in late.items():
        ref.add_delta(u, ref_encode_user_delta(f, ref.shared))
    initial, late = make_drifted_fleet(**kw)
    port = build_store(initial, device=CPU)
    for u, f in late.items():
        port.add_delta(u, encode_user_delta(f, port.shared))
    return port.to_bytes(), ref.to_bytes()


@pytest.fixture(scope="module")
def drifted_store_bytes():
    """The drifted fleet of ``tests/test_chaos.py``, serialized once."""
    port_bytes, ref_bytes = _drifted_pair_bytes()
    assert port_bytes == ref_bytes
    return port_bytes


@pytest.fixture(scope="module")
def uncrashed(drifted_store_bytes):
    """The RFT1 bytes and step list of one uncrashed extend run."""
    store = RefStore.from_bytes(drifted_store_bytes)
    sched = RefCrashSchedule()
    ref_recluster(store, mode="extend", journal=RefJournal(), on_step=sched)
    return store.to_bytes(), list(sched.steps)


@pytest.fixture(scope="module")
def baseline(drifted_store_bytes):
    store = ForestStore.from_bytes(drifted_store_bytes, device=CPU)
    return {u: store.reconstruct(u) for u in store.user_ids}


def test_uncrashed_runs_equal(drifted_store_bytes, uncrashed):
    store = ForestStore.from_bytes(drifted_store_bytes, device=CPU)
    sched = CrashSchedule()
    recluster(store, mode="extend", journal=MigrationJournal(), on_step=sched)
    assert store.to_bytes() == uncrashed[0]
    assert list(sched.steps) == uncrashed[1]


N_STEPS = 14  # steps of one extend run over the 5-user fleet


@pytest.mark.parametrize("step", range(N_STEPS))
@pytest.mark.parametrize("crashed_by", ["reference", "port"])
def test_journal_left_by_one_package_resumes_in_the_other(
        drifted_store_bytes, uncrashed, crashed_by, step, tmp_path):
    """A run crashed at ``step`` by one package leaves what a restarted
    process finds on disk: its store synced to a durable directory (which
    keeps every resident codebook generation, the superseded one too) and
    its RFJ1 journal file.  The other package opens both and resumes to
    the uncrashed run's bytes."""
    want, steps = uncrashed
    assert len(steps) == N_STEPS
    fleet, jpath = str(tmp_path / "fleet"), str(tmp_path / "fleet.rfj")
    if crashed_by == "reference":
        store = RefStore.from_bytes(drifted_store_bytes)
        with pytest.raises(RefInjectedCrash):
            ref_recluster(store, mode="extend", journal=RefJournal(path=jpath),
                          on_step=RefCrashSchedule(fail_at=(step,)))
        RefDurable.create(fleet, store)
        left = DurableStore.open(fleet).load_store(lazy=False, device=CPU)
        journal_cls, again, resume = (MigrationJournal, recluster,
                                      resume_recluster)
    else:
        store = ForestStore.from_bytes(drifted_store_bytes, device=CPU)
        with pytest.raises(InjectedCrash):
            recluster(store, mode="extend", journal=MigrationJournal(path=jpath),
                      on_step=CrashSchedule(fail_at=(step,)))
        DurableStore.create(fleet, store)
        left = RefDurable.open(fleet).load_store(lazy=False)
        journal_cls, again, resume = RefJournal, ref_recluster, \
            ref_resume_recluster
    assert left.generations == store.generations
    revived = (journal_cls.load(jpath) if os.path.exists(jpath)
               else journal_cls(path=jpath))
    if revived.state == "idle":
        r = again(left, mode="extend", journal=revived)
    else:
        r = resume(left, revived)
    assert revived.state == "committed", steps[step]
    assert r.n_pending == 0
    assert left.to_bytes() == want, steps[step]


# ---------------------------------------------------------------------------
# the port's copy of tests/test_chaos.py::TestJournaledRecluster
# ---------------------------------------------------------------------------

class _FakeCodebook:
    def __init__(self, b):
        self._b = b

    def to_bytes(self):
        return self._b


class _FakeRemap:
    def __init__(self, old, new, b):
        self.old_generation = old
        self.new_generation = new
        self._b = b

    def to_bytes(self):
        return self._b


class TestJournaledRecluster:
    def test_journal_roundtrip(self):
        j = MigrationJournal()
        j.log_built(
            "extend",
            _FakeCodebook(b"CBYTES"),
            _FakeRemap(1, 2, b"RBYTES"),
        )
        j.log_installed()
        j.log_migrate_intent("alice", b"old-delta")
        j.log_migrate_commit("alice", "relabeled")
        j.log_migrate_intent("bob", b"old-delta-2")
        jj = MigrationJournal.from_bytes(j.to_bytes())
        assert jj.state == "installed"
        assert jj.mode == "extend"
        assert (jj.old_generation, jj.new_generation) == (1, 2)
        assert jj.codebook_bytes == b"CBYTES"
        assert jj.entries["alice"]["committed"]
        assert jj.entries["alice"]["status"] == "relabeled"
        assert jj.uncommitted_users == ["bob"]
        assert jj.entries["bob"]["intent"] == b"old-delta-2"

    def test_journal_persists_to_path(self, tmp_path):
        path = str(tmp_path / "migration.journal")
        j = MigrationJournal(path=path)
        j.log_built(
            "extend", _FakeCodebook(b"CB"), _FakeRemap(1, 2, b"RM")
        )
        loaded = MigrationJournal.load(path)
        assert loaded.state == "built"
        assert loaded.path == path

    def test_crash_at_every_step_then_resume_is_bit_exact(
        self, drifted_store_bytes, baseline
    ):
        sched = CrashSchedule()
        clean = ForestStore.from_bytes(drifted_store_bytes, device=CPU)
        result = recluster(
            clean, mode="extend", journal=MigrationJournal(), on_step=sched
        )
        steps = list(sched.steps)
        assert steps[0] == "build" and steps[-2:] == ["commit", "gc"]
        assert any(s.startswith("migrate:") for s in steps)

        for i, name in enumerate(steps):
            store = ForestStore.from_bytes(drifted_store_bytes, device=CPU)
            journal = MigrationJournal()
            with pytest.raises(InjectedCrash):
                recluster(
                    store, mode="extend", journal=journal,
                    on_step=CrashSchedule(fail_at=(i,)),
                )
            revived = MigrationJournal.from_bytes(journal.to_bytes())
            if revived.state == "idle":
                r = recluster(store, mode="extend", journal=revived)
            else:
                r = resume_recluster(store, revived)
            assert revived.state == "committed", (i, name)
            assert store.generations == [result.new_generation], (i, name)
            for u, want in baseline.items():
                assert store.reconstruct(u).equals(want), (i, name, u)
            assert r.n_pending == 0, (i, name)

    def test_resume_is_idempotent_after_commit(self, drifted_store_bytes):
        store = ForestStore.from_bytes(drifted_store_bytes, device=CPU)
        journal = MigrationJournal()
        recluster(store, mode="extend", journal=journal)
        before = store.to_bytes()
        r = resume_recluster(store, journal)
        assert store.to_bytes() == before
        assert r.n_pending == 0

    def test_resume_idle_journal_raises(self, drifted_store_bytes):
        store = ForestStore.from_bytes(drifted_store_bytes, device=CPU)
        with pytest.raises(ValueError, match="re-run recluster"):
            resume_recluster(store, MigrationJournal())

    def test_gc_deferred_until_commit(self, drifted_store_bytes):
        store = ForestStore.from_bytes(drifted_store_bytes, device=CPU)
        journal = MigrationJournal()
        with pytest.raises(InjectedCrash):
            recluster(
                store, mode="extend", journal=journal,
                on_step=CrashSchedule(
                    fail_at=("migrated:" + store.user_ids[0],)),
            )
        assert len(store.generations) == 2
        resume_recluster(store, journal)
        assert len(store.generations) == 1

    def test_serving_parity_after_crash_recovery(
        self, drifted_store_bytes, baseline, rng
    ):
        store = ForestStore.from_bytes(drifted_store_bytes, device=CPU)
        journal = MigrationJournal()
        users = store.user_ids
        with pytest.raises(InjectedCrash):
            recluster(
                store, mode="extend", journal=journal,
                on_step=CrashSchedule(fail_at=("migrate:" + users[2],)),
            )
        resume_recluster(store, journal)
        server = ForestServer(store, device=CPU)
        reqs = [
            (u, rng.integers(0, 12, (9, 5)).astype(np.int32))
            for u in users
        ]
        for (u, x), p in zip(reqs, server.serve(reqs)):
            assert np.array_equal(p, store.predict(u, x))


# ---------------------------------------------------------------------------
# the port's copy of tests/test_lifecycle.py
# ---------------------------------------------------------------------------

class TestGenerationFraming:
    def test_codebook_and_delta_carry_generation(self):
        from repro_torch.store import SharedCodebook, UserDelta

        fleet = make_synthetic_fleet(3, n_trees=(3, 5), max_depth=3)
        store = build_store(fleet, device=CPU)
        assert store.generation == 1
        cb = SharedCodebook.from_bytes(store.shared.to_bytes())
        assert cb.generation == 1
        delta = store.delta(store.user_ids[0])
        assert delta.codebook_generation == 1
        rt = UserDelta.from_bytes(delta.to_bytes())
        assert rt.codebook_generation == 1

    def test_hydrate_rejects_generation_mismatch(self):
        from repro_torch.store.delta import hydrate

        fleet = make_synthetic_fleet(2, n_trees=(3, 5), max_depth=3)
        store = build_store(fleet, device=CPU)
        wrong = dataclasses.replace(store.shared, generation=7)
        with pytest.raises(ValueError, match="generation"):
            hydrate(store.delta(store.user_ids[0]), wrong)

    def test_rft1_roundtrips_retained_codebooks(self):
        store, fleet, late = drifted_store()
        res = recluster(store, migrate=False)
        migrate_users(store, late, res.remap)
        assert store.generations == [1, 2]
        clone = ForestStore.from_bytes(store.to_bytes(), device=CPU)
        assert clone.generations == [1, 2]
        assert all(
            clone.reconstruct(u).equals(fleet[u]) for u in clone.user_ids
        )
        migrate_users(
            clone, [u for u in clone.user_ids if u not in late], res.remap
        )
        assert clone.generations == [2]


class TestDriftMonitor:
    def test_clean_fleet_reports_no_drift(self):
        store = build_store(make_synthetic_fleet(4, n_trees=(3, 5),
                                                 max_depth=3), device=CPU)
        rep = drift_report(store)
        assert rep["fallback_user_fraction"] == 0.0
        assert rep["fallback_bytes"] == 0
        assert not rep["recommend_recluster"]

    @pytest.mark.parametrize("task", TASKS)
    def test_drifted_fleet_trips_the_monitor(self, task):
        store, _, late = drifted_store(task=task)
        rep = drift_report(store)
        assert rep["n_fallback_users"] == len(late)
        assert rep["fallback_user_fraction"] == pytest.approx(
            len(late) / rep["n_users"]
        )
        assert rep["fallback_bytes"] > 0
        assert 0 < rep["fallback_overhead_fraction"] < 1
        assert rep["recommend_recluster"]
        for u in late:
            assert rep["per_user"][u]["uses_fallback"]

    def test_server_stats_surface_drift(self, rng):
        store, _, _ = drifted_store()
        server = ForestServer(store, device=CPU)
        drift = server.stats()["store"]
        assert drift["codebook_generation"] == 1
        assert drift["fallback_user_fraction"] > 0
        from conftest import random_forest

        f = random_forest(seed=1, n_trees=3)
        single = ForestServer.from_forest(
            forest_from_arrays(f.trees, f.meta, f.fit_values), device=CPU)
        assert single.stats()["store"] is None


class TestRemapTable:
    def test_extend_remap_is_identity_and_roundtrips(self):
        store, _, _ = drifted_store()
        res = recluster(store, migrate=False)
        remap = res.remap
        assert remap.is_identity
        assert remap.old_generation == 1 and remap.new_generation == 2
        rt = RemapTable.from_bytes(remap.to_bytes())
        assert rt.old_generation == 1 and rt.new_generation == 2
        assert rt.fit_table_prefix == remap.fit_table_prefix
        assert np.array_equal(rt.vars_map, remap.vars_map)
        assert np.array_equal(rt.fits_map, remap.fits_map)
        assert set(rt.splits_map) == set(remap.splits_map)
        for v in remap.splits_map:
            assert np.array_equal(rt.splits_map[v], remap.splits_map[v])

    def test_build_remap_matches_identical_twins_only(self):
        store, _, _ = drifted_store()
        remap = build_remap(store.shared, store.shared)
        assert remap.is_identity
        assert remap.fit_table_prefix


class TestRecluster:
    @pytest.mark.parametrize("task", TASKS)
    def test_extend_is_bit_exact_and_shrinks_bytes(self, task):
        store, fleet, late = drifted_store(task=task, n_users=12)
        res = recluster(store, mode="extend")
        assert res.new_generation == 2 and store.generation == 2
        assert res.verified_bit_exact
        assert all(
            store.reconstruct(u).equals(fleet[u]) for u in store.user_ids
        )
        assert res.n_reencoded == len(late)
        assert res.n_relabeled == len(store.user_ids) - len(late)
        assert res.bytes_after <= res.bytes_before
        rep = drift_report(store)
        assert rep["fallback_user_fraction"] == 0.0
        assert store.generations == [2]

    @pytest.mark.parametrize("task", TASKS)
    def test_full_rebuild_is_bit_exact(self, task):
        store, fleet, _ = drifted_store(task=task)
        res = recluster(store, mode="full")
        assert store.generation == 2
        assert all(
            store.reconstruct(u).equals(fleet[u]) for u in store.user_ids
        )
        rep = drift_report(store)
        assert rep["fallback_user_fraction"] == 0.0
        assert set(r["status"] for r in res.per_user.values()) <= {
            "relabeled", "reencoded"
        }

    def test_unknown_mode_rejected(self):
        store = build_store(make_synthetic_fleet(2, n_trees=(3, 4),
                                                 max_depth=3), device=CPU)
        with pytest.raises(ValueError, match="mode"):
            recluster(store, mode="nope")

    def test_empty_store(self):
        fleet = make_synthetic_fleet(1, n_trees=(3, 4), max_depth=3)
        store = build_store(fleet, device=CPU)
        empty = ForestStore(store.shared, device=CPU)
        for mode in MODES:
            res = recluster(empty, mode=mode)
            assert res.n_users == 0
            assert res.n_relabeled == res.n_reencoded == 0
        assert empty.generation == 3

    def test_singleton_fleet(self):
        fleet = make_synthetic_fleet(1, n_trees=(3, 4), max_depth=3)
        store = build_store(fleet, device=CPU)
        for mode in MODES:
            res = recluster(store, mode=mode)
            assert res.n_users == 1
        (u,) = store.user_ids
        assert store.reconstruct(u).equals(fleet[u])
        assert store.generations == [3]

    def test_late_user_with_only_local_clusters(self):
        initial, _ = make_drifted_fleet(
            6, late_fraction=0.0, n_trees=(4, 8), max_depth=4,
        )
        store = build_store(initial, device=CPU)
        d = store.shared.n_features
        loner = one_tree_on_feature(d - 1, d=d)
        store.add_user("loner", loner)
        rep = user_fallback_report(store, "loner")
        assert rep["uses_fallback"] and rep["n_local_clusters"] > 0
        res = recluster(store, mode="extend")
        assert res.per_user["loner"]["status"] == "reencoded"
        assert store.reconstruct("loner").equals(loner)
        assert not user_fallback_report(store, "loner")["uses_fallback"]


class TestMigration:
    def test_incremental_migration_keeps_old_generation_alive(self):
        store, fleet, late = drifted_store()
        res = recluster(store, migrate=False)
        assert res.n_pending == len(store.user_ids)
        assert store.generations == [1, 2]
        extra = make_synthetic_fleet(1, n_trees=(3, 4), max_depth=3,
                                     seed=99)
        (uid, forest), = extra.items()
        store.add_user("fresh-" + uid, forest)
        assert store.delta("fresh-" + uid).codebook_generation == 2
        migrate_users(store, late, res.remap)
        assert store.generations == [1, 2]
        rest = [
            u for u in store.user_ids
            if store.delta(u).codebook_generation == 1
        ]
        migrate_users(store, rest, res.remap)
        assert store.generations == [2]
        assert all(
            store.reconstruct(u).equals(fleet[u]) for u in fleet
        )

    def test_migrate_user_already_current(self):
        store, _, _ = drifted_store()
        res = recluster(store)
        rec = migrate_user(store, store.user_ids[0], res.remap)
        assert rec["status"] == "current"

    def test_relabel_preserves_bytes_and_decoded_artifact(self):
        store, fleet, late = drifted_store()
        clean = [u for u in store.user_ids if u not in late]
        before = {u: len(store.delta(u).to_bytes()) for u in clean}
        ver_before = {u: store.user_version(u) for u in clean}
        store.tiles(clean[0], 8)
        tiles_before = len(store.cache)
        res = recluster(store, mode="extend")
        for u in clean:
            assert res.per_user[u]["status"] == "relabeled"
            assert len(store.delta(u).to_bytes()) == before[u]
            assert store.user_version(u) == ver_before[u]
        assert len(store.cache) == tiles_before

    def test_serving_mid_migration_mixes_generations(self, rng):
        store, fleet, late = drifted_store(n_users=8)
        server = ForestServer(store, device=CPU)
        res = recluster(store, migrate=False)
        migrate_users(store, late, res.remap)
        users = store.user_ids
        x = rng.integers(0, 12, (9, 8)).astype(np.int32)
        gens = {store.delta(u).codebook_generation for u in users}
        assert gens == {1, 2}
        mixed = [(u, x) for u in users[:2] + late[:2]]
        preds = server.serve(mixed)
        for (u, xx), p in zip(mixed, preds):
            assert np.array_equal(p, store.predict(u, xx))


class TestServingAcrossMigration:
    def test_warm_session_invalidates_only_migrated_users(self, rng):
        store, fleet, late = drifted_store(n_users=10)
        server = ForestServer(store, device=CPU)
        clean = [u for u in store.user_ids if u not in late]
        x = rng.integers(0, 12, (9, 8)).astype(np.int32)
        reqs_clean = [(clean[0], x), (clean[1], x)]
        reqs_late = [(late[0], x), (late[1], x)]
        for _ in range(2):
            server.serve(reqs_clean)
            server.serve(reqs_late)
        hits0 = server.plan_cache.pack_hits
        misses0 = server.plan_cache.pack_misses

        res = recluster(store, mode="extend")
        assert res.n_reencoded == len(late)

        preds_clean = server.serve(reqs_clean)
        preds_late = server.serve(reqs_late)
        assert server.plan_cache.pack_hits == hits0 + 1
        assert server.plan_cache.pack_misses == misses0 + 1
        for reqs, preds in ((reqs_clean, preds_clean),
                            (reqs_late, preds_late)):
            for (u, xx), p in zip(reqs, preds):
                np.testing.assert_array_equal(p, store.predict(u, xx))
