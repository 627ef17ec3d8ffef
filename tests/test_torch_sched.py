"""The port's online serving (``repro_torch.sched``) against the JAX
reference on the CPU.

* The port's copy of each of ``tests/test_sched.py``'s checks,
  unweakened, on ``device="cpu"``, through the port's ``ForestServer``,
  store, ``runtime.chaos`` and ``store.lifecycle`` (same class names).
* Differential runs: both packages' servers built from one RFT1 blob
  replay one seeded trace under ``VirtualClock`` (inline).  The
  micro-batches (seq, users, trigger), every ticket (status, detail,
  degraded, prediction) and ``Scheduler.stats()`` are equal; with a
  ``LifecycleDriver`` so are its decisions tick by tick, the RFJ1
  journal bytes and the final RFT1 bytes; with ``BatchFaults`` and one
  poisoned user the same tickets fail and are quarantined; over a
  durable store under a residency budget with a ``Prefetcher``, the
  prefetch hits, the cold loads (those ``plan`` makes among them,
  ROADMAP R7) and every ``stats()`` are equal.
* Real threads on the port: ``WallClock``, overlap on, a background
  ``Prefetcher`` over a durable store, answers equal to the inline run;
  the device is resolved at construction and never on the serve path;
  every device-tier call (arena uploads, gathers, run tokens,
  invalidations) is made on ``sched-executor``; after ``close()`` no
  worker thread is left.
* DET004 for the port: no module of ``repro_torch.sched`` but
  ``clock.py`` uses ``time`` or ``datetime``.
"""
import ast
import os
import sys
import threading
import types

import numpy as np
import pytest

import repro.sched as ref_sched
from repro.runtime.chaos import BatchFaults as RefBatchFaults
from repro.runtime.chaos import poison_user as ref_poison_user
from repro.serving.server import ForestServer as RefServer
from repro.store import DurableStore as RefDurable
from repro.store import Prefetcher as RefPrefetcher
from repro.store import attach_residency as ref_attach_residency
from repro.store.runtime import ForestStore as RefForestStore
from repro_torch import sched as port_sched
from repro_torch.core.compressed_predict import predict_compressed
from repro_torch.runtime.chaos import BatchFaults, poison_user
from repro_torch.sched import (
    AdmissionError,
    LifecycleDriver,
    MicroBatcher,
    RequestQueue,
    Scheduler,
    VirtualClock,
    WallClock,
)
from repro_torch.serving.server import ForestServer
from repro_torch.store import (
    DurableStore,
    Prefetcher,
    attach_residency,
    make_synthetic_fleet,
)
from repro_torch.store.fleet import make_drifted_fleet
from repro_torch.store.lifecycle import drift_report
from repro_torch.store.runtime import ForestStore, build_store

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHED = os.path.join(ROOT, "src", "repro_torch", "sched")
RTOL = ATOL = 1e-5  # tests/test_serving.py:36


def fleet_server(n_users=6, task="classification", seed=0):
    forests = make_synthetic_fleet(
        n_users, task, n_trees=(4, 8), max_depth=4, seed=seed
    )
    store = build_store(forests, device=CPU)
    return ForestServer(store, device=CPU), store, sorted(forests)


def drifted_store(n_users=10, late_fraction=0.3, seed=0):
    initial, late = make_drifted_fleet(
        n_users, late_fraction=late_fraction, task="classification",
        n_trees=(4, 8), max_depth=4, seed=seed,
    )
    store = build_store(initial, device=CPU)
    for u, f in late.items():
        store.add_user(u, f)
    return store, initial, sorted({**initial, **late})


def drifted_server(n_users=10, late_fraction=0.3, seed=0):
    store, _, users = drifted_store(n_users, late_fraction, seed)
    return ForestServer(store, device=CPU), store, users


def make_rows(rng, store, n):
    return rng.integers(
        0, 64, size=(n, store.shared.n_features), dtype=np.int32
    )


def oracle(store, u, rows):
    return predict_compressed(store.hydrate(u), rows, device=CPU)


# ---------------------------------------------------------------------------
# the port's copy of tests/test_sched.py
# ---------------------------------------------------------------------------

class TestClocks:
    def test_virtual_clock_advances(self):
        c = VirtualClock(start=10.0)
        assert c.now() == 10.0
        c.advance(2.5)
        c.sleep(0.5)
        assert c.now() == 13.0

    def test_virtual_clock_rejects_negative(self):
        with pytest.raises(ValueError):
            VirtualClock().advance(-1.0)

    def test_wall_clock_monotonic(self):
        c = WallClock()
        assert c.now() <= c.now()


class TestRequestQueue:
    def test_fifo_and_deadlines(self):
        q = RequestQueue(slo_s=0.25)
        r1 = q.submit("a", np.zeros((4, 3), np.int32), now=1.0)
        r2 = q.submit("a", np.zeros((2, 3), np.int32), now=2.0)
        r3 = q.submit("b", np.zeros((8, 3), np.int32), now=1.5)
        assert (r1.deadline, r2.deadline, r3.deadline) == (1.25, 2.25, 1.75)
        assert q.n_pending == 3 and q.pending_rows == 14
        assert q.head_deadlines() == {"a": 1.25, "b": 1.75}
        assert q.oldest_head_deadline() == 1.25
        assert q.pop("a") is r1
        assert q.oldest_head_deadline() == 1.75

    def test_admission_bounds(self):
        q = RequestQueue(
            max_pending_requests=2, max_pending_rows=100,
            max_pending_per_tenant=1,
        )
        q.submit("a", np.zeros((4, 3), np.int32), now=0.0)
        with pytest.raises(AdmissionError):  # per-tenant bound
            q.submit("a", np.zeros((4, 3), np.int32), now=0.0)
        q.submit("b", np.zeros((4, 3), np.int32), now=0.0)
        with pytest.raises(AdmissionError):  # global request bound
            q.submit("c", np.zeros((4, 3), np.int32), now=0.0)
        q.pop("a")
        with pytest.raises(AdmissionError):  # global row bound
            q.submit("c", np.zeros((99, 3), np.int32), now=0.0)
        assert q.stats()["n_rejected"] == 3

    def test_rejects_non_2d_rows(self):
        with pytest.raises(ValueError):
            RequestQueue().submit("a", np.zeros(4, np.int32), now=0.0)


class TestMicroBatcher:
    def test_rows_trigger(self):
        q = RequestQueue(slo_s=10.0)
        b = MicroBatcher(max_rows=16)
        q.submit("a", np.zeros((8, 3), np.int32), now=0.0)
        assert b.due(q, 0.0) is None
        q.submit("b", np.zeros((8, 3), np.int32), now=0.0)
        assert b.due(q, 0.0) == "rows"
        batch = b.form(q, 0.0)
        assert batch.trigger == "rows" and batch.n_rows == 16
        assert q.n_pending == 0

    def test_deadline_trigger_fires_at_headroom(self):
        q = RequestQueue(slo_s=1.0)
        b = MicroBatcher(max_rows=1 << 20, plan_headroom_s=0.1)
        q.submit("a", np.zeros((4, 3), np.int32), now=0.0)  # deadline 1.0
        assert b.due(q, 0.85) is None
        assert b.due(q, 0.9) == "deadline"
        batch = b.form(q, 0.9)
        assert batch.trigger == "deadline" and batch.n_requests == 1

    def test_tenant_coherent_urgency_order_canonical_sort(self):
        q = RequestQueue(slo_s=1.0)
        b = MicroBatcher(max_rows=16)
        ra2 = q.submit("a", np.zeros((4, 3), np.int32), now=0.5)
        ra1 = q.submit("a", np.zeros((4, 3), np.int32), now=0.6)
        rb = q.submit("b", np.zeros((8, 3), np.int32), now=0.0)
        batch = b.form(q, 2.0)
        assert batch.requests == [ra2, ra1, rb]
        assert batch.users == ["a", "b"]

    def test_budget_leaves_tail_queued(self):
        q = RequestQueue(slo_s=1.0)
        b = MicroBatcher(max_rows=8)
        q.submit("a", np.zeros((8, 3), np.int32), now=0.0)
        q.submit("a", np.zeros((8, 3), np.int32), now=0.0)
        batch = b.form(q, 10.0)
        assert batch.n_requests == 1 and q.n_pending == 1

    def test_oversized_first_request_not_starved(self):
        q = RequestQueue(slo_s=1.0)
        b = MicroBatcher(max_rows=8)
        q.submit("a", np.zeros((32, 3), np.int32), now=0.0)
        batch = b.form(q, 10.0)
        assert batch.n_rows == 32

    def test_no_trigger_no_batch(self):
        q = RequestQueue(slo_s=10.0)
        b = MicroBatcher(max_rows=1 << 20)
        q.submit("a", np.zeros((4, 3), np.int32), now=0.0)
        assert b.form(q, 0.0) is None
        assert b.form(q, 0.0, flush=True) is not None


class TestSchedulerEndToEnd:
    def test_bit_exact_vs_predict_compressed_and_slo(self):
        server, store, users = fleet_server()
        clock = VirtualClock()
        sched = Scheduler(
            server, clock=clock, queue=RequestQueue(slo_s=0.5),
            batcher=MicroBatcher(max_rows=64),
        )
        rng = np.random.default_rng(1)
        tickets = []
        for i in range(40):
            u = users[int(rng.integers(len(users)))]
            rows = make_rows(rng, store, int(rng.integers(4, 24)))
            tickets.append((u, rows, sched.submit(u, rows)))
            clock.advance(0.02)
            sched.pump()
        sched.close()
        for u, rows, t in tickets:
            assert t.done and t.status == "ok"
            assert np.array_equal(t.prediction, oracle(store, u, rows))
        lat = sched.latency_stats()
        assert lat["n_completed"] == 40
        assert lat["deadline_misses"] == 0
        assert set(sched.batcher.stats()["trigger_counts"]) <= {
            "rows", "deadline", "flush"
        }

    def test_overlap_matches_inline(self):
        results = []
        for overlap in (False, True):
            server, store, users = fleet_server(seed=5)
            sched = Scheduler(
                server, clock=VirtualClock() if not overlap else WallClock(),
                batcher=MicroBatcher(max_rows=32), overlap=overlap,
            )
            rng = np.random.default_rng(7)  # re-seeded: same trace twice
            tickets = []
            for _ in range(12):
                u = users[int(rng.integers(len(users)))]
                tickets.append(sched.submit(u, make_rows(rng, store, 8)))
                sched.pump()
            sched.close()
            assert sched.executor.overlap is overlap
            results.append([t.prediction for t in tickets])
        for a, b in zip(*results):
            assert np.array_equal(a, b)

    def test_plan_cache_hits_on_recurring_trace(self):
        server, store, users = fleet_server()
        sched = Scheduler(
            server, clock=VirtualClock(), batcher=MicroBatcher(max_rows=64),
        )
        rng = np.random.default_rng(3)
        for _ in range(2):
            for u in users[:4]:
                sched.submit(u, make_rows(rng, store, 16))
            sched.flush()
        sched.close()
        assert server.plan_cache.stats()["plan_hits"] > 0

    def test_quarantine_preserved_through_scheduler(self):
        server, store, users = fleet_server()
        sched = Scheduler(server, clock=VirtualClock())
        rng = np.random.default_rng(4)
        poison_user(store, users[0])
        t_bad = sched.submit(users[0], make_rows(rng, store, 8))
        t_ok = sched.submit(users[1], make_rows(rng, store, 8))
        sched.flush()
        sched.close()
        assert t_bad.status == "quarantined" and t_bad.prediction is None
        assert "IntegrityError" in t_bad.detail
        assert t_ok.status == "ok"
        assert users[0] in server.quarantined_users

    def test_batch_fault_isolation(self):
        server, store, users = fleet_server()
        faults = BatchFaults(fail_batches=(0,))
        sched = Scheduler(server, clock=VirtualClock(), fault_hook=faults)
        rng = np.random.default_rng(5)
        t0 = sched.submit(users[0], make_rows(rng, store, 8))
        sched.flush()
        t1 = sched.submit(users[1], make_rows(rng, store, 8))
        sched.flush()
        sched.close()
        assert t0.status == "failed" and "InjectedCrash" in t0.detail
        assert t1.status == "ok"
        assert sched.executor.stats()["n_failed_batches"] == 1

    def test_engine_timings_surface(self):
        server, store, users = fleet_server()
        sched = Scheduler(server, clock=VirtualClock())
        rng = np.random.default_rng(6)
        sched.submit(users[0], make_rows(rng, store, 8))
        sched.flush()
        sched.close()
        timings = server.stats()["engine_timings"]
        assert timings, "execute() must record at least one engine"
        for summary in timings.values():
            assert summary["count"] >= 1
            assert summary["p99_ms"] >= summary["p50_ms"] >= 0.0


class TestLifecycleDriver:
    def test_load_aware_poll_window(self):
        server, store, users = fleet_server()
        d = LifecycleDriver(
            server, VirtualClock(), poll_interval_s=1.0,
            max_poll_interval_s=4.0, low_load_rows=100,
        )
        d.tick(0.0, pending_rows=0)
        assert d.n_polls == 1 and d._next_poll == 1.0
        d.tick(0.5, pending_rows=0)  # inside window: no poll
        assert d.n_polls == 1
        d.tick(1.0, pending_rows=100)  # loaded: window stretches 2x
        assert d.n_polls == 2 and d._next_poll == 3.0
        d.tick(3.0, pending_rows=10**9)  # stretch is capped
        assert d._next_poll == 7.0

    def test_autonomous_recluster_waits_for_low_load(self):
        server, store, users = drifted_server()
        clock = VirtualClock()
        d = LifecycleDriver(
            server, clock, poll_interval_s=1.0, low_load_rows=64,
            migrate_users_per_s=1000.0, max_users_per_tick=1000,
        )
        assert drift_report(store)["recommend_recluster"]
        gen0 = store.generation
        d.tick(0.0, pending_rows=1000)  # high load: polls, defers
        assert d.n_polls == 1 and d.n_reclusters == 0
        assert store.generation == gen0
        d.tick(10.0, pending_rows=0)  # low-load gap: recluster fires
        assert d.n_reclusters == 1 and store.generation == gen0 + 1
        while d.state == "migrating":
            clock.advance(1.0)
            d.tick(clock.now(), pending_rows=0)
        assert d.stats()["journal"]["state"] == "committed"
        assert drift_report(store)["n_pending_migration"] == 0
        assert not drift_report(store)["recommend_recluster"]

    def test_migration_rate_limit(self):
        server, store, users = drifted_server(n_users=12, late_fraction=0.5)
        clock = VirtualClock()
        d = LifecycleDriver(
            server, clock, poll_interval_s=0.1, low_load_rows=64,
            migrate_users_per_s=2.0, max_users_per_tick=1,
        )
        d.tick(0.0, pending_rows=0)
        assert d.state == "migrating"
        n_pending = d.stats()["n_pending_migration"]
        assert n_pending > 2
        d.tick(0.5, pending_rows=0)
        d.tick(1.0, pending_rows=0)
        assert d.n_migrated == 2  # rate limit respected, not all at once
        while d.state == "migrating":
            clock.advance(0.5)
            d.tick(clock.now(), pending_rows=0)
        assert d.n_migrated == n_pending

    def test_mixed_generation_serving_under_load(self):
        server, store, users = drifted_server()
        clock = VirtualClock()
        driver = LifecycleDriver(
            server, clock, poll_interval_s=0.2, low_load_rows=256,
            migrate_users_per_s=10.0, max_users_per_tick=1,
        )
        sched = Scheduler(
            server, clock=clock, queue=RequestQueue(slo_s=0.5),
            batcher=MicroBatcher(max_rows=128), lifecycle=driver,
        )
        rng = np.random.default_rng(8)
        gen0 = store.generation
        tickets = []
        saw_mixed = False
        for i in range(150):
            u = users[int(rng.integers(len(users)))]
            rows = make_rows(rng, store, 8)
            tickets.append((u, rows, sched.submit(u, rows)))
            clock.advance(0.05)
            sched.pump()
            if driver.state == "migrating":
                saw_mixed = True
        while driver.state == "migrating":
            clock.advance(0.1)
            sched.pump()
        sched.close()
        assert store.generation == gen0 + 1  # autonomous recluster ran
        assert saw_mixed  # requests were served MID-migration
        assert driver.n_migrated > 0
        silent_wrong = 0
        for u, rows, t in tickets:
            assert t.status == "ok", (t.status, t.detail)
            if not np.array_equal(t.prediction, oracle(store, u, rows)):
                silent_wrong += 1
        assert silent_wrong == 0
        lat = sched.latency_stats(slack_s=0.25)
        assert lat["deadline_misses"] == 0

    def test_driver_excludes_quarantined_users(self):
        server, store, users = drifted_server()
        poison_user(store, users[0])
        server.serve_safe([(users[0], np.zeros(
            (1, store.shared.n_features), np.int32
        ))])
        assert users[0] in server.quarantined_users
        clock = VirtualClock()
        d = LifecycleDriver(server, clock, low_load_rows=64)
        d.tick(0.0, pending_rows=0)
        assert d.last_report["n_users"] == len(users) - 1
        assert d.n_reclusters == 0 and d.n_deferred == 1
        fixed = make_synthetic_fleet(
            1, "classification", n_trees=(4, 8), max_depth=4, seed=77
        )
        store.add_user(users[0], next(iter(fixed.values())))
        clock.advance(10.0)
        d.tick(clock.now(), pending_rows=0)
        assert d.n_reclusters == 1


class TestDriftReportCache:
    def test_memoized_on_store_version(self):
        server, store, users = drifted_server()
        r1 = drift_report(store)
        r2 = drift_report(store)
        assert r2 is r1
        store.add_user(
            "fresh", make_synthetic_fleet(
                1, "classification", n_trees=(4, 8), max_depth=4, seed=42
            ).popitem()[1],
        )
        r3 = drift_report(store)
        assert r3 is not r1 and r3["n_users"] == r1["n_users"] + 1

    def test_distinct_args_not_conflated(self):
        server, store, users = drifted_server()
        r1 = drift_report(store, recluster_threshold=0.2)
        r2 = drift_report(store, recluster_threshold=0.9)
        assert r2 is not r1
        r3 = drift_report(store, exclude=(users[0],))
        assert r3["n_users"] == r1["n_users"] - 1

    def test_per_user_cache_sees_relabel_migration(self):
        from repro_torch.store.lifecycle import recluster

        server, store, users = drifted_server()
        before = drift_report(store)
        assert before["fallback_user_fraction"] > 0
        recluster(store, mode="extend", seed=0)
        after = drift_report(store)
        assert after["codebook_generation"] == store.generation
        assert after["n_pending_migration"] == 0
        assert after["fallback_user_fraction"] == 0.0
        for u in users:
            assert (
                after["per_user"][u]["codebook_generation"]
                == store.generation
            )


class TestResidencyPrefetch:
    def _durable_fleet(self, tmp_path, n_users=8):
        forests = make_synthetic_fleet(
            n_users, "classification", n_trees=(4, 8), max_depth=4, seed=2
        )
        store0 = build_store(forests, device=CPU)
        base = str(tmp_path / "fleet")
        DurableStore.create(base, store0)
        return store0, base

    def _serving(self, base, budget, prefetch, clock):
        durable = DurableStore.open(base)
        store = durable.load_store(lazy=True, device=CPU)
        mgr = attach_residency(store, durable, budget_bytes=budget)
        server = ForestServer(store, device=CPU)
        pf = (
            Prefetcher(mgr, server=server, background=False)
            if prefetch else None
        )
        return Scheduler(server, clock, prefetcher=pf), mgr, store, server

    def test_prefetch_bit_identical_to_inline_and_hits(self, tmp_path):
        store0, base = self._durable_fleet(tmp_path)
        sizes = {
            u: len(store0._deltas[u].to_bytes()) for u in store0.user_ids
        }
        budget = 3 * max(sizes.values())  # < fleet: demotions guaranteed
        assert budget < sum(sizes.values())

        def run(prefetch):
            clock = VirtualClock()
            sched, mgr, _, _ = self._serving(base, budget, prefetch, clock)
            rng = np.random.default_rng(4)
            users = sorted(store0.user_ids)
            tickets = []
            for _ in range(15):
                for _ in range(int(rng.integers(1, 4))):
                    u = users[int(rng.integers(len(users)))]
                    tickets.append(sched.submit(u, make_rows(rng, store0, 4)))
                clock.advance(0.3)
                sched.pump()
            sched.close()
            return tickets, mgr.stats()

        t_off, s_off = run(False)
        t_on, s_on = run(True)
        assert len(t_off) == len(t_on)
        for a, b in zip(t_off, t_on):
            assert a.status == b.status == "ok"
            assert np.array_equal(a.prediction, b.prediction)
        assert s_off["prefetch_requested"] == 0
        assert s_on["prefetch_hits"] > 0
        assert s_on["resident_bytes"] <= budget
        assert s_off["resident_bytes"] <= budget
        assert s_on["over_budget_events"] == 0

    def test_quarantined_user_never_prefetched(self, tmp_path):
        from repro_torch.runtime.chaos import DiskFaults
        from repro_torch.store.durable import _LazyShard

        store0, base = self._durable_fleet(tmp_path)
        victim, healthy = sorted(store0.user_ids)[:2]
        clock = VirtualClock()
        sched, mgr, store, server = self._serving(
            base, 10**9, prefetch=True, clock=clock
        )
        durable = store._deltas._durable
        entry = durable.shard_for_user(victim)
        path, off, length = durable.shard_location(entry.shard_id)
        DiskFaults().corrupt_region(path, off, min(length, 16))
        rng = np.random.default_rng(9)
        t_bad = sched.submit(victim, make_rows(rng, store0, 4))
        t_ok = sched.submit(healthy, make_rows(rng, store0, 4))
        sched.flush()
        assert t_bad.status == "quarantined" and t_bad.prediction is None
        assert t_ok.status == "ok"
        assert victim in server.quarantined_users
        st = mgr.stats()
        assert st["prefetch_errors"] == 1  # the pre-quarantine warm
        requested = st["prefetch_requested"]
        t_again = sched.submit(victim, make_rows(rng, store0, 4))
        sched.flush()
        assert t_again.status == "quarantined"
        assert mgr.stats()["prefetch_requested"] == requested  # filtered
        assert isinstance(dict.get(store._deltas, victim), _LazyShard)
        sched.close()

    def test_lifecycle_migrates_demoted_user_round_trip(self, tmp_path):
        store0, initial, _ = drifted_store()
        rng = np.random.default_rng(1)
        x = make_rows(rng, store0, 8)
        want = {u: store0.predict(u, x) for u in store0.user_ids}
        base = str(tmp_path / "fleet")
        DurableStore.create(base, store0)
        durable = DurableStore.open(base)
        store = durable.load_store(lazy=True, device=CPU)
        mgr = attach_residency(store, durable, budget_bytes=10**9)
        server = ForestServer(store, device=CPU)
        clock = VirtualClock()
        driver = LifecycleDriver(
            server, clock, poll_interval_s=0.1, low_load_rows=64,
            migrate_users_per_s=1e9, max_users_per_tick=1000,
        )
        victim = sorted(initial)[0]
        store.predict(victim, x)          # resident...
        assert mgr.demote(victim)         # ...then demoted (clean)
        assert drift_report(store)["recommend_recluster"]
        driver.tick(0.0, pending_rows=0)
        while driver.state == "migrating":
            clock.advance(1.0)
            driver.tick(clock.now(), pending_rows=0)
        assert driver.n_reclusters == 1
        for u, w in want.items():
            assert np.array_equal(store.predict(u, x), w), u
        assert mgr.demote(victim)
        st = mgr.stats()
        assert st["writebacks"] >= 1
        assert np.array_equal(store.predict(victim, x), want[victim])


# ---------------------------------------------------------------------------
# differential: the reference and the port replay one trace
# ---------------------------------------------------------------------------

PORT = types.SimpleNamespace(
    sched=port_sched, poison=poison_user, faults=BatchFaults,
    server=lambda store: ForestServer(store, device=CPU),
    from_bytes=lambda blob: ForestStore.from_bytes(blob, device=CPU),
    durable=DurableStore, attach=attach_residency, prefetcher=Prefetcher,
    load=lambda durable: durable.load_store(lazy=True, device=CPU),
)
REF = types.SimpleNamespace(
    sched=ref_sched, poison=ref_poison_user, faults=RefBatchFaults,
    server=RefServer, from_bytes=RefForestStore.from_bytes,
    durable=RefDurable, attach=ref_attach_residency,
    prefetcher=RefPrefetcher,
    load=lambda durable: durable.load_store(lazy=True),
)


def seeded_trace(store, users, n, seed, rows=(4, 24), dt=(0.01, 0.3)):
    """``n`` arrivals: (user, rows block, clock advance after it)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        u = users[int(rng.integers(len(users)))]
        x = make_rows(rng, store, int(rng.integers(*rows)))
        out.append((u, x, float(rng.uniform(*dt))))
    return out


def replay(pkg, store, trace, *, max_rows=64, slo_s=0.5, fault_hook=None,
           driver_kw=None, journal=None, prefetch_budget=None, safe=True):
    """Run ``trace`` through ``pkg``'s Scheduler under VirtualClock and
    record everything the differential compares."""
    s = pkg.sched
    mgr = pf = None
    if prefetch_budget is not None:
        durable = store
        store = pkg.load(durable)
        mgr = pkg.attach(store, durable, budget_bytes=prefetch_budget)
    server = pkg.server(store)
    if mgr is not None:
        pf = pkg.prefetcher(mgr, server=server, background=False)
    clock = s.VirtualClock()
    driver = None
    if driver_kw is not None:
        driver = s.LifecycleDriver(server, clock, journal_path=journal,
                                   **driver_kw)
    sched = s.Scheduler(
        server, clock=clock, queue=s.RequestQueue(slo_s=slo_s),
        batcher=s.MicroBatcher(max_rows=max_rows), lifecycle=driver,
        fault_hook=fault_hook, prefetcher=pf, safe=safe,
    )
    batches, ticks, loads = [], [], []
    submit = sched.executor.submit

    def record_batch(batch):
        batches.append((batch.seq, batch.users, batch.trigger,
                        batch.formed_t, [r.seq for r in batch.requests]))
        submit(batch)

    sched.executor.submit = record_batch
    in_plan = []
    if mgr is not None:
        plan, notify = server.plan, mgr.notify_loaded

        def counted_plan(*a, **k):
            in_plan.append(True)
            try:
                return plan(*a, **k)
            finally:
                in_plan.pop()

        def counted_load(user_id, *a, **k):
            loads.append((user_id, bool(in_plan)))
            return notify(user_id, *a, **k)

        server.plan = counted_plan
        mgr.notify_loaded = counted_load
    tickets = []
    for u, x, dt in trace:
        tickets.append(sched.submit(u, x))
        clock.advance(dt)
        sched.pump()
        if driver is not None:
            ticks.append((clock.now(), driver.state, driver.n_reclusters,
                          driver.n_migrated))
    while driver is not None and driver.state == "migrating":
        clock.advance(0.1)
        sched.pump()
        ticks.append((clock.now(), driver.state, driver.n_reclusters,
                      driver.n_migrated))
    sched.close()
    return {
        "batches": batches, "tickets": tickets, "stats": sched.stats(),
        "ticks": ticks, "loads": loads,
        "residency": mgr.stats() if mgr is not None else None,
        "quarantined": sorted(server.quarantined_users),
        "store_bytes": (None if server.quarantined_users
                        else server.store.to_bytes()),
        "journal": open(journal, "rb").read() if journal else None,
    }


def assert_same_run(port, ref, task):
    assert port["batches"] == ref["batches"]
    assert len(port["tickets"]) == len(ref["tickets"])
    for p, r in zip(port["tickets"], ref["tickets"]):
        assert (p.seq, p.user_id, p.status, p.detail, p.degraded,
                p.batch_seq, p.arrival_t, p.deadline, p.completed_t) == (
            r.seq, r.user_id, r.status, r.detail, r.degraded,
            r.batch_seq, r.arrival_t, r.deadline, r.completed_t)
        if r.prediction is None:
            assert p.prediction is None
        elif task == "classification":
            np.testing.assert_array_equal(p.prediction, r.prediction)
        else:
            np.testing.assert_allclose(p.prediction, r.prediction,
                                       rtol=RTOL, atol=ATOL)
    assert port["stats"] == ref["stats"]
    assert port["ticks"] == ref["ticks"]
    assert port["quarantined"] == ref["quarantined"]


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_trace_equals_reference(task):
    """Batches, tickets and ``stats()`` of one trace; the classification
    run also fails batch 1 by ``BatchFaults`` and poisons one user."""
    forests = make_synthetic_fleet(6, task, n_trees=(4, 8), max_depth=4,
                                   seed=11)
    blob = build_store(forests, device=CPU).to_bytes()
    users = sorted(forests)
    n = 24 if task == "classification" else 12
    runs = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        store = pkg.from_bytes(blob)
        trace = seeded_trace(store, users, n, seed=3)
        hook = None
        if task == "classification":
            pkg.poison(store, users[2])
            hook = pkg.faults(fail_batches=(1,))
        runs[name] = replay(pkg, store, trace, fault_hook=hook)
    assert_same_run(runs["port"], runs["ref"], task)
    statuses = {t.status for t in runs["port"]["tickets"]}
    triggers = {b[2] for b in runs["port"]["batches"]}
    if task == "classification":
        assert {"rows", "deadline"} <= triggers
        assert statuses == {"ok", "failed", "quarantined"}
        assert runs["port"]["stats"]["executor"]["n_failed_batches"] == 1
        assert runs["port"]["quarantined"] == [users[2]]
    assert runs["port"]["store_bytes"] == runs["ref"]["store_bytes"]


def test_lifecycle_driver_equals_reference(tmp_path):
    """The driver's decisions tick by tick (when the recluster starts,
    who migrates when), the RFJ1 journal and the final RFT1 bytes."""
    store, _, users = drifted_store()
    blob = store.to_bytes()
    trace = seeded_trace(store, users, 28, seed=5, rows=(8, 9),
                         dt=(0.05, 0.0500001))
    kw = dict(poll_interval_s=0.2, low_load_rows=256,
              migrate_users_per_s=10.0, max_users_per_tick=1)
    runs = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        runs[name] = replay(pkg, pkg.from_bytes(blob), trace, max_rows=128,
                            driver_kw=kw, journal=str(tmp_path / name))
    assert_same_run(runs["port"], runs["ref"], "classification")
    ticks = runs["port"]["ticks"]
    assert ticks[0][2] == 1  # the recluster starts at the first tick
    assert any(t[1] == "migrating" for t in ticks)
    assert ticks[-1][1] == "watching" and ticks[-1][3] > 0
    assert runs["port"]["journal"] == runs["ref"]["journal"]
    assert runs["port"]["store_bytes"] == runs["ref"]["store_bytes"]
    port_store = ForestStore.from_bytes(runs["port"]["store_bytes"],
                                        device=CPU)
    assert drift_report(port_store)["fallback_user_fraction"] == 0.0
    for (u, x, _), t in zip(trace, runs["port"]["tickets"]):
        assert t.status == "ok"
        np.testing.assert_array_equal(t.prediction,
                                      oracle(port_store, u, x))


@pytest.mark.parametrize("safe", [True, False])
def test_prefetch_through_the_scheduler_equals_reference(tmp_path, safe):
    """ROADMAP R7 through the scheduler: over a durable store at a
    budget that demotes, with an inline ``Prefetcher``, both packages
    count the same prefetch hits and the same cold loads, and report
    equal ``stats()``.  Inline, the executor prefetches then serves;
    ``serve_safe``'s probe touches (and so absorbs) each staged user
    before ``plan`` reads it, while ``serve`` (``safe=False``) plans
    first and loads the staged users cold again (R7)."""
    forests = make_synthetic_fleet(8, "classification", n_trees=(4, 8),
                                   max_depth=4, seed=2)
    store0 = build_store(forests, device=CPU)
    sizes = [len(store0.delta(u).to_bytes()) for u in store0.user_ids]
    budget = 3 * max(sizes)
    assert budget < sum(sizes)
    blob = store0.to_bytes()
    users = sorted(forests)
    runs = {}
    for name, pkg in (("port", PORT), ("ref", REF)):
        base = str(tmp_path / name)
        pkg.durable.create(base, pkg.from_bytes(blob))
        durable = pkg.durable.open(base)
        trace = seeded_trace(store0, users, 10, seed=4, rows=(4, 5),
                             dt=(0.3, 0.3000001))
        runs[name] = replay(pkg, durable, trace, max_rows=1024,
                            slo_s=0.25, prefetch_budget=budget, safe=safe)
    assert_same_run(runs["port"], runs["ref"], "classification")
    assert runs["port"]["residency"] == runs["ref"]["residency"]
    assert runs["port"]["loads"] == runs["ref"]["loads"]
    st = runs["port"]["residency"]
    in_plan = sum(1 for _, p in runs["port"]["loads"] if p)
    assert st["demotions"] > 0
    assert st["reloads"] == len(runs["port"]["loads"])
    if safe:
        assert in_plan == 0 and st["prefetch_hits"] > 0
    else:
        assert in_plan > 0


# ---------------------------------------------------------------------------
# real threads on the port
# ---------------------------------------------------------------------------

def _device_resolutions(monkeypatch):
    """Record the thread of every ``resolve_device`` call the port's
    modules make."""
    import importlib

    from repro_torch import device as device_mod

    calls = []
    real = device_mod.resolve_device

    def spy(*a, **k):
        calls.append(threading.current_thread().name)
        return real(*a, **k)

    for mod in ("repro_torch.device", "repro_torch.serving.server",
                "repro_torch.store.arena", "repro_torch.store.runtime",
                "repro_torch.kernels.tree_predict.ops"):
        m = importlib.import_module(mod)
        if getattr(m, "resolve_device", None) is real:
            monkeypatch.setattr(m, "resolve_device", spy)
    return calls


def test_overlapped_scheduler_with_prefetch_on_real_threads(
        tmp_path, monkeypatch):
    """``WallClock``, overlap on, a background ``Prefetcher`` over a
    durable store at a budget that demotes: every answer equals the
    inline run's and the per-user oracle's; the serve path never
    resolves a device; every device-tier call is made on
    ``sched-executor``; ``close()`` leaves no worker thread."""
    forests = make_synthetic_fleet(10, "classification", n_trees=(4, 8),
                                   max_depth=4, seed=9)
    store0 = build_store(forests, device=CPU)
    base = str(tmp_path / "fleet")
    DurableStore.create(base, store0)
    sizes = [len(store0.delta(u).to_bytes()) for u in store0.user_ids]
    budget = 3 * max(sizes)
    users = sorted(forests)
    trace = seeded_trace(store0, users, 40, seed=6, rows=(4, 16))

    def run(overlap):
        durable = DurableStore.open(base)
        store = durable.load_store(lazy=True, device=CPU)
        mgr = attach_residency(store, durable, budget_bytes=budget)
        server = ForestServer(store, device=CPU)
        pf = Prefetcher(mgr, server=server, background=overlap)
        calls = []
        arena = store.arena
        for name in ("admit_many", "gather", "run_token", "invalidate",
                     "touch_users"):
            real = getattr(arena, name)

            def spy(*a, _real=real, _name=name, **k):
                calls.append((_name, threading.current_thread().name))
                return _real(*a, **k)

            setattr(arena, name, spy)
        resolved = _device_resolutions(monkeypatch) if overlap else []
        sched = Scheduler(
            server, clock=WallClock() if overlap else VirtualClock(),
            batcher=MicroBatcher(max_rows=48), prefetcher=pf,
        )
        assert sched.executor.overlap is overlap
        tickets = []
        for u, x, _ in trace:
            tickets.append(sched.submit(u, x))
            sched.pump()
        sched.close()
        assert mgr.accounted_bytes() <= budget
        return tickets, mgr.stats(), calls, resolved, sched

    inline, _, _, _, _ = run(False)
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the three threads finely
    try:
        tickets, st, calls, resolved, sched = run(True)
    finally:
        sys.setswitchinterval(switch)
    for (u, x, _), a, b in zip(trace, inline, tickets):
        assert a.status == b.status == "ok" and not b.degraded, b.detail
        np.testing.assert_array_equal(b.prediction, a.prediction)
        np.testing.assert_array_equal(b.prediction, store0.predict(u, x))
    ex = sched.executor.stats()
    assert ex["n_failed_batches"] == 0 and ex["n_preplanned"] > 0
    assert st["prefetch_errors"] == 0 and st["demotions"] > 0
    assert resolved == []
    assert calls and {t for _, t in calls} == {"sched-executor"}, sorted(
        {c for c in calls if c[1] != "sched-executor"})
    alive = {t.name for t in threading.enumerate()}
    assert not alive & {"sched-executor", "residency-prefetch"}


def test_driver_migration_on_real_threads_leaves_the_arena_to_the_executor():
    """S3: a ``LifecycleDriver`` reclustering and migrating on the pump
    thread while ``sched-executor`` serves (``WallClock``, overlap on).
    Re-registered users' arena runs are dropped on ``sched-executor``
    (``ForestStore.serve_path``), never on the pump thread that migrated
    them; every ticket is answered and equals the per-user oracle of the
    store as left."""
    server, store, users = drifted_server(n_users=12, late_fraction=0.5,
                                          seed=3)
    calls = []
    arena = store.arena
    for name in ("admit_many", "gather", "run_token", "invalidate",
                 "touch_users"):
        real = getattr(arena, name)

        def spy(*a, _real=real, _name=name, **k):
            calls.append((_name, threading.current_thread().name))
            return _real(*a, **k)

        setattr(arena, name, spy)
    clock = WallClock()
    driver = LifecycleDriver(
        server, clock, poll_interval_s=0.0, low_load_rows=10**6,
        migrate_users_per_s=1e6, max_users_per_tick=2,
    )
    sched = Scheduler(server, clock=clock, batcher=MicroBatcher(max_rows=48),
                      lifecycle=driver)
    assert sched.executor.overlap
    rng = np.random.default_rng(5)
    gen0 = store.generation
    tickets = []
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        # the executor serves (and so claims the arena) before the first
        # tick, then the driver migrates while batches are in flight
        u = users[0]
        rows = make_rows(rng, store, 8)
        tickets.append((u, rows, sched.submit(u, rows)))
        sched.flush()
        for i in range(400):
            u = users[int(rng.integers(len(users)))]
            rows = make_rows(rng, store, 8)
            tickets.append((u, rows, sched.submit(u, rows)))
            sched.pump()
            if driver.n_migrated and driver.state == "watching":
                break
        sched.close()
    finally:
        sys.setswitchinterval(switch)
    assert store.generation == gen0 + 1 and driver.n_migrated > 0
    for u, rows, t in tickets:
        assert t.status == "ok", (t.status, t.detail)
        np.testing.assert_array_equal(t.prediction, oracle(store, u, rows))
    off = sorted({c for c in calls if c[1] != "sched-executor"})
    assert off == [], off
    assert sum(name == "invalidate" for name, _ in calls) > 0


# ---------------------------------------------------------------------------
# DET004: only clock.py may read the wall clock
# ---------------------------------------------------------------------------

_ALLOW = "repro-lint: allow-wallclock"


def wallclock_uses(path):
    """(line, what) for every import or name of ``time`` / ``datetime``
    in the module at ``path`` (a line marked ``allow-wallclock`` is
    exempt, as ``docs/analysis.md`` §2 allows)."""
    with open(path) as fh:
        text = fh.read()
    lines = text.splitlines()
    found = []
    for node in ast.walk(ast.parse(text)):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names = [node.module.split(".")[0]]
        elif isinstance(node, ast.Name):
            names = [node.id]
        for name in names:
            if name in ("time", "datetime") and (
                    _ALLOW not in lines[node.lineno - 1]):
                found.append((node.lineno, name))
    return found


def test_det004_only_the_clock_reads_time():
    mods = sorted(f for f in os.listdir(SCHED) if f.endswith(".py"))
    assert len(mods) == 7
    assert wallclock_uses(os.path.join(SCHED, "clock.py"))
    for f in mods:
        if f != "clock.py":
            assert wallclock_uses(os.path.join(SCHED, f)) == [], f


def test_det004_scan_catches_a_planted_clock_read(tmp_path):
    src = os.path.join(SCHED, "batcher.py")
    with open(src) as fh:
        text = fh.read()
    planted = tmp_path / "batcher.py"
    planted.write_text(text.replace(
        "        trigger = self.due(queue, now)\n",
        "        import time\n"
        "        now = time.monotonic()\n"
        "        trigger = self.due(queue, now)\n", 1))
    assert planted.read_text() != text
    assert [w for _, w in wallclock_uses(planted)] == ["time", "time"]
