"""The port's residency tier (``repro_torch.store.residency``) and streaming
build (``repro_torch.store.streaming``) against the JAX reference on the
CPU.

* A streaming build writes the same durable directory in both packages.
* A differential property in the reference's own form: the same drawn
  budget and the same interleaving of serve, demote, prefetch and
  re-register run on both packages over copies of one streaming-built
  fleet; after every op the predictions, ``accounted_bytes()`` and the
  reference's per-op invariant agree, and at the end the two managers'
  ``stats()`` are equal.
* The reference's property (``tests/test_property.py::
  test_residency_interleavings_bit_exact_within_budget``) copied as it
  stands onto the port.  It fails on the port exactly as it fails on the
  reference (ROADMAP Queue 3 R1): the same falsifying example (budget
  591 B, the smallest user's delta; ops ``[('serve', 'user00000')]``) and
  the same count (``over_budget_events`` reads 8, not 0): the final loop
  serves users larger than the budget, each pinned for its serve, and
  the manager counts every pinned overflow.  It is marked
  ``xfail(strict=True)`` with that reason, so a change in either
  direction shows.
* The port's copy of ``tests/test_chaos.py::TestResidencyChaos``,
  unweakened, and the port's own device rules: a demotion drops the
  user's arena run, and the ``Prefetcher``'s worker thread never touches
  the arena (the upload stays on the serving thread).
"""
import os
import shutil
import tempfile
import threading

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.store import DurableStore as RefDurable
from repro.store import Prefetcher as RefPrefetcher
from repro.store import attach_residency as ref_attach_residency
from repro.store import build_store_streaming as ref_build_store_streaming
from repro.store import make_synthetic_fleet as ref_fleet
from repro.store.delta import UserDelta as RefUserDelta
from repro_torch.core.framing import IntegrityError
from repro_torch.runtime.chaos import (
    CrashSchedule,
    DiskFaults,
    InjectedCrash,
    record_steps,
)
from repro_torch.serving import ForestServer
from repro_torch.store import (
    DurableStore,
    Prefetcher,
    attach_residency,
    build_store,
    build_store_streaming,
    make_request_batch,
    make_synthetic_fleet,
)
from repro_torch.store.delta import UserDelta
from repro_torch.store.durable import _LazyShard

CPU = "cpu"
FLEET_KW = dict(n_users=8, d=5, n_bins=12, seed=31, n_trees=(3, 5),
                max_depth=3)
STREAM_KW = dict(wave_users=3, k_max=4, seed=0, slab_shards=8)


def _files(path):
    out = {}
    for name in sorted(os.listdir(path)):
        with open(os.path.join(path, name), "rb") as f:
            out[name] = f.read()
    return out


_TEMPLATE: dict = {}


def _template():
    """The property's fleet, streaming-built once by each package, plus
    the per-user oracle; every example copies both directories fresh."""
    if _TEMPLATE:
        return _TEMPLATE
    root = tempfile.mkdtemp(prefix="torch_residency_")
    port_path, ref_path = f"{root}/port", f"{root}/ref"
    durable = build_store_streaming(make_synthetic_fleet(**FLEET_KW),
                                    port_path, device=CPU, **STREAM_KW)
    ref_build_store_streaming(ref_fleet(**FLEET_KW), ref_path, **STREAM_KW)
    ref = durable.load_store(lazy=False, device=CPU)
    users = sorted(ref.user_ids)
    rng = np.random.default_rng(7)
    x = rng.integers(
        0, int(ref.shared.n_bins_per_feature[0]),
        (6, ref.shared.n_features),
    ).astype(np.int32)
    delta_bytes = {u: ref._deltas[u].to_bytes() for u in users}
    _TEMPLATE.update({
        "root": root, "port": port_path, "ref": ref_path, "users": users,
        "x": x, "oracle": {u: ref.predict(u, x) for u in users},
        "delta_bytes": delta_bytes,
        "sizes": {u: len(b) for u, b in delta_bytes.items()},
    })
    return _TEMPLATE


def test_streaming_build_writes_the_reference_directory():
    tpl = _template()
    assert _files(tpl["port"]) == _files(tpl["ref"])
    port = DurableStore.open(tpl["port"]).load_store(lazy=False, device=CPU)
    ref = RefDurable.open(tpl["ref"]).load_store(lazy=False)
    assert port.to_bytes() == ref.to_bytes()
    assert port.generations == ref.generations


@pytest.mark.parametrize("extend", [True, False])
def test_streaming_waves_equal_reference(tmp_path, extend):
    seen = {"port": [], "ref": []}
    kw = dict(wave_users=2, k_max=4, seed=0, slab_shards=3, extend=extend)
    build_store_streaming(make_synthetic_fleet(**FLEET_KW),
                          str(tmp_path / "p"), device=CPU,
                          on_wave=seen["port"].append, **kw)
    ref_build_store_streaming(ref_fleet(**FLEET_KW), str(tmp_path / "r"),
                              on_wave=seen["ref"].append, **kw)
    assert seen["port"] == seen["ref"]
    assert len(seen["port"]) == 4
    assert _files(str(tmp_path / "p")) == _files(str(tmp_path / "r"))


def test_streaming_build_needs_a_user(tmp_path):
    with pytest.raises(ValueError, match="at least one"):
        build_store_streaming({}, str(tmp_path / "x"), device=CPU)
    with pytest.raises(ValueError, match="positive"):
        build_store_streaming({}, str(tmp_path / "x"), wave_users=0,
                              device=CPU)


# ---------------------------------------------------------------------------
# the differential property: same draws, both packages
# ---------------------------------------------------------------------------

def _open_pair(work, budget):
    tpl = _template()
    shutil.copytree(tpl["port"], f"{work}/port")
    shutil.copytree(tpl["ref"], f"{work}/ref")
    pd = DurableStore.open(f"{work}/port")
    rd = RefDurable.open(f"{work}/ref")
    ps = pd.load_store(lazy=True, device=CPU)
    rs = rd.load_store(lazy=True)
    pm = attach_residency(ps, pd, budget_bytes=budget)
    rm = ref_attach_residency(rs, rd, budget_bytes=budget)
    return (ps, pm, Prefetcher(pm, background=False)), \
        (rs, rm, RefPrefetcher(rm, background=False))


def _apply(op, u, store, mgr, pf, delta_cls, x):
    """One op of the reference property's interleaving; returns the
    prediction for a serve."""
    if op == "serve":
        return np.asarray(store.predict(u, x))
    if op == "demote":
        mgr.demote(u)
    elif op == "prefetch":
        pf.request([u])
        mgr.absorb_staged()
    else:
        store.add_delta(
            u, delta_cls.from_bytes(_template()["delta_bytes"][u]))
    return None


@given(st.data())
@settings(max_examples=10, deadline=None)
def test_residency_interleavings_equal_reference(data):
    tpl = _template()
    users, x, oracle = tpl["users"], tpl["x"], tpl["oracle"]
    total = sum(tpl["sizes"].values())
    budget = data.draw(
        st.integers(min(tpl["sizes"].values()), total), label="budget"
    )
    ops = data.draw(
        st.lists(
            st.tuples(
                st.sampled_from(["serve", "demote", "prefetch",
                                 "reregister"]),
                st.sampled_from(users),
            ),
            min_size=1, max_size=30,
        ),
        label="ops",
    )
    work = tempfile.mkdtemp(prefix="torch_residency_case_")
    try:
        port, ref = _open_pair(work, budget)
        for op, u in ops:
            got = _apply(op, u, *port, UserDelta, x)
            want = _apply(op, u, *ref, RefUserDelta, x)
            if op == "serve":
                assert np.array_equal(got, want), u
                assert np.array_equal(got, oracle[u]), u
            assert port[1].accounted_bytes() == ref[1].accounted_bytes()
            assert port[1].accounted_bytes() <= budget, (op, u)
        for u in users:
            got = _apply("serve", u, *port, UserDelta, x)
            assert np.array_equal(got, _apply("serve", u, *ref,
                                              RefUserDelta, x)), u
            assert np.array_equal(got, oracle[u]), u
            assert port[1].accounted_bytes() == ref[1].accounted_bytes()
            assert port[1].accounted_bytes() <= budget
        assert port[1].stats() == ref[1].stats()
        assert port[1].stats()["resident_bytes"] <= budget
        for pf in (port[2], ref[2]):
            pf.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# the reference's property, copied as it stands
# ---------------------------------------------------------------------------

@pytest.mark.xfail(
    strict=True,
    reason="ROADMAP Queue 3 R1: the reference fails this property the same "
           "way (budget 591 B, ops [('serve', 'user00000')], "
           "over_budget_events 8): users larger than the budget overflow "
           "while they serve, and the manager counts it",
)
@given(st.data())
@settings(max_examples=10, deadline=None)
def test_residency_interleavings_bit_exact_within_budget(data):
    tpl = _template()
    users, x, oracle = tpl["users"], tpl["x"], tpl["oracle"]
    total = sum(tpl["sizes"].values())
    work = tempfile.mkdtemp(prefix="torch_residency_case_")
    try:
        base = f"{work}/fleet"
        shutil.copytree(tpl["port"], base)
        durable = DurableStore.open(base)
        store = durable.load_store(lazy=True, device=CPU)
        budget = data.draw(
            st.integers(min(tpl["sizes"].values()), total), label="budget"
        )
        mgr = attach_residency(store, durable, budget_bytes=budget)
        pf = Prefetcher(mgr, background=False)
        ops = data.draw(
            st.lists(
                st.tuples(
                    st.sampled_from(
                        ["serve", "demote", "prefetch", "reregister"]
                    ),
                    st.sampled_from(users),
                ),
                min_size=1, max_size=30,
            ),
            label="ops",
        )
        for op, u in ops:
            if op == "serve":
                assert np.array_equal(store.predict(u, x), oracle[u]), u
            elif op == "demote":
                mgr.demote(u)
            elif op == "prefetch":
                pf.request([u])
                mgr.absorb_staged()
            else:
                store.add_delta(
                    u, UserDelta.from_bytes(tpl["delta_bytes"][u])
                )
            assert mgr.accounted_bytes() <= budget, (op, u)
        for u in users:
            assert np.array_equal(store.predict(u, x), oracle[u]), u
            assert mgr.accounted_bytes() <= budget
        st_ = mgr.stats()
        assert st_["resident_bytes"] <= budget
        assert st_["over_budget_events"] == 0
        pf.close()
    finally:
        shutil.rmtree(work, ignore_errors=True)


def test_r1_example_counts_the_same_on_both_packages():
    """R1's falsifying example, replayed: both managers count the same
    8 over-budget events, and both serve every user exactly."""
    tpl = _template()
    budget = min(tpl["sizes"].values())
    assert budget == 591
    work = tempfile.mkdtemp(prefix="torch_residency_r1_")
    try:
        port, ref = _open_pair(work, budget)
        for u in ["user00000"] + tpl["users"]:
            got = _apply("serve", u, *port, UserDelta, tpl["x"])
            assert np.array_equal(got, tpl["oracle"][u])
            assert np.array_equal(
                got, _apply("serve", u, *ref, RefUserDelta, tpl["x"]))
        assert port[1].stats() == ref[1].stats()
        assert port[1].stats()["over_budget_events"] == 8
    finally:
        shutil.rmtree(work, ignore_errors=True)


# ---------------------------------------------------------------------------
# the port's device rules
# ---------------------------------------------------------------------------

def _fleet_store(n_users=6):
    return build_store(make_synthetic_fleet(
        n_users=n_users, d=5, n_bins=12, seed=13, n_trees=(3, 5),
        max_depth=3,
    ), device=CPU)


def test_demotion_drops_the_users_arena_run(tmp_path):
    store0 = _fleet_store()
    DurableStore.create(str(tmp_path / "fleet"), store0)
    durable = DurableStore.open(str(tmp_path / "fleet"))
    store = durable.load_store(lazy=True, device=CPU)
    mgr = attach_residency(store, durable, budget_bytes=10**9)
    server = ForestServer(store, device=CPU)
    reqs = make_request_batch(store, 12, 16, seed=2)
    want = server.serve(reqs)
    users = sorted({u for u, _ in reqs})
    assert all(u in store.arena for u in users)
    invalidated = store.arena.stats()
    for u in users:
        assert mgr.demote(u)
        assert u not in store.arena
        assert isinstance(dict.get(store._deltas, u), _LazyShard)
        assert u not in store._hydrated
    assert store.arena.stats() != invalidated
    got = server.serve(reqs)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert mgr.stats()["demotions"] == len(users)


def test_prefetch_worker_never_touches_the_arena(tmp_path):
    """The background worker reads, parses, hydrates and decodes tiles;
    every arena call (admission, gather, invalidation) runs on the
    serving thread."""
    store0 = _fleet_store(8)
    DurableStore.create(str(tmp_path / "fleet"), store0)
    durable = DurableStore.open(str(tmp_path / "fleet"))
    store = durable.load_store(lazy=True, device=CPU)
    budget = sum(len(store0.delta(u).to_bytes())
                 for u in store0.user_ids) // 3
    mgr = attach_residency(store, durable, budget_bytes=budget)
    arena = store.arena
    threads = []
    for name in ("admit_many", "gather", "invalidate"):
        real = getattr(arena, name)

        def spy(*a, _real=real, _name=name, **k):
            threads.append((_name, threading.current_thread().name))
            return _real(*a, **k)

        setattr(arena, name, spy)
    server = ForestServer(store, device=CPU)
    pf = Prefetcher(mgr, server=server, background=True)
    oracle = ForestServer(store0, device=CPU)
    try:
        for seed in range(6):
            reqs = make_request_batch(store, 6, 16, seed=seed)
            pf.request([u for u, _ in reqs])
            pf.drain()
            for g, w in zip(server.serve(reqs), oracle.serve(reqs)):
                np.testing.assert_array_equal(g, w)
            assert mgr.accounted_bytes() <= budget
    finally:
        pf.close()
    st_ = mgr.stats()
    assert st_["prefetch_staged"] > 0 and st_["demotions"] > 0
    main = threading.main_thread().name
    assert threads and {t for _, t in threads} == {main}


# ---------------------------------------------------------------------------
# the port's copy of tests/test_chaos.py::TestResidencyChaos
# ---------------------------------------------------------------------------

class TestResidencyChaos:
    def _fleet_on_disk(self, tmp_path, n_users=6):
        store0 = build_store(make_synthetic_fleet(
            n_users=n_users, d=5, n_bins=12, seed=13,
            n_trees=(3, 5), max_depth=3,
        ), device=CPU)
        rng = np.random.default_rng(5)
        x = rng.integers(0, 12, (6, 5)).astype(np.int32)
        oracle = {u: store0.predict(u, x) for u in store0.user_ids}
        base = str(tmp_path / "fleet")
        DurableStore.create(base, store0, slab_shards=3)
        snap = str(tmp_path / "snap")
        shutil.copytree(base, snap)
        return store0, base, snap, x, oracle

    def test_demote_writeback_crash_at_every_step(self, tmp_path):
        store0, base, snap, x, oracle = self._fleet_on_disk(tmp_path)
        victim = store0.user_ids[0]
        victim_bytes = store0._deltas[victim].to_bytes()

        def op(on_step):
            durable = DurableStore.open(base)
            store = durable.load_store(lazy=True, device=CPU)
            mgr = attach_residency(
                store, durable, budget_bytes=10**9, on_step=on_step
            )
            store.add_delta(victim, UserDelta.from_bytes(victim_bytes))
            assert mgr.demote(victim)
            assert np.array_equal(store.predict(victim, x), oracle[victim])

        steps = record_steps(op)
        assert steps, "writeback produced no commit steps"
        assert steps[-2:] == ["manifest", "gc"]
        for i, name in enumerate(steps):
            shutil.rmtree(base)
            shutil.copytree(snap, base)
            with pytest.raises(InjectedCrash):
                op(CrashSchedule(fail_at=(i,)))
            recovered = DurableStore.open(base).load_store(lazy=False,
                                                           device=CPU)
            assert sorted(recovered.user_ids) == sorted(oracle)
            for u, want in oracle.items():
                assert np.array_equal(recovered.predict(u, x), want), (
                    i, name, u,
                )

    def test_prefetch_behind_corrupt_shard_never_silent(self, tmp_path):
        store0, base, snap, x, oracle = self._fleet_on_disk(tmp_path)
        victim = store0.user_ids[0]
        durable = DurableStore.open(base)
        store = durable.load_store(lazy=True, device=CPU)
        mgr = attach_residency(store, durable, budget_bytes=10**9)
        pf = Prefetcher(mgr, background=False)
        entry = durable.shard_for_user(victim)
        path, off, length = durable.shard_location(entry.shard_id)
        DiskFaults().corrupt_region(path, off, min(length, 16))

        pf.request([victim])
        mgr.absorb_staged()
        st_ = mgr.stats()
        assert st_["prefetch_errors"] == 1 and st_["prefetch_staged"] == 0
        assert isinstance(dict.get(store._deltas, victim), _LazyShard)
        with pytest.raises(IntegrityError):
            store.predict(victim, x)
        assert durable.read_shard(entry.shard_id, repair=True)
        assert pf.request([victim]) == 1
        assert mgr.absorb_staged() == 1
        assert np.array_equal(store.predict(victim, x), oracle[victim])
        assert mgr.stats()["prefetch_hits"] == 1
        pf.close()

    def test_streaming_build_crash_leaves_whole_waves(self, tmp_path):
        fleet = make_synthetic_fleet(
            n_users=6, d=5, n_bins=12, seed=13, n_trees=(3, 5), max_depth=3,
        )
        ref = build_store(fleet, device=CPU)
        rng = np.random.default_rng(5)
        x = rng.integers(0, 12, (6, 5)).astype(np.int32)
        oracle = {u: ref.predict(u, x) for u in ref.user_ids}
        base = str(tmp_path / "stream")
        waves: list[list[str]] = []

        def op(on_step):
            if waves:
                waves.clear()
            shutil.rmtree(base, ignore_errors=True)
            seen: set[str] = set()

            def on_wave(info):
                nonlocal seen
                now = set(DurableStore.open(base)
                          .load_store(lazy=True, device=CPU).user_ids)
                waves.append(sorted(now - seen))
                seen = now

            build_store_streaming(
                fleet, base, wave_users=3, k_max=4, seed=0,
                slab_shards=3, on_wave=on_wave, on_step=on_step, device=CPU,
            )

        steps = record_steps(op)
        assert len(waves) == 2 and all(len(w) == 3 for w in waves)
        prefixes = [set()]
        for w in waves:
            prefixes.append(prefixes[-1] | set(w))
        for i in range(len(steps)):
            with pytest.raises(InjectedCrash):
                op(CrashSchedule(fail_at=(i,)))
            d = DurableStore.open(base)
            try:
                recovered = d.load_store(lazy=False, device=CPU)
                got = set(recovered.user_ids)
            except IntegrityError:
                assert d.manifest.epoch == 0, (i, steps[i])
                got = set()
            assert got in prefixes, (i, steps[i], got)
            for u in got:
                assert np.array_equal(recovered.predict(u, x), oracle[u])
