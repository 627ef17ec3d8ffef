"""Serving in the port against the JAX reference session and
``predict_compressed``: single-forest sessions (engines, multi-request
batches, the plan cache, arena eviction, ``serve_safe`` degradation), the
fleet session over a ``ForestStore`` (the reference's
``tests/test_serving.py`` and the ``serve_safe`` cases of
``tests/test_chaos.py``, ported), and the parts that wait for later
slices.  The port runs with ``device="cpu"``; the reference with
``interpret=True``."""
import functools
import types

import numpy as np
import pytest
import torch

from conftest import random_forest
from repro.core.forest_codec import CompressedForest as RefCompressed
from repro.runtime.chaos import TransientFaults as RefTransientFaults
from repro.serving import ForestServer as RefServer
from repro.serving.plan import choose_engine as ref_choose_engine
from repro.store.arena import TileArena as RefArena
from repro_torch.convert import compressed_from_bytes, forest_from_arrays
from repro_torch.core.compressed_predict import predict_compressed
from repro_torch.core.forest_codec import compress_forest
from repro_torch.core.lossy import LossyConfig
from repro_torch.runtime.chaos import (
    TransientError,
    TransientFaults,
    poison_user,
)
from repro_torch.serving import ForestServer, SingleForestStore
from repro_torch.serving.plan import choose_engine
from repro_torch.store import TileArena, build_store, make_synthetic_fleet

CPU = "cpu"


@functools.lru_cache(maxsize=None)
def forest_pair(task, seed=13, n_trees=9, max_depth=5):
    """(forest, the reference's decode of the port's RFS1 bytes, the
    port's decode of the same bytes) — both sessions serve one frame."""
    n_classes = 3 if task == "classification" else 2
    f = random_forest(seed=seed, n_trees=n_trees, max_depth=max_depth,
                      task=task, n_classes=n_classes)
    port_forest = forest_from_arrays(f.trees, f.meta, f.fit_values)
    blob = compress_forest(port_forest, device=CPU).to_bytes()
    return f, RefCompressed.from_bytes(blob), compressed_from_bytes(blob)


def assert_matches(got, want, task):
    assert got.dtype == np.float64 and got.shape == want.shape
    if task == "classification":
        np.testing.assert_array_equal(got, want)  # integer votes: exact
    else:  # float32 device sums, as tests/test_serving.py holds them
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def rows(seed, n=48, d=5):
    return np.random.default_rng(seed).integers(0, 16, (n, d)).astype(np.int32)


@pytest.mark.parametrize("engine", [None, "pipelined", "simple", "sharded"])
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_from_forest_matches_reference_and_oracle(task, engine):
    _f, ref_comp, comp = forest_pair(task)
    x = rows(1)
    oracle = predict_compressed(comp, x, device=CPU)
    got = ForestServer.from_forest(comp, device=CPU).predict(
        x, engine=engine, block_trees=4
    )
    assert_matches(got, oracle, task)
    want = RefServer.from_forest(ref_comp, interpret=True).predict(
        x, engine=engine, block_trees=4
    )
    assert_matches(got, want, task)


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_from_plain_forest_compresses_on_the_way_in(task):
    f, _ref, comp = forest_pair(task)
    port_forest = forest_from_arrays(f.trees, f.meta, f.fit_values)
    server = ForestServer.from_forest(port_forest, device=CPU)
    assert server.store.hydrate("forest").to_bytes() == comp.to_bytes()
    x = rows(2)
    assert_matches(server.predict(x), predict_compressed(comp, x, device=CPU),
                   task)


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_multi_request_serve_and_plan_cache(task):
    _f, ref_comp, comp = forest_pair(task)
    server = ForestServer.from_forest(comp, device=CPU)
    ref_server = RefServer.from_forest(ref_comp, interpret=True)
    xs = [rows(s, n) for s, n in ((3, 5), (4, 17), (5, 1), (6, 9))]
    requests = [("forest", x) for x in xs]
    for _ in range(2):  # second pass: plan and pack come from the cache
        preds = server.serve(requests)
    want = ref_server.serve(requests)
    for x, p, w in zip(xs, preds, want):
        assert_matches(p, predict_compressed(comp, x, device=CPU), task)
        assert_matches(p, w, task)
    stats = server.stats()["plan_cache"]
    assert stats["plan_hits"] == 1 and stats["pack_hits"] == 1
    assert server.plan(requests) is server.plan([("forest", 5), ("forest", 17),
                                                 ("forest", 1), ("forest", 9)])
    assert server.serve([]) == []


def test_stats_surface_matches_reference():
    _f, ref_comp, comp = forest_pair("classification")
    x = rows(7)
    server = ForestServer.from_forest(comp, device=CPU)
    ref_server = RefServer.from_forest(ref_comp, interpret=True)
    server.predict(x)
    ref_server.predict(x)
    got, want = server.stats(), ref_server.stats()
    assert got.keys() == want.keys()
    assert got["health"].keys() == want["health"].keys()
    assert got["arena"] == want["arena"]
    assert got["tile_cache"] == want["tile_cache"]
    assert got["engine_counts"] == want["engine_counts"] == {"pipelined": 1}


def test_small_arena_capacity_still_serves_exactly():
    """A working set larger than the arena's capacity grows past it (it
    cannot evict the batch's own pinned user) and stays exact."""
    _f, ref_comp, comp = forest_pair("regression")
    x = rows(8)
    server = ForestServer.from_forest(
        comp, arena_capacity_trees=4, tile_cache_trees=4, device=CPU
    )
    ref_server = RefServer.from_forest(
        ref_comp, arena_capacity_trees=4, tile_cache_trees=4, interpret=True
    )
    assert_matches(server.predict(x), ref_server.predict(x), "regression")
    assert server.stats()["arena"] == ref_server.stats()["arena"]
    assert server.stats()["tile_cache"] == ref_server.stats()["tile_cache"]


def _arena_tiles(rng, t, depth, n_bins=9, d=5):
    h = (1 << (depth + 1)) - 1
    feat = rng.integers(0, d, (t, h)).astype(np.int32)
    thr = rng.integers(0, n_bins, (t, h)).astype(np.int32)
    fit = rng.normal(size=(t, h)).astype(np.float32)
    inter = rng.random((t, h)) < 0.5
    return [(feat, thr, fit, inter)]


def test_arena_eviction_and_gathers_match_reference():
    """Drive both arenas through the same admissions: GreedyDual
    eviction, lazy compaction, width growth and gathers agree."""
    rng = np.random.default_rng(29)
    users = {f"u{i}": (_arena_tiles(rng, 3 + i % 4, 2 + i % 3), 2 + i % 3)
             for i in range(7)}
    port = TileArena(5, 16, capacity_trees=12, device=CPU)
    ref = RefArena(5, 16, capacity_trees=12)
    steps = ["u0", "u1", "u2", "u0", "u3", "u4", "u1", "u5", "u6", "u2"]
    for u in steps:
        for arena in (port, ref):
            if u not in arena:
                tiles, depth = users[u]
                arena.admit(u, tiles, depth)
        assert port.stats() == ref.stats()
        assert sorted(port._runs) == sorted(ref._runs)
        resident = sorted(port._runs)
        code, fit, tseg, counts = port.gather(resident, block_trees=4)
        rcode, rfit, rtseg, rcounts = ref.gather(resident, block_trees=4)
        np.testing.assert_array_equal(code.numpy(), np.asarray(rcode))
        np.testing.assert_array_equal(fit.numpy(), np.asarray(rfit))
        np.testing.assert_array_equal(tseg, rtseg)
        np.testing.assert_array_equal(counts, rcounts)
    assert port.evictions > 0 and port.evictions == ref.evictions
    port.invalidate("u2")
    ref.invalidate("u2")
    assert port.stats() == ref.stats()
    assert port.run_token("u2") is None


@pytest.mark.parametrize("fail_first,degraded", [(1, False), (10, True)])
def test_serve_safe_retries_then_degrades(fail_first, degraded):
    _f, ref_comp, comp = forest_pair("classification")
    x = rows(9)
    server = ForestServer.from_forest(
        comp, retry_backoff_s=0.0, max_retries=2, device=CPU
    )
    ref_server = RefServer.from_forest(
        ref_comp, retry_backoff_s=0.0, max_retries=2, interpret=True
    )
    server.store.arena.admission_fault = TransientFaults(fail_first)
    ref_server.store.arena.admission_fault = RefTransientFaults(fail_first)
    (got,) = server.serve_safe([("forest", x)])
    (want,) = ref_server.serve_safe([("forest", x)])
    assert got.status == want.status == "ok"
    assert got.degraded == want.degraded == degraded
    assert_matches(got.prediction, want.prediction, "classification")
    assert_matches(got.prediction, predict_compressed(comp, x, device=CPU),
                   "classification")
    health, ref_health = server.stats()["health"], ref_server.stats()["health"]
    for key in ("transient_retries", "degraded_batches", "n_quarantined"):
        assert health[key] == ref_health[key]
    if degraded:
        assert server.engine_counts["simple"] == 1


def test_serve_raises_transient_faults_without_serve_safe():
    _f, _ref, comp = forest_pair("classification")
    server = ForestServer.from_forest(comp, device=CPU)
    server.store.arena.admission_fault = TransientFaults(1)
    with pytest.raises(TransientError):
        server.predict(rows(10))


def test_single_forest_store_errors():
    _f, _ref, comp = forest_pair("regression")
    store = SingleForestStore(comp, device=CPU)
    with pytest.raises(KeyError):
        store.n_trees("someone-else")
    with pytest.raises(TypeError):
        store.add_user("u", None)
    with pytest.raises(TypeError):
        store.to_bytes()
    assert store.drift_stats() is None
    server = ForestServer(store, device=CPU)
    with pytest.raises(KeyError):
        server.predict(rows(11), user_id="someone-else")


def test_engine_choice_matches_reference_on_one_device():
    seg = np.array([5, 7])
    for arena in (None, object()):
        store = types.SimpleNamespace(arena=arena)
        got = choose_engine(store, seg, 100)
        want = ref_choose_engine(store, seg, 100)
        assert (got.name, got.block_trees, got.block_obs) == (
            want.name, want.block_trees, want.block_obs
        )
    with pytest.raises(ValueError, match="fused tile arena"):
        choose_engine(types.SimpleNamespace(arena=None), seg, 10,
                      engine="pipelined")
    with pytest.raises(ValueError, match="unknown serving engine"):
        choose_engine(types.SimpleNamespace(arena=object()), seg, 10,
                      engine="bogus")


def test_server_rejects_a_store_on_another_device():
    _f, _ref, comp = forest_pair("classification")
    store = SingleForestStore(comp, device=CPU)
    store.device = torch.device("meta")
    with pytest.raises(ValueError, match="store lives on"):
        ForestServer(store, device=CPU)


# ---------------------------------------------------------------------------
# the fleet session (the reference's tests/test_serving.py, ported)
# ---------------------------------------------------------------------------


def small_fleet(task="classification", n_users=6, seed=0):
    return make_synthetic_fleet(
        n_users, task=task, n_trees=(4, 8), max_depth=4, seed=seed
    )


def fleet_requests(store, rng, n_requests=6, n_rows=20):
    users = store.user_ids
    d = store.shared.n_features
    return [
        (users[i % len(users)],
         rng.integers(0, 12, (n_rows, d)).astype(np.int32))
        for i in range(n_requests)
    ]


def assert_matches_store(store, requests, preds, task):
    for (u, x), p in zip(requests, preds):
        assert_matches(p, store.predict(u, x), task)


def test_plan_fields_and_signature(rng):
    store = build_store(small_fleet(n_users=4), device=CPU)
    server = ForestServer(store, device=CPU)
    u = store.user_ids
    requests = [(u[1], rng.integers(0, 12, (9, 8)).astype(np.int32)),
                (u[0], rng.integers(0, 12, (5, 8)).astype(np.int32)),
                (u[1], rng.integers(0, 12, (3, 8)).astype(np.int32))]
    plan = server.plan(requests)
    assert plan.users == (u[1], u[0])  # first-appearance order
    assert plan.row_counts == (9, 5, 3)
    assert plan.n_rows == 17
    assert plan.row_slices == (slice(0, 9), slice(9, 14), slice(14, 17))
    assert plan.engine.name == "pipelined" and plan.engine.reason
    assert plan.t_pad % plan.engine.block_trees == 0
    hash(plan.signature)


def test_plan_from_row_counts_only(rng):
    store = build_store(small_fleet(n_users=3), device=CPU)
    server = ForestServer(store, device=CPU)
    u = store.user_ids
    x = rng.integers(0, 12, (7, 8)).astype(np.int32)
    assert server.plan([(u[0], x), (u[1], x)]) is server.plan(
        [(u[0], 7), (u[1], 7)]
    )


def test_plan_memoized_until_store_changes(rng):
    fleet = small_fleet(n_users=3)
    store = build_store(fleet, device=CPU)
    server = ForestServer(store, device=CPU)
    reqs = fleet_requests(store, rng, 3)
    p1 = server.plan(reqs)
    assert server.plan(reqs) is p1
    assert server.plan_cache.plan_hits == 1
    store.add_user(store.user_ids[0], fleet[store.user_ids[0]])
    assert server.plan(reqs) is not p1
    assert server.plan_cache.invalidations >= 1


def test_cost_model_simple_when_no_arena(rng):
    store = build_store(small_fleet(n_users=3), device=CPU)
    store.arena = None  # a schema-incompatible store
    server = ForestServer(store, device=CPU)
    reqs = fleet_requests(store, rng, 3)
    plan = server.plan(reqs)
    assert plan.engine.name == "simple"
    preds = server.execute(plan, [x for _, x in reqs])
    assert_matches_store(store, reqs, preds, "classification")
    for engine in ("pipelined", "sharded"):
        with pytest.raises(ValueError, match="fused tile arena"):
            server.plan(reqs, engine=engine)
    with pytest.raises(ValueError, match="engine"):
        server.plan(reqs, engine="nope")


def test_pack_cache_reused_for_fresh_rows(rng):
    store = build_store(small_fleet(n_users=4), device=CPU)
    server = ForestServer(store, device=CPU)
    u = store.user_ids
    shape = ((u[0], 11), (u[2], 6))
    server.serve([(v, rng.integers(0, 12, (n, 8)).astype(np.int32))
                  for v, n in shape])
    reqs2 = [(v, rng.integers(0, 12, (n, 8)).astype(np.int32))
             for v, n in shape]
    preds = server.serve(reqs2)
    assert server.plan_cache.pack_hits >= 1
    assert_matches_store(store, reqs2, preds, "classification")


@pytest.mark.parametrize("engine", ["pipelined", "simple", "sharded"])
def test_empty_and_zero_row_requests(rng, engine):
    store = build_store(small_fleet(n_users=3), device=CPU)
    server = ForestServer(store, device=CPU, devices=[CPU] * 2)
    assert server.serve([]) == []
    u = store.user_ids
    x = rng.integers(0, 12, (10, 8)).astype(np.int32)
    empty = np.zeros((0, 8), np.int32)
    preds = server.serve([(u[0], x), (u[1], empty), (u[2], x)],
                         engine=engine)
    assert preds[1].shape == (0,)
    assert np.array_equal(preds[0], store.predict(u[0], x))
    assert np.array_equal(preds[2], store.predict(u[2], x))
    only_empty = server.serve([(u[1], empty)], engine=engine)
    assert only_empty[0].shape == (0,)


def test_execute_validates_rows_and_rejects_stale_plans(rng):
    fleet = small_fleet(n_users=2)
    store = build_store(fleet, device=CPU)
    server = ForestServer(store, device=CPU)
    u = store.user_ids
    x = rng.integers(0, 12, (8, 8)).astype(np.int32)
    plan = server.plan([(u[0], x)])
    with pytest.raises(ValueError, match="rows"):
        server.execute(plan, [x[:5]])
    with pytest.raises(ValueError, match="requests"):
        server.execute(plan, [x, x])
    store.add_user(u[0], fleet[u[0]])
    with pytest.raises(ValueError, match="stale"):
        server.execute(plan, [x])


@pytest.mark.parametrize("engine", ["pipelined", "sharded"])
def test_arena_eviction_invalidates_cached_pack(rng, engine):
    store = build_store(small_fleet(n_users=4), device=CPU)
    server = ForestServer(store, device=CPU, devices=[CPU] * 2)
    u = store.user_ids
    x = rng.integers(0, 12, (9, 8)).astype(np.int32)
    reqs = [(u[0], x), (u[1], x)]
    server.serve(reqs, engine=engine)
    epoch0 = store.arena.epoch
    store.arena.invalidate(u[0])
    assert store.arena.epoch > epoch0
    preds = server.serve(reqs, engine=engine)  # re-gathered, not stale
    assert server.plan_cache.invalidations >= 1
    assert_matches_store(store, reqs, preds, "classification")


def test_cold_admission_of_unrelated_users_keeps_pack(rng):
    store = build_store(small_fleet(n_users=6), device=CPU)
    server = ForestServer(store, device=CPU)
    u = store.user_ids
    x = rng.integers(0, 12, (7, 8)).astype(np.int32)
    reqs_a = [(u[0], x), (u[1], x)]
    server.serve(reqs_a)
    misses0 = server.plan_cache.pack_misses
    hits0 = server.plan_cache.pack_hits
    server.serve([(u[4], x), (u[5], x)])  # unrelated cold admissions
    preds = server.serve(reqs_a)
    assert server.plan_cache.pack_misses == misses0 + 1
    assert server.plan_cache.pack_hits == hits0 + 1
    assert_matches_store(store, reqs_a, preds, "classification")


def test_eviction_invalidates_only_affected_users_packs(rng):
    store = build_store(small_fleet(n_users=6), device=CPU)
    server = ForestServer(store, device=CPU)
    u = store.user_ids
    x = rng.integers(0, 12, (7, 8)).astype(np.int32)
    reqs_a = [(u[0], x), (u[1], x)]
    reqs_b = [(u[2], x), (u[3], x)]
    server.serve(reqs_a)
    server.serve(reqs_b)
    inval0 = server.plan_cache.invalidations
    hits0 = server.plan_cache.pack_hits
    store.arena.invalidate(u[0])
    preds_b = server.serve(reqs_b)  # untouched: pack hit
    preds_a = server.serve(reqs_a)  # touched: re-gathered
    assert server.plan_cache.pack_hits == hits0 + 1
    assert server.plan_cache.invalidations == inval0 + 1
    assert_matches_store(store, reqs_a, preds_a, "classification")
    assert_matches_store(store, reqs_b, preds_b, "classification")


@pytest.mark.parametrize("engine", ["pipelined", "simple", "sharded"])
def test_reregistration_serves_new_forest(rng, engine):
    store = build_store(small_fleet(n_users=3), device=CPU)
    server = ForestServer(store, device=CPU, devices=[CPU] * 2)
    u0 = store.user_ids[0]
    x = rng.integers(0, 12, (25, 8)).astype(np.int32)
    before = server.serve([(u0, x)], engine=engine)[0]
    other = small_fleet(n_users=3, seed=9)
    store.add_user(u0, other[list(other)[0]])
    preds = server.serve([(u0, x)], engine=engine)
    assert np.array_equal(preds[0], store.predict(u0, x))
    assert not np.array_equal(preds[0], before)


def test_pack_hits_on_repeated_batch(rng):
    store = build_store(small_fleet(n_users=4), device=CPU)
    server = ForestServer(store, device=CPU)
    reqs = fleet_requests(store, rng, 4)
    for _ in range(3):
        server.serve(reqs)
    stats = server.plan_cache.stats()
    assert stats["pack_hits"] >= 2 and stats["plan_hits"] >= 2
    assert stats["pack_hit_rate"] > 0


def test_lossy_store_serves_on_its_grid(rng):
    bits = 5
    store = build_store(small_fleet("regression", n_users=5),
                        lossy=LossyConfig(fit_bits=bits), device=CPU)
    rep = store.size_report()["lossy"]
    assert rep["fit_bits"] == bits and rep["grid_levels"] == 1 << bits
    assert len(store.shared.fleet_fit_values) <= 1 << bits
    assert rep["max_abs_error"] <= rep["max_error_bound"] + 1e-12
    assert rep["distortion_bound"] == pytest.approx(rep["step"] ** 2 / 12.0)
    server = ForestServer(store, device=CPU)
    reqs = fleet_requests(store, rng, 3)
    assert_matches_store(store, reqs, server.serve(reqs), "regression")
    assert server.stats()["lossy"] == rep
    lossless = build_store(small_fleet("regression", n_users=5), device=CPU)
    assert lossless.size_report()["lossy"] is None
    assert len(store.shared.fleet_fit_values) < len(
        lossless.shared.fleet_fit_values
    )
    with pytest.raises(ValueError, match="regression"):
        build_store(small_fleet(n_users=2), lossy=LossyConfig(4), device=CPU)


def test_fleet_stats_match_reference(rng):
    """The fleet session's ``stats()`` carries the drift summary; its
    sections equal the reference session's after the same batches."""
    from repro.store import build_store as ref_build_store
    from repro.store import make_synthetic_fleet as ref_fleet

    store = build_store(small_fleet(n_users=4), device=CPU)
    ref_store = ref_build_store(ref_fleet(
        4, task="classification", n_trees=(4, 8), max_depth=4, seed=0
    ))
    server = ForestServer(store, device=CPU)
    ref_server = RefServer(ref_store, interpret=True)
    reqs = fleet_requests(store, rng, 4)
    for _ in range(2):
        server.serve(reqs)
        ref_server.serve(reqs)
    got, want = server.stats(), ref_server.stats()
    assert got.keys() == want.keys()
    for key in ("store", "tile_cache", "arena", "plan_cache",
                "engine_counts", "lossy", "residency"):
        assert got[key] == want[key], key
    assert got["store"]["codebook_generation"] == 1
    assert got["store"]["fallback_user_fraction"] == 0.0
    assert got["health"]["n_quarantined"] == 0
    assert got["health"]["journal"] is None


def test_tile_cache_per_user_counters_reset_on_reregistration(rng):
    store = build_store(small_fleet(n_users=3), device=CPU)
    server = ForestServer(store, device=CPU)
    user = store.user_ids[0]
    reqs = fleet_requests(store, rng, 3)
    reqs = [(user, reqs[0][1])] + reqs
    server.serve(reqs)
    server.serve(reqs)
    before = store.cache.stats()["per_user"][user]
    assert before["hits"] + before["misses"] > 0
    store.add_delta(user, store.delta(user))  # re-register
    assert user not in store.cache.stats()["per_user"]
    server.serve(reqs)
    kept = store.cache.stats()["per_user"][user]
    assert kept["misses"] > 0
    store.cache.invalidate_user(user, reset_stats=False)
    assert store.cache.stats()["per_user"][user] == kept


def test_arena_epoch_tracks_structural_changes(rng):
    store = build_store(small_fleet(n_users=3), device=CPU)
    server = ForestServer(store, device=CPU)
    arena = store.arena
    e0 = arena.epoch
    server.serve(fleet_requests(store, rng, 2))
    e1 = arena.epoch
    assert e1 > e0
    server.serve(fleet_requests(store, rng, 2))
    assert arena.epoch == e1


# ---------------------------------------------------------------------------
# serve_safe over a fleet (the reference's tests/test_chaos.py, ported)
# ---------------------------------------------------------------------------

@pytest.fixture
def fleet_server(rng):
    fleet = make_synthetic_fleet(n_users=4, d=5, n_bins=12, seed=11)
    store = build_store(fleet, device=CPU)
    server = ForestServer(store, retry_backoff_s=0.0, device=CPU)
    reqs = [(u, rng.integers(0, 12, (8, 5)).astype(np.int32))
            for u in store.user_ids]
    return store, server, reqs


@pytest.mark.parametrize("engine", [None, "simple", "sharded"])
def test_quarantine_isolates_bad_user(fleet_server, engine):
    store, server, reqs = fleet_server
    want = server.serve(reqs)
    bad = store.user_ids[1]
    poison_user(store, bad)
    statuses = server.serve_safe(reqs, engine=engine)
    assert [s.user_id for s in statuses] == [u for u, _ in reqs]
    for (u, _), st, w in zip(reqs, statuses, want):
        if u == bad:
            assert st.status == "quarantined" and st.prediction is None
            assert "IntegrityError" in st.detail
        else:
            assert st.status == "ok"
            assert np.array_equal(st.prediction, w)


def test_quarantine_sticky_released_and_counted(fleet_server):
    store, server, reqs = fleet_server
    bad = store.user_ids[0]
    healthy = store.delta(bad)
    poison_user(store, bad)
    server.serve_safe(reqs)
    n = server.integrity_failures
    server.serve_safe(reqs)  # quarantined: not re-probed
    assert server.integrity_failures == n
    assert server.quarantined_users == [bad]
    h = server.stats()["health"]
    assert h["n_quarantined"] == 1 and h["quarantined"][bad]["kind"] == (
        "integrity"
    )
    drift = server.stats()["store"]
    assert drift["n_excluded_users"] == 1
    assert drift["n_users"] == len(store.user_ids) - 1
    store.add_delta(bad, healthy)  # repair bumps the user version
    statuses = server.serve_safe(reqs)
    assert statuses[0].status == "ok" and server.quarantined_users == []
    assert np.array_equal(statuses[0].prediction,
                          store.predict(bad, reqs[0][1]))


def test_transient_admission_retry_then_success(fleet_server):
    store, server, reqs = fleet_server
    for u in store.user_ids:
        store.arena.invalidate(u)
    store.arena.admission_fault = TransientFaults(fail_first=2)
    statuses = server.serve_safe(reqs, engine="pipelined")
    assert server.transient_retries == 2 and server.degraded_batches == 0
    assert all(s.status == "ok" and not s.degraded for s in statuses)


@pytest.mark.parametrize("engine", ["pipelined", "sharded"])
def test_retries_exhausted_degrade_to_simple(fleet_server, engine):
    store, server, reqs = fleet_server
    want = server.serve(reqs, engine="simple")
    for u in store.user_ids:
        store.arena.invalidate(u)
    store.arena.admission_fault = TransientFaults(fail_first=10**6)
    statuses = server.serve_safe(reqs, engine=engine)
    assert server.degraded_batches == 1
    assert server.engine_counts["simple"] == 2
    assert all(s.status == "ok" and s.degraded for s in statuses)
    for st, w in zip(statuses, want):
        assert np.array_equal(st.prediction, w)


def test_serve_safe_empty_batch_and_unknown_user(fleet_server):
    _store, server, _reqs = fleet_server
    assert server.serve_safe([]) == []
    with pytest.raises(KeyError):
        server.serve_safe([("nobody", np.zeros((1, 5), np.int32))])
