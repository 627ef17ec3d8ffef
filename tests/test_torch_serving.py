"""Single-forest serving in the port against the JAX reference session and
``predict_compressed``: engines, multi-request batches, the plan cache,
arena eviction, ``serve_safe`` degradation, and the parts that wait for
later slices.  The port runs with ``device="cpu"``; the reference with
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
from repro_torch.runtime.chaos import TransientError, TransientFaults
from repro_torch.serving import ForestServer, SingleForestStore
from repro_torch.serving.plan import choose_engine
from repro_torch.store import ForestStore, TileArena, build_store

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


@pytest.mark.parametrize("engine", [None, "pipelined", "simple"])
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


def test_parts_of_later_slices_raise_not_implemented():
    _f, _ref, comp = forest_pair("classification")
    server = ForestServer.from_forest(comp, device=CPU)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        server.predict(rows(12), engine="sharded")
    for make in (lambda: ForestStore(None), lambda: build_store({}),
                 lambda: ForestStore.from_bytes(b"")):
        with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
            make()


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
