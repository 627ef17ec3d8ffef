"""The port's fleet store against the JAX reference on the CPU: shared
codebooks, user deltas, hydrate / reconstruct, RFT1 in both directions,
the drift monitor, the three serving engines over ragged mixed-user
batches (``sharded`` on 1, 2 and 4 CPU devices), the engine cost model,
and K5 (``forest_predict_agg_segmented_sharded``).

The reference runs as its own tests run it (one JAX CPU device, the
Pallas kernels in interpret mode); the port runs on ``device="cpu"``.
Votes are equal; regression sums agree to rtol = atol = 1e-5 (float32
sums in another order); frames are equal byte for byte."""
import functools

import numpy as np
import pytest
import torch

from repro.core.framing import IntegrityError as RefIntegrityError
from repro.core.lossy import LossyConfig as RefLossyConfig
from repro.kernels.tree_predict import ops as ref_ops
from repro.serving import ForestServer as RefServer
from repro.serving.plan import choose_engine as ref_choose_engine
from repro.store import ForestStore as RefStore
from repro.store import build_shared_codebook as ref_build_shared_codebook
from repro.store import build_store as ref_build_store
from repro.store import drift_report as ref_drift_report
from repro.store import encode_user_delta as ref_encode_user_delta
from repro.store import hydrate as ref_hydrate
from repro.store import make_drifted_fleet as ref_drifted_fleet
from repro.store import make_synthetic_fleet as ref_fleet
from repro.store import reconstruct_user as ref_reconstruct_user
from repro_torch.core.framing import IntegrityError, TruncatedFrameError
from repro_torch.core.lossy import LossyConfig
from repro_torch.kernels.tree_predict import ops
from repro_torch.kernels.tree_predict import tree_predict as tp
from repro_torch.serving import ForestServer
from repro_torch.serving.plan import (
    MIN_SHARD_SPEEDUP,
    MIN_SHARD_TREES,
    choose_engine,
)
from repro_torch.store import (
    ForestStore,
    SharedCodebook,
    UserDelta,
    build_shared_codebook,
    build_store,
    drift_report,
    encode_user_delta,
    hydrate,
    make_drifted_fleet,
    make_request_batch,
    make_synthetic_fleet,
    reconstruct_user,
)

CPU = "cpu"
TASKS = ["classification", "regression"]
FLEET_KW = dict(n_trees=(4, 8), max_depth=5)


@functools.lru_cache(maxsize=None)
def fleets(task, n_users=5, seed=0):
    """The same synthetic fleet from each package's generator."""
    kw = dict(task=task, seed=seed, **FLEET_KW)
    return make_synthetic_fleet(n_users, **kw), ref_fleet(n_users, **kw)


@functools.lru_cache(maxsize=None)
def stores(task, bits=None):
    """(port store, reference store) built from one fleet, lossless or
    with ``bits``-bit fleet fit quantization."""
    port_fleet, reference_fleet = fleets(task)
    port = build_store(
        port_fleet, device=CPU,
        lossy=None if bits is None else LossyConfig(fit_bits=bits),
    )
    ref = ref_build_store(
        reference_fleet,
        lossy=None if bits is None else RefLossyConfig(fit_bits=bits),
    )
    return port, ref


def assert_matches(got, want, task):
    assert got.dtype == np.float64 and got.shape == want.shape
    if task == "classification":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def requests_for(store, seed=1, n=7, rows=13):
    """A ragged mixed-user batch: repeated users, a zero-row request."""
    reqs = make_request_batch(store, n, rows, seed=seed)
    rng = np.random.default_rng(seed)
    d = store.shared.n_features
    reqs.append((reqs[0][0], rng.integers(0, 12, (3, d)).astype(np.int32)))
    reqs.append((reqs[1][0], np.zeros((0, d), np.int32)))
    return reqs


# ---------------------------------------------------------------------------
# per-module parity
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("task", TASKS)
def test_fleet_generator_matches_reference(task):
    port_fleet, reference_fleet = fleets(task)
    assert list(port_fleet) == list(reference_fleet)
    for u, f in port_fleet.items():
        r = reference_fleet[u]
        assert f.n_trees == r.n_trees
        np.testing.assert_array_equal(f.fit_values, r.fit_values)
        for a, b in zip(f.trees, r.trees):
            np.testing.assert_array_equal(a.feature, b.feature)
            np.testing.assert_array_equal(a.threshold, b.threshold)
            np.testing.assert_array_equal(a.node_fit, b.node_fit)


@pytest.mark.parametrize("task", TASKS)
def test_shared_codebook_bytes_match_reference(task):
    port_fleet, reference_fleet = fleets(task)
    got = build_shared_codebook(list(port_fleet.values()), device=CPU)
    want = ref_build_shared_codebook(list(reference_fleet.values()))
    assert got.to_bytes() == want.to_bytes()
    back = SharedCodebook.from_bytes(want.to_bytes())
    assert back.to_bytes() == want.to_bytes()


@pytest.mark.parametrize("task", TASKS)
def test_user_deltas_hydrate_and_reconstruct_match_reference(task):
    port_fleet, reference_fleet = fleets(task)
    shared = build_shared_codebook(list(port_fleet.values()), device=CPU)
    ref_shared = ref_build_shared_codebook(list(reference_fleet.values()))
    for u, forest in port_fleet.items():
        delta = encode_user_delta(forest, shared, seed=0)
        ref_delta = ref_encode_user_delta(reference_fleet[u], ref_shared)
        assert delta.to_bytes() == ref_delta.to_bytes(), u
        assert UserDelta.from_bytes(ref_delta.to_bytes()).to_bytes() == (
            ref_delta.to_bytes()
        )
        assert hydrate(delta, shared).to_bytes() == (
            ref_hydrate(ref_delta, ref_shared).to_bytes()
        )
        assert reconstruct_user(delta, shared).equals(forest)
        ref_back = ref_reconstruct_user(ref_delta, ref_shared)
        np.testing.assert_array_equal(
            reconstruct_user(delta, shared).fit_values, ref_back.fit_values
        )


@pytest.mark.parametrize(
    "task,bits", [("classification", None), ("regression", None),
                  ("regression", 5)],
)
def test_build_store_bytes_and_report_match_reference(task, bits):
    port, ref = stores(task, bits)
    assert port.to_bytes() == ref.to_bytes()
    got, want = port.size_report(), ref.size_report()
    assert got == want
    if bits is not None:
        assert got["lossy"]["grid_levels"] == 1 << bits
        assert len(port.shared.fleet_fit_values) <= 1 << bits


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_rft1_cross_decoding(task, direction):
    """An RFT1 store written by one package is read by the other: equal
    bytes back and equal predictions for every user."""
    port, ref = stores(task)
    x = np.random.default_rng(3).integers(0, 12, (21, 8)).astype(np.int32)
    if direction == "reference_to_port":
        blob = ref.to_bytes()
        loaded = ForestStore.from_bytes(blob, device=CPU)
        assert loaded.to_bytes() == blob
        for u in ref.user_ids:
            assert_matches(loaded.predict(u, x), ref.predict(u, x), task)
            assert loaded.reconstruct(u).equals(port.reconstruct(u))
    else:
        blob = port.to_bytes()
        loaded = RefStore.from_bytes(blob)
        assert loaded.to_bytes() == blob
        for u in port.user_ids:
            assert_matches(port.predict(u, x), loaded.predict(u, x), task)


def test_rft1_integrity_errors_are_typed():
    port, _ref = stores("classification")
    blob = port.to_bytes()
    bad = bytearray(blob)
    bad[len(blob) // 2] ^= 0x10
    with pytest.raises(IntegrityError):
        ForestStore.from_bytes(bytes(bad), device=CPU)
    with pytest.raises(RefIntegrityError):
        RefStore.from_bytes(bytes(bad))
    with pytest.raises((IntegrityError, TruncatedFrameError)):
        ForestStore.from_bytes(blob[:40], device=CPU)


def test_store_registry_and_generations():
    port, ref = stores("classification")
    assert port.user_ids == ref.user_ids
    u = port.user_ids[0]
    assert port.n_trees(u) == ref.n_trees(u)
    assert port.max_depth(u) == ref.max_depth(u)
    assert port.generations == ref.generations == [1]
    assert port.codebook_for(1) is port.shared
    with pytest.raises(KeyError, match="not resident"):
        port.codebook_for(7)
    assert port.residency is None and port.journal is None
    assert port.device == torch.device("cpu")


@pytest.mark.parametrize("task", TASKS)
def test_drift_report_matches_reference_with_late_users(task):
    """Late users onboarded against a frozen codebook carry user-local
    fallback clusters; both packages account for them alike."""
    kw = dict(task=task, n_trees=(3, 5), max_depth=4, seed=2)
    init, late = make_drifted_fleet(8, **kw)
    ref_init, ref_late = ref_drifted_fleet(8, **kw)
    port = build_store(init, device=CPU)
    ref = ref_build_store(ref_init)
    for u in late:
        port.add_user(u, late[u])
        ref.add_user(u, ref_late[u])
    assert port.to_bytes() == ref.to_bytes()
    got, want = drift_report(port), ref_drift_report(ref)
    assert got == want
    assert got["n_fallback_users"] > 0
    excl = [next(iter(late))]
    assert drift_report(port, exclude=excl) == ref_drift_report(
        ref, exclude=excl
    )
    assert port.drift_stats(exclude=tuple(excl)) == ref.drift_stats(
        exclude=tuple(excl)
    )


# ---------------------------------------------------------------------------
# serving engines against the reference session and the oracle
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def reference_serve(task, engine):
    _port, ref = stores(task)
    reqs = requests_for(ref)
    return RefServer(ref, interpret=True).serve(reqs, engine=engine)


@pytest.mark.parametrize("task", TASKS)
@pytest.mark.parametrize(
    "engine,shards",
    [("pipelined", None), ("simple", None), ("sharded", 1), ("sharded", 2),
     ("sharded", 4)],
)
def test_engines_match_reference_session_and_oracle(task, engine, shards):
    port, _ref = stores(task)
    reqs = requests_for(port)
    devices = None if shards is None else [CPU] * shards
    server = ForestServer(port, device=CPU, devices=devices)
    preds = server.serve(reqs, engine=engine)
    # the reference shards over the one device JAX has here
    want = reference_serve(task, engine)
    for (u, x), p, w in zip(reqs, preds, want):
        assert_matches(p, port.predict(u, x), task)
        assert_matches(p, w, task)
    assert server.engine_counts[engine] == 1
    if engine == "sharded":
        pack = server._gathered_pack(server.plan(reqs, engine=engine))
        assert list(pack.code) == [torch.device(CPU)]  # one stack a device
        assert only(pack.code).shape[0] == shards
        assert only(pack.fit).shape == only(pack.code).shape


@pytest.mark.parametrize("task", TASKS)
def test_sharded_engine_launch_counts(task, monkeypatch):
    """One sharded batch runs K1's plain version once per shard, under
    one K5 call."""
    port, _ref = stores(task)
    calls = {"k1": 0, "k5": 0}
    k1, k5 = tp._seg_packed_plain, tp._seg_sharded_plain

    def count_k1(*a):
        calls["k1"] += 1
        return k1(*a)

    def count_k5(*a):
        calls["k5"] += 1
        return k5(*a)

    monkeypatch.setattr(tp, "_seg_packed_plain", count_k1)
    monkeypatch.setattr(tp, "_seg_sharded_plain", count_k5)
    server = ForestServer(port, device=CPU, devices=[CPU] * 4)
    server.serve(requests_for(port), engine="sharded")
    assert calls == {"k1": 4, "k5": 1}


def test_session_device_list():
    port, _ref = stores("classification")
    assert ForestServer(port, device=CPU).devices == (torch.device("cpu"),)
    server = ForestServer(port, device=CPU, devices=["cpu", "cpu"])
    assert server.devices == (torch.device("cpu"),) * 2
    with pytest.raises(ValueError, match="at least one"):
        ForestServer(port, device=CPU, devices=[])
    with pytest.raises(ValueError, match="unsupported device"):
        ForestServer(port, device=CPU, devices=["cpu", "meta"])


def test_default_session_on_many_users_picks_sharded_only_with_devices():
    """With the default one-device list the cost model resolves to
    ``pipelined``, as the reference does on one device; four listed
    devices and an even enough batch resolve to ``sharded``."""
    fleet = make_synthetic_fleet(12, n_trees=(8, 12), max_depth=3, seed=4)
    store = build_store(fleet, device=CPU)
    reqs = [(u, np.zeros((2, 8), np.int32)) for u in store.user_ids]
    one = ForestServer(store, device=CPU).plan(reqs)
    assert (one.engine.name, one.engine.reason) == ("pipelined",
                                                     "single device")
    four = ForestServer(store, device=CPU, devices=[CPU] * 4).plan(reqs)
    assert four.engine.name == "sharded"
    assert four.engine.reason.startswith("4 devices, predicted")


# ---------------------------------------------------------------------------
# the cost model and the bin-pack
# ---------------------------------------------------------------------------

class _Store:
    def __init__(self, arena):
        self.arena = arena


@pytest.mark.parametrize(
    "seg",
    [[5, 7], [100, 1, 1], [10] * 8, [40, 30, 20, 10], [], [63], [64, 64]],
)
def test_choose_engine_on_one_device_matches_reference(seg):
    seg = np.array(seg, np.int64)
    for arena in (None, object()):
        got = choose_engine(_Store(arena), seg, 100)
        want = ref_choose_engine(_Store(arena), seg, 100)
        assert (got.name, got.block_trees, got.block_obs, got.reason) == (
            want.name, want.block_trees, want.block_obs, want.reason
        )


@pytest.mark.parametrize(
    "seg,expect",
    [
        ([10, 10, 10], "floor"),  # 30 trees: below MIN_SHARD_TREES
        ([200, 1, 1, 1], "imbalance"),  # one user dominates
        ([20] * 8, "sharded"),  # even: 4x
        ([60, 50, 40, 30, 20, 10], "sharded"),
        ([64], "imbalance"),  # at the floor, one user
    ],
)
def test_choose_engine_on_four_devices_follows_the_bin_pack(seg, expect):
    seg = np.array(seg, np.int64)
    got = choose_engine(_Store(object()), seg, 100, n_devices=4)
    speedup = ops.estimate_shard_speedup(seg, 4)
    assert speedup == ref_ops.estimate_shard_speedup(seg, 4)
    if expect == "floor":
        assert seg.sum() < MIN_SHARD_TREES and got.name == "pipelined"
        assert "sharding floor" in got.reason
    elif expect == "imbalance":
        assert speedup < MIN_SHARD_SPEEDUP and got.name == "pipelined"
        assert "imbalance" in got.reason
    else:
        assert speedup >= MIN_SHARD_SPEEDUP and got.name == "sharded"
        assert got.reason == f"4 devices, predicted {speedup:.2f}x from " \
            "the tree bin-pack"
    # an explicit engine is honoured whatever the device count
    assert choose_engine(_Store(object()), seg, 100, engine="sharded",
                         n_devices=1).name == "sharded"


@pytest.mark.parametrize("n_shards", [1, 2, 3, 4, 7])
def test_bin_pack_matches_reference(n_shards):
    rng = np.random.default_rng(n_shards)
    for _ in range(5):
        seg = rng.integers(0, 30, rng.integers(0, 12))
        assert ops.partition_segments_by_load(seg, n_shards) == (
            ref_ops.partition_segments_by_load(seg, n_shards)
        )
        assert ops.estimate_shard_speedup(seg, n_shards) == (
            ref_ops.estimate_shard_speedup(seg, n_shards)
        )


# ---------------------------------------------------------------------------
# K5
# ---------------------------------------------------------------------------

def only(tiles):
    """The one device's stack of a pack's shards (``ShardedPack.code`` or
    ``.fit``)."""
    (stack,) = tiles.values()
    return stack


def sharded_inputs(task, n_shards, seed=5):
    """K5's inputs from a real pack: the store's users bin-packed onto
    ``n_shards`` shards, rows sorted by segment."""
    port, _ref = stores(task)
    reqs = requests_for(port, seed=seed)
    server = ForestServer(port, device=CPU, devices=[CPU] * n_shards)
    plan = server.plan(reqs, engine="sharded")
    pack = server._gathered_pack(plan)
    from repro_torch.serving.pack import concat_rows

    xb = concat_rows([x for _, x in reqs])[plan.order]
    c = port.shared.n_classes if task == "classification" else 0
    return port, plan, pack, xb, c


@pytest.mark.parametrize("task", TASKS)
def test_sharded_kernel_matches_reference_and_single_device(task):
    """K5 at S = 1 equals the reference's K5 (one JAX device, interpret
    mode); at S = 2 and 4 it equals S = 1 (votes) or agrees to 1e-5."""
    port, plan, pack, xb, c = sharded_inputs(task, 1)
    kw = dict(n_classes=c, block_trees=plan.engine.block_trees,
              block_obs=pack.block_obs)
    one = ops.forest_predict_agg_segmented_sharded(
        xb, plan.oseg_s, pack.code, pack.fit, pack.tree_seg, pack.chunk_lo,
        pack.chunk_hi, pack.max_depth, port.arena.tb2, devices=[CPU], **kw,
    ).numpy()
    want = np.asarray(ref_ops.forest_predict_agg_segmented_sharded(
        xb, plan.oseg_s, only(pack.code).numpy(),
        only(pack.fit).numpy(), pack.tree_seg,
        pack.chunk_lo, pack.chunk_hi, pack.max_depth, port.arena.tb2,
        interpret=True, **kw,
    ))
    assert one.shape == want.shape
    if task == "classification":
        np.testing.assert_array_equal(one, want)
    else:
        np.testing.assert_allclose(one, want, rtol=1e-5, atol=1e-5)
    for n_shards in (2, 4):
        _p, plan_s, pack_s, xb_s, _c = sharded_inputs(task, n_shards)
        got = ops.forest_predict_agg_segmented_sharded(
            xb_s, plan_s.oseg_s, only(pack_s.code),
            only(pack_s.fit), pack_s.tree_seg, pack_s.chunk_lo,
            pack_s.chunk_hi, pack_s.max_depth, port.arena.tb2,
            devices=[CPU] * n_shards, **kw,
        ).numpy()
        if task == "classification":
            np.testing.assert_array_equal(got, one)
        else:
            np.testing.assert_allclose(got, one, rtol=1e-5, atol=1e-5)


def test_sharded_kernel_sums_shards_in_order():
    """The plain version is K1's plain version per shard, summed on the
    first shard's device in shard order."""
    port, plan, pack, xb, c = sharded_inputs("regression", 3)
    args = [
        [torch.as_tensor(xb)] * 3, [torch.as_tensor(plan.oseg_s)] * 3,
        list(only(pack.code)), list(only(pack.fit)),
        [torch.as_tensor(a) for a in pack.tree_seg],
        [torch.as_tensor(a) for a in pack.chunk_lo],
        [torch.as_tensor(a) for a in pack.chunk_hi],
    ]
    scalars = (pack.max_depth, port.arena.tb2, c, plan.engine.block_trees,
               pack.block_obs)
    got = tp._seg_sharded_plain(*args, *scalars)
    parts = [tp._seg_packed_plain(*shard, *scalars) for shard in zip(*args)]
    assert torch.equal(got, (parts[0] + parts[1]) + parts[2])


def test_sharded_kernel_guards():
    port, plan, pack, xb, c = sharded_inputs("classification", 2)
    base = (plan.oseg_s, only(pack.code), only(pack.fit),
            pack.tree_seg, pack.chunk_lo, pack.chunk_hi, pack.max_depth,
            port.arena.tb2)
    with pytest.raises(ValueError, match="2 tree shards but only 1 devices"):
        ops.forest_predict_agg_segmented_sharded(xb, *base, n_classes=c)
    with pytest.raises(ValueError, match="2 tree shards but only 1 devices"):
        ops.forest_predict_agg_segmented_sharded(
            xb, *base, n_classes=c, devices=[CPU]
        )
    with pytest.raises(ValueError, match="2\\*\\*24"):
        ops.forest_predict_agg_segmented_sharded(
            xb, *base, n_classes=1 << 24, devices=[CPU] * 2
        )
    big = xb.copy()
    big[0, 0] = 1 << 24
    with pytest.raises(ValueError, match="xb contains values >= 2\\*\\*24"):
        ops.forest_predict_agg_segmented_sharded(
            big, *base, n_classes=c, devices=[CPU] * 2
        )
    with pytest.raises(ValueError, match="multiple of block_trees"):
        ops.forest_predict_agg_segmented_sharded(
            xb, *base, n_classes=c, block_trees=7, devices=[CPU] * 2
        )
    empty = ops.forest_predict_agg_segmented_sharded(
        xb[:0], plan.oseg_s[:0], *base[1:], n_classes=c, devices=[CPU] * 2
    )
    assert empty.shape == (0, c)


def test_sharded_pack_stacks_a_devices_shards_for_one_launch():
    """K5 launches once a device over that device's shards stacked: the
    sharded engine's pack holds each device's shards as one (k, T_pad, H)
    stack there, in shard order, and the entry's other forms (one stacked
    array, a sequence of shards) give the same answer; shards of unequal
    ``T_pad`` are stacked each padded to the longest with the fill (code
    and fit 0, tree_seg -1)."""
    port, plan, pack, xb, c = sharded_inputs("regression", 4)
    assert list(pack.code) == list(pack.fit) == [torch.device(CPU)]
    assert only(pack.code).shape[0] == 4
    scalars = (pack.max_depth, port.arena.tb2)
    kw = dict(n_classes=c, block_trees=plan.engine.block_trees,
              block_obs=pack.block_obs, devices=[CPU] * 4)
    rest = (pack.tree_seg, pack.chunk_lo, pack.chunk_hi, *scalars)
    want = ops.forest_predict_agg_segmented_sharded(
        xb, plan.oseg_s, pack.code, pack.fit, *rest, **kw)
    for code, fit in ((only(pack.code).numpy(), only(pack.fit).numpy()),
                      (list(only(pack.code)), list(only(pack.fit)))):
        got = ops.forest_predict_agg_segmented_sharded(
            xb, plan.oseg_s, code, fit, *rest, **kw)
        assert torch.equal(got, want)
    tseg = [torch.as_tensor(a) for a in pack.tree_seg]
    short = [t[:8] for t in tseg[:2]] + tseg[2:]
    padded = tp._stacked(short, -1)
    assert padded.shape == (4, len(tseg[0]))
    assert torch.equal(padded[0, :8], tseg[0][:8])
    assert (padded[0, 8:] == -1).all() and (padded[1, 8:] == -1).all()
    assert torch.equal(padded[3], tseg[3])


def test_sharded_launch_refuses_cpu_tensors():
    """K5's CUDA launch never runs CPU tensors and counts nothing when it
    refuses."""
    port, plan, pack, xb, c = sharded_inputs("classification", 2)
    tp.reset_launches()
    with pytest.raises(ValueError, match="CUDA"):
        tp._launch_seg_sharded(
            [torch.as_tensor(xb)], [torch.as_tensor(plan.oseg_s)],
            [only(pack.code)], [only(pack.fit)],
            [torch.as_tensor(pack.tree_seg)],
            [torch.as_tensor(pack.chunk_lo)],
            [torch.as_tensor(pack.chunk_hi)],
            pack.max_depth, port.arena.tb2, c, 8, pack.block_obs,
        )
    assert all(v == 0 for v in tp.LAUNCHES.values())


# ---------------------------------------------------------------------------
# the sharded engine's width hazard (tests/test_store.py, ported)
# ---------------------------------------------------------------------------

def _random_port_forest(**kw):
    from conftest import random_forest

    from repro_torch.convert import forest_from_arrays

    f = random_forest(**kw)
    return forest_from_arrays(f.trees, f.meta, f.fit_values)


def test_piecewise_gathers_share_width_after_ensure(rng):
    """The sharded engine gathers per shard; arena_ensure of the WHOLE
    batch must come first so a later shard's deeper user cannot grow the
    arena width after an earlier shard was gathered."""
    shallow = _random_port_forest(seed=0, n_trees=3, d=5, max_depth=2,
                                  n_bins=12)
    deep = _random_port_forest(seed=1, n_trees=3, d=5, max_depth=6,
                               n_bins=12)
    shared = build_shared_codebook([shallow, deep], device=CPU)
    store = ForestStore(shared, device=CPU)
    store.add_user("shallow", shallow)
    store.add_user("deep", deep)
    store.arena_ensure(["shallow", "deep"], block_trees=4)
    code_a, *_ = store.arena_pack(["shallow"], block_trees=4)
    code_b, *_ = store.arena_pack(["deep"], block_trees=4)
    assert code_a.shape[1] == code_b.shape[1] == store.arena.h

    x = rng.integers(0, 12, (15, 5)).astype(np.int32)
    reqs = [("shallow", x), ("deep", x)]
    for engine, devices in (("pipelined", None), ("sharded", [CPU] * 2)):
        server = ForestServer(store, device=CPU, devices=devices)
        for (u, xi), p in zip(reqs, server.serve(reqs, engine=engine)):
            assert np.array_equal(p, store.predict(u, xi)), engine


def test_width_and_depth_shrink_after_deep_user_leaves(rng):
    shallow = {
        f"s{i}": _random_port_forest(seed=i, n_trees=3, d=5, max_depth=3,
                                     n_bins=12)
        for i in range(3)
    }
    deep = _random_port_forest(seed=11, n_trees=3, d=5, max_depth=7,
                               n_bins=12)
    shared = build_shared_codebook(list(shallow.values()) + [deep],
                                   device=CPU)
    store = ForestStore(shared, device=CPU)
    for u, f in shallow.items():
        store.add_user(u, f)
    store.add_user("deep", deep)
    store.arena_pack(list(shallow) + ["deep"], block_trees=4)
    h_wide = store.arena.h
    assert store.arena.max_depth == 7
    store.arena.invalidate("deep")
    assert store.arena.h < h_wide
    assert store.arena.max_depth == 3
    x = rng.integers(0, 12, (12, 5)).astype(np.int32)
    reqs = [(u, x) for u in shallow]
    server = ForestServer(store, device=CPU, devices=[CPU] * 3)
    for engine in ("pipelined", "sharded"):
        for (u, xi), p in zip(reqs, server.serve(reqs, engine=engine)):
            assert np.array_equal(p, store.predict(u, xi))


# ---------------------------------------------------------------------------
# device defaults
# ---------------------------------------------------------------------------

def test_store_entries_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    port, _ref = stores("classification")
    blob = port.to_bytes()
    port_fleet, _ = fleets("classification")
    for make in (lambda: build_store(port_fleet),
                 lambda: ForestStore.from_bytes(blob),
                 lambda: ForestStore(port.shared),
                 lambda: ForestServer(port, device="cuda")):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    with pytest.raises(RuntimeError, match="CUDA"):
        ForestServer(port, device=CPU, devices=["cuda"])


@pytest.mark.parametrize(
    "argv",
    [["--engine", "pipelined"], ["--engine", "simple"],
     ["--engine", "sharded"], ["--task", "regression"]],
)
def test_serve_store_driver_on_the_cpu(argv, capsys):
    """``launch/serve_store.py`` at a small size: every engine prints 0
    mismatches against per-user ``predict_compressed``."""
    from repro_torch.launch import serve_store

    serve_store.main(["--users", "6", "--requests", "8", "--rows", "16",
                      "--depth", "4", "--device", "cpu", *argv])
    out = capsys.readouterr().out
    assert "(8 requests): 0 mismatches" in out


def test_uncached_stage_helpers_match_the_session(rng):
    from repro_torch.launch import serve_store

    port, _ref = stores("regression")
    reqs = requests_for(port)
    got = serve_store.serve_pipelined_uncached(port, reqs)
    want = ForestServer(port, device=CPU).serve(reqs, engine="pipelined")
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert serve_store.serve_pipelined_uncached(
        port, [(reqs[0][0], np.zeros((0, 8), np.int32))]
    )[0].shape == (0,)


def test_serve_forest_driver_on_the_cpu(capsys):
    from repro_torch.launch import serve_forest

    serve_forest.main(["--trees", "6", "--depth", "4", "--rows", "300",
                       "--batch", "128", "--device", "cpu"])
    assert "agreement vs predict_compressed: 1.0" in capsys.readouterr().out
