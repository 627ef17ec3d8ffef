"""K1-K4 plain versions and the ref twins against the JAX reference.

The reference runs as its own tests run it: the Pallas kernels with
``interpret=True`` and the jnp oracles in ``ref.py``.  The port runs on
CPU tensors, which take the kernels' plain PyTorch versions.  Votes are
equal; regression sums agree to rtol = atol = 1e-5 (float32 sums in
another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.tree_predict import ref as jref
from repro.kernels.tree_predict import tree_predict as jtp
from repro_torch.kernels.tree_predict import ref as tref
from repro_torch.kernels.tree_predict import tree_predict as tp

TOL = dict(rtol=1e-5, atol=1e-5)


def heaps(rng, t, depth, d, n_bins, n_classes, negative=False):
    """Random heap-form trees; classification fits in [-1, C + 1] so some
    leaves carry out-of-range class ids."""
    h = (1 << (depth + 1)) - 1
    lo_f, hi_f = (-2, d + 2) if negative else (0, d)
    feature = rng.integers(lo_f, hi_f, (t, h)).astype(np.int32)
    threshold = rng.integers(-3 if negative else 0, n_bins, (t, h))
    threshold = threshold.astype(np.int32)
    is_internal = rng.random((t, h)) < 0.75
    is_internal[:, (1 << depth) - 1:] = False
    if n_classes:
        fit = rng.integers(-1, n_classes + 2, (t, h)).astype(np.float32)
    else:
        fit = rng.normal(size=(t, h)).astype(np.float32)
    return feature, threshold, fit, is_internal


def case(seed, task, depth, negative=False, t=11, n=50, d=5, n_bins=9):
    rng = np.random.default_rng(seed)
    c = 3 if task == "classification" else 0
    feature, threshold, fit, is_internal = heaps(
        rng, t, depth, d, n_bins, c, negative
    )
    xb = rng.integers(-1 if negative else 0, n_bins, (n, d)).astype(np.int32)
    # ragged segments: unsorted rows, a tree segment no row uses
    oseg = rng.integers(0, 3, n).astype(np.int32)
    tseg = np.sort(rng.integers(0, 4, t)).astype(np.int32)
    return xb, oseg, tseg, feature, threshold, fit, is_internal, c


def check(got: torch.Tensor, want, n_classes):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if n_classes:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("depth", [3, 5])
@pytest.mark.parametrize("engine", ["pipelined", "simple"])
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_engines_match_reference_kernels(task, engine, depth):
    xb, oseg, tseg, feat, thr, fit, inter, c = case(depth, task, depth)
    kw = dict(n_classes=c, block_trees=4, block_obs=16, engine=engine)
    want = jtp.forest_predict_agg_segmented(
        jnp.asarray(xb), oseg, tseg, jnp.asarray(feat), jnp.asarray(thr),
        jnp.asarray(fit), jnp.asarray(inter), depth, interpret=True, **kw,
    )
    got = tp.forest_predict_agg_segmented(
        torch.as_tensor(xb), oseg, tseg, feat, thr, fit, inter, depth, **kw
    )
    check(got, want, c)
    oracle = jref.forest_predict_agg_segmented_reference(
        jnp.asarray(xb), jnp.asarray(oseg), jnp.asarray(tseg),
        jnp.asarray(feat), jnp.asarray(thr), jnp.asarray(fit),
        jnp.asarray(inter), depth, n_classes=c,
    )
    check(got, oracle, c)


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_simple_engine_negative_features_and_thresholds(task):
    """K2 accepts any int32 feature / threshold the reference accepts:
    features clamp to [0, d - 1], negative thresholds compare as ints."""
    xb, oseg, tseg, feat, thr, fit, inter, c = case(
        21, task, 4, negative=True
    )
    assert feat.min() < 0 and thr.min() < 0 and feat.max() >= xb.shape[1]
    kw = dict(n_classes=c, block_trees=4, block_obs=16)
    want = jtp.forest_predict_agg_segmented(
        jnp.asarray(xb), oseg, tseg, jnp.asarray(feat), jnp.asarray(thr),
        jnp.asarray(fit), jnp.asarray(inter), 4, interpret=True,
        engine="simple", **kw,
    )
    got = tp.forest_predict_agg_segmented(
        torch.as_tensor(xb), oseg, tseg, feat, thr, fit, inter, 4,
        engine=None, **kw,  # auto-select: negative fields force "simple"
    )
    check(got, want, c)
    with pytest.raises(ValueError, match="non-negative"):
        tp.forest_predict_agg_segmented(
            torch.as_tensor(xb), oseg, tseg, feat, thr, fit, inter, 4,
            engine="pipelined", **kw,
        )


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_packed_entry_matches_reference_with_padding_trees(task):
    """K1's low-level entry on the fused layout, T padded to a block
    multiple with segment -1 trees, against the reference kernel and the
    packed jnp oracle."""
    xb, oseg, tseg, feat, thr, fit, inter, c = case(31, task, 4, t=13)
    order = np.argsort(oseg, kind="stable")
    xb, oseg = xb[order], oseg[order]
    tb = tp.fused_threshold_base(int(thr.max()))
    code = tp.fuse_node_attrs(feat, thr, inter, tb)
    np.testing.assert_array_equal(code, jtp.fuse_node_attrs(feat, thr, inter, tb))
    bt, bo = 4, 8
    pad = -len(tseg) % bt
    code = np.pad(code, ((0, pad), (0, 0)))
    fit = np.pad(fit, ((0, pad), (0, 0)))
    tseg = np.pad(tseg, (0, pad), constant_values=-1)
    lo, hi = tp.segment_chunk_ranges(oseg, tseg, bt, bo)
    jlo, jhi = jtp.segment_chunk_ranges(oseg, tseg, bt, bo)
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(hi, jhi)
    args = (oseg, code, fit, tseg, lo, hi, 4, 2 * tb)
    kw = dict(n_classes=c, block_trees=bt, block_obs=bo)
    want = jtp.forest_predict_agg_segmented_packed(
        jnp.asarray(xb), *args, interpret=True, **kw
    )
    got = tp.forest_predict_agg_segmented_packed(
        torch.as_tensor(xb), oseg, torch.as_tensor(code), fit, tseg, lo, hi,
        4, 2 * tb, **kw,
    )
    check(got, want, c)
    oracle = jref.forest_predict_agg_segmented_packed_reference(
        jnp.asarray(xb), jnp.asarray(oseg), jnp.asarray(code),
        jnp.asarray(fit), jnp.asarray(tseg), 4, 2 * tb, n_classes=c,
    )
    check(got, oracle, c)
    twin = tref.forest_predict_agg_segmented_packed_reference(
        torch.as_tensor(xb), torch.as_tensor(oseg), torch.as_tensor(code),
        torch.as_tensor(fit), torch.as_tensor(tseg), 4, 2 * tb, n_classes=c,
    )
    check(twin, oracle, c)


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_ref_twins_match_jnp_oracles(task):
    xb, oseg, tseg, feat, thr, fit, inter, c = case(41, task, 5)
    J = [jnp.asarray(a) for a in (xb, feat, thr, fit, inter)]
    T = [torch.as_tensor(a) for a in (xb, feat, thr, fit, inter)]
    per_tree = tref.forest_predict_reference(*T, 5)
    np.testing.assert_array_equal(
        per_tree.numpy(), np.asarray(jref.forest_predict_reference(*J, 5))
    )
    check(
        tref.forest_predict_agg_reference(*T, 5, n_classes=c),
        jref.forest_predict_agg_reference(*J, 5, n_classes=c), c,
    )
    check(
        tref.forest_predict_agg_segmented_reference(
            T[0], torch.as_tensor(oseg), torch.as_tensor(tseg), *T[1:], 5,
            n_classes=c,
        ),
        jref.forest_predict_agg_segmented_reference(
            J[0], jnp.asarray(oseg), jnp.asarray(tseg), *J[1:], 5,
            n_classes=c,
        ),
        c,
    )


@pytest.mark.parametrize("kernel", ["packed", "simple", "agg"])
def test_plain_versions_sum_in_chunk_order(kernel):
    """The plain versions repeat the kernels' summation order: per chunk
    the masked leaves in tree order, then chunk sums row by row.  Check it
    against that order written out in float32 numpy."""
    xb, oseg, tseg, feat, thr, fit, inter, _ = case(51, "regression", 4, t=10)
    bt = 4
    per_tree = tref.forest_predict_reference(
        *(torch.as_tensor(a) for a in (xb, feat, thr, fit, inter)), 4
    ).numpy()
    leaf = np.where(tseg[:, None] == oseg[None, :], per_tree, 0)
    leaf = leaf.astype(np.float32)
    want = np.zeros(xb.shape[0], np.float32)
    for lo in range(0, len(tseg), bt):
        s = np.zeros(xb.shape[0], np.float32)
        for t in range(lo, min(lo + bt, len(tseg))):
            s = s + leaf[t]
        want = want + s
    T = torch.as_tensor
    if kernel == "agg":
        leaf = per_tree.astype(np.float32)  # K3: every tree, no segments
        want = np.zeros(xb.shape[0], np.float32)
        for lo in range(0, len(tseg), bt):
            s = np.zeros(xb.shape[0], np.float32)
            for t in range(lo, min(lo + bt, len(tseg))):
                s = s + leaf[t]
            want = want + s
        got = tp._agg_plain_unseg(
            T(xb), T(feat), T(thr), T(fit), T(inter), 4, 0, bt, 16
        )
    elif kernel == "simple":
        got = tp._seg_simple_plain(
            T(xb), T(oseg), T(tseg), T(feat), T(thr), T(fit), T(inter), 4,
            0, bt, 16,
        )
    else:
        tb = tp.fused_threshold_base(int(thr.max()))
        code = tp.fuse_node_attrs(feat, thr, inter, tb)
        pad = -len(tseg) % bt
        tseg_p = np.pad(tseg, (0, pad), constant_values=-1)
        lo, hi = tp.segment_chunk_ranges(oseg, tseg_p, bt, 16)
        got = tp._seg_packed_plain(
            T(xb), T(oseg), T(np.pad(code, ((0, pad), (0, 0)))),
            T(np.pad(fit, ((0, pad), (0, 0)))), T(tseg_p), T(lo), T(hi), 4,
            2 * tb, 0, bt, 16,
        )
    np.testing.assert_array_equal(got.numpy(), want)


def test_f32_precision_guard_at_boundary():
    """The 2**24 guards raise where the reference raises (mirrors
    tests/test_serve_path.py::test_f32_precision_guard_at_boundary)."""
    xb, oseg, tseg, feat, thr, fit, inter, _ = case(61, "regression", 3, t=2)

    def port(thr_, depth=3, xb_=xb):
        return tp.forest_predict_agg_segmented(
            torch.as_tensor(xb_), oseg, tseg, feat, thr_, fit, inter, depth,
            engine="simple",
        )

    def ref(thr_, depth=3, xb_=xb):
        return jtp.forest_predict_agg_segmented(
            jnp.asarray(xb_), oseg, tseg, jnp.asarray(feat),
            jnp.asarray(thr_), jnp.asarray(fit), jnp.asarray(inter), depth,
            interpret=True, engine="simple",
        )

    ok = thr.copy()
    ok[0, 0] = 2**24 - 1  # largest exactly-representable int32 in f32
    check(port(ok), ref(ok), 0)
    bad = thr.copy()
    bad[0, 0] = 2**24
    big_x = xb.copy()
    big_x[0, 0] = -(2**24)
    for fn in (port, ref):
        with pytest.raises(ValueError, match="2\\*\\*24"):
            fn(bad)
        with pytest.raises(ValueError, match="xb contains values"):
            fn(thr, xb_=big_x)
        with pytest.raises(ValueError, match="heap nodes"):
            fn(thr, depth=30)


def test_packed_entry_validation_matches_reference():
    xb = np.zeros((4, 2), np.int32)
    seg = np.zeros(4, np.int32)
    code = np.zeros((6, 3), np.float32)
    lo = hi = np.zeros(1, np.int32)
    for mod, extra in ((tp, {}), (jtp, {"interpret": True})):
        x = torch.as_tensor(xb) if mod is tp else jnp.asarray(xb)
        with pytest.raises(ValueError, match="multiple of"):
            mod.forest_predict_agg_segmented_packed(
                x, seg, code, code, np.zeros(6, np.int32), lo, hi, 1, 2,
                block_trees=4, **extra,
            )
        bad = code.copy()
        bad[0, 0] = 2**24
        with pytest.raises(ValueError, match="code contains values"):
            mod.forest_predict_agg_segmented_packed(
                x, seg, bad, code, np.zeros(6, np.int32), lo, hi, 1, 2,
                block_trees=3, **extra,
            )
        with pytest.raises(ValueError, match="n_classes"):
            mod.forest_predict_agg_segmented_packed(
                x, seg, code, code, np.zeros(6, np.int32), lo, hi, 1, 2,
                n_classes=2**24, block_trees=3, **extra,
            )


def test_unknown_engine_raises():
    xb, oseg, tseg, feat, thr, fit, inter, _ = case(71, "regression", 3)
    with pytest.raises(ValueError, match="unknown segmented engine"):
        tp.forest_predict_agg_segmented(
            torch.as_tensor(xb), oseg, tseg, feat, thr, fit, inter, 3,
            engine="bogus",
        )


def test_host_helpers_equal_reference():
    assert [tp.fused_threshold_base(v) for v in range(0, 70, 7)] == [
        jtp.fused_threshold_base(v) for v in range(0, 70, 7)
    ]
    for d, tb in ((1, 2), (8, 32), (300, 1 << 14)):
        assert tp.fused_code_limit(d, tb) == jtp.fused_code_limit(d, tb)
    rng = np.random.default_rng(81)
    oseg = rng.integers(-1, 6, 77).astype(np.int32)
    tseg = np.concatenate(
        [np.sort(rng.integers(0, 6, 29)), np.full(3, -1)]
    ).astype(np.int32)
    for bo in (1, 8, 77, 100):
        got = tp.segment_chunk_ranges(oseg, tseg, 4, bo)
        want = jtp.segment_chunk_ranges(oseg, tseg, 4, bo)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_packed_entry_honours_given_chunk_ranges(task):
    """K1 walks only ``[chunk_lo, chunk_hi)`` per row block: with ranges
    narrower than the segments need, the port drops the same pairs as the
    reference kernel."""
    xb, oseg, tseg, feat, thr, fit, inter, c = case(91, task, 3, t=16, n=24)
    tb = tp.fused_threshold_base(int(thr.max()))
    code = tp.fuse_node_attrs(feat, thr, inter, tb)
    lo = np.array([0, 1, 2], np.int32)  # 3 row blocks of 8, 4 chunks of 4
    hi = np.array([2, 1, 4], np.int32)  # block 1 walks nothing
    kw = dict(n_classes=c, block_trees=4, block_obs=8)
    want = jtp.forest_predict_agg_segmented_packed(
        jnp.asarray(xb), oseg, code, fit, tseg, lo, hi, 3, 2 * tb,
        interpret=True, **kw,
    )
    got = tp.forest_predict_agg_segmented_packed(
        torch.as_tensor(xb), oseg, torch.as_tensor(code), fit, tseg, lo, hi,
        3, 2 * tb, **kw,
    )
    check(got, want, c)
    assert not got[8:16].any()


@pytest.mark.parametrize("negative", [False, True])
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_whole_forest_entries_match_reference_kernels(task, negative):
    """K3 (``forest_predict_agg``) and K4 (``forest_predict``): 11 trees in
    blocks of 4 (a padding tile), out-of-range class ids, and (with
    ``negative``) negative and too-large features and negative thresholds,
    against the interpret-mode kernels and the jnp oracles."""
    xb, _, _, feat, thr, fit, inter, c = case(
        101 + negative, task, 4, negative=negative
    )
    J = [jnp.asarray(a) for a in (xb, feat, thr, fit, inter)]
    kw = dict(block_trees=4, block_obs=16)
    want = jtp.forest_predict_agg(*J, 4, n_classes=c, interpret=True, **kw)
    got = tp.forest_predict_agg(
        torch.as_tensor(xb), feat, thr, fit, inter, 4, n_classes=c, **kw
    )
    check(got, want, c)
    check(got, jref.forest_predict_agg_reference(*J, 4, n_classes=c), c)
    per_tree = tp.forest_predict(torch.as_tensor(xb), feat, thr, fit, inter,
                                 4, **kw)
    np.testing.assert_array_equal(
        per_tree.numpy(), np.asarray(jtp.forest_predict(*J, 4, interpret=True,
                                                        **kw))
    )
    np.testing.assert_array_equal(
        per_tree.numpy(), np.asarray(jref.forest_predict_reference(*J, 4))
    )


def test_whole_forest_entries_f32_guards_match_reference():
    """K3 and K4 raise the reference's 2**24 errors at the same inputs."""
    xb, _, _, feat, thr, fit, inter, _ = case(111, "regression", 3, t=2)
    ok = thr.copy()
    ok[0, 0] = 2**24 - 1
    bad = thr.copy()
    bad[0, 0] = 2**24
    big_x = xb.copy()
    big_x[0, 0] = -(2**24)
    for port, ref in (
        (tp.forest_predict_agg, jtp.forest_predict_agg),
        (tp.forest_predict, jtp.forest_predict),
    ):
        def run(mod_fn, is_port, thr_=thr, depth=3, xb_=xb, **kw):
            if is_port:
                return mod_fn(torch.as_tensor(xb_), feat, thr_, fit, inter,
                              depth, **kw)
            return mod_fn(jnp.asarray(xb_), jnp.asarray(feat),
                          jnp.asarray(thr_), jnp.asarray(fit),
                          jnp.asarray(inter), depth, interpret=True, **kw)

        np.testing.assert_allclose(
            run(port, True, ok).numpy(), np.asarray(run(ref, False, ok)),
            **TOL,
        )
        for fn, is_port in ((port, True), (ref, False)):
            with pytest.raises(ValueError, match="2\\*\\*24"):
                run(fn, is_port, bad)
            with pytest.raises(ValueError, match="xb contains values"):
                run(fn, is_port, xb_=big_x)
            with pytest.raises(ValueError, match="heap nodes"):
                run(fn, is_port, depth=30)
    for fn, is_port in ((tp.forest_predict_agg, True),
                        (jtp.forest_predict_agg, False)):
        x = torch.as_tensor(xb) if is_port else jnp.asarray(xb)
        extra = {} if is_port else {"interpret": True}
        with pytest.raises(ValueError, match="n_classes"):
            fn(x, feat, thr, fit, inter, 3, n_classes=2**24, **extra)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4"])
@pytest.mark.parametrize("task", ["classification", "regression"])
def test_walks_past_the_heap_read_zero(kernel, task):
    """With ``max_depth`` two levels deeper than the heap and internal
    nodes on its last level, walks leave the heap.  The Pallas kernels then
    read zero words (feature 0, threshold 0, not internal, fit 0) from their
    zero-padded heaps; the plain versions read the same.  Regression fits
    are multiples of 1/4 below 2**10, so every sum is exact and the
    comparison is array-equal in any summation order."""
    depth = 3
    rng = np.random.default_rng(121)
    t, n, d, nb = 10, 40, 5, 9
    h = (1 << (depth + 1)) - 1
    feat = rng.integers(0, d, (t, h)).astype(np.int32)
    thr = rng.integers(0, nb, (t, h)).astype(np.int32)
    inter = rng.random((t, h)) < 0.9  # the last level too: walks leave
    c = 3 if task == "classification" else 0
    if c:
        fit = rng.integers(-1, c + 1, (t, h)).astype(np.float32)
    else:
        fit = (rng.integers(-400, 400, (t, h)) / 4).astype(np.float32)
    xb = rng.integers(0, nb, (n, d)).astype(np.int32)
    oseg = rng.integers(0, 2, n).astype(np.int32)
    tseg = np.sort(rng.integers(0, 2, t)).astype(np.int32)
    deep = depth + 2
    J = [jnp.asarray(a) for a in (xb, feat, thr, fit, inter)]
    X = torch.as_tensor(xb)
    kw = dict(block_trees=4, block_obs=16)
    if kernel == "K4":
        want = jtp.forest_predict(*J, deep, interpret=True, **kw)
        got = tp.forest_predict(X, feat, thr, fit, inter, deep, **kw)
        # the walk left the heap: some leaves read the zero fit there
        clamped = jref.forest_predict_reference(*J, deep)
        assert not np.array_equal(np.asarray(want), np.asarray(clamped))
    elif kernel == "K3":
        want = jtp.forest_predict_agg(*J, deep, n_classes=c, interpret=True,
                                      **kw)
        got = tp.forest_predict_agg(X, feat, thr, fit, inter, deep,
                                    n_classes=c, **kw)
    else:
        engine = "pipelined" if kernel == "K1" else "simple"
        want = jtp.forest_predict_agg_segmented(
            J[0], oseg, tseg, *J[1:], deep, n_classes=c, interpret=True,
            engine=engine, **kw,
        )
        got = tp.forest_predict_agg_segmented(
            X, oseg, tseg, feat, thr, fit, inter, deep, n_classes=c,
            engine=engine, **kw,
        )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
