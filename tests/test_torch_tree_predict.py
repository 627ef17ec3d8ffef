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


# ---------------------------------------------------------------------------
# K3 / K4 on the card: node records, tiling and work partition, rehearsed
# through their plain twins
# ---------------------------------------------------------------------------

def wide_heaps(seed, t, depth, d, n_bins, n_classes, n=60, p_internal=0.85):
    """Heaps with negative and out-of-range features, thresholds in
    [-n_bins, n_bins) and internal nodes on the last level (walks leave the
    heap at ``max_depth > depth``)."""
    rng = np.random.default_rng(seed)
    h = (1 << (depth + 1)) - 1
    feat = rng.integers(-2, d + 2, (t, h)).astype(np.int32)
    thr = rng.integers(-n_bins, n_bins, (t, h)).astype(np.int32)
    inter = rng.random((t, h)) < p_internal
    if n_classes:
        fit = rng.integers(-1, n_classes + 2, (t, h)).astype(np.float32)
    else:
        fit = rng.normal(size=(t, h)).astype(np.float32)
    xb = rng.integers(-n_bins, n_bins, (n, d)).astype(np.int32)
    return [torch.as_tensor(a) for a in (xb, feat, thr, fit, inter)]


@pytest.mark.parametrize("max_depth", [2, 4, 6])
@pytest.mark.parametrize("form", [tp.NARROW, tp.WIDE])
def test_packed_records_round_trip(form, max_depth):
    """The prologue's plain twin completes the heap and keeps what a walk
    of ``depth`` levels reads: the words of the nodes above level
    ``depth``, the fits of the nodes on it.  A node whose strict ancestors
    are all internal keeps its feature (clamped to [0, d - 1]), its
    threshold (negative ones sign-extended) and its fit, save an internal
    node of the heap's last level when ``max_depth`` passes the heap (fit
    0); a node below a leaf, or below a child past the heap, has word 0
    and that stop's fit; the padding is zero."""
    n_bins = 1 << 15 if form == tp.NARROW else 1 << 20
    xb, feat, thr, fit, inter = wide_heaps(131, 5, 4, 7, n_bins, 0)
    if form == tp.NARROW:
        thr = thr.clamp(-(2**15) + 1, 2**15 - 1)
        thr[0, :2] = torch.tensor([2**15 - 1, -(2**15) + 1])
    h = 29  # a partial last level: nodes 29 and 30 lie past the heap
    feat, thr, fit, inter = (a[:, :h].contiguous()
                             for a in (feat, thr, fit, inter))
    words, fits = tp._pack_records_plain(feat, thr, fit, inter, 7, form,
                                         max_depth)
    depth = tp._walk_depth(h, max_depth)
    assert depth == min(max_depth, 4)
    ws = tp._leaf_stride(depth)
    assert tp._leaf_stride(0) == tp._leaf_stride(2) == 4 and ws == 1 << depth
    assert words.shape == ((5, ws) if form == tp.NARROW else (5, ws, 2))
    assert words.dtype == torch.int32 and fits.shape == (5, ws)
    f, th = tp._unpack_records_plain(words, form)
    first_leaf = (1 << depth) - 1
    for t in range(5):
        for j in range(2 * first_leaf + 1):
            stop, a = None, j
            while a:
                a = (a - 1) // 2
                if a >= h or not inter[t, a]:
                    stop = a  # keeps the shallowest
            if j >= first_leaf:  # level depth: the fit
                if stop is not None:
                    want = 0.0 if stop >= h else fit[t, stop]
                elif j >= h:
                    want = 0.0
                else:
                    cut = bool(inter[t, j]) and depth == 4 and max_depth >= 5
                    want = 0.0 if cut else fit[t, j]
                assert fits[t, j - first_leaf] == want
            elif stop is not None or j >= h:
                assert f[t, j] == th[t, j] == 0
            else:
                assert f[t, j] == min(max(int(feat[t, j]), 0), 6)
                assert th[t, j] == thr[t, j]
    assert not f[:, first_leaf:].any() and not fits[:, first_leaf + 1:].any()


def test_record_form_boundaries():
    """Narrow records take d <= 2**15 and |threshold| < 2**15; the entry
    reads the threshold maximum from the 2**24 guard's own pass."""
    assert tp._record_form(2**15, 2**15 - 1) == tp.NARROW
    assert tp._record_form(2**15, 2**15) == tp.WIDE
    assert tp._record_form(2**15 + 1, 0) == tp.WIDE
    assert tp._record_form(1, 0) == tp.NARROW
    xb, feat, thr, fit, inter = wide_heaps(132, 2, 2, 3, 9, 0)
    for top, form in ((2**15 - 1, tp.NARROW), (2**15, tp.WIDE)):
        thr2 = thr.clone()
        thr2[1, 3] = -top
        maxima = tp._validate_f32_exact(2, 3, feature=feat, threshold=thr2,
                                        xb=xb)
        assert maxima["threshold"] == top
        _, _, got = tp._forest_inputs(xb, feat, thr2, fit, inter, 2)
        assert got == form
    maxima = tp._validate_f32_exact(2, 3, threshold=np.zeros((0, 3)),
                                    xb=xb.numpy())
    assert maxima == {"threshold": 0, "xb": int(xb.abs().max())}


@pytest.mark.parametrize("form", [tp.NARROW, tp.WIDE])
@pytest.mark.parametrize("extra_levels", [-2, 0, 2])
@pytest.mark.parametrize("h", [63, 50])
def test_walk_over_records_equals_per_tree_plain(form, extra_levels, h):
    """The kernel's walk over the completed heap (``min(max_depth, levels
    - 1)`` uniform levels, one word each, the fit where it ends) equals
    ``_per_tree_plain`` bit for bit: with ``max_depth`` short of the heap,
    at it, past it (walks that leave the heap), and on a heap of 50 nodes,
    whose last level is partial."""
    n_bins = 2**15 - 1 if form == tp.NARROW else 70000
    xb, *heap = wide_heaps(133 + form, 9, 5, 6, n_bins, 0)
    feat, thr, fit, inter = (a[:, :h].contiguous() for a in heap)
    depth = 6 + extra_levels
    words, fits = tp._pack_records_plain(feat, thr, fit, inter, 6, form,
                                         depth)
    got = tp._walk_records_plain(xb, words, fits, form, h, depth)
    want = tp._per_tree_plain(xb, feat, thr, fit, inter, depth)
    assert torch.equal(got, want)


#: chip_smoke.py's K3 / K4 shapes: (t, h, n, d, max_depth, n_classes,
#: block_trees, form) — the Liberty forests (50 trees, depth 12, 50,999
#: rows, 32 variables) and the parity cases.
SMOKE_SHAPES = [
    (50, 8191, 50999, 32, 12, 2, 8, tp.NARROW),
    (50, 8191, 50999, 32, 12, 0, 8, tp.NARROW),
    (1021, 511, 65536, 8, 8, 2, 8, tp.NARROW),
    (1021, 511, 65536, 8, 8, 0, 8, tp.NARROW),
    (203, 8191, 5003, 8, 12, 7, 8, tp.NARROW),
    (99, 511, 2001, 8, 10, 0, 8, tp.NARROW),
    (37, 32767, 3001, 8, 14, 0, 8, tp.NARROW),
    (45, 2047, 4001, 8, 10, 3, 8, tp.WIDE),
    (17, 511, 257, 40000, 8, 40, 8, tp.WIDE),
    (1, 8191, 4099, 8, 12, 0, 8, tp.NARROW),
    (203, 8191, 1, 8, 12, 7, 8, tp.NARROW),
    (301, 2047, 2003, 8, 10, 0, 5, tp.NARROW),
    # 67 features: a 512-row x tile of 137,216 B beside a full tree budget
    # would pass a CTA's 232,448 B (12 depth-12 trees, 96 depth-8 trees)
    (12, 8191, 3001, 67, 12, 2, 8, tp.NARROW),
    (96, 511, 3001, 67, 8, 0, 8, tp.NARROW),
    (96, 511, 3001, 67, 8, 3, 8, tp.NARROW),
]


@pytest.mark.parametrize("resident", [132, 264, 396])
@pytest.mark.parametrize("shape", SMOKE_SHAPES)
def test_work_partition_covers_every_pair_once(shape, resident):
    """Over the configuration the wrapper computes, the CTAs' (tree range,
    row range) work items cover every (tree, row) pair exactly once, with
    the rows of a group of fewer trees cut into fewer ranges; K3's sums
    run in groups of whole chunks of block_trees trees whenever there are
    several, so a chunk's sum is made in one CTA; the tiling fits a Hopper
    CTA, x in shared memory whenever its tile alone fits (its bytes taken
    from the trees' budget)."""
    t, h, n, d, max_depth, c, bt, form = shape
    for per_tree in (False, True):
        cfg = tp._forest_config(t, h, n, d, max_depth, c, per_tree, bt, form,
                                resident)
        assert cfg["smem"] <= 232448 and cfg["grid"] >= 1
        assert cfg["x_smem"] == (512 * (d | 1) * 4 <= 136 * 1024)
        assert cfg["grid"] <= max(resident, 1) + cfg["n_groups"]
        depth = cfg["depth"]
        assert depth == min(max_depth, h.bit_length() - 1)
        assert 0 <= cfg["levels"] <= depth
        assert cfg["staged"] % 4 == 0
        assert (1 << cfg["levels"]) - 1 <= cfg["staged"] <= tp._leaf_stride(
            depth)
        rows_of = {}
        for trees, rows in tp._forest_work(cfg, t, n):
            assert len(trees) and len(rows)
            rows_of.setdefault((trees.start, trees.stop), []).append(rows)
        starts = sorted(rows_of)
        assert starts[0][0] == 0 and starts[-1][1] == t
        assert all(a[1] == b[0] for a, b in zip(starts, starts[1:]))
        for key, ranges in rows_of.items():
            ranges.sort(key=lambda r: r.start)
            assert ranges[0].start == 0 and ranges[-1].stop == n
            assert all(a.stop == b.start for a, b in zip(ranges, ranges[1:]))
            if not per_tree and c == 0 and cfg["n_groups"] > 1:
                assert key[0] % bt == 0 and cfg["partials"] == 1
        splits = [len(rows_of[k]) for k in starts]
        assert splits[-1] <= splits[0]  # the last group has the fewest trees
        assert cfg["mode"] == (tp.PER_TREE if per_tree else tp.SUM if c == 0
                               else tp.VOTES if c <= 8 else tp.VOTE_ATOMIC)


def kernel_order_plain(xb, feat, thr, fit, inter, depth, n_classes, bt, cfg):
    """K3 written out as the kernel orders it, in float32 numpy over the
    configuration's work items: per row and group, leaves in tree order
    into the open chunk, chunk sums into the row's total (one group) or
    into partials that a second pass folds in chunk order; votes as
    integer counts."""
    leaf = tp._per_tree_plain(xb, feat, thr, fit, inter, depth).numpy()
    t, n = leaf.shape
    if n_classes:
        votes = np.zeros((n, n_classes), np.int64)
        for trees, rows in tp._forest_work(cfg, t, n):
            for tree in trees:
                cls = leaf[tree, rows.start:rows.stop].astype(np.int32)
                for r, k in zip(rows, cls):
                    if 0 <= k < n_classes:
                        votes[r, k] += 1
        return votes.astype(np.float32)
    n_chunks = -(-t // bt)
    partial = np.full((n_chunks, n), np.nan, np.float32)
    out = np.full(n, np.nan, np.float32)
    for trees, rows in tp._forest_work(cfg, t, n):
        sl = slice(rows.start, rows.stop)
        total = np.zeros(len(rows), np.float32)
        chunk = np.zeros(len(rows), np.float32)
        for tree in trees:
            if tree % bt == 0 and tree != trees.start:
                if cfg["partials"]:
                    partial[tree // bt - 1, sl] = chunk
                else:
                    total = total + chunk
                chunk = np.zeros(len(rows), np.float32)
            chunk = chunk + leaf[tree, sl]
        if cfg["partials"]:
            partial[(trees.stop - 1) // bt, sl] = chunk
        else:
            out[sl] = total + chunk
    if cfg["partials"]:
        out = np.zeros(n, np.float32)
        for k in range(n_chunks):
            out = out + partial[k]
    return out


#: (trees, heap depth, max_depth, block_trees, groups): one group; several
#: groups folded through chunk partials (walks past the heap in one);
#: nothing staged (max_depth 0).
ORDER_SHAPES = [
    (29, 5, 6, 3, 1),
    (101, 10, 10, 3, 5),
    (101, 10, 12, 7, 5),
    (29, 5, 0, 3, 1),
]


@pytest.mark.parametrize("shape", ORDER_SHAPES)
@pytest.mark.parametrize("n_classes", [0, 3, 11])
def test_kernel_reduction_order_equals_agg_plain(n_classes, shape):
    """K3's reduction, written out in the kernel's order over its work
    items (one group, several groups folded through chunk partials, and
    nothing staged), equals ``_agg_plain_unseg`` bit for bit."""
    t, depth, max_depth, bt, groups = shape
    xb, feat, thr, fit, inter = wide_heaps(141 + n_classes, t, depth, 6, 9,
                                           n_classes, n=97)
    cfg = tp._forest_config(t, feat.shape[1], 97, 6, max_depth, n_classes,
                            False, bt, tp.NARROW, resident=5)
    assert cfg["n_groups"] == groups and cfg["partials"] == (groups > 1)
    assert (cfg["levels"] == 0) == (max_depth == 0)
    got = kernel_order_plain(xb, feat, thr, fit, inter, max_depth, n_classes,
                             bt, cfg)
    want = tp._agg_plain_unseg(xb, feat, thr, fit, inter, max_depth,
                               n_classes, bt)
    np.testing.assert_array_equal(got, want.numpy())


def test_forest_launches_refuse_what_they_do_not_take():
    """K3's and K4's launches check dtype, shape and contiguity, refuse
    narrow records for d > 2**15, then refuse a CPU tensor; a refusal
    counts no launch and runs no plain version."""
    xb, feat, thr, fit, inter = wide_heaps(151, 4, 3, 5, 9, 0)
    tp.reset_launches()
    for launch in (tp._launch_agg, tp._launch_per_tree):
        with pytest.raises(ValueError, match="dtype"):
            launch(xb.long(), feat, thr, fit, inter, 3)
        with pytest.raises(ValueError, match="dtype"):
            launch(xb, feat, thr, fit, inter.to(torch.uint8), 3)
        with pytest.raises(ValueError, match="contiguous"):
            launch(xb, feat.T.contiguous().T, thr, fit, inter, 3)
        with pytest.raises(ValueError, match="shape"):
            launch(xb, feat, thr[:, :-1], fit, inter, 3)
        with pytest.raises(ValueError, match="CUDA"):
            launch(xb, feat, thr, fit, inter, 3)
        # narrow records cannot hold a feature id past 2**15
        wide_x = torch.zeros((2, 2**15 + 1), dtype=torch.int32)
        with pytest.raises(ValueError, match="narrow"):
            launch(wide_x, feat, thr, fit, inter, 3, form=tp.NARROW)
    assert tp.LAUNCHES["agg"] == tp.LAUNCHES["per_tree"] == 0


@pytest.mark.parametrize("task", ["classification", "regression"])
def test_depth13_entries_match_interpret_kernels(task):
    """Depth 13 (16,383-node heaps), small T and N: K3's and K4's entries
    on the CPU (their plain versions) against the interpret-mode Pallas
    kernels, with walks two levels past the heap for K4."""
    c = 3 if task == "classification" else 0
    xb, feat, thr, fit, inter = wide_heaps(161 + c, 5, 13, 6, 9, c, n=24,
                                           p_internal=0.9)
    J = [jnp.asarray(a.numpy()) for a in (xb, feat, thr, fit, inter)]
    kw = dict(block_trees=2, block_obs=8)
    want = jtp.forest_predict_agg(*J, 13, n_classes=c, interpret=True, **kw)
    got = tp.forest_predict_agg(xb, feat, thr, fit, inter, 13, n_classes=c,
                                **kw)
    check(got, want, c)
    for depth in (13, 15):
        want = jtp.forest_predict(*J, depth, interpret=True, **kw)
        got = tp.forest_predict(xb, feat, thr, fit, inter, depth, **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# K1 / K2 on the card: tiling, kept slices, walk, decode and reduction,
# rehearsed through their plain twins
# ---------------------------------------------------------------------------

def seg_layout(name):
    """(obs_seg, tree_seg, block_trees, block_obs, chunk ranges or None) of
    the K1 / K2 shapes ``chip_smoke.py`` runs: the main path's 1,024-row
    batches, the fleet batch (222 users of 8-16 trees, 256 requests of 256
    rows sorted by user), the large parity shape and the parity cases
    that the tiling introduces.  K1's trees are padded to a multiple of
    its 8-tree chunks with segment -1; its ranges come from
    ``segment_chunk_ranges``."""
    rng = np.random.default_rng(171)
    k1 = name.startswith("k1")
    if name.endswith("main"):  # one user, 100 trees or K2's first chunk
        tseg, oseg = np.zeros(100 if k1 else 32, np.int32), np.zeros(1024)
    elif name.endswith("fleet"):
        tseg = np.repeat(np.arange(222), rng.integers(8, 17, 222))
        asked = np.concatenate([np.arange(222), rng.integers(0, 222, 34)])
        oseg = np.sort(np.repeat(asked, 256))
    elif name.endswith("large"):
        tseg = np.sort(rng.integers(0, 37, 1021))
        oseg = np.sort(rng.integers(0, 37, 65536))
    elif name.endswith("long"):  # one user of 2,100 trees
        tseg, oseg = np.zeros(2100), np.zeros(700)
    elif name.endswith("n1000"):
        tseg = np.sort(rng.integers(0, 2, 100))
        oseg = rng.integers(0, 2, 1000)
    elif name.endswith("n1"):
        tseg, oseg = np.sort(rng.integers(0, 3, 203)), np.array([1])
    else:  # dead chunks: 160 users over 640 trees
        tseg = np.sort(rng.integers(0, 160, 640))
        oseg = np.sort(rng.integers(0, 160, 8192))
    tseg, oseg = tseg.astype(np.int32), oseg.astype(np.int32)
    bt, bo = (8, 128) if k1 else (32, 256)
    bo = min(bo, len(oseg))
    if not k1:
        return oseg, tseg, bt, bo, None
    tseg = np.pad(tseg, (0, -len(tseg) % bt), constant_values=-1)
    lo, hi = tp.segment_chunk_ranges(oseg, tseg, bt, bo)
    if name == "k1-fleet":  # and every third row block with an empty range
        hi = hi.copy()
        hi[::3] = lo[::3]
    return oseg, tseg, bt, bo, (lo, hi)


def shard_layout(name):
    """K5's shape of a K1 layout ``<layout>-s<S>``: the layout's users
    bin-packed onto S tree shards by tree count (``partition_segments_by
    _load``, as the sharded engine does), each shard's trees in user order
    and every shard padded with segment -1 to one ``T_pad`` (a multiple
    of the 8-tree chunk): the shards hold unequal tree counts, and a
    shard may hold none.  (obs_seg, tree_seg (S, T_pad), block_trees,
    block_obs, (chunk_lo, chunk_hi) each (S, G))."""
    from repro_torch.kernels.tree_predict.ops import (
        partition_segments_by_load,
    )

    base, shards = name.rsplit("-s", 1)
    oseg, tseg, bt, bo, _ = seg_layout(base)
    tseg = tseg[tseg >= 0]
    users = np.bincount(tseg)
    parts = [np.concatenate([np.flatnonzero(tseg == u) for u in sorted(us)]
                            or [np.zeros(0, int)]).astype(int)
             for us in partition_segments_by_load(users, int(shards))]
    t_pad = max(-(-max(len(p) for p in parts) // bt) * bt, bt)
    tsegs = np.full((len(parts), t_pad), -1, np.int32)
    for s, p in enumerate(parts):
        tsegs[s, :len(p)] = tseg[p]
    ranges = [tp.segment_chunk_ranges(oseg, t, bt, bo) for t in tsegs]
    return oseg, tsegs, bt, bo, tuple(np.stack(r) for r in zip(*ranges))


SEG_LAYOUTS = ["k1-main", "k1-fleet", "k1-large", "k1-long", "k1-n1000",
               "k1-n1", "k2-main", "k2-fleet", "k2-large", "k2-long",
               "k2-dead",
               # K5: K1's layouts over S tree shards (``shard_layout``)
               "k1-fleet-s1", "k1-fleet-s2", "k1-fleet-s4", "k1-main-s4",
               "k1-long-s2", "k1-n1000-s2", "k1-n1-s4"]


@pytest.mark.parametrize("resident", [132, 528, 1056])
@pytest.mark.parametrize("name", SEG_LAYOUTS)
def test_seg_work_covers_every_pair_once(name, resident):
    """Over the configuration the wrapper computes, K1's / K2's CTAs hold
    tiles that cut each row block into consecutive row ranges, and the
    slices each keeps, walked against its rows, cover every (tree, row)
    pair whose segments match and whose chunk lies in the row block's
    range exactly once; the rows a CTA holds are the fewest (from 8, or
    16 for K2) whose grid fits the resident CTAs.  K5's layouts (``-s``
    S shards): the same over the shard axis, every (shard, tree, row)
    pair covered once by that shard's CTAs, and the grid of every shard
    together fitting the resident CTAs."""
    sharded = "-s" in name
    oseg, tseg, bt, bo, ranges = (shard_layout if sharded
                                  else seg_layout)(name)
    tsegs = tseg if sharded else tseg[None]
    shards, t = tsegs.shape
    n = len(oseg)
    tb2 = 64 if ranges is not None else None
    cfg = tp._seg_config(n, 8, t, 511, 8, 2, bt, bo, tb2, resident,
                         shards=shards)
    assert cfg["rows"] * cfg["cols"] == cfg["threads"] == 256
    assert cfg["shards"] == shards
    assert cfg["grid"] * shards <= resident or cfg["rows"] == 128
    # dynamic shared memory beside the static (the kept list, K2's staged
    # trees' table, the warps' ranges) fits a Hopper CTA; only K2 stages
    assert cfg["smem"] + 2 * 4 * 256 + 3 * 4 * 8 <= 232448
    assert (cfg["levels"] > 0) == (tb2 is None)
    assert cfg["levels"] <= cfg["depth"]
    fewest = 8 if tb2 else 16  # K2's CTAs hold 16 rows or more
    assert cfg["rows"] >= fewest
    if cfg["rows"] > fewest:  # half the rows would not have fit the card
        half = tp._seg_config(n, 8, t, 511, 8, 2, bt, bo, tb2, resident,
                              shards=shards)
        tp._seg_size(half, n, bo, 2, cfg["rows"] // 2)
        assert half["grid"] * shards > resident
    lo, hi = ranges if ranges is not None else (None, None)
    los = lo if sharded or lo is None else lo[None]
    his = hi if sharded or hi is None else hi[None]
    n_chunks = -(-t // bt)
    blocks = np.arange(n) // bo
    chunk_of = np.arange(t) // bt
    c = np.arange(n_chunks)
    in_range = [np.ones((len(np.unique(blocks)), n_chunks), bool)
                if los is None else
                (c[None] >= los[s][:, None]) & (c[None] < his[s][:, None])
                for s in range(shards)]
    work = tp._seg_work(cfg, oseg, tseg, bt, bo, lo, hi)
    if not sharded:
        work = ((0, rows, slices) for rows, slices in work)
    covered = 0
    rows_seen = np.zeros((shards, n), np.int64)
    for s, rows, slices in work:
        assert len({blocks[r] for r in (rows.start, rows.stop - 1)}) == 1
        rows_seen[s, rows.start:rows.stop] += 1
        trees = np.concatenate([np.arange(sl.start, min(sl.stop, t))
                                for sl in slices] or [np.zeros(0, int)])
        assert len(set(trees.tolist())) == len(trees)  # no tree twice
        ok = in_range[s][blocks[rows.start], chunk_of[trees]]
        covered += int((tsegs[s][trees][ok, None]
                        == oseg[None, rows.start:rows.stop]).sum())
    assert (rows_seen == 1).all()
    want = 0
    for s in range(shards):
        for tree in range(t):
            rows = np.flatnonzero(oseg == tsegs[s][tree])
            want += int(in_range[s][blocks[rows], chunk_of[tree]].sum())
    assert covered == want
    if sharded:  # the shards together hold every real tree once
        base = seg_layout(name.rsplit("-s", 1)[0])[1]
        assert sorted(tseg[tseg >= 0].tolist()) == sorted(
            base[base >= 0].tolist())


def seg_kernel_order_plain(leaf, oseg, tseg, n_classes, bt, bo, cfg,
                           ranges=None):
    """K1's / K2's reduction written out in the kernel's order, in float32
    numpy over its CTAs' kept slices: for a slice that is a whole chunk,
    the thread's sum of its masked leaves in tree order, added by the
    row's folding thread into its total; for slices of a larger chunk,
    the leaves, added into the open chunk's sum, which goes into the total
    when the next kept chunk starts and at the end; votes as integer
    counts.  Pairs that do not count hold leaf 0."""
    n, t = len(oseg), len(tseg)
    lo, hi = ranges if ranges is not None else (None, None)
    counts = np.zeros((n, max(n_classes, 1)), np.int64)
    out = np.full(n, np.nan, np.float32)
    for rows, slices in tp._seg_work(cfg, oseg, tseg, bt, bo, lo, hi):
        for r in rows:
            total, open_, open_chunk = (np.float32(0), np.float32(0), -1)
            for trees in slices:
                held = [np.float32(leaf[k, r])
                        if k < t and tseg[k] == oseg[r] else np.float32(0)
                        for k in trees]  # the leaves one thread holds
                if n_classes:
                    for k, v in zip(trees, held):
                        cls = int(v)
                        if k < t and tseg[k] == oseg[r] and 0 <= cls < n_classes:
                            counts[r, cls] += 1
                elif cfg["values"] == 1:
                    s = held[0]
                    for v in held[1:]:
                        s = np.float32(s + v)
                    total = np.float32(total + s)
                else:
                    if trees.start // bt != open_chunk:
                        total = np.float32(total + open_)
                        open_, open_chunk = np.float32(0), trees.start // bt
                    for v in held:
                        open_ = np.float32(open_ + v)
            out[r] = np.float32(total + open_)
    return counts.astype(np.float32) if n_classes else out


#: (block_trees, rows, trees, users, sorted rows, K1 ranges): chunks of 8
#: trees as K1 runs them, 5 (short chunks), 12 (two slices, the last of 4
#: trees) and K2's 32; a fleet-like layout of sorted users; unsorted rows;
#: ranges with empty blocks.
SEG_ORDER_SHAPES = [
    (8, 300, 61, 9, True, True),
    (5, 97, 37, 3, False, True),
    (12, 150, 50, 4, True, False),
    (32, 300, 101, 12, True, False),
    (32, 64, 40, 2, False, False),
]


@pytest.mark.parametrize("shape", SEG_ORDER_SHAPES)
@pytest.mark.parametrize("n_classes", [0, 3, 11])
def test_seg_kernel_reduction_order_equals_agg_plain(n_classes, shape):
    """K1's and K2's reduction, written out as the kernel folds the leaves
    each thread holds (a chunk's sum, or the leaves of slices of a larger
    chunk, kept slices only), equals their plain versions bit for bit."""
    bt, n, t, users, sort, use_ranges = shape
    xb, feat, thr, fit, inter = wide_heaps(181 + n_classes + bt, t, 5, 6, 9,
                                           n_classes, n=n)
    rng = np.random.default_rng(bt + n)
    tseg = np.repeat(np.arange(users), np.diff(np.linspace(0, t, users + 1)
                                               .astype(int)))
    oseg = rng.integers(0, users + 1, n)  # segment `users` has no trees
    oseg = np.sort(oseg) if sort else oseg
    tseg, oseg = tseg.astype(np.int32), oseg.astype(np.int32)
    leaf = tp._per_tree_plain(xb, feat, thr, fit, inter, 6).numpy()
    T = torch.as_tensor
    if use_ranges:
        bo = 16
        pad = -t % bt
        tseg_p = np.pad(tseg, (0, pad), constant_values=-1)
        lo, hi = tp.segment_chunk_ranges(oseg, tseg_p, bt, bo)
        hi[1::4] = lo[1::4]
        tb2 = 2 * tp.fused_threshold_base(int(thr.abs().max()))
        code = tp.fuse_node_attrs(feat.clamp(min=0).numpy(),
                                  thr.clamp(min=0).numpy(), inter.numpy(),
                                  tb2 // 2)
        xb_k = xb.clamp(min=0)
        want = tp._seg_packed_plain(
            xb_k, T(oseg), T(np.pad(code, ((0, pad), (0, 0)))),
            T(np.pad(fit.numpy(), ((0, pad), (0, 0)))), T(tseg_p), T(lo),
            T(hi), 6, tb2, n_classes, bt, bo)
        f2, t2, i2 = tp._unfuse(T(code), tb2)
        leaf = tp._per_tree_plain(xb_k, f2, t2, fit, i2, 6).numpy()
        leaf = np.pad(leaf, ((0, pad), (0, 0)))
        cfg = tp._seg_config(n, 6, t + pad, feat.shape[1], 6, n_classes, bt,
                             bo, tb2, resident=7)
        got = seg_kernel_order_plain(leaf, oseg, tseg_p, n_classes, bt, bo,
                                     cfg, (lo, hi))
    else:
        bo = 32
        want = tp._seg_simple_plain(xb, T(oseg), T(tseg), feat, thr, fit,
                                    inter, 6, n_classes, bt, bo)
        cfg = tp._seg_config(n, 6, t, feat.shape[1], 6, n_classes, bt, bo,
                             None, resident=7)
        got = seg_kernel_order_plain(leaf, oseg, tseg, n_classes, bt, bo,
                                     cfg)
    assert cfg["values"] == (1 if bt <= 8 else 8)
    np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("tb2", [2, 4, 64, 1 << 14, 96])
def test_shift_and_mask_decode_equals_unfuse(tb2):
    """K1's decode (shift and mask where ``tb2`` is a power of two, the
    arithmetic shift flooring negative words; division for 96) equals
    ``_unfuse`` on every word of a fused table and on negative words."""
    rng = np.random.default_rng(191)
    tb = tb2 // 2
    feat = rng.integers(0, 300, (7, 63))
    thr = rng.integers(0, tb, (7, 63))
    inter = rng.random((7, 63)) < 0.5
    code = tp.fuse_node_attrs(feat, thr, inter, tb).reshape(-1)
    words = torch.as_tensor(np.concatenate(
        [code, np.arange(-5000, 5000, dtype=np.float32)]))
    for got, want in zip(tp._decode_plain(words, tb2),
                         tp._unfuse(words, tb2)):
        assert torch.equal(got, want)
    f, th, it = tp._decode_plain(torch.as_tensor(code), tb2)
    assert torch.equal(f, torch.as_tensor(feat.reshape(-1), dtype=torch.int32))
    assert torch.equal(th, torch.as_tensor(thr.reshape(-1), dtype=torch.int32))
    assert torch.equal(it, torch.as_tensor(inter.reshape(-1)))


@pytest.mark.parametrize("extra_levels", [-3, 0, 2, 5])
@pytest.mark.parametrize("h", [63, 50])
def test_stay_put_walk_equals_per_tree_plain(extra_levels, h):
    """K1's / K2's walk (``min(max_depth, h.bit_length())`` uniform
    levels, the zero word by a select past the heap, ``idx = internal ?
    child : idx``) equals ``_per_tree_plain`` bit for bit: ``max_depth``
    short of the heap, at it and past it (walks that leave the heap), on
    a full heap and on one of 50 nodes, whose last level is partial."""
    xb, *heap = wide_heaps(201 + h, 9, 5, 6, 9, 0)
    feat, thr, fit, inter = (a[:, :h].contiguous() for a in heap)
    depth = 5 + extra_levels
    got = tp._walk_stay_put_plain(xb, feat, thr, fit, inter, depth)
    want = tp._per_tree_plain(xb, feat, thr, fit, inter, depth)
    assert torch.equal(got, want)


def test_seg_launches_refuse_what_they_do_not_take():
    """K1's and K2's launches refuse no rows, no features, blocks below 1,
    a code word base below 1 and T_pad no multiple of block_trees (with
    the same messages as the twin's refusals), then a CPU tensor; a
    refusal counts no launch.  Block sizes no longer meet a shared-memory
    limit: chip_smoke.py's largest blocks, (32, 512) for K1 and (64, 512)
    for K2, reach the device check, and so does one block of 4,096 trees.
    Heaps of 2**31 nodes pass the 32-bit node offsets."""
    xb, feat, thr, fit, inter = wide_heaps(211, 64, 3, 5, 9, 0, n=40)
    code = torch.zeros(feat.shape, dtype=torch.float32)
    seg = torch.zeros(40, dtype=torch.int32)
    tseg = torch.zeros(64, dtype=torch.int32)

    def k1(bt=8, bo=16, tb2=32, x=xb, s=seg):
        g = torch.zeros(-(-x.shape[0] // max(bo, 1)), dtype=torch.int32)
        return tp._launch_seg_packed(x, s, code, fit, tseg, g, g, 3, tb2, 0,
                                     bt, bo)

    def k2(bt=32, bo=16, x=xb, s=seg):
        return tp._launch_seg_simple(x, s, tseg, feat, thr, fit, inter, 3,
                                     0, bt, bo)

    tp.reset_launches()
    empty = torch.zeros((0, 5), dtype=torch.int32)
    no_features = torch.zeros((40, 0), dtype=torch.int32)
    for launch in (k1, k2):
        with pytest.raises(ValueError, match="positive"):
            launch(bt=0)
        with pytest.raises(ValueError, match="positive"):
            launch(bo=0)
        with pytest.raises(ValueError, match="rows and features"):
            launch(x=empty, s=seg[:0])
        with pytest.raises(ValueError, match="rows and features"):
            launch(x=no_features)
        for bt, bo in ((32, 512), (64, 512), (64, 4096)):
            with pytest.raises(ValueError, match="CUDA"):
                launch(bt=bt, bo=bo)
    with pytest.raises(ValueError, match="tb2=0"):
        k1(tb2=0)
    with pytest.raises(ValueError, match="multiple of block_trees"):
        k1(bt=5)
    with pytest.raises(ValueError, match="CUDA"):
        k1(tb2=96)  # no power of two: decoded by division
    with pytest.raises(ValueError, match="32-bit node offsets"):
        tp._launch_config(10, 5, 1 << 16, 1 << 15, 8, 128)
    tp._launch_config(10, 5, (1 << 16) - 1, 1 << 15, 8, 128)
    assert tp.LAUNCHES["seg_packed"] == tp.LAUNCHES["seg_simple"] == 0
    # the twin refuses the same shapes
    for args in ((0, 5, 64, 15, 3, 0, 8, 16, 32), (40, 0, 64, 15, 3, 0, 8,
                 16, 32), (40, 5, 64, 15, 3, 0, 0, 16, 32),
                 (40, 5, 64, 15, 3, 0, 8, 0, 32), (40, 5, 64, 15, 3, 0, 8, 16,
                 0), (40, 5, 1 << 16, 1 << 15, 3, 0, 8, 16, None)):
        with pytest.raises(ValueError):
            tp._seg_config(*args, resident=132)
