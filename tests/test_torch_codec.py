"""The port's codec against the JAX reference: RFS1 frames cross in both
directions, corruptions raise the same typed errors, compressed
prediction agrees, and the clustering engines assign alike."""
import numpy as np
import pytest
import torch

from conftest import random_forest
from repro.core import bregman as ref_bregman
from repro.core.compressed_predict import iter_trees as ref_iter_trees
from repro.core.compressed_predict import (
    predict_compressed as ref_predict_compressed,
)
from repro.core.forest_codec import CompressedForest as RefCompressed
from repro.core.forest_codec import compress_forest as ref_compress
from repro.runtime.chaos import flip_bits as ref_flip_bits
from repro_torch.convert import compressed_from_bytes, forest_from_arrays
from repro_torch.core import bregman
from repro_torch.core.compressed_predict import (
    _batched_leaf_fits,
    _torch_leaf_fits,
    iter_trees,
    predict_compressed,
    stacked_forest,
)
from repro_torch.core.forest_codec import compress_forest
from repro_torch.core.framing import FramingError
from repro_torch.runtime.chaos import flip_bits

FIXTURES = {
    "cls2": dict(seed=3, n_trees=10, max_depth=5, task="classification"),
    "cls4": dict(
        seed=4, n_trees=8, max_depth=4, task="classification", n_classes=4
    ),
    "reg": dict(seed=5, n_trees=12, max_depth=5, task="regression"),
}
#: The Bregman sweep's largest K.  Small, because the reference's dense
#: engine compiles once per (models, alphabet, K) shape.
K_MAX = 4


@pytest.fixture(scope="module")
def frames():
    """Per fixture: the reference forest, its reference-compressed bytes,
    and the port's compressed bytes of the same forest."""
    out = {}
    for name, kw in FIXTURES.items():
        f = random_forest(**kw)
        port_forest = forest_from_arrays(f.trees, f.meta, f.fit_values)
        out[name] = (
            f,
            ref_compress(f, k_max=K_MAX).to_bytes(),
            compress_forest(port_forest, k_max=K_MAX, device="cpu").to_bytes(),
        )
    return out


def _same_trees(a, b) -> bool:
    a, b = list(a), list(b)
    return len(a) == len(b) and all(
        np.array_equal(x.feature, y.feature)
        and np.array_equal(x.threshold, y.threshold)
        and np.array_equal(x.children_left, y.children_left)
        and np.array_equal(x.children_right, y.children_right)
        and np.array_equal(x.node_fit, y.node_fit)
        for x, y in zip(a, b)
    )


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_forest_from_arrays_copies_every_field(name):
    f = random_forest(**FIXTURES[name])
    p = forest_from_arrays(f.trees, f.meta, f.fit_values)
    assert p.n_trees == f.n_trees
    assert _same_trees(p.trees, f.trees)
    assert np.array_equal(p.fit_values, f.fit_values)
    assert p.meta.task == f.meta.task and p.meta.n_classes == f.meta.n_classes
    assert np.array_equal(p.meta.n_bins_per_feature, f.meta.n_bins_per_feature)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_port_decodes_reference_frames(name, frames):
    _f, ref_bytes, _ = frames[name]
    ref = RefCompressed.from_bytes(ref_bytes)
    port = compressed_from_bytes(ref_bytes)
    assert _same_trees(iter_trees(port), ref_iter_trees(ref))
    assert port.to_bytes() == ref_bytes  # re-serialization is byte-exact


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_reference_decodes_port_frames(name, frames):
    f, _, port_bytes = frames[name]
    ref = RefCompressed.from_bytes(port_bytes)
    assert _same_trees(ref_iter_trees(ref), f.trees)
    assert _same_trees(iter_trees(compressed_from_bytes(port_bytes)), f.trees)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_port_encoder_bytes_equal_reference(name, frames):
    """Deterministic encoding: both packages write the same frame (the
    dense clustering's float32 argmin has no ties on these fixtures)."""
    _f, ref_bytes, port_bytes = frames[name]
    assert port_bytes == ref_bytes


def _same_outcome(blob: bytes) -> str:
    """Parse ``blob`` with both packages: both raise the same typed error,
    or both parse to identical trees.  Returns the outcome's name."""
    port_kind = ref_kind = "ok"
    try:
        port = compressed_from_bytes(blob)
    except FramingError as exc:
        port_kind = type(exc).__name__
    try:
        ref = RefCompressed.from_bytes(blob)
    except Exception as exc:  # noqa: BLE001 — compare the type
        ref_kind = type(exc).__name__
    assert port_kind == ref_kind
    if port_kind == "ok":
        assert _same_trees(iter_trees(port), ref_iter_trees(ref))
    return port_kind


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_same_errors_on_truncation(name, frames):
    _f, ref_bytes, _ = frames[name]
    rng = np.random.default_rng(7)
    keeps = sorted({0, 3, 7, len(ref_bytes) // 2,
                    *rng.integers(1, len(ref_bytes), 12).tolist()})
    kinds = [_same_outcome(ref_bytes[:keep]) for keep in keeps]
    assert "ok" not in kinds[:-1] or kinds.count("ok") < len(kinds)
    assert all(k != "ok" for k in kinds[:4])  # cut inside the header


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_same_errors_on_bit_flips(name, frames):
    _f, ref_bytes, _ = frames[name]
    kinds = []
    for seed in range(12):
        blob, bits = flip_bits(ref_bytes, seed, n=1)
        assert (blob, bits) == ref_flip_bits(ref_bytes, seed, n=1)
        kinds.append(_same_outcome(blob))
    assert "IntegrityError" in kinds  # the CRC trailer catches flips


@pytest.mark.parametrize("engine", ["table", "bitwise"])
@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_predict_compressed_matches_reference(name, engine, frames):
    f, ref_bytes, _ = frames[name]
    x = np.random.default_rng(11).integers(0, 16, (64, f.meta.n_features))
    want = ref_predict_compressed(RefCompressed.from_bytes(ref_bytes), x,
                                  engine=engine)
    got = predict_compressed(compressed_from_bytes(ref_bytes), x,
                             engine=engine, device="cpu")
    assert got.dtype == np.float64
    if f.meta.task == "classification":
        np.testing.assert_array_equal(got, want)
    else:  # same float64 accumulation order on both sides
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_torch_traverse_equals_numpy_traverse(name, frames):
    """The torch-gather traversal (the card path of predict_compressed),
    run here on CPU tensors, equals the numpy gathers bit for bit."""
    f, ref_bytes, _ = frames[name]
    sf = stacked_forest(compressed_from_bytes(ref_bytes))
    x = np.random.default_rng(12).integers(0, 16, (64, f.meta.n_features))
    x = x.astype(np.int32)
    want = _batched_leaf_fits(sf, x, torch.device("cpu"))
    got = _torch_leaf_fits(sf, x, torch.device("cpu"))
    np.testing.assert_array_equal(got, want)


def _counts(seed, m=40, b=12):
    rng = np.random.default_rng(seed)
    proto = rng.dirichlet(np.full(b, 0.5), size=3)
    rows = [rng.multinomial(int(rng.integers(5, 60)), proto[i % 3])
            for i in range(m)]
    return np.array(rows, np.float64)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chunked_clustering_assigns_identically(seed):
    counts = _counts(seed)
    want = ref_bregman.cluster_models(counts, 2.0, k_max=5, engine="chunked",
                                      chunk_size=7)
    got = bregman.cluster_models(counts, 2.0, k_max=5, engine="chunked",
                                 chunk_size=7)
    np.testing.assert_array_equal(got.assignments, want.assignments)
    np.testing.assert_array_equal(got.centroids, want.centroids)
    assert got.objective_bits == want.objective_bits


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_dense_clustering_matches_reference(seed):
    """The float32 torch step against the float32 jitted JAX step."""
    counts = _counts(seed)
    for k in (1, 3, 5):
        a_ref, c_ref, o_ref = ref_bregman.kl_kmeans(counts, k, engine="dense")
        a, c, o = bregman.kl_kmeans(counts, k, engine="dense", device="cpu")
        np.testing.assert_array_equal(a, a_ref)
        np.testing.assert_allclose(c, c_ref, rtol=1e-5, atol=1e-6)
        assert o == pytest.approx(o_ref, rel=1e-5, abs=1e-4)


def test_dense_clustering_device_is_explicit():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        bregman.kl_kmeans(_counts(0), 2, engine="dense")
