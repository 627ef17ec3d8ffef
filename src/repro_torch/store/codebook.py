"""Fleet-level shared codebooks (multi-tenant store, piece 1).

The paper's subscriber scenario puts ONE user-specific forest on a
storage-constrained device; at fleet scale the empirical models of
different users' forests are highly redundant.  This module pools the
``stats.extract_records`` model counts across a whole fleet of forests and
runs the same KL K-means / objective-(6) machinery of ``core.bregman`` on
the UNION of all users' models — M is then #users x #model-keys and easily
reaches 1e5+, which is what the chunked assignment engine is for.

The result is a ``SharedCodebook``: per component (variable names, split
values per variable, fits) a set of cluster codebooks built from the pooled
member counts, stored ONCE for the fleet.  Per-user deltas
(``store.delta``) then reference these codebooks by cluster id and carry
only residual streams.

Regression fits are pooled through a fleet-level value table: the union of
every user's distinct 64-bit fit values, stored once; per-user deltas keep
an int32 map from their local fit ids into the fleet table (4 bytes/line
instead of 8) and reconstruct their exact local table from it.

Port note: copied from ``repro.store.codebook``; the only change is the
explicit ``device`` that the clustering takes (it is where
``core.bregman``'s dense engine runs; the default chunked engine is host
numpy and ignores it).
"""
from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np

from ..core.arithmetic import ArithmeticCode
from ..core.bregman import cluster_models
from ..core.huffman import HuffmanCode
from ..core.stats import (
    alpha_fits,
    alpha_splits,
    alpha_vars,
    extract_records,
    fit_counts,
    split_counts,
    var_name_counts,
)
import torch

from ..core.tree import Forest, ForestMeta
from ..core.framing import (
    check_crc,
    expect_magic,
    read_arr,
    read_struct,
    with_crc,
    write_arr,
)

_MAGIC = b"RFS1"


@dataclass
class SharedComponent:
    """One component's fleet-level cluster codebooks.

    ``coder == "huffman"``: ``codebook_lengths[k]`` is the canonical code
    length table of cluster k (built from the pooled member counts).
    ``coder == "arithmetic"``: ``freqs[k]`` is the pooled count table the
    static arithmetic coder is constructed from on both ends.
    """

    coder: str  # "huffman" | "arithmetic"
    alphabet: int
    codebook_lengths: list[np.ndarray] = field(default_factory=list)
    freqs: list[np.ndarray] = field(default_factory=list)

    @property
    def n_clusters(self) -> int:
        if self.coder == "huffman":
            return len(self.codebook_lengths)
        return len(self.freqs)

    def coder_for(self, k: int):
        """Instantiate cluster ``k``'s entropy coder (HuffmanCode from its
        canonical lengths, or ArithmeticCode from its pooled counts)."""
        if self.coder == "huffman":
            return HuffmanCode(self.codebook_lengths[k])
        return ArithmeticCode(self.freqs[k])

    def cost_table(self) -> np.ndarray:
        """(K, B) expected bits per symbol occurrence under each cluster's
        code; +inf where the cluster cannot code the symbol at all.  Deltas
        pick, per model, the cluster minimizing ACTUAL coded bits — the
        store-side analogue of the KL assignment (up to Huffman integer
        rounding), and exactly the quantity billed on disk.

        Clusters appended by an ``extend``-mode recluster may carry tables
        shorter than the component's (grown) alphabet — symbols past a
        cluster's table end are simply uncodable by it (+inf)."""
        k = self.n_clusters
        cost = np.full((k, self.alphabet), np.inf)
        for c in range(k):
            if self.coder == "huffman":
                ln = np.asarray(self.codebook_lengths[c], dtype=np.float64)
                cost[c, : len(ln)][ln > 0] = ln[ln > 0]
            else:
                f = np.asarray(self.freqs[c], dtype=np.float64)
                tot = f.sum()
                cost[c, : len(f)][f > 0] = -np.log2(f[f > 0] / tot)
        return cost


@dataclass
class SharedCodebook:
    """Fleet-wide schema + shared cluster codebooks for every component.

    ``generation`` is the codebook's lifecycle version (v1, v2, ...): the
    store's re-clustering operation (``store.lifecycle.recluster``) builds
    a successor codebook with ``generation + 1`` and migrates user deltas
    onto it; every ``UserDelta`` records the generation it references, so
    old and new codebooks can coexist mid-migration.

    ``fleet_fit_values`` (regression) is the fleet-union value table.  It
    is SORTED within each generation's contribution but only
    APPEND-ORDERED across generations: an ``extend``-mode recluster
    appends newly-onboarded values after the previous generation's block,
    so existing deltas' fit-symbol ids stay valid without re-encoding.
    """

    n_features: int
    task: str  # "classification" | "regression"
    n_classes: int
    t_max: int  # fleet max depth + 1 (model-key table height)
    n_train_obs: int  # fleet max (alpha bookkeeping only)
    n_bins_per_feature: np.ndarray  # (d,) int32
    categorical: np.ndarray  # (d,) bool
    vars_comp: SharedComponent
    splits_comp: dict[int, SharedComponent]
    fits_comp: SharedComponent
    fleet_fit_values: np.ndarray  # regression: append-ordered union table
    generation: int = 1  # codebook lifecycle version (v1, v2, ...)

    def user_meta(self, n_train_obs: int) -> ForestMeta:
        """The fleet schema as one user's ``ForestMeta`` (the per-user
        ``n_train_obs`` is the only field the fleet does not fix)."""
        return ForestMeta(
            n_features=self.n_features,
            task=self.task,
            n_classes=self.n_classes,
            n_bins_per_feature=self.n_bins_per_feature,
            n_train_obs=n_train_obs,
            categorical=self.categorical,
        )

    # ---------------- serialization ---------------------------------------
    def to_bytes(self) -> bytes:
        """Serialize as one RFS1 frame (normative spec: docs/format.md)."""
        out = io.BytesIO()
        out.write(_MAGIC)
        out.write(
            struct.pack(
                "<HIBHHI",
                self.generation,
                self.n_features,
                1 if self.task == "regression" else 0,
                self.n_classes,
                self.t_max,
                self.n_train_obs,
            )
        )
        write_arr(out, self.n_bins_per_feature.astype(np.int32))
        write_arr(out, self.categorical.astype(np.uint8))
        _write_component(out, self.vars_comp)
        out.write(struct.pack("<H", len(self.splits_comp)))
        for v, c in sorted(self.splits_comp.items()):
            out.write(struct.pack("<H", v))
            _write_component(out, c)
        _write_component(out, self.fits_comp)
        write_arr(out, self.fleet_fit_values.astype(np.float64))
        return with_crc(out.getvalue())

    @classmethod
    def from_bytes(cls, data: bytes) -> "SharedCodebook":
        """Parse one RFS1 frame (normative spec: docs/format.md).  The
        CRC32 trailer is verified when present; corruption raises a typed
        ``core.framing.IntegrityError`` / ``TruncatedFrameError``."""
        inp = io.BytesIO(check_crc(data, "RFS1 shared codebook"))
        expect_magic(inp, _MAGIC, "RFS1 shared codebook")
        gen, d, is_reg, n_classes, t_max, n_obs = read_struct(
            inp, "<HIBHHI", "RFS1 header"
        )
        n_bins = read_arr(inp).astype(np.int32)
        categorical = read_arr(inp).astype(bool)
        vars_comp = _read_component(inp)
        (ns,) = read_struct(inp, "<H", "RFS1 split-component count")
        splits_comp = {}
        for _ in range(ns):
            (v,) = read_struct(inp, "<H", "RFS1 split variable id")
            splits_comp[v] = _read_component(inp)
        fits_comp = _read_component(inp)
        fleet_fit_values = read_arr(inp).astype(np.float64)
        return cls(
            n_features=d,
            task="regression" if is_reg else "classification",
            n_classes=n_classes,
            t_max=t_max,
            n_train_obs=n_obs,
            n_bins_per_feature=n_bins,
            categorical=categorical,
            vars_comp=vars_comp,
            splits_comp=splits_comp,
            fits_comp=fits_comp,
            fleet_fit_values=fleet_fit_values,
            generation=gen,
        )


def _write_component(out: io.BytesIO, c: SharedComponent) -> None:
    out.write(
        struct.pack(
            "<BHI",
            1 if c.coder == "arithmetic" else 0,
            c.n_clusters,
            c.alphabet,
        )
    )
    for k in range(c.n_clusters):
        if c.coder == "huffman":
            write_arr(out, np.asarray(c.codebook_lengths[k], np.uint8))
        else:
            write_arr(out, np.asarray(c.freqs[k], np.int64))


def _read_component(inp: io.BytesIO) -> SharedComponent:
    is_arith, nk, alphabet = read_struct(
        inp, "<BHI", "RFS1 component header"
    )
    comp = SharedComponent(
        "arithmetic" if is_arith else "huffman", alphabet
    )
    for _ in range(nk):
        tab = read_arr(inp)
        if is_arith:
            comp.freqs.append(tab.astype(np.int64))
        else:
            comp.codebook_lengths.append(tab.astype(np.int32))
    return comp


def fit_value_ids(
    table: np.ndarray, vals: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Look up ``vals`` in a fleet fit-value ``table`` that is only
    APPEND-ORDERED (sorted per generation block, not globally — see
    ``SharedCodebook``).  Returns ``(hit, ids)``: ``hit[i]`` is True when
    ``vals[i]`` exists in the table and ``ids[i]`` is then its table
    position (first occurrence); ``ids`` is undefined where ``hit`` is
    False.  O((T+V) log T) via an argsort view."""
    vals = np.asarray(vals, np.float64)
    if not len(table) or not len(vals):
        return np.zeros(len(vals), bool), np.zeros(len(vals), np.int64)
    order = np.argsort(table, kind="stable")  # stable: first occurrence wins
    sorted_table = table[order]
    pos = np.searchsorted(sorted_table, vals)
    pos_c = np.minimum(pos, len(table) - 1)
    hit = (sorted_table[pos_c] == vals) & (pos < len(table))
    return hit, order[pos_c].astype(np.int64)


def _validate_fleet_schema(forests: Sequence[Forest]) -> ForestMeta:
    if not forests:
        raise ValueError("cannot build a shared codebook from an empty fleet")
    m0 = forests[0].meta
    for f in forests[1:]:
        m = f.meta
        if (
            m.n_features != m0.n_features
            or m.task != m0.task
            or m.n_classes != m0.n_classes
            or not np.array_equal(m.n_bins_per_feature, m0.n_bins_per_feature)
            or not np.array_equal(m.categorical, m0.categorical)
        ):
            raise ValueError(
                "fleet forests must share one schema "
                "(n_features/task/n_classes/bins/categorical)"
            )
    return m0


def cluster_codebooks(
    rows: np.ndarray,
    alpha_bits: float,
    coder: str,
    k_max: int,
    seed: int,
    engine: str = "chunked",
    chunk_size: int = 65536,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, list[np.ndarray], list[np.ndarray]]:
    """Cluster count rows under objective (6) and build one codebook per
    used cluster from the pooled member counts.  Shared by the fleet
    builder and the per-user local-cluster fallback (``store.delta``).

    Returns (compact assignments (M,), huffman lengths per cluster,
    arithmetic freq tables per cluster) — one of the two lists is empty,
    per ``coder``."""
    res = cluster_models(
        rows, alpha_bits, k_max=k_max, seed=seed,
        engine=engine, chunk_size=chunk_size, device=device,
    )
    uniq, compact = np.unique(res.assignments, return_inverse=True)
    lengths: list[np.ndarray] = []
    freqs: list[np.ndarray] = []
    for c in range(len(uniq)):
        pooled = rows[compact == c].sum(0)
        if coder == "huffman":
            lengths.append(HuffmanCode.from_freqs(pooled).lengths)
        else:
            freqs.append(pooled.astype(np.int64))
    return compact, lengths, freqs


def _pool_and_cluster(
    per_user_counts: list[np.ndarray],
    alpha_bits: float,
    coder: str,
    k_max: int,
    seed: int,
    engine: str,
    chunk_size: int,
    device: str | torch.device = "cuda",
) -> SharedComponent:
    """Stack every user's USED model rows, cluster the union, and build one
    codebook per cluster from the pooled member counts."""
    alphabet = per_user_counts[0].shape[1]
    used_rows = [c[c.sum(-1) > 0] for c in per_user_counts]
    stacked = (
        np.concatenate([r for r in used_rows if len(r)])
        if any(len(r) for r in used_rows)
        else np.zeros((0, alphabet))
    )
    comp = SharedComponent(coder, alphabet)
    if not len(stacked):
        return comp
    _, comp.codebook_lengths, comp.freqs = cluster_codebooks(
        stacked, alpha_bits, coder, k_max, seed, engine, chunk_size, device
    )
    return comp


def build_shared_codebook(
    forests: Sequence[Forest],
    k_max: int = 16,
    seed: int = 0,
    engine: str = "chunked",
    chunk_size: int = 65536,
    generation: int = 1,
    device: str | torch.device = "cuda",
) -> SharedCodebook:
    """Pool model counts across a fleet of forests and build the shared
    cluster codebooks (fleet-scale Bregman clustering, objective (6) over
    the union of all users' models).  ``generation`` stamps the codebook's
    lifecycle version (a ``full``-mode recluster passes the successor
    generation; fresh builds are v1).  ``device`` is where the dense
    clustering engine runs."""
    meta = _validate_fleet_schema(forests)
    d = meta.n_features
    recs = [extract_records(f) for f in forests]
    t_max = max(
        (int(r.depth.max()) + 1 if len(r.depth) else 1) for r in recs
    )
    n_train = max(f.meta.n_train_obs for f in forests)

    # ---- fits alphabet: classes, or the fleet-union value table ----------
    if meta.task == "classification":
        fleet_values = np.zeros(0, np.float64)
        n_fit_syms = meta.n_classes
        fit_syms = [r.fit.astype(np.int64) for r in recs]
        fits_coder = "arithmetic" if meta.n_classes == 2 else "huffman"
    else:
        fleet_values = np.unique(
            np.concatenate(
                [np.asarray(f.fit_values, np.float64) for f in forests]
            )
        )
        n_fit_syms = len(fleet_values)
        fit_syms = []
        for f, r in zip(forests, recs):
            fmap = np.searchsorted(fleet_values, f.fit_values)
            fit_syms.append(fmap[r.fit.astype(np.int64)])
        fits_coder = "huffman"

    vars_comp = _pool_and_cluster(
        [var_name_counts(r, d, t_max) for r in recs],
        alpha_vars(d), "huffman", k_max, seed, engine, chunk_size, device,
    )

    splits_comp: dict[int, SharedComponent] = {}
    per_var: dict[int, list[np.ndarray]] = {}
    for r in recs:
        for v, cnts in split_counts(r, d, t_max, meta.n_bins_per_feature).items():
            per_var.setdefault(v, []).append(cnts)
    for v, counts_list in sorted(per_var.items()):
        a = alpha_splits(
            not bool(meta.categorical[v]), n_train,
            int(meta.n_bins_per_feature[v]),
        )
        splits_comp[v] = _pool_and_cluster(
            counts_list, a, "huffman", k_max, seed, engine, chunk_size, device,
        )

    fits_counts_list = []
    for r, syms in zip(recs, fit_syms):
        rf = type(r)(
            tree_id=r.tree_id, depth=r.depth, father_var=r.father_var,
            var=r.var, split=r.split, fit=syms, is_leaf=r.is_leaf,
        )
        fits_counts_list.append(fit_counts(rf, d, t_max, n_fit_syms))
    fits_comp = _pool_and_cluster(
        fits_counts_list, alpha_fits(meta.task, n_fit_syms), fits_coder,
        k_max, seed, engine, chunk_size, device,
    )

    return SharedCodebook(
        n_features=d,
        task=meta.task,
        n_classes=meta.n_classes,
        t_max=t_max,
        n_train_obs=n_train,
        n_bins_per_feature=np.asarray(meta.n_bins_per_feature, np.int32),
        categorical=np.asarray(meta.categorical, bool),
        vars_comp=vars_comp,
        splits_comp=splits_comp,
        fits_comp=fits_comp,
        fleet_fit_values=fleet_values,
        generation=generation,
    )
