"""Lossless forest compression — the paper's Algorithm 1.

Pipeline
--------
1. Structure: per-tree Zaks sequences, concatenated, LZW-coded (§3.1).
2. Variable names: empirical models P(var | depth, father's var), clustered
   with KL K-means under objective (6); one canonical-Huffman codebook per
   cluster (§3.2).
3. Split values: per-variable models P(split | depth, var, father's var),
   clustered per variable (Algorithm 1 line 39).
4. Fits: P(fit | depth, father's var); Huffman, or arithmetic coding for
   two-class problems (Algorithm 1 line 40 / §4).

Symbols are emitted in GLOBAL PREORDER (tree by tree, preorder within a
tree) into one bitstream per cluster.  The decoder reproduces the exact
same order from the decoded structure + already-decoded parents, so the
streams need no per-node framing.  (Algorithm 1 groups per-model sequences
inside each cluster; interleaving by preorder is rate-identical under the
same codebook and enables streaming prediction — see compressed_predict.)

Everything here is byte-honest: ``CompressedForest.to_bytes()`` is a real
serialization, and the size report in ``size_report()`` is measured from
those bytes, bucketed as in the paper's Table 1.

Codebook ownership is pluggable: the preorder stream emission
(``emit_streams``) is driven by ``ComponentCodec`` objects — a kid→cluster
map plus one symbol coder per cluster — and does not care where the
codebooks live.  ``compress_forest`` builds them inline per forest (the
paper's single-subscriber format); the multi-tenant store
(``repro.store``) builds them against fleet-level shared codebooks and
stores only per-user residual streams.
"""
from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field

import numpy as np

from .arithmetic import ArithmeticCode
from .bitio import BitReader, BitWriter
from .bregman import ClusteringResult, cluster_models
from .framing import (
    check_crc,
    expect_magic,
    read_arr,
    read_bytes,
    read_struct,
    with_crc,
    write_arr,
    write_bytes,
)
from .huffman import HuffmanCode
from .lz import lzw_decode_bits, lzw_encode_bits
from .stats import (
    alpha_fits,
    alpha_splits,
    alpha_vars,
    extract_records,
    fit_counts,
    key_id,
    split_counts,
    var_name_counts,
)
from .tree import Forest, ForestMeta, Tree
from .zaks import zaks_decode, zaks_encode


# --------------------------------------------------------------------------
# component containers
# --------------------------------------------------------------------------
@dataclass
class ClusteredComponent:
    """One compressed component: cluster map + per-cluster codebooks+streams."""

    kid_to_cluster: np.ndarray  # (n_keys,) int16; -1 for unused keys
    codebook_lengths: list[np.ndarray]  # per cluster: (B,) Huffman lengths
    streams: list[bytes]  # per cluster: coded payload
    n_symbols: list[int]  # per cluster: symbol count
    coder: str = "huffman"  # or "arithmetic"
    centroid_freqs: list[np.ndarray] = field(default_factory=list)  # arithmetic

    def decoders(self):
        if self.coder == "huffman":
            return [HuffmanCode(l) for l in self.codebook_lengths]
        return [ArithmeticCode(f) for f in self.centroid_freqs]


@dataclass
class ComponentCodec:
    """A component's resolved coding state with pluggable codebook ownership:
    the kid→cluster map plus one symbol coder per cluster id.  ``coders``
    entries may be None for clusters the map never references (external
    store codebooks the forest at hand does not use)."""

    kid_to_cluster: np.ndarray
    coders: list

    @classmethod
    def of_component(cls, c: ClusteredComponent) -> "ComponentCodec":
        return cls(c.kid_to_cluster, c.decoders())

    @property
    def n_clusters(self) -> int:
        return len(self.coders)


def emit_streams(
    rec,
    d: int,
    vars_codec: ComponentCodec,
    split_codecs: dict[int, ComponentCodec],
    fits_codec: ComponentCodec,
    fit_syms_global: np.ndarray,
):
    """Encode every per-node symbol in GLOBAL PREORDER into per-cluster
    streams, against whatever codebooks the ``ComponentCodec``s resolve to
    (inline per-forest, or fleet-shared plus user-local).

    Vars/splits are Huffman symbol-at-a-time; fits are gathered per cluster
    and whole-sequence coded (required by the arithmetic coder, harmless for
    Huffman).  Returns ``(vars_streams, vars_n, split_streams, split_n,
    fits_streams, fits_n)`` where the split entries are per-variable dicts.
    """
    kid_all = key_id(rec.depth, rec.father_var, d)

    vars_writers = [BitWriter() for _ in vars_codec.coders]
    vars_n = [0] * vars_codec.n_clusters
    split_writers = {
        v: [BitWriter() for _ in c.coders] for v, c in split_codecs.items()
    }
    split_n = {v: [0] * c.n_clusters for v, c in split_codecs.items()}
    fits_seq_per_cluster: list[list[int]] = [
        [] for _ in range(fits_codec.n_clusters)
    ]

    internal = ~rec.is_leaf
    for i in range(len(rec.depth)):
        kid = int(kid_all[i])
        if internal[i]:
            c = int(vars_codec.kid_to_cluster[kid])
            vars_codec.coders[c].encode_symbol(vars_writers[c], int(rec.var[i]))
            vars_n[c] += 1
            v = int(rec.var[i])
            sc = int(split_codecs[v].kid_to_cluster[kid])
            split_codecs[v].coders[sc].encode_symbol(
                split_writers[v][sc], int(rec.split[i])
            )
            split_n[v][sc] += 1
        fc = int(fits_codec.kid_to_cluster[kid])
        fits_seq_per_cluster[fc].append(int(fit_syms_global[i]))

    vars_streams = [w.getvalue() for w in vars_writers]
    split_streams = {
        v: [w.getvalue() for w in ws] for v, ws in split_writers.items()
    }
    fits_streams = [
        fits_codec.coders[c].encode(seq) if len(seq) else b""
        for c, seq in enumerate(fits_seq_per_cluster)
    ]
    fits_n = [len(s) for s in fits_seq_per_cluster]
    return vars_streams, vars_n, split_streams, split_n, fits_streams, fits_n


#: magic of the inline single-forest frame (legacy format; docs/format.md §7)
_RFC_MAGIC = b"RFC1"


def _write_rfc_component(out: io.BytesIO, c: ClusteredComponent) -> None:
    """Write one RFC1 COMPONENT record (mirror of ``_read_rfc_component``):
    u8 coder flag, ARR cluster map, u16 cluster count, then per cluster an
    ARR codebook table, u32 symbol count, and a BYTES stream."""
    out.write(struct.pack("<B", 1 if c.coder == "arithmetic" else 0))
    write_arr(out, c.kid_to_cluster.astype(np.int16))
    out.write(struct.pack("<H", len(c.streams)))
    for k in range(len(c.streams)):
        if c.coder == "huffman":
            write_arr(out, c.codebook_lengths[k].astype(np.uint8))
        else:
            write_arr(out, c.centroid_freqs[k].astype(np.uint32))
        out.write(struct.pack("<I", c.n_symbols[k]))
        write_bytes(out, c.streams[k])


def _read_rfc_component(inp: io.BytesIO) -> ClusteredComponent:
    """Read one RFC1 COMPONENT record written by ``_write_rfc_component``."""
    (is_arith,) = read_struct(inp, "<B", "RFC1 component coder flag")
    kid_to_cluster = read_arr(inp).astype(np.int16)
    (nk,) = read_struct(inp, "<H", "RFC1 component cluster count")
    lengths, freqs, streams, n_symbols = [], [], [], []
    for _ in range(nk):
        tab = read_arr(inp)
        if is_arith:
            freqs.append(tab.astype(np.int64))
            lengths.append(np.zeros(0, np.int32))
        else:
            lengths.append(tab.astype(np.int32))
        (ns,) = read_struct(inp, "<I", "RFC1 component symbol count")
        n_symbols.append(ns)
        streams.append(read_bytes(inp))
    return ClusteredComponent(
        kid_to_cluster, lengths, streams, n_symbols,
        "arithmetic" if is_arith else "huffman", freqs,
    )


@dataclass
class CompressedForest:
    meta: ForestMeta
    n_trees: int
    zaks_payload: bytes
    zaks_total_bits: int
    zaks_lengths: np.ndarray  # (n_trees,) int32 — bits per tree
    vars_comp: ClusteredComponent
    splits_comp: dict[int, ClusteredComponent]  # per variable
    fits_comp: ClusteredComponent
    fit_values: np.ndarray  # regression: distinct 64-bit fit values
    max_depth: int

    # ---------------- size accounting (paper Table 1 buckets) -------------
    def size_report(self) -> dict[str, float]:
        def comp_stream_bytes(c: ClusteredComponent) -> int:
            return sum(len(s) for s in c.streams)

        def comp_dict_bytes(c: ClusteredComponent) -> int:
            b = len(c.kid_to_cluster) * 2  # cluster map, int16/line
            for lengths in c.codebook_lengths:
                b += int((np.asarray(lengths) > 0).sum()) * 2  # (sym,len) lines
            for f in c.centroid_freqs:
                b += int((np.asarray(f) > 0).sum()) * 4
            return b

        structure = len(self.zaks_payload) + len(self.zaks_lengths) * 4
        names = comp_stream_bytes(self.vars_comp)
        splits = sum(comp_stream_bytes(c) for c in self.splits_comp.values())
        fits = comp_stream_bytes(self.fits_comp)
        dicts = (
            comp_dict_bytes(self.vars_comp)
            + sum(comp_dict_bytes(c) for c in self.splits_comp.values())
            + comp_dict_bytes(self.fits_comp)
            + self.fit_values.size * 8  # 64-bit fit-value dictionary
        )
        total = structure + names + splits + fits + dicts
        return {
            "structure": structure,
            "var_names": names,
            "split_values": splits,
            "fits": fits,
            "dictionaries": dicts,
            "total": total,
            "total_serialized": len(self.to_bytes()),
        }

    # ---------------- serialization ---------------------------------------
    def to_bytes(self) -> bytes:
        m = self.meta
        out = io.BytesIO()
        out.write(_RFC_MAGIC)
        out.write(
            struct.pack(
                "<IIHIB", self.n_trees, m.n_features, m.n_classes,
                m.n_train_obs, 1 if m.task == "regression" else 0,
            )
        )
        out.write(struct.pack("<HI", self.max_depth, self.zaks_total_bits))
        write_arr(out, m.n_bins_per_feature.astype(np.int32))
        write_arr(out, m.categorical.astype(np.uint8))
        write_arr(out, self.zaks_lengths.astype(np.int32))
        write_bytes(out, self.zaks_payload)
        _write_rfc_component(out, self.vars_comp)
        out.write(struct.pack("<H", len(self.splits_comp)))
        for v, c in sorted(self.splits_comp.items()):
            out.write(struct.pack("<H", v))
            _write_rfc_component(out, c)
        _write_rfc_component(out, self.fits_comp)
        write_arr(out, self.fit_values.astype(np.float64))
        return with_crc(out.getvalue())

    @classmethod
    def from_bytes(cls, data: bytes) -> "CompressedForest":
        """Parse one RFC1 frame.  The CRC32 trailer is verified when
        present (pre-ISSUE-9 frames without one still parse); truncated
        or corrupted frames raise a typed ``core.framing.FramingError``
        instead of ``struct.error`` / ``AssertionError``."""
        inp = io.BytesIO(check_crc(data, "RFC1 compressed forest"))
        expect_magic(inp, _RFC_MAGIC, "RFC1 compressed forest")
        n_trees, d, n_classes, n_obs, is_reg = read_struct(
            inp, "<IIHIB", "RFC1 header"
        )
        max_depth, zaks_total_bits = read_struct(
            inp, "<HI", "RFC1 structure header"
        )
        n_bins = read_arr(inp).astype(np.int32)
        categorical = read_arr(inp).astype(bool)
        meta = ForestMeta(
            n_features=d,
            task="regression" if is_reg else "classification",
            n_classes=n_classes,
            n_bins_per_feature=n_bins,
            n_train_obs=n_obs,
            categorical=categorical,
        )
        zaks_lengths = read_arr(inp).astype(np.int32)
        zaks_payload = read_bytes(inp)
        vars_comp = _read_rfc_component(inp)
        (nsplit,) = read_struct(inp, "<H", "RFC1 split-component count")
        splits_comp = {}
        for _ in range(nsplit):
            (v,) = read_struct(inp, "<H", "RFC1 split variable id")
            splits_comp[v] = _read_rfc_component(inp)
        fits_comp = _read_rfc_component(inp)
        fit_values = read_arr(inp).astype(np.float64)
        return cls(
            meta, n_trees, zaks_payload, zaks_total_bits, zaks_lengths,
            vars_comp, splits_comp, fits_comp, fit_values, max_depth,
        )


# --------------------------------------------------------------------------
# encoder
# --------------------------------------------------------------------------
def _build_component(
    counts: np.ndarray,
    alpha_bits: float,
    coder: str,
    k_max: int,
    seed: int,
    device: str = "cuda",
) -> tuple[ClusteredComponent, ClusteringResult]:
    """Cluster the models and build per-cluster codebooks.

    Codebooks are built from the SUM OF MEMBER COUNTS (the empirical
    distribution the cluster actually codes) — this is the Huffman code "for
    Q_k" and guarantees every coded symbol has a codeword (paper §5)."""
    used = np.flatnonzero(counts.sum(-1) > 0)
    full_map = np.full(counts.shape[0], -1, dtype=np.int16)
    if len(used) == 0:
        comp = ClusteredComponent(full_map, [], [], [], coder, [])
        return comp, ClusteringResult(np.zeros(0, int), np.zeros((0, 0)), 0, 0, 0, 0)
    res = cluster_models(
        counts[used], alpha_bits, k_max=k_max, seed=seed, device=device
    )
    # compact cluster ids to 0..K-1
    uniq, compact = np.unique(res.assignments, return_inverse=True)
    full_map[used] = compact.astype(np.int16)
    k = len(uniq)
    codebooks, cfreqs = [], []
    for c in range(k):
        member_counts = counts[used][compact == c].sum(0)
        if coder == "huffman":
            codebooks.append(HuffmanCode.from_freqs(member_counts).lengths)
            cfreqs.append(np.zeros(0, np.int64))
        else:
            codebooks.append(np.zeros(0, np.int32))
            cfreqs.append(member_counts.astype(np.int64))
    comp = ClusteredComponent(full_map, codebooks, [], [], coder, cfreqs)
    return comp, res


def compress_forest(
    forest: Forest, k_max: int = 12, seed: int = 0, device: str = "cuda"
) -> CompressedForest:
    """Algorithm 1: compress ``forest`` into a ``CompressedForest``.
    ``device`` is where the dense Bregman clustering runs (see
    ``bregman.kl_kmeans``); the rest of the encoder is host numpy."""
    meta = forest.meta
    d = meta.n_features
    rec = extract_records(forest)
    t_max = int(rec.depth.max()) + 1 if len(rec.depth) else 1

    # ---- 1. structure ----------------------------------------------------
    zaks_list = [zaks_encode(t) for t in forest.trees]
    zaks_lengths = np.array([len(z) for z in zaks_list], dtype=np.int32)
    zaks_all = (
        np.concatenate(zaks_list) if zaks_list else np.zeros(0, np.uint8)
    )
    zaks_payload = lzw_encode_bits(zaks_all)

    # ---- 2. variable names -----------------------------------------------
    v_counts = var_name_counts(rec, d, t_max)
    vars_comp, _ = _build_component(
        v_counts, alpha_vars(d), "huffman", k_max, seed, device
    )

    # ---- 3. split values (per variable) ----------------------------------
    s_counts = split_counts(rec, d, t_max, meta.n_bins_per_feature)
    splits_comp: dict[int, ClusteredComponent] = {}
    for v, cnts in s_counts.items():
        a = alpha_splits(
            not bool(meta.categorical[v]),
            meta.n_train_obs,
            int(meta.n_bins_per_feature[v]),
        )
        splits_comp[v], _ = _build_component(
            cnts, a, "huffman", k_max, seed, device
        )

    # ---- 4. fits -----------------------------------------------------------
    if meta.task == "classification":
        n_fit_syms = meta.n_classes
        fit_values = np.zeros(0, np.float64)
        fit_syms_global = rec.fit.astype(np.int64)
        fits_coder = "arithmetic" if meta.n_classes == 2 else "huffman"
    else:
        # regression: node fits are already indices into forest.fit_values
        fit_values = np.asarray(forest.fit_values, dtype=np.float64)
        n_fit_syms = len(fit_values)
        fit_syms_global = rec.fit.astype(np.int64)
        fits_coder = "huffman"
    f_counts = fit_counts(rec, d, t_max, n_fit_syms)
    fits_comp, _ = _build_component(
        f_counts, alpha_fits(meta.task, n_fit_syms), fits_coder, k_max,
        seed, device,
    )

    # ---- 5. emit streams in global preorder --------------------------------
    vs, vn, ss, sn, fs, fn = emit_streams(
        rec, d,
        ComponentCodec.of_component(vars_comp),
        {v: ComponentCodec.of_component(c) for v, c in splits_comp.items()},
        ComponentCodec.of_component(fits_comp),
        fit_syms_global,
    )
    vars_comp.streams = vs
    vars_comp.n_symbols = vn
    for v, c in splits_comp.items():
        c.streams = ss[v]
        c.n_symbols = sn[v]
    fits_comp.streams = fs
    fits_comp.n_symbols = fn

    return CompressedForest(
        meta=meta,
        n_trees=forest.n_trees,
        zaks_payload=zaks_payload,
        zaks_total_bits=int(zaks_lengths.sum()),
        zaks_lengths=zaks_lengths,
        vars_comp=vars_comp,
        splits_comp=splits_comp,
        fits_comp=fits_comp,
        fit_values=fit_values,
        max_depth=t_max - 1,
    )


# --------------------------------------------------------------------------
# decoder (full reconstruction; streaming prediction lives in
# compressed_predict.py)
# --------------------------------------------------------------------------
def decompress_forest(comp: CompressedForest) -> Forest:
    meta = comp.meta
    d = meta.n_features

    zaks_all = lzw_decode_bits(comp.zaks_payload, comp.zaks_total_bits)
    vars_dec = comp.vars_comp.decoders()
    vars_readers = [BitReader(s) for s in comp.vars_comp.streams]
    split_dec = {v: c.decoders() for v, c in comp.splits_comp.items()}
    split_readers = {
        v: [BitReader(s) for s in c.streams]
        for v, c in comp.splits_comp.items()
    }
    # arithmetic/huffman fits: decode each cluster's full symbol sequence up
    # front, then consume in preorder.
    fits_dec = comp.fits_comp.decoders()
    fits_seqs = [
        dec.decode(s, n) if n else np.zeros(0, np.int64)
        for dec, s, n in zip(
            fits_dec, comp.fits_comp.streams, comp.fits_comp.n_symbols
        )
    ]
    fits_cursor = [0] * len(fits_seqs)

    trees = []
    off = 0
    for tlen in comp.zaks_lengths:
        bits = zaks_all[off : off + int(tlen)]
        off += int(tlen)
        left, right, is_leaf = zaks_decode(bits)
        n = len(bits)
        feature = np.full(n, -1, dtype=np.int32)
        threshold = np.full(n, -1, dtype=np.int32)
        fit = np.zeros(n, dtype=np.int64)
        depth = np.zeros(n, dtype=np.int32)
        fvar = np.full(n, -1, dtype=np.int32)
        for i in range(n):  # preorder; parents precede children
            kid = int(depth[i]) * (d + 1) + int(fvar[i]) + 1
            if not is_leaf[i]:
                c = int(comp.vars_comp.kid_to_cluster[kid])
                v = vars_dec[c].decode_symbol(vars_readers[c])
                feature[i] = v
                sc = int(comp.splits_comp[v].kid_to_cluster[kid])
                threshold[i] = split_dec[v][sc].decode_symbol(
                    split_readers[v][sc]
                )
                for ch in (left[i], right[i]):
                    depth[ch] = depth[i] + 1
                    fvar[ch] = v
            fc = int(comp.fits_comp.kid_to_cluster[kid])
            fit[i] = fits_seqs[fc][fits_cursor[fc]]
            fits_cursor[fc] += 1
        trees.append(Tree(feature, threshold, left, right, fit))
    return Forest(trees=trees, meta=meta, fit_values=comp.fit_values)
