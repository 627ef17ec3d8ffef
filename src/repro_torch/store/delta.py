"""Per-user delta encoding against the fleet codebook (store piece 2).

A ``UserDelta`` is a user's forest compressed AGAINST the shared fleet
codebooks: it stores the structure stream (per-user Zaks + LZW, as in the
inline codec), a per-component kid→cluster map whose entries reference the
SHARED cluster codebooks by id, and the residual symbol streams — but no
codebooks of its own.  Dictionary bytes, the dominant cost for small
subscriber forests, are paid once per fleet instead of once per user.

Cluster choice is byte-exact greedy: each of the user's models picks the
shared cluster minimizing the ACTUAL coded bits of its symbols (Huffman
code lengths / arithmetic -log2 q), restricted to clusters that can code
every symbol the model emits.  Models no shared cluster can code (possible
only for users onboarded after the codebook was frozen, with symbols the
fleet never produced) fall back to USER-LOCAL clusters whose codebooks ship
inside the delta — lossless onboarding without a fleet rebuild.

``hydrate`` resolves a delta back into a plain inline ``CompressedForest``
(codebook ownership is pluggable in ``core.forest_codec``), so every
existing consumer — ``decompress_forest``, ``predict_compressed``, the
serving engines — works on store-resident forests unchanged.
Reconstruction is bit-exact, including regression fit-value tables, which
round-trip through the fleet-union table plus a per-user int32 map.

Port note: copied from ``repro.store.delta`` with its relative imports;
nothing here touches a device (the user-local fallback clustering runs
``core.bregman``'s host chunked engine).
"""
from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field

import numpy as np

from ..core.arithmetic import ArithmeticCode
from ..core.forest_codec import (
    ClusteredComponent,
    ComponentCodec,
    CompressedForest,
    decompress_forest,
    emit_streams,
)
from ..core.huffman import HuffmanCode
from ..core.lz import lzw_encode_bits
from ..core.stats import (
    alpha_fits,
    alpha_splits,
    alpha_vars,
    extract_records,
    fit_counts,
    key_id,
    split_counts,
    var_name_counts,
)
from ..core.framing import (
    check_crc,
    expect_magic,
    read_arr,
    read_bytes,
    read_struct,
    with_crc,
    write_arr,
    write_bytes,
)
from ..core.tree import Forest
from ..core.zaks import zaks_encode
from .codebook import (
    SharedCodebook,
    SharedComponent,
    cluster_codebooks,
    fit_value_ids,
)

_MAGIC = b"RFD1"


@dataclass
class DeltaComponent:
    """One component of a user delta: shared-or-local cluster references plus
    the user's residual streams.

    ``kid_to_ref`` entries: -1 for unused keys, ``0..S-1`` reference the
    shared codebook's clusters, ``S + j`` references user-local cluster j
    (codebooks stored inline below)."""

    coder: str  # "huffman" | "arithmetic"
    kid_to_ref: np.ndarray  # (n_user_keys,) int16
    local_lengths: list[np.ndarray] = field(default_factory=list)
    local_freqs: list[np.ndarray] = field(default_factory=list)
    refs: np.ndarray = field(default_factory=lambda: np.zeros(0, np.int16))
    n_symbols: list[int] = field(default_factory=list)
    streams: list[bytes] = field(default_factory=list)

    @property
    def n_local(self) -> int:
        if self.coder == "huffman":
            return len(self.local_lengths)
        return len(self.local_freqs)


@dataclass
class UserDelta:
    """A user's forest, delta-encoded against a ``SharedCodebook``.

    ``codebook_generation`` names the generation of the shared codebook
    every shared cluster reference resolves against — decoding a delta
    against any other generation is a framing error.  The store keeps a
    superseded codebook alive until the last delta referencing it has
    been migrated (``store.lifecycle``)."""

    codebook_generation: int
    n_trees: int
    max_depth: int
    n_train_obs: int
    zaks_payload: bytes
    zaks_total_bits: int
    zaks_lengths: np.ndarray
    vars_dc: DeltaComponent
    splits_dc: dict[int, DeltaComponent]
    fits_dc: DeltaComponent
    # regression: local fit id -> fleet id (>= 0) or extra id (-(i+1));
    # ``extra_fit_values`` holds values the fleet table lacks (late onboard)
    fit_map: np.ndarray
    extra_fit_values: np.ndarray

    # ---------------- serialization ---------------------------------------
    def to_bytes(self) -> bytes:
        """Serialize as one RFD1 frame (normative spec: docs/format.md)."""
        out = io.BytesIO()
        out.write(_MAGIC)
        out.write(
            struct.pack(
                "<HIHII",
                self.codebook_generation,
                self.n_trees, self.max_depth, self.n_train_obs,
                self.zaks_total_bits,
            )
        )
        write_arr(out, self.zaks_lengths.astype(np.int32))
        write_bytes(out, self.zaks_payload)
        _write_delta_component(out, self.vars_dc)
        out.write(struct.pack("<H", len(self.splits_dc)))
        for v, c in sorted(self.splits_dc.items()):
            out.write(struct.pack("<H", v))
            _write_delta_component(out, c)
        _write_delta_component(out, self.fits_dc)
        write_arr(out, self.fit_map.astype(np.int32))
        write_arr(out, self.extra_fit_values.astype(np.float64))
        return with_crc(out.getvalue())

    @classmethod
    def from_bytes(cls, data: bytes) -> "UserDelta":
        """Parse one RFD1 frame (normative spec: docs/format.md).  The
        CRC32 trailer is verified when present; corruption raises a typed
        ``core.framing.IntegrityError`` / ``TruncatedFrameError``."""
        inp = io.BytesIO(check_crc(data, "RFD1 user delta"))
        expect_magic(inp, _MAGIC, "RFD1 user delta")
        gen, n_trees, max_depth, n_obs, zbits = read_struct(
            inp, "<HIHII", "RFD1 header"
        )
        zaks_lengths = read_arr(inp).astype(np.int32)
        zaks_payload = read_bytes(inp)
        vars_dc = _read_delta_component(inp)
        (ns,) = read_struct(inp, "<H", "RFD1 split-component count")
        splits_dc = {}
        for _ in range(ns):
            (v,) = read_struct(inp, "<H", "RFD1 split variable id")
            splits_dc[v] = _read_delta_component(inp)
        fits_dc = _read_delta_component(inp)
        fit_map = read_arr(inp).astype(np.int64)
        extra = read_arr(inp).astype(np.float64)
        return cls(
            codebook_generation=gen,
            n_trees=n_trees, max_depth=max_depth, n_train_obs=n_obs,
            zaks_payload=zaks_payload, zaks_total_bits=zbits,
            zaks_lengths=zaks_lengths, vars_dc=vars_dc,
            splits_dc=splits_dc, fits_dc=fits_dc,
            fit_map=fit_map, extra_fit_values=extra,
        )


def _write_delta_component(out: io.BytesIO, c: DeltaComponent) -> None:
    out.write(struct.pack("<B", 1 if c.coder == "arithmetic" else 0))
    write_arr(out, c.kid_to_ref.astype(np.int16))
    out.write(struct.pack("<H", c.n_local))
    for j in range(c.n_local):
        if c.coder == "huffman":
            write_arr(out, np.asarray(c.local_lengths[j], np.uint8))
        else:
            write_arr(out, np.asarray(c.local_freqs[j], np.int64))
    out.write(struct.pack("<H", len(c.streams)))
    for ref, n, s in zip(c.refs, c.n_symbols, c.streams):
        out.write(struct.pack("<hI", int(ref), int(n)))
        write_bytes(out, s)


def _read_delta_component(inp: io.BytesIO) -> DeltaComponent:
    (is_arith,) = read_struct(inp, "<B", "RFD1 component coder tag")
    coder = "arithmetic" if is_arith else "huffman"
    kid_to_ref = read_arr(inp).astype(np.int16)
    (nl,) = read_struct(inp, "<H", "RFD1 local-cluster count")
    local_lengths, local_freqs = [], []
    for _ in range(nl):
        tab = read_arr(inp)
        if is_arith:
            local_freqs.append(tab.astype(np.int64))
        else:
            local_lengths.append(tab.astype(np.int32))
    (nstr,) = read_struct(inp, "<H", "RFD1 stream count")
    refs, n_symbols, streams = [], [], []
    for _ in range(nstr):
        ref, n = read_struct(inp, "<hI", "RFD1 stream header")
        refs.append(ref)
        n_symbols.append(n)
        streams.append(read_bytes(inp))
    return DeltaComponent(
        coder=coder, kid_to_ref=kid_to_ref,
        local_lengths=local_lengths, local_freqs=local_freqs,
        refs=np.asarray(refs, np.int16), n_symbols=n_symbols,
        streams=streams,
    )


# --------------------------------------------------------------------------
# encoding
# --------------------------------------------------------------------------
# every referenced cluster costs one stream frame in the delta (int16 ref +
# uint32 n_symbols + uint32 length prefix + ~half a byte of bit padding)
_STREAM_OVERHEAD_BITS = 8 * (2 + 4 + 4) + 4


def _consolidate_refs(bits: np.ndarray, assign: np.ndarray) -> np.ndarray:
    """Facility-location greedy over shared-cluster references.

    ``bits[u, s]`` is the coded size of model u under cluster s (inf where
    uncodable); ``assign`` starts at the per-model argmin.  Each referenced
    cluster costs ``_STREAM_OVERHEAD_BITS`` of per-user framing, so we
    repeatedly close the cluster whose members' cheapest-alternative penalty
    is smaller than the frame it frees, until no closure pays."""
    while True:
        open_refs = np.unique(assign)
        if len(open_refs) <= 1:
            return assign
        best_saving, best_close, best_moved = 0.0, None, None
        for c in open_refs:
            members = np.flatnonzero(assign == c)
            alt = bits[np.ix_(members, open_refs[open_refs != c])]
            j = np.argmin(alt, axis=1)
            alt_cost = alt[np.arange(len(members)), j]
            if not np.isfinite(alt_cost).all():
                continue  # some member is codable only by c
            penalty = float(
                (alt_cost - bits[members, assign[members]]).sum()
            )
            saving = _STREAM_OVERHEAD_BITS - penalty
            if saving > best_saving:
                best_saving = saving
                best_close = c
                best_moved = (members, open_refs[open_refs != c][j])
        if best_close is None:
            return assign
        members, targets = best_moved
        assign = assign.copy()
        assign[members] = targets


def _assign_against_shared(
    counts: np.ndarray,
    shared: SharedComponent,
    alpha_bits: float,
    coder: str,
    k_max_local: int,
    seed: int,
) -> DeltaComponent:
    """Pick shared clusters for every used model key: per-model cheapest
    CODABLE cluster, then facility-location consolidation (a referenced
    cluster costs a stream frame in the delta); models the shared codebook
    cannot code at all go to user-local clusters."""
    n_keys, alphabet = counts.shape
    s = shared.n_clusters
    kid_to_ref = np.full(n_keys, -1, dtype=np.int16)
    used = np.flatnonzero(counts.sum(-1) > 0)
    dc = DeltaComponent(coder, kid_to_ref)
    if not len(used):
        return dc
    cost = shared.cost_table()  # (S, B_shared)
    if s and alphabet > shared.alphabet:  # late-onboard alphabet growth
        pad = np.full((s, alphabet - shared.alphabet), np.inf)
        cost = np.concatenate([cost, pad], axis=1)
    local_rows = []
    if s:
        rows = counts[used].astype(np.float64)  # (U, B)
        # bits[u, s] = coded size of model u under cluster s; inf where the
        # cluster lacks a codeword for a symbol the model emits
        finite_cost = np.where(np.isfinite(cost), cost, 0.0)
        bits = rows @ finite_cost.T
        uncodable = (rows[:, None, :] > 0) & ~np.isfinite(cost)[None, :, :]
        bits[uncodable.any(-1)] = np.inf
        codable_any = np.isfinite(bits).any(-1)
        assign = np.where(codable_any, np.argmin(bits, axis=1), -1)
        cod = np.flatnonzero(codable_any)
        if len(cod):
            assign[cod] = _consolidate_refs(bits[cod], assign[cod])
        for u, kid in enumerate(used):
            if assign[u] >= 0:
                kid_to_ref[kid] = assign[u]
            else:
                kid_to_ref[kid] = s + len(local_rows)  # placeholder
                local_rows.append(kid)
    else:
        for kid in used:
            kid_to_ref[kid] = s + len(local_rows)
            local_rows.append(kid)
    if local_rows:
        # cluster the leftover models into a small set of local codebooks
        compact, dc.local_lengths, dc.local_freqs = cluster_codebooks(
            counts[local_rows].astype(np.float64), alpha_bits, coder,
            k_max_local, seed,
        )
        for kid, c in zip(local_rows, compact):
            kid_to_ref[kid] = s + int(c)
    return dc


def _delta_codec(
    dc: DeltaComponent, shared: SharedComponent
) -> ComponentCodec:
    """ComponentCodec whose coder list spans shared ids then local ids,
    instantiating only the clusters this user actually references."""
    s = shared.n_clusters
    coders: list = [None] * (s + dc.n_local)
    for ref in np.unique(dc.kid_to_ref[dc.kid_to_ref >= 0]):
        ref = int(ref)
        if ref < s:
            coders[ref] = shared.coder_for(ref)
        elif dc.coder == "huffman":
            coders[ref] = HuffmanCode(dc.local_lengths[ref - s])
        else:
            coders[ref] = ArithmeticCode(dc.local_freqs[ref - s])
    return ComponentCodec(dc.kid_to_ref, coders)


def _keep_nonempty(dc: DeltaComponent, streams, n_symbols) -> None:
    refs = [c for c, n in enumerate(n_symbols) if n > 0]
    dc.refs = np.asarray(refs, np.int16)
    dc.n_symbols = [n_symbols[c] for c in refs]
    dc.streams = [streams[c] for c in refs]


def encode_user_delta(
    forest: Forest,
    shared: SharedCodebook,
    k_max_local: int = 4,
    seed: int = 0,
) -> UserDelta:
    """Delta-encode one user's forest against the fleet codebook."""
    meta = forest.meta
    d = meta.n_features
    if d != shared.n_features or meta.task != shared.task:
        raise ValueError("forest schema does not match the shared codebook")
    rec = extract_records(forest)
    t_max = int(rec.depth.max()) + 1 if len(rec.depth) else 1

    # ---- structure (stays per-user, as in the inline codec) --------------
    zaks_list = [zaks_encode(t) for t in forest.trees]
    zaks_lengths = np.array([len(z) for z in zaks_list], dtype=np.int32)
    zaks_all = (
        np.concatenate(zaks_list) if zaks_list else np.zeros(0, np.uint8)
    )
    zaks_payload = lzw_encode_bits(zaks_all)

    # ---- fit symbols: remap into the fleet (+extra) alphabet -------------
    if meta.task == "classification":
        fit_map = np.zeros(0, np.int64)
        extra_values = np.zeros(0, np.float64)
        n_fit_syms = meta.n_classes
        fit_syms = rec.fit.astype(np.int64)
    else:
        fleet = shared.fleet_fit_values
        vals = np.asarray(forest.fit_values, np.float64)
        # the fleet table is only append-ordered across generations, so the
        # lookup goes through the argsort view, not a raw searchsorted
        hit, ids = fit_value_ids(fleet, vals)
        extra_values = vals[~hit]
        fit_map = np.where(
            hit, ids, -(np.cumsum(~hit) - 1) - 1
        ).astype(np.int64)
        ext_ids = np.where(hit, ids, len(fleet) + np.cumsum(~hit) - 1)
        n_fit_syms = len(fleet) + len(extra_values)
        fit_syms = ext_ids[rec.fit.astype(np.int64)]
    rec_f = type(rec)(
        tree_id=rec.tree_id, depth=rec.depth, father_var=rec.father_var,
        var=rec.var, split=rec.split, fit=fit_syms, is_leaf=rec.is_leaf,
    )

    # ---- per-component shared-cluster assignment + local fallback --------
    vars_dc = _assign_against_shared(
        var_name_counts(rec, d, t_max), shared.vars_comp,
        alpha_vars(d), "huffman", k_max_local, seed,
    )
    splits_dc: dict[int, DeltaComponent] = {}
    for v, cnts in split_counts(rec, d, t_max, meta.n_bins_per_feature).items():
        sh = shared.splits_comp.get(
            v, SharedComponent("huffman", cnts.shape[1])
        )
        a = alpha_splits(
            not bool(meta.categorical[v]), meta.n_train_obs,
            int(meta.n_bins_per_feature[v]),
        )
        splits_dc[v] = _assign_against_shared(
            cnts, sh, a, "huffman", k_max_local, seed
        )
    fits_coder = shared.fits_comp.coder
    fits_dc = _assign_against_shared(
        fit_counts(rec_f, d, t_max, n_fit_syms), shared.fits_comp,
        alpha_fits(meta.task, n_fit_syms), fits_coder, k_max_local, seed,
    )

    # ---- emit residual streams in global preorder ------------------------
    vs, vn, ss, sn, fs, fn = emit_streams(
        rec, d,
        _delta_codec(vars_dc, shared.vars_comp),
        {
            v: _delta_codec(
                dc,
                shared.splits_comp.get(
                    v,
                    SharedComponent(
                        "huffman", int(meta.n_bins_per_feature[v])
                    ),
                ),
            )
            for v, dc in splits_dc.items()
        },
        _delta_codec(fits_dc, shared.fits_comp),
        fit_syms,
    )
    _keep_nonempty(vars_dc, vs, vn)
    for v, dc in splits_dc.items():
        _keep_nonempty(dc, ss[v], sn[v])
    _keep_nonempty(fits_dc, fs, fn)

    return UserDelta(
        codebook_generation=shared.generation,
        n_trees=forest.n_trees,
        max_depth=t_max - 1,
        n_train_obs=meta.n_train_obs,
        zaks_payload=zaks_payload,
        zaks_total_bits=int(zaks_lengths.sum()),
        zaks_lengths=zaks_lengths,
        vars_dc=vars_dc,
        splits_dc=splits_dc,
        fits_dc=fits_dc,
        fit_map=fit_map,
        extra_fit_values=extra_values,
    )


# --------------------------------------------------------------------------
# hydration + reconstruction
# --------------------------------------------------------------------------
def _hydrate_component(
    dc: DeltaComponent, shared: SharedComponent
) -> ClusteredComponent:
    """Materialize a delta component as an inline ``ClusteredComponent``:
    referenced shared codebooks are copied in, cluster ids compacted to
    stream order."""
    s = shared.n_clusters
    ref_pos = {int(r): i for i, r in enumerate(dc.refs)}
    kid_map = np.full(len(dc.kid_to_ref), -1, dtype=np.int16)
    for kid, ref in enumerate(dc.kid_to_ref):
        if ref >= 0:
            kid_map[kid] = ref_pos[int(ref)]
    lengths, freqs = [], []
    for r in dc.refs:
        r = int(r)
        if dc.coder == "huffman":
            src = (
                shared.codebook_lengths[r] if r < s
                else dc.local_lengths[r - s]
            )
            lengths.append(np.asarray(src, np.int32))
            freqs.append(np.zeros(0, np.int64))
        else:
            src = shared.freqs[r] if r < s else dc.local_freqs[r - s]
            freqs.append(np.asarray(src, np.int64))
            lengths.append(np.zeros(0, np.int32))
    return ClusteredComponent(
        kid_map, lengths, list(dc.streams), list(dc.n_symbols),
        dc.coder, freqs,
    )


def hydrate(delta: UserDelta, shared: SharedCodebook) -> CompressedForest:
    """Resolve a user delta into a plain inline ``CompressedForest`` (every
    existing decode/predict/serve path applies).  Regression node fits come
    out as FLEET ids with ``fit_values`` set to the fleet(+extra) table —
    numerically identical predictions; use ``reconstruct_user`` for the
    bit-exact original forest."""
    if delta.codebook_generation != shared.generation:
        raise ValueError(
            f"delta references codebook generation "
            f"{delta.codebook_generation}, got generation "
            f"{shared.generation}"
        )
    meta = shared.user_meta(delta.n_train_obs)
    if shared.task == "regression":
        fit_values = np.concatenate(
            [shared.fleet_fit_values, delta.extra_fit_values]
        )
    else:
        fit_values = np.zeros(0, np.float64)
    splits_comp = {
        v: _hydrate_component(
            dc,
            shared.splits_comp.get(
                v,
                SharedComponent(
                    "huffman", int(shared.n_bins_per_feature[v])
                ),
            ),
        )
        for v, dc in delta.splits_dc.items()
    }
    return CompressedForest(
        meta=meta,
        n_trees=delta.n_trees,
        zaks_payload=delta.zaks_payload,
        zaks_total_bits=delta.zaks_total_bits,
        zaks_lengths=delta.zaks_lengths,
        vars_comp=_hydrate_component(delta.vars_dc, shared.vars_comp),
        splits_comp=splits_comp,
        fits_comp=_hydrate_component(delta.fits_dc, shared.fits_comp),
        fit_values=fit_values,
        max_depth=delta.max_depth,
    )


def reconstruct_user(delta: UserDelta, shared: SharedCodebook) -> Forest:
    """Bit-exact reconstruction of the user's original forest, including the
    user-local fit-value table and node-fit indices."""
    forest = decompress_forest(hydrate(delta, shared))
    if shared.task != "regression":
        return forest
    n_fleet = len(shared.fleet_fit_values)
    ext_ids = np.where(
        delta.fit_map >= 0, delta.fit_map, n_fleet + (-delta.fit_map - 1)
    )
    n_ext = n_fleet + len(delta.extra_fit_values)
    inv = np.full(n_ext, -1, dtype=np.int64)
    inv[ext_ids] = np.arange(len(ext_ids))
    for t in forest.trees:
        t.node_fit = inv[t.node_fit.astype(np.int64)]
    ext_table = np.concatenate(
        [shared.fleet_fit_values, delta.extra_fit_values]
    )
    forest.fit_values = ext_table[ext_ids]
    return forest
