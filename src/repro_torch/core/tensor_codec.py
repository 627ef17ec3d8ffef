"""Entropy-coded checkpoint tensors — the paper's scheme transplanted to
LM state (beyond the paper) — the port of ``repro.core.tensor_codec``.

The paper's premise is that i.i.d. sub-models (trees) share empirical
distributions, so their codebooks can be CLUSTERED (eq. 6) instead of
stored per-model.  Transformer checkpoints have the same structure: the
per-layer weight tensors are near-i.i.d. across depth (and experts across
the expert axis), so their value histograms cluster tightly.

Two modes:
  * LOSSLESS (bf16/fp16): split each tensor into high bytes
    (sign+exponent, heavily skewed -> entropy-codable) and low bytes
    (mantissa tail, ~uniform -> stored raw).  Perfect reconstruction.
  * QUANTIZED (b-bit): §7's uniform quantizer per tensor; distortion
    bounded by step/2 = range/2^{b+1}, the paper's closed-form knob.

Pipeline (mirrors Algorithm 1): histogram per tensor chunk -> KL k-means
clustering of histograms (core.bregman, eq. 6 objective with alpha =
dictionary-line cost) -> one canonical Huffman codebook per cluster ->
vectorized encode (core.vechuff).  Each tensor chunk is an independent
stream, so a restore can decode just the layers it needs — the checkpoint
analogue of predicting from the compressed forest (§5).

The port's differences, none of them in the payload:

* Tensors are torch tensors (any device; copied to the host) or numpy
  arrays, and come back as CPU torch tensors: numpy has no bfloat16
  without ``ml_dtypes``, which the port does not need.  A bfloat16
  tensor is named ``"bfloat16"`` in the metadata, as the reference names
  its ``ml_dtypes`` arrays, and is treated as the reference treats them:
  their numpy kind is ``"V"``, not ``"f"``, so the lossless mode passes
  bfloat16 through unencoded (ROADMAP R9).  ``flatten_pytree`` also
  takes modules (their ``named_parameters()``) and dicts keyed by
  parameter names, and stacks the blocks of ``layers`` / ``layers_dense``
  on a leading L axis, so a port train state flattens to the reference's
  paths (``models.reference_path``).
* The dense Bregman clustering runs on ``device`` (``core.bregman``).
* ``to_bytes`` pickles the payload under the reference's class path,
  ``repro.core.tensor_codec.CompressedTensors``, so the reference's
  ``from_bytes`` (an ``isinstance`` check) reads it; ``from_bytes`` reads
  that path and the port's as the port's class, without importing the
  reference.
"""
from __future__ import annotations

import io
import pickle
from dataclasses import dataclass, field

import numpy as np
import torch

from .bregman import cluster_models
from .vechuff import VectorHuffman

__all__ = [
    "CompressedTensors",
    "compress_tensors",
    "decompress_tensors",
    "flatten_pytree",
    "unflatten_pytree",
]

#: The class path the reference's payloads name, and the one the port's
#: ``to_bytes`` writes.
REFERENCE_CLASS = ("repro.core.tensor_codec", "CompressedTensors")

_CHUNK = 1 << 16  # symbols per stream: decode parallelism vs overhead


def _split_float(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """float array -> (top-byte symbols [sign+exponent: heavily skewed],
    remaining bytes raw).  Works for any itemsize >= 2."""
    size = arr.dtype.itemsize
    raw = arr.ravel().view(np.uint8).reshape(-1, size)
    # numpy is little-endian here: the top byte is the LAST byte
    hi = raw[:, size - 1].copy()
    rest = raw[:, : size - 1].copy()
    return hi, rest.ravel()


def _join_float(hi: np.ndarray, rest: np.ndarray, dtype, shape) -> np.ndarray:
    size = np.dtype(dtype).itemsize
    n = hi.size
    raw = np.empty((n, size), np.uint8)
    raw[:, : size - 1] = rest.reshape(n, size - 1)
    raw[:, size - 1] = hi
    return raw.ravel().view(dtype).reshape(shape)


def _quantize(arr: np.ndarray, bits: int):
    """§7 uniform quantizer: returns (codes uint16, lo, step)."""
    flat = arr.astype(np.float64).ravel()
    lo, hi = float(flat.min()), float(flat.max())
    n_levels = 1 << bits
    step = max((hi - lo) / n_levels, 1e-300)
    q = np.clip(np.floor((flat - lo) / step), 0, n_levels - 1)
    return q.astype(np.uint16), lo, step


@dataclass
class CompressedTensors:
    """Self-contained compressed checkpoint payload."""

    mode: str  # "lossless" | "quantized"
    bits: int  # alphabet log-size (8 for lossless high bytes)
    tensors: dict  # name -> metadata dict
    cluster_lengths: list  # per-cluster Huffman code lengths
    streams: dict  # name -> list[(blob, n_symbols)]
    raw: dict  # name -> bytes (low bytes / unquantized passthrough)
    n_clusters: int = 0
    stats: dict = field(default_factory=dict)

    def to_bytes(self) -> bytes:
        buf = io.BytesIO()
        _ReferencePickler(buf, protocol=4).dump(self)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "CompressedTensors":
        """Unpickle bytes this program (or the reference) wrote; a payload
        of any other class raises ``TypeError``."""
        obj = _PortUnpickler(io.BytesIO(data)).load()
        if not isinstance(obj, cls):
            raise TypeError(f"not a CompressedTensors payload: {type(obj)}")
        return obj

    @property
    def nbytes(self) -> int:
        total = 0
        for st in self.streams.values():
            total += sum(len(b) for b, _n, _k in st)
        for r in self.raw.values():
            total += len(r)
        for ln in self.cluster_lengths:
            total += len(ln)  # dictionary: one length byte per line
        for meta in self.tensors.values():
            total += 64  # shape/dtype/scale bookkeeping
        return total


class _ReferencePickler(pickle._Pickler):
    """Writes ``CompressedTensors`` under the reference's class path."""

    def save_global(self, obj, name=None):
        if obj is CompressedTensors:
            self.save(REFERENCE_CLASS[0])
            self.save(REFERENCE_CLASS[1])
            self.write(pickle.STACK_GLOBAL)
            self.memoize(obj)
            return
        super().save_global(obj, name)


class _PortUnpickler(pickle.Unpickler):
    """Reads the reference's class path (and the port's) as the port's
    ``CompressedTensors``."""

    def find_class(self, module, name):
        if name == REFERENCE_CLASS[1] and module in (
                REFERENCE_CLASS[0], __name__):
            return CompressedTensors
        return super().find_class(module, name)


def _dtype_name(t: torch.Tensor) -> str:
    """numpy's name for a torch dtype ("float32", "bfloat16", "int32")."""
    return str(t.dtype).removeprefix("torch.")


def _host(x) -> torch.Tensor:
    """A CPU tensor of a tensor, a numpy array (``ml_dtypes`` bfloat16
    through its bits) or a scalar."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    a = np.asarray(x)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(
            np.array(a, order="C").view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, order="C"))


def _numpy(t: torch.Tensor) -> np.ndarray:
    """The CPU tensor's numbers as numpy (a bfloat16 one as its int16
    bits)."""
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy()
    return t.contiguous().numpy()


def _from_bytes(raw: bytes, name: str, shape) -> torch.Tensor:
    """A CPU tensor of dtype ``name`` from its raw bytes."""
    if name == "bfloat16":
        a = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    return torch.from_numpy(
        np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape).copy())


def _histograms(symbol_chunks: list[np.ndarray], alphabet: int) -> np.ndarray:
    return np.stack(
        [np.bincount(c, minlength=alphabet) for c in symbol_chunks]
    )


def compress_tensors(
    tree: dict[str, np.ndarray],
    *,
    bits: int | None = None,
    k_max: int = 8,
    seed: int = 0,
    device="cuda",
) -> CompressedTensors:
    """tree: flat {name: tensor or array}. bits=None -> lossless split
    mode (bfloat16 passes through, as in the reference).  The clustering
    runs on ``device``."""
    if bits is not None and not (1 <= bits <= 12):
        raise ValueError("quantized mode supports 1..12 bits (FSM decoder)")
    mode = "lossless" if bits is None else "quantized"
    alphabet = 256 if bits is None else (1 << bits)

    names: list[str] = []
    chunk_syms: list[np.ndarray] = []
    chunk_owner: list[int] = []
    tensors: dict[str, dict] = {}
    raw: dict[str, bytes] = {}

    for name, t in tree.items():
        t = _host(t)
        arr = _numpy(t)
        dtype = _dtype_name(t)
        meta: dict = {"shape": tuple(int(n) for n in t.shape),
                      "dtype": dtype}
        if mode == "lossless":
            # bfloat16 is numpy kind "V" in the reference (ml_dtypes)
            if dtype == "bfloat16" or arr.dtype.kind != "f" \
                    or arr.dtype.itemsize < 2 or arr.size == 0:
                raw[name] = arr.tobytes()  # ints/scalars pass through
                meta["passthrough"] = True
                tensors[name] = meta
                continue
            hi, lo = _split_float(arr)
            raw[name] = lo.tobytes()
            syms = hi
        else:
            codes, lo_v, step = _quantize(t.double().numpy(), bits)
            meta["scale"] = (lo_v, step)
            syms = codes
        ti = len(names)
        names.append(name)
        tensors[name] = meta
        for off in range(0, len(syms), _CHUNK):
            chunk_syms.append(syms[off : off + _CHUNK])
            chunk_owner.append(ti)

    if not chunk_syms:
        return CompressedTensors(mode, bits or 8, tensors, [], {}, raw)

    hists = _histograms(chunk_syms, alphabet)
    # alpha: one dictionary line = symbol id + code length byte
    alpha_bits = 8 + np.log2(alphabet)
    res = cluster_models(hists, alpha_bits=alpha_bits, k_max=k_max, seed=seed,
                         device=device)

    # build one codebook per cluster from the SUMMED member counts (the
    # centroid may assign zero mass to a symbol a member uses; sums can't)
    books: list[VectorHuffman] = []
    lengths_out = []
    for k in range(res.k):
        members = np.flatnonzero(res.assignments == k)
        counts = hists[members].sum(0) if len(members) else np.ones(alphabet)
        vh = VectorHuffman(_lengths_from_counts(counts))
        books.append(vh)
        lengths_out.append(vh.lengths.astype(np.uint8).tobytes())

    streams: dict[str, list] = {n: [] for n in names}
    for ci, syms in enumerate(chunk_syms):
        k = int(res.assignments[ci])
        blob, _bits = books[k].encode(syms)
        streams[names[chunk_owner[ci]]].append((blob, len(syms), k))

    comp = CompressedTensors(
        mode, bits or 8, tensors, lengths_out, streams, raw, res.k
    )
    comp.stats = {
        "k": res.k,
        "objective_bits": res.objective_bits,
        "coding_loss_bits": res.coding_loss_bits,
        "n_chunks": len(chunk_syms),
    }
    return comp


def _lengths_from_counts(counts: np.ndarray) -> np.ndarray:
    from .huffman import code_lengths

    return code_lengths(counts)


def decompress_tensors(
    comp: CompressedTensors, names: list[str] | None = None
) -> dict[str, torch.Tensor]:
    """Decode all tensors (or just ``names`` — layer-on-demand restore),
    as CPU torch tensors."""
    books = [
        VectorHuffman(np.frombuffer(ln, dtype=np.uint8).astype(np.int64))
        for ln in comp.cluster_lengths
    ]
    want = set(names) if names is not None else set(comp.tensors)
    out: dict[str, torch.Tensor] = {}

    # group chunks by codebook so each decode_streams call is big
    jobs: dict[int, list] = {}
    for name, chunks in comp.streams.items():
        if name not in want:
            continue
        for pos, (blob, n, k) in enumerate(chunks):
            jobs.setdefault(k, []).append((name, pos, blob, n))
    decoded: dict[tuple[str, int], np.ndarray] = {}
    for k, items in jobs.items():
        blobs = [b for _, _, b, _ in items]
        ns = np.array([n for _, _, _, n in items])
        res = books[k].decode_streams(blobs, ns)
        for (name, pos, _, _), syms in zip(items, res):
            decoded[(name, pos)] = syms

    for name, meta in comp.tensors.items():
        if name not in want:
            continue
        shape, dtype = meta["shape"], meta["dtype"]
        if meta.get("passthrough"):
            out[name] = _from_bytes(comp.raw[name], dtype, shape)
            continue
        chunks = comp.streams[name]
        syms = np.concatenate(
            [decoded[(name, i)] for i in range(len(chunks))]
        ) if chunks else np.zeros(0, np.int64)
        if comp.mode == "lossless":
            lo = np.frombuffer(comp.raw[name], dtype=np.uint8)
            out[name] = torch.from_numpy(_join_float(
                syms.astype(np.uint8), lo, np.dtype(dtype), shape))
        else:
            lo_v, step = meta["scale"]
            vals = lo_v + (syms.astype(np.float64) + 0.5) * step
            out[name] = _cast(vals, dtype).reshape(shape)
    return out


def _cast(vals: np.ndarray, dtype: str) -> torch.Tensor:
    """float64 values as a CPU tensor of ``dtype`` (bfloat16 rounded from
    float32)."""
    if dtype == "bfloat16":
        return torch.from_numpy(vals.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(vals.astype(np.dtype(dtype)))


def flatten_pytree(tree, prefix="") -> dict[str, torch.Tensor]:
    """dict-pytree -> flat {path: CPU tensor}, keys sorted as the
    reference sorts them.  A module stands for its ``named_parameters()``;
    a dotted key is a parameter name and maps to the reference's path
    (``models.reference_path``), the blocks of ``layers`` /
    ``layers_dense`` stacked on a leading L axis in block order."""
    from ..models.model import reference_path

    if isinstance(tree, torch.nn.Module):
        tree = dict(tree.named_parameters())
    if not isinstance(tree, dict):
        return {prefix.rstrip("/"): _host(tree)}
    nested: dict = {}
    stacks: dict[str, dict[int, object]] = {}
    for key, val in tree.items():
        path, index = reference_path(key)
        if index is None:
            _put(nested, path.split("/"), val)
        else:
            stacks.setdefault(path, {})[index] = val
    for path, members in stacks.items():
        leaves = [_host(members[i]) for i in range(len(members))]
        _put(nested, path.split("/"), torch.stack(leaves))
    out = {}
    for k in sorted(nested):
        out.update(flatten_pytree(nested[k], f"{prefix}{k}/"))
    return out


def _put(root: dict, parts: list[str], val) -> None:
    node = root
    for p in parts[:-1]:
        node = node.setdefault(p, {})
    node[parts[-1]] = val


def unflatten_pytree(flat: dict):
    root: dict = {}
    for path, arr in flat.items():
        _put(root, path.split("/"), arr)
    return root
