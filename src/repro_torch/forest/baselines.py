"""The paper's two reference compression schemes (§6).

* ``standard_compress`` — serialize the full forest object (every attribute,
  64-bit numerics) and gzip-level deflate it.  Stands in for Matlab's
  ``compact(tree)`` + gzip.
* ``light_compress`` — keep ONLY what prediction needs (structure, splits,
  fits — the three attributes of §3), as tightly typed numpy arrays, then
  deflate.  This is the paper's apples-to-apples reference.

Both return real serialized byte sizes; ``light_report`` also reports the
paper's Table-1 buckets for the light scheme.
"""
from __future__ import annotations

import io
import pickle
import zlib

import numpy as np

from ..core.tree import Forest


def standard_compress(forest: Forest) -> bytes:
    """Full-fidelity pickle (64-bit everything, all attributes) + deflate."""
    blob = pickle.dumps(
        {
            "trees": [
                {
                    "feature": t.feature.astype(np.int64),
                    "threshold": t.threshold.astype(np.float64),
                    "children_left": t.children_left.astype(np.int64),
                    "children_right": t.children_right.astype(np.int64),
                    "node_fit": t.node_fit.astype(np.float64),
                    # the "unnecessary-for-prediction" attributes a standard
                    # toolkit serializes (per-node counts, impurities, ids)
                    "node_id": np.arange(t.n_nodes, dtype=np.int64),
                    "depth": t.depths().astype(np.int64),
                    "parent": t.parents().astype(np.int64),
                }
                for t in forest.trees
            ],
            "fit_values": forest.fit_values.astype(np.float64),
            "meta": forest.meta,
        },
        protocol=4,
    )
    return zlib.compress(blob, level=9)


def _light_blob(forest: Forest) -> dict[str, bytes]:
    """Minimal typed arrays per component (shared tightly-packed layout)."""

    def cat(arrs, dtype):
        return (
            np.concatenate(arrs).astype(dtype).tobytes() if arrs else b""
        )

    trees = forest.trees
    n_nodes = np.array([t.n_nodes for t in trees], np.int32)
    structure = cat([t.children_left for t in trees], np.int32) + cat(
        [t.children_right for t in trees], np.int32
    ) + n_nodes.tobytes()
    names = cat([t.feature for t in trees], np.int8 if forest.meta.n_features < 128 else np.int16)
    splits = cat([t.threshold for t in trees], np.int16)
    if forest.meta.task == "classification":
        fits = cat([t.node_fit for t in trees], np.int8 if forest.meta.n_classes < 128 else np.int32)
    else:
        # 64-bit orthodox losslessness, as in the paper's experiments
        fits = cat(
            [forest.fit_values[t.node_fit.astype(np.int64)] for t in trees],
            np.float64,
        )
    return {
        "structure": structure,
        "var_names": names,
        "split_values": splits,
        "fits": fits,
    }


def light_compress(forest: Forest) -> bytes:
    blobs = _light_blob(forest)
    out = io.BytesIO()
    for k in ("structure", "var_names", "split_values", "fits"):
        z = zlib.compress(blobs[k], level=9)
        out.write(len(z).to_bytes(4, "little"))
        out.write(z)
    return out.getvalue()


def light_report(forest: Forest) -> dict[str, int]:
    blobs = _light_blob(forest)
    rep = {
        k: len(zlib.compress(v, level=9)) for k, v in blobs.items()
    }
    rep["total"] = sum(rep.values())
    return rep
