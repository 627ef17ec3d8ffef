"""Carry state across from the JAX reference to the port, and back.

The RFS1 frame bytes (``docs/format.md``) are the interchange format:
bytes one package writes, the other reads.  ``forest_from_arrays`` turns
an uncompressed reference ``Forest`` into the port's from its numpy
fields alone (duck-typed: anything with ``feature``, ``threshold``,
``children_left``, ``children_right`` and ``node_fit`` per tree, and a
meta with the ``ForestMeta`` fields).  Nothing here imports the
reference.
"""
from __future__ import annotations

import numpy as np

from .core.forest_codec import CompressedForest
from .core.tree import Forest, ForestMeta, Tree

__all__ = ["compressed_from_bytes", "forest_from_arrays"]


def forest_from_arrays(trees, meta, fit_values) -> Forest:
    """The port's ``Forest`` holding copies of the given trees' arrays."""
    port_meta = ForestMeta(
        n_features=int(meta.n_features),
        task=str(meta.task),
        n_classes=int(meta.n_classes),
        n_bins_per_feature=(
            None if meta.n_bins_per_feature is None
            else np.array(meta.n_bins_per_feature)
        ),
        bin_edges=(
            None if meta.bin_edges is None else np.array(meta.bin_edges)
        ),
        n_train_obs=int(meta.n_train_obs),
        categorical=(
            None if meta.categorical is None else np.array(meta.categorical)
        ),
    )
    port_trees = [
        Tree(
            np.array(t.feature), np.array(t.threshold),
            np.array(t.children_left), np.array(t.children_right),
            np.array(t.node_fit),
        )
        for t in trees
    ]
    return Forest(port_trees, port_meta, np.array(fit_values))


def compressed_from_bytes(blob: bytes) -> CompressedForest:
    """Parse an RFS1 frame (written by either package) into the port's
    ``CompressedForest``; corruption raises the typed ``FramingError``s."""
    return CompressedForest.from_bytes(blob)
