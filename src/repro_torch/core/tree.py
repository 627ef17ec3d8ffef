"""Host-side compact decision-tree containers shared by the codec and the
JAX forest substrate.

Conventions
-----------
* Nodes are stored in **preorder** (root first, then left subtree, then right
  subtree).  The codec relies on this: the Zaks sequence is the preorder
  internal/leaf pattern, and every per-node symbol stream is emitted/consumed
  in the same global preorder.
* Every internal node has exactly two children (CART binary splits).
* ``feature[i] == -1`` marks a leaf.
* ``threshold[i]`` is an integer *split symbol*: the bin index for numerical
  variables (histogram CART; the bin-edge table lives in ForestMeta) or the
  partition id for categorical variables.
* ``node_fit[i]`` is stored for EVERY node, not only leaves — the paper (§3.3)
  notes common implementations keep per-node fits for missing-value handling,
  and that this makes fits a dominant fraction of the forest; we reproduce
  that behaviour.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Tree:
    feature: np.ndarray  # (n_nodes,) int32; -1 => leaf
    threshold: np.ndarray  # (n_nodes,) int32 split symbol; -1 at leaves
    children_left: np.ndarray  # (n_nodes,) int32; -1 at leaves
    children_right: np.ndarray  # (n_nodes,) int32; -1 at leaves
    node_fit: np.ndarray  # (n_nodes,) float64 (regression) or int64 (classes)

    def __post_init__(self) -> None:
        self.feature = np.asarray(self.feature, dtype=np.int32)
        self.threshold = np.asarray(self.threshold, dtype=np.int32)
        self.children_left = np.asarray(self.children_left, dtype=np.int32)
        self.children_right = np.asarray(self.children_right, dtype=np.int32)
        self.node_fit = np.asarray(self.node_fit)

    @property
    def n_nodes(self) -> int:
        return len(self.feature)

    @property
    def is_leaf(self) -> np.ndarray:
        return self.feature < 0

    def depths(self) -> np.ndarray:
        d = np.zeros(self.n_nodes, dtype=np.int32)
        for i in range(self.n_nodes):
            for c in (self.children_left[i], self.children_right[i]):
                if c >= 0:
                    d[c] = d[i] + 1
        return d

    def parents(self) -> np.ndarray:
        p = np.full(self.n_nodes, -1, dtype=np.int32)
        for i in range(self.n_nodes):
            for c in (self.children_left[i], self.children_right[i]):
                if c >= 0:
                    p[c] = i
        return p

    def predict_one(self, x_binned: np.ndarray) -> float:
        """Reference traversal over binned features (oracle for the kernels)."""
        i = 0
        while self.feature[i] >= 0:
            if x_binned[self.feature[i]] <= self.threshold[i]:
                i = int(self.children_left[i])
            else:
                i = int(self.children_right[i])
        return self.node_fit[i]

    def equals(self, other: "Tree") -> bool:
        return (
            np.array_equal(self.feature, other.feature)
            and np.array_equal(self.threshold, other.threshold)
            and np.array_equal(self.children_left, other.children_left)
            and np.array_equal(self.children_right, other.children_right)
            and np.array_equal(self.node_fit, other.node_fit)
        )


@dataclass
class ForestMeta:
    """Per-forest metadata shared by all trees (stored once; counted in the
    codec's overhead bucket)."""

    n_features: int
    task: str  # "classification" | "regression"
    n_classes: int = 2
    n_bins_per_feature: np.ndarray | None = None  # (d,) alphabet size per var
    bin_edges: np.ndarray | None = None  # (d, max_bins-1) float32 bin uppers
    n_train_obs: int = 0  # the paper's n (numerical split alpha = log2 n + C)
    categorical: np.ndarray | None = None  # (d,) bool

    def __post_init__(self) -> None:
        if self.n_bins_per_feature is None:
            self.n_bins_per_feature = np.full(self.n_features, 256, np.int32)
        if self.categorical is None:
            self.categorical = np.zeros(self.n_features, dtype=bool)


@dataclass
class Forest:
    trees: list[Tree]
    meta: ForestMeta
    fit_values: np.ndarray = field(default_factory=lambda: np.zeros(0))
    # ``fit_values``: for regression, node_fit arrays hold int indices into
    # this table of distinct 64-bit fit values (the paper's "symbol -> 64-bit
    # value" dictionary). For classification it is empty and node_fit holds
    # class ids directly.

    @property
    def n_trees(self) -> int:
        return len(self.trees)

    def equals(self, other: "Forest") -> bool:
        return (
            self.n_trees == other.n_trees
            and all(a.equals(b) for a, b in zip(self.trees, other.trees))
            and np.array_equal(self.fit_values, other.fit_values)
        )

    def max_depth(self) -> int:
        return max((int(t.depths().max()) for t in self.trees), default=0)
