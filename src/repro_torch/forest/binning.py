"""Feature binning — the HBM-friendly front door of the TPU-native CART.

The paper's trees split on raw observation values; on TPU we pre-quantize
every numerical feature into <=256 quantile bins (LightGBM-style histogram
CART).  This is the hardware adaptation recorded in DESIGN.md: it turns the
split-value alphabet finite *by construction* — which §3.2.2 observes is
effectively true for big data anyway — and makes split search a dense
fixed-shape histogram reduction.

Categorical features use their category id as the bin id (ordinal encoding;
see DESIGN.md deviations).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Binner:
    bin_edges: np.ndarray  # (d, n_bins - 1) float64 upper edges (inf-padded)
    n_bins_per_feature: np.ndarray  # (d,) actual alphabet size
    categorical: np.ndarray  # (d,) bool

    @property
    def n_features(self) -> int:
        return len(self.n_bins_per_feature)

    def transform(self, x: np.ndarray) -> np.ndarray:
        """(n, d) raw -> (n, d) int32 bin ids."""
        n, d = x.shape
        out = np.empty((n, d), dtype=np.int32)
        for j in range(d):
            if self.categorical[j]:
                out[:, j] = np.clip(
                    x[:, j].astype(np.int64), 0, self.n_bins_per_feature[j] - 1
                )
            else:
                out[:, j] = np.searchsorted(
                    self.bin_edges[j], x[:, j], side="left"
                )
        return out


def fit_binner(
    x: np.ndarray,
    n_bins: int = 64,
    categorical: np.ndarray | None = None,
) -> Binner:
    n, d = x.shape
    if categorical is None:
        categorical = np.zeros(d, dtype=bool)
    edges = np.full((d, n_bins - 1), np.inf, dtype=np.float64)
    alphabet = np.zeros(d, dtype=np.int32)
    for j in range(d):
        if categorical[j]:
            alphabet[j] = int(x[:, j].max()) + 1
            continue
        qs = np.quantile(x[:, j], np.linspace(0, 1, n_bins + 1)[1:-1])
        uniq = np.unique(qs)
        edges[j, : len(uniq)] = uniq
        alphabet[j] = len(uniq) + 1
    return Binner(edges, alphabet, categorical)
