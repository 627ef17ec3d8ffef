"""Lossy compression with rate-distortion guarantees (paper §7).

Two knobs, each with a closed-form trade-off the experiments verify:

* **tree subsampling** — keep a random |A0| of the |A| trees; the added
  prediction variance is D ≈ sigma^2/|A0| + sigma^2/|A| (eq. 7 with
  |A0| << |A|), while the compressed size shrinks linearly in |A0|/|A|.
* **fit quantization** — uniform b-bit quantization of the numerical fits
  over their range 2^r; distortion 2^{-(b-r)} per value (variance
  (2^{-(b-r)})^2 / 12 under dithered/uniform error), size gain ~ b/64.

Both return ordinary Forest objects, so the LOSSLESS codec is reused
unchanged downstream — "lossy = preprocess, then lossless" exactly as §7.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .tree import Forest


@dataclass(frozen=True)
class LossyConfig:
    """Store-level lossy mode (paper §6/§7): quantize every user's
    regression fit table onto one fleet-wide fixed-rate grid of
    ``2**fit_bits`` levels before (lossless) delta encoding.  Consumed by
    ``repro.store.build_store(lossy=...)``, which reports the measured max
    error next to the closed-form distortion bound."""

    fit_bits: int = 8
    dithered: bool = False
    seed: int = 0


def subsample_trees(forest: Forest, n_keep: int, seed: int = 0) -> Forest:
    rng = np.random.default_rng(seed)
    idx = rng.choice(forest.n_trees, size=min(n_keep, forest.n_trees), replace=False)
    return Forest(
        trees=[forest.trees[int(i)] for i in sorted(idx)],
        meta=forest.meta,
        fit_values=forest.fit_values,
    )


def quantize_fits(
    forest: Forest,
    bits: int,
    dithered: bool = False,
    seed: int = 0,
    value_range: tuple[float, float] | None = None,
) -> tuple[Forest, float]:
    """Uniform b-bit quantization of the regression fit-value dictionary.

    Returns (new forest, max quantization error).  The quantized forest's
    ``fit_values`` table has at most 2^bits distinct values, so the fits
    component's alphabet (and dictionary) shrinks accordingly; node fit
    indices are remapped.

    ``value_range=(lo, hi)`` pins the grid to an EXTERNAL range instead of
    this forest's own min/max — quantizing a whole fleet against one
    shared range makes every user land on the same fixed-rate grid, so
    the store's fleet-union fit table collapses to at most 2^bits entries
    (``repro.store.build_store(lossy=...)``).
    """
    if forest.meta.task != "regression":
        raise ValueError("fit quantization applies to regression forests")
    values = np.asarray(forest.fit_values, dtype=np.float64)
    if value_range is None:
        lo, hi = float(values.min()), float(values.max())
    else:
        lo, hi = float(value_range[0]), float(value_range[1])
    span = max(hi - lo, 1e-30)
    n_levels = 1 << bits
    step = span / n_levels
    rng = np.random.default_rng(seed)
    dither = rng.uniform(-0.5, 0.5, size=values.shape) if dithered else 0.0
    q = np.clip(
        np.floor((values - lo) / step + (dither if dithered else 0.0)),
        0,
        n_levels - 1,
    )
    grid = lo + (q + 0.5) * step  # reconstruction points
    new_values, remap = np.unique(grid, return_inverse=True)
    new_trees = [
        type(t)(
            t.feature,
            t.threshold,
            t.children_left,
            t.children_right,
            remap[t.node_fit.astype(np.int64)].astype(np.int64),
        )
        for t in forest.trees
    ]
    max_err = float(np.abs(grid - values).max())
    return (
        Forest(trees=new_trees, meta=forest.meta, fit_values=new_values),
        max_err,
    )


# --------------------------------------------------------------------------
# §7 theory — used by tests and the lossy benchmarks to overlay predicted
# curves on measured ones.
# --------------------------------------------------------------------------
@dataclass
class LossyTheory:
    sigma2: float  # per-tree prediction-error variance around ensemble mean
    n_trees: int
    fit_range_log2: float  # r: fits span 2^r

    def subsample_distortion(self, n_keep: int) -> float:
        """Eq. 7 (|A0| << |A| approximation)."""
        return self.sigma2 / n_keep + self.sigma2 / self.n_trees

    def quantization_distortion(self, bits: int) -> float:
        """Variance of the uniform quantization error."""
        step = 2.0 ** (self.fit_range_log2 - bits)
        return step**2 / 12.0

    def total_distortion(self, n_keep: int, bits: int) -> float:
        return (
            self.subsample_distortion(n_keep)
            + self.quantization_distortion(bits) / n_keep
        )

    def compression_gain(self, n_keep: int, bits: int) -> float:
        """Predicted size multiplier (fits bucket: b/64; whole forest:
        linear in the sampling ratio)."""
        return (n_keep / self.n_trees) * (bits / 64.0)


def estimate_sigma2(per_tree_preds: np.ndarray) -> float:
    """sigma^2 from a matrix (n_trees, n_obs) of per-tree predictions:
    variance of per-tree mean error around the ensemble mean (paper §7,
    e_t = mean_i(yhat_{t,i} - yhat_i^*))."""
    ens = per_tree_preds.mean(axis=0, keepdims=True)
    e_t = (per_tree_preds - ens).mean(axis=1)
    return float(e_t.var(ddof=1))


def estimate_sigma2_per_obs(per_tree_preds: np.ndarray) -> float:
    """The paper's sigma^2 BOUND: per-observation variance of the tree
    error (sigma_i^2 <= sigma^2, taken as the mean over observations).
    This is the quantity that predicts the per-observation MSE increase
    sigma^2/|A0| when subsampling (var(e_t) of the across-obs MEAN is
    smaller by up to 1/n and underpredicts test MSE)."""
    var_t = per_tree_preds.var(axis=0, ddof=1)  # (n_obs,)
    return float(var_t.mean())
