"""Synthetic tabular datasets, size-matched to the paper's Table 2 rows.

No network access in this environment, so each UCI/Kaggle dataset is
replaced by a generator that matches its (#obs, #vars, numeric/categorical
mix, task) and produces a learnable non-linear target — tree-friendly
structure so the forests (and hence the codec's empirical models) behave
like the paper's: low-depth splits concentrate on a few informative
features, deep splits become uniform.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class TabularSpec:
    name: str
    n_obs: int
    n_vars: int
    task: str  # "classification" | "regression"
    n_classes: int = 2
    n_categorical: int = 0
    paper_row: str = ""  # which Table-2 row this mirrors


def make_dataset(spec: TabularSpec, seed: int = 0):
    """Returns (X (n,d) float64, y, categorical mask (d,) bool)."""
    rng = np.random.default_rng(seed)
    n, d = spec.n_obs, spec.n_vars
    n_cat = min(spec.n_categorical, d)
    x = rng.normal(size=(n, d))
    # heavy-tailed + correlated columns, like real tabular data
    mix = rng.normal(size=(d, d)) * 0.3 + np.eye(d)
    x = x @ mix
    categorical = np.zeros(d, dtype=bool)
    for j in range(n_cat):
        k = int(rng.integers(3, 12))
        x[:, j] = rng.integers(0, k, size=n)
        categorical[j] = True
    # non-linear target over a sparse set of informative features
    n_inf = max(2, d // 4)
    inf = rng.choice(d, size=n_inf, replace=False)
    coef = rng.normal(size=n_inf) * 2.0
    signal = np.zeros(n)
    for c, j in zip(coef, inf):
        xj = x[:, j]
        signal += c * np.where(xj > np.median(xj), 1.0, -1.0) * np.abs(xj) ** 0.5
    signal += 0.5 * np.sin(3 * x[:, inf[0]]) * x[:, inf[-1]]
    noise = rng.normal(size=n) * signal.std() * 0.3
    y_cont = signal + noise
    if spec.task == "regression":
        return x, y_cont.astype(np.float64), categorical
    if spec.n_classes == 2:
        y = (y_cont > np.median(y_cont)).astype(np.int64)
    else:
        qs = np.quantile(y_cont, np.linspace(0, 1, spec.n_classes + 1)[1:-1])
        y = np.searchsorted(qs, y_cont).astype(np.int64)
    return x, y, categorical


# Table-2-matched specs (scaled_obs: CPU-budget row used by default in the
# benchmarks; the full paper sizes are kept for --full runs).
TABLE2_SPECS: list[TabularSpec] = [
    TabularSpec("iris", 150, 4, "classification", 3, 0, "Iris* (3 class)"),
    TabularSpec("wages", 534, 11, "classification", 2, 3, "Wages*"),
    TabularSpec("airfoil_reg", 1503, 5, "regression", paper_row="Airfoil+"),
    TabularSpec("airfoil_cls", 1503, 5, "classification", 2, 0, "Airfoil*"),
    TabularSpec("bike_reg", 10886, 11, "regression", n_categorical=4, paper_row="Bike Sharing+"),
    TabularSpec("naval_reg", 11934, 16, "regression", paper_row="Naval Plants+"),
    TabularSpec("naval_cls", 11934, 16, "classification", 2, 0, "Naval Plants*"),
    TabularSpec("shuttle", 14500, 9, "classification", 7, 0, "Shuttle*"),
    TabularSpec("forests", 15120, 55, "classification", 7, 10, "Forests*"),
    TabularSpec("adults", 48842, 14, "classification", 2, 7, "Adults*"),
    TabularSpec("liberty_reg", 50999, 32, "regression", n_categorical=16, paper_row="Liberty+"),
    TabularSpec("liberty_cls", 50999, 32, "classification", 2, 16, "Liberty*"),
    TabularSpec("otto", 61878, 94, "classification", 9, 0, "Otto*"),
]


def spec_by_name(name: str) -> TabularSpec:
    for s in TABLE2_SPECS:
        if s.name == name:
            return s
    raise KeyError(name)


def scaled(spec: TabularSpec, max_obs: int) -> TabularSpec:
    """CPU-budget copy of a spec (same vars/task, capped #obs)."""
    return TabularSpec(
        spec.name,
        min(spec.n_obs, max_obs),
        spec.n_vars,
        spec.task,
        spec.n_classes,
        spec.n_categorical,
        spec.paper_row,
    )
