"""Synthetic subscriber fleets for store benchmarks, tests, and demos.

Real fleets are redundant ACROSS users: every subscriber's forest is grown
by the same training pipeline on behaviourally similar data, so the
per-(depth, father-variable) empirical models of different users are close
— which is exactly what the fleet-level Bregman clustering exploits.  This
generator reproduces that structure without training: a fleet-wide
prototype (per-depth variable preferences, split-value profile, fit skew)
is perturbed per user, and trees are sampled from the perturbed model.

Regression fit values are drawn from a shared fleet pool (quantized fits,
as a deployment would do — see ``core.lossy.quantize_fits``), so the
fleet-union value table stays compact.
"""
from __future__ import annotations

import numpy as np

from ..core.tree import Forest, ForestMeta, Tree


def _sample_tree(
    rng: np.random.Generator,
    d: int,
    n_bins: int,
    max_depth: int,
    p_split_by_depth: np.ndarray,
    var_pref_by_depth: np.ndarray,  # (max_depth+1, d) probability rows
    split_profile: np.ndarray,  # (n_bins,) probability row
    fit_profile: np.ndarray,  # (n_fit_syms,) probability row
) -> Tree:
    feature, thresh, left, right, fit = [], [], [], [], []

    def build(depth: int) -> int:
        i = len(feature)
        feature.append(-1)
        thresh.append(-1)
        left.append(-1)
        right.append(-1)
        fit.append(int(rng.choice(len(fit_profile), p=fit_profile)))
        if depth < max_depth and rng.random() < p_split_by_depth[depth]:
            feature[i] = int(rng.choice(d, p=var_pref_by_depth[depth]))
            thresh[i] = int(rng.choice(n_bins, p=split_profile))
            left[i] = build(depth + 1)
            right[i] = build(depth + 1)
        return i

    build(0)
    return Tree(
        np.array(feature), np.array(thresh), np.array(left),
        np.array(right), np.array(fit, dtype=np.int64),
    )


def _gen_users(
    rng: np.random.Generator,
    meta: ForestMeta,
    n_users: int,
    name_offset: int,
    n_trees: tuple[int, int],
    max_depth: int,
    p_split: np.ndarray,
    var_pref: np.ndarray,
    split_profile: np.ndarray,
    fit_profile: np.ndarray,
    fleet_pool: np.ndarray,
    n_user_fit_values: int,
    user_jitter: float,
) -> dict[str, Forest]:
    """Per-user sampling loop shared by the synthetic and drifted fleet
    generators: perturb the prototype per user, sample ragged tree counts,
    and (regression) quantize each user onto a subset of the fleet pool."""
    d = meta.n_features
    n_bins = int(meta.n_bins_per_feature[0])
    fleet: dict[str, Forest] = {}
    for u in range(name_offset, name_offset + n_users):
        urng = np.random.default_rng(rng.integers(1 << 31))

        def jitter(p: np.ndarray) -> np.ndarray:
            q = p * np.exp(urng.normal(0, user_jitter, p.shape))
            return q / q.sum(-1, keepdims=True)

        u_var = np.stack([jitter(row) for row in var_pref])
        u_split = jitter(split_profile)
        u_fit = jitter(fit_profile)
        t_count = int(urng.integers(n_trees[0], n_trees[1] + 1))
        trees = [
            _sample_tree(
                urng, d, n_bins, max_depth, p_split, u_var, u_split, u_fit
            )
            for _ in range(t_count)
        ]
        if meta.task == "regression":
            # each user quantizes onto a subset of the fleet pool
            fit_values = np.sort(
                urng.choice(fleet_pool, n_user_fit_values, replace=False)
            )
        else:
            fit_values = np.zeros(0)
        fleet[f"user{u:05d}"] = Forest(
            trees=trees, meta=meta, fit_values=fit_values
        )
    return fleet


def make_synthetic_fleet(
    n_users: int,
    task: str = "classification",
    n_trees: tuple[int, int] = (8, 16),
    d: int = 8,
    n_bins: int = 16,
    max_depth: int = 6,
    n_classes: int = 2,
    n_fleet_fit_values: int = 64,
    n_user_fit_values: int = 24,
    user_jitter: float = 0.25,
    seed: int = 0,
) -> dict[str, Forest]:
    """Generate ``n_users`` forests sharing one schema and one (perturbed)
    fleet prototype.  Tree counts are ragged in ``n_trees=(lo, hi)``."""
    rng = np.random.default_rng(seed)
    n_fit_syms = n_classes if task == "classification" else n_user_fit_values
    # fleet prototype: skewed, depth-dependent — gives the clustering
    # something real to find
    var_pref = rng.dirichlet(np.full(d, 0.5), size=max_depth + 1)
    split_profile = rng.dirichlet(np.full(n_bins, 0.7))
    fit_profile = rng.dirichlet(np.full(n_fit_syms, 0.8))
    p_split = np.clip(
        np.linspace(0.95, 0.35, max_depth + 1) + rng.normal(0, 0.05, max_depth + 1),
        0.1, 1.0,
    )
    fleet_pool = (
        np.sort(rng.normal(size=n_fleet_fit_values))
        if task == "regression"
        else np.zeros(0)
    )

    meta = ForestMeta(
        n_features=d,
        task=task,
        n_classes=n_classes,
        n_bins_per_feature=np.full(d, n_bins, np.int32),
        n_train_obs=1000,
        categorical=np.zeros(d, dtype=bool),
    )
    return _gen_users(
        rng, meta, n_users, 0, n_trees, max_depth, p_split, var_pref,
        split_profile, fit_profile, fleet_pool, n_user_fit_values,
        user_jitter,
    )


def make_drifted_fleet(
    n_users: int,
    late_fraction: float = 0.3,
    task: str = "classification",
    n_trees: tuple[int, int] = (8, 16),
    d: int = 8,
    n_bins: int = 16,
    max_depth: int = 6,
    n_classes: int = 2,
    n_drift_features: int = 2,
    n_fleet_fit_values: int = 64,
    n_user_fit_values: int = 24,
    user_jitter: float = 0.25,
    seed: int = 0,
) -> tuple[dict[str, Forest], dict[str, Forest]]:
    """Generate a DRIFTED fleet for codebook-lifecycle scenarios: an
    initial population whose trees never touch the last
    ``n_drift_features`` features, and a late-onboarded population (the
    trailing ``late_fraction`` of users) that splits on them heavily — and
    (regression) carries fit values outside the initial fleet pool.

    A codebook built from the initial population alone therefore CANNOT
    code the late users' models (their symbols have zero fleet
    probability), forcing the user-local fallback path that
    ``store.lifecycle.drift_report`` monitors and ``recluster`` repairs.

    Returns ``(initial, late)`` — two disjoint ``{user_id: Forest}`` dicts
    sharing one schema and naming sequence.
    """
    if not 0.0 <= late_fraction <= 1.0:
        raise ValueError(f"late_fraction={late_fraction} not in [0, 1]")
    rng = np.random.default_rng(seed)
    n_fit_syms = n_classes if task == "classification" else n_user_fit_values
    var_pref = rng.dirichlet(np.full(d, 0.5), size=max_depth + 1)
    split_profile = rng.dirichlet(np.full(n_bins, 0.7))
    fit_profile = rng.dirichlet(np.full(n_fit_syms, 0.8))
    p_split = np.clip(
        np.linspace(0.95, 0.35, max_depth + 1) + rng.normal(0, 0.05, max_depth + 1),
        0.1, 1.0,
    )
    fleet_pool = (
        np.sort(rng.normal(size=n_fleet_fit_values))
        if task == "regression"
        else np.zeros(0)
    )
    # late users draw fits from a SHIFTED pool: none of its values exist in
    # the initial pool, so every late regression user onboards extras
    late_pool = (
        np.sort(rng.normal(loc=5.0, size=n_fleet_fit_values))
        if task == "regression"
        else np.zeros(0)
    )

    # initial population: zero preference mass on the drift features
    init_pref = var_pref.copy()
    init_pref[:, d - n_drift_features:] = 0.0
    init_pref /= init_pref.sum(-1, keepdims=True)
    # late population: strong preference for the drift features
    late_pref = var_pref.copy()
    late_pref[:, d - n_drift_features:] += 2.0 / max(n_drift_features, 1)
    late_pref /= late_pref.sum(-1, keepdims=True)

    meta = ForestMeta(
        n_features=d,
        task=task,
        n_classes=n_classes,
        n_bins_per_feature=np.full(d, n_bins, np.int32),
        n_train_obs=1000,
        categorical=np.zeros(d, dtype=bool),
    )
    n_late = int(round(n_users * late_fraction))
    n_initial = n_users - n_late
    initial = _gen_users(
        rng, meta, n_initial, 0, n_trees, max_depth, p_split, init_pref,
        split_profile, fit_profile, fleet_pool, n_user_fit_values,
        user_jitter,
    )
    late = _gen_users(
        rng, meta, n_late, n_initial, n_trees, max_depth, p_split,
        late_pref, split_profile, fit_profile, late_pool,
        n_user_fit_values, user_jitter,
    )
    return initial, late


def make_request_batch(
    store, n_requests: int, rows_per_request: int, seed: int = 0
) -> list[tuple[str, np.ndarray]]:
    """Random mixed-user request batch against a store — the workload the
    serving demos and benchmarks share (one helper so they all measure the
    same request shape)."""
    rng = np.random.default_rng(seed)
    d = store.shared.n_features
    n_bins = int(store.shared.n_bins_per_feature[0])
    users = store.user_ids
    return [
        (
            users[int(rng.integers(len(users)))],
            rng.integers(0, n_bins, (rows_per_request, d)).astype(np.int32),
        )
        for _ in range(n_requests)
    ]
