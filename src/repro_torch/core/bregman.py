"""Model clustering via Bregman divergence (paper §3.2.1, eqs. 3-6).

Given M empirical distributions P_1..P_M (with sequence lengths n_1..n_M) on
a shared alphabet of size B, find clusters C_1..C_K and codebook
distributions Q_1..Q_K minimizing

    sum_k sum_{i in C_k} n_i * D_KL(P_i || Q_k)  +  alpha * B * K      (6)

KL(P||Q) is the Bregman divergence generated by negative entropy, so the
optimal centroid of a cluster is the n_i-weighted MEAN of its member
distributions (Banerjee et al. 2005) — that makes the inner loop a plain
K-means with KL assignment + weighted-mean update.  The dense math
(M x K divergence matrix) runs in PyTorch on an explicit device; the
paper sweeps K and keeps the minimizer of (6).

Two engines share the objective:

* ``engine="dense"`` — float32 PyTorch on ``device`` (the reference's
  jitted float32 JAX step, written as plain tensor code).  Materializes the
  full (M, K) divergence matrix per Lloyd step; the small-M oracle.
* ``engine="chunked"`` — fleet-scale path for the multi-tenant store
  (``repro.store``), where M is the number of (user, model-key) pairs and
  reaches 1e5+.  Assignment runs in row chunks of ``chunk_size`` so peak
  extra memory is O(chunk * K) instead of O(M * K); centroid updates are
  streaming weighted sums; clusters that empty out mid-iteration are
  deterministically re-seeded to the model with the largest current
  divergence (the dense path keeps the stale centroid instead — both are
  valid Lloyd variants, and ``kl_assign`` itself is chunk-size-invariant,
  which is what the parity tests pin down).
"""
from __future__ import annotations

from dataclasses import dataclass
import numpy as np
import torch

from ..device import resolve_device

_EPS = 1e-12


def _kl_kmeans_step(counts, weights, centroids, n_iters: int):
    """counts: (M,B) row-normalized later; centroids: (K,B). Returns
    (assignments (M,), centroids (K,B), weighted objective).  Float32
    tensors on one device; the Lloyd loop updates ``cent`` in place of a
    functional carry."""
    p = counts / torch.clamp(counts.sum(-1, keepdim=True), min=_EPS)  # (M,B)
    plogp = torch.where(
        p > 0, p * torch.log2(torch.clamp(p, min=_EPS)), torch.zeros_like(p)
    ).sum(-1)
    cent = centroids
    k = cent.shape[0]
    for _ in range(n_iters):
        logq = torch.log2(torch.clamp(cent, min=_EPS))  # (K,B)
        # n_i * KL(P_i||Q_k) = n_i * (sum p log p - sum p log q)
        cross = p @ logq.T  # (M,K)
        div = weights[:, None] * (plogp[:, None] - cross)  # (M,K) in bits
        assign = torch.argmin(div, dim=1)  # (M,)
        onehot = torch.nn.functional.one_hot(assign, k).to(p.dtype)  # (M,K)
        wsum = (onehot * weights[:, None]).T @ p  # (K,B) weighted sums
        mass = wsum.sum(-1, keepdim=True)
        cent = torch.where(mass > 0, wsum / torch.clamp(mass, min=_EPS), cent)
    logq = torch.log2(torch.clamp(cent, min=_EPS))
    div = weights[:, None] * (plogp[:, None] - (p @ logq.T))
    best = torch.argmin(div, dim=1)
    obj = torch.gather(div, 1, best[:, None]).sum()
    return best, cent, obj


def _rows_plogp(p: np.ndarray) -> np.ndarray:
    return np.sum(np.where(p > 0, p * np.log2(np.maximum(p, _EPS)), 0.0), -1)


def kl_assign(
    counts: np.ndarray,
    centroids: np.ndarray,
    chunk_size: int | None = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Weighted-KL hard assignment of M count rows to K centroid rows.

    Computes ``argmin_k n_i * D_KL(P_i || Q_k)`` without materializing the
    dense (M, K) divergence matrix: rows are processed in chunks of
    ``chunk_size`` (``None`` = one dense pass).  The per-row math is the
    same either way (divergences agree to BLAS reduction-order ulps), so
    assignments are chunk-size-invariant away from exact ties.

    Returns (assignments (M,) int32, min_divergence_bits (M,) float64).
    """
    counts = np.asarray(counts, dtype=np.float64)
    centroids = np.asarray(centroids, dtype=np.float64)
    m = counts.shape[0]
    weights = counts.sum(-1)
    p = counts / np.maximum(weights[:, None], _EPS)
    logq = np.log2(np.maximum(centroids, _EPS))  # (K,B)
    assign = np.zeros(m, dtype=np.int32)
    mindiv = np.zeros(m, dtype=np.float64)
    step = m if chunk_size is None else max(1, int(chunk_size))
    for lo in range(0, m, step):
        hi = min(lo + step, m)
        pc = p[lo:hi]
        div = weights[lo:hi, None] * (
            _rows_plogp(pc)[:, None] - pc @ logq.T
        )  # (chunk, K) bits
        a = np.argmin(div, axis=1)
        assign[lo:hi] = a
        mindiv[lo:hi] = div[np.arange(hi - lo), a]
    return assign, mindiv


def _kmeans_pp_init(
    p: np.ndarray, weights: np.ndarray, k: int, seed: int,
    chunk_size: int | None = None,
) -> list[int]:
    """Deterministic k-means++-flavoured seeding: start from the largest-n
    model, then repeatedly take the model farthest (in weighted KL) from the
    chosen set.  Incremental: O(M) per new centroid, never O(M * K) at once."""
    m = p.shape[0]
    rng = np.random.default_rng(seed)
    chosen = [int(np.argmax(weights))]
    plogp = _rows_plogp(p)
    d_min = np.full(m, np.inf)
    step = m if chunk_size is None else max(1, int(chunk_size))
    while len(chosen) < k:
        logq = np.log2(np.maximum(p[chosen[-1]], _EPS))
        for lo in range(0, m, step):
            hi = min(lo + step, m)
            div = weights[lo:hi] * (plogp[lo:hi] - p[lo:hi] @ logq)
            d_min[lo:hi] = np.minimum(d_min[lo:hi], div)
        d = d_min.copy()
        d[chosen] = -np.inf
        nxt = int(np.argmax(d))
        if d[nxt] <= 0:  # all remaining models are exact duplicates
            nxt = int(rng.integers(m))
        chosen.append(nxt)
    return chosen


def _kl_kmeans_chunked(
    counts: np.ndarray,
    k: int,
    n_iters: int,
    seed: int,
    chunk_size: int | None,
):
    """Fleet-scale Lloyd loop: chunked assignment, streaming centroid sums,
    deterministic empty-cluster re-seeding."""
    counts = np.asarray(counts, dtype=np.float64)
    m, b = counts.shape
    weights = counts.sum(-1)
    p = counts / np.maximum(weights[:, None], _EPS)
    cent = p[_kmeans_pp_init(p, weights, k, seed, chunk_size)].copy()
    assign = np.zeros(m, dtype=np.int32)
    for _ in range(n_iters):
        assign, mindiv = kl_assign(counts, cent, chunk_size)
        wsum = np.zeros((k, b), dtype=np.float64)
        np.add.at(wsum, assign, weights[:, None] * p)
        mass = wsum.sum(-1)
        nonempty = mass > 0
        cent[nonempty] = wsum[nonempty] / mass[nonempty, None]
        empties = np.flatnonzero(~nonempty)
        if empties.size:
            # re-seed each empty cluster at the currently worst-coded model
            order = np.argsort(-mindiv, kind="stable")
            for j, c in enumerate(empties[: len(order)]):
                cent[c] = p[order[j]]
    assign, mindiv = kl_assign(counts, cent, chunk_size)
    return assign, cent, float(mindiv.sum())


# models-times-clusters above which ``engine="auto"`` switches to the
# chunked path (the dense path would materialize an (M, K) matrix per step)
_AUTO_DENSE_CELLS = 1 << 22


def kl_kmeans(
    counts: np.ndarray,
    k: int,
    n_iters: int = 25,
    seed: int = 0,
    engine: str = "auto",
    chunk_size: int = 65536,
    device: str | torch.device = "cuda",
):
    """Cluster M empirical count vectors into k groups under weighted KL.

    ``engine``: "dense" (float32 torch on ``device``, materializes (M, K)
    per step — the small-M oracle), "chunked" (fleet-scale numpy streaming
    path; ``device`` unused), or "auto" (chunked once M * k would exceed
    ~4M divergence cells).

    Returns (assignments (M,), centroids (k,B) as probability rows,
    coding_loss_bits = sum_i n_i KL(P_i || Q_{c(i)})).
    """
    counts = np.asarray(counts, dtype=np.float64)
    m, b = counts.shape
    weights = counts.sum(-1)
    k = min(k, m)
    if engine == "auto":
        engine = "chunked" if m * max(k, 1) > _AUTO_DENSE_CELLS else "dense"
    if engine == "chunked":
        return _kl_kmeans_chunked(counts, k, n_iters, seed, chunk_size)
    if engine != "dense":
        raise ValueError(f"unknown kl_kmeans engine: {engine!r}")
    dev = resolve_device(device)
    p = counts / np.maximum(weights[:, None], _EPS)
    chosen = _kmeans_pp_init(p, weights, k, seed)

    def f32(a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=dev)

    assign, cent, obj = _kl_kmeans_step(
        f32(counts), f32(weights), f32(p[chosen]), n_iters
    )
    return (
        assign.cpu().numpy().astype(np.int32), cent.cpu().numpy(), float(obj)
    )


@dataclass
class ClusteringResult:
    assignments: np.ndarray  # (M,) model -> cluster
    centroids: np.ndarray  # (K,B) probability rows
    k: int
    coding_loss_bits: float  # sum_i n_i KL(P_i||Q_c(i))
    dict_bits: float  # alpha * (#codebook lines) — we charge actual support
    objective_bits: float


def cluster_models(
    counts: np.ndarray,
    alpha_bits: float,
    k_max: int = 12,
    n_iters: int = 25,
    seed: int = 0,
    engine: str = "auto",
    chunk_size: int = 65536,
    device: str | torch.device = "cuda",
) -> ClusteringResult:
    """Sweep K = 1..k_max and return the minimizer of objective (6).

    ``alpha_bits`` is the paper's per-dictionary-line cost.  We charge
    ``alpha * support(Q_k)`` (the actual number of lines written) which the
    paper upper-bounds by ``alpha * B``; using the real support is strictly
    tighter and still decodable.  ``engine``/``chunk_size`` select the
    fleet-scale chunked assignment path (see ``kl_kmeans``); ``device``
    is where the dense engine runs.
    """
    counts = np.asarray(counts, dtype=np.float64)
    m = counts.shape[0]
    best: ClusteringResult | None = None
    for k in range(1, min(k_max, m) + 1):
        assign, cent, loss = kl_kmeans(
            counts, k, n_iters=n_iters, seed=seed,
            engine=engine, chunk_size=chunk_size, device=device,
        )
        used = np.unique(assign)
        support = int((cent[used] > 1e-9).sum())
        dict_bits = alpha_bits * support
        obj = loss + dict_bits
        if best is None or obj < best.objective_bits:
            best = ClusteringResult(assign, cent, len(used), loss, dict_bits, obj)
        # early exit: adding clusters can reduce loss at most to 0; if the
        # dictionary cost alone already exceeds the incumbent, stop.
        if best is not None and alpha_bits * (k + 1) > best.objective_bits:
            break
    assert best is not None
    return best
