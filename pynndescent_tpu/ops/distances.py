"""Dense distance layer — batched metric kernels.

Mirrors the capability surface of the reference's distance library
(``pynndescent/distances.py:51-2263``): ~40 named metrics, the
``fast_distance_alternatives`` order-preserving surrogate registry, and the
``proxy_distances`` rerank registry.

Design differences from the reference (which compiles per-pair scalar loops
with numba): every metric here is a *batched* JAX function over ``[..., d]``
arrays — the trailing axis is the feature axis and all leading axes broadcast.
Metrics therefore vmap/jit cleanly and the hot ones (euclidean / cosine / dot
family) additionally have blocked pairwise **matmul** fast paths exposed
through :func:`pairwise`, which is the primitive the NN-descent local join and
the query beam search consume.

Zero-vector / degenerate-input semantics intentionally match the reference so
the recall-oracle tests carry over (e.g. cosine of two zero vectors is 0.0,
one zero vector is 1.0; alternative metrics saturate to ``FLOAT32_MAX``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

FLOAT32_EPS = float(np.finfo(np.float32).eps)

# Distance grams ask for full float32 products: the gram/cancellation form
# ||x||^2 + ||y||^2 - 2<x, y> loses near-neighbor ordering at lower input
# precision. On an NVIDIA H100, HIGHEST means true fp32 with TF32 off (the
# default would round operands to TF32's 10-bit mantissa); on the CPU it is
# plain fp32. Hot paths that can tolerate lower precision pass an explicit
# override.
HIGHEST = jax.lax.Precision.HIGHEST
FLOAT32_MAX = float(np.finfo(np.float32).max)


def _dot(x, y):
    return jnp.sum(x * y, axis=-1)


# ---------------------------------------------------------------------------
# Minkowski family
# ---------------------------------------------------------------------------


def euclidean(x, y):
    r"""Euclidean distance (reference: distances.py:51)."""
    return jnp.sqrt(squared_euclidean(x, y))


def squared_euclidean(x, y):
    r"""Squared euclidean distance (reference: distances.py:79)."""
    d = x - y
    return jnp.sum(d * d, axis=-1)


def standardised_euclidean(x, y, sigma=None):
    r"""Euclidean standardised by per-coordinate variance (distances.py:95)."""
    if sigma is None:
        sigma = jnp.ones(x.shape[-1], x.dtype)
    d = x - y
    return jnp.sqrt(jnp.sum(d * d / sigma, axis=-1))


def manhattan(x, y):
    r"""L1 distance (distances.py:110)."""
    return jnp.sum(jnp.abs(x - y), axis=-1)


def chebyshev(x, y):
    r"""L-infinity distance (distances.py:124)."""
    return jnp.max(jnp.abs(x - y), axis=-1)


def minkowski(x, y, p=2):
    r"""Minkowski distance ``(sum |x-y|^p)^(1/p)`` (distances.py:138)."""
    return jnp.sum(jnp.abs(x - y) ** p, axis=-1) ** (1.0 / p)


def weighted_minkowski(x, y, w=None, p=2):
    r"""Weighted Minkowski distance (distances.py:157)."""
    if w is None:
        w = jnp.ones(x.shape[-1], x.dtype)
    return jnp.sum(w * jnp.abs(x - y) ** p, axis=-1) ** (1.0 / p)


def mahalanobis(x, y, vinv=None):
    r"""Mahalanobis distance ``sqrt((x-y)^T V^-1 (x-y))`` (distances.py:175)."""
    if vinv is None:
        vinv = jnp.eye(x.shape[-1], dtype=x.dtype)
    diff = x - y
    tmp = jnp.einsum("...i,ij->...j", diff, vinv, precision=HIGHEST)
    return jnp.sqrt(jnp.sum(tmp * diff, axis=-1))


# ---------------------------------------------------------------------------
# Other dense distances
# ---------------------------------------------------------------------------


def canberra(x, y):
    r"""Canberra distance with 0/0 terms dropped (distances.py:218)."""
    denom = jnp.abs(x) + jnp.abs(y)
    num = jnp.abs(x - y)
    return jnp.sum(jnp.where(denom > 0, num / jnp.where(denom > 0, denom, 1.0), 0.0), axis=-1)


def bray_curtis(x, y):
    r"""Bray-Curtis dissimilarity (distances.py:237)."""
    num = jnp.sum(jnp.abs(x - y), axis=-1)
    denom = jnp.sum(jnp.abs(x + y), axis=-1)
    return jnp.where(denom > 0, num / jnp.where(denom > 0, denom, 1.0), 0.0)


def cosine(x, y):
    r"""Cosine distance; 0 if both zero vectors, 1 if one is (distances.py:556)."""
    result = _dot(x, y)
    nx = _dot(x, x)
    ny = _dot(y, y)
    both_zero = (nx == 0.0) & (ny == 0.0)
    one_zero = (nx == 0.0) | (ny == 0.0)
    safe = jnp.where(one_zero, 1.0, nx * ny)
    val = 1.0 - result / jnp.sqrt(safe)
    return jnp.where(both_zero, 0.0, jnp.where(one_zero, 1.0, val))


def alternative_cosine(x, y):
    r"""log2-transformed cosine surrogate (distances.py:600)."""
    result = _dot(x, y)
    nx = _dot(x, x)
    ny = _dot(y, y)
    both_zero = (nx == 0.0) & (ny == 0.0)
    bad = ((nx == 0.0) | (ny == 0.0) | (result <= 0.0)) & ~both_zero
    safe_res = jnp.where(result > 0.0, result, 1.0)
    val = jnp.log2(jnp.sqrt(jnp.maximum(nx * ny, FLOAT32_EPS)) / safe_res)
    return jnp.where(both_zero, 0.0, jnp.where(bad, FLOAT32_MAX, val))


def dot(x, y):
    r"""1 - <x,y> for normalized vectors; 1.0 for non-positive dot (distances.py:642)."""
    result = _dot(x, y)
    return jnp.where(result <= 0.0, 1.0, 1.0 - result)


def alternative_dot(x, y):
    r"""-log2 dot surrogate (distances.py:680)."""
    result = _dot(x, y)
    return jnp.where(result <= 0.0, FLOAT32_MAX, -jnp.log2(jnp.where(result > 0.0, result, 1.0)))


def correct_alternative_cosine(d):
    r"""Invert the log2 transform: 1 - 2^-d (distances.py:705)."""
    return 1.0 - np.power(2.0, -np.asarray(d))


def inner_product(x, y):
    r"""Negative inner product distance (distances.py:723)."""
    return -_dot(x, y)


def alternative_inner_product(x, y):
    r"""Reciprocal inner-product surrogate (distances.py:759)."""
    result = _dot(x, y)
    return jnp.where(result <= 0.0, FLOAT32_MAX, 1.0 / jnp.where(result > 0.0, result, 1.0))


def correct_alternative_inner_product(d):
    r"""Invert reciprocal transform; MAX maps to 0.0 (distances.py:842)."""
    d = np.asarray(d)
    return np.where(d >= FLOAT32_MAX, 0.0, -1.0 / np.where(d >= FLOAT32_MAX, 1.0, d))


def tsss(x, y):
    r"""Triangle-area * sector-area similarity distance (distances.py:1208)."""
    diff = x - y
    d_euc_sq = jnp.sum(diff * diff, axis=-1)
    d_cos = _dot(x, y)
    nx = jnp.sqrt(_dot(x, x))
    ny = jnp.sqrt(_dot(y, y))
    mag_diff = jnp.abs(nx - ny)
    d_cos = d_cos / (nx * ny)
    theta = jnp.arccos(jnp.clip(d_cos, -1.0, 1.0)) + jnp.radians(10.0)
    sector = (jnp.sqrt(d_euc_sq) + mag_diff) ** 2 * theta
    triangle = nx * ny * jnp.sin(theta) / 2.0
    return triangle * sector


def true_angular(x, y):
    r"""1 - arccos(cos_sim)/pi; MAX on zero/negative similarity (distances.py:1242)."""
    result = _dot(x, y)
    nx = _dot(x, x)
    ny = _dot(y, y)
    both_zero = (nx == 0.0) & (ny == 0.0)
    bad = ((nx == 0.0) | (ny == 0.0) | (result <= 0.0)) & ~both_zero
    sim = result / jnp.sqrt(jnp.maximum(nx * ny, FLOAT32_EPS))
    val = 1.0 - jnp.arccos(jnp.clip(sim, -1.0, 1.0)) / jnp.pi
    return jnp.where(both_zero, 0.0, jnp.where(bad, FLOAT32_MAX, val))


def true_angular_from_alt_cosine(d):
    r"""Correction from alternative_cosine to true angular (distances.py:1274)."""
    d = np.asarray(d)
    return 1.0 - np.arccos(np.clip(np.power(2.0, -d), -1.0, 1.0)) / np.pi


def correlation(x, y):
    r"""1 - Pearson correlation (distances.py:1284)."""
    mu_x = jnp.mean(x, axis=-1, keepdims=True)
    mu_y = jnp.mean(y, axis=-1, keepdims=True)
    sx = x - mu_x
    sy = y - mu_y
    nx = jnp.sum(sx * sx, axis=-1)
    ny = jnp.sum(sy * sy, axis=-1)
    dp = jnp.sum(sx * sy, axis=-1)
    both_zero = (nx == 0.0) & (ny == 0.0)
    val = 1.0 - dp / jnp.sqrt(jnp.maximum(nx * ny, FLOAT32_EPS))
    return jnp.where(both_zero, 0.0, jnp.where(dp == 0.0, 1.0, val))


def haversine(x, y):
    r"""Great-circle distance on (lat, lon) radians pairs (distances.py:504)."""
    if x.shape[-1] != 2:
        raise ValueError("haversine is only defined for 2 dimensional data")
    sin_lat = jnp.sin(0.5 * (x[..., 0] - y[..., 0]))
    sin_long = jnp.sin(0.5 * (x[..., 1] - y[..., 1]))
    result = jnp.sqrt(sin_lat**2 + jnp.cos(x[..., 0]) * jnp.cos(y[..., 0]) * sin_long**2)
    return 2.0 * jnp.arcsin(jnp.clip(result, -1.0, 1.0))


def hellinger(x, y):
    r"""Hellinger distance over (unnormalised) distributions (distances.py:1340)."""
    result = jnp.sum(jnp.sqrt(jnp.maximum(x * y, 0.0)), axis=-1)
    l1x = jnp.sum(x, axis=-1)
    l1y = jnp.sum(y, axis=-1)
    both_zero = (l1x == 0.0) & (l1y == 0.0)
    one_zero = (l1x == 0.0) | (l1y == 0.0)
    val = jnp.sqrt(jnp.clip(1.0 - result / jnp.sqrt(jnp.maximum(l1x * l1y, FLOAT32_EPS)), 0.0, 1.0))
    return jnp.where(both_zero, 0.0, jnp.where(one_zero, 1.0, val))


def alternative_hellinger(x, y):
    r"""log2-transformed Hellinger surrogate (distances.py:1387)."""
    result = jnp.sum(jnp.sqrt(jnp.maximum(x * y, 0.0)), axis=-1)
    l1x = jnp.sum(x, axis=-1)
    l1y = jnp.sum(y, axis=-1)
    both_zero = (l1x == 0.0) & (l1y == 0.0)
    bad = ((l1x == 0.0) | (l1y == 0.0) | (result <= 0.0)) & ~both_zero
    safe_res = jnp.where(result > 0.0, result, 1.0)
    val = jnp.log2(jnp.sqrt(jnp.maximum(l1x * l1y, FLOAT32_EPS)) / safe_res)
    return jnp.where(both_zero, 0.0, jnp.where(bad, FLOAT32_MAX, val))


def correct_alternative_hellinger(d):
    r"""Invert alternative Hellinger: sqrt(1 - 2^-d) (distances.py:1420)."""
    return np.sqrt(np.clip(1.0 - np.power(2.0, -np.asarray(d)), 0.0, 1.0))


# ---------------------------------------------------------------------------
# Rank / Spearman
# ---------------------------------------------------------------------------


def rankdata(a, method="average"):
    r"""JAX port of scipy.stats.rankdata over the trailing axis
    (reference: distances.py:1430, tested by tests/test_rank.py)."""
    if method not in ("average", "min", "max", "dense", "ordinal"):
        raise ValueError(f"unknown method '{method}'")
    arr = jnp.asarray(a)
    n = arr.shape[-1]
    sorter = jnp.argsort(arr, axis=-1, stable=True)
    inv = jnp.argsort(sorter, axis=-1, stable=True)
    if method == "ordinal":
        return (inv + 1).astype(jnp.float64 if jax.config.x64_enabled else jnp.float32)
    sorted_arr = jnp.take_along_axis(arr, sorter, axis=-1)
    obs = jnp.concatenate(
        [
            jnp.ones(sorted_arr.shape[:-1] + (1,), bool),
            sorted_arr[..., 1:] != sorted_arr[..., :-1],
        ],
        axis=-1,
    )
    dense = jnp.take_along_axis(jnp.cumsum(obs, axis=-1), inv, axis=-1)
    if method == "dense":
        return dense.astype(jnp.float32)
    idx = jnp.arange(n)
    # Per sorted position t: group_start(t) = last obs position <= t
    # (prefix cummax); group_end(t) = first obs position > t, else n
    # (exclusive suffix cummin).
    group_start = jax.lax.cummax(jnp.where(obs, idx, -1), axis=arr.ndim - 1)
    marks = jnp.where(obs, idx, n)
    suffix_min = jnp.flip(jax.lax.cummin(jnp.flip(marks, axis=-1), axis=arr.ndim - 1), axis=-1)
    group_end = jnp.concatenate(
        [suffix_min[..., 1:], jnp.full(suffix_min.shape[:-1] + (1,), n, suffix_min.dtype)],
        axis=-1,
    )
    group_start_per_elem = jnp.take_along_axis(group_start, inv, axis=-1)
    group_end_per_elem = jnp.take_along_axis(group_end, inv, axis=-1)
    if method == "max":
        return group_end_per_elem.astype(jnp.float32)
    if method == "min":
        return (group_start_per_elem + 1).astype(jnp.float32)
    return 0.5 * (group_end_per_elem + group_start_per_elem + 1).astype(jnp.float32)


def spearmanr(x, y):
    r"""1 - Spearman rank correlation (distances.py:1466)."""
    return correlation(rankdata(x), rankdata(y))


# ---------------------------------------------------------------------------
# Distribution distances
# ---------------------------------------------------------------------------


def jensen_shannon_divergence(x, y):
    r"""Eps-smoothed Jensen-Shannon divergence (distances.py:1602)."""
    dim = x.shape[-1]
    l1x = jnp.sum(x, axis=-1, keepdims=True) + FLOAT32_EPS * dim
    l1y = jnp.sum(y, axis=-1, keepdims=True) + FLOAT32_EPS * dim
    px = (x + FLOAT32_EPS) / l1x
    py = (y + FLOAT32_EPS) / l1y
    m = 0.5 * (px + py)
    return jnp.sum(0.5 * (px * jnp.log(px / m) + py * jnp.log(py / m)), axis=-1)


def symmetric_kl_divergence(x, y):
    r"""Eps-smoothed symmetric KL divergence (distances.py:1728)."""
    dim = x.shape[-1]
    l1x = jnp.sum(x, axis=-1, keepdims=True) + FLOAT32_EPS * dim
    l1y = jnp.sum(y, axis=-1, keepdims=True) + FLOAT32_EPS * dim
    px = (x + FLOAT32_EPS) / l1x
    py = (y + FLOAT32_EPS) / l1y
    return jnp.sum(px * jnp.log(px / py) + py * jnp.log(py / px), axis=-1)


def wasserstein_1d(x, y, p=1):
    r"""p-Wasserstein over ordered bins via CDFs (distances.py:1639).

    Zero-mass rows saturate to FLOAT32_MAX instead of NaN, matching the
    reference's proxy behavior (distances.py:875-1030)."""
    l1x = jnp.sum(x, axis=-1, keepdims=True)
    l1y = jnp.sum(y, axis=-1, keepdims=True)
    bad = (l1x[..., 0] == 0.0) | (l1y[..., 0] == 0.0)
    xc = jnp.cumsum(x / jnp.where(l1x == 0, 1.0, l1x), axis=-1)
    yc = jnp.cumsum(y / jnp.where(l1y == 0, 1.0, l1y), axis=-1)
    return jnp.where(bad, FLOAT32_MAX, minkowski(xc, yc, p))


def circular_kantorovich(x, y, p=1):
    r"""Wasserstein on a circular domain via median-shifted CDFs (distances.py:1674).

    Zero-mass rows saturate to FLOAT32_MAX instead of NaN (see wasserstein_1d)."""
    l1x = jnp.sum(x, axis=-1, keepdims=True)
    l1y = jnp.sum(y, axis=-1, keepdims=True)
    bad = (l1x[..., 0] == 0.0) | (l1y[..., 0] == 0.0)
    xc = jnp.cumsum(x / jnp.where(l1x == 0, 1.0, l1x), axis=-1)
    yc = jnp.cumsum(y / jnp.where(l1y == 0, 1.0, l1y), axis=-1)
    mu = jnp.median((xc - yc) ** p, axis=-1, keepdims=True)
    if p == 1:
        out = jnp.sum(jnp.abs(xc - yc - mu), axis=-1)
    elif p == 2:
        val = xc - yc - mu
        out = jnp.sqrt(jnp.sum(val * val, axis=-1))
    elif p > 2:
        out = jnp.sum(jnp.abs(xc - yc - mu) ** p, axis=-1) ** (1.0 / p)
    else:
        raise ValueError("Invalid p supplied to Kantorovich distance")
    return jnp.where(bad, FLOAT32_MAX, out)


def proxy_wasserstein_1d(x, y):
    r"""L1-of-CDFs proxy for 1D Wasserstein (distances.py:875)."""
    l1x = jnp.sum(x, axis=-1, keepdims=True)
    l1y = jnp.sum(y, axis=-1, keepdims=True)
    bad = (l1x[..., 0] == 0.0) | (l1y[..., 0] == 0.0)
    xc = jnp.cumsum(x / jnp.where(l1x == 0, 1.0, l1x), axis=-1)
    yc = jnp.cumsum(y / jnp.where(l1y == 0, 1.0, l1y), axis=-1)
    return jnp.where(bad, FLOAT32_MAX, jnp.sum(jnp.abs(xc - yc), axis=-1))


def proxy_kantorovich(x, y):
    r"""TV + Hellinger proxy for Kantorovich distance (distances.py:937)."""
    l1x = jnp.sum(x, axis=-1, keepdims=True)
    l1y = jnp.sum(y, axis=-1, keepdims=True)
    bad = (l1x[..., 0] == 0.0) | (l1y[..., 0] == 0.0)
    px = x / jnp.where(l1x == 0, 1.0, l1x)
    py = y / jnp.where(l1y == 0, 1.0, l1y)
    tv = jnp.sum(jnp.abs(px - py), axis=-1)
    bc = jnp.sum(jnp.sqrt(jnp.maximum(px * py, 0.0)), axis=-1)
    return jnp.where(bad, FLOAT32_MAX, 0.5 * tv + (1.0 - bc))


def proxy_circular_kantorovich(x, y):
    r"""Mean-shifted CDF L1 proxy for circular Kantorovich (distances.py:996)."""
    l1x = jnp.sum(x, axis=-1, keepdims=True)
    l1y = jnp.sum(y, axis=-1, keepdims=True)
    bad = (l1x[..., 0] == 0.0) | (l1y[..., 0] == 0.0)
    xc = jnp.cumsum(x / jnp.where(l1x == 0, 1.0, l1x), axis=-1)
    yc = jnp.cumsum(y / jnp.where(l1y == 0, 1.0, l1y), axis=-1)
    mu = jnp.mean(xc - yc, axis=-1, keepdims=True)
    return jnp.where(bad, FLOAT32_MAX, jnp.sum(jnp.abs(xc - yc - mu), axis=-1))


def proxy_jensen_shannon(x, y):
    r"""Squared-Hellinger proxy for Jensen-Shannon (distances.py:1059)."""
    l1x = jnp.sum(x, axis=-1, keepdims=True)
    l1y = jnp.sum(y, axis=-1, keepdims=True)
    bad = (l1x[..., 0] == 0.0) | (l1y[..., 0] == 0.0)
    px = x / jnp.where(l1x == 0, 1.0, l1x)
    py = y / jnp.where(l1y == 0, 1.0, l1y)
    bc = jnp.sum(jnp.sqrt(jnp.maximum(px * py, 0.0)), axis=-1)
    return jnp.where(bad, FLOAT32_MAX, 1.0 - bc * bc)


def proxy_symmetric_kl(x, y):
    r"""Triangular-discrimination proxy for symmetric KL (distances.py:1117)."""
    l1x = jnp.sum(x, axis=-1, keepdims=True)
    l1y = jnp.sum(y, axis=-1, keepdims=True)
    bad = (l1x[..., 0] == 0.0) | (l1y[..., 0] == 0.0)
    px = x / jnp.where(l1x == 0, 1.0, l1x)
    py = y / jnp.where(l1y == 0, 1.0, l1y)
    denom = px + py
    diff = px - py
    val = jnp.sum(jnp.where(denom > 0, diff * diff / jnp.where(denom > 0, denom, 1.0), 0.0), axis=-1)
    return jnp.where(bad, FLOAT32_MAX, val)


def proxy_sinkhorn(x, y):
    r"""Same TV+Hellinger proxy as proxy_kantorovich (distances.py:1174)."""
    return proxy_kantorovich(x, y)


def proxy_inner_product(x, y):
    r"""Rank proxy for inner product: alt-cosine + 1/sqrt(ip) (distances.py:810)."""
    ip = _dot(x, y)
    nx = _dot(x, x)
    ny = _dot(y, y)
    bad = (nx == 0.0) | (ny == 0.0) | (ip < 0.0)
    safe_ip = jnp.where(ip > 0.0, ip, 1.0)
    cosine_result = -jnp.log2(safe_ip / jnp.sqrt(jnp.maximum(nx * ny, FLOAT32_EPS)))
    val = cosine_result + 1.0 / jnp.sqrt(safe_ip)
    return jnp.where(bad, FLOAT32_MAX, val)


# Exact OT metrics are provided by the optimal_transport module; imported
# lazily at the bottom of this file to avoid a circular import.


# ---------------------------------------------------------------------------
# Binary set distances (x != 0 treated as membership)
# ---------------------------------------------------------------------------


def _binary_counts(x, y):
    xt = x != 0
    yt = y != 0
    ntt = jnp.sum(xt & yt, axis=-1).astype(jnp.float32)
    nneq = jnp.sum(xt != yt, axis=-1).astype(jnp.float32)
    return xt, yt, ntt, nneq


def hamming(x, y):
    r"""Proportion of differing elements (distances.py:201)."""
    return jnp.mean((x != y).astype(jnp.float32), axis=-1)


def jaccard(x, y):
    r"""Jaccard distance on supports (distances.py:259)."""
    xt = x != 0
    yt = y != 0
    nnz = jnp.sum(xt | yt, axis=-1).astype(jnp.float32)
    neq = jnp.sum(xt & yt, axis=-1).astype(jnp.float32)
    return jnp.where(nnz == 0.0, 0.0, (nnz - neq) / jnp.where(nnz == 0.0, 1.0, nnz))


def alternative_jaccard(x, y):
    r"""-log2 Jaccard similarity surrogate (distances.py:303)."""
    xt = x != 0
    yt = y != 0
    nnz = jnp.sum(xt | yt, axis=-1).astype(jnp.float32)
    neq = jnp.sum(xt & yt, axis=-1).astype(jnp.float32)
    val = -jnp.log2(jnp.maximum(neq, FLOAT32_EPS) / jnp.where(nnz == 0.0, 1.0, nnz))
    return jnp.where(nnz == 0.0, 0.0, jnp.where(neq == 0.0, FLOAT32_MAX, val))


def correct_alternative_jaccard(v):
    r"""Invert: 1 - 2^-v (distances.py:330)."""
    return 1.0 - np.power(2.0, -np.asarray(v))


def matching(x, y):
    r"""Simple matching dissimilarity (distances.py:340)."""
    _, _, _, nneq = _binary_counts(x, y)
    return nneq / x.shape[-1]


def dice(x, y):
    r"""Sorensen-Dice dissimilarity (distances.py:360)."""
    _, _, ntt, nneq = _binary_counts(x, y)
    return jnp.where(nneq == 0.0, 0.0, nneq / (2.0 * ntt + nneq))


def kulsinski(x, y):
    r"""Kulsinski dissimilarity (distances.py:386)."""
    n = x.shape[-1]
    _, _, ntt, nneq = _binary_counts(x, y)
    return jnp.where(nneq == 0.0, 0.0, (nneq - ntt + n) / (nneq + n))


def rogers_tanimoto(x, y):
    r"""Rogers-Tanimoto dissimilarity (distances.py:414)."""
    n = x.shape[-1]
    _, _, _, nneq = _binary_counts(x, y)
    return 2.0 * nneq / (n + nneq)


def russellrao(x, y):
    r"""Russell-Rao dissimilarity (distances.py:435)."""
    n = x.shape[-1]
    xt = x != 0
    yt = y != 0
    ntt = jnp.sum(xt & yt, axis=-1).astype(jnp.float32)
    nx = jnp.sum(xt, axis=-1).astype(jnp.float32)
    ny = jnp.sum(yt, axis=-1).astype(jnp.float32)
    return jnp.where((ntt == nx) & (ntt == ny), 0.0, (n - ntt) / n)


def sokal_michener(x, y):
    r"""Sokal-Michener dissimilarity (== Rogers-Tanimoto) (distances.py:458)."""
    return rogers_tanimoto(x, y)


def sokal_sneath(x, y):
    r"""Sokal-Sneath dissimilarity (distances.py:479)."""
    _, _, ntt, nneq = _binary_counts(x, y)
    return jnp.where(nneq == 0.0, 0.0, nneq / (0.5 * ntt + nneq))


def yule(x, y):
    r"""Yule dissimilarity (distances.py:525)."""
    xt = x != 0
    yt = y != 0
    ntt = jnp.sum(xt & yt, axis=-1).astype(jnp.float32)
    ntf = jnp.sum(xt & ~yt, axis=-1).astype(jnp.float32)
    nft = jnp.sum(~xt & yt, axis=-1).astype(jnp.float32)
    nff = x.shape[-1] - ntt - ntf - nft
    denom = ntt * nff + ntf * nft
    return jnp.where(
        (ntf == 0.0) | (nft == 0.0),
        0.0,
        2.0 * ntf * nft / jnp.where(denom == 0.0, 1.0, denom),
    )


# ---------------------------------------------------------------------------
# Bit-packed binary metrics (uint8 lanes, popcount)
# ---------------------------------------------------------------------------


def bit_hamming(x, y):
    r"""Popcount of XOR over packed uint8 vectors; returns raw bit count
    (distances.py:1780). Uses lax.population_count — the batched analog of
    the reference's hand-written llvm.ctpop.i8 intrinsic (distances.py:31)."""
    return jnp.sum(
        jax.lax.population_count(jnp.bitwise_xor(x, y)).astype(jnp.float32), axis=-1
    )


def bit_jaccard(x, y):
    r"""-log(popcount(and)/popcount(or)) over packed uint8 vectors
    (distances.py:1822)."""
    num = jnp.sum(jax.lax.population_count(jnp.bitwise_and(x, y)).astype(jnp.float32), axis=-1)
    denom = jnp.sum(jax.lax.population_count(jnp.bitwise_or(x, y)).astype(jnp.float32), axis=-1)
    val = -jnp.log(jnp.maximum(num, FLOAT32_EPS) / jnp.where(denom == 0.0, 1.0, denom))
    return jnp.where(denom == 0.0, 0.0, val)


# ---------------------------------------------------------------------------
# Pairwise block kernels (the matmul fast path)
# ---------------------------------------------------------------------------


def _pairwise_sqeuclidean(X, Y):
    # ||x||^2 + ||y||^2 - 2 x.y as one matmul; clip negatives from
    # cancellation. This is the single hottest kernel of the framework.
    x_sq = jnp.sum(X * X, axis=-1)[:, None]
    y_sq = jnp.sum(Y * Y, axis=-1)[None, :]
    xy = jnp.dot(X, Y.T, precision=HIGHEST, preferred_element_type=jnp.float32)
    return jnp.maximum(x_sq + y_sq - 2.0 * xy, 0.0)


def _pairwise_euclidean(X, Y):
    return jnp.sqrt(_pairwise_sqeuclidean(X, Y))


def _pairwise_cosine(X, Y):
    nx = jnp.sqrt(jnp.sum(X * X, axis=-1))[:, None]
    ny = jnp.sqrt(jnp.sum(Y * Y, axis=-1))[None, :]
    sim = jnp.dot(X, Y.T, precision=HIGHEST, preferred_element_type=jnp.float32)
    both_zero = (nx == 0.0) & (ny == 0.0)
    one_zero = (nx == 0.0) | (ny == 0.0)
    denom = jnp.where(one_zero, 1.0, nx * ny)
    return jnp.where(both_zero, 0.0, jnp.where(one_zero, 1.0, 1.0 - sim / denom))


def _pairwise_alternative_cosine(X, Y):
    nx = jnp.sqrt(jnp.sum(X * X, axis=-1))[:, None]
    ny = jnp.sqrt(jnp.sum(Y * Y, axis=-1))[None, :]
    sim = jnp.dot(X, Y.T, precision=HIGHEST, preferred_element_type=jnp.float32)
    both_zero = (nx == 0.0) & (ny == 0.0)
    bad = ((nx == 0.0) | (ny == 0.0) | (sim <= 0.0)) & ~both_zero
    val = jnp.log2(jnp.maximum(nx * ny, FLOAT32_EPS) / jnp.where(sim > 0.0, sim, 1.0))
    return jnp.where(both_zero, 0.0, jnp.where(bad, FLOAT32_MAX, val))


def _pairwise_dot(X, Y):
    sim = jnp.dot(X, Y.T, precision=HIGHEST, preferred_element_type=jnp.float32)
    return jnp.where(sim <= 0.0, 1.0, 1.0 - sim)


def _pairwise_alternative_dot(X, Y):
    sim = jnp.dot(X, Y.T, precision=HIGHEST, preferred_element_type=jnp.float32)
    return jnp.where(sim <= 0.0, FLOAT32_MAX, -jnp.log2(jnp.where(sim > 0.0, sim, 1.0)))


def _pairwise_inner_product(X, Y):
    return -jnp.dot(X, Y.T, precision=HIGHEST, preferred_element_type=jnp.float32)


def _pairwise_alternative_inner_product(X, Y):
    sim = jnp.dot(X, Y.T, precision=HIGHEST, preferred_element_type=jnp.float32)
    return jnp.where(sim <= 0.0, FLOAT32_MAX, 1.0 / jnp.where(sim > 0.0, sim, 1.0))


def _pairwise_proxy_inner_product(X, Y):
    nx = jnp.sum(X * X, axis=-1)[:, None]
    ny = jnp.sum(Y * Y, axis=-1)[None, :]
    ip = jnp.dot(X, Y.T, precision=HIGHEST, preferred_element_type=jnp.float32)
    bad = (nx == 0.0) | (ny == 0.0) | (ip < 0.0)
    safe_ip = jnp.where(ip > 0.0, ip, 1.0)
    val = -jnp.log2(safe_ip / jnp.sqrt(jnp.maximum(nx * ny, FLOAT32_EPS))) + 1.0 / jnp.sqrt(safe_ip)
    return jnp.where(bad, FLOAT32_MAX, val)


# Metrics whose pairwise form is a single matmul.
_PAIRWISE_FAST = {
    "euclidean": _pairwise_euclidean,
    "l2": _pairwise_euclidean,
    "sqeuclidean": _pairwise_sqeuclidean,
    "cosine": _pairwise_cosine,
    "alternative_cosine": _pairwise_alternative_cosine,
    "dot": _pairwise_dot,
    "alternative_dot": _pairwise_alternative_dot,
    "inner_product": _pairwise_inner_product,
    "alternative_inner_product": _pairwise_alternative_inner_product,
    "proxy_inner_product": _pairwise_proxy_inner_product,
}


def pairwise(metric, X, Y=None, **kwds):
    """Distance matrix ``[n, m]`` between rows of X and Y.

    ``metric`` may be a registry name or any batched callable ``f(x, y)``
    over ``[..., d]`` arrays. Matmul fast paths are used when available.
    """
    if Y is None:
        Y = X
    fn = None
    if isinstance(metric, str):
        if metric in _PAIRWISE_FAST and not kwds:
            return _PAIRWISE_FAST[metric](X, Y)
        fn = named_distances[metric]
    else:
        fn = metric
    if kwds:
        fn = functools.partial(fn, **kwds)
    return fn(X[:, None, :], Y[None, :, :])


def pairwise_rowwise(metric, Q, C, **kwds):
    """Row-batched distances: ``Q [b, d]`` against ``C [b, m, d]`` → ``[b, m]``.

    This is the shape the NN-descent local join and the beam search use:
    each row has its own candidate block. The euclidean/cosine family
    reduces to batched matmuls; everything else broadcasts elementwise.
    """
    name = metric if isinstance(metric, str) else None
    if name in ("euclidean", "l2", "sqeuclidean") and not kwds:
        q_sq = jnp.sum(Q * Q, axis=-1)[:, None]
        c_sq = jnp.sum(C * C, axis=-1)
        qc = jnp.einsum("bd,bmd->bm", Q, C, precision=HIGHEST, preferred_element_type=jnp.float32)
        d2 = jnp.maximum(q_sq + c_sq - 2.0 * qc, 0.0)
        return d2 if name == "sqeuclidean" else jnp.sqrt(d2)
    fn = named_distances[name] if name is not None else metric
    if kwds:
        fn = functools.partial(fn, **kwds)
    return fn(Q[:, None, :], C)


# ---------------------------------------------------------------------------
# Registries (mirroring reference distances.py:2103-2263)
# ---------------------------------------------------------------------------

named_distances = {
    # general minkowski distances
    "euclidean": euclidean,
    "l2": euclidean,
    "sqeuclidean": squared_euclidean,
    "manhattan": manhattan,
    "taxicab": manhattan,
    "l1": manhattan,
    "chebyshev": chebyshev,
    "linfinity": chebyshev,
    "linfty": chebyshev,
    "linf": chebyshev,
    "minkowski": minkowski,
    # standardised/weighted distances
    "seuclidean": standardised_euclidean,
    "standardised_euclidean": standardised_euclidean,
    "wminkowski": weighted_minkowski,
    "weighted_minkowski": weighted_minkowski,
    "mahalanobis": mahalanobis,
    # other distances
    "canberra": canberra,
    "cosine": cosine,
    "dot": dot,
    "inner_product": inner_product,
    "correlation": correlation,
    "haversine": haversine,
    "braycurtis": bray_curtis,
    "spearmanr": spearmanr,
    "tsss": tsss,
    "true_angular": true_angular,
    # distribution distances
    "hellinger": hellinger,
    "wasserstein_1d": wasserstein_1d,
    "wasserstein-1d": wasserstein_1d,
    "kantorovich-1d": wasserstein_1d,
    "kantorovich_1d": wasserstein_1d,
    "circular_kantorovich": circular_kantorovich,
    "circular_wasserstein": circular_kantorovich,
    "jensen-shannon": jensen_shannon_divergence,
    "jensen_shannon": jensen_shannon_divergence,
    "symmetric-kl": symmetric_kl_divergence,
    "symmetric_kl": symmetric_kl_divergence,
    "symmetric_kullback_liebler": symmetric_kl_divergence,
    # binary distances
    "hamming": hamming,
    "jaccard": jaccard,
    "dice": dice,
    "matching": matching,
    "kulsinski": kulsinski,
    "rogerstanimoto": rogers_tanimoto,
    "russellrao": russellrao,
    "sokalsneath": sokal_sneath,
    "sokalmichener": sokal_michener,
    "yule": yule,
    "bit_hamming": bit_hamming,
    "bit_jaccard": bit_jaccard,
    # aliases for the alternative forms (searchable by name)
    "alternative_cosine": alternative_cosine,
    "alternative_dot": alternative_dot,
    "alternative_inner_product": alternative_inner_product,
    "alternative_jaccard": alternative_jaccard,
    "alternative_hellinger": alternative_hellinger,
    "proxy_inner_product": proxy_inner_product,
    "proxy_wasserstein_1d": proxy_wasserstein_1d,
    "proxy_kantorovich": proxy_kantorovich,
    "proxy_circular_kantorovich": proxy_circular_kantorovich,
    "proxy_jensen_shannon": proxy_jensen_shannon,
    "proxy_symmetric_kl": proxy_symmetric_kl,
    "proxy_sinkhorn": proxy_sinkhorn,
}

# Order-preserving cheap surrogates + correction applied to final distances
# (reference distances.py:2170-2188).
fast_distance_alternatives = {
    "euclidean": {"dist": squared_euclidean, "pairwise": "sqeuclidean", "correction": np.sqrt},
    "l2": {"dist": squared_euclidean, "pairwise": "sqeuclidean", "correction": np.sqrt},
    "cosine": {
        "dist": alternative_cosine,
        "pairwise": "alternative_cosine",
        "correction": correct_alternative_cosine,
    },
    "dot": {
        "dist": alternative_dot,
        "pairwise": "alternative_dot",
        "correction": correct_alternative_cosine,
    },
    "inner_product": {
        "dist": alternative_inner_product,
        "pairwise": "alternative_inner_product",
        "correction": correct_alternative_inner_product,
    },
    "true_angular": {
        "dist": alternative_cosine,
        "pairwise": "alternative_cosine",
        "correction": true_angular_from_alt_cosine,
    },
    "hellinger": {
        "dist": alternative_hellinger,
        "pairwise": None,
        "correction": correct_alternative_hellinger,
    },
    "jaccard": {
        "dist": alternative_jaccard,
        "pairwise": None,
        "correction": correct_alternative_jaccard,
    },
}

# Cheap proxy + exact rerank (reference distances.py:2190-2239). The true
# OT-based entries are completed by ops.optimal_transport at import below.
proxy_distances = {
    "proxy_inner_product": {
        "proxy_dist": proxy_inner_product,
        "true_dist": inner_product,
    },
    "proxy_wasserstein_1d": {
        "proxy_dist": proxy_wasserstein_1d,
        "true_dist": wasserstein_1d,
    },
    "proxy_wasserstein-1d": {
        "proxy_dist": proxy_wasserstein_1d,
        "true_dist": wasserstein_1d,
    },
    "proxy_circular_kantorovich": {
        "proxy_dist": proxy_circular_kantorovich,
        "true_dist": circular_kantorovich,
    },
    "proxy_circular_wasserstein": {
        "proxy_dist": proxy_circular_kantorovich,
        "true_dist": circular_kantorovich,
    },
    "proxy_jensen_shannon": {
        "proxy_dist": proxy_jensen_shannon,
        "true_dist": jensen_shannon_divergence,
    },
    "proxy_jensen-shannon": {
        "proxy_dist": proxy_jensen_shannon,
        "true_dist": jensen_shannon_divergence,
    },
    "proxy_symmetric_kl": {
        "proxy_dist": proxy_symmetric_kl,
        "true_dist": symmetric_kl_divergence,
    },
    "proxy_symmetric-kl": {
        "proxy_dist": proxy_symmetric_kl,
        "true_dist": symmetric_kl_divergence,
    },
}


def _register_ot_metrics():
    """Wire the optimal-transport metrics (kantorovich / sinkhorn) into the
    registries. Deferred to avoid a circular import."""
    from pynndescent_tpu.ops import optimal_transport as ot

    named_distances.update(
        {
            "kantorovich": ot.kantorovich,
            "wasserstein": ot.kantorovich,
            "sinkhorn": ot.sinkhorn,
        }
    )
    proxy_distances.update(
        {
            "proxy_kantorovich": {"proxy_dist": proxy_kantorovich, "true_dist": ot.kantorovich},
            "proxy_wasserstein": {"proxy_dist": proxy_kantorovich, "true_dist": ot.kantorovich},
            "proxy_sinkhorn": {"proxy_dist": proxy_sinkhorn, "true_dist": ot.sinkhorn},
        }
    )
