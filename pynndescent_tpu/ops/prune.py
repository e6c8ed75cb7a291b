"""Graph refinement — diversification and degree pruning, batched.

Capability parity with the reference's refinement layer
(``pynndescent_.py:369-760``): forward occlusion pruning (``diversify``),
degree-aware variants, reverse-graph pruning, and degree capping.

Batched shape: the reference runs a per-row Python loop growing a keep-list.
Here each row's neighbor-pair distances are one batched tile (gather
``[rows, k, d]`` then a batched ``[rows, k, k]`` product), and the sequential
keep-scan (kept entries occlude later ones) is a ``lax.scan`` over the k
columns carried across all rows at once — k is small (<= ~60), rows are
wide, so the scan is cheap and fully parallel across rows.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from pynndescent_tpu.ops import distances as dst

FLOAT32_EPS = float(np.finfo(np.float32).eps)


def _pair_dists_rowwise(metric, metric_kwds, X, idx):
    """D[b, k, k] distances between the neighbor vectors of each row."""
    V = X[jnp.maximum(idx, 0)]  # [b, k, d]
    b, k, d = V.shape
    if isinstance(metric, str) and metric in ("euclidean", "l2", "sqeuclidean") and not metric_kwds:
        sq = jnp.sum(V * V, axis=-1)
        dots = jnp.einsum(
            "bkd,bld->bkl", V, V, precision=dst.HIGHEST, preferred_element_type=jnp.float32
        )
        d2 = jnp.maximum(sq[:, :, None] + sq[:, None, :] - 2.0 * dots, 0.0)
        return d2 if metric == "sqeuclidean" else jnp.sqrt(d2)
    fn = dst.named_distances[metric] if isinstance(metric, str) else metric
    if metric_kwds:
        fn = functools.partial(fn, **metric_kwds)
    return fn(V[:, :, None, :], V[:, None, :, :])


def diversify_block(idx, dist, X, metric, metric_kwds=None, prune_prob=1.0, key=None,
                    degrees=None, aggression=1.0):
    """Occlusion-prune each row's sorted neighbor list (reference: diversify,
    pynndescent_.py:370; degree-aware variant :433).

    idx i32[b, k] sorted ascending by dist; returns keep mask bool[b, k].
    A later neighbor j is dropped when some kept earlier neighbor c with
    dist[c] > eps occludes it: d(x_c, x_j) < dist[j] (with probability
    prune_prob). With ``degrees`` given, the occlusion threshold is scaled by
    the degree-aware factor (reference pynndescent_.py:499-511).
    """
    b, k = idx.shape
    D = _pair_dists_rowwise(metric, metric_kwds, X, idx)  # [b, k, k]
    valid = idx >= 0

    if prune_prob < 1.0:
        if key is None:
            raise ValueError("prune_prob < 1 requires a PRNG key")
        hit = jax.random.uniform(key, (b, k, k)) < prune_prob
    else:
        hit = jnp.ones((b, k, k), bool)

    if degrees is not None:
        # threshold = 1 + 0.04 * aggression * clip(deg_ratio - 1, 0, 2),
        # clamped to [0.8, 1.2] (reference pynndescent_.py:499-511)
        mean_deg = jnp.maximum(jnp.mean(degrees.astype(jnp.float32)), 1.0)
        deg_ratio = degrees[jnp.maximum(idx, 0)].astype(jnp.float32) / mean_deg  # [b, k]
        factor = 1.0 + 0.04 * aggression * jnp.clip(deg_ratio - 1.0, 0.0, 2.0)
        factor = jnp.clip(factor, 0.8, 1.2)
        thresh = dist * factor
    else:
        thresh = dist

    def body(keep, j):
        # occluded_j = exists kept c (< j) with dist[c] > eps and D[c, j] < thresh[j]
        occludes = (
            keep
            & (dist > FLOAT32_EPS)
            & hit[:, :, j]
            & (D[:, :, j] < thresh[:, j][:, None])
        )
        col_mask = jnp.arange(k) < j
        occluded = jnp.any(occludes & col_mask[None, :], axis=-1)
        keep_j = valid[:, j] & ~occluded
        keep = keep.at[:, j].set(keep_j)
        return keep, None

    keep0 = jnp.zeros((b, k), bool).at[:, 0].set(valid[:, 0])
    keep, _ = jax.lax.scan(body, keep0, jnp.arange(1, k))
    return keep


def diversify_all(idx, dist, X, metric, metric_kwds=None, prune_prob=1.0, key=None,
                  degrees=None, aggression=1.0, block_rows=4096):
    """Pure blocked diversify over all rows (fori over row blocks) — safe to
    call under an enclosing jit. Returns keep mask bool[n, k] on device."""
    n, k = idx.shape
    # width-aware cap: each block gathers a [b, k, d] neighbor tile — bound
    # it to ~512 MB so wide rows (e.g. a 4096-wide sparse sketch) don't blow
    # HBM; shapes are static under trace so this costs nothing at runtime
    d = X.shape[-1]
    b_cap = max(256, (1 << 29) // max(k * d * np.dtype(X.dtype).itemsize, 1))
    b = min(block_rows, b_cap, n)
    n_blocks = -(-n // b)
    if key is None:
        key = jax.random.PRNGKey(0)  # unused when prune_prob >= 1

    def body(blk, keep):
        s0 = jnp.minimum(blk * b, n - b)
        bi = jax.lax.dynamic_slice_in_dim(idx, s0, b)
        bd = jax.lax.dynamic_slice_in_dim(dist, s0, b)
        kb = diversify_block(
            bi, bd, X, metric, metric_kwds, prune_prob,
            jax.random.fold_in(key, blk), degrees, aggression,
        )
        return jax.lax.dynamic_update_slice_in_dim(keep, kb, s0, 0)

    return jax.lax.fori_loop(0, n_blocks, body, jnp.zeros((n, k), bool))


def diversify(idx, dist, X, metric, metric_kwds=None, prune_prob=1.0, key=None,
              degrees=None, aggression=1.0, block_rows=4096):
    """Jitted standalone driver; returns the keep mask as a host array."""
    fn = jax.jit(
        functools.partial(
            diversify_all,
            metric=metric,
            metric_kwds=metric_kwds,
            prune_prob=prune_prob,
            aggression=aggression,
            block_rows=block_rows,
        )
    )
    keep = fn(
        jnp.asarray(idx), jnp.asarray(dist), jnp.asarray(X),
        key=key, degrees=degrees,
    )
    return np.asarray(keep)


def reverse_topk(idx, dist, cap: int):
    """Reverse (transposed) adjacency rows, keeping each vertex's ``cap``
    smallest-distance in-edges — one segmented sort on device (replaces the
    reference's host CSR transpose, pynndescent_.py:1549).

    idx i32[n, k] (-1 padding), dist f32[n, k]. Returns
    (rev_idx i32[n, cap], rev_dist f32[n, cap]).
    """
    n, k = idx.shape
    nk = n * k
    src = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[:, None], idx.shape).reshape(-1)
    tgt = jnp.where(idx >= 0, idx, n).reshape(-1)
    d = jnp.where(idx >= 0, dist, jnp.inf).reshape(-1)
    t_s, d_s, s_s = jax.lax.sort((tgt, d, src), num_keys=2)
    posn = jnp.arange(nk, dtype=jnp.int32)
    is_head = jnp.concatenate([jnp.ones((1,), bool), t_s[1:] != t_s[:-1]])
    group_start = jax.lax.cummax(jnp.where(is_head, posn, -1))
    rank = posn - group_start
    keep = (rank < cap) & (t_s < n) & jnp.isfinite(d_s)
    rows = jnp.where(keep, t_s, n)  # n out-of-bounds -> dropped
    cols = jnp.where(keep, rank, 0)
    rev_idx = jnp.full((n, cap), -1, jnp.int32).at[rows, cols].set(
        s_s, mode="drop", unique_indices=True
    )
    rev_dist = jnp.full((n, cap), jnp.inf, jnp.float32).at[rows, cols].set(
        d_s, mode="drop", unique_indices=True
    )
    return rev_idx, rev_dist


def compute_degrees(idx):
    """Undirected degree of each vertex in the directed kNN graph
    (reference: compute_degrees, pynndescent_.py:406)."""
    idx = jnp.asarray(idx)
    n = idx.shape[0]
    out_deg = jnp.sum(idx >= 0, axis=1).astype(jnp.int32)
    tgt = jnp.where(idx >= 0, idx, n).reshape(-1)
    in_deg = jnp.zeros(n + 1, jnp.int32).at[tgt].add(1)[:n]
    return out_deg + in_deg


def degree_prune_rows(idx, dist, max_degree):
    """Keep each row's max_degree smallest-distance entries (reference:
    degree_prune, pynndescent_.py:741). Rows are already sorted, so this is
    a truncation."""
    return idx[:, :max_degree], dist[:, :max_degree]
