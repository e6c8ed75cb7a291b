"""Neighbor-state ops — the batched replacement for the reference's per-point heaps.

The reference's central data structure is a per-row binary max-heap
``(indices i32[n,k], distances f32[n,k], flags u8[n,k])`` mutated by scalar
``siftdown`` / ``checked_flagged_heap_push`` loops (reference: utils.py:130-533).

On an accelerator the idiomatic equivalent is a *sorted* fixed-width neighbor state:

    idx  i32[n, k]  — neighbor ids, sorted ascending by distance, -1 = empty
    dist f32[n, k]  — distances, +inf for empty slots
    flag bool[n, k] — "new" markers driving NN-descent's incremental join

"Heap push" becomes one vectorised **merge**: concatenate candidate columns,
mask duplicates with a lexicographic sort on (id, dist, age), re-sort by
distance, keep the first k. One fused op updates all n rows at once —
replacing millions of data-dependent scalar heap operations with two
row-parallel sorts.

Duplicate suppression matches the reference's ``checked_heap_push`` linear
scan semantics (utils.py:429-431): a candidate equal to an existing neighbor
id never occupies a second slot, and ties prefer the incumbent (so flags are
not spuriously re-set to "new").
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

INT32_MAX = jnp.iinfo(jnp.int32).max


class NeighborState(NamedTuple):
    """Sorted neighbor lists for all rows (the 'graph heap')."""

    idx: jax.Array  # i32[n, k], -1 for empty
    dist: jax.Array  # f32[n, k], +inf for empty
    flag: jax.Array  # bool[n, k], True = new


def make_neighbor_state(n: int, k: int) -> NeighborState:
    """Empty neighbor state (reference: utils.py:131 make_heap)."""
    return NeighborState(
        idx=jnp.full((n, k), -1, jnp.int32),
        dist=jnp.full((n, k), jnp.inf, jnp.float32),
        flag=jnp.zeros((n, k), bool),
    )


# Stable 2-key dedup sort: keys (id, dist_bits) with a stable sort replace
# the 3-key (id, dist, age) sort. Non-negative float distances (incl. +inf)
# bitcast to int32 order-preservingly, and the age tie-break is exactly what
# stability gives for free: incumbents precede candidates in the
# concatenated operand, and two incumbents never share an id. Semantically
# identical (test_neighbors asserts it); OFF until measured faster on the
# device (XLA lowers stable sorts with an extra hidden iota operand).
DEDUP_STABLE = False


def _dedup_keys(idx, dist, age):
    """Sort by (idx, dist[, age]); mark any entry whose id equals its left
    neighbor's id as a duplicate. Invalid ids (<0) are pushed to the end.

    The age (2 bits) is packed into the id operand — sort compile cost
    grows steeply with operand count, and ties in (id, dist) resolve by age
    (exact ties prefer the incumbent). Caps ids at 2^29 (~536M points)."""
    combined = idx * 4 + age
    sort_id = jnp.where(idx < 0, INT32_MAX, idx)
    if DEDUP_STABLE:
        bits = jax.lax.bitcast_convert_type(dist, jnp.int32)
        s_id, s_bits, s_comb = jax.lax.sort(
            (sort_id, bits, combined), num_keys=2, dimension=-1, is_stable=True
        )
        s_dist = jax.lax.bitcast_convert_type(s_bits, jnp.float32)
    else:
        s_id, s_dist, s_comb = jax.lax.sort(
            (sort_id, dist, combined), num_keys=3, dimension=-1
        )
    dup = jnp.concatenate(
        [jnp.zeros(s_id.shape[:-1] + (1,), bool), s_id[..., 1:] == s_id[..., :-1]],
        axis=-1,
    )
    s_dist = jnp.where(dup | (s_id == INT32_MAX), jnp.inf, s_dist)
    return s_comb, s_dist


def merge_candidates(
    state: NeighborState, cand_idx: jax.Array, cand_dist: jax.Array
) -> tuple[NeighborState, jax.Array]:
    """Merge candidate columns into the sorted neighbor state.

    cand_idx i32[n, m], cand_dist f32[n, m]; invalid candidates use id -1.
    Returns the merged state plus the per-call number of changed slots
    (the analog of the reference's push-count ``c`` that drives the
    ``c <= delta*k*n`` early exit, pynndescent_.py:317).

    Inserted candidates get flag=True (new); surviving incumbents keep their
    flag. Ties on (id, dist) prefer the incumbent via the age key.
    """
    idx, dist, flag = state
    k = idx.shape[-1]
    all_idx = jnp.concatenate([idx, cand_idx.astype(jnp.int32)], axis=-1)
    all_dist = jnp.concatenate([dist, cand_dist.astype(jnp.float32)], axis=-1)
    # age 0 = incumbent (sorts first on ties), 1 = fresh candidate
    age = jnp.concatenate(
        [
            jnp.where(flag, 1, 0).astype(jnp.int32),
            jnp.full(cand_idx.shape, 2, jnp.int32),
        ],
        axis=-1,
    )
    # NaN-safe: treat non-finite candidate distances as invalid.
    all_dist = jnp.where(jnp.isnan(all_dist), jnp.inf, all_dist)
    d_comb, d_dist = _dedup_keys(all_idx, all_dist, age)
    width = d_dist.shape[-1]
    if k <= 64 and 4 * k <= width:
        # selecting k << width: top_k beats a second full sort (ties keep
        # the dedup order's first occurrence, like the stable sort did)
        neg_top, pos = jax.lax.top_k(-d_dist, k)
        m_dist = -neg_top
        m_comb = jnp.take_along_axis(d_comb, pos, axis=-1)
    else:
        m_dist, m_comb = jax.lax.sort((d_dist, d_comb), num_keys=1, dimension=-1)
        m_dist = m_dist[..., :k]
        m_comb = m_comb[..., :k]
    new_idx = m_comb >> 2  # arithmetic shift: -1 ids stay negative
    new_dist = m_dist
    # slots holding dedup-invalidated entries (dist == inf) are empty
    new_idx = jnp.where(jnp.isinf(new_dist), -1, new_idx)
    new_flag = ((m_comb & 3) >= 1) & (new_idx >= 0)
    n_changes = jnp.sum((new_idx != idx) & (new_idx >= 0))
    return NeighborState(new_idx, new_dist, new_flag), n_changes


def sort_by_distance(idx, dist):
    """Return (idx, dist) sorted ascending by distance per row, invalid last
    (the analog of deheap_sort, reference utils.py:190)."""
    d = jnp.where((idx < 0) | jnp.isnan(dist), jnp.inf, dist)
    s_dist, s_idx = jax.lax.sort((d, idx), num_keys=1, dimension=-1)
    return s_idx, s_dist


def mask_out_self(cand_idx, row_ids):
    """Invalidate candidates equal to the row's own id (self edges)."""
    return jnp.where(cand_idx == row_ids[:, None], -1, cand_idx)


def state_from_graph(
    indices: jax.Array, distances: jax.Array, k: int | None = None, flag_new: bool = True
) -> NeighborState:
    """Seed a neighbor state from an existing (indices, distances) graph
    (reference: utils.py:836 initalize_heap_from_graph_indices)."""
    n, k0 = indices.shape
    if k is None:
        k = k0
    state = make_neighbor_state(n, k)
    state, _ = merge_candidates(state, indices, distances)
    if not flag_new:
        state = state._replace(flag=jnp.zeros_like(state.flag))
    return state
