"""NN-Descent graph construction — a row-local, gather-and-matmul formulation.

Capability parity with the reference driver (``pynndescent_.py:73-366`` dense,
``sparse_nndescent.py`` sparse) but a different algorithmic shape, chosen for
the hardware:

The reference's inner loop is a *pair-emitting local join*: for each vertex it
enumerates candidate x candidate pairs, thresholds them against two heaps, and
scatters (p, q, d) update triples to both endpoints through owner-computes
thread blocks (utils.py:536-733). That shape is scatter-dominated — poor on an
accelerator, where colliding scatters serialise (or, with float atomics, give
run-to-run different sums) and matrix products are cheap.

Here the join is **row-local**: every vertex i gathers a fixed-width candidate
pool built from

  * its sampled *new* forward neighbors and *new* reverse neighbors (1-hop),
  * sampled neighbors of those new hops, and new-flagged neighbors of its
    *old* hops (2-hop),

computes all distances d(x_i, pool) as one batched tile, and merges
the result into its own sorted neighbor row. No update ever crosses rows, so
the whole iteration is embarrassingly row-parallel: the only scatter left is
the O(n*k) reverse-neighbor sampling, done once per iteration with a
min-priority slot reservoir.

Why this is equivalent: the reference evaluates pair (q1, q2) when both are
candidates of a common vertex i and at least one is new. Viewed from q1's
side, that is exactly "q2 is a neighbor of a vertex i adjacent to q1, through
a new edge" — i.e. a 2-hop neighbor through a new hop. The set of pairs
explored per iteration is the same family, sampled at the same fixed budget,
with updates delivered to q1 by its own gather instead of a remote scatter.

Multi-device: the row-local shape shards trivially — vertices are sharded
across the mesh, the candidate-pool gathers of X become all-gathers of point
blocks, and the single reverse-sampling scatter becomes an all-to-all of
(edge, priority) tuples (see pynndescent_tpu.parallel).
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from pynndescent_tpu.ops import distances as dst
from pynndescent_tpu.ops.neighbors import (
    NeighborState,
    make_neighbor_state,
    merge_candidates,
    sort_by_distance,
)
from pynndescent_tpu.utils import rng

DEFAULT_BLOCK_ROWS = 8192


def _freeze_kwds(kwds):
    """Hashable snapshot of metric kwds (arrays -> bytes)."""
    if not kwds:
        return ()
    items = []
    for k, v in sorted(kwds.items()):
        a = np.asarray(v)
        if a.ndim == 0:
            items.append((k, a.item()))
        else:
            items.append((k, (a.shape, str(a.dtype), a.tobytes())))
    return tuple(items)


_ROWWISE_CACHE: dict = {}


def _resolve_rowwise_metric(metric, metric_kwds, cast_candidates_f32=False) -> Callable:
    """Return fn(Q [b, d], C [b, m, d]) -> [b, m] distances.

    The returned closure is cached per (metric, kwds) so it has a stable
    identity — it is passed to jitted stages as a *static* argument, and a
    fresh closure per call would defeat jax's trace cache entirely.

    ``cast_candidates_f32`` upcasts gathered candidate tiles before the math:
    used when the candidate data is stored in bfloat16 (half the HBM gather
    traffic of the search hot loop; exact rerank recovers full precision)."""
    try:
        cache_key = (metric, _freeze_kwds(metric_kwds), cast_candidates_f32)
        cached = _ROWWISE_CACHE.get(cache_key)
        if cached is not None:
            return cached
    except TypeError:
        cache_key = None
    if callable(metric):
        base = metric
        if metric_kwds:
            base = functools.partial(base, **metric_kwds)
        inner = lambda Q, C: base(Q[:, None, :], C)
    else:
        kwds = dict(metric_kwds or {})
        inner = lambda Q, C: dst.pairwise_rowwise(metric, Q, C, **kwds)
    if cast_candidates_f32:
        fn = lambda Q, C: inner(Q, C.astype(jnp.float32))
    else:
        fn = inner
    if cache_key is not None:
        _ROWWISE_CACHE[cache_key] = fn
    return fn


# ---------------------------------------------------------------------------
# Candidate sampling
# ---------------------------------------------------------------------------


def _forward_sample(idx, pri, mask, c):
    """Per row, pick the (up to) c masked entries with smallest priority.
    Returns (candidate ids [n, c], selected positions [n, c], valid [n, c])."""
    c = min(c, idx.shape[-1])
    masked_pri = jnp.where(mask, pri, jnp.inf)
    neg_top, pos = jax.lax.top_k(-masked_pri, c)
    valid = jnp.isfinite(neg_top)
    cand = jnp.where(valid, jnp.take_along_axis(idx, pos, axis=-1), -1)
    return cand, pos, valid


def _reverse_sample(idx, pri, slot, mask, n, c):
    """Slot-reservoir reverse sampling: each directed edge (i -> idx[i, l])
    bids for a random slot in its *target's* candidate row with a random
    priority; the minimum-priority bid per slot wins.

    This replaces the reference's owner-computes reverse candidate pass
    (utils.py:259-306) with one elementwise scatter-min + one gather.
    Used at small n, where its ~2s compile beats the segmented sort's;
    at scale the fused sort path (_reverse_samples_sorted) is faster per
    iteration.

    Returns (reverse candidates [n, c], per-edge win mask [n, k]).
    """
    src = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[:, None], idx.shape)
    tgt = jnp.where(mask, idx, n)  # dump masked edges on a padding row
    pri = jnp.where(mask, pri, jnp.inf)

    buf = jnp.full((n + 1, c), jnp.inf, jnp.float32)
    buf = buf.at[tgt, slot].min(pri)
    tied = (pri == buf[tgt, slot]) & mask
    rcand = jnp.full((n + 1, c), -1, jnp.int32)
    rcand = rcand.at[tgt, slot].max(jnp.where(tied, src, -1))
    # ties on f32 priority: several sources can match the slot minimum, but
    # only the max-src one survives the .max — clearing the others' new
    # flags would consume their edges unexplored. Win = priority tie AND
    # being the surviving id.
    won = tied & (src == rcand[tgt, slot])
    return rcand[:n], won


# below this many vertices the reservoir's cheap compile wins; above it the
# fused segmented sort's per-iteration speed wins (persistent-cache-friendly)
REVERSE_SAMPLE_SORT_MIN_N = 32768


def _reverse_samples_sorted(idx, pri, new_mask, old_mask, n, c):
    """Exact reverse candidate sampling for BOTH the new and old edge sets
    with one segmented sort over all directed edges.

    Edges are keyed by (target*2 + is_new, priority); after sorting, the
    first c edges of each (target, age) group win. Replaces two collision-
    prone scatter-min reservoirs with one sort + two provably-unique
    scatters (reference analog: new_build_candidates' reverse pushes,
    utils.py:285-306).

    Returns (rev_new [n, c], rev_old [n, c], won_new mask [n, k]).
    """
    k = idx.shape[1]
    nk = n * k
    src = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[:, None], idx.shape)
    is_new = new_mask
    valid = new_mask | old_mask
    group = jnp.where(
        valid, idx * 2 + is_new.astype(jnp.int32), 2 * n + 2
    ).reshape(-1)
    p = jnp.where(valid, pri, jnp.inf).reshape(-1)
    eid = jnp.arange(nk, dtype=jnp.int32)
    g_s, p_s, s_s, e_s = jax.lax.sort(
        (group, p, src.reshape(-1), eid), num_keys=2
    )
    posn = jnp.arange(nk, dtype=jnp.int32)
    is_head = jnp.concatenate([jnp.ones((1,), bool), g_s[1:] != g_s[:-1]])
    group_start = jax.lax.cummax(jnp.where(is_head, posn, -1))
    rank = posn - group_start
    keep = (rank < c) & (g_s < 2 * n)
    tgt_s = g_s >> 1
    # non-winning entries route OUT of bounds (row n+1 on an [n+1, c] buffer,
    # mode='drop') so every in-bounds index is genuinely unique — duplicates
    # at an in-bounds dummy row under unique_indices=True would be UB
    oob = n + 1
    rows = jnp.where(keep, tgt_s, oob)
    cols = jnp.where(keep, rank, 0)
    new_s = (g_s & 1) == 1
    rn = jnp.full((n + 1, c), -1, jnp.int32).at[
        jnp.where(new_s, rows, oob), cols
    ].set(s_s, mode="drop", unique_indices=True)
    ro = jnp.full((n + 1, c), -1, jnp.int32).at[
        jnp.where(new_s, oob, rows), cols
    ].set(s_s, mode="drop", unique_indices=True)
    won_new = (
        jnp.zeros((nk,), bool)
        .at[jnp.where(keep & new_s, e_s, nk)]
        .set(True, mode="drop", unique_indices=True)
        .reshape(n, k)
    )
    return rn[:n], ro[:n], won_new


def _compact_rows(rows, key):
    """Push valid (non-negative) entries to the front of each row in random
    order; returns (compacted rows, per-row valid count). Compaction makes
    every 2-hop sample land on a real candidate instead of padding — on
    sparse tables this multiplies effective exploration ~3-4x at equal cost.
    """
    invalid = rows < 0
    rnd = jax.random.uniform(key, rows.shape)
    sort_key = invalid.astype(jnp.float32) + rnd
    _, out = jax.lax.sort((sort_key, rows), num_keys=1, dimension=-1)
    return out, jnp.sum(~invalid, axis=-1).astype(jnp.int32)


class CandidateSample(NamedTuple):
    hop_new: jax.Array  # [n, 2c] new 1-hop candidates (fwd + rev), compacted
    cnt_new: jax.Array  # [n] valid count in hop_new
    hop_old: jax.Array  # [n, 2c] old 1-hop candidates (fwd + rev), compacted
    cnt_old: jax.Array  # [n] valid count in hop_old
    flag: jax.Array  # [n, k] updated (cleared) new-flags


def build_candidates(
    state: NeighborState, key, max_candidates: int, window_rows: int | None = None
) -> CandidateSample:
    """Sample new/old forward + reverse candidates and clear the sampled
    new-flags (reference: new_build_candidates, utils.py:221-320).

    ``window_rows`` (locality phases, see nn_descent): flags are only
    cleared for edges whose two endpoints share a window — an edge masked
    out of the windowed join was not actually explored, so its newness
    must survive for the cross-window/global iterations."""
    n, k = state.idx.shape
    c = max_candidates
    valid = state.idx >= 0
    k_f, k_rn, k_ro = jax.random.split(key, 3)

    pri = jax.random.uniform(k_f, (n, k))
    new_mask = valid & state.flag
    old_mask = valid & ~state.flag

    fwd_new, pos_new, sel_new = _forward_sample(state.idx, pri, new_mask, c)
    fwd_old, _, _ = _forward_sample(state.idx, pri, old_mask, c)

    k_rn, k_ro, k_sn, k_so = jax.random.split(k_rn, 4)
    if n >= REVERSE_SAMPLE_SORT_MIN_N:
        rpri = jax.random.uniform(k_rn, (n, k))
        rev_new, rev_old, won_new = _reverse_samples_sorted(
            state.idx, rpri, new_mask, old_mask, n, c
        )
    else:
        rpri_n = jax.random.uniform(k_rn, (n, k))
        rpri_o = jax.random.uniform(k_ro, (n, k))
        slot_n = jax.random.randint(k_sn, (n, k), 0, c, dtype=jnp.int32)
        slot_o = jax.random.randint(k_so, (n, k), 0, c, dtype=jnp.int32)
        rev_new, won_new = _reverse_sample(state.idx, rpri_n, slot_n, new_mask, n, c)
        rev_old, _ = _reverse_sample(state.idx, rpri_o, slot_o, old_mask, n, c)

    # Clear flags of new edges consumed this round: forward-sampled ones and
    # reverse winners (reference clears on priority match, utils.py:285-306).
    flag = state.flag
    rows = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[:, None], pos_new.shape)
    if window_rows is not None and window_rows < n:
        row_pos = jnp.arange(n, dtype=jnp.int32)[:, None]
        fwd_same_win = sel_new & (
            jnp.maximum(fwd_new, 0) // window_rows == rows // window_rows
        )
        edge_same_win = (
            jnp.maximum(state.idx, 0) // window_rows == row_pos // window_rows
        )
    else:
        fwd_same_win = sel_new
        edge_same_win = True
    flag = flag.at[rows, pos_new].set(
        jnp.where(fwd_same_win, False, flag[rows, pos_new]), unique_indices=True
    )
    flag = flag & ~(won_new & edge_same_win)

    k_c1, k_c2 = jax.random.split(k_ro, 2)
    hop_new, cnt_new = _compact_rows(jnp.concatenate([fwd_new, rev_new], axis=-1), k_c1)
    hop_old, cnt_old = _compact_rows(jnp.concatenate([fwd_old, rev_old], axis=-1), k_c2)
    return CandidateSample(hop_new, cnt_new, hop_old, cnt_old, flag)


# ---------------------------------------------------------------------------
# Row-local join
# ---------------------------------------------------------------------------


def _slice_hop2(table, hops):
    """2-hop expansion by leading slice: for each hop h (>= 0) take
    ``table[h]`` wholesale. The tables arrive pre-sliced to the sample
    budget and compacted in per-iteration random order (_compact_rows), so
    the leading slice IS a uniform without-replacement sample — no per-
    element randint/take_along_axis gathers, just one row gather. -1
    padding in short rows masks itself."""
    picked = table[jnp.maximum(hops, 0)]
    b, h, t = picked.shape
    return jnp.where((hops >= 0)[:, :, None], picked, -1).reshape(b, h * t)


def _join_block(
    row_ids,  # [b]
    hop_new,  # [b, 2c]
    hop_old,  # [b, 2c]
    tbl_nn,  # [n, t_nn] leading slice of the new table (new-hop x new)
    tbl_no,  # [n, t_no] leading slice of the old table (new-hop x old)
    tbl_on,  # [n, t_on] leading slice of the new table (old-hop x new)
    X_rows,  # [W, d] gatherable point table (full X, or a locality window)
    dist_rowwise,
    n_real: int,
    win_start=0,  # global id of X_rows[0]; ids outside the window are masked
):
    """Build the candidate pool for a block of rows and compute distances.

    The 2-hop expansion goes through the *candidate tables*, which are
    approximately symmetric (h in cand(p) <=> p in cand(h) up to reservoir
    sampling). This makes the receive-form join cover exactly the pair family
    of the reference's local join (pynndescent_.py:217, utils.py:536-733):
    for any common vertex i with p, q in cand(i), p finds q by expanding
    cand(i) through its own hop h = i — including rev x rev co-parent pairs.
    Pairs must involve at least one new edge: new hops expand both the new
    and old tables, old hops expand only the new table.

    Locality mode: ``X_rows`` is a [W, d] contiguous window of the (tree-
    ordered) table and ``win_start`` its offset; pool ids that fall outside
    [win_start, win_start + W) are masked to +inf distance (they stay in the
    state, unexplored this iteration). Row gathers from a bounded window
    touch a far smaller working set than gathers from a multi-GB table.

    Returns (pool ids [b, P] — global ids, pool distances [b, P])."""
    hop2_new = jnp.concatenate(
        [_slice_hop2(tbl_nn, hop_new), _slice_hop2(tbl_no, hop_new)], axis=-1
    )
    hop2_old = _slice_hop2(tbl_on, hop_old)

    pool = jnp.concatenate([hop_new, hop2_new, hop2_old], axis=-1)  # [b, P]

    # rows beyond the real point count (state padding for mesh divisibility)
    # merge nothing and stay empty, so their ids never enter real rows
    pool = jnp.where(row_ids[:, None] < n_real, pool, -1)
    W = X_rows.shape[0]
    local = pool - win_start
    # out-of-window ids become padding (-1): they must not enter the merge
    # even as inf-distance entries, or they would fill empty state slots
    pool = jnp.where((local >= 0) & (local < W), pool, -1)
    local = jnp.clip(local, 0, W - 1)
    Q = X_rows[jnp.clip(row_ids - win_start, 0, W - 1)]
    C = X_rows[local]
    d = dist_rowwise(Q, C)
    d = jnp.where(pool < 0, jnp.inf, d)
    return pool, d


# ---------------------------------------------------------------------------
# Iteration + driver
# ---------------------------------------------------------------------------


@jax.jit
def _state_to_tree_order(state: NeighborState, order):
    """Re-index the neighbor state into a tree's position space: row r of the
    output describes the point at tree position r, and every neighbor id is
    a tree position. Enables locality-window joins over tree-order slabs."""
    n = order.shape[0]
    inv = (
        jnp.zeros(n, jnp.int32)
        .at[order]
        .set(jnp.arange(n, dtype=jnp.int32), unique_indices=True)
    )
    idx_p = state.idx[order]
    idx_p = jnp.where(idx_p >= 0, inv[jnp.maximum(idx_p, 0)], -1)
    return NeighborState(idx_p, state.dist[order], state.flag[order])


@jax.jit
def _state_from_tree_order(state_p: NeighborState, order):
    """Inverse of _state_to_tree_order."""
    n = order.shape[0]
    inv = (
        jnp.zeros(n, jnp.int32)
        .at[order]
        .set(jnp.arange(n, dtype=jnp.int32), unique_indices=True)
    )
    idx = jnp.where(state_p.idx >= 0, order[jnp.maximum(state_p.idx, 0)], -1)
    return NeighborState(idx[inv], state_p.dist[inv], state_p.flag[inv])


_jit_permute_rows = jax.jit(lambda X, order: X[order])


def _descent_iteration(
    state: NeighborState,
    X,
    key,
    *,
    max_candidates: int,
    dist_rowwise,
    block_rows: int,
    hop2_new_samples: int,
    hop2_old_samples: int,
    window_rows: int | None = None,
):
    n = state.idx.shape[0]  # may exceed X rows (padding for mesh divisibility)
    k_cand, k_join = jax.random.split(key)
    sample = build_candidates(state, k_cand, max_candidates, window_rows)
    state = state._replace(flag=sample.flag)

    # pre-slice the tables to the 2-hop budgets once (the compacted rows are
    # in per-iteration random order, so leading slices are uniform samples);
    # the new-hop budget is split between the new and old tables so the
    # pair family still covers new x new and new x old
    t_nn = max(1, (hop2_new_samples + 1) // 2)
    t_no = max(0, hop2_new_samples - t_nn)  # honor the budget at small values
    tbl_nn = sample.hop_new[:, :t_nn]
    tbl_no = sample.hop_old[:, :t_no]
    tbl_on = sample.hop_new[:, :hop2_old_samples]

    n_x = X.shape[0]
    windowed = window_rows is not None and window_rows < n_x
    b = min(block_rows, n)
    if windowed:
        # a row block must fit inside its locality window: the join computes
        # every block row's distances against X_rows, so a block wider than
        # the window would pair out-of-window rows with a clamped (WRONG)
        # query row and merge corrupt distances
        b = min(b, window_rows)
    n_blocks = -(-n // b)

    def body(blk, carry):
        st, changes = carry
        start = jnp.minimum(blk * b, n - b)
        rows = start + jnp.arange(b, dtype=jnp.int32)
        if windowed:
            # locality window covering this row block (aligned to the
            # window grid; clamped windows at the tail still cover the rows)
            ws = jnp.clip((start // window_rows) * window_rows, 0, n_x - window_rows)
            ws = jnp.maximum(ws, start + b - window_rows)
            X_rows = jax.lax.dynamic_slice_in_dim(X, ws, window_rows)
        else:
            ws = 0
            X_rows = X
        pool, d = _join_block(
            rows,
            jax.lax.dynamic_slice_in_dim(sample.hop_new, start, b),
            jax.lax.dynamic_slice_in_dim(sample.hop_old, start, b),
            tbl_nn,
            tbl_no,
            tbl_on,
            X_rows,
            dist_rowwise,
            n_real=n_x,
            win_start=ws,
        )
        blk_state = NeighborState(
            jax.lax.dynamic_slice_in_dim(st.idx, start, b),
            jax.lax.dynamic_slice_in_dim(st.dist, start, b),
            jax.lax.dynamic_slice_in_dim(st.flag, start, b),
        )
        merged, n_changed = merge_candidates(blk_state, pool, d)
        st = NeighborState(
            jax.lax.dynamic_update_slice_in_dim(st.idx, merged.idx, start, 0),
            jax.lax.dynamic_update_slice_in_dim(st.dist, merged.dist, start, 0),
            jax.lax.dynamic_update_slice_in_dim(st.flag, merged.flag, start, 0),
        )
        return st, changes + n_changed

    state, changes = jax.lax.fori_loop(0, n_blocks, body, (state, jnp.int32(0)))
    return state, changes


def init_random(state: NeighborState, X, key, n_extra: int, dist_rowwise,
                block_rows: int = 65536):
    """Random-fill initialisation (reference: init_random, pynndescent_.py:193).
    Blocked so the [rows, n_extra+1, d] gather never exceeds a bounded
    working set."""
    n = X.shape[0]
    b = min(block_rows, n)
    n_blocks = -(-n // b)

    def body(blk, st):
        s0 = jnp.minimum(blk * b, n - b)
        rows = s0 + jnp.arange(b, dtype=jnp.int32)
        cand = jax.random.randint(
            jax.random.fold_in(key, blk), (b, n_extra), 0, n, dtype=jnp.int32
        )
        # the reference convention keeps each point as its own first neighbor
        # (distance 0); seed it explicitly
        self_ids = rows[:, None]
        cand = jnp.concatenate([self_ids, cand], axis=-1)
        d = dist_rowwise(X[rows], X[jnp.maximum(cand, 0)])
        d = jnp.where(cand == self_ids, 0.0, d)
        blk_state = NeighborState(st.idx[rows], st.dist[rows], st.flag[rows])
        merged, _ = merge_candidates(blk_state, cand, d)
        return NeighborState(
            st.idx.at[rows].set(merged.idx, unique_indices=True),
            st.dist.at[rows].set(merged.dist, unique_indices=True),
            st.flag.at[rows].set(merged.flag, unique_indices=True),
        )

    return jax.lax.fori_loop(0, n_blocks, body, state)


def init_from_forest(
    state: NeighborState, X, orders, starts, sizes, dist_rowwise,
    leaf_cap: int, block_rows: int = 4096,
):
    """Seed the graph from ALL forest trees with one merge per row block.

    Per block of point ids, every tree's leaf window is gathered side by
    side into one [b, T*leaf_cap] candidate tile, distances are computed as
    one batched tile, and a single sort-merge folds them into the rows —
    ~T fewer sorts and dispatches than looping init_from_tree_order per
    tree (the per-op fixed costs dominate at this width).
    Replaces the reference's per-tree leaf all-pairs scatters
    (init_rp_tree / generate_leaf_updates, pynndescent_.py:73-185).
    """
    n = X.shape[0]
    T = orders.shape[0]
    b = min(block_rows, n)
    n_blocks = -(-n // b)
    offsets = jnp.arange(leaf_cap, dtype=jnp.int32)
    trow = jnp.arange(T, dtype=jnp.int32)[:, None]
    # positions of each point id in each tree (inverse permutations)
    inv = (
        jnp.zeros((T, n), jnp.int32)
        .at[trow, orders]
        .set(jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None], (T, n)),
             unique_indices=True)
    )

    def body(blk, st):
        s0 = jnp.minimum(blk * b, n - b)
        pts = s0 + jnp.arange(b, dtype=jnp.int32)
        # [T, b] tree positions of this block's points (contiguous slice)
        pos = jax.lax.dynamic_slice_in_dim(inv, s0, b, axis=1)
        lstart = starts[trow, pos]  # [T, b]
        lsize = sizes[trow, pos]
        win = lstart[:, :, None] + offsets[None, None, :]  # [T, b, cap]
        cand = orders[trow[:, :, None], jnp.minimum(win, n - 1)]
        cand = jnp.where(
            offsets[None, None, :] < jnp.minimum(lsize, leaf_cap)[:, :, None],
            cand, -1,
        )
        cand = jnp.moveaxis(cand, 0, 1).reshape(b, T * leaf_cap)
        Q = X[pts]
        C = X[jnp.maximum(cand, 0)]
        d = dist_rowwise(Q, C)
        d = jnp.where(cand < 0, jnp.inf, d)
        blk_state = NeighborState(
            jax.lax.dynamic_slice_in_dim(st.idx, s0, b),
            jax.lax.dynamic_slice_in_dim(st.dist, s0, b),
            jax.lax.dynamic_slice_in_dim(st.flag, s0, b),
        )
        merged, _ = merge_candidates(blk_state, cand, d)
        return NeighborState(
            jax.lax.dynamic_update_slice_in_dim(st.idx, merged.idx, s0, 0),
            jax.lax.dynamic_update_slice_in_dim(st.dist, merged.dist, s0, 0),
            jax.lax.dynamic_update_slice_in_dim(st.flag, merged.flag, s0, 0),
        )

    return jax.lax.fori_loop(0, n_blocks, body, state)


def init_from_tree_order(
    state: NeighborState, X, order, start, size, dist_rowwise,
    leaf_cap: int, block_rows: int = 8192,
):
    """Seed the graph from one RP tree's node-location encoding — gather-only.

    For the point at tree position p, its leaf co-members are exactly
    ``order[start[p] : start[p] + size[p]]`` — a contiguous gather window.
    Each point merges distances to (up to leaf_cap of) its leaf-mates into
    its own row; rows are then written back through the ``order`` permutation
    (provably-unique scatter). Replaces the reference's leaf-pair update
    scatters (init_rp_tree / generate_leaf_updates, pynndescent_.py:73-185)
    with zero collision-prone scatters.
    """
    n = X.shape[0]
    b = min(block_rows, n)
    n_blocks = -(-n // b)
    offsets = jnp.arange(leaf_cap, dtype=jnp.int32)

    def body(blk, st):
        s0 = jnp.minimum(blk * b, n - b)
        pos = s0 + jnp.arange(b, dtype=jnp.int32)
        pts = order[pos]
        lstart = start[pos]
        lsize = size[pos]
        win = lstart[:, None] + offsets[None, :]
        cand = order[jnp.minimum(win, n - 1)]
        cand = jnp.where(offsets[None, :] < jnp.minimum(lsize, leaf_cap)[:, None], cand, -1)
        Q = X[pts]
        C = X[jnp.maximum(cand, 0)]
        d = dist_rowwise(Q, C)
        d = jnp.where(cand < 0, jnp.inf, d)
        row_state = NeighborState(st.idx[pts], st.dist[pts], st.flag[pts])
        merged, _ = merge_candidates(row_state, cand, d)
        # pts are distinct within one scatter call (order is a permutation),
        # so the unique fast path applies; the final block's overlap with the
        # previous one only re-merges already-merged rows across calls
        return NeighborState(
            st.idx.at[pts].set(merged.idx, unique_indices=True),
            st.dist.at[pts].set(merged.dist, unique_indices=True),
            st.flag.at[pts].set(merged.flag, unique_indices=True),
        )

    return jax.lax.fori_loop(0, n_blocks, body, state)


# metrics whose sweep tile derives from the (gram, norms) pair — the
# internal (alternative) metrics the index build substitutes for the common
# user metrics; other metrics take the windowed-join phase iterations
SWEEP_METRICS = (
    "sqeuclidean",
    "euclidean",
    "l2",
    "cosine",
    "alternative_cosine",
    "dot",
    "alternative_dot",
    "inner_product",
    "alternative_inner_product",
)


@functools.partial(jax.jit, static_argnames=("win", "m", "metric", "offset"))
def window_topm(X_t, n_valid=None, *, win: int, m: int, metric: str, offset: int = 0):
    """Exact top-m neighbors within fixed contiguous [win]-row windows.

    X_t [n, d] — data permuted into a tree's leaf order, so each window is a
    spatial cell. Returns (ids i32[n, m], dists f32[n, m]) where ids are
    TREE POSITIONS (global, = window_start + column) and missing entries are
    (-1, +inf).

    ``offset`` staggers the window boundaries: conceptually ``offset``
    zero-pad rows are prepended before slicing windows, so the cut points
    move from ``{0, win, 2*win, ...}`` to ``{win-offset, 2*win-offset, ...}``.
    A second sweep at ``offset=win//2`` gives every tree-order-adjacent pair
    cut by a boundary in the first sweep a window it shares — boundary
    misses are the dominant correlated-miss mode of sweep-only schedules.

    ``n_valid`` (traced, optional) marks rows at and past it as padding:
    they neither receive nor become candidates (a mesh slab's tail).

    This is the gather-free reformulation of the locality-windowed descent
    join (_join_block): instead of sampling ~2c^2 candidate pairs per row
    per iteration through random row gathers, one sweep reads each window
    slab once, computes the slab's full pairwise tile as one matrix
    product, and keeps the exact per-row top-m.
    """
    n, _ = X_t.shape
    lim = n if n_valid is None else jnp.minimum(n, n_valid)
    if win < 2:
        raise ValueError(f"win must be >= 2, got {win}")
    if offset and not 0 < offset < win:
        raise ValueError(f"offset must be in [0, win), got {offset}")
    m = min(m, win - 1)
    n_off = n + offset
    n_pad = -(-n_off // win) * win
    Xp = jnp.pad(X_t, ((offset, n_pad - n_off), (0, 0)))
    nb = n_pad // win

    def body(w, carry):
        ids_all, d_all = carry
        s = w * win
        tile = jax.lax.dynamic_slice_in_dim(Xp, s, win)
        d = dst.pairwise(metric, tile.astype(jnp.float32))
        col = jax.lax.broadcasted_iota(jnp.int32, (win, win), 1)
        row = jax.lax.broadcasted_iota(jnp.int32, (win, win), 0)
        # self-pairs, the zero-padded front (boundary stagger) and tail rows
        d = jnp.where(
            (col == row) | (col + s < offset) | (col + s - offset >= lim)
            | (row + s - offset >= lim),
            jnp.inf,
            d,
        )
        neg, pos = jax.lax.top_k(-d, m)
        ids = jnp.where(neg > -jnp.inf, pos + s - offset, -1)
        ids_all = jax.lax.dynamic_update_slice_in_dim(ids_all, ids, s, 0)
        d_all = jax.lax.dynamic_update_slice_in_dim(d_all, -neg, s, 0)
        return ids_all, d_all

    ids_all = jnp.full((n_pad, m), -1, jnp.int32)
    d_all = jnp.full((n_pad, m), jnp.inf, jnp.float32)
    ids_all, d_all = jax.lax.fori_loop(0, nb, body, (ids_all, d_all))
    return ids_all[offset : offset + n], d_all[offset : offset + n]


@functools.partial(
    jax.jit, static_argnames=("win", "m", "metric", "block_rows", "offset")
)
def _jit_window_sweep(
    state_p: NeighborState, Xp, id_offset=0, n_valid=None, *, win: int, m: int,
    metric: str, block_rows: int = 65536, offset: int = 0,
):
    """Merge each point's exact within-window top-m into the state.

    ``state_p``/``Xp`` are in TREE-POSITION space (the locality-phase
    convention), so the sweep's position ids merge directly. Merged entries
    arrive flagged "new" — the following join iterations explore them.
    ``offset`` staggers the window boundaries (see window_topm);
    ``id_offset`` is the tree position of ``Xp[0]`` and ``n_valid`` the
    number of real rows in ``Xp`` when the rows are one device's slab of a
    sharded table (parallel.mesh)."""
    ids, dd = window_topm(Xp, n_valid, win=win, m=m, metric=metric, offset=offset)
    ids = jnp.where(ids >= 0, ids + id_offset, -1)
    n = state_p.idx.shape[0]
    b = min(block_rows, n)
    n_blocks = -(-n // b)

    def body(blk, st):
        s0 = jnp.minimum(blk * b, n - b)
        blk_state = NeighborState(
            jax.lax.dynamic_slice_in_dim(st.idx, s0, b),
            jax.lax.dynamic_slice_in_dim(st.dist, s0, b),
            jax.lax.dynamic_slice_in_dim(st.flag, s0, b),
        )
        ci = jax.lax.dynamic_slice_in_dim(ids, s0, b)
        cd = jax.lax.dynamic_slice_in_dim(dd, s0, b)
        merged, _ = merge_candidates(blk_state, ci, cd)
        return NeighborState(
            jax.lax.dynamic_update_slice_in_dim(st.idx, merged.idx, s0, 0),
            jax.lax.dynamic_update_slice_in_dim(st.dist, merged.dist, s0, 0),
            jax.lax.dynamic_update_slice_in_dim(st.flag, merged.flag, s0, 0),
        )

    return jax.lax.fori_loop(0, n_blocks, body, state_p)


def _sweep_ok(metric, metric_kwds, X) -> bool:
    return (
        isinstance(metric, str)
        and metric in SWEEP_METRICS
        and not metric_kwds
        and X.dtype in (jnp.float32, jnp.bfloat16)
    )


def _resolve_locality(locality, n_x, forest, n_iters, sweep_ok=True):
    """Resolve the ``locality`` option of nn_descent to
    (window, phases, phase_iters, global_iters, refresh, sweep_win, sweep_m,
    sweep_stagger), or None when disabled or inapplicable (no forest, or
    table below the window). ``sweep_ok`` is False when the metric or dtype
    has no window sweep (``_sweep_ok``): the schedule then takes windowed-join
    phase iterations instead."""
    if locality is None or forest is None:
        return None
    if locality == "auto":
        if n_x < 400_000:
            return None
        # Large-table schedule: exact window sweeps over many tree orders
        # replace sampled windowed joins — every extra tree order is an
        # independent chance for a true pair to share a slab — followed by
        # a short global polish to stitch cross-window 2-hop families.
        # When the sweep doesn't apply (non-gram metric), _sweep_ok below
        # falls back to windowed-join phase iterations. 12 independent tree
        # orders already decorrelate slab boundaries, so the staggered
        # second sweep per phase is off.
        locality = {"sweep": 1024, "phases": 12, "phase_iters": 0,
                    "global_iters": 2, "sweep_stagger": False}
    elif not isinstance(locality, dict):
        raise ValueError("locality must be None, 'auto', or a dict")
    W = int(locality.get("window", 65536))
    if W >= n_x:
        return None
    phases = int(locality.get("phases", 2))
    phase_iters = int(locality.get("phase_iters", max(4, n_iters // 2)))
    global_iters = int(locality.get("global_iters", 2))
    # exact top-m window sweep (window_topm) before each phase's
    # windowed joins: all-pairs within contiguous [sweep]-row slabs of the
    # phase's tree order, the gather-free form of local exploration
    sweep_win = int(locality.get("sweep", 0))
    sweep_m = int(locality.get("sweep_m", 32))
    # second sweep per phase with window boundaries staggered by win/2:
    # rescues true pairs cut by a slab boundary (the dominant correlated
    # miss of sweep-only schedules) for ~one extra sweep's cost
    sweep_stagger = bool(locality.get("sweep_stagger", True))
    if sweep_win and sweep_win < 2:
        raise ValueError("locality['sweep'] must be 0 (off) or >= 2")
    if sweep_win >= n_x:
        sweep_win = 0
    # re-flag every edge as new before the global polish (run_schedule)
    refresh = bool(locality.get("refresh_flags", True))
    if sweep_win and not sweep_ok:
        sweep_win = 0
        if phase_iters <= 0:
            # a sweep-only schedule (many cheap phases) degrades to the
            # windowed-join schedule shape: few phases x several iters
            phase_iters = max(4, n_iters // 2)
            phases = min(phases, 2)
    T = int(forest[0].shape[0])
    phases = min(phases, T)
    if phases <= 0 or (phase_iters <= 0 and not sweep_win):
        return None
    return (W, phases, phase_iters, global_iters, refresh, sweep_win,
            sweep_m, sweep_stagger)


class DescentStages(NamedTuple):
    """The device-specific steps of ``run_schedule``: one card runs them on
    whole arrays (``nn_descent``), a mesh on row shards (parallel.mesh).

    to_tree(state, X, order) -> (state_p, Xp): the state and data in one
        tree's leaf order, neighbor ids as tree positions.
    sweep(state_p, Xp, win, m, offset) -> state_p: each row's exact
        within-window top-m merged in (``_jit_window_sweep``).
    join(state, X, key, n_iters, window_rows) -> state: up to ``n_iters``
        join iterations with the delta early exit; ``window_rows`` restricts
        candidates to tree-order windows (None: the whole table).
    from_tree(state_p, order) -> state: back to id order.
    """

    to_tree: Callable
    sweep: Callable
    join: Callable
    from_tree: Callable


def run_schedule(state, X, key, stages: DescentStages, *, loc, orders, n_iters,
                 verbose: bool = False):
    """The descent schedule after the init: with ``loc`` (from
    ``_resolve_locality``) the locality phases — per phase, one tree order,
    its window sweeps and windowed joins — then the global join iterations.
    ``orders`` holds the forest's tree orders."""
    if loc is not None:
        (W, phases, phase_iters, global_iters, refresh_flags, sweep_win,
         sweep_m, sweep_stagger) = loc
        T = int(orders.shape[0])
        for ph in range(phases):
            order = orders[ph % T]
            state, Xp = stages.to_tree(state, X, order)
            if sweep_win:
                state = stages.sweep(state, Xp, sweep_win, sweep_m, 0)
                if sweep_stagger:
                    state = stages.sweep(state, Xp, sweep_win, sweep_m, sweep_win // 2)
            if phase_iters > 0:
                state = stages.join(
                    state, Xp, rng.derive(key, rng.ROLE_DESCENT_LOCAL, ph),
                    phase_iters, W,
                )
            state = stages.from_tree(state, order)
            del Xp
            if verbose:
                print(
                    f"\tlocality phase {ph + 1} / {phases} (window {W}, "
                    f"tree {ph % T}"
                    + (f", sweep {sweep_win}x{sweep_m}" if sweep_win else "")
                    + ")"
                )
        n_iters = max(global_iters, 0)
        if refresh_flags and n_iters > 0:
            # re-flag every edge as new before the global polish: the
            # windowed phases consumed most flags in-window, and the polish
            # must re-explore the graph's 2-hop family to stitch windows
            state = state._replace(flag=state.idx >= 0)
    return stages.join(state, X, key, n_iters, None)


def nn_descent(
    X,
    n_neighbors: int,
    key,
    *,
    metric="euclidean",
    metric_kwds=None,
    n_iters: int | None = None,
    delta: float = 0.001,
    max_candidates: int | None = None,
    init_graph: NeighborState | None = None,
    forest=None,
    leaf_cap: int | None = None,
    rp_tree_init: bool = True,
    block_rows: int = DEFAULT_BLOCK_ROWS,
    hop2_new_samples: int | None = None,
    hop2_old_samples: int | None = None,
    compute_dtype=None,
    locality=None,
    verbose: bool = False,
):
    """Full NN-descent driver (reference: nn_descent, pynndescent_.py:324).

    Returns (indices i32[n, k], distances f32[n, k]) sorted ascending.

    ``compute_dtype=jnp.bfloat16`` runs the join's candidate gathers and
    distance tiles in bfloat16 (half the device-memory gather traffic of the hottest
    loop); the returned distances are made exact again by a final f32
    rerank of the surviving [n, k] pairs. Only near-tie merge decisions can
    differ from the f32 path. Applied only to float32 data with registry
    (string) metrics.

    ``locality`` enables tree-order windowed descent for large tables:
    most iterations run with candidate gathers restricted to contiguous
    [window]-row slabs of the data permuted into a tree's leaf order (row
    gathers from a bounded window touch a far smaller working set than
    gathers from a multi-GB table). Slabs in tree order are spatial cells,
    so in-window
    candidates cover almost all true neighbors; successive phases rotate
    to a different tree's order (re-blocking space differently), and a few
    full-table iterations polish the remaining cross-window edges. Pass a
    dict {"window": int, "phases": int, "phase_iters": int,
    "global_iters": int} or "auto"; None disables. Requires a forest.
    """
    X = jnp.asarray(X)
    n = X.shape[0]
    k = n_neighbors
    if n_iters is None:
        n_iters = max(5, int(round(np.log2(max(n, 2)))))
    if max_candidates is None:
        max_candidates = min(60, n_neighbors)
    # two-hop budget: expanding ~max_candidates entries of each hop's table
    # matches the reference local join's O(c^2)-pairs-per-row exploration
    if hop2_new_samples is None:
        hop2_new_samples = max_candidates
    if hop2_old_samples is None:
        hop2_old_samples = max(1, max_candidates // 2)

    dist_rowwise = _resolve_rowwise_metric(metric, metric_kwds)
    if leaf_cap is None:
        leaf_cap = 64
    # Bound the join's [b, P, d] candidate tile — the build's peak
    # allocation — to ~1.5 GB regardless of feature width (at d=784 the
    # default 8192-row block would be an 8 GB tile), and halve it again at
    # 1M-row scale, where X, the state and the tables hold ~1 GB more.
    t_nn_est = max(1, (hop2_new_samples + 1) // 2)
    t_no_est = max(0, hop2_new_samples - t_nn_est)
    pool_w = 2 * max_candidates * (1 + t_nn_est + t_no_est + hop2_old_samples)
    d_bytes = int(np.prod(X.shape[1:])) * X.dtype.itemsize
    tile_budget = 3 << 28 if n > (1 << 19) else (3 << 29)
    block_rows = int(
        max(512, min(block_rows, tile_budget // max(pool_w * d_bytes, 1)))
    )

    if (
        compute_dtype is not None
        and X.dtype == jnp.float32
        and isinstance(metric, str)
    ):
        X_join = X.astype(compute_dtype)
    else:
        X_join = X
        compute_dtype = None

    state = init_graph if init_graph is not None else make_neighbor_state(n, k)

    # Staged jitted pipeline: each stage is a module-level jit with static
    # config, so identical configs reuse traces in-process and the persistent
    # XLA cache across processes. (A fully fused single program was tried and
    # costs several minutes of XLA compilation; staged compiles are far
    # cheaper for identical device time, since runtime is dispatch-light.)
    if forest is not None and rp_tree_init:
        orders, starts, sizes = forest
        T = int(orders.shape[0])
        # bound the gathered [b, T*cap, d] candidate tile to ~4 GB; prefer
        # the widest block the budget allows (fewer, larger gathers)
        init_block = int(max(256, min(8192, (1 << 32) // max(T * leaf_cap * d_bytes, 1))))
        state = _jit_forest_init(
            state, X_join, orders, starts, sizes,
            dist_rowwise=dist_rowwise, leaf_cap=leaf_cap,
            block_rows=init_block,
        )
    rand_block = int(max(1024, min(65536, (1 << 30) // max((k + 1) * d_bytes, 1))))
    state = _jit_init_random(
        state, X_join, rng.derive(key, rng.ROLE_DESCENT_INIT),
        n_extra=k, dist_rowwise=dist_rowwise, block_rows=rand_block,
    )

    stop_count = jnp.float32(delta * k * n)
    block_rows = min(block_rows, n)

    def join(state, X_, key_, n_iters_, window_rows):
        if verbose and window_rows is None:
            # per-iteration prints need a host sync each round — only pay
            # that when asked to narrate
            for it in range(n_iters_):
                state, changes = _jit_iteration(
                    state, X_, rng.derive(key_, rng.ROLE_DESCENT_ITER, it),
                    max_candidates=max_candidates,
                    dist_rowwise=dist_rowwise,
                    block_rows=block_rows,
                    hop2_new_samples=hop2_new_samples,
                    hop2_old_samples=hop2_old_samples,
                )
                print(f"\t{it + 1}  /  {n_iters_}  (changes: {int(changes)})")
                if int(changes) <= stop_count:
                    print(f"\tStopping threshold met -- exiting after {it + 1} iterations")
                    break
            return state
        # fused driver: the delta early-exit runs on device, so the whole
        # loop is one dispatch with zero per-iteration host syncs
        return _jit_descent_loop(
            state, X_, key_, stop_count,
            n_iters=n_iters_,
            max_candidates=max_candidates,
            dist_rowwise=dist_rowwise,
            block_rows=block_rows,
            hop2_new_samples=hop2_new_samples,
            hop2_old_samples=hop2_old_samples,
            window_rows=window_rows,
        )

    stages = DescentStages(
        to_tree=lambda st, X_, order: (
            _state_to_tree_order(st, order), _jit_permute_rows(X_, order)
        ),
        sweep=lambda st, Xp, win, m, offset: _jit_window_sweep(
            st, Xp, win=win, m=m, metric=metric, offset=offset
        ),
        join=join,
        from_tree=_state_from_tree_order,
    )
    use_forest = forest if rp_tree_init else None
    loc = _resolve_locality(
        locality, n, use_forest, n_iters,
        sweep_ok=_sweep_ok(metric, metric_kwds, X_join),
    )
    state = run_schedule(
        state, X_join, key, stages, loc=loc,
        orders=None if use_forest is None else jnp.asarray(use_forest[0]),
        n_iters=n_iters, verbose=verbose,
    )

    idx, dist = _jit_sort(state.idx, state.dist)
    if compute_dtype is not None:
        # width-aware block: the rerank gathers [b, k, d] f32 tiles, ~512 MB
        # at most (a 65536-row block of a 4096-wide sparse sketch would be a
        # 16 GB tile)
        rb = max(1024, min(65536, (1 << 29) // max(k * X.shape[1] * 4, 1)))
        idx, dist = exact_rerank_graph(
            X, idx, dist_rowwise=dist_rowwise, block_rows=rb
        )
    return idx, dist


@functools.partial(
    jax.jit,
    static_argnames=(
        "n_iters", "max_candidates", "dist_rowwise", "block_rows",
        "hop2_new_samples", "hop2_old_samples", "window_rows",
    ),
)
def _jit_descent_loop(
    state, X, key, stop_count, *, n_iters, max_candidates, dist_rowwise,
    block_rows, hop2_new_samples, hop2_old_samples, window_rows=None,
):
    def cond(carry):
        _, it, changes = carry
        return (it < n_iters) & (changes > stop_count)

    def body(carry):
        st, it, _ = carry
        st, ch = _descent_iteration(
            st, X, rng.derive(key, rng.ROLE_DESCENT_ITER, it),
            max_candidates=max_candidates,
            dist_rowwise=dist_rowwise,
            block_rows=block_rows,
            hop2_new_samples=hop2_new_samples,
            hop2_old_samples=hop2_old_samples,
            window_rows=window_rows,
        )
        return st, it + 1, ch.astype(jnp.float32)

    state, _, _ = jax.lax.while_loop(
        cond, body, (state, jnp.int32(0), jnp.float32(np.inf))
    )
    return state


@functools.partial(jax.jit, static_argnames=("dist_rowwise", "block_rows"))
def exact_rerank_graph(X, idx, *, dist_rowwise, block_rows: int = 65536):
    """Recompute exact f32 distances of the graph's surviving pairs and
    re-sort each row (the cheap final step of the bf16-join mode)."""
    n, k = idx.shape
    b = min(block_rows, n)
    n_blocks = -(-n // b)

    def body(blk, carry):
        oidx, odist = carry
        s0 = jnp.minimum(blk * b, n - b)
        rows = s0 + jnp.arange(b, dtype=jnp.int32)
        bi = idx[rows]
        d = dist_rowwise(X[rows], X[jnp.maximum(bi, 0)])
        d = jnp.where(bi < 0, jnp.inf, d)
        sd, si = jax.lax.sort((d, bi), num_keys=1, dimension=-1)
        return (
            oidx.at[rows].set(si, unique_indices=True),
            odist.at[rows].set(jnp.where(jnp.isinf(sd), jnp.inf, sd), unique_indices=True),
        )

    out = jax.lax.fori_loop(
        0, n_blocks, body,
        (jnp.zeros_like(idx), jnp.full(idx.shape, jnp.inf, jnp.float32)),
    )
    return out


_jit_tree_init = jax.jit(
    init_from_tree_order, static_argnames=("dist_rowwise", "leaf_cap", "block_rows")
)
_jit_forest_init = jax.jit(
    init_from_forest, static_argnames=("dist_rowwise", "leaf_cap", "block_rows")
)
_jit_init_random = jax.jit(
    init_random, static_argnames=("n_extra", "dist_rowwise", "block_rows")
)
_jit_iteration = jax.jit(
    _descent_iteration,
    static_argnames=(
        "max_candidates", "dist_rowwise", "block_rows",
        "hop2_new_samples", "hop2_old_samples", "window_rows",
    ),
)
_jit_sort = jax.jit(sort_by_distance)
