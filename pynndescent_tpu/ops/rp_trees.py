"""Random-projection trees — level-synchronous, recursion-free construction.

Capability parity with the reference's RP-forest layer (``rp_trees.py``:
random euclidean/angular splits :323/:60, recursive builders :2173-2641,
forest orchestration :2815, leaf arrays :2918) with a completely different
construction shape:

The reference builds each tree by *recursion*, one node at a time, splitting a
typed-list of point indices. Here a whole tree is built **level by level with
no recursion and no per-node control flow**, using a node-location encoding
(the idea sketched in the reference's vestigial ``threaded_rp_trees.py:6-9``
but taken to its batched, fixed-shape conclusion):

* points live in a permutation ``order[n]`` where every tree node owns a
  contiguous slice; each *position* carries its node's ``(start, size)``;
* the two random split points of a node are chosen by a counter-based integer
  hash of ``(seed, level, start)`` — every member of a node derives the same
  choice with zero communication;
* one fused pass computes all margins for all nodes at a level (gather the
  two anchor points, elementwise dot), and a segmented
  cumulative-sum partitions every node in place.

A whole forest is ``vmap`` of this over per-tree seeds. Degenerate splits
(all points on one side — duplicates/zero vectors) fall back to random side
assignment exactly like the reference (rp_trees.py:144-155), which also
bounds the depth at ~log2(n/leaf_size) + slack.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Reference default: leaf_size = max(60, min(256, 5*k)) (rp_trees.py:2845)


def default_leaf_size(n_neighbors: int) -> int:
    return max(60, min(256, 5 * n_neighbors))


def default_n_trees(n: int) -> int:
    # reference: max(3, min(12, round(2 * log10(n)))) (pynndescent_.py:1009)
    return max(3, min(12, int(round(2.0 * np.log10(max(n, 10))))))


def forest_depth(n: int, leaf_size: int) -> int:
    return int(np.ceil(np.log2(max(n / max(leaf_size, 1), 1.0)))) + 8


# ---------------------------------------------------------------------------
# Counter-based integer hashing (per-node / per-point randomness)
# ---------------------------------------------------------------------------


def _mix(h):
    """splitmix-style 32-bit finalizer."""
    h = jnp.uint32(h)
    h = (h ^ (h >> 16)) * jnp.uint32(0x7FEB352D)
    h = (h ^ (h >> 15)) * jnp.uint32(0x846CA68B)
    h = h ^ (h >> 16)
    return h


def _hash3(a, b, c):
    h = (
        jnp.uint32(a) * jnp.uint32(0x9E3779B9)
        + jnp.uint32(b) * jnp.uint32(0x85EBCA6B)
        + jnp.uint32(c) * jnp.uint32(0xC2B2AE35)
    )
    return _mix(h)


def _hash_mod(a, b, c, mod):
    """Hash of (a, b, c) reduced into [0, mod) (mod must be >= 1)."""
    return (_hash3(a, b, c) % jnp.uint32(jnp.maximum(mod, 1))).astype(jnp.int32)


def _level_directions(seed, max_depth, d):
    """Deterministic gaussian direction per tree level (Box-Muller over
    counter hashes). Level-shared directions let the init-forest builder
    compute every split margin from ONE ``X @ R`` matmul in point-id space
    (a sequential read of X) instead of gathering three full
    ``[n, d]`` row sets per level per tree — the batched reshaping of the
    reference's per-node random-pair hyperplanes (rp_trees.py:323-430)."""
    lev = jnp.arange(max_depth, dtype=jnp.uint32)[:, None]
    dim = jnp.arange(d, dtype=jnp.uint32)[None, :]
    h1 = _hash3(seed, lev * 2 + jnp.uint32(101), dim)
    h2 = _hash3(seed, lev * 2 + jnp.uint32(102), dim)
    u1 = (h1.astype(jnp.float32) + 1.0) * jnp.float32(1.0 / 4294967296.0)
    u2 = h2.astype(jnp.float32) * jnp.float32(1.0 / 4294967296.0)
    return jnp.sqrt(-2.0 * jnp.log(u1)) * jnp.cos(2.0 * np.pi * u2)  # [L, d]


# ---------------------------------------------------------------------------
# One level of splits, all nodes at once
# ---------------------------------------------------------------------------


def _bit_margin(x, xa, xb):
    """Signed closest-anchor margin for bit-packed rows: popcount(x ^ xb) -
    popcount(x ^ xa); positive means x is closer to anchor a."""
    da = jnp.sum(jax.lax.population_count(jnp.bitwise_xor(x, xa)).astype(jnp.int32), axis=-1)
    db = jnp.sum(jax.lax.population_count(jnp.bitwise_xor(x, xb)).astype(jnp.int32), axis=-1)
    return (db - da).astype(jnp.float32)


def _segment_cumsum_stats(values, start, size):
    """For per-position int values inside contiguous node slices, return
    (prefix_within_node_exclusive, total_within_node). ``values`` may carry
    leading batch axes ([..., n]); ``start``/``size`` are [n] and broadcast —
    one cumsum serves all stacked rows."""
    cum = jnp.cumsum(values, axis=-1)  # inclusive
    before_node = jnp.where(
        start > 0, jnp.take(cum, jnp.maximum(start - 1, 0), axis=-1), 0
    )
    total = jnp.take(cum, start + size - 1, axis=-1) - before_node
    prefix_excl = cum - values - before_node
    return prefix_excl, total


# bail-to-leaf threshold for scored hub splits (reference MIN_SPLIT_BALANCE,
# rp_trees.py:798)
MIN_SPLIT_BALANCE = 0.1


def _hub_anchor_points(order, start, size, degrees, n):
    """Graph-informed anchor choice (the reference's hub trees,
    rp_trees.py:680-2170): the EXACT top-3 highest global-in-degree members
    of each node (reference get_top_k_hub_indices :747), computed for every
    node at a level with ONE segmented sort — positions are already grouped
    by node (contiguous slices, ``start`` nondecreasing), so sorting by
    (start, -degree) puts each node's top hubs at its first three positions.
    Deterministic: ties break on point id via the stable sort. Returns point
    ids h1, h2, h3 (descending degree)."""
    deg = degrees[order].astype(jnp.int32)
    _, _, by_deg = jax.lax.sort(
        (start, -deg, order), num_keys=2, is_stable=True
    )
    # tiny degenerate nodes (size < 3) clamp within the node; such nodes are
    # at or below leaf_size and never actually split
    p2 = start + jnp.minimum(1, jnp.maximum(size - 1, 0))
    p3 = start + jnp.minimum(2, jnp.maximum(size - 1, 0))
    return (
        by_deg[jnp.clip(start, 0, n - 1)],
        by_deg[jnp.clip(p2, 0, n - 1)],
        by_deg[jnp.clip(p3, 0, n - 1)],
    )


def _edge_cut_scores(order, start, sides, neighbor_idx, n):
    """Per-position edge-cut count of each candidate split: the number of
    directed graph edges (i -> j) with both endpoints in the position's node
    whose endpoints land on opposite sides (reference sparse/bit hub splits
    score by edge cuts, rp_trees.py:1414-1431). ``sides`` is [3, n] per
    *position*; returns [3, n] cut counts broadcast back to positions."""
    node_of_id = jnp.zeros(n, jnp.int32).at[order].set(start, unique_indices=True)
    nb = neighbor_idx
    nb_safe = jnp.clip(nb, 0, n - 1)
    same_node = (nb >= 0) & (node_of_id[nb_safe] == node_of_id[:, None])
    node_rows = jnp.broadcast_to(node_of_id[:, None], nb.shape)
    cuts = []
    for c in range(sides.shape[0]):
        side_id = jnp.zeros(n, bool).at[order].set(sides[c], unique_indices=True)
        cut_edge = same_node & (side_id[nb_safe] != side_id[:, None])
        table = jnp.zeros(n, jnp.int32).at[node_rows].add(cut_edge.astype(jnp.int32))
        cuts.append(table[start])
    return jnp.stack(cuts)




def _anchor_scores(X, norms, x, pts, angular, ell_nnz):
    """Per-point score s against anchor point ids ``pts``; the hyperplane
    margin of an anchor pair (a, b) is ``s_a - s_b``:

    * dense euclidean: s = <x, xa> - ||xa||^2/2
    * angular:         s = <x, xa> / ||xa||
    * bit-packed:      s = -hamming(x, xa)  (closest-anchor assignment)
    * packed ELL:      same formulas through sparse_dot
    """
    xa = X[pts]
    if ell_nnz is not None:
        from pynndescent_tpu.ops import sparse_ell as se

        if isinstance(ell_nnz, tuple):
            nnz_x, nnz_a = ell_nnz  # x and anchor rows may differ in width
        else:
            nnz_x = nnz_a = ell_nnz
        da = se.sparse_dot(x, xa, nnz_x, nnz_a)
        if angular:
            return da / jnp.maximum(norms[pts], 1e-8)
        return da - 0.5 * se._sq_norm(xa, nnz_a)
    if X.dtype == jnp.uint8:
        ham = jnp.sum(
            jax.lax.population_count(jnp.bitwise_xor(x, xa)).astype(jnp.int32), axis=-1
        )
        return -ham.astype(jnp.float32)
    d = jnp.sum(x * xa, axis=-1)
    if angular:
        return d / jnp.maximum(norms[pts], 1e-8)
    return d - 0.5 * jnp.sum(xa * xa, axis=-1)


def _split_level(X, norms, order, start, size, level, seed, leaf_size, angular,
                 degrees=None, ell_nnz=None, sealed=None, neighbor_idx=None):
    """Split every active node at one level.

    Random mode (``degrees is None``): two hash-chosen anchors per node;
    degenerate all-one-side splits fall back to random assignment
    (reference rp_trees.py:144-155).

    Hub mode (``degrees`` given): the three EXACT top-in-degree members of
    each node anchor three pair hyperplanes. Dense float data keeps the
    best-*balanced* one; a node whose best balance is below
    MIN_SPLIT_BALANCE bails to a leaf (reference euclidean_hub_split,
    rp_trees.py:798-933). Sparse-ELL and bit-packed data with
    ``neighbor_idx`` given keep the minimum-*edge-cut* one among candidates
    with two nonempty sides, falling back to random assignment when all
    three are degenerate (reference sparse/bit hub splits,
    rp_trees.py:1414-1431).

    Returns ``(order, start, size, sealed), (a_pt, b_pt)`` where the anchor
    arrays are aligned to the *entering* positions (what each node at this
    level split on — consumed by the tree flattener).
    """
    n = X.shape[0]
    pos = jnp.arange(n, dtype=jnp.int32)
    if sealed is None:
        sealed = jnp.zeros(n, bool)
    done = (size <= leaf_size) | sealed
    x = X[order]

    # tie -> per-point coin flip (reference rp_trees.py:131-143)
    coin = (_hash3(seed, jnp.uint32(level), order.astype(jnp.uint32)) & 1).astype(bool)

    if degrees is not None:
        h1, h2, h3 = _hub_anchor_points(order, start, size, degrees, n)
        s1 = _anchor_scores(X, norms, x, h1, angular, ell_nnz)
        s2 = _anchor_scores(X, norms, x, h2, angular, ell_nnz)
        s3 = _anchor_scores(X, norms, x, h3, angular, ell_nnz)
        sides, apts, bpts = [], [], []
        for pa, pb, sa, sb in ((h1, h2, s1, s2), (h1, h3, s1, s3), (h2, h3, s2, s3)):
            m = sa - sb
            sd = jnp.where(m > 0, True, jnp.where(m < 0, False, coin))
            sides.append(jnp.where(done, False, sd))
            apts.append(pa)
            bpts.append(pb)
        sides = jnp.stack(sides)  # [3, n]
        edge_cut = neighbor_idx is not None and (
            ell_nnz is not None or X.dtype == jnp.uint8
        )
        if edge_cut:
            # candidate 3 = pure coin assignment (reference random fallback)
            coin_side = jnp.where(done, False, coin)
            cand_sides = jnp.concatenate([sides, coin_side[None]], axis=0)
            prefixes, totals = _segment_cumsum_stats(
                (~cand_sides).astype(jnp.int32), start, size
            )
            cuts = _edge_cut_scores(order, start, sides, neighbor_idx, n)
            valid = (totals[:3] > 0) & (totals[:3] < size)
            score = jnp.where(valid, cuts, jnp.iinfo(jnp.int32).max)
            best = jnp.argmin(score, axis=0)
            best = jnp.where(jnp.any(valid, axis=0), best, 3)
            take = lambda arrs: jnp.take_along_axis(arrs, best[None], axis=0)[0]
            side = take(cand_sides)
            rank_left = take(prefixes)
            n_left = take(totals)
            take3 = lambda arrs: jnp.take_along_axis(
                arrs, jnp.minimum(best, 2)[None], axis=0
            )[0]
            a_pt = take3(jnp.stack(apts))
            b_pt = take3(jnp.stack(bpts))
            side = jnp.where(done, False, side)
        else:
            # one batched cumsum scores all three pair hyperplanes at once
            prefixes, totals = _segment_cumsum_stats(
                (~sides).astype(jnp.int32), start, size
            )
            bals = jnp.minimum(totals, size - totals).astype(jnp.float32) / jnp.maximum(
                size, 1
            ).astype(jnp.float32)
            best = jnp.argmax(bals, axis=0)  # [n] (node-uniform: bal is)
            take = lambda arrs: jnp.take_along_axis(arrs, best[None], axis=0)[0]
            side = take(sides)
            best_bal = take(bals)
            rank_left = take(prefixes)
            n_left = take(totals)
            a_pt = take(jnp.stack(apts))
            b_pt = take(jnp.stack(bpts))
            # bail to leaf: hopelessly unbalanced nodes stop splitting for good
            newly_sealed = (~done) & (best_bal < MIN_SPLIT_BALANCE)
            sealed = sealed | newly_sealed
            done = done | newly_sealed
            side = jnp.where(done, False, side)
    else:
        a_off = _hash_mod(seed, jnp.uint32(level * 2 + 1), start.astype(jnp.uint32), size)
        b_off = _hash_mod(seed, jnp.uint32(level * 2 + 2), start.astype(jnp.uint32), jnp.maximum(size - 1, 1))
        b_off = jnp.where(b_off >= a_off, b_off + 1, b_off)
        b_off = jnp.minimum(b_off, size - 1)
        a_pt = order[jnp.clip(start + a_off, 0, n - 1)]
        b_pt = order[jnp.clip(start + b_off, 0, n - 1)]
        margin = _anchor_scores(X, norms, x, a_pt, angular, ell_nnz) - _anchor_scores(
            X, norms, x, b_pt, angular, ell_nnz
        )
        side_m = jnp.where(done, False, jnp.where(margin > 0, True, jnp.where(margin < 0, False, coin)))
        side_c = jnp.where(done, False, coin)
        # one batched cumsum covers both the margin side and the coin
        # fallback (degenerate all-one-side splits -> random assignment)
        stacked = jnp.stack([(~side_m).astype(jnp.int32), (~side_c).astype(jnp.int32)])
        prefixes, totals = _segment_cumsum_stats(stacked, start, size)
        degenerate = (~done) & ((totals[0] == 0) | (totals[0] == size))
        side = jnp.where(degenerate, side_c, side_m)
        rank_left = jnp.where(degenerate, prefixes[1], prefixes[0])
        n_left = jnp.where(degenerate, totals[1], totals[0])

    rank_right = (pos - start) - rank_left

    new_pos = jnp.where(side, start + n_left + rank_right, start + rank_left)
    new_pos = jnp.where(done, pos, new_pos)
    new_start = jnp.where(done, start, jnp.where(side, start + n_left, start))
    new_size = jnp.where(done, size, jnp.where(side, size - n_left, n_left))

    # new_pos is a permutation: declare indices unique so XLA emits a
    # vectorized scatter instead of a serialized collision-safe loop
    out_order = jnp.zeros_like(order).at[new_pos].set(order, unique_indices=True)
    out_start = jnp.zeros_like(start).at[new_pos].set(new_start, unique_indices=True)
    out_size = jnp.zeros_like(size).at[new_pos].set(new_size, unique_indices=True)
    out_sealed = jnp.zeros_like(sealed).at[new_pos].set(sealed, unique_indices=True)
    return (out_order, out_start, out_size, out_sealed), (a_pt, b_pt)


def _tree_norms(X, angular, ell_nnz=None):
    if not angular or X.dtype == jnp.uint8:
        return jnp.zeros((X.shape[0],), jnp.float32)
    if ell_nnz is not None:
        from pynndescent_tpu.ops import sparse_ell as se

        return jnp.sqrt(se._sq_norm(X, ell_nnz))
    return jnp.linalg.norm(X, axis=-1)


@functools.partial(
    jax.jit, static_argnames=("leaf_size", "max_depth", "angular", "ell_nnz")
)
def build_tree_order(X, seed, leaf_size: int, max_depth: int, angular: bool = False,
                     ell_nnz: int | None = None, degrees=None, neighbor_idx=None):
    """Build one RP tree, returning the node-location encoding:

    order i32[n] — point ids grouped so every leaf is a contiguous slice
    start i32[n] — per position, the first position of its leaf slice
    size  i32[n] — per position, its leaf's member count

    With ``degrees`` the splits are scored hub splits (used to *score*
    candidate search trees before flattening the winner).
    (Replaces the reference's recursive make_*_tree, rp_trees.py:2173-2641.)
    """
    n = X.shape[0]
    norms = _tree_norms(X, angular, ell_nnz)
    order = jnp.arange(n, dtype=jnp.int32)
    start = jnp.zeros(n, jnp.int32)
    size = jnp.full(n, n, jnp.int32)
    sealed = jnp.zeros(n, bool)

    # while_loop with an all-done early exit: max_depth carries slack for
    # degenerate splits, but typical trees finish ~40% shallower — each saved
    # level saves three full row-gather passes
    def cond(carry):
        level, _, _, size, sealed = carry
        return (level < max_depth) & jnp.any((size > leaf_size) & ~sealed)

    def body(carry):
        level, order, start, size, sealed = carry
        new, _ = _split_level(X, norms, order, start, size, level, seed, leaf_size,
                              angular, ell_nnz=ell_nnz, sealed=sealed,
                              degrees=degrees, neighbor_idx=neighbor_idx)
        return (level + 1,) + new

    _, order, start, size, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), order, start, size, sealed)
    )
    return order, start, size


def _segment_means(vals, seg):
    """Mean and size of each element's segment, per row of ``[T, n]``
    ``vals`` grouped by the integer labels ``seg``.

    The sums run in a fixed order — a stable sort by label, then a
    segmented scan — so identical inputs give bit-identical means on every
    backend. A float scatter-add would sum in the order the device's atomics
    land, which changes from run to run on a GPU; a mean one ulp off can
    flip a point's side of the split and change the tree."""
    T, n = vals.shape
    pos = jnp.broadcast_to(jnp.arange(n, dtype=jnp.int32)[None], (T, n))
    seg_s, v_s, perm = jax.lax.sort(
        (seg, vals, pos), dimension=1, num_keys=1, is_stable=True
    )
    head = jnp.concatenate(
        [jnp.ones((T, 1), bool), seg_s[:, 1:] != seg_s[:, :-1]], axis=1
    )

    def add_within_segment(a, b):
        head_a, sum_a = a
        head_b, sum_b = b
        return head_a | head_b, jnp.where(head_b, sum_b, sum_a + sum_b)

    _, csum = jax.lax.associative_scan(add_within_segment, (head, v_s), axis=1)
    is_end = jnp.concatenate([head[:, 1:], jnp.ones((T, 1), bool)], axis=1)
    end = jax.lax.cummin(jnp.where(is_end, pos, n), axis=1, reverse=True)
    first = jax.lax.cummax(jnp.where(head, pos, 0), axis=1)
    cnt_s = end - first + 1
    mean_s = jnp.take_along_axis(csum, end, axis=1) / cnt_s.astype(vals.dtype)
    # back to element order (perm is a permutation: a unique scatter)
    trow = jnp.arange(T)[:, None]
    mean = jnp.zeros_like(vals).at[trow, perm].set(mean_s, unique_indices=True)
    cnt = jnp.zeros((T, n), jnp.int32).at[trow, perm].set(cnt_s, unique_indices=True)
    return mean, cnt


@functools.partial(jax.jit, static_argnames=("leaf_size", "max_depth", "angular"))
def _fast_forest_orders(X, seeds, leaf_size: int, max_depth: int, angular: bool):
    """Init-forest builder with the per-level work reduced to one matrix
    product, one sort and elementwise passes over ``[n_trees, n]``.

    Design (replaces the reference's recursive random-pair splits,
    rp_trees.py:323-430, for the init forest only — these trees are
    consumed as leaf arrays and never descended at query time):

    * per tree, one level-shared random direction per level
      (_level_directions); all projections = one ``X @ R`` matmul in
      point-id space (sequential read of X, no gathers);
    * each point carries a node id (path bits); a level splits every node
      at its segment-mean projection (_segment_means, summed in a fixed
      order so the trees are reproducible);
    * nodes at or below ``leaf_size`` freeze by setting their threshold to
      +inf: all members keep taking the left branch together, so the leaf
      survives to the final level with a unique id and no mask is needed;
    * all-equal projections (duplicate blobs) tie on the threshold and
      split by a hash coin, mirroring the reference's degenerate-split
      random fallback (rp_trees.py:144-155);
    * one final sort by node id recovers the ``(order, start, size)``
      node-location encoding.
    """
    n, d = X.shape
    T = seeds.shape[0]
    norms = _tree_norms(X, angular)
    point_ids = jnp.arange(n, dtype=jnp.int32)

    # per-level direction bank for ALL trees: [T, L, d]. Projections are
    # computed per level ([T, n] at a time) instead of materialising the
    # full [T, n, L] tensor — at n=1M x 12 trees x 18 levels that tensor
    # alone is ~0.9 GB (one [n,d]x[d,T] matmul per level is a cheap
    # sequential read of X).
    R_bank = jax.vmap(lambda s: _level_directions(s, max_depth, d))(seeds)  # [T, L, d]
    trow = jnp.arange(T)[:, None]
    inv_norms = (
        (1.0 / jnp.maximum(norms, 1e-8))[None, :] if angular else None
    )
    M = 1 << max_depth

    # Level loop as a while_loop instead of a Python unroll: the body is
    # depth-independent (one compiled program for any depth), and the
    # all-leaves-frozen early exit comes for free (mean splits finish a few
    # levels shallower than the slack-padded max_depth).
    def body(carry):
        level, node, _ = carry
        Rl = jax.lax.dynamic_index_in_dim(R_bank, level, axis=1, keepdims=False)
        # default precision: on an H100 an f32 product runs in TF32 here;
        # the split only needs an approximate median-like cut
        pl = jax.lax.dot_general(
            Rl, X, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )  # [T, n]
        if inv_norms is not None:
            pl = pl * inv_norms
        mean, cnt = _segment_means(pl, node)
        thr_p = jnp.where(cnt <= leaf_size, jnp.inf, mean)
        coin = (_hash3(seeds[:, None], (level * 2 + 7).astype(jnp.uint32), point_ids[None]) & 1).astype(bool)
        side = jnp.where(pl == thr_p, coin, pl > thr_p)
        # nodes at or below leaf_size froze (thr=inf -> all left): once
        # every node is frozen the remaining levels are pure no-op
        # shifts, which do not change the grouping order — exit early.
        not_done = jnp.max(cnt) > leaf_size
        return level + 1, node * 2 + side.astype(jnp.int32), not_done

    _, node, _ = jax.lax.while_loop(
        lambda c: (c[0] < max_depth) & c[2],
        body,
        (jnp.int32(0), jnp.zeros((T, n), jnp.int32), jnp.bool_(True)),
    )
    # int32 accumulation: a float32 cumsum loses integer exactness past 2^24,
    # silently misaligning leaf windows at n > ~16.7M
    cnt = jnp.zeros((T, M), jnp.int32).at[trow, node].add(1)
    prefix = jnp.cumsum(cnt, axis=1) - cnt
    pair = jnp.stack([prefix, cnt], axis=-1)  # [T, M, 2] i32
    ids = jnp.broadcast_to(point_ids[None], (T, n))
    node_s, order = jax.lax.sort((node, ids), dimension=1, num_keys=1, is_stable=True)
    se = pair[trow, node_s]  # [T, n, 2]
    return order, se[..., 0], se[..., 1]


def build_forest_orders(X, seeds, leaf_size: int, max_depth: int, angular: bool = False,
                        ell_nnz: int | None = None, fast: bool = True):
    """Tree construction over per-tree seeds -> [n_trees, n] encodings
    (replaces joblib-thread forest orchestration, rp_trees.py:2815-2880).

    Dense float data defaults to the fast level-shared-projection splits
    (see build_tree_order) — init-forest trees are consumed only as leaf
    arrays, so the split rule never has to be replayed at query time.

    Trees are vmapped when the per-level gather working set (3 point-row
    gathers per tree on the exact path) fits comfortably in HBM; otherwise
    they build sequentially through one compiled program."""
    X = jnp.asarray(X)
    seeds = jnp.asarray(seeds, jnp.uint32)
    n, d = X.shape
    n_trees = int(seeds.shape[0])
    fast = fast and ell_nnz is None and X.dtype != jnp.uint8
    if fast:
        # mean splits are near-balanced: small slack over the ideal depth
        # (vs +8 for random-pair splits) — every level is ~2 issue-bound ops
        depth = min(
            max_depth,
            int(np.ceil(np.log2(max(n / max(leaf_size, 1), 1.0)))) + 4,
        )
        workset = n_trees * n * max(depth, 1) * 4  # the projection table
        if workset <= 4 << 30:
            return _fast_forest_orders(X, seeds, leaf_size, depth, angular)
        outs = [
            _fast_forest_orders(X, seeds[t : t + 1], leaf_size, depth, angular)
            for t in range(n_trees)
        ]
        return tuple(jnp.concatenate([o[i] for o in outs]) for i in range(3))
    workset = 3 * n_trees * n * d * 4  # bytes of gathered rows per level
    fn = functools.partial(
        build_tree_order, X, leaf_size=leaf_size, max_depth=max_depth, angular=angular,
        ell_nnz=ell_nnz,
    )
    if workset <= 4 << 30:
        return jax.vmap(fn)(seeds)
    outs = [fn(seeds[t]) for t in range(n_trees)]
    return tuple(jnp.stack([o[i] for o in outs]) for i in range(3))


def leaf_arrays_from_order(order, start, size):
    """Host-side extraction of the padded leaf matrix [n_leaves, leaf_max]
    from one tree's node-location encoding (replaces rptree_leaf_array,
    rp_trees.py:2918)."""
    order = np.asarray(order)
    start = np.asarray(start)
    size = np.asarray(size)
    n = order.shape[0]
    heads = np.nonzero(np.arange(n) == start)[0]
    leaf_sizes = size[heads]
    leaf_max = int(leaf_sizes.max()) if len(leaf_sizes) else 0
    leaves = np.full((len(heads), leaf_max), -1, np.int32)
    for li, (h, s) in enumerate(zip(heads, leaf_sizes)):
        leaves[li, :s] = order[h : h + s]
    return leaves


# ---------------------------------------------------------------------------
# Flat search tree (query seeding)
# ---------------------------------------------------------------------------
#
# The reference flattens its recursive trees into contiguous arrays for search
# (convert_tree_format, rp_trees.py:3019; leaves encoded as negated index
# ranges :2929-2934). Here the flat form is built directly from per-level
# snapshots of the node-location encoding; instead of storing d-dimensional
# hyperplanes per node we store only the two anchor *point ids* — the
# hyperplane is recomputed from two data gathers at query time, which costs
# O(d) per visited node but keeps the tree O(n_nodes) in memory.


class FlatTree:
    """Array-encoded RP tree for query descent.

    a_pt, b_pt i32[n_nodes] — anchor points defining the node's hyperplane
    child      i32[n_nodes, 2] — left/right children (leaves self-loop)
    leaf_lo/hi i32[n_nodes] — leaf slice into tree_order (-1 for internal)
    tree_order i32[n] — points grouped by leaf
    """

    def __init__(self, a_pt, b_pt, child, leaf_lo, leaf_hi, tree_order, depth, angular,
                 hyper=None, offset=None):
        self.a_pt = a_pt
        self.b_pt = b_pt
        self.child = child
        self.leaf_lo = leaf_lo
        self.leaf_hi = leaf_hi
        self.tree_order = tree_order
        self.depth = int(depth)
        self.angular = bool(angular)
        # optional materialized hyperplanes [n_nodes, d] + offsets [n_nodes]:
        # used when the raw float data is unavailable at query time
        # (quantized indexes) — mirrors the reference's explicit FlatTree
        # hyperplane storage (rp_trees.py:27-29)
        self.hyper = hyper
        self.offset = offset
        self.leaf_max = (
            int(np.max(np.asarray(leaf_hi) - np.asarray(leaf_lo)))
            if len(np.asarray(leaf_lo))
            else 0
        )

    def to_arrays(self):
        d = dict(
            a_pt=np.asarray(self.a_pt),
            b_pt=np.asarray(self.b_pt),
            child=np.asarray(self.child),
            leaf_lo=np.asarray(self.leaf_lo),
            leaf_hi=np.asarray(self.leaf_hi),
            tree_order=np.asarray(self.tree_order),
            depth=self.depth,
            angular=self.angular,
        )
        d["leaf_size"] = getattr(self, "leaf_size_cfg", 0)
        if self.hyper is not None:
            d["hyper"] = np.asarray(self.hyper)
            d["offset"] = np.asarray(self.offset)
        return d

    @classmethod
    def from_arrays(cls, d):
        return cls(
            d["a_pt"], d["b_pt"], d["child"], d["leaf_lo"], d["leaf_hi"],
            d["tree_order"], d["depth"], d["angular"],
            hyper=d.get("hyper"), offset=d.get("offset"),
        )


def default_head_cap(n: int, leaf_size: int) -> int:
    """Static bound on nodes per level for the compact trace. Typical trees
    have ~n/leaf_size leaves; 4x slack + a floor covers skewed splits."""
    return int(min(n, max(512, 4 * (n // max(leaf_size, 1)) + 64)))


@functools.partial(
    jax.jit,
    static_argnames=("leaf_size", "max_depth", "angular", "ell_nnz", "head_cap"),
)
def build_tree_trace(X, seed, leaf_size: int, max_depth: int, angular: bool = False,
                     degrees=None, ell_nnz: int | None = None,
                     head_cap: int | None = None, neighbor_idx=None):
    """Like build_tree_order but additionally emits a *compact per-level node
    table* for host-side flattening: for each level, the (sorted) start
    positions of its nodes, their sizes, and the anchor point ids they split
    on. Compacting on device keeps the host transfer at O(depth x nodes)
    instead of O(depth x n) — the host never re-derives the anchor choice.

    Returns ``(order, head_pos, head_size, head_a, head_b, n_heads)``:

    * ``order`` i32[n] — final point permutation (leaf members contiguous)
    * ``head_pos`` i32[depth+1, cap] — node start positions per level
      (ascending, padded with n); level ``depth`` describes the final state
    * ``head_size`` i32[depth+1, cap] — node sizes at those positions
    * ``head_a``/``head_b`` i32[depth, cap] — split anchor point ids
    * ``n_heads`` i32[depth+1] — true node count per level (overflow check)
    """
    n = X.shape[0]
    if head_cap is None:
        head_cap = default_head_cap(n, leaf_size)
    M = int(head_cap)
    norms = _tree_norms(X, angular, ell_nnz)
    order = jnp.arange(n, dtype=jnp.int32)
    start = jnp.zeros(n, jnp.int32)
    size = jnp.full(n, n, jnp.int32)
    sealed = jnp.zeros(n, bool)
    pos = jnp.arange(n, dtype=jnp.int32)

    def compact(start, size, a_pt, b_pt):
        heads = pos == start
        key = jnp.where(heads, pos, n)
        hp = jnp.sort(key)[:M]
        safe = jnp.minimum(hp, n - 1)
        hsize = jnp.where(hp < n, size[safe], -1)
        ha = jnp.where(hp < n, a_pt[safe], -1) if a_pt is not None else None
        hb = jnp.where(hp < n, b_pt[safe], -1) if b_pt is not None else None
        return hp, hsize, ha, hb, jnp.sum(heads).astype(jnp.int32)

    def step(carry, level):
        order, start, size, sealed = carry
        new, (a_pt, b_pt) = _split_level(
            X, norms, order, start, size, level, seed, leaf_size, angular,
            degrees=degrees, ell_nnz=ell_nnz, sealed=sealed,
            neighbor_idx=neighbor_idx,
        )
        return new, compact(start, size, a_pt, b_pt)

    (order, start, size, _), (hp, hsize, ha, hb, n_heads) = jax.lax.scan(
        step, (order, start, size, sealed), jnp.arange(max_depth)
    )
    fhp, fhsize, _, _, fn_heads = compact(start, size, None, None)
    return (
        order,
        jnp.concatenate([hp, fhp[None]], axis=0),
        jnp.concatenate([hsize, fhsize[None]], axis=0),
        ha,
        hb,
        jnp.concatenate([n_heads, fn_heads[None]], axis=0),
    )


def flatten_search_tree(X, seed, leaf_size: int, max_depth: int | None = None,
                        angular: bool = False, materialize: bool = False,
                        degrees=None, ell_nnz: int | None = None,
                        neighbor_idx=None) -> FlatTree:
    """Build one RP tree on device and flatten it to query-descent arrays
    (the analog of convert_tree_format, reference rp_trees.py:3019; the
    per-node anchors come straight from the device trace — the host never
    re-derives the split choice).

    With ``materialize=True`` the per-node hyperplanes/offsets are stored
    explicitly so query descent does not need the float data (quantized
    indexes)."""
    n = X.shape[0]
    if max_depth is None:
        max_depth = forest_depth(n, leaf_size)
    if materialize and ell_nnz is not None:
        raise ValueError("materialized hyperplanes are not available for ELL data")
    dg = None if degrees is None else jnp.asarray(degrees)
    head_cap = default_head_cap(n, leaf_size)
    for attempt in range(2):
        nb = None if neighbor_idx is None else jnp.asarray(neighbor_idx)
        order, head_pos, head_size, head_a, head_b, n_heads = jax.device_get(
            build_tree_trace(
                jnp.asarray(X), jnp.uint32(seed), leaf_size, max_depth, angular,
                degrees=dg, ell_nnz=ell_nnz, head_cap=head_cap, neighbor_idx=nb,
            )
        )
        if int(n_heads.max()) <= head_cap:
            break
        # pathological node explosion (many tiny leaves): retry uncompacted
        head_cap = n
    hub = degrees is not None

    def lookup(level, s):
        """Compact-table index of the node starting at position s, or -1."""
        hp = head_pos[level]
        j = int(np.searchsorted(hp, s))
        return j if j < len(hp) and hp[j] == s else -1

    a_pt, b_pt, child, leaf_lo, leaf_hi = [], [], [], [], []
    # BFS over (level, start, size) nodes
    from collections import deque

    queue = deque([(0, 0, n)])
    ids = {}

    def node_id(level, s, sz):
        key = (level, s, sz)
        if key not in ids:
            ids[key] = len(a_pt)
            a_pt.append(0)
            b_pt.append(0)
            child.append([0, 0])
            leaf_lo.append(-1)
            leaf_hi.append(-1)
            queue.append(key)
        return ids[key]

    root = node_id(0, 0, n)
    seen = set()
    while queue:
        key = queue.popleft()
        if key in seen:
            continue
        seen.add(key)
        level, s, sz = key
        i = ids[key]
        if sz <= leaf_size or level >= max_depth:
            child[i] = [i, i]  # self-loop: descent can run a fixed depth
            leaf_lo[i] = s
            leaf_hi[i] = s + sz
            continue
        j_next = lookup(level + 1, s)
        n_left = int(head_size[level + 1][j_next]) if j_next >= 0 else 0
        if n_left in (0, sz):
            if hub:
                # scored hub split bailed to leaf (balance < MIN_SPLIT_BALANCE)
                child[i] = [i, i]
                leaf_lo[i] = s
                leaf_hi[i] = s + sz
            else:
                # passthrough (degenerate random kept the node whole)
                ci = node_id(level + 1, s, sz)
                child[i] = [ci, ci]
            continue
        j_here = lookup(level, s)
        a_pt[i] = int(head_a[level][j_here])
        b_pt[i] = int(head_b[level][j_here])
        child[i] = [
            node_id(level + 1, s, n_left),
            node_id(level + 1, s + n_left, sz - n_left),
        ]
    tree_leaf_size = leaf_size
    hyper = offset = None
    if materialize:
        Xh = np.asarray(X, np.float32)
        a = np.asarray(a_pt, np.int64)
        b = np.asarray(b_pt, np.int64)
        xa = Xh[a]
        xb = Xh[b]
        if angular:
            na = np.maximum(np.linalg.norm(xa, axis=1, keepdims=True), 1e-8)
            nb = np.maximum(np.linalg.norm(xb, axis=1, keepdims=True), 1e-8)
            hyper = (xa / na - xb / nb).astype(np.float32)
            offset = np.zeros(len(a), np.float32)
        else:
            hyper = (xa - xb).astype(np.float32)
            offset = np.sum(hyper * (xa + xb) * 0.5, axis=1).astype(np.float32)
    tree = FlatTree(
        np.asarray(a_pt, np.int32),
        np.asarray(b_pt, np.int32),
        np.asarray(child, np.int32),
        np.asarray(leaf_lo, np.int32),
        np.asarray(leaf_hi, np.int32),
        order.astype(np.int32),
        max_depth,
        angular,
        hyper=hyper,
        offset=offset,
    )
    tree.leaf_size_cfg = tree_leaf_size
    return tree


def descend_tree(tree_arrays, X, queries, coins, depth: int, angular: bool = False,
                 ell=None):
    """Vectorised query descent: queries [q, d], coins u32[q] tie-break bits.
    Returns (leaf_lo [q], leaf_hi [q]) slices into tree_order.
    (Replaces search_flat_tree / select_side, reference rp_trees.py:2644-2759.)

    ``ell`` = (query nnz, data nnz) marks packed-ELL sparse operands; margins
    then go through sparse_dot (reference search_sparse_flat_tree :2799).
    """
    a_pt = tree_arrays["a_pt"]
    b_pt = tree_arrays["b_pt"]
    child = tree_arrays["child"]
    q = queries.shape[0]
    node = jnp.zeros(q, jnp.int32)

    norms = None
    if angular and "hyper" not in tree_arrays and X.dtype != jnp.uint8:
        norms = _tree_norms(X, True, None if ell is None else ell[1])

    has_planes = "hyper" in tree_arrays

    def body(level, node):
        if has_planes:
            hyper = tree_arrays["hyper"][node]
            margin = jnp.sum(queries * hyper, axis=-1) - tree_arrays["offset"][node]
        else:
            a = a_pt[node]
            b = b_pt[node]
            # same anchor-score form as the build-side splits, so data points
            # land in the leaves the build placed them in
            margin = _anchor_scores(
                X, norms, queries, a, angular, ell
            ) - _anchor_scores(X, norms, queries, b, angular, ell)
        coin = ((coins >> jnp.uint32(level % 32)) & 1).astype(bool)
        side = jnp.where(margin > 0, True, jnp.where(margin < 0, False, coin))
        return child[node, side.astype(jnp.int32)]

    node = jax.lax.fori_loop(0, depth, body, node)
    return tree_arrays["leaf_lo"][node], tree_arrays["leaf_hi"][node]


def make_forest_leaves(X, n_trees, leaf_size, key, angular=False, max_depth=None):
    """Build the forest and return a list of per-tree padded leaf matrices.

    The device does all the splitting work; the host only slices out leaf
    boundaries (cheap, O(n) per tree).
    """
    import jax.random as jrandom

    n = X.shape[0]
    if max_depth is None:
        max_depth = forest_depth(n, leaf_size)
    seeds = jrandom.randint(key, (n_trees,), 0, np.iinfo(np.int32).max, dtype=jnp.int32)
    seeds = jnp.asarray(seeds, jnp.uint32)
    orders, starts, sizes = build_forest_orders(X, seeds, leaf_size, max_depth, angular)
    orders, starts, sizes = jax.device_get((orders, starts, sizes))
    per_tree = [
        leaf_arrays_from_order(orders[t], starts[t], sizes[t]) for t in range(len(seeds))
    ]
    # pad to a single [n_trees, n_leaves_max, leaf_max] block so downstream
    # jitted leaf-init compiles once for the whole forest
    n_leaves_max = max(la.shape[0] for la in per_tree)
    leaf_max = max(la.shape[1] for la in per_tree)
    forest = np.full((len(per_tree), n_leaves_max, leaf_max), -1, np.int32)
    for t, la in enumerate(per_tree):
        forest[t, : la.shape[0], : la.shape[1]] = la
    return forest


def score_tree(order, start, size, neighbor_indices):
    """Fraction of points whose true neighbors co-occur in their leaf
    (reference: score_tree, rp_trees.py:3093) — a quality measure for
    choosing among candidate search trees."""
    order = np.asarray(order)
    start = np.asarray(start)
    size = np.asarray(size)
    neighbor_indices = np.asarray(neighbor_indices)
    n, k = neighbor_indices.shape
    # leaf id per point = its slice start
    leaf_of = np.empty(n, np.int64)
    leaf_of[order] = start
    # unfilled graph slots are -1; count them as misses, not python-wrapped hits
    valid = neighbor_indices >= 0
    safe = np.clip(neighbor_indices, 0, n - 1)
    hits = valid & (leaf_of[safe] == leaf_of[np.arange(n)][:, None])
    return float(hits.sum() / max(valid.sum(), 1))


def score_linked_tree(tree_arrays, neighbor_indices):
    """score_tree over a flattened search tree (reference rp_trees.py:3114)."""
    order = np.asarray(tree_arrays["tree_order"])
    lo = np.asarray(tree_arrays["leaf_lo"])
    hi = np.asarray(tree_arrays["leaf_hi"])
    n = order.shape[0]
    leaf_of = np.full(n, -1, np.int64)
    for node in np.nonzero(lo >= 0)[0]:
        leaf_of[order[lo[node] : hi[node]]] = node
    neighbor_indices = np.asarray(neighbor_indices)
    valid = neighbor_indices >= 0
    safe = np.clip(neighbor_indices, 0, n - 1)
    hits = valid & (leaf_of[safe] == leaf_of[np.arange(len(neighbor_indices))][:, None])
    return float(hits.sum() / max(valid.sum(), 1))
