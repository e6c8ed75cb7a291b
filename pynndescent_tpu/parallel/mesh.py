"""Multi-device scale-out: shard the point set over a device mesh.

The reference's only parallelism is shared-memory CPU threading with
owner-computes vertex blocks (SURVEY §2.2; reference utils.py:706-731).
The equivalents implemented here map each reference thread pattern onto a
mesh collective:

| reference thread pattern | mapping here |
|---|---|
| owner-computes vertex blocks (utils.py:706-731) | neighbor state sharded along vertices over the ``data`` axis (``sharded_nn_descent``); XLA partitions the row-blocked iteration so each device updates its shard |
| "every thread scans all updates" reverse pass (utils.py:259-306) | the reverse-sampling segmented sort / scatter runs under the SPMD partitioner, which inserts the cross-shard all-to-all |
| per-thread preallocated update buffers (pynndescent_.py:283-294) | fixed-shape per-row candidate pools — no buffers needed |
| joblib tree-per-thread forest build (rp_trees.py:2853) | trees vmapped on device; forest arrays replicated |
| parallel_batch_queries (pynndescent_.py:1791) | query batch sharded over the mesh (``sharded_search``) |
| — (no reference analog: data larger than one machine) | ``shard_data=True``: X row-sharded, candidate point blocks circulate through every shard per join tile as a ppermute ring (``_ring_gather_rows``) |

The mesh follows the algorithm, not a physical topology: on a GPU host the
cards are joined all to all (NVLink), so a 1-D mesh over the cards is the
natural shape, and XLA lowers the collectives to NCCL.

Vertex counts that do not divide the mesh are handled by padding the
*neighbor state* (and, with ``shard_data=True``, X with zero rows): pad rows
merge nothing, bid nothing, take the tail tree positions of the locality
phases (masked in the last slab's sweep), and are sliced off the result.

Given the PRNG key the computation is deterministic per executable; the
sharded SPMD executable may differ from the single-device one by float
reduction order (ulp-level distance differences can flip near-tied k-th
neighbors), so the test tier asserts *statistical equivalence* — matching
neighbor overlap and k-th distances — rather than bit identity.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pynndescent_tpu.ops import nndescent as nnd_ops
from pynndescent_tpu.ops import rp_trees
from pynndescent_tpu.ops.neighbors import (
    NeighborState,
    make_neighbor_state,
    merge_candidates,
    sort_by_distance,
)
from pynndescent_tpu.utils import rng


def make_mesh(n_devices: int | None = None, axis_name: str = "data") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), (axis_name,))


def make_mesh_2d(shape: tuple[int, int], axis_names: tuple[str, str] = ("replica", "data")) -> Mesh:
    """2-D mesh: an outer replica axis times the inner ``data`` axis. The
    build shards vertices over the inner axis and replicates over the outer;
    serving shards queries over the outer axis — the replica axis never
    carries per-iteration build traffic (useful when the outer axis spans
    hosts joined by a slower network than the cards within a host)."""
    devices = np.array(jax.devices()[: shape[0] * shape[1]]).reshape(shape)
    return Mesh(devices, axis_names)


def _data_axis(mesh: Mesh, axis_name: str) -> str:
    if axis_name in mesh.axis_names:
        return axis_name
    return mesh.axis_names[-1]


def sharded_nn_descent(
    X,
    n_neighbors: int,
    key,
    mesh: Mesh,
    *,
    metric="euclidean",
    metric_kwds=None,
    n_iters: int | None = None,
    delta: float = 0.001,
    max_candidates: int | None = None,
    forest=None,
    leaf_cap: int = 64,
    block_rows: int | None = None,
    axis_name: str = "data",
    shard_data: bool = False,
    init_state=None,
    locality=None,
):
    """NN-descent with vertex-sharded state over ``mesh``.

    Returns (indices, distances) like ops.nndescent.nn_descent. Results are
    statistically equivalent to the single-device build for the same key
    (identical sampling; ulp-level float differences may flip near-ties).

    ``shard_data=True`` additionally shards X's rows over the mesh —
    the >per-device-memory regime — and streams candidate point blocks
    around a ppermute ring (see ``_data_sharded_stages``).

    ``init_state`` warm-starts from an existing NeighborState of n rows
    (the mesh analog of nn_descent's init_graph — NNDescent.update() routes
    its re-descent through this, matching the reference's update running
    under the same parallelism as the build, pynndescent_.py:2381-2553).

    ``locality`` is nn_descent's option, run by the same schedule driver
    (``ops.nndescent.run_schedule``): per phase the state and X move into
    one tree's order (row moves between devices, ``_tree_moves``), every
    device sweeps the windows of its own contiguous slab (windows never
    straddle a slab boundary), phase iterations join within the phase's
    tree order, and the state moves back. The one difference from a single
    card: with ``shard_data=True`` the phase iterations sample the whole
    table (the sharded join has no windowed form).
    """
    X = jnp.asarray(X)
    n = X.shape[0]
    k = n_neighbors
    axis = _data_axis(mesh, axis_name)
    n_dev = mesh.shape[axis]
    # pad the neighbor STATE up to mesh divisibility: pad rows start empty,
    # merge nothing (ops mask rows >= n), and are sliced off
    n_pad = -(-n // n_dev) * n_dev
    if n_iters is None:
        n_iters = max(5, int(round(np.log2(max(n, 2)))))
    if max_candidates is None:
        max_candidates = min(60, n_neighbors)
    rows = NamedSharding(mesh, P(axis, None))
    replicated = NamedSharding(mesh, P())
    if init_state is not None:
        pad = n_pad - init_state.idx.shape[0]
        init_state = jax.device_put(NeighborState(
            jnp.pad(init_state.idx, ((0, pad), (0, 0)), constant_values=-1),
            jnp.pad(init_state.dist, ((0, pad), (0, 0)), constant_values=jnp.inf),
            jnp.pad(init_state.flag, ((0, pad), (0, 0))),
        ), rows)
    make = _data_sharded_stages if shard_data else _replicated_stages
    init, stages, X_dev = make(
        X, k, mesh, axis, n_pad=n_pad, metric=metric, metric_kwds=metric_kwds,
        max_candidates=max_candidates, leaf_cap=leaf_cap, block_rows=block_rows,
        stop_count=jnp.float32(delta * k * n),
    )
    state = init(key, init_state, forest)

    loc = nnd_ops._resolve_locality(
        locality, n, forest, n_iters,
        sweep_ok=nnd_ops._sweep_ok(metric, metric_kwds, X),
    )
    orders = None
    if loc is not None:
        # pad ids take the tail tree positions (the last slab's tail)
        orders = jnp.asarray(forest[0], jnp.int32)
        tail = jnp.arange(n, n_pad, dtype=jnp.int32)
        orders = jnp.concatenate(
            [orders, jnp.broadcast_to(tail, (orders.shape[0], n_pad - n))], axis=1
        )
        orders = jax.device_put(orders, replicated)
    state = nnd_ops.run_schedule(
        state, X_dev, key, stages, loc=loc, orders=orders, n_iters=n_iters
    )
    idx, dist = nnd_ops._jit_sort(state.idx, state.dist)
    return idx[:n], dist[:n]


def _tree_moves(mesh, axis, n_dev, s):
    """Row moves of a row-sharded NeighborState between id order and a
    tree's order (``ops.nndescent._state_to_tree_order`` and its inverse),
    as jitted shard_maps. Each device fetches exactly the rows of its own
    slab through the ppermute ring (``_ring_gather_rows``), so no device
    ever holds more than its shard plus one visiting shard. ``order`` is a
    replicated permutation of the padded row count."""
    from jax import shard_map

    spec, rep = P(axis, None), P()

    def inverse(order):
        return (
            jnp.zeros(order.shape[0], jnp.int32)
            .at[order]
            .set(jnp.arange(order.shape[0], dtype=jnp.int32), unique_indices=True)
        )

    def move(st, want, relabel):
        me = jax.lax.axis_index(axis)
        ids = jax.lax.dynamic_slice_in_dim(want, me * s, s)
        got = NeighborState(*_ring_gather_rows(tuple(st), ids, axis, n_dev, s))
        return got._replace(
            idx=jnp.where(got.idx >= 0, relabel[jnp.maximum(got.idx, 0)], -1)
        )

    def shmap(fn):
        return shard_map(fn, mesh=mesh, in_specs=(spec, rep, rep),
                         out_specs=spec, check_vma=False)

    @jax.jit
    def to_tree(state, order):
        # my tree positions hold ids order[pos]; neighbor ids -> positions
        return shmap(move)(state, order, inverse(order))

    @jax.jit
    def from_tree(state_p, order):
        # my ids sit at tree positions inv[id]; positions -> neighbor ids
        return shmap(move)(state_p, inverse(order), order)

    return to_tree, from_tree


def _slab_sweep(mesh, axis, s, n, metric, x_sharded):
    """``DescentStages.sweep`` on a mesh: every device sweeps the windows of
    its own contiguous slab of tree positions. ``x_sharded``: the tree-order
    data is row-sharded like the state; otherwise it is replicated with
    ``n`` rows and each device takes its slab from it."""
    from jax import shard_map

    spec = P(axis, None)

    def slab(st, Xp, *, win, m, offset):
        off = jax.lax.axis_index(axis) * s
        if not x_sharded:
            Xp = jnp.take(Xp, off + jnp.arange(s, dtype=jnp.int32), axis=0,
                          mode="fill", fill_value=0)
        return nnd_ops._jit_window_sweep(
            st, Xp, off, n - off, win=win, m=m, metric=metric, offset=offset
        )

    @functools.partial(jax.jit, static_argnames=("win", "m", "offset"))
    def sweep(state_p, Xp, win, m, offset):
        return shard_map(
            functools.partial(slab, win=win, m=m, offset=offset), mesh=mesh,
            in_specs=(spec, spec if x_sharded else P()), out_specs=spec,
            check_vma=False,
        )(state_p, Xp)

    return sweep


def _replicated_stages(X, k, mesh, axis, *, n_pad, metric, metric_kwds,
                       max_candidates, leaf_cap, block_rows, stop_count):
    """Init and ``DescentStages`` of the default mesh build: X replicated on
    every device, the neighbor state row-sharded; XLA partitions the
    row-blocked join iteration so each device updates its shard."""
    n = X.shape[0]
    n_dev = mesh.shape[axis]
    if block_rows is None:
        block_rows = min(nnd_ops.DEFAULT_BLOCK_ROWS, n_pad)
    row_sharding = NamedSharding(mesh, P(axis, None))
    replicated = NamedSharding(mesh, P())
    X = jax.device_put(X, replicated)
    dist_rowwise = nnd_ops._resolve_rowwise_metric(metric, metric_kwds)

    def constrain(state):
        return jax.tree.map(
            lambda a: jax.lax.with_sharding_constraint(a, row_sharding), state
        )

    @functools.partial(jax.jit, static_argnames=("has_forest",))
    def _init(X, forest, key, init, has_forest):
        state = constrain(make_neighbor_state(n_pad, k) if init is None else init)
        if has_forest:
            orders, starts, sizes = forest

            def tree_body(t, st):
                st = nnd_ops.init_from_tree_order(
                    st, X, orders[t], starts[t], sizes[t],
                    dist_rowwise=dist_rowwise, leaf_cap=leaf_cap,
                )
                return constrain(st)

            state = jax.lax.fori_loop(0, orders.shape[0], tree_body, state)
        return constrain(
            nnd_ops.init_random(
                state, X, rng.derive(key, rng.ROLE_DESCENT_INIT),
                n_extra=k, dist_rowwise=dist_rowwise,
            )
        )

    def init(key, init_state, forest):
        if forest is not None:
            forest = tuple(jax.device_put(jnp.asarray(f), replicated) for f in forest)
        return _init(X, forest, key, init_state, has_forest=forest is not None)

    @functools.partial(jax.jit, static_argnames=("n_iters", "window_rows"))
    def join(state, X_, key, n_iters, window_rows):
        iteration = functools.partial(
            nnd_ops._descent_iteration,
            max_candidates=max_candidates,
            dist_rowwise=dist_rowwise,
            block_rows=min(block_rows, n_pad),
            hop2_new_samples=max_candidates,
            hop2_old_samples=max(1, max_candidates // 2),
            window_rows=window_rows,
        )

        def cond(carry):
            _, it, changes = carry
            return (it < n_iters) & (changes > stop_count)

        def body(carry):
            st, it, _ = carry
            st, ch = iteration(st, X_, rng.derive(key, rng.ROLE_DESCENT_ITER, it))
            return constrain(st), it + 1, ch.astype(jnp.float32)

        state, _, _ = jax.lax.while_loop(
            cond, body, (constrain(state), jnp.int32(0), jnp.float32(np.inf))
        )
        return state

    to_tree_state, from_tree = _tree_moves(mesh, axis, n_dev, n_pad // n_dev)
    stages = nnd_ops.DescentStages(
        # the tree-order data stays replicated with n rows (its pad
        # positions are masked by row count, as in the global join)
        to_tree=lambda st, X_, order: (
            to_tree_state(st, order), nnd_ops._jit_permute_rows(X_, order[:n])
        ),
        sweep=_slab_sweep(mesh, axis, n_pad // n_dev, n, metric, x_sharded=False),
        join=join,
        from_tree=from_tree,
    )
    return init, stages, X


# ---------------------------------------------------------------------------
# Sharded-X build (>per-device-HBM datasets)
# ---------------------------------------------------------------------------


def bucket_by_dest(dest, sort_key, ints, cap, n_dev):
    """Route flat tuples to fixed [n_dev*cap] buckets: per destination keep
    the ``cap`` entries with smallest sort_key (iid-uniform keys = a uniform
    subsample; distance keys = best-first). Overflow and invalid entries
    (dest >= n_dev) route out of bounds and are dropped.

    Returns ``([int payload buckets...], float key bucket)``; empty slots
    hold -1 / inf."""
    E = dest.shape[0]
    ops = (dest, sort_key) + tuple(ints)
    sorted_ops = jax.lax.sort(ops, num_keys=2)
    d_s, k_s = sorted_ops[0], sorted_ops[1]
    ints_s = sorted_ops[2:]
    posn = jnp.arange(E, dtype=jnp.int32)
    is_head = jnp.concatenate([jnp.ones((1,), bool), d_s[1:] != d_s[:-1]])
    gstart = jax.lax.cummax(jnp.where(is_head, posn, -1))
    rank = posn - gstart
    keep = (rank < cap) & (d_s < n_dev)
    slot = jnp.where(keep, d_s * cap + rank, n_dev * cap)  # oob -> drop
    out_i = [
        jnp.full((n_dev * cap,), -1, jnp.int32)
        .at[slot]
        .set(v, mode="drop", unique_indices=True)
        for v in ints_s
    ]
    out_f = (
        jnp.full((n_dev * cap,), jnp.inf, jnp.float32)
        .at[slot]
        .set(k_s, mode="drop", unique_indices=True)
    )
    return out_i, out_f


def group_topc(gkey, n_groups, sort_key, ints, cap):
    """Per group key in [0, n_groups), keep the ``cap`` smallest sort_key
    entries; returns per-group [n_groups, cap] tables (-1 pad) plus the
    kept mask aligned with the sort order inputs."""
    E = gkey.shape[0]
    ops = (gkey, sort_key) + tuple(ints)
    sorted_ops = jax.lax.sort(ops, num_keys=2)
    g_s = sorted_ops[0]
    ints_s = sorted_ops[2:]
    posn = jnp.arange(E, dtype=jnp.int32)
    is_head = jnp.concatenate([jnp.ones((1,), bool), g_s[1:] != g_s[:-1]])
    gstart = jax.lax.cummax(jnp.where(is_head, posn, -1))
    rank = posn - gstart
    keep = (rank < cap) & (g_s >= 0) & (g_s < n_groups)
    slot = jnp.where(keep, g_s * cap + rank, n_groups * cap)
    tables = [
        jnp.full((n_groups * cap,), -1, jnp.int32)
        .at[slot]
        .set(v, mode="drop", unique_indices=True)
        .reshape(n_groups, cap)
        for v in ints_s
    ]
    return tables, (g_s, rank, keep, ints_s)


def _ring_gather_rows(shards, ids, axis_name, n_dev, shard_size):
    """Gather global rows ``ids`` from row-sharded arrays (one array or a
    tuple of them sharing the row axis) by circulating the shards around
    the ring (ppermute): per step, each device picks out the ids the
    visiting shard owns. Communication is the shards themselves —
    independent of how many rows are requested — and only one visiting
    shard is materialised at a time (the >device-memory property)."""
    me = jax.lax.axis_index(axis_name)

    def pick(out, held, src):
        local = ids - src * shard_size
        hit = (local >= 0) & (local < shard_size)
        li = jnp.clip(local, 0, shard_size - 1)
        return jax.tree.map(
            lambda o, a: jnp.where(
                hit.reshape(hit.shape + (1,) * (a.ndim - 1)), a[li], o
            ),
            out, held,
        )

    def step(t, carry):
        out, held = carry
        held = jax.lax.ppermute(
            held, axis_name, [(i, (i - 1) % n_dev) for i in range(n_dev)]
        )
        return pick(out, held, (me + t) % n_dev), held

    out = jax.tree.map(
        lambda a: jnp.zeros(ids.shape + a.shape[1:], a.dtype), shards
    )
    out = pick(out, shards, me)
    out, _ = jax.lax.fori_loop(1, n_dev, step, (out, shards))
    return out


def _data_sharded_stages(X, k, mesh, axis, *, n_pad, metric, metric_kwds,
                         max_candidates, leaf_cap, block_rows, stop_count,
                         exchange_slack: int = 32):
    """Init and ``DescentStages`` with BOTH X and the neighbor state
    row-sharded over the mesh (shard_map + explicit collectives) — the
    >per-device-memory regime (``shard_data=True``).

    This is the mesh mapping of the reference's owner-computes
    update pattern (SURVEY §5; reference utils.py:536-733): each device owns
    a vertex shard and its state rows, performs the local join over its own
    rows' candidates, and routes fixed-width **(target, source, distance)
    update tuples to the target's owner shard with ``lax.all_to_all``**.
    Per-iteration cross-device volume per device:

      * candidate point rows:         the X shards, once around the ring
                                      per gathered super-block of rows
      * reverse-candidate edges out:  O(n·k / n_dev) tuples
      * reverse winners returned:     O(n·c / n_dev) tuples
      * join update tuples:           O(exchange_slack · n·k / n_dev) tuples
      * heap-root thresholds:         O(n) scalars (all_gather of [s] f32)

    — no replicated O(n·k) state and no O(n·k·n_dev) all-gather. Peak
    memory is ``n·d/n_dev + O(n·k/n_dev)`` per device. Each pair-join block
    keeps, per destination, its best ``cap_b`` update tuples in its own
    slot of a fixed buffer (work linear in the shard); overflow drops the
    *worst* entries (highest random priority for samples, largest distance
    for updates), so convergence degrades gracefully instead of erroring;
    ``exchange_slack`` scales the update budget. The tree-order moves of the
    locality phases ring the X shards once per phase (``_tree_moves``).
    """
    from jax import shard_map

    n, d = X.shape
    n_dev = mesh.shape[axis]
    axis_name = axis
    # pad X with zero rows; pad rows are masked everywhere (they emit
    # nothing, receive nothing, and are sliced off the result)
    X = jnp.concatenate([X, jnp.zeros((n_pad - n, d), X.dtype)], axis=0)
    s = n_pad // n_dev  # shard size (state rows and X rows per device)
    c = max_candidates
    if block_rows is None:
        block_rows = min(nnd_ops.DEFAULT_BLOCK_ROWS, s)
    b = max(1, min(block_rows, s))
    # pair-join block: the [bj, 2c, 2c, d] broadcast must stay bounded
    bj = max(1, min(b, (8 << 20) // max(16 * c * c * d, 1)))
    # candidate rows are ringed in once per super-block of G pair-join blocks
    G = max(1, b // bj)
    sb = G * bj
    n_super = -(-s // sb)

    # fixed all-to-all bucket widths (per destination device)
    cap_r = max(8, -(-2 * s * k // n_dev))  # reverse edges out
    cap_w = max(8, -(-2 * s * c // n_dev))  # reverse winners returned
    cap_b = max(16, -(-exchange_slack * bj * k // n_dev))  # update tuples per block

    dist_rowwise = nnd_ops._resolve_rowwise_metric(metric, metric_kwds)
    n_real = n

    spec_x = P(axis_name, None)
    spec_rep = P()

    def ring(X_shard, ids):
        return _ring_gather_rows(X_shard, ids, axis_name, n_dev, s)

    def a2a_i(x):
        return jax.lax.all_to_all(x, axis_name, 0, 0, tiled=True)

    def _bucket_by_dest(dest, sort_key, ints, cap):
        return bucket_by_dest(dest, sort_key, ints, cap, n_dev)

    def _group_topc(gkey, n_groups, sort_key, ints, cap):
        return group_topc(gkey, n_groups, sort_key, ints, cap)

    def _local_merge_block(st, rows_local, cand, dmat):
        row_state = NeighborState(
            st.idx[rows_local], st.dist[rows_local], st.flag[rows_local]
        )
        merged, n_changed = merge_candidates(row_state, cand, dmat)
        return (
            NeighborState(
                st.idx.at[rows_local].set(merged.idx, unique_indices=True),
                st.dist.at[rows_local].set(merged.dist, unique_indices=True),
                st.flag.at[rows_local].set(merged.flag, unique_indices=True),
            ),
            n_changed,
        )

    def tree_init_shard(X_shard, state, order, start, size, inv):
        """Leaf-window init for MY OWNED POINTS: each device looks up its own
        points' tree positions (``inv`` = inverse permutation, replicated
        O(n) ints), gathers their leaf windows, and merges locally — zero
        exchange; the only cross-device traffic is the X ring."""
        me = jax.lax.axis_index(axis_name)
        offsets = jnp.arange(leaf_cap, dtype=jnp.int32)
        n_blocks = -(-s // b)

        def body(blk, st):
            r0 = jnp.minimum(blk * b, s - b)
            rows_local = r0 + jnp.arange(b, dtype=jnp.int32)
            pts = me * s + rows_local
            pos = inv[jnp.minimum(pts, n_real - 1)]
            lstart = start[pos]
            lsize = size[pos]
            win = lstart[:, None] + offsets[None, :]
            cand = order[jnp.minimum(win, order.shape[0] - 1)]
            cand = jnp.where(
                offsets[None, :] < jnp.minimum(lsize, leaf_cap)[:, None], cand, -1
            )
            cand = jnp.where((pts[:, None] < n_real) & (cand < n_real), cand, -1)
            Q = X_shard[rows_local]
            C = ring(X_shard, jnp.maximum(cand, 0))
            dmat = dist_rowwise(Q, C)
            dmat = jnp.where(cand < 0, jnp.inf, dmat)
            st, _ = _local_merge_block(st, rows_local, cand, dmat)
            return st

        return jax.lax.fori_loop(0, n_blocks, body, state)

    def random_init_shard(X_shard, state, key):
        me = jax.lax.axis_index(axis_name)
        n_blocks = -(-s // b)

        def body(blk, st):
            r0 = jnp.minimum(blk * b, s - b)
            rows_local = r0 + jnp.arange(b, dtype=jnp.int32)
            pts = me * s + rows_local
            cand = jax.random.randint(
                jax.random.fold_in(key, blk * n_dev + me),
                (b, k), 0, n_real, dtype=jnp.int32,
            )
            self_ids = pts[:, None]
            cand = jnp.concatenate([self_ids, cand], axis=-1)
            cand = jnp.where(pts[:, None] < n_real, cand, -1)
            Q = X_shard[rows_local]
            C = ring(X_shard, jnp.maximum(cand, 0))
            dmat = dist_rowwise(Q, C)
            dmat = jnp.where(cand == self_ids, 0.0, dmat)
            dmat = jnp.where(cand < 0, jnp.inf, dmat)
            st, _ = _local_merge_block(st, rows_local, cand, dmat)
            return st

        return jax.lax.fori_loop(0, n_blocks, body, state)

    def sample_candidates_shard(state, key):
        """Sharded candidate builder (reference new_build_candidates,
        utils.py:221-320): forward sampling is local; reverse sampling
        routes each directed edge to its target's owner as a (target, src,
        slot) tuple keyed by an iid-uniform priority, and the winners'
        (src, slot) return to the source owner to clear new-flags."""
        me = jax.lax.axis_index(axis_name)
        k_f, k_r = jax.random.split(key)
        valid = (state.idx >= 0) & (state.idx < n_real)
        pri = jax.random.uniform(jax.random.fold_in(k_f, me), (s, k))
        new_mask = valid & state.flag
        old_mask = valid & ~state.flag
        fwd_new, pos_new, sel_new = nnd_ops._forward_sample(state.idx, pri, new_mask, c)
        fwd_old, _, _ = nnd_ops._forward_sample(state.idx, pri, old_mask, c)

        # ---- reverse edges out (all_to_all #1) ----
        rpri = jax.random.uniform(jax.random.fold_in(k_r, me), (s, k))
        tgt = state.idx.reshape(-1)
        src = jnp.broadcast_to(
            (me * s + jnp.arange(s, dtype=jnp.int32))[:, None], (s, k)
        ).reshape(-1)
        slot = jnp.broadcast_to(
            jnp.arange(k, dtype=jnp.int32)[None, :], (s, k)
        ).reshape(-1)
        isnew = (new_mask).reshape(-1)
        ok = valid.reshape(-1)
        dest = jnp.where(ok, tgt // s, n_dev)
        (bi, bf) = _bucket_by_dest(
            dest, jnp.where(ok, rpri.reshape(-1), jnp.inf),
            (tgt, src, slot, isnew.astype(jnp.int32)), cap_r,
        )
        rx = [a2a_i(v) for v in bi]
        rx_pri = jax.lax.all_to_all(bf, axis_name, 0, 0, tiled=True)
        rtgt, rsrc, rslot, risnew = rx
        rok = rtgt >= 0
        ltgt = rtgt - me * s
        gkey = jnp.where(rok, ltgt * 2 + risnew, -1)
        tables, (g_s, rank, keep, ints_s) = _group_topc(
            gkey, 2 * s, jnp.where(rok, rx_pri, jnp.inf), (rsrc, rslot), c
        )
        src_tab, slot_tab = tables
        src_tab = src_tab.reshape(s, 2, c)
        rev_old = src_tab[:, 0]  # gkey even = old edges
        rev_new = src_tab[:, 1]

        # ---- winners return to source owners (all_to_all #2) ----
        src_s, slot_s = ints_s
        win_new = keep & ((g_s & 1) == 1)
        wdest = jnp.where(win_new, src_s // s, n_dev)
        (wbi, _) = _bucket_by_dest(
            wdest, jnp.where(win_new, 0.0, jnp.inf), (src_s, slot_s), cap_w
        )
        wsrc, wslot = (a2a_i(v) for v in wbi)
        wok = wsrc >= 0
        lsrc = jnp.where(wok, wsrc - me * s, s)
        flag = state.flag
        # forward-sampled flags clear locally (reference clears on sample)
        rows = jnp.broadcast_to(
            jnp.arange(s, dtype=jnp.int32)[:, None], pos_new.shape
        )
        flag = flag.at[rows, pos_new].set(
            jnp.where(sel_new, False, flag[rows, pos_new]), unique_indices=True
        )
        # reverse winners: each (src, slot) edge wins at most once globally
        flag = flag.at[lsrc, jnp.maximum(wslot, 0)].set(False, mode="drop")
        cand_new = jnp.concatenate([fwd_new, rev_new], axis=-1)  # [s, 2c]
        cand_old = jnp.concatenate([fwd_old, rev_old], axis=-1)
        return cand_new, cand_old, flag

    def iter_shard(X_shard, state, key):
        """One owner-computes iteration: local join over my rows' candidate
        pairs, emission of (target, other, d) tuples to owner shards
        (all_to_all #3), local application."""
        me = jax.lax.axis_index(axis_name)
        cand_new, cand_old, flag = sample_candidates_shard(state, key)
        state = state._replace(flag=flag)

        # current k-th distances of ALL rows, replicated (O(n) f32): the
        # emission threshold (reference utils.py:607-656 thresholds by the
        # endpoint heap roots before emitting)
        roots = jax.lax.all_gather(state.dist[:, -1], axis_name, tiled=True)

        w = 2 * c

        def pair_dists(A, B):
            bb, ma, dd = A.shape
            mb = B.shape[1]
            Q = A.reshape(bb * ma, dd)
            C = jnp.broadcast_to(B[:, None], (bb, ma, mb, dd)).reshape(bb * ma, mb, dd)
            return dist_rowwise(Q, C).reshape(bb, ma, mb)

        def flat(P_, Q_, D, m):
            p = jnp.broadcast_to(P_[:, :, None], D.shape).reshape(-1)
            q = jnp.broadcast_to(Q_[:, None, :], D.shape).reshape(-1)
            dv = jnp.where(m, D, jnp.inf).reshape(-1)
            return p, q, dv

        def super_block(i, carry):
            r0 = jnp.minimum(i * sb, s - sb)
            cn_sb = jax.lax.dynamic_slice_in_dim(cand_new, r0, sb)
            co_sb = jax.lax.dynamic_slice_in_dim(cand_old, r0, sb)
            Xn_sb = ring(X_shard, jnp.maximum(cn_sb, 0))
            Xo_sb = ring(X_shard, jnp.maximum(co_sb, 0))

            def emit_block(j, carry):
                st, local_changes, buf_t, buf_o, buf_d = carry
                j0 = j * bj
                rows_local = r0 + j0 + jnp.arange(bj, dtype=jnp.int32)
                cn = jax.lax.dynamic_slice_in_dim(cn_sb, j0, bj)  # [bj, w] global ids
                co = jax.lax.dynamic_slice_in_dim(co_sb, j0, bj)
                Xn = jax.lax.dynamic_slice_in_dim(Xn_sb, j0, bj)
                Xo = jax.lax.dynamic_slice_in_dim(Xo_sb, j0, bj)
                # 1-hop self-merge: the candidate rows are already on hand,
                # so each row folds its own sampled candidates in locally
                # (zero extra exchange; pure quality win over emit-only)
                own = jnp.concatenate([cn, co], axis=-1)
                own_d = dist_rowwise(
                    X_shard[rows_local], jnp.concatenate([Xn, Xo], axis=1)
                )
                own_d = jnp.where(own >= 0, own_d, jnp.inf)
                own = jnp.where(
                    own == (me * s + rows_local)[:, None], -1, own
                )  # no self edges
                st, ch1 = _local_merge_block(st, rows_local, own, own_d)
                Dnn = pair_dists(Xn, Xn)  # [bj, w, w]
                Dno = pair_dists(Xn, Xo)
                iu = jnp.triu(jnp.ones((w, w), bool), 1)[None]
                vn = cn >= 0
                vo = co >= 0
                m_nn = iu & vn[:, :, None] & vn[:, None, :]
                m_no = vn[:, :, None] & vo[:, None, :]
                p1, q1, d1 = flat(cn, cn, Dnn, m_nn)
                p2, q2, d2 = flat(cn, co, Dno, m_no)
                # both directions: the tuple targeted at t is kept iff it
                # beats t's current k-th distance (stale by <= 1 iteration)
                t_all = jnp.concatenate([p1, q1, p2, q2])
                o_all = jnp.concatenate([q1, p1, q2, p2])
                d_all = jnp.concatenate([d1, d1, d2, d2])
                ok = (
                    jnp.isfinite(d_all)
                    & (t_all >= 0)
                    & (o_all >= 0)
                    & (t_all != o_all)
                    & (d_all < roots[jnp.maximum(t_all, 0)])
                )
                # this block's best cap_b tuples per destination go to its
                # own slot of the exchange buffer
                (nb, nf) = _bucket_by_dest(
                    jnp.where(ok, t_all // s, n_dev), jnp.where(ok, d_all, jnp.inf),
                    (t_all, o_all), cap_b,
                )
                slot = (0, i * G + j, 0)
                buf_t = jax.lax.dynamic_update_slice(
                    buf_t, nb[0].reshape(n_dev, 1, cap_b), slot)
                buf_o = jax.lax.dynamic_update_slice(
                    buf_o, nb[1].reshape(n_dev, 1, cap_b), slot)
                buf_d = jax.lax.dynamic_update_slice(
                    buf_d, nf.reshape(n_dev, 1, cap_b), slot)
                return (st, local_changes + ch1, buf_t, buf_o, buf_d)

            return jax.lax.fori_loop(0, G, emit_block, carry)

        slots = (n_dev, n_super * G, cap_b)
        buf_t = jnp.full(slots, -1, jnp.int32)
        buf_o = jnp.full(slots, -1, jnp.int32)
        buf_d = jnp.full(slots, jnp.inf, jnp.float32)
        state, local_changes, buf_t, buf_o, buf_d = jax.lax.fori_loop(
            0, n_super, super_block,
            (state, jnp.int32(0), buf_t, buf_o, buf_d),
        )
        buf_t, buf_o, buf_d = (a.reshape(-1) for a in (buf_t, buf_o, buf_d))

        # ---- update exchange (all_to_all #3) + local apply ----
        rx_t = a2a_i(buf_t)
        rx_o = a2a_i(buf_o)
        rx_d = jax.lax.all_to_all(buf_d, axis_name, 0, 0, tiled=True)
        rok = rx_t >= 0
        lt = jnp.where(rok, rx_t - me * s, -1)
        m_apply = min(4 * k, 96)
        tables, _ = _group_topc(
            lt, s, jnp.where(rok, rx_d, jnp.inf), (rx_o, rx_d.view(jnp.int32)), m_apply
        )
        o_tab, dbits_tab = tables
        d_tab = jnp.where(o_tab >= 0, dbits_tab.view(jnp.float32), jnp.inf)
        merged, n_changed = merge_candidates(
            NeighborState(state.idx, state.dist, state.flag), o_tab, d_tab
        )
        changes = jax.lax.psum(n_changed + local_changes, axis_name)
        return merged, changes

    def program_init(X_shard, key, init, forest_args):
        state = NeighborState(*init) if init else make_neighbor_state(s, k)
        if forest_args is not None:
            orders, starts, sizes, invs = forest_args

            def tree_body(t, st):
                return tree_init_shard(
                    X_shard, st, orders[t], starts[t], sizes[t], invs[t]
                )

            state = jax.lax.fori_loop(0, orders.shape[0], tree_body, state)
        return random_init_shard(
            X_shard, state, rng.derive(key, rng.ROLE_DESCENT_INIT)
        )

    def init(key, init_state, forest):
        forest_args = None
        if forest is not None:
            orders, starts, sizes = (jnp.asarray(f) for f in forest)
            npts = orders.shape[1]
            trow = jnp.arange(orders.shape[0], dtype=jnp.int32)[:, None]
            invs = (
                jnp.zeros(orders.shape, jnp.int32)
                .at[trow, orders]
                .set(
                    jnp.broadcast_to(
                        jnp.arange(npts, dtype=jnp.int32)[None], orders.shape
                    ),
                    unique_indices=True,
                )
            )
            forest_args = (orders, starts, sizes, invs)
        init = () if init_state is None else tuple(init_state)
        fn = shard_map(
            functools.partial(program_init, forest_args=forest_args),
            mesh=mesh,
            in_specs=(spec_x, spec_rep, (spec_x,) * len(init)),
            out_specs=spec_x,
            check_vma=False,
        )
        return jax.jit(fn)(X, key, init)

    def loop(X_shard, state, key, *, n_iters):
        def cond(carry):
            _, it, changes = carry
            return (it < n_iters) & (changes > stop_count)

        def body(carry):
            st, it, _ = carry
            st, ch = iter_shard(X_shard, st, rng.derive(key, rng.ROLE_DESCENT_ITER, it))
            return st, it + 1, ch.astype(jnp.float32)

        state, _, _ = jax.lax.while_loop(
            cond, body, (state, jnp.int32(0), jnp.float32(np.inf))
        )
        return state

    @functools.partial(jax.jit, static_argnames=("n_iters", "window_rows"))
    def join(state, X_, key, n_iters, window_rows):
        # the sharded join samples the whole table: window_rows has no
        # sharded form, so phase iterations run unwindowed in tree order
        del window_rows
        return shard_map(
            functools.partial(loop, n_iters=n_iters), mesh=mesh,
            in_specs=(spec_x, spec_x, spec_rep), out_specs=spec_x,
            check_vma=False,
        )(X_, state, key)

    to_tree_state, from_tree = _tree_moves(mesh, axis, n_dev, s)

    @jax.jit
    def permute_x(X_, order):
        def fetch(X_shard, order):
            me = jax.lax.axis_index(axis)
            ids = jax.lax.dynamic_slice_in_dim(order, me * s, s)
            return ring(X_shard, ids)

        return shard_map(fetch, mesh=mesh, in_specs=(spec_x, spec_rep),
                         out_specs=spec_x, check_vma=False)(X_, order)

    stages = nnd_ops.DescentStages(
        to_tree=lambda st, X_, order: (to_tree_state(st, order), permute_x(X_, order)),
        sweep=_slab_sweep(mesh, axis, s, n, metric, x_sharded=True),
        join=join,
        from_tree=from_tree,
    )
    X = jax.device_put(X, NamedSharding(mesh, spec_x))
    return init, stages, X


def sharded_search(queries, X, adj, tree, key, mesh, *, k, epsilon=0.1,
                   min_distance=0.0, beam_width=None, dist_rowwise=None,
                   axis_name: str = "data", per_device_batch: int = 8192,
                   tree_queries=None, ell=None, expansions_per_step: int = 2):
    """Query search with the query batch sharded over the mesh (data-parallel
    serving: each device runs the beam loop on its query shard against the
    replicated index). On a 2-D mesh the queries shard over the *outer*
    (replica) axis, so serving traffic never crosses the build axis."""
    from pynndescent_tpu.models import search as search_ops

    if len(mesh.axis_names) > 1:
        qaxis = mesh.axis_names[0]
    else:
        qaxis = _data_axis(mesh, axis_name)
    replicated = NamedSharding(mesh, P())
    qshard = NamedSharding(mesh, P(qaxis, None))
    X = jax.device_put(jnp.asarray(X), replicated)
    adj = jax.device_put(jnp.asarray(adj), replicated)
    if tree is not None:
        tree = {
            kk: (jax.device_put(jnp.asarray(vv), replicated) if kk not in ("depth", "angular", "leaf_size") else vv)
            for kk, vv in tree.items()
        }

    # Blocked batching over query chunks of (n_dev * per_device_batch) rows:
    # one chunk at a time is sharded onto the mesh, so per-device beam state
    # stays bounded no matter how large the serving batch is. Tail chunks pad
    # per-device rows up to a power-of-two bucket (compile reuse, same scheme
    # as models.search). Padding rows are real rows replayed (row 0) — their
    # results are sliced off, they only keep shard shapes equal.
    queries = np.asarray(queries)
    tree_q = None if tree_queries is None else np.asarray(tree_queries)
    nq = queries.shape[0]
    n_dev = int(mesh.shape[qaxis])
    chunk = n_dev * int(per_device_batch)
    out_idx, out_dist = [], []

    def pad_chunk(blk, rows, tgt):
        return np.concatenate(
            [blk, np.broadcast_to(blk[:1], (tgt - rows,) + blk.shape[1:])], 0
        )

    for s in range(0, nq, chunk):
        blk = queries[s : s + chunk]
        tq_blk = None if tree_q is None else tree_q[s : s + chunk]
        rows = blk.shape[0]
        if rows < chunk:
            per = max(256, 1 << (-(-rows // n_dev) - 1).bit_length())
            tgt = min(chunk, n_dev * per)
            blk = pad_chunk(blk, rows, tgt)
            if tq_blk is not None:
                tq_blk = pad_chunk(tq_blk, rows, tgt)
        blk = jax.device_put(jnp.asarray(blk), qshard)
        if tq_blk is not None:
            tq_blk = jax.device_put(jnp.asarray(tq_blk), qshard)
        bi, bd = search_ops.search(
            blk, X, adj, tree, jax.random.fold_in(key, s),
            k=k, epsilon=epsilon, min_distance=min_distance,
            beam_width=beam_width, dist_rowwise=dist_rowwise,
            batch_size=blk.shape[0], tree_queries=tq_blk, ell=ell,
            expansions_per_step=expansions_per_step,
        )
        out_idx.append(np.asarray(bi)[:rows])
        out_dist.append(np.asarray(bd)[:rows])
    if len(out_idx) == 1:
        return out_idx[0], out_dist[0]
    return np.concatenate(out_idx, 0), np.concatenate(out_dist, 0)
