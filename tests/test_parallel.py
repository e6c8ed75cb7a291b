"""Multi-device tests on the virtual 8-device CPU mesh: sharded build runs,
matches the single-device result bit-for-bit (shard invariance), and the
graft entry points work."""

import numpy as np
import pytest

import jax


def test_mesh_has_8_devices():
    assert len(jax.devices()) == 8


def test_sharded_build_shard_equivalence(nn_data):
    """The sharded build must be statistically equivalent to the
    single-device build. (Bit-identity is NOT guaranteed: the SPMD
    executable's float reduction order differs by ulps, and near-tied
    distances legitimately flip marginal k-th neighbors.)"""
    from pynndescent_tpu.ops import nndescent as nnd_ops
    from pynndescent_tpu.parallel import make_mesh, sharded_nn_descent
    from pynndescent_tpu.utils import rng

    data = nn_data[:1000]  # divisible by 8
    k = 8
    key = rng.state_from_seed(5)
    mesh = make_mesh(8)
    idx_s, dist_s = sharded_nn_descent(data, k, key, mesh, n_iters=5, block_rows=250)
    idx_1, dist_1 = nnd_ops.nn_descent(
        data, k, key, n_iters=5, block_rows=250,
        metric="euclidean",
    )
    idx_s, idx_1 = np.asarray(idx_s), np.asarray(idx_1)
    overlap = np.mean(
        [len(np.intersect1d(idx_s[i], idx_1[i])) / k for i in range(len(data))]
    )
    assert overlap >= 0.95, f"sharded/single neighbor overlap {overlap}"
    # k-th neighbor distances agree closely on average (individual rows may
    # differ where the two executables discovered different marginal
    # neighbors of nearly equal distance)
    a = np.sort(np.asarray(dist_s), 1)[:, k - 1]
    b = np.sort(np.asarray(dist_1), 1)[:, k - 1]
    rel = np.abs(a - b) / np.maximum(b, 1e-12)
    assert np.mean(rel) < 0.02, f"mean kth-distance deviation {np.mean(rel)}"


def test_sharded_build_recall(nn_data):
    from sklearn.neighbors import NearestNeighbors

    from pynndescent_tpu.ops import rp_trees
    from pynndescent_tpu.parallel import make_mesh, sharded_nn_descent
    from pynndescent_tpu.utils import rng

    data = nn_data[:1000]
    k = 10
    key = rng.state_from_seed(42)
    mesh = make_mesh(8)
    forest = rp_trees.build_forest_orders(
        data, np.arange(4, dtype=np.uint32), 60, rp_trees.forest_depth(1000, 60)
    )
    idx, _ = sharded_nn_descent(data, k, key, mesh, forest=forest, block_rows=250)
    idx = np.asarray(idx)
    nn = NearestNeighbors(n_neighbors=k).fit(data)
    true_idx = nn.kneighbors(data, k, return_distance=False)
    recall = np.mean(
        [len(np.intersect1d(idx[i, :k], true_idx[i])) / k for i in range(1000)]
    )
    assert recall >= 0.98, f"sharded build recall {recall}"


def test_sharded_build_non_divisible_n(nn_data):
    """n that does not divide the mesh is handled by padding the neighbor
    state (never the data); pad rows must not leak into results."""
    from sklearn.neighbors import NearestNeighbors

    from pynndescent_tpu.parallel import make_mesh, sharded_nn_descent
    from pynndescent_tpu.utils import rng

    data = nn_data[:997]  # prime-ish: 997 % 8 != 0
    k = 8
    mesh = make_mesh(8)
    idx, dist = sharded_nn_descent(
        data, k, rng.state_from_seed(3), mesh, n_iters=6, block_rows=256
    )
    idx = np.asarray(idx)
    assert idx.shape == (997, k)
    assert idx.max() < 997  # no padding ids leaked
    nn = NearestNeighbors(n_neighbors=k).fit(data)
    true_idx = nn.kneighbors(data, k, return_distance=False)
    recall = np.mean(
        [len(np.intersect1d(idx[i], true_idx[i])) / k for i in range(997)]
    )
    assert recall >= 0.9, f"padded sharded build recall {recall}"


@pytest.mark.slow
def test_sharded_data_build(nn_data):
    """X row-sharded over the mesh (the >per-device-memory mode): candidate
    rows circulate on the ppermute ring; results match the exact oracle."""
    from sklearn.neighbors import NearestNeighbors

    from pynndescent_tpu.parallel import make_mesh, sharded_nn_descent
    from pynndescent_tpu.utils import rng

    data = nn_data[:600]
    k = 8
    mesh = make_mesh(8)
    idx, dist = sharded_nn_descent(
        data, k, rng.state_from_seed(4), mesh, n_iters=6, block_rows=64,
        shard_data=True,
    )
    idx = np.asarray(idx)
    assert idx.shape == (600, k)
    nn = NearestNeighbors(n_neighbors=k).fit(data)
    true_idx = nn.kneighbors(data, k, return_distance=False)
    recall = np.mean(
        [len(np.intersect1d(idx[i], true_idx[i])) / k for i in range(600)]
    )
    assert recall >= 0.9, f"sharded-X build recall {recall}"


@pytest.mark.slow
def test_2d_mesh_build_and_search(nn_data):
    """2-D (replica x data) mesh: vertices shard over the inner axis,
    queries over the outer axis."""
    from sklearn.neighbors import NearestNeighbors

    from pynndescent_tpu.ops import nndescent as nnd_ops
    from pynndescent_tpu.parallel import make_mesh_2d, sharded_nn_descent, sharded_search
    from pynndescent_tpu.utils import rng

    data = nn_data[:800]
    k = 8
    mesh = make_mesh_2d((2, 4))
    key = rng.state_from_seed(6)
    idx, dist = sharded_nn_descent(data, k, key, mesh, n_iters=6, block_rows=200)
    idx = np.asarray(idx)
    assert idx.shape == (800, k)

    adj = idx
    qidx, qdist = sharded_search(
        data[:64], data, adj, None, rng.derive(key, 9), mesh, k=k,
        dist_rowwise=nnd_ops._resolve_rowwise_metric("sqeuclidean", None),
    )
    assert np.asarray(qidx).shape == (64, k)
    nn = NearestNeighbors(n_neighbors=k).fit(data)
    true_idx = nn.kneighbors(data, k, return_distance=False)
    recall = np.mean(
        [len(np.intersect1d(idx[i], true_idx[i])) / k for i in range(800)]
    )
    assert recall >= 0.9, f"2-D mesh build recall {recall}"


def test_sharded_search_recall_matches_single(nn_data):
    """sharded_search must deliver the same recall as the single-device
    search on the same index and key — not just matching shapes."""
    from sklearn.neighbors import NearestNeighbors

    from pynndescent_tpu.models import search as search_ops
    from pynndescent_tpu.ops import nndescent as nnd_ops
    from pynndescent_tpu.parallel import make_mesh, sharded_search
    from pynndescent_tpu.utils import rng

    data = nn_data[:800]
    k = 8
    key = rng.state_from_seed(2)
    idx, _ = nnd_ops.nn_descent(data, k, key, n_iters=5, metric="sqeuclidean")
    adj = np.asarray(idx)
    queries = nn_data[800:864]
    dr = nnd_ops._resolve_rowwise_metric("sqeuclidean", None)
    mesh = make_mesh(8)
    qkey = rng.derive(key, 9)
    qidx, _ = sharded_search(
        queries, data, adj, None, qkey, mesh, k=k, epsilon=0.2, dist_rowwise=dr
    )
    import jax.numpy as jnp

    sidx, _ = search_ops.search(
        jnp.asarray(queries), jnp.asarray(data), jnp.asarray(adj), None, qkey,
        k=k, epsilon=0.2, min_distance=0.0, dist_rowwise=dr,
        batch_size=len(queries),
    )
    qidx, sidx = np.asarray(qidx), np.asarray(sidx)
    nn = NearestNeighbors(n_neighbors=k).fit(data)
    true_idx = nn.kneighbors(queries, k, return_distance=False)
    rec_sharded = np.mean(
        [len(np.intersect1d(qidx[i], true_idx[i])) / k for i in range(len(queries))]
    )
    rec_single = np.mean(
        [len(np.intersect1d(sidx[i], true_idx[i])) / k for i in range(len(queries))]
    )
    assert rec_sharded >= 0.9, f"sharded search recall {rec_sharded}"
    assert rec_sharded >= rec_single - 0.02, (rec_sharded, rec_single)

    # blocked batching: a tiny per-device budget forces multiple sharded
    # chunks plus a padded tail; results must keep the same recall
    cidx, _ = sharded_search(
        queries, data, adj, None, qkey, mesh, k=k, epsilon=0.2,
        dist_rowwise=dr, per_device_batch=4,
    )
    cidx = np.asarray(cidx)
    assert cidx.shape == (len(queries), k)
    rec_chunked = np.mean(
        [len(np.intersect1d(cidx[i], true_idx[i])) / k for i in range(len(queries))]
    )
    assert rec_chunked >= 0.9, f"chunked sharded search recall {rec_chunked}"


def test_graft_entry_compiles():
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    fn, args = ge.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out[0].idx)


def test_graft_dryrun_multichip():
    import sys

    sys.path.insert(0, "/root/repo")
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_bucket_by_dest_exact_small_keys():
    """bucket_by_dest keeps, per destination, exactly the cap smallest-key
    entries, drops overflow/invalid, and never duplicates a slot."""
    import jax.numpy as jnp

    from pynndescent_tpu.parallel.mesh import bucket_by_dest

    rs = np.random.RandomState(0)
    E, n_dev, cap = 500, 4, 8
    dest = rs.randint(0, n_dev + 1, E).astype(np.int32)  # n_dev = invalid
    key = rs.uniform(0, 1, E).astype(np.float32)
    payload = np.arange(E, dtype=np.int32)
    (out_p,), out_k = bucket_by_dest(
        jnp.asarray(dest), jnp.asarray(key), (jnp.asarray(payload),), cap, n_dev
    )
    out_p, out_k = np.asarray(out_p).reshape(n_dev, cap), np.asarray(out_k).reshape(n_dev, cap)
    for dev in range(n_dev):
        members = np.nonzero(dest == dev)[0]
        expect = set(members[np.argsort(key[members], kind="stable")[:cap]])
        got = set(out_p[dev][out_p[dev] >= 0])
        assert got == expect, (dev, got, expect)
        # float keys line up with payloads
        for slotpos in range(cap):
            if out_p[dev, slotpos] >= 0:
                assert out_k[dev, slotpos] == key[out_p[dev, slotpos]]


def test_group_topc_exact():
    from pynndescent_tpu.parallel.mesh import group_topc
    import jax.numpy as jnp

    rs = np.random.RandomState(1)
    E, n_groups, cap = 400, 16, 4
    gkey = rs.randint(-1, n_groups, E).astype(np.int32)  # -1 = invalid
    key = rs.uniform(0, 1, E).astype(np.float32)
    payload = np.arange(E, dtype=np.int32)
    (tab,), _ = group_topc(
        jnp.asarray(gkey), n_groups, jnp.asarray(key), (jnp.asarray(payload),), cap
    )
    tab = np.asarray(tab)
    for g in range(n_groups):
        members = np.nonzero(gkey == g)[0]
        expect = set(members[np.argsort(key[members], kind="stable")[:cap]])
        got = set(tab[g][tab[g] >= 0])
        assert got == expect, (g, got, expect)


def test_mesh_native_index_class(nn_data):
    """Multi-device through the PUBLIC API. Building and
    querying via NNDescent(devices=8) must hit the reference recall floors
    (query >= 0.95 at eps 0.2, tests/test_pynndescent_.py:133-165) and agree
    statistically with the single-device index."""
    from sklearn.neighbors import NearestNeighbors

    from pynndescent_tpu import NNDescent

    data = nn_data[:800]
    queries = nn_data[800:]
    k = 10
    index = NNDescent(data, n_neighbors=k, random_state=42, devices=8)
    assert index._mesh is not None
    idx, _ = index.query(queries, k=k, epsilon=0.2)
    nn = NearestNeighbors(n_neighbors=k).fit(data)
    true_idx = nn.kneighbors(queries, k, return_distance=False)
    recall = np.mean(
        [len(np.intersect1d(idx[i], true_idx[i])) / k for i in range(len(queries))]
    )
    assert recall >= 0.95, f"mesh-native query recall {recall}"
    # graph parity with a single-device build (statistical: ulp-order flips)
    single = NNDescent(data, n_neighbors=k, random_state=42)
    gi_m, _ = index.neighbor_graph
    gi_1, _ = single.neighbor_graph
    overlap = np.mean(
        [len(np.intersect1d(gi_m[i], gi_1[i])) / k for i in range(len(data))]
    )
    assert overlap >= 0.9, f"mesh/single graph overlap {overlap}"


def test_mesh_native_index_pickle(nn_data):
    """Mesh indexes pickle: the mesh itself is process-local, so the clone
    re-resolves devices on load and queries identically-shaped results."""
    import pickle

    from pynndescent_tpu import NNDescent

    data = nn_data[:400]
    index = NNDescent(data, n_neighbors=6, random_state=3, devices=8)
    index.prepare()
    clone = pickle.loads(pickle.dumps(index))
    assert clone._mesh is not None  # 8 virtual devices available here too
    qi, qd = clone.query(data[:20], k=4, epsilon=0.2)
    assert qi.shape == (20, 4)
    hits = np.mean([i in qi[i] for i in range(20)])
    assert hits >= 0.9


def test_mesh_native_update(nn_data):
    """update() on a devices= index re-runs the descent
    through the SAME mesh parallelism as the build (reference analog: update
    under the build's threading, pynndescent_.py:2381-2553). Build with
    devices=8, append fresh rows, query: the recall floor must hold over the
    grown table."""
    from sklearn.neighbors import NearestNeighbors

    from pynndescent_tpu import NNDescent

    data = nn_data[:700]
    fresh = nn_data[700:900]
    queries = nn_data[900:]
    k = 10
    index = NNDescent(data, n_neighbors=k, random_state=42, devices=8)
    index.update(xs_fresh=fresh)
    assert index._mesh is not None
    full = np.vstack([data, fresh])
    assert index._raw_data.shape[0] == full.shape[0]
    idx, _ = index.query(queries, k=k, epsilon=0.2)
    nn = NearestNeighbors(n_neighbors=k).fit(full)
    true_idx = nn.kneighbors(queries, k, return_distance=False)
    recall = np.mean(
        [len(np.intersect1d(idx[i], true_idx[i])) / k for i in range(len(queries))]
    )
    assert recall >= 0.9, f"mesh update query recall {recall}"
    # fresh rows must be discoverable as neighbors of themselves
    qi, _ = index.query(fresh[:20], k=4, epsilon=0.2)
    hits = np.mean([700 + i in qi[i] for i in range(20)])
    assert hits >= 0.9


def test_mesh_native_inplace_update(nn_data):
    """In-place row overwrites on a devices= index: moved rows must be
    re-discovered at their new location after update()."""
    from pynndescent_tpu import NNDescent

    data = nn_data[:640].copy()
    k = 8
    index = NNDescent(data, n_neighbors=k, random_state=7, devices=8)
    moved = np.asarray(data[:10] + 50.0)  # far from everything else
    index.update(xs_updated=moved, updated_indices=np.arange(10))
    qi, _ = index.query(moved, k=4, epsilon=0.2)
    hits = np.mean([i in qi[i] for i in range(10)])
    assert hits >= 0.9


def _mesh_stages(data, mesh, shard_data, k=6):
    import jax.numpy as jnp

    from pynndescent_tpu.parallel import mesh as mesh_mod

    n = data.shape[0]
    n_dev = mesh.shape["data"]
    make = mesh_mod._data_sharded_stages if shard_data else mesh_mod._replicated_stages
    _, stages, X_dev = make(
        jnp.asarray(data), k, mesh, "data", n_pad=-(-n // n_dev) * n_dev,
        metric="sqeuclidean", metric_kwds=None, max_candidates=k, leaf_cap=16,
        block_rows=None, stop_count=jnp.float32(0.0),
    )
    return stages, X_dev


def test_sharded_window_sweeps_match_slab_oracle(nn_data):
    """One sweep phase over the identity order: every row holds the exact
    top-k of its window, windows cut per device slab (never straddling
    one), ids global."""
    _check_slab_sweep(nn_data, 800, shard_data=False)


@pytest.mark.parametrize(
    "n, shard_data", [(797, False), (800, True), (797, True)],
    ids=["padded", "shard_data", "shard_data-padded"],
)
def test_sharded_window_sweeps_slab_oracle_cases(nn_data, n, shard_data):
    """As above with X row-sharded, and with n not dividing the mesh: rows
    past n (the last slab's padding) neither get nor give candidates."""
    _check_slab_sweep(nn_data, n, shard_data)


def _check_slab_sweep(nn_data, n, shard_data):
    import jax.numpy as jnp

    from pynndescent_tpu.ops.neighbors import make_neighbor_state
    from pynndescent_tpu.parallel import make_mesh

    data = nn_data[:n]
    k, win, slab = 6, 64, 100  # 8 devices x 100-row slabs
    mesh = make_mesh(8)
    stages, X_dev = _mesh_stages(data, mesh, shard_data, k)
    order = jnp.arange(800, dtype=jnp.int32)
    st, Xp = stages.to_tree(make_neighbor_state(800, k), X_dev, order)
    st = stages.from_tree(stages.sweep(st, Xp, win, k, 0), order)
    idx, dist = np.asarray(st.idx), np.asarray(st.dist)
    assert np.all(idx[n:] == -1)
    for s0 in range(0, n, slab):
        for w0 in range(s0, min(s0 + slab, n), win):
            w1 = min(w0 + win, s0 + slab, n)
            blk = data[w0:w1].astype(np.float64)
            D = ((blk[:, None] - blk[None]) ** 2).sum(-1)
            np.fill_diagonal(D, np.inf)
            want = np.sort(D, axis=1)[:, :k]
            got = dist[w0:w1, : want.shape[1]]
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
            ok = idx[w0:w1] >= 0
            assert np.all((idx[w0:w1][ok] >= w0) & (idx[w0:w1][ok] < w1))


@pytest.mark.parametrize("shard_data", [False, True], ids=["replicated", "shard_data"])
def test_tree_moves_match_single_device(nn_data, shard_data):
    """The mesh's tree-order moves (row fetches through the ppermute ring)
    give the single-device permutation (ops.nndescent._state_to_tree_order)
    and invert exactly."""
    import jax.numpy as jnp

    from pynndescent_tpu.ops import nndescent as nnd_ops
    from pynndescent_tpu.ops.neighbors import NeighborState
    from pynndescent_tpu.parallel import make_mesh

    n, k = 800, 6
    rs = np.random.RandomState(0)
    state = NeighborState(
        jnp.asarray(rs.randint(-1, n, (n, k)).astype(np.int32)),
        jnp.asarray(rs.uniform(size=(n, k)).astype(np.float32)),
        jnp.asarray(rs.uniform(size=(n, k)) < 0.5),
    )
    order = jnp.asarray(rs.permutation(n).astype(np.int32))
    stages, X_dev = _mesh_stages(nn_data[:n], make_mesh(8), shard_data, k)
    st_p, Xp = stages.to_tree(state, X_dev, order)
    want = nnd_ops._state_to_tree_order(state, order)
    for got, ref in zip(st_p, want):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))
    np.testing.assert_array_equal(np.asarray(Xp)[:n], nn_data[:n][np.asarray(order)])
    for got, ref in zip(stages.from_tree(st_p, order), state):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))


def _count_sweeps(monkeypatch):
    from pynndescent_tpu.parallel import mesh as mesh_mod

    calls = []
    make = mesh_mod._slab_sweep

    def counting(*args, **kwargs):
        sweep = make(*args, **kwargs)

        def counted(*a):
            calls.append(a[2:])
            return sweep(*a)

        return counted

    monkeypatch.setattr(mesh_mod, "_slab_sweep", counting)
    return calls


def _locality_build_recall(data, shard_data, locality, seed=8, k=8):
    from sklearn.neighbors import NearestNeighbors

    from pynndescent_tpu.ops import rp_trees
    from pynndescent_tpu.parallel import make_mesh, sharded_nn_descent
    from pynndescent_tpu.utils import rng

    n = data.shape[0]
    forest = rp_trees.build_forest_orders(
        data, np.arange(4, dtype=np.uint32), 60, rp_trees.forest_depth(n, 60)
    )
    idx, _ = sharded_nn_descent(
        data, k, rng.state_from_seed(seed), make_mesh(8), forest=forest,
        leaf_cap=60, block_rows=100, shard_data=shard_data, locality=locality,
    )
    idx = np.asarray(idx)
    assert idx.shape == (n, k) and idx.max() < n
    true_idx = NearestNeighbors(n_neighbors=k).fit(data).kneighbors(
        data, k, return_distance=False
    )
    return np.mean([len(np.intersect1d(idx[i], true_idx[i])) / k for i in range(n)])


@pytest.mark.parametrize("shard_data", [False, True], ids=["replicated", "shard_data"])
def test_mesh_build_runs_locality_sweeps(nn_data, monkeypatch, shard_data):
    """devices= builds follow nn_descent's sweep schedule (the shared
    run_schedule): leaf + random init, one sharded window sweep per phase,
    then a short sharded polish — and reach the build floor."""
    _check_locality_sweeps(nn_data, monkeypatch, 800, shard_data)


@pytest.mark.parametrize("shard_data", [False, True], ids=["replicated", "shard_data"])
def test_mesh_build_locality_non_divisible_n(nn_data, monkeypatch, shard_data):
    """The same schedule when n does not divide the mesh (the state and X
    are padded; the last slab's pad rows are masked)."""
    _check_locality_sweeps(nn_data, monkeypatch, 797, shard_data)


def _check_locality_sweeps(nn_data, monkeypatch, n, shard_data):
    calls = _count_sweeps(monkeypatch)
    recall = _locality_build_recall(
        nn_data[:n], shard_data,
        {"window": 400, "sweep": 64, "sweep_m": 16, "phases": 3,
         "phase_iters": 0, "global_iters": 2, "sweep_stagger": False},
    )
    assert calls == [(64, 16, 0)] * 3
    assert recall >= 0.95, f"mesh locality build recall {recall}"


@pytest.mark.parametrize("shard_data", [False, True], ids=["replicated", "shard_data"])
def test_mesh_build_runs_phase_iterations(nn_data, monkeypatch, shard_data):
    """Windowed-join phase iterations (phase_iters) run on a mesh as on one
    card: per phase the join runs in the tree's order; no sweep."""
    calls = _count_sweeps(monkeypatch)
    recall = _locality_build_recall(
        nn_data[:797], shard_data,
        {"window": 200, "phases": 2, "phase_iters": 3, "global_iters": 2},
    )
    assert calls == []
    assert recall >= 0.95, f"mesh phase-iteration build recall {recall}"
