"""The locality window sweep and the forest leaf init, against NumPy oracles.

Both stages are plain XLA programs (one code path on every backend); these
tests run them on the CPU at small shapes. The same comparisons run at real
widths on the GPU in ``chip_smoke.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from pynndescent_tpu.ops import nndescent as nnd_ops
from pynndescent_tpu.ops import rp_trees
from pynndescent_tpu.ops.neighbors import make_neighbor_state

F32_MAX = np.finfo(np.float32).max


def _np_pairwise(metric, A, B):
    """float64 NumPy distance matrix with the registry's conventions."""
    A = np.asarray(A, np.float64)
    B = np.asarray(B, np.float64)
    sim = A @ B.T
    if metric in ("sqeuclidean", "euclidean"):
        d2 = np.maximum((A * A).sum(1)[:, None] + (B * B).sum(1)[None] - 2 * sim, 0)
        return d2 if metric == "sqeuclidean" else np.sqrt(d2)
    nn = np.linalg.norm(A, axis=1)[:, None] * np.linalg.norm(B, axis=1)[None]
    if metric == "cosine":
        return 1.0 - sim / nn
    if metric == "alternative_cosine":
        return np.where(sim > 0, np.log2(nn / np.where(sim > 0, sim, 1)), F32_MAX)
    if metric == "dot":
        return np.where(sim <= 0, 1.0, 1.0 - sim)
    raise ValueError(metric)


@pytest.fixture(scope="module")
def small_forest():
    n, d = 600, 16
    rs = np.random.RandomState(0)
    # offset keeps every pairwise inner product positive (no F32_MAX ties)
    X = jnp.asarray(rs.randn(n, d).astype(np.float32) + 2.0)
    seeds = jnp.arange(2, dtype=jnp.uint32)
    orders, starts, sizes = rp_trees.build_forest_orders(
        X, seeds, 30, rp_trees.forest_depth(n, 30)
    )
    return X, orders, starts, sizes


@pytest.mark.parametrize("metric", ["sqeuclidean", "alternative_cosine"])
def test_forest_init_matches_leaf_allpairs_oracle(small_forest, metric):
    """Each row holds the k nearest of its leaf-mates over all trees (the
    first ``leaf_cap`` members of each leaf), self included at distance 0."""
    X, orders, starts, sizes = small_forest
    n, k, cap = X.shape[0], 8, 64
    st = nnd_ops._jit_forest_init(
        make_neighbor_state(n, k), X, orders, starts, sizes,
        dist_rowwise=nnd_ops._resolve_rowwise_metric(metric, None),
        leaf_cap=cap,
    )
    idx, dist = np.asarray(st.idx), np.asarray(st.dist)
    Xn = np.asarray(X)
    on, sn, zn = (np.asarray(a) for a in (orders, starts, sizes))
    pos_of = np.argsort(on, axis=1)  # tree position of each point id
    for p in np.random.RandomState(1).choice(n, 60, replace=False):
        cand = set()
        for t in range(on.shape[0]):
            s0, sz = sn[t, pos_of[t, p]], zn[t, pos_of[t, p]]
            cand.update(on[t, s0 : s0 + min(sz, cap)].tolist())
        cand = np.array(sorted(cand))
        want = np.sort(_np_pairwise(metric, Xn[p : p + 1], Xn[cand])[0])[:k]
        got = dist[p][idx[p] >= 0]
        assert len(got) == len(want)
        assert len(set(idx[p][idx[p] >= 0].tolist())) == len(got)
        assert set(idx[p][idx[p] >= 0].tolist()) <= set(cand.tolist())
        np.testing.assert_allclose(np.sort(got), want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# window_topm: exact within-window top-m (the gather-free locality sweep)
# ---------------------------------------------------------------------------


def _topm_oracle(X, win, m, n_real=None):
    """Brute-force within-window top-m (numpy)."""
    n = X.shape[0] if n_real is None else n_real
    ids = np.full((n, m), -1, np.int64)
    dd = np.full((n, m), np.inf, np.float32)
    for s in range(0, n, win):
        e = min(s + win, n)
        blk = np.asarray(X[s:e], np.float32)
        d = ((blk[:, None, :] - blk[None, :, :]) ** 2).sum(-1)
        np.fill_diagonal(d, np.inf)
        take = min(m, e - s - 1)
        order = np.argsort(d, axis=1, kind="stable")[:, :take]
        ids[s:e, :take] = order + s
        dd[s:e, :take] = np.take_along_axis(d, order, axis=1)
    return ids, dd


@pytest.mark.parametrize("n", [1024, 1100])  # exact multiple + ragged tail
def test_window_topm_xla_matches_oracle(n):
    rs = np.random.RandomState(1)
    X = jnp.asarray(rs.randn(n, 24).astype(np.float32))
    win, m = 256, 12
    ids, dd = nnd_ops.window_topm(X, win=win, m=m, metric="sqeuclidean")
    oid, od = _topm_oracle(X, win, m)
    ids, dd = np.asarray(ids), np.asarray(dd)
    # same distances everywhere (id ties may reorder within equal distances)
    np.testing.assert_allclose(dd, od, rtol=1e-4, atol=1e-5)
    agree = (ids == oid).mean()
    assert agree > 0.999


def test_window_topm_offset_matches_oracle():
    """Staggered boundaries: offset=win//2 must equal the oracle computed on
    a front-padded copy, with ids mapped back to unpadded positions."""
    rs = np.random.RandomState(3)
    n, win, m, off = 900, 256, 10, 128
    X = rs.randn(n, 24).astype(np.float32) + 3.0  # keep rows away from 0-pad
    ids, dd = nnd_ops.window_topm(jnp.asarray(X), win=win, m=m,
                             metric="sqeuclidean", offset=off)
    Xp = np.concatenate([np.zeros((off, 24), np.float32), X])
    oid, od = _topm_oracle(Xp, win, m)
    # drop the pad rows; pad columns (global pos < off) carry inf distance
    # in the kernel and so never make top-m for rows that have >= m real
    # in-window peers; compare distances where the oracle's pick is real
    oid, od = oid[off:], od[off:]
    real = oid >= off
    np.testing.assert_allclose(
        np.asarray(dd)[real], od[real], rtol=1e-4, atol=1e-5
    )
    agree = (np.asarray(ids)[real] == (oid - off)[real]).mean()
    assert agree > 0.999


def test_window_sweep_merges_exact_local_neighbors():
    """After one sweep, every point's state holds its exact within-window
    top-k (the sweep is exhaustive inside a window)."""
    rs = np.random.RandomState(3)
    n, k = 700, 6
    X = jnp.asarray(rs.randn(n, 8).astype(np.float32))
    state = make_neighbor_state(n, k)
    state = nnd_ops._jit_window_sweep(
        state, X, win=256, m=16, metric="sqeuclidean"
    )
    oid, od = _topm_oracle(X, 256, k)
    np.testing.assert_allclose(np.asarray(state.dist), od, rtol=1e-4, atol=1e-5)
    assert bool(np.asarray(state.flag)[np.asarray(state.idx) >= 0].all())


def test_window_sweep_staggered_offset_jits():
    """offset must be a static jit argument of _jit_window_sweep (passing it
    traced raises TracerBoolConversionError); a staggered sweep merges
    cross-boundary neighbors the aligned sweep cannot see."""
    rs = np.random.RandomState(5)
    n, k = 700, 6
    X = jnp.asarray(rs.randn(n, 8).astype(np.float32))
    state = make_neighbor_state(n, k)
    state = nnd_ops._jit_window_sweep(
        state, X, win=256, m=16, metric="sqeuclidean"
    )
    state = nnd_ops._jit_window_sweep(
        state, X, win=256, m=16, metric="sqeuclidean", offset=128,
    )
    # rows 255/256 straddle the aligned boundary; the staggered window
    # [128, 384) contains both, so each must now see the other if they are
    # within top-k distance — check the state merged *some* cross-boundary
    # pair overall (statistically certain on gaussian data)
    idx = np.asarray(state.idx)
    pos = np.arange(n)[:, None]
    cross = (idx >= 0) & (pos // 256 != idx // 256)
    assert cross.any()


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "alternative_cosine", "dot"])
def test_window_topm_metric_matches_numpy_oracle(metric):
    """Exact within-window top-m for each gram-form metric the sweep takes:
    the returned distances are the m smallest of the window's row (NumPy,
    float64), and each returned id carries its own true distance."""
    rs = np.random.RandomState(6)
    n, d, win, m = 700, 20, 256, 9
    X = rs.randn(n, d).astype(np.float32) + 1.0
    if metric == "dot":
        X /= np.linalg.norm(X, axis=1, keepdims=True)
    ids, dd = nnd_ops.window_topm(jnp.asarray(X), win=win, m=m, metric=metric)
    ids, dd = np.asarray(ids), np.asarray(dd)
    for s in range(0, n, win):
        e = min(s + win, n)
        D = _np_pairwise(metric, X[s:e], X[s:e])
        np.fill_diagonal(D, np.inf)
        want = np.sort(D, axis=1)[:, :m]
        np.testing.assert_allclose(dd[s:e], want, rtol=1e-4, atol=1e-5)
        assert np.all((ids[s:e] >= s) & (ids[s:e] < e))
        own = np.take_along_axis(D, ids[s:e] - s, axis=1)
        np.testing.assert_allclose(dd[s:e], own, rtol=1e-4, atol=1e-5)
