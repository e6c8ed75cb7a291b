"""Padded-ELL sparse path: metric library, tree init, wide queries, update.

Mirrors the reference's sparse coverage (sparse metric correctness against
dense oracles, sparse build/query recall floors, append-only sparse update —
reference tests/test_distances.py:118-235, test_pynndescent_.py:92-203).
"""

import numpy as np
import pytest
from scipy import sparse
from scipy.spatial import distance as sd
NearestNeighbors = pytest.importorskip("sklearn.neighbors").NearestNeighbors

import jax.numpy as jnp

from pynndescent_tpu import NNDescent
from pynndescent_tpu.ops import sparse_ell as se
from pynndescent_tpu.ops.sparse import DENSIFY_MAX_FEATURES


def _recall(indices, true_indices):
    n, k = true_indices.shape
    return (
        sum(len(np.intersect1d(indices[i, :k], true_indices[i])) for i in range(n))
        / (n * k)
    )


def _clustered_wide_sparse(n, d, seed=0, n_centers=25, density=0.002):
    rs = np.random.RandomState(seed)
    base = sparse.random(
        n_centers, d, density=density, random_state=rs, format="csr", dtype=np.float32
    )
    rows = [
        base[rs.randint(n_centers)]
        + 0.1
        * sparse.random(
            1, d, density=density / 4, random_state=rs, format="csr", dtype=np.float32
        )
        for _ in range(n)
    ]
    return sparse.vstack(rows).tocsr()


# ---------------------------------------------------------------------------
# metric correctness vs dense oracles
# ---------------------------------------------------------------------------

SCIPY_ORACLES = {
    "euclidean": sd.euclidean,
    "sqeuclidean": sd.sqeuclidean,
    "manhattan": sd.cityblock,
    "chebyshev": sd.chebyshev,
    "canberra": sd.canberra,
    "braycurtis": sd.braycurtis,
    "cosine": sd.cosine,
    "correlation": sd.correlation,
}


@pytest.fixture(scope="module")
def ell_pair():
    rs = np.random.RandomState(0)
    n, d = 12, 40
    dense = (rs.uniform(0, 1, (n, d)) * (rs.uniform(0, 1, (n, d)) < 0.3)).astype(
        np.float32
    )
    qd = (rs.uniform(0, 1, (6, d)) * (rs.uniform(0, 1, (6, d)) < 0.6)).astype(
        np.float32
    )
    csr, qcsr = sparse.csr_matrix(dense), sparse.csr_matrix(qd)
    nnz_x = int(np.diff(csr.indptr).max())
    nnz_q = int(np.diff(qcsr.indptr).max())
    X = se.csr_to_ell_packed(csr, nnz_x)
    Q = se.csr_to_ell_packed(qcsr, nnz_q)
    return dense, qd, X, Q, nnz_x, nnz_q, d


@pytest.mark.parametrize("metric", sorted(SCIPY_ORACLES))
def test_ell_metric_vs_scipy(ell_pair, metric):
    dense, qd, X, Q, nnz_x, nnz_q, d = ell_pair
    fn = se.make_ell_metric(metric, nnz_q, nnz_x, n_features=d)
    got = np.asarray(fn(jnp.asarray(Q)[:, None, :], jnp.asarray(X)[None, :, :]))
    oracle = SCIPY_ORACLES[metric]
    want = np.array(
        [[oracle(qd[i], dense[j]) for j in range(len(dense))] for i in range(len(qd))]
    )
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_ell_minkowski_kwds(ell_pair):
    dense, qd, X, Q, nnz_x, nnz_q, d = ell_pair
    fn = se.make_ell_metric("minkowski", nnz_q, nnz_x, p=3.0)
    got = np.asarray(fn(jnp.asarray(Q)[:, None, :], jnp.asarray(X)[None, :, :]))
    want = np.array(
        [
            [sd.minkowski(qd[i], dense[j], 3) for j in range(len(dense))]
            for i in range(len(qd))
        ]
    )
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_ell_binary_family(ell_pair):
    """Binary set metrics match the reference's stored-pattern formulas
    (sparse.py:494-613)."""
    dense, qd, X, Q, nnz_x, nnz_q, d = ell_pair

    def stats(a, b):
        pa, pb = a != 0, b != 0
        tt = float(np.sum(pa & pb))
        u = float(np.sum(pa | pb))
        return tt, u, u - tt

    def oracle(name, a, b):
        tt, u, ne = stats(a, b)
        if name == "jaccard":
            return 0.0 if u == 0 else (u - tt) / u
        if name == "dice":
            return 0.0 if ne == 0 else ne / (2 * tt + ne)
        if name == "matching":
            return ne / d
        if name == "kulsinski":
            return 0.0 if ne == 0 else (ne - tt + d) / (ne + d)
        if name in ("rogerstanimoto", "sokalmichener"):
            return 2 * ne / (d + ne)
        if name == "sokalsneath":
            return 0.0 if ne == 0 else ne / (0.5 * tt + ne)
        if name == "hamming":
            return float(np.sum((a != b) & ((a != 0) | (b != 0)))) / d
        raise KeyError(name)

    for name in (
        "hamming", "jaccard", "dice", "matching", "kulsinski",
        "rogerstanimoto", "sokalmichener", "sokalsneath",
    ):
        fn = se.make_ell_metric(name, nnz_q, nnz_x, n_features=d)
        got = np.asarray(fn(jnp.asarray(Q)[:, None, :], jnp.asarray(X)[None, :, :]))
        want = np.array(
            [[oracle(name, qd[i], dense[j]) for j in range(len(dense))] for i in range(len(qd))]
        )
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5, err_msg=name)


def test_ell_distribution_metrics(ell_pair):
    dense, qd, X, Q, nnz_x, nnz_q, d = ell_pair
    eps = float(np.finfo(np.float32).eps)

    def js(a, b, sym):
        m = (a != 0) | (b != 0)
        a, b = a[m].astype(np.float64), b[m].astype(np.float64)
        dim = len(a)
        l1a, l1b = a.sum() + eps * dim, b.sum() + eps * dim
        pa, pb = (a + eps) / l1a, (b + eps) / l1b
        if sym:
            return np.sum(pa * np.log(pa / pb) + pb * np.log(pb / pa))
        mm = 0.5 * (pa + pb)
        return np.sum(0.5 * (pa * np.log(pa / mm) + pb * np.log(pb / mm)))

    def w1(a, b):
        ca = np.cumsum(a / a.sum())
        cb = np.cumsum(b / b.sum())
        return np.sum(np.abs(ca - cb))

    def hellinger(a, b):
        bc = np.sum(np.sqrt(a * b))
        sn = np.sqrt(a.sum() * b.sum())
        return 0.0 if bc > sn else np.sqrt(1 - bc / sn)

    for name, oracle in [
        ("jensen_shannon", lambda a, b: js(a, b, False)),
        ("symmetric_kl", lambda a, b: js(a, b, True)),
        ("wasserstein_1d", w1),
        ("hellinger", hellinger),
    ]:
        fn = se.make_ell_metric(name, nnz_q, nnz_x)
        got = np.asarray(fn(jnp.asarray(Q)[:, None, :], jnp.asarray(X)[None, :, :]))
        want = np.array(
            [[oracle(qd[i], dense[j]) for j in range(len(dense))] for i in range(len(qd))]
        )
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3, err_msg=name)


def test_ell_unsupported_metric_raises():
    with pytest.raises(NotImplementedError):
        se.make_ell_metric("kantorovich", 4, 4)


# ---------------------------------------------------------------------------
# index-level behavior
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_ell_tree_init_and_hub_search_tree():
    """Wide sparse builds now get RP-tree init and a hub search tree
    (previously random-init with no tree)."""
    X = _clustered_wide_sparse(500, DENSIFY_MAX_FEATURES + 50, seed=1)
    index = NNDescent(X, n_neighbors=10, random_state=42, sparse_sketch=None, n_trees=4)
    assert index._ell is not None
    assert index.tree_init  # trees were built for ELL data
    index.prepare()
    assert index._search_tree is not None  # hub search tree exists

    dense = np.asarray(X.todense())
    nn = NearestNeighbors(n_neighbors=10).fit(dense)
    true_idx = nn.kneighbors(dense, 10, return_distance=False)
    assert _recall(index._neighbor_graph[0], true_idx) >= 0.85


@pytest.mark.slow
def test_ell_query_wider_than_train_rows():
    """Queries with more nonzeros than the train watermark are packed at
    their own width — never truncated."""
    X = _clustered_wide_sparse(400, DENSIFY_MAX_FEATURES + 10, seed=2)
    index = NNDescent(X, n_neighbors=10, random_state=42, sparse_sketch=None, n_trees=3)
    rs = np.random.RandomState(7)
    # noise triples the nonzero count (wider than the train watermark) but
    # stays small in magnitude — the test isolates the no-truncation
    # property; magnitude-heavy noise is a different (recall) stressor
    q = (
        X[:30]
        + 0.05
        * sparse.random(
            30,
            X.shape[1],
            density=3.0 * np.diff(X.indptr).max() / X.shape[1],
            random_state=rs,
            format="csr",
            dtype=np.float32,
        )
    ).tocsr()
    assert np.diff(q.tocsr().indptr).max() > index._ell["nnz"]
    qi, qdist = index.query(q, k=5, epsilon=0.3)
    dense = np.asarray(X.todense())
    qdense = np.asarray(q.todense())
    nn = NearestNeighbors(n_neighbors=5).fit(dense)
    true_q = nn.kneighbors(qdense, 5, return_distance=False)
    assert _recall(qi, true_q) >= 0.9
    # distances are exact (no dropped features)
    j = int(qi[0, 0])
    assert qdist[0, 0] == pytest.approx(
        np.linalg.norm(qdense[0] - dense[j]), rel=1e-3, abs=1e-4
    )


@pytest.mark.slow
def test_ell_update_append():
    """Append-only update on the ELL path, including a width-raising batch
    (reference allows append-only sparse updates, pynndescent_.py:2412)."""
    X = _clustered_wide_sparse(300, DENSIFY_MAX_FEATURES + 20, seed=3)
    index = NNDescent(X, n_neighbors=8, random_state=42, sparse_sketch=None, n_trees=3)
    old_nnz = index._ell["nnz"]
    rs = np.random.RandomState(11)
    fresh = (
        X[:40]
        + sparse.random(
            40,
            X.shape[1],
            density=2.5 * old_nnz / X.shape[1],
            random_state=rs,
            format="csr",
            dtype=np.float32,
        )
    ).tocsr()
    index.update(xs_fresh=fresh)
    assert index._ell["nnz"] >= old_nnz
    assert index._raw_data.shape[0] == 340

    dense = np.vstack([np.asarray(X.todense()), np.asarray(fresh.todense())])
    nn = NearestNeighbors(n_neighbors=8).fit(dense)
    true_idx = nn.kneighbors(dense, 8, return_distance=False)
    assert _recall(index._neighbor_graph[0], true_idx) >= 0.8

    with pytest.raises(NotImplementedError):
        index.update(xs_updated=fresh[:2], updated_indices=[0, 1])


@pytest.mark.slow
def test_ell_pickle_roundtrip():
    import pickle

    X = _clustered_wide_sparse(300, DENSIFY_MAX_FEATURES + 5, seed=4)
    index = NNDescent(X, metric="cosine", n_neighbors=8, random_state=42, sparse_sketch=None, n_trees=3)
    index.prepare()
    blob = pickle.dumps(index)
    index2 = pickle.loads(blob)
    q = X[:20]
    i1, d1 = index.query(q, k=5, epsilon=0.2)
    i2, d2 = index2.query(q, k=5, epsilon=0.2)
    assert np.array_equal(i1, i2)
    np.testing.assert_allclose(d1, d2, rtol=1e-6)


def test_ell_dense_query_rejected():
    X = _clustered_wide_sparse(150, DENSIFY_MAX_FEATURES + 5, seed=5)
    index = NNDescent(X, n_neighbors=5, random_state=42, sparse_sketch=None, n_trees=2)
    with pytest.raises(ValueError, match="scipy sparse"):
        index.query(np.zeros((2, X.shape[1]), np.float32), k=3)
