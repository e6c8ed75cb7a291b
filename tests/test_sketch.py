"""Hashed-projection sketch path for wide sparse data (ops/sketch.py).

The sketch is the dense *proxy* formulation of the reference's sparse
path (reference proxy design: /root/reference/pynndescent/distances.py:
2190-2239 — build/search under a cheap order-preserving surrogate, exact
rerank on output). These tests assert the three contracts that make the
proxy invisible at the API:

1. every distance the API returns (neighbor_graph, query) is the TRUE
   sparse metric, recomputed from the exact packed-ELL rows;
2. recall floors hold vs a brute-force sparse oracle (the reference's
   sparse build/query floors, tests/test_pynndescent_.py:105-107,167-203);
3. the escape hatches work: unsupported metrics fall back to the exact ELL
   path under "auto", and sparse_sketch=None forces it.
"""

import numpy as np
import pickle
import pytest
from scipy import sparse
from scipy.spatial import distance as sd
NearestNeighbors = pytest.importorskip("sklearn.neighbors").NearestNeighbors

from pynndescent_tpu import NNDescent
from pynndescent_tpu.ops import sketch as sketch_ops
from pynndescent_tpu.ops.sparse import DENSIFY_MAX_FEATURES

WIDE = DENSIFY_MAX_FEATURES + 50


def _recall(indices, true_indices):
    hits = sum(
        len(np.intersect1d(indices[i], true_indices[i]))
        for i in range(true_indices.shape[0])
    )
    return hits / true_indices.size


def _topic_corpus(n, d, nnz, seed, n_topics=20):
    """Clustered sparse rows with shared vocabulary (cosine-informative)."""
    rs = np.random.RandomState(seed)
    topic_cols = [rs.choice(d, 6 * nnz, replace=False) for _ in range(n_topics)]
    rows = np.repeat(np.arange(n), nnz)
    cols = np.concatenate(
        [rs.choice(topic_cols[i % n_topics], nnz, replace=False) for i in range(n)]
    )
    vals = rs.uniform(0.1, 1.0, n * nnz).astype(np.float32)
    X = sparse.csr_matrix((vals, (rows, cols)), shape=(n, d))
    X.sum_duplicates()
    return X


# ---------------------------------------------------------------------------
# unit level
# ---------------------------------------------------------------------------


def test_resolve_semantics():
    assert sketch_ops.resolve(None, "cosine", WIDE) is None
    assert sketch_ops.resolve(False, "cosine", WIDE) is None
    cfg = sketch_ops.resolve("auto", "cosine", WIDE)
    assert cfg == {
        "kind": "hash",
        "h": sketch_ops.DEFAULT_H,
        "internal": "cosine",
        "binarize": False,
    }
    # jaccard-family metrics use a sign (1-bit) minhash under euclidean:
    # +-1 signs ride the matmul fast paths and are exact in bfloat16
    cfg = sketch_ops.resolve("auto", "jaccard", WIDE)
    assert cfg["kind"] == "minhash" and cfg["encode"] == "sign"
    assert cfg["internal"] == "euclidean"
    assert cfg["h"] == sketch_ops.DEFAULT_D_SIGN
    # the auto width is clamped so the [n, D] signature stays <~2.5 GB
    big = sketch_ops.resolve("auto", "jaccard", WIDE, n_rows=1_000_000)
    assert 2048 <= big["h"] < sketch_ops.DEFAULT_D_SIGN
    assert big["h"] % 128 == 0
    # minhash width is a sample count — NOT clamped to n_features
    assert sketch_ops.resolve(512, "jaccard", 300)["h"] == 512
    # unsupported metric: auto silently declines, explicit width raises
    assert sketch_ops.resolve("auto", "hellinger", WIDE) is None
    with pytest.raises(ValueError):
        sketch_ops.resolve(512, "hellinger", WIDE)
    with pytest.raises(ValueError):
        sketch_ops.resolve(8, "cosine", WIDE)  # too narrow
    # width never exceeds the feature count
    assert sketch_ops.resolve(4096, "cosine", 300)["h"] == 300


def test_minhash_estimates_jaccard():
    """P(signature match) == Jaccard: the hamming distance between minhash
    value signatures is an unbiased estimator of 1-J with std
    sqrt(J(1-J)/h)."""
    rs = np.random.RandomState(3)
    n, d, nnz = 48, WIDE, 40
    rows = np.repeat(np.arange(n), nnz)
    # overlapping supports drawn from a small shared pool -> J in ~[0.1, 0.5]
    cols = rs.randint(0, 4 * nnz, n * nnz)
    X = sparse.csr_matrix(
        (np.ones(n * nnz, np.float32), (rows, cols)), shape=(n, d)
    )
    X.sum_duplicates()
    h = 2048
    S = sketch_ops.minhash_sketch_csr(X, h, seed=5)
    assert S.shape == (n, h) and S.dtype == np.float32
    np.testing.assert_array_equal(S, sketch_ops.minhash_sketch_csr(X, h, seed=5))
    B = (X.toarray() != 0)
    inter = (B[:, None, :] & B[None, :, :]).sum(-1)
    union = (B[:, None, :] | B[None, :, :]).sum(-1)
    J = inter / np.maximum(union, 1)
    J_hat = (S[:, None, :] == S[None, :, :]).mean(-1)
    iu = np.triu_indices(n, 1)
    err = np.abs(J_hat - J)[iu]
    # 3 sigma at J=0.5, h=2048 is 0.033
    assert float(np.mean(err)) < 0.01
    assert float(np.max(err)) < 0.05


def test_sign_minhash_estimates_jaccard():
    """E[s_x . s_y] = D * J: matched minhash slots contribute +1, unmatched
    slots an independent fair coin; variance (1 - J^2)/D per slot."""
    rs = np.random.RandomState(3)
    n, d, nnz = 48, WIDE, 40
    rows = np.repeat(np.arange(n), nnz)
    cols = rs.randint(0, 4 * nnz, n * nnz)
    X = sparse.csr_matrix(
        (np.ones(n * nnz, np.float32), (rows, cols)), shape=(n, d)
    )
    X.sum_duplicates()
    D = 8192
    S = sketch_ops.sign_minhash_sketch_csr(X, D, seed=5)
    assert S.shape == (n, D) and S.dtype == np.float32
    assert set(np.unique(S)) == {-1.0, 1.0}
    np.testing.assert_array_equal(
        S, sketch_ops.sign_minhash_sketch_csr(X, D, seed=5)
    )
    # +-1 is exactly representable in bfloat16 (the fix for the bf16-copy
    # blindness relies on this)
    import jax.numpy as jnp

    np.testing.assert_array_equal(
        np.asarray(jnp.asarray(S).astype(jnp.bfloat16).astype(jnp.float32)), S
    )
    B = X.toarray() != 0
    inter = (B[:, None, :] & B[None, :, :]).sum(-1)
    union = (B[:, None, :] | B[None, :, :]).sum(-1)
    J = inter / np.maximum(union, 1)
    J_hat = (S @ S.T) / D
    iu = np.triu_indices(n, 1)
    err = np.abs(J_hat - J)[iu]
    # per-pair std is sqrt((1-J^2)/D) <= 0.011 at D=8192
    assert float(np.mean(err)) < 0.02
    assert float(np.max(err)) < 0.06


def test_sketch_preserves_inner_products():
    """Signed feature hashing is the standard unbiased <x,y> estimator;
    at h=2048 the relative error on these norms is a few percent."""
    X = _topic_corpus(64, WIDE, nnz=32, seed=0)
    S = sketch_ops.sketch_csr(X, 2048, seed=7)
    assert S.shape == (64, 2048) and S.dtype == np.float32
    # determinism across calls (hash is splitmix64, not Python hash)
    S2 = sketch_ops.sketch_csr(X, 2048, seed=7)
    np.testing.assert_array_equal(S, S2)
    G_true = (X @ X.T).toarray()
    G_sk = S @ S.T
    scale = np.sqrt(np.outer(np.diag(G_true), np.diag(G_true))) + 1e-12
    err = np.abs(G_sk - G_true) / scale
    assert float(np.median(err)) < 0.05
    assert float(np.mean(np.abs(np.diag(G_sk) - np.diag(G_true)) / np.diag(G_true))) < 0.1


# ---------------------------------------------------------------------------
# end to end
# ---------------------------------------------------------------------------


def test_sketch_cosine_end_to_end():
    X = _topic_corpus(500, WIDE, nnz=24, seed=1)
    index = NNDescent(
        X, metric="cosine", n_neighbors=8, random_state=42, n_trees=4,
        sparse_sketch=1024,  # narrow width: contract test, not a recall bench
    )
    assert index._sketch is not None and index._ell is None  # sketch path taken
    idx, dist = index.neighbor_graph
    dense = X.toarray()
    nn = NearestNeighbors(n_neighbors=8, metric="cosine").fit(dense)
    true_idx = nn.kneighbors(dense, 8, return_distance=False)
    # reference sparse build floor (tests/test_pynndescent_.py:105-107)
    assert _recall(idx, true_idx) >= 0.85
    # contract 1: returned distances are TRUE cosine, not sketch cosine
    for i in (3, 57, 211):
        j = int(idx[i, 1])
        expected = sd.cosine(dense[i], dense[j])
        assert dist[i, 1] == pytest.approx(expected, rel=1e-3, abs=1e-5)
    # rows are sorted ascending and duplicate-free
    assert np.all(np.diff(dist, axis=1) >= -1e-7)
    assert all(len(np.unique(row)) == len(row) for row in idx[:20])
    # query path: recall floor + exact distances
    qidx, qdist = index.query(X[:50], k=5, epsilon=0.3)
    true_q = nn.kneighbors(dense[:50], 5, return_distance=False)
    assert _recall(qidx, true_q) >= 0.9
    j = int(qidx[7, 0])
    assert qdist[7, 0] == pytest.approx(sd.cosine(dense[7], dense[j]), rel=1e-3, abs=1e-5)


def test_sketch_jaccard_binarized():
    X = _topic_corpus(400, WIDE, nnz=20, seed=2)
    index = NNDescent(
        X, metric="jaccard", n_neighbors=8, random_state=42, n_trees=4,
        sparse_sketch=2048,  # narrow width: contract test, not a recall bench
    )
    assert index._sketch is not None and index._sketch["kind"] == "minhash"
    idx, dist = index.neighbor_graph
    # oracle: exact jaccard on binary supports
    B = (X.toarray() != 0).astype(np.float32)
    inter = B @ B.T
    nnz_r = B.sum(axis=1)
    union = nnz_r[:, None] + nnz_r[None, :] - inter
    jac = 1.0 - inter / np.maximum(union, 1.0)
    true_idx = np.argsort(jac, axis=1, kind="stable")[:, :8]
    assert _recall(idx, true_idx) >= 0.75  # set-metric recall floor (reference
    # bit_jaccard floor is 0.60, tests/test_pynndescent_.py:77-79)
    i = 11
    j = int(idx[i, 1])
    assert dist[i, 1] == pytest.approx(jac[i, j], rel=1e-3, abs=1e-5)


def test_minhash_query_finds_proxy_neighbors():
    """Regression: the minhash query path must retrieve candidates that are
    near in PROXY (signature-hamming) space. Serving the signatures from the
    bfloat16 search copy broke this silently — the stored 24-bit hash values
    rounded while the query signatures stayed exact, so a true match never
    compared equal, every proxy distance saturated at ~1.0, and the beam
    search went blind (query-vs-proxy recall 0.04 at 5k rows; the tiny
    corpora in the floor tests above were rescued by tree seeding + rerank,
    which is why this needs a few thousand rows to bite)."""
    n, nq = 4000, 150
    X = _topic_corpus(n + nq, WIDE, nnz=24, seed=8, n_topics=40)
    train, queries = X[:n], X[n:]
    index = NNDescent(train, metric="jaccard", n_neighbors=10, random_state=42)
    index.prepare()
    assert index._sketch is not None and index._sketch["kind"] == "minhash"
    sig_t = np.asarray(index._X)
    sig_q = sketch_ops.sketch_rows(
        queries.tocsr(), index._sketch, index._sketch["seed"]
    )
    if index._sketch.get("encode") == "sign":
        D_proxy = -(sig_q @ sig_t.T)  # euclidean on +-1 == -dot ordering
    else:
        D_proxy = (sig_q[:, None, :] != sig_t[None, :, :]).mean(-1)
    proxy10 = np.argsort(D_proxy, axis=1, kind="stable")[:, :10]
    qidx, _ = index.query(queries, k=10, epsilon=0.3)
    # the served ids (exact-reranked from the over-fetched proxy beam) must
    # overlap the exact proxy top-10 far above the blind-beam level (~0.04)
    assert _recall(np.asarray(qidx), proxy10) >= 0.5


def test_sketch_auto_falls_back_for_unsupported_metric():
    X = _topic_corpus(120, WIDE, nnz=12, seed=3)
    X.data = np.abs(X.data)
    index = NNDescent(X, metric="hellinger", n_neighbors=4, random_state=42, n_trees=2)
    assert index._sketch is None and index._ell is not None


def test_sketch_update_append():
    X = _topic_corpus(300, WIDE, nnz=16, seed=4)
    index = NNDescent(
        X, metric="cosine", n_neighbors=6, random_state=42, n_trees=3,
        sparse_sketch=1024,
    )
    fresh = _topic_corpus(40, WIDE, nnz=16, seed=5)
    index.update(xs_fresh=fresh)
    idx, dist = index.neighbor_graph
    assert idx.shape == (340, 6)
    with pytest.raises(NotImplementedError):
        index.update(xs_updated=fresh[:2], updated_indices=np.array([0, 1]))
    # fresh rows participate: query a fresh row for itself
    qidx, _ = index.query(fresh[:10], k=3, epsilon=0.3)
    hits = sum(300 + i in qidx[i] for i in range(10))
    assert hits >= 8


def test_sketch_pickle_roundtrip(tmp_path):
    X = _topic_corpus(250, WIDE, nnz=16, seed=6)
    index = NNDescent(
        X, metric="cosine", n_neighbors=6, random_state=42, n_trees=3,
        sparse_sketch=1024,
    )
    index.prepare()
    q = X[17:42]
    i1, d1 = index.query(q, k=5, epsilon=0.25)
    clone = pickle.loads(pickle.dumps(index))
    i2, d2 = clone.query(q, k=5, epsilon=0.25)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d2), rtol=1e-5)
    # array-native npz checkpoint carries the sketch config + exact ELL store
    path = tmp_path / "sketch_index.npz"
    index.save(path)
    loaded = NNDescent.load(path)
    i3, d3 = loaded.query(q, k=5, epsilon=0.25)
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i3))
    np.testing.assert_allclose(np.asarray(d1), np.asarray(d3), rtol=1e-5)
