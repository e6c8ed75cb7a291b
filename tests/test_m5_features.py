"""M5 long-tail features: sparse input, bit-packed metrics, quantization,
proxy metrics, metric kwds, degree-aware diversify
(mirrors reference tests/test_pynndescent_.py:56-130, 205-232)."""

import numpy as np
import pytest
from scipy import sparse
NearestNeighbors = pytest.importorskip("sklearn.neighbors").NearestNeighbors

from pynndescent_tpu import NNDescent


def _recall(indices, true_indices):
    n, k = true_indices.shape
    return (
        sum(len(np.intersect1d(indices[i, :k], true_indices[i])) for i in range(n))
        / (n * k)
    )


def test_sparse_build_recall(sparse_nn_data):
    k = 20
    index = NNDescent(sparse_nn_data, n_neighbors=k, random_state=42)
    idx, _ = index.neighbor_graph
    dense = sparse_nn_data.toarray()
    nn = NearestNeighbors(n_neighbors=10).fit(dense)
    true_idx = nn.kneighbors(dense, 10, return_distance=False)
    recall = _recall(idx[:, :10], true_idx)
    # reference floor for the sparse path (tests/test_pynndescent_.py:105-107)
    assert recall >= 0.85, f"sparse build recall {recall}"


def test_sparse_cosine_build_recall(sparse_nn_data):
    k = 20
    index = NNDescent(sparse_nn_data, metric="cosine", n_neighbors=k, random_state=42)
    idx, _ = index.neighbor_graph
    dense = sparse_nn_data.toarray()
    nn = NearestNeighbors(n_neighbors=10, metric="cosine").fit(dense)
    true_idx = nn.kneighbors(dense, 10, return_distance=False)
    recall = _recall(idx[:, :10], true_idx)
    assert recall >= 0.85, f"sparse cosine build recall {recall}"


def test_sparse_query(sparse_nn_data):
    # reference parameters: build n_neighbors=15, query epsilon=0.24
    # (tests/test_pynndescent_.py:167-184)
    train = sparse_nn_data[200:]
    queries = sparse_nn_data[:200]
    index = NNDescent(train, n_neighbors=15, random_state=42)
    idx, dist = index.query(queries, k=10, epsilon=0.24)
    assert idx.shape == (200, 10)
    dense_train = train.toarray()
    dense_q = queries.toarray()
    nn = NearestNeighbors(n_neighbors=10).fit(dense_train)
    true_idx = nn.kneighbors(dense_q, 10, return_distance=False)
    recall = _recall(idx, true_idx)
    assert recall >= 0.9, f"sparse query recall {recall}"


def test_bit_hamming_build():
    rs = np.random.RandomState(42)
    raw = rs.choice([0, 1], size=(600, 64), p=[0.5, 0.5]).astype(np.uint8)
    packed = np.packbits(raw, axis=1)
    index = NNDescent(packed, metric="bit_hamming", n_neighbors=10, random_state=42)
    idx, dist = index.neighbor_graph
    nn = NearestNeighbors(n_neighbors=10, metric="hamming").fit(raw)
    true_idx = nn.kneighbors(raw, 10, return_distance=False)
    recall = _recall(idx, true_idx)
    # reference floor for bit metrics is 0.6 (tests/test_pynndescent_.py:77-79)
    assert recall >= 0.6, f"bit_hamming build recall {recall}"


def test_bit_jaccard_build_and_query():
    rs = np.random.RandomState(42)
    raw = rs.choice([0, 1], size=(600, 64), p=[0.6, 0.4]).astype(np.uint8)
    packed = np.packbits(raw, axis=1)
    index = NNDescent(packed, metric="bit_jaccard", n_neighbors=10, random_state=42)
    idx, _ = index.neighbor_graph
    nn = NearestNeighbors(n_neighbors=10, metric="jaccard").fit(raw.astype(bool))
    true_idx = nn.kneighbors(raw.astype(bool), 10, return_distance=False)
    assert _recall(idx, true_idx) >= 0.6
    qidx, _ = index.query(packed[:20], k=5)
    assert qidx.shape == (20, 5)


@pytest.mark.parametrize("quantization", ["binary", "uint8", "uint4"])
def test_quantized_query(nn_data, quantization):
    if quantization == "binary":
        # sign-bit codes need centered data (the >0 threshold is degenerate
        # on uniform(0,1) inputs — same in the reference, :2178)
        rs = np.random.RandomState(189212)
        data = rs.randn(1000, 64).astype(np.float32)
        train, queries = data[200:], data[:200]
    else:
        train = nn_data[200:]
        queries = nn_data[:200]
    index = NNDescent(
        train, n_neighbors=10, random_state=42, quantization=quantization
    )
    # binary codes are a coarse proxy: over-fetch more and let the true-metric
    # rerank recover (reference uses epsilon=0.36 and larger indexes for
    # bit-packed search, tests/test_pynndescent_.py:205-232)
    pbs = 16 if quantization == "binary" else 4
    idx, dist = index.query(queries, k=10, epsilon=0.3, proxy_beam_size=pbs)
    nn = NearestNeighbors(n_neighbors=10).fit(train)
    true_d, true_idx = nn.kneighbors(queries, 10)
    recall = _recall(idx, true_idx)
    floor = 0.5 if quantization == "binary" else 0.85
    assert recall >= floor, f"{quantization} query recall {recall}"
    # reranked distances are true euclidean
    d0 = np.linalg.norm(train[idx[0]] - queries[0], axis=1)
    np.testing.assert_allclose(np.sort(dist[0]), np.sort(d0), rtol=1e-3, atol=1e-3)


def test_proxy_metric_query(nn_data):
    train = np.abs(nn_data[200:500]) + 0.01
    queries = np.abs(nn_data[:50]) + 0.01
    index = NNDescent(
        train, metric="proxy_jensen_shannon", n_neighbors=10, random_state=42
    )
    idx, dist = index.query(queries, k=5, epsilon=0.2)
    assert idx.shape == (50, 5)
    # distances are true jensen-shannon after rerank
    import pynndescent_tpu.ops.distances as dst

    expected = np.asarray(
        dst.jensen_shannon_divergence(queries[0][None, :], train[idx[0]])
    )
    np.testing.assert_allclose(np.sort(dist[0]), np.sort(expected), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("metric", ["kantorovich", "wasserstein", "sinkhorn"])
def test_exact_ot_metric_build_and_query(nn_data, metric):
    """Direct exact-OT metric names build and query end-to-end (reference
    NNDescent(metric="kantorovich"), distances.py:1484-1598): the build runs
    on the jittable proxy, returned distances are host-exact."""
    rs = np.random.RandomState(3)
    d = 8
    train = np.abs(rs.randn(120, d)).astype(np.float32) + 0.05
    train /= train.sum(axis=1, keepdims=True)
    queries = np.abs(rs.randn(15, d)).astype(np.float32) + 0.05
    queries /= queries.sum(axis=1, keepdims=True)
    # ground cost: 1-d bin positions
    pos = np.arange(d, dtype=np.float64)
    cost = np.abs(pos[:, None] - pos[None, :])

    index = NNDescent(
        train, metric=metric, metric_kwds={"cost": cost}, n_neighbors=8,
        random_state=42,
    )
    idx, dist = index.query(queries, k=5, epsilon=0.2)
    assert idx.shape == (15, 5)
    assert np.all(idx >= 0) and np.all(np.isfinite(dist))

    from pynndescent_tpu.ops import optimal_transport as ot

    exact_fn = ot.kantorovich if metric != "sinkhorn" else (
        lambda x, y: float(ot.sinkhorn(x, y, cost=cost))
    )
    # returned distances are the exact metric on the returned neighbors
    expected = np.array(
        [exact_fn(queries[0], train[c], cost=cost) if metric != "sinkhorn"
         else exact_fn(queries[0], train[c]) for c in idx[0]]
    )
    np.testing.assert_allclose(dist[0], expected, rtol=1e-3, atol=1e-4)

    # neighbor_graph exposes exact distances too
    gi, gd = index.neighbor_graph
    row_exact = np.array(
        [exact_fn(train[0], train[c], cost=cost) if metric != "sinkhorn"
         else exact_fn(train[0], train[c]) for c in gi[0]]
    )
    np.testing.assert_allclose(gd[0], row_exact, rtol=1e-3, atol=1e-4)
    # recall vs exact-OT oracle on a query sample
    sub = rs.choice(len(train), 60, replace=False)
    true0 = np.argsort(
        [exact_fn(queries[0], train[c], cost=cost) if metric != "sinkhorn"
         else exact_fn(queries[0], train[c]) for c in sub]
    )[:5]
    # sanity only: the top-1 exact neighbor among the sampled subset should
    # rank well in the returned list whenever it was indexed
    assert len(np.intersect1d(idx[0], sub[true0])) >= 1


def test_metric_kwds_minkowski(nn_data):
    k = 8
    index = NNDescent(
        nn_data[:400], metric="minkowski", metric_kwds={"p": 3}, n_neighbors=k,
        random_state=42,
    )
    idx, dist = index.neighbor_graph
    nn = NearestNeighbors(n_neighbors=k, metric="minkowski", p=3).fit(nn_data[:400])
    true_idx = nn.kneighbors(nn_data[:400], k, return_distance=False)
    assert _recall(idx, true_idx) >= 0.95


def test_degree_aware_diversify(nn_data):
    index = NNDescent(
        nn_data, n_neighbors=10, random_state=42, diversify_method="degree_aware"
    )
    index.prepare()
    idx, _ = index.query(nn_data[:50], k=5, epsilon=0.2)
    assert idx.shape == (50, 5)


def test_diversify_prob(nn_data):
    index = NNDescent(nn_data, n_neighbors=10, random_state=42, diversify_prob=0.5)
    index.prepare()
    idx, _ = index.query(nn_data[:50], k=5, epsilon=0.2)
    assert idx.shape == (50, 5)


def test_wide_sparse_ell_path():
    """CSR input beyond the densification threshold uses true sparse
    (padded-ELL) kernels end to end."""
    rs = np.random.RandomState(189212)
    n, d, nnz = 600, 100_000, 24
    rows = np.repeat(np.arange(n), nnz)
    cols = np.concatenate(
        [rs.choice(d // 100, nnz, replace=False) * 100 + rs.randint(0, 7) for _ in range(n)]
    )
    vals = rs.uniform(0.1, 1.0, n * nnz).astype(np.float32)
    X = sparse.csr_matrix((vals, (rows, cols)), shape=(n, d))
    index = NNDescent(X, n_neighbors=8, random_state=42, sparse_sketch=None)
    assert index._ell is not None  # ELL path actually taken
    idx, dist = index.neighbor_graph
    # oracle on densified data
    dense = X.toarray()
    nn = NearestNeighbors(n_neighbors=8).fit(dense)
    true_idx = nn.kneighbors(dense, 8, return_distance=False)
    recall = _recall(idx, true_idx)
    # reference sparse build floor (tests/test_pynndescent_.py:105-107)
    assert recall >= 0.85, f"ELL build recall {recall}"
    # distances are true euclidean
    i, j = 5, int(idx[5, 1])
    expected = np.linalg.norm(dense[i] - dense[j])
    assert dist[5, 1] == pytest.approx(expected, rel=1e-3, abs=1e-4)
    # query path
    qidx, _ = index.query(X[:40], k=5, epsilon=0.3)
    true_q = nn.kneighbors(dense[:40], 5, return_distance=False)
    qrecall = _recall(qidx, true_q)
    # reference sparse query floor (tests/test_pynndescent_.py:167-203)
    assert qrecall >= 0.9, f"ELL query recall {qrecall}"


def test_wide_sparse_ell_cosine():
    rs = np.random.RandomState(3)
    n, d, nnz = 400, 50_000, 16
    # clustered supports so cosine similarities are informative (fully random
    # disjoint supports have all-zero overlaps — no method can traverse that)
    n_topics = 20
    topic_cols = [rs.choice(d, 64, replace=False) for _ in range(n_topics)]
    rows = np.repeat(np.arange(n), nnz)
    cols = np.concatenate(
        [rs.choice(topic_cols[i % n_topics], nnz, replace=False) for i in range(n)]
    )
    vals = rs.uniform(0.1, 1.0, n * nnz).astype(np.float32)
    X = sparse.csr_matrix((vals, (rows, cols)), shape=(n, d))
    X.sum_duplicates()
    index = NNDescent(X, metric="cosine", n_neighbors=8, random_state=42, sparse_sketch=None)
    assert index._ell is not None
    idx, _ = index.neighbor_graph
    dense = X.toarray()
    nn = NearestNeighbors(n_neighbors=8, metric="cosine").fit(dense)
    true_idx = nn.kneighbors(dense, 8, return_distance=False)
    assert _recall(idx, true_idx) >= 0.85
