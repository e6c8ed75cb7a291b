"""API-surface tests: transformer, pickling, update, compression, graph utils
(mirrors reference tests/test_pynndescent_.py:234-663)."""

import io
import pickle

import numpy as np
import pytest
from scipy import sparse
NearestNeighbors = pytest.importorskip("sklearn.neighbors").NearestNeighbors

from pynndescent_tpu import NNDescent, PyNNDescentTransformer
from pynndescent_tpu.utils import graph_utils


def _recall(indices, true_indices):
    n, k = true_indices.shape
    return (
        sum(len(np.intersect1d(indices[i, :k], true_indices[i])) for i in range(n))
        / (n * k)
    )


def test_transformer_fit_transform(nn_data):
    k = 5
    t = PyNNDescentTransformer(n_neighbors=k, random_state=42)
    G = t.fit_transform(nn_data)
    assert sparse.issparse(G)
    assert G.shape == (len(nn_data), len(nn_data))
    # every row has k+1 entries (self included)
    counts = np.diff(G.indptr)
    assert np.all(counts == k + 1)


def test_transformer_transform_matches_query(nn_data):
    train = nn_data[100:]
    queries = nn_data[:100]
    t = PyNNDescentTransformer(n_neighbors=4, random_state=42).fit(train)
    G = t.transform(queries)
    assert G.shape == (100, len(train))
    # transform returns exactly n_neighbors entries per row (the +1
    # self-neighbor convention applies only to fit/fit_transform)
    assert np.all(np.diff(G.indptr) == 4)
    idx, dist = t.index_.query(queries, k=4, epsilon=0.1)
    row0 = G.getrow(0)
    np.testing.assert_allclose(np.sort(row0.data), np.sort(dist[0]), rtol=1e-4)


def test_transformer_fit_compresses_index(nn_data):
    t = PyNNDescentTransformer(n_neighbors=4, random_state=42).fit(nn_data[:300])
    # fit(compress_index=True) is the default: graph dropped, queries work
    assert t.index_._neighbor_graph is None
    G = t.transform(nn_data[300:350])
    assert G.shape == (50, 300)


def test_transformer_sklearn_pipeline(nn_data):
    from sklearn.manifold import Isomap
    from sklearn.pipeline import make_pipeline

    pipe = make_pipeline(
        PyNNDescentTransformer(n_neighbors=15, random_state=42),
        Isomap(n_neighbors=10, metric="precomputed"),
    )
    out = pipe.fit_transform(nn_data[:300])
    assert out.shape == (300, 2)


def test_transformer_sklearn_estimator_contract(nn_data):
    """clone()/get_params()/set_params() round-trip (reference inherits
    BaseEstimator/TransformerMixin at pynndescent_.py:2556)."""
    from sklearn.base import BaseEstimator, TransformerMixin, clone

    t = PyNNDescentTransformer(n_neighbors=7, metric="cosine", search_epsilon=0.15)
    assert isinstance(t, BaseEstimator) and isinstance(t, TransformerMixin)
    params = t.get_params()
    assert params["n_neighbors"] == 7
    assert params["metric"] == "cosine"
    assert params["search_epsilon"] == 0.15
    t2 = clone(t)
    assert t2 is not t
    assert t2.get_params() == params
    t2.set_params(n_neighbors=3)
    assert t2.n_neighbors == 3 and t.n_neighbors == 7


def test_transformer_gridsearch_smoke(nn_data):
    """GridSearchCV over the transformer inside a pipeline — exercises
    clone + get_params/set_params through sklearn's machinery."""
    from sklearn.manifold import Isomap
    from sklearn.model_selection import GridSearchCV
    from sklearn.pipeline import make_pipeline

    X = nn_data[:200]
    pipe = make_pipeline(
        PyNNDescentTransformer(random_state=42),
        Isomap(n_neighbors=8, metric="precomputed"),
    )
    grid = GridSearchCV(
        pipe,
        {"pynndescenttransformer__n_neighbors": [10, 15]},
        cv=2,
        scoring=lambda est, X_t: 1.0,  # smoke: fitting through clone is the test
    )
    grid.fit(X)
    assert grid.best_params_["pynndescenttransformer__n_neighbors"] in (10, 15)


def test_pickle_roundtrip(nn_data):
    train = nn_data[200:]
    queries = nn_data[:200]
    index = NNDescent(train, n_neighbors=10, random_state=42)
    r_before = index.query(queries, k=5, epsilon=0.2)
    blob = pickle.dumps(index)
    index2 = pickle.loads(blob)
    r_after = index2.query(queries, k=5, epsilon=0.2)
    np.testing.assert_array_equal(r_before[0], r_after[0])
    np.testing.assert_allclose(r_before[1], r_after[1])


def test_compressed_pickle_roundtrip(nn_data):
    train = nn_data[200:]
    queries = nn_data[:200]
    index = NNDescent(train, n_neighbors=10, random_state=42, compressed=True)
    with pytest.warns(UserWarning):
        assert index.neighbor_graph is None
    blob = pickle.dumps(index)
    index2 = pickle.loads(blob)
    idx, dist = index2.query(queries, k=5, epsilon=0.2)
    assert idx.shape == (200, 5)


def test_quantized_pickle_roundtrip(nn_data):
    train = nn_data[200:]
    queries = nn_data[:50]
    index = NNDescent(train, n_neighbors=10, random_state=42, quantization="uint8")
    index.prepare()
    r_before = index.query(queries, k=5, epsilon=0.2)
    index2 = pickle.loads(pickle.dumps(index))
    r_after = index2.query(queries, k=5, epsilon=0.2)
    np.testing.assert_array_equal(r_before[0], r_after[0])


def test_quantized_codebook_deterministic_with_randomstate(nn_data):
    a = NNDescent(
        nn_data[:300], n_neighbors=5, quantization="uint8",
        random_state=np.random.RandomState(7),
    )
    b = NNDescent(
        nn_data[:300], n_neighbors=5, quantization="uint8",
        random_state=np.random.RandomState(7),
    )
    a.prepare()
    b.prepare()
    np.testing.assert_array_equal(a._quantized["codebook"], b._quantized["codebook"])


def test_update_bit_metric_data():
    rs = np.random.RandomState(5)
    bits = rs.randint(0, 256, (300, 8)).astype(np.uint8)
    index = NNDescent(bits, metric="bit_hamming", n_neighbors=5, random_state=1)
    fresh = rs.randint(0, 256, (20, 8)).astype(np.uint8)
    index.update(xs_fresh=fresh)
    idx, dist = index.neighbor_graph
    assert idx.shape[0] == 320
    assert index._raw_data.dtype == np.uint8


def test_joblib_dump(nn_data):
    import joblib

    index = NNDescent(nn_data[200:], n_neighbors=10, random_state=42)
    buf = io.BytesIO()
    joblib.dump(index, buf)
    buf.seek(0)
    index2 = joblib.load(buf)
    r1 = index.query(nn_data[:50], k=5)
    r2 = index2.query(nn_data[:50], k=5)
    np.testing.assert_array_equal(r1[0], r2[0])


def test_update_with_fresh_data(nn_data):
    k = 10
    train = nn_data[:800]
    fresh = nn_data[800:]
    index = NNDescent(train, n_neighbors=k, random_state=42)
    index.update(xs_fresh=fresh)
    idx, dist = index.neighbor_graph
    assert idx.shape[0] == len(nn_data)
    nn = NearestNeighbors(n_neighbors=k).fit(nn_data)
    true_idx = nn.kneighbors(nn_data, k, return_distance=False)
    recall = _recall(idx, true_idx)
    assert recall >= 0.95, f"post-update recall {recall}"
    # queries work after update
    qidx, _ = index.query(nn_data[:10], k=5)
    assert qidx.shape == (10, 5)


def test_update_with_changed_data(nn_data):
    k = 8
    index = NNDescent(nn_data, n_neighbors=k, random_state=42)
    rs = np.random.RandomState(0)
    updated_indices = np.arange(0, 50)
    xs_updated = rs.uniform(0, 1, (50, nn_data.shape[1])).astype(np.float32)
    index.update(xs_updated=xs_updated, updated_indices=updated_indices)
    new_data = nn_data.copy()
    new_data[updated_indices] = xs_updated
    idx, _ = index.neighbor_graph
    nn = NearestNeighbors(n_neighbors=k).fit(new_data)
    true_idx = nn.kneighbors(new_data, k, return_distance=False)
    recall = _recall(idx, true_idx)
    assert recall >= 0.95, f"post-overwrite recall {recall}"


def test_adjacency_matrix_representation(nn_data):
    index = NNDescent(nn_data[:300], n_neighbors=5, random_state=42)
    idx, dist = index.neighbor_graph
    A = graph_utils.adjacency_matrix_representation(idx, dist)
    assert A.shape == (300, 300)
    assert (A != A.T).nnz == 0  # symmetric


def test_connect_graph():
    rs = np.random.RandomState(3)
    # two well-separated blobs -> disconnected kNN graph
    blob1 = rs.randn(100, 4).astype(np.float32)
    blob2 = rs.randn(100, 4).astype(np.float32) + 50.0
    data = np.vstack([blob1, blob2])
    index = NNDescent(data, n_neighbors=5, random_state=42)
    idx, dist = index.neighbor_graph
    A = graph_utils.adjacency_matrix_representation(idx, dist)
    ncomp_before, _ = sparse.csgraph.connected_components(A, directed=False)
    assert ncomp_before >= 2
    A2 = graph_utils.connect_graph(A, index)
    ncomp_after, _ = sparse.csgraph.connected_components(A2, directed=False)
    assert ncomp_after == 1


def test_connect_graph_exact_min_edge():
    """connect_graph must choose the TRUE minimum cross-component edge, even
    for components larger than any sampling cap (reference finds an
    approximate edge, graph_utils.py:123-165; this build is exact)."""
    from scipy.spatial.distance import cdist

    rs = np.random.RandomState(5)
    blob1 = rs.randn(2500, 4).astype(np.float32)  # > 2048 members
    blob2 = rs.randn(400, 4).astype(np.float32) + 30.0
    data = np.vstack([blob1, blob2])
    index = NNDescent(data, n_neighbors=5, random_state=42)
    idx, dist = index.neighbor_graph
    A = graph_utils.adjacency_matrix_representation(idx, dist)
    ncomp, labels = sparse.csgraph.connected_components(A, directed=False)
    assert ncomp >= 2
    assert np.bincount(labels).max() > 2048
    A2 = graph_utils.connect_graph(A, index)
    assert sparse.csgraph.connected_components(A2, directed=False)[0] == 1
    new = sparse.triu(A2 - A).tocoo()
    assert new.nnz >= 1
    for i, j, v in zip(new.row, new.col, new.data):
        c1, c2 = labels[i], labels[j]
        assert c1 != c2
        true_min = cdist(data[labels == c1], data[labels == c2]).min()
        assert v == pytest.approx(true_min, rel=1e-3, abs=1e-3)
        assert np.linalg.norm(data[i] - data[j]) == pytest.approx(
            true_min, rel=1e-3, abs=1e-3
        )
    # multi-tile path: small blocks must agree with the one-tile answer
    m1 = np.nonzero(labels == labels[0])[0]
    m2 = np.nonzero(labels != labels[0])[0]
    i, j, d = graph_utils._min_cross_edge(index, m1, m2, block=512)
    assert d == pytest.approx(cdist(data[m1], data[m2]).min(), rel=1e-3, abs=1e-3)


def test_one_dimensional_data():
    rs = np.random.RandomState(7)
    data = rs.uniform(0, 1, (500, 1)).astype(np.float32)
    index = NNDescent(data, n_neighbors=5, random_state=42)
    idx, dist = index.neighbor_graph
    assert idx.shape == (500, 5)
    qidx, _ = index.query(data[:10], k=3)
    assert qidx.shape == (10, 3)


def test_tree_init_false(nn_data):
    k = 10
    index = NNDescent(nn_data, n_neighbors=k, random_state=42, tree_init=False)
    idx, _ = index.neighbor_graph
    nn = NearestNeighbors(n_neighbors=k).fit(nn_data)
    true_idx = nn.kneighbors(nn_data, k, return_distance=False)
    assert _recall(idx, true_idx) >= 0.95


def test_init_graph(nn_data):
    k = 8
    base = NNDescent(nn_data, n_neighbors=k, random_state=42)
    idx0, _ = base.neighbor_graph
    warm = NNDescent(
        nn_data, n_neighbors=k, random_state=43, init_graph=idx0, tree_init=False
    )
    idx, _ = warm.neighbor_graph
    nn = NearestNeighbors(n_neighbors=k).fit(nn_data)
    true_idx = nn.kneighbors(nn_data, k, return_distance=False)
    assert _recall(idx, true_idx) >= 0.98


def test_output_when_verbose_is_true(small_data, capsys):
    """Verbose builds narrate phases (reference test_pynndescent_.py:372)."""
    index = NNDescent(small_data, n_neighbors=4, random_state=1, verbose=True)
    index.prepare()
    out = capsys.readouterr().out
    assert "NN descent" in out
    assert "search graph" in out.lower() or "Search graph" in out


def test_no_output_when_verbose_is_false(small_data, capsys):
    """Silent by default (reference test_pynndescent_.py:390)."""
    index = NNDescent(small_data, n_neighbors=4, random_state=1, verbose=False)
    index.prepare()
    index.query(small_data[:4], k=3)
    assert capsys.readouterr().out == ""


def test_random_state_none(small_data):
    """random_state=None must build a working index (reference :261)."""
    index = NNDescent(small_data, n_neighbors=4, random_state=None)
    idx, dist = index.neighbor_graph
    assert idx.shape == (small_data.shape[0], 4)
    assert np.all(idx >= 0)


def test_transformer_verbose_output(small_data, capsys):
    """Transformer forwards verbose (reference :409-440)."""
    from pynndescent_tpu import PyNNDescentTransformer

    PyNNDescentTransformer(n_neighbors=3, random_state=1, verbose=True).fit(small_data)
    assert "NN descent" in capsys.readouterr().out
    PyNNDescentTransformer(n_neighbors=3, random_state=1, verbose=False).fit(small_data)
    assert capsys.readouterr().out == ""


def test_npz_save_load_roundtrip(tmp_path, nn_data):
    """Array-native .npz checkpoint: identical query results after a
    load in a pickle-free format (save/load beyond the reference's
    pickle-only persistence, pynndescent_.py:1306-1331)."""
    train = nn_data[200:]
    queries = nn_data[:50]
    index = NNDescent(train, n_neighbors=10, random_state=42)
    r1 = index.query(queries, k=5, epsilon=0.2)
    path = str(tmp_path / "index.npz")
    index.save(path)
    loaded = NNDescent.load(path)
    r2 = loaded.query(queries, k=5, epsilon=0.2)
    np.testing.assert_array_equal(np.asarray(r1[0]), np.asarray(r2[0]))
    np.testing.assert_allclose(np.asarray(r1[1]), np.asarray(r2[1]), rtol=1e-6)
    # callable metrics are pickle-only, stated loudly
    import pytest as _pytest

    def mymetric(a, b):
        return ((a - b) ** 2).sum(-1)

    idx2 = NNDescent(train[:300], metric=mymetric, n_neighbors=5, random_state=1)
    with _pytest.raises(ValueError):
        idx2.save(str(tmp_path / "x.npz"))
