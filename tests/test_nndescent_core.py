"""M1/M2: end-to-end NN-descent recall vs brute force
(mirrors reference tests/test_pynndescent_.py:19-53 build-accuracy floors)."""

import numpy as np
import pytest
NearestNeighbors = pytest.importorskip("sklearn.neighbors").NearestNeighbors

from pynndescent_tpu.ops.nndescent import nn_descent
from pynndescent_tpu.utils import rng


def _recall(indices, true_indices):
    n, k = true_indices.shape
    hits = 0
    for i in range(n):
        hits += len(np.intersect1d(indices[i, :k], true_indices[i]))
    return hits / (n * k)


def test_nn_descent_euclidean_recall(nn_data):
    k = 10
    key = rng.state_from_seed(42)
    indices, distances = nn_descent(nn_data, n_neighbors=k, key=key, metric="euclidean")
    indices = np.asarray(indices)
    nn = NearestNeighbors(n_neighbors=k).fit(nn_data)
    true_indices = nn.kneighbors(nn_data, k, return_distance=False)
    recall = _recall(indices, true_indices)
    assert recall >= 0.95, f"NN-descent recall {recall} below 0.95"


def test_nn_descent_cosine_recall(nn_data):
    k = 10
    key = rng.state_from_seed(42)
    indices, _ = nn_descent(nn_data, n_neighbors=k, key=key, metric="alternative_cosine")
    indices = np.asarray(indices)
    nn = NearestNeighbors(n_neighbors=k, metric="cosine").fit(nn_data)
    true_indices = nn.kneighbors(nn_data, k, return_distance=False)
    recall = _recall(indices, true_indices)
    assert recall >= 0.95, f"NN-descent cosine recall {recall} below 0.95"


def test_nn_descent_deterministic(nn_data):
    k = 8
    i1, d1 = nn_descent(nn_data, n_neighbors=k, key=rng.state_from_seed(7))
    i2, d2 = nn_descent(nn_data, n_neighbors=k, key=rng.state_from_seed(7))
    np.testing.assert_array_equal(np.asarray(i1), np.asarray(i2))
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))


def test_nn_descent_duplicate_free_rows(nn_data):
    data = np.vstack([nn_data[:50]] * 2)  # heavy duplicates
    indices, _ = nn_descent(data, n_neighbors=5, key=rng.state_from_seed(3))
    indices = np.asarray(indices)
    for row in indices:
        valid = row[row >= 0]
        assert len(np.unique(valid)) == len(valid)
    # reference convention: each point's first neighbor is itself — or, for
    # exactly duplicated points, its distance-0 twin
    first = indices[:, 0]
    ids = np.arange(len(data))
    assert np.all((first == ids) | (first == (ids + 50) % 100))


def test_nn_descent_forest_init_recall(nn_data):
    import numpy as _np
    from pynndescent_tpu.ops.rp_trees import build_forest_orders, forest_depth

    k = 10
    key = rng.state_from_seed(42)
    n = nn_data.shape[0]
    forest = build_forest_orders(
        nn_data, _np.arange(6, dtype=_np.uint32), 60, forest_depth(n, 60)
    )
    indices, _ = nn_descent(nn_data, n_neighbors=k, key=key, forest=forest, leaf_cap=60)
    indices = np.asarray(indices)
    nn = NearestNeighbors(n_neighbors=k).fit(nn_data)
    true_indices = nn.kneighbors(nn_data, k, return_distance=False)
    recall = _recall(indices, true_indices)
    # reference build-recall floor (tests/test_pynndescent_.py:32-34)
    assert recall >= 0.98, f"forest-init NN-descent recall {recall} below 0.98"
