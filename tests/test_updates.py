"""Incremental update scenarios
(mirrors reference tests/conftest.py:85-102 + tests/test_pynndescent_.py:523-663)."""

import numpy as np
import pytest
NearestNeighbors = pytest.importorskip("sklearn.neighbors").NearestNeighbors

from pynndescent_tpu import NNDescent


def _recall(indices, true_indices):
    n, k = true_indices.shape
    return (
        sum(len(np.intersect1d(indices[i, :k], true_indices[i])) for i in range(n))
        / (n * k)
    )


def _scenarios():
    rs = np.random.RandomState(189212)
    base = rs.uniform(0, 1, (600, 5)).astype(np.float32)
    fresh = rs.uniform(0, 1, (120, 5)).astype(np.float32)
    upd_idx = np.arange(40, 80)
    upd_vals = rs.uniform(0, 1, (40, 5)).astype(np.float32)
    return [
        ("fresh_only", base, fresh, None, None),
        ("update_only", base, None, upd_vals, upd_idx),
        ("fresh_and_update", base, fresh, upd_vals, upd_idx),
        ("small_fresh", base, fresh[:3], None, None),
    ]


@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("name,base,fresh,upd_vals,upd_idx",
                         _scenarios(), ids=[s[0] for s in _scenarios()])
def test_update_scenarios(name, base, fresh, upd_vals, upd_idx, metric):
    k = 8
    index = NNDescent(base, metric=metric, n_neighbors=k, random_state=42)
    index.update(xs_fresh=fresh, xs_updated=upd_vals, updated_indices=upd_idx)
    data = base.copy()
    if upd_vals is not None:
        data[upd_idx] = upd_vals
    if fresh is not None:
        data = np.vstack([data, fresh])
    idx, _ = index.neighbor_graph
    assert idx.shape[0] == len(data)
    nn = NearestNeighbors(n_neighbors=k, metric=metric).fit(data)
    true_idx = nn.kneighbors(data, k, return_distance=False)
    recall = _recall(idx, true_idx)
    assert recall >= 0.93, f"{name}/{metric} post-update recall {recall}"


def test_repeated_updates_shrink_forest(nn_data):
    index = NNDescent(nn_data[:600], n_neighbors=8, random_state=42)
    assert index.n_trees_after_update == max(2, round(index.n_trees / 3))
    for i in range(3):
        index.update(xs_fresh=nn_data[600 + i * 100 : 700 + i * 100])
    idx, _ = index.neighbor_graph
    assert idx.shape[0] == 900
    qidx, _ = index.query(nn_data[:20], k=5)
    assert qidx.shape == (20, 5)
