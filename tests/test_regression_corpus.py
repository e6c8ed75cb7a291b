"""Reference regression corpus — real pathological payloads.

Runs the reference suite's recorded bug payloads (read-only from
/root/reference/pynndescent/tests/test_data/) through this build:

* cosine_hang.npy: many all-zero and duplicate rows that blew the reference's
  recursive RP trees (reference test_pynndescent_.py:299-348);
* cosine_near_duplicates.npy: near-identical rows (reference :352-369);
* pynndescent_bug_np.npz: wide near-binary data (reference test_bad_data :750).

Invariants mirrored: the build completes (no pathology), neighbor rows are
duplicate-free, and de-duplicated data meets the reference recall floor.
"""

import os

import numpy as np
import pytest

from pynndescent_tpu import NNDescent

TEST_DATA = "/root/reference/pynndescent/tests/test_data"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(TEST_DATA), reason="reference regression payloads unavailable"
)


def _assert_duplicate_free(knn_indices):
    for i in range(knn_indices.shape[0]):
        row = knn_indices[i][knn_indices[i] >= 0]
        assert len(row) == len(np.unique(row)), f"duplicate neighbors in row {i}"


@pytest.mark.slow
def test_duplicate_data_does_not_hang(seed):
    # reference test_rp_trees_should_not_stack_overflow_with_duplicate_data
    data = np.load(os.path.join(TEST_DATA, "cosine_hang.npy")).astype(np.float32)
    index = NNDescent(
        data, metric="cosine", n_neighbors=10, random_state=seed, n_trees=8
    )
    _assert_duplicate_free(index._neighbor_graph[0])


@pytest.mark.slow
def test_deduplicated_data_behaves_normally(seed):
    # reference test_pynndescent_.py:317-348
    from sklearn.neighbors import KDTree
    from sklearn.preprocessing import normalize

    data = np.unique(
        np.load(os.path.join(TEST_DATA, "cosine_hang.npy")).astype(np.float32), axis=0
    )
    data = data[~np.all(data == 0, axis=1)][:1000]

    n_neighbors = 10
    index = NNDescent(
        data, metric="cosine", n_neighbors=n_neighbors, random_state=seed, n_trees=8
    )
    knn_indices = index._neighbor_graph[0]
    _assert_duplicate_free(knn_indices)

    angular_data = normalize(data, norm="l2")
    true_indices = KDTree(angular_data).query(
        angular_data, n_neighbors, return_distance=False
    )
    num_correct = sum(
        np.sum(np.isin(true_indices[i], knn_indices[i])) for i in range(data.shape[0])
    )
    assert num_correct / (data.shape[0] * n_neighbors) >= 0.95


def test_near_duplicate_data_does_not_hang(seed):
    # reference test_rp_trees_should_not_stack_overflow_with_near_duplicate_data
    data = np.load(os.path.join(TEST_DATA, "cosine_near_duplicates.npy")).astype(
        np.float32
    )
    index = NNDescent(
        data, metric="cosine", n_neighbors=10, random_state=seed, n_trees=8
    )
    _assert_duplicate_free(index._neighbor_graph[0])


@pytest.mark.slow
def test_bad_data_builds(seed):
    # reference test_bad_data (test_pynndescent_.py:750-756)
    data = np.sqrt(
        np.load(os.path.join(TEST_DATA, "pynndescent_bug_np.npz"))["arr_0"]
    ).astype(np.float32)
    index = NNDescent(data, metric="cosine", random_state=seed)
    _assert_duplicate_free(index._neighbor_graph[0])


def test_nan_rejected(nn_data):
    bad = nn_data.copy()
    bad[3, 2] = np.nan
    with pytest.raises(ValueError, match="NaN or infinity"):
        NNDescent(bad, n_neighbors=5, random_state=42)


def test_inf_query_rejected(nn_data):
    index = NNDescent(nn_data[:200], n_neighbors=5, random_state=42, n_trees=2)
    bad_q = nn_data[:4].copy()
    bad_q[1, 0] = np.inf
    with pytest.raises(ValueError, match="NaN or infinity"):
        index.query(bad_q, k=3)
