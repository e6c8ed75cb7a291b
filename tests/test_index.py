"""Full-index build + query recall floors
(mirrors reference tests/test_pynndescent_.py:19-203)."""

import numpy as np
import pytest
NearestNeighbors = pytest.importorskip("sklearn.neighbors").NearestNeighbors

from pynndescent_tpu import NNDescent


def _recall(indices, true_indices):
    n, k = true_indices.shape
    hits = sum(
        len(np.intersect1d(indices[i, :k], true_indices[i])) for i in range(n)
    )
    return hits / (n * k)


def test_build_recall_euclidean(nn_data):
    k = 10
    index = NNDescent(nn_data, n_neighbors=k, random_state=42)
    idx, dist = index.neighbor_graph
    nn = NearestNeighbors(n_neighbors=k).fit(nn_data)
    true_idx = nn.kneighbors(nn_data, k, return_distance=False)
    recall = _recall(idx, true_idx)
    assert recall >= 0.98, f"build recall {recall} < 0.98"
    # distances must be true euclidean (corrected from sqeuclidean)
    true_d = np.linalg.norm(nn_data[idx[5]] - nn_data[5], axis=1)
    np.testing.assert_allclose(dist[5], true_d, rtol=1e-3, atol=1e-3)


def test_build_recall_cosine(nn_data):
    k = 10
    index = NNDescent(nn_data, metric="cosine", n_neighbors=k, random_state=42)
    idx, dist = index.neighbor_graph
    nn = NearestNeighbors(n_neighbors=k, metric="cosine").fit(nn_data)
    true_idx = nn.kneighbors(nn_data, k, return_distance=False)
    recall = _recall(idx, true_idx)
    assert recall >= 0.98, f"cosine build recall {recall} < 0.98"


def test_query_recall_euclidean(nn_data):
    k = 10
    train = nn_data[200:]
    queries = nn_data[:200]
    index = NNDescent(train, n_neighbors=10, random_state=42)
    idx, dist = index.query(queries, k=k, epsilon=0.2)
    nn = NearestNeighbors(n_neighbors=k).fit(train)
    true_idx = nn.kneighbors(queries, k, return_distance=False)
    recall = _recall(idx, true_idx)
    assert recall >= 0.95, f"query recall {recall} < 0.95"
    # distances corrected to true euclidean
    true_d = np.linalg.norm(train[idx[0]] - queries[0], axis=1)
    np.testing.assert_allclose(np.sort(dist[0]), np.sort(true_d), rtol=1e-3, atol=1e-3)


def test_query_recall_angular(nn_data):
    k = 10
    train = nn_data[200:]
    queries = nn_data[:200]
    index = NNDescent(train, metric="cosine", n_neighbors=10, random_state=42)
    idx, _ = index.query(queries, k=k, epsilon=0.2)
    nn = NearestNeighbors(n_neighbors=k, metric="cosine").fit(train)
    true_idx = nn.kneighbors(queries, k, return_distance=False)
    recall = _recall(idx, true_idx)
    assert recall >= 0.95, f"angular query recall {recall} < 0.95"


def test_query_determinism(nn_data):
    train = nn_data[200:]
    queries = nn_data[:200]
    i1 = NNDescent(train, n_neighbors=10, random_state=42)
    i2 = NNDescent(train, n_neighbors=10, random_state=42)
    r1 = i1.query(queries, k=5)
    r2 = i2.query(queries, k=5)
    np.testing.assert_array_equal(r1[0], r2[0])
    np.testing.assert_allclose(r1[1], r2[1])


def test_locality_windowed_descent_recall(nn_data):
    """Tree-order locality-windowed descent (ops/nndescent.py ``locality``):
    an explicit window far below n must still converge to the same recall
    as the full-table join (the windowed phases + global polish design; at
    n >= 400k this mode is the default via locality='auto'). Clustered data
    like every ann-benchmarks dataset — tree-order slabs are only spatial
    cells when the space HAS cells; on structureless uniform data the mode
    is not the default at any n."""
    rs = np.random.RandomState(3)
    centers = rs.randn(25, 32).astype(np.float32) * 4
    train = (centers[rs.randint(0, 25, 1500)]
             + rs.randn(1500, 32).astype(np.float32))
    k = 10
    index = NNDescent(
        train, n_neighbors=k, random_state=42,
        locality={"window": 256, "phases": 2, "phase_iters": 4, "global_iters": 3},
    )
    idx, dist = index.neighbor_graph
    idx, dist = np.asarray(idx), np.asarray(dist)
    nn = NearestNeighbors(n_neighbors=k).fit(train)
    true_idx = nn.kneighbors(train, k, return_distance=False)
    recall = _recall(idx, true_idx)
    assert recall >= 0.95, f"locality build recall {recall} < 0.95"
    # stored distances must be the TRUE metric on the stored ids — windowed
    # joins must never merge a distance computed from a clamped query row
    # (regression: block_rows > window corrupted out-of-window rows)
    exact = np.linalg.norm(train[:, None, :] - train[idx], axis=-1)
    np.testing.assert_allclose(dist, exact, rtol=1e-4, atol=1e-4)


def test_hub_heavy_reverse_diversify():
    """A point with extreme in-degree (a star hub inside a shell: the center
    is in nearly every point's kNN) must not collapse under the reverse
    transpose cap (reverse diversify truncates the transposed graph at
    rev_cap, models/nndescent.py; the reference diversifies the full
    transpose, pynndescent_.py:1549-1586). Search recall must hold and the
    hub's own neighbors must stay findable."""
    rs = np.random.RandomState(11)
    # 32-D shell: random directions are near-orthogonal, so inter-shell
    # distances are ~sqrt(2) while every point sits at distance 1 from the
    # center — the center is everyone's true nearest neighbor
    shell = rs.randn(799, 32).astype(np.float32)
    shell /= np.linalg.norm(shell, axis=1, keepdims=True)
    data = np.vstack([np.zeros((1, 32), np.float32), shell])
    k = 10
    index = NNDescent(data, n_neighbors=k, random_state=42)
    idx, _ = index.neighbor_graph
    idx = np.asarray(idx)
    # the center (id 0) really is a global hub in the built graph
    in_degree_0 = int(np.sum(idx[1:] == 0))
    assert in_degree_0 > 4 * k, f"center in-degree only {in_degree_0}"
    # queries near the shell: the only well-separated true neighbors are the
    # originating shell point (d=0.05) and the center (d=1.05) — the rest
    # are ~sqrt(2)-distance near-ties, meaningless for a recall criterion.
    # Both must be found despite the rev_cap truncation of the center's
    # enormous reverse list.
    queries = shell[:100] * 1.05
    qidx, _ = index.query(queries, k=k, epsilon=0.2)
    qidx = np.asarray(qidx)
    found_self = np.mean([(i + 1) in qidx[i] for i in range(100)])
    found_center = np.mean([0 in qidx[i] for i in range(100)])
    assert found_self >= 0.95, f"shell self-neighbor found {found_self}"
    assert found_center >= 0.95, f"hub center found {found_center}"
    # a query at the center itself must find the center
    cidx, _ = index.query(np.zeros((1, 32), np.float32), k=5, epsilon=0.2)
    assert 0 in np.asarray(cidx)[0]


def test_expansion_default_pinned():
    """The beam search's operative expansion width is 2 (both the search()
    driver default and search_block's own default): every recall floor in
    this suite was tuned at E=2, so a silent retune of either default would
    invalidate them."""
    import inspect

    from pynndescent_tpu.models import search as search_mod

    assert (
        inspect.signature(search_mod.search).parameters[
            "expansions_per_step"
        ].default
        == 2
    )
    assert (
        inspect.signature(search_mod.search_block).parameters[
            "expansions_per_step"
        ].default
        == 2
    )


def test_device_array_queries_match_numpy(nn_data):
    """Dense queries already on device take the no-host-round-trip fast
    path; results must match the numpy path exactly, and non-finite device
    queries must still be rejected (the check is deferred past the search
    dispatch, not skipped)."""
    import jax.numpy as jnp

    from pynndescent_tpu import NNDescent

    index = NNDescent(nn_data[:300], n_neighbors=8, random_state=42, n_trees=2)
    q_np = nn_data[300:340].astype(np.float32)
    i_host, d_host = index.query(q_np, k=5, epsilon=0.2)
    i_dev, d_dev = index.query(jnp.asarray(q_np), k=5, epsilon=0.2)
    np.testing.assert_array_equal(np.asarray(i_dev), np.asarray(i_host))
    np.testing.assert_allclose(np.asarray(d_dev), np.asarray(d_host), rtol=1e-6)

    bad = q_np.copy()
    bad[2, 1] = np.nan
    with pytest.raises(ValueError, match="NaN or infinity"):
        index.query(jnp.asarray(bad), k=5, epsilon=0.2)


def test_device_array_queries_cosine(nn_data):
    """Device-path normalization (cosine) matches the host path."""
    import jax.numpy as jnp

    from pynndescent_tpu import NNDescent

    index = NNDescent(
        nn_data[:300], metric="cosine", n_neighbors=8, random_state=42, n_trees=2
    )
    q_np = nn_data[300:332].astype(np.float32)
    i_host, _ = index.query(q_np, k=5, epsilon=0.2)
    i_dev, _ = index.query(jnp.asarray(q_np), k=5, epsilon=0.2)
    np.testing.assert_array_equal(np.asarray(i_dev), np.asarray(i_host))


def test_phase_times_populated(nn_data):
    """profile=True accumulates structured per-phase wall seconds across
    build, prepare and query (SURVEY §5 tracing subsystem)."""
    from pynndescent_tpu import NNDescent

    index = NNDescent(
        nn_data[:300], n_neighbors=8, random_state=42, n_trees=2, profile=True
    )
    index.prepare()
    index.query(nn_data[300:320], k=5, epsilon=0.2)
    times = index.phase_times_
    for key in ("forest", "descent", "prepare/diversify",
                "prepare/search_tree", "query"):
        assert key in times and times[key] >= 0.0, (key, times)
    # disabled by default: no timing overhead state accumulates
    cold = NNDescent(nn_data[:300], n_neighbors=8, random_state=42, n_trees=2)
    assert cold.phase_times_ == {}


def test_one_dimensional_data_rejected(nn_data):
    """1-D input raises like sklearn check_array(ensure_2d=True), which the
    reference routes every input through (pynndescent_.py:1041-1057)."""
    import pytest

    from pynndescent_tpu import NNDescent

    with pytest.raises(ValueError, match="Expected 2D array"):
        NNDescent(np.float32([1.0, 2.0, 3.0]), n_neighbors=2)
    with pytest.raises(ValueError, match="Expected 2D array"):
        NNDescent(nn_data.reshape(-1), n_neighbors=2)
