"""Hub (graph-informed) search tree tests
(mirrors reference tests/test_hub_trees.py:60-388)."""

import numpy as np
import jax.numpy as jnp
import pytest
from scipy import sparse
NearestNeighbors = pytest.importorskip("sklearn.neighbors").NearestNeighbors

from pynndescent_tpu import NNDescent
from pynndescent_tpu.ops.rp_trees import flatten_search_tree, descend_tree, forest_depth


def _recall(idx, true_idx):
    k = true_idx.shape[1]
    return np.mean(
        [len(np.intersect1d(idx[i, :k], true_idx[i])) / k for i in range(len(true_idx))]
    )


def test_hub_split_is_partition(nn_data):
    degrees = np.random.RandomState(0).randint(1, 40, len(nn_data))
    tree = flatten_search_tree(nn_data, seed=5, leaf_size=30, degrees=degrees)
    a = tree.to_arrays()
    # leaves tile [0, n) exactly
    leaf_mask = a["leaf_lo"] >= 0
    spans = sorted(zip(a["leaf_lo"][leaf_mask], a["leaf_hi"][leaf_mask]))
    covered = 0
    prev_end = 0
    for lo, hi in spans:
        assert lo == prev_end
        assert hi > lo
        prev_end = hi
        covered += hi - lo
    assert covered == len(nn_data)
    # order is a permutation
    assert sorted(a["tree_order"].tolist()) == list(range(len(nn_data)))


def test_hub_tree_query_recall(nn_data):
    """The full index uses the hub search tree; reference floor is 0.90
    (tests/test_hub_trees.py:216-217)."""
    from sklearn.neighbors import NearestNeighbors

    train = nn_data[200:]
    queries = nn_data[:200]
    index = NNDescent(train, n_neighbors=10, random_state=42)
    idx, _ = index.query(queries, k=10, epsilon=0.2)
    nn = NearestNeighbors(n_neighbors=10).fit(train)
    true_idx = nn.kneighbors(queries, 10, return_distance=False)
    recall = np.mean(
        [len(np.intersect1d(idx[i, :10], true_idx[i])) / 10 for i in range(200)]
    )
    assert recall >= 0.90, f"hub-tree query recall {recall}"


def test_scored_hub_splits_balance(nn_data):
    """Scored hub splits keep the best-balanced of the 3 hub-pair hyperplanes
    and bail to a leaf below MIN_SPLIT_BALANCE (reference rp_trees.py:798-933):
    every *internal* node's children must both hold >= 10% of its members."""
    degrees = np.random.RandomState(0).randint(1, 40, len(nn_data))
    tree = flatten_search_tree(nn_data, seed=7, leaf_size=30, degrees=degrees)
    a = tree.to_arrays()
    child = a["child"]
    # recover per-node sizes: leaves know theirs; internal = sum of children
    n_nodes = len(child)
    sizes = np.where(a["leaf_lo"] >= 0, a["leaf_hi"] - a["leaf_lo"], -1)
    for _ in range(64):  # bottom-up fixpoint over the shallow tree
        undone = sizes < 0
        if not undone.any():
            break
        l, r = child[:, 0], child[:, 1]
        ready = undone & (sizes[l] >= 0) & (sizes[r] >= 0)
        sizes = np.where(ready, sizes[l] + sizes[r], sizes)
    internal = a["leaf_lo"] < 0
    l_sz = sizes[child[internal, 0]].astype(float)
    r_sz = sizes[child[internal, 1]].astype(float)
    balance = np.minimum(l_sz, r_sz) / (l_sz + r_sz)
    assert balance.min() >= 0.1 - 1e-6, f"unbalanced internal node: {balance.min()}"


def test_n_search_trees_selection(nn_data):
    """n_search_trees candidate trees are scored and the best is kept
    (reference pynndescent_.py:1353-1373); more candidates never hurt
    tree quality by construction."""
    from pynndescent_tpu.ops import rp_trees

    index = NNDescent(nn_data, n_neighbors=10, random_state=42, n_search_trees=3)
    index.prepare()
    score3 = rp_trees.score_linked_tree(index._search_tree, index._neighbor_graph[0])
    assert score3 > 0.1  # leaves actually capture neighbor structure


def test_hub_anchors_are_exact_top_degree():
    """_hub_anchor_points must return each node's TRUE top-3 in-degree
    members (reference get_top_k_hub_indices, rp_trees.py:747), not a
    sample."""
    from pynndescent_tpu.ops.rp_trees import _hub_anchor_points

    rs = np.random.RandomState(0)
    n = 64
    order = jnp.asarray(rs.permutation(n).astype(np.int32))
    # three nodes: [0, 20), [20, 48), [48, 64)
    bounds = [(0, 20), (20, 48), (48, 64)]
    start = np.empty(n, np.int32)
    size = np.empty(n, np.int32)
    for lo, hi in bounds:
        start[lo:hi] = lo
        size[lo:hi] = hi - lo
    degrees = jnp.asarray(rs.randint(0, 1000, n).astype(np.int32))
    h1, h2, h3 = _hub_anchor_points(
        order, jnp.asarray(start), jnp.asarray(size), degrees, n
    )
    h1, h2, h3 = np.asarray(h1), np.asarray(h2), np.asarray(h3)
    order_np, deg_np = np.asarray(order), np.asarray(degrees)
    for lo, hi in bounds:
        members = order_np[lo:hi]
        top3 = members[np.argsort(-deg_np[members], kind="stable")[:3]]
        # every position of the node must agree on the node's top-3
        for pos in range(lo, hi):
            got = {int(h1[pos]), int(h2[pos]), int(h3[pos])}
            assert got == set(int(t) for t in top3), (lo, hi, got, top3)


def test_hub_tree_beats_random_on_neighbor_capture(nn_data):
    """The point of graph-informed trees: their leaves capture more true
    neighbor pairs than random-split trees of the same leaf size
    (reference rp_trees.py:680-2170). Deterministic given fixed seeds."""
    from pynndescent_tpu.ops import rp_trees

    n = len(nn_data)
    nn = NearestNeighbors(n_neighbors=10).fit(nn_data)
    idx = nn.kneighbors(nn_data, 10, return_distance=False).astype(np.int32)
    degrees = np.bincount(idx.reshape(-1), minlength=n).astype(np.int32)
    depth = forest_depth(n, 30)
    hub_scores, rand_scores = [], []
    for seed in (3, 11, 42):
        o, s, z = rp_trees.build_tree_order(
            jnp.asarray(nn_data), jnp.uint32(seed), 30, depth,
            degrees=jnp.asarray(degrees),
        )
        hub_scores.append(rp_trees.score_tree(o, s, z, idx))
        o, s, z = rp_trees.build_tree_order(
            jnp.asarray(nn_data), jnp.uint32(seed), 30, depth,
        )
        rand_scores.append(rp_trees.score_tree(o, s, z, idx))
    assert np.mean(hub_scores) > np.mean(rand_scores), (hub_scores, rand_scores)


def test_hub_vs_random_query_recall(nn_data):
    """Hub search trees must not lose to random search trees on query recall
    at equal epsilon, and must clear the reference 0.90 floor
    (reference tests/test_hub_trees.py:197-217)."""
    from pynndescent_tpu.ops import rp_trees

    train = nn_data[200:]
    queries = nn_data[:200]
    index = NNDescent(train, n_neighbors=10, random_state=42)
    index.prepare()
    nn = NearestNeighbors(n_neighbors=10).fit(train)
    true_idx = nn.kneighbors(queries, 10, return_distance=False)
    hub_idx, _ = index.query(queries, k=10, epsilon=0.1)
    hub_recall = _recall(hub_idx, true_idx)
    # swap in a random (non-hub) search tree of the same leaf size
    st_leaf = index.search_tree_leaf_size or max(index.leaf_size, index.n_neighbors)
    rand_tree = rp_trees.flatten_search_tree(
        index._X, 12345, leaf_size=st_leaf, angular=index._angular_trees
    )
    index._search_tree = rand_tree.to_arrays()
    rand_idx, _ = index.query(queries, k=10, epsilon=0.1)
    rand_recall = _recall(rand_idx, true_idx)
    assert hub_recall >= 0.90, f"hub recall {hub_recall}"
    assert hub_recall >= rand_recall - 0.005, (hub_recall, rand_recall)


def test_angular_hub_tree_query_recall():
    """Dense angular hub tree floor 0.90 (reference
    tests/test_hub_trees.py:219-239)."""
    rs = np.random.RandomState(42)
    data = rs.uniform(0, 1, size=(500, 20)).astype(np.float32)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    train, queries = data[100:], data[:100]
    index = NNDescent(train, metric="cosine", n_neighbors=15, random_state=42)
    idx, _ = index.query(queries, k=10, epsilon=0.2)
    nn = NearestNeighbors(metric="cosine").fit(train)
    true_idx = nn.kneighbors(queries, n_neighbors=10, return_distance=False)
    assert _recall(idx, true_idx) >= 0.90


def test_sparse_hub_tree_query_recall():
    """Sparse hub tree floor 0.85 (reference
    tests/test_hub_trees.py:241-262)."""
    rs = np.random.RandomState(42)
    X = sparse.random(500, 50, density=0.5, format="csr", dtype=np.float32,
                      random_state=rs)
    train, queries = X[100:], X[:100]
    index = NNDescent(train, metric="euclidean", n_neighbors=15, random_state=42)
    idx, _ = index.query(queries, k=10, epsilon=0.2)
    nn = NearestNeighbors().fit(train.toarray())
    true_idx = nn.kneighbors(queries.toarray(), n_neighbors=10, return_distance=False)
    assert _recall(idx, true_idx) >= 0.85


def test_bit_hub_tree_query_recall():
    """Bit-packed hub tree floor 0.70 at epsilon=0.3 (reference
    tests/test_hub_trees.py:287-324); exercises the edge-cut scored splits
    (reference rp_trees.py:1414-1431 — sparse/bit variants score by graph
    edge cuts, not balance)."""
    rs = np.random.RandomState(42)
    raw = rs.choice([0, 1], size=(500, 160), p=[0.55, 0.45]).astype(np.uint8)
    packed = np.packbits(raw, axis=1)
    train, queries = packed[100:], packed[:100]
    index = NNDescent(train, metric="bit_jaccard", n_neighbors=15, random_state=42)
    idx, _ = index.query(queries, k=10, epsilon=0.3)
    nn = NearestNeighbors(metric="jaccard").fit(raw[100:].astype(bool))
    true_idx = nn.kneighbors(raw[:100].astype(bool), n_neighbors=10,
                             return_distance=False)
    assert _recall(idx, true_idx) >= 0.70


def test_hub_tree_self_query(nn_data):
    """Self-queries must find the point itself (reference
    tests/test_hub_trees.py:327-388)."""
    index = NNDescent(nn_data[:500], n_neighbors=10, random_state=42)
    idx, dist = index.query(nn_data[:100], k=1, epsilon=0.1)
    assert np.mean(idx[:, 0] == np.arange(100)) >= 0.99
    # matmul-form sqeuclidean has ~1e-7 cancellation noise -> ~5e-4 after sqrt
    assert np.allclose(dist[:100, 0], 0.0, atol=2e-3)
