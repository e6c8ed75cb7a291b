"""Graph connectivity utilities (reference: graph_utils.py).

``adjacency_matrix_representation`` — symmetric sparse adjacency from a kNN
graph (reference graph_utils.py:168). ``connect_graph`` — add minimum-cost
edges so the kNN graph becomes a single connected component (reference
graph_utils.py:193), used by the UMAP ecosystem.

The reference finds an *approximate* minimum cross-component edge with a
bespoke bidirectional graph-informed beam search per component pair
(graph_utils.py:24-165) — the right call on a CPU, where exact pairwise
scans are expensive. On an accelerator blocked pairwise tiles are cheap
matrix products, so the edge is found **exactly**: every (block x block) tile of the
full cross-component distance matrix is streamed through the device with a
running (min, argmin) carried on device, and only the final winner is
pulled to the host (one round trip per component pair). Exact beats the
reference's approximation and is simpler.
"""

from __future__ import annotations

from itertools import combinations

import jax.numpy as jnp
import numpy as np
from scipy import sparse

from pynndescent_tpu.ops import distances as dst


def adjacency_matrix_representation(neighbor_indices, neighbor_distances):
    """Symmetrised sparse adjacency matrix from (indices, distances)
    (reference graph_utils.py:168)."""
    n, k = neighbor_indices.shape
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    cols = neighbor_indices.reshape(-1).astype(np.int64)
    vals = neighbor_distances.reshape(-1).astype(np.float32)
    ok = (cols >= 0) & np.isfinite(vals)
    result = sparse.coo_matrix(
        (vals[ok], (rows[ok], cols[ok])), shape=(n, n)
    ).tocsr()
    return result.maximum(result.T)


def _min_cross_edge(index, comp_a, comp_b, block=4096):
    """EXACT smallest-distance edge between two sets of vertex ids.

    Streams blocked pairwise tiles over the FULL member sets (no sampling
    cap); the running (min, i, j) lives on device so the whole scan costs a
    single host round trip regardless of tile count. Replaces the
    reference's approximate bidirectional beam search
    (find_component_connection_edge, graph_utils.py:123-165)."""
    data = index._raw_data
    metric = index._internal_metric
    kwds = index._internal_metric_kwds or {}
    a_ids = np.asarray(comp_a, np.int32)
    b_ids = np.asarray(comp_b, np.int32)
    best_val = jnp.asarray(np.inf, jnp.float32)
    best_i = jnp.asarray(-1, jnp.int32)
    best_j = jnp.asarray(-1, jnp.int32)
    for a0 in range(0, len(a_ids), block):
        ab = a_ids[a0 : a0 + block]
        Xa = jnp.asarray(data[ab])
        ab_dev = jnp.asarray(ab)
        for b0 in range(0, len(b_ids), block):
            bb = b_ids[b0 : b0 + block]
            D = dst.pairwise(metric, Xa, jnp.asarray(data[bb]), **kwds)
            D = jnp.where(jnp.isnan(D), jnp.inf, D.astype(jnp.float32))
            flat = jnp.argmin(D)
            v = D.reshape(-1)[flat]
            i = ab_dev[flat // D.shape[1]]
            j = jnp.asarray(bb)[flat % D.shape[1]]
            upd = v < best_val
            best_val = jnp.where(upd, v, best_val)
            best_i = jnp.where(upd, i, best_i)
            best_j = jnp.where(upd, j, best_j)
    d, i, j = (np.asarray(x) for x in (best_val, best_i, best_j))
    d = float(d)
    if index._distance_correction is not None:
        d = float(np.asarray(index._distance_correction(d)))
    return int(i), int(j), d


def connect_graph(graph, index, search_size=10, n_jobs=None, random_state=None):
    """Connect all components of the kNN adjacency by adding the exact
    minimum-cost edge between EVERY component pair (reference
    graph_utils.py:193-229 adds an approximate edge per pair; this build
    adds the true minimum per pair).

    ``search_size``/``n_jobs``/``random_state`` are accepted for signature
    parity; the exact scan needs no beam width, threads, or sampling."""
    n_components, labels = sparse.csgraph.connected_components(graph, directed=False)
    if n_components <= 1:
        return graph
    graph = graph.tolil()
    members = [np.nonzero(labels == c)[0] for c in range(n_components)]
    for c1, c2 in combinations(range(n_components), 2):
        i, j, d = _min_cross_edge(index, members[c1], members[c2])
        graph[i, j] = max(d, float(np.finfo(np.float32).eps))
        graph[j, i] = max(d, float(np.finfo(np.float32).eps))
    return graph.tocsr()
