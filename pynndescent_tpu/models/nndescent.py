"""NNDescent index — the public API layer.

Capability parity with the reference's ``NNDescent`` class
(``pynndescent_.py:792-2553``): constructor surface, data-dependent defaults,
fast-alternative metric substitution with final distance correction,
RP-forest-seeded graph build, diversified/pruned search-graph preparation,
epsilon-bounded queries, and (incrementally, across milestones) update(),
compress_index(), pickling, quantization, and the sparse path.

The orchestration is host Python; every hot stage is a jitted device program:
forest build (ops.rp_trees), descent (ops.nndescent), diversification
(ops.prune), and query search (models.search).
"""

from __future__ import annotations

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np

from pynndescent_tpu.ops import distances as dst
from pynndescent_tpu.ops import nndescent as nnd_ops
from pynndescent_tpu.ops import prune as prune_ops
from pynndescent_tpu.ops import rp_trees
from pynndescent_tpu.models import search as search_ops
from pynndescent_tpu.utils import rng


def _ts():
    import datetime

    return datetime.datetime.now().strftime("%a %b %d %H:%M:%S %Y")


def _check_finite(arr, name="data"):
    """Reject NaN/inf inputs like sklearn's check_array (reference routes all
    inputs through check_array, pynndescent_.py:1041-1057). Merge kernels
    treat NaN as +inf, so bad rows would otherwise silently degrade recall
    instead of erroring."""
    if np.issubdtype(np.asarray(arr).dtype, np.floating):
        if not np.all(np.isfinite(arr)):
            raise ValueError(
                f"Input {name} contains NaN or infinity; NNDescent requires "
                "finite values (matching sklearn check_array semantics)."
            )

# Exact-OT metric names routed through proxy build + exact host rerank
# (reference builds on them directly via numba network simplex,
# distances.py:1484-1598, :2103-2162 — untraceable under XLA).
_OT_EXACT_ROUTES = {
    "kantorovich": "proxy_kantorovich",
    "wasserstein": "proxy_kantorovich",
    "sinkhorn": "proxy_sinkhorn",
}

_ANGULAR_METRICS = (
    "cosine",
    "dot",
    "correlation",
    "dice",
    "jaccard",
    "hellinger",
    "hamming",
    "bit_hamming",
    "bit_jaccard",
)


def _resolve_mesh(devices):
    """Resolve the ``devices`` constructor kwarg to a jax.sharding.Mesh or
    None (single device). Accepts None, an int (first N of jax.devices()),
    a sequence of jax devices, or a Mesh."""
    if devices is None:
        return None
    from jax.sharding import Mesh

    if isinstance(devices, Mesh):
        return devices
    from pynndescent_tpu.parallel import mesh as mesh_mod

    if isinstance(devices, int):
        if devices <= 1:
            return None
        avail = len(jax.devices())
        if devices > avail:
            raise ValueError(f"devices={devices} but only {avail} available")
        return mesh_mod.make_mesh(devices)
    devs = list(devices)
    if len(devs) <= 1:
        return None
    return Mesh(np.array(devs), ("data",))


class NNDescent:
    """Approximate nearest neighbor index on a JAX device (reference:
    pynndescent_.py:976).

    Parameters mirror the reference's constructor; device tuning knobs
    (block_rows, beam_width) are additive.

    Compatibility no-ops — accepted for drop-in parity with the reference but
    intentionally without effect on the device execution model:

    * ``n_jobs``: XLA owns device/host threading; there is no thread pool to
      cap (reference maps this to numba.set_num_threads).
    * ``parallel_batch_queries``: queries are *always* batched in lockstep on
      the device; there is no serial query mode to parallelize.
    * ``low_memory``: the build is always the blocked, bounded-working-set
      formulation (the reference's high-memory mode trades RAM for speed in
      ways that do not apply to fixed-shape device programs).
    """

    def __init__(
        self,
        data,
        metric="euclidean",
        metric_kwds=None,
        bit_metric=False,
        n_neighbors=30,
        n_trees=None,
        angular_trees=False,
        leaf_size=None,
        pruning_degree_multiplier=1.5,
        diversify_prob=1.0,
        diversify_method="standard",
        degree_prune_aggressiveness=1.0,
        n_search_trees=1,
        search_tree_leaf_size=None,
        max_search_tree_depth=None,
        quantization=None,
        tree_init=True,
        init_graph=None,
        init_dist=None,
        random_state=None,
        low_memory=True,
        max_candidates=None,
        max_rptree_depth=200,
        n_iters=None,
        delta=0.001,
        n_jobs=None,
        compressed=False,
        parallel_batch_queries=False,
        verbose=False,
        *,
        block_rows=nnd_ops.DEFAULT_BLOCK_ROWS,
        beam_width=None,
        search_dtype="bfloat16",
        build_dtype=None,
        sparse_sketch="auto",
        locality="auto",
        profile=False,
        devices=None,
        shard_data=False,
    ):
        self.n_neighbors = n_neighbors
        self.metric = metric
        self.metric_kwds = dict(metric_kwds or {})
        self.bit_metric = bool(bit_metric)
        self.angular_trees = bool(angular_trees)
        self.pruning_degree_multiplier = pruning_degree_multiplier
        self.diversify_prob = diversify_prob
        self.diversify_method = diversify_method
        self.degree_prune_aggressiveness = degree_prune_aggressiveness
        self.n_search_trees = n_search_trees
        self.search_tree_leaf_size = search_tree_leaf_size
        self.max_search_tree_depth = max_search_tree_depth
        self.quantization = quantization
        self.max_rptree_depth = max_rptree_depth
        self.low_memory = low_memory
        self.delta = delta
        self.compressed = compressed
        self.parallel_batch_queries = parallel_batch_queries
        self.verbose = verbose
        self.random_state = random_state
        self.block_rows = block_rows
        self.beam_width = beam_width
        self.search_dtype = search_dtype
        self.build_dtype = build_dtype
        self.sparse_sketch = sparse_sketch
        # multi-device scale-out (the reference's n_jobs analog,
        # pynndescent_.py:1140-1143 -> a jax.sharding mesh axis): None = one
        # device; an int / device list / jax.sharding.Mesh shards the build's
        # vertex state over the mesh (parallel.mesh.sharded_nn_descent) and
        # serves query() with the query batch sharded
        # (parallel.mesh.sharded_search). ``shard_data=True`` additionally
        # row-shards X itself (> per-device-HBM datasets).
        self.devices = devices
        self.shard_data = bool(shard_data)
        self._mesh = _resolve_mesh(devices)
        # tree-order windowed descent at large n (ops.nndescent locality
        # phases): "auto" enables beyond 400k rows; None disables; a dict
        # sets {"window", "phases", "phase_iters", "global_iters"}
        self.locality = locality
        # structured phase timings (SURVEY §5): True records wall seconds
        # per build/prepare/query phase into ``phase_times_``; a directory
        # path additionally captures a jax.profiler trace of the build
        from pynndescent_tpu.utils.profiling import PhaseTimer

        self.profile = profile
        self._timer = PhaseTimer(profile)

        # dtype policy (reference pynndescent_.py:1041-1057): f32 C-order
        # dense (CSR densified — see ops.sparse), u8 for bit-packed metrics
        from pynndescent_tpu.ops import sparse as sparse_ops

        self._input_is_sparse = sparse_ops.is_sparse(data)
        self._ell = None
        self._sketch = None
        self._graph_exact = None
        if self._input_is_sparse:
            csr = data.tocsr()
            if csr.shape[1] > sparse_ops.DENSIFY_MAX_FEATURES:
                from pynndescent_tpu.ops import sparse_ell
                from pynndescent_tpu.ops import sketch as sketch_ops

                if metric == "dot":
                    csr = sparse_ops.l2_normalize_rows(csr)
                nnz_max = max(1, int(np.diff(csr.indptr).max()))
                sk = (
                    sketch_ops.resolve(
                        sparse_sketch, metric, csr.shape[1], csr.shape[0]
                    )
                    if quantization is None and isinstance(metric, str)
                    else None
                )
                if sk is not None:
                    # hashed-projection proxy build (ops/sketch.py): dense
                    # matmul pipeline over the sketch; exact ELL rows kept for
                    # reranking every distance the API returns. Jaccard-family
                    # metrics use a sign (1-bit) minhash instead: +-1 per
                    # min-wise hash, E[s_x . s_y] = D*J, internal metric
                    # euclidean — bf16-exact and matmul-native end to end.
                    self._ell_store = sparse_ell.csr_to_ell_packed(
                        csr, nnz_max
                    )
                    self._sketch = {
                        "kind": sk["kind"],
                        "encode": sk.get("encode"),
                        "h": sk["h"],
                        "internal": sk["internal"],
                        "binarize": sk["binarize"],
                        "seed": 0x5EED,
                        "nnz": nnz_max,
                        "n_features": csr.shape[1],
                    }
                    data = sketch_ops.sketch_rows(csr, self._sketch, 0x5EED)
                else:
                    # wide feature space: true sparse padded-ELL kernels
                    data = sparse_ell.csr_to_ell_packed(csr, nnz_max)
                    self._ell = {"nnz": nnz_max, "n_features": csr.shape[1]}
            else:
                data = sparse_ops.densify(data)
        self._is_bit = metric in ("bit_hamming", "bit_jaccard") or (
            callable(metric) and self.bit_metric
        )
        if self._is_bit:
            data = np.ascontiguousarray(np.asarray(data, dtype=np.uint8))
            self._input_dtype = np.uint8
        else:
            data = np.ascontiguousarray(np.asarray(data, dtype=np.float32))
            self._input_dtype = np.float32
            _check_finite(data, "data")
        if data.ndim != 2:
            # match sklearn check_array(ensure_2d=True), which the reference
            # routes every input through (pynndescent_.py:1041-1057)
            raise ValueError(
                f"Expected 2D array, got {data.ndim}D array instead. "
                "Reshape your data either using array.reshape(-1, 1) if it "
                "has a single feature or array.reshape(1, -1) if it "
                "contains a single sample."
            )
        n = data.shape[0]
        self.dim = data.shape[1]

        # data-dependent defaults (reference pynndescent_.py:1009-1012, :1135)
        if n_trees is None:
            n_trees = rp_trees.default_n_trees(n)
        if n_iters is None:
            n_iters = max(5, int(round(np.log2(max(n, 2)))))
        if max_candidates is None:
            max_candidates = min(60, n_neighbors)
        if leaf_size is None:
            leaf_size = rp_trees.default_leaf_size(n_neighbors)
        self.n_trees = n_trees
        self.n_iters = n_iters
        self.max_candidates = max_candidates
        self.leaf_size = leaf_size
        self.n_trees_after_update = max(2, int(round(n_trees / 3)))
        # sketch path: the hashed proxy's ordering is noisy near the top-k
        # boundary, so the internal graph is built 2x wide and exact-reranked
        # down to n_neighbors (the reference's proxy design over-fetches the
        # same way at query time, pynndescent_.py:2309-2312)
        self._build_k = (
            min(max(n - 1, 1), 2 * n_neighbors)
            if self._sketch is not None
            else n_neighbors
        )

        self._angular_trees = metric in _ANGULAR_METRICS or (
            callable(metric) and self.angular_trees
        )
        if self._sketch is not None and self._sketch["kind"] == "minhash":
            # minhash signatures split with plain (offset euclidean)
            # hyperplanes: sign vectors all share the same norm, so angular
            # normalization is a no-op at best; for legacy value signatures
            # it actively destroys the match structure
            self._angular_trees = False


        # metric resolution: substitute the order-preserving fast alternative
        # for build/search; correct distances on output
        # (reference _set_distance_func, pynndescent_.py:1271)
        self._set_distance_func()
        if self._ell is not None:
            if not isinstance(metric, str):
                raise NotImplementedError(
                    "custom callables are not supported on the padded-ELL sparse path"
                )
            if quantization is not None:
                raise NotImplementedError(
                    "quantization is not supported on the padded-ELL sparse "
                    "path (the reference's quantization is dense-only, "
                    "pynndescent_.py:2175)"
                )
            self._set_ell_metric()

        if metric == "dot" and self._ell is None:
            norms = np.linalg.norm(data, axis=1, keepdims=True)
            data = data / np.where(norms == 0.0, 1.0, norms)

        self._raw_data = data
        self._X = jnp.asarray(data)

        self._root_seed = rng.resolve_seed(random_state)
        self._key = rng.state_from_seed(self._root_seed)

        if init_graph is not None and tree_init:
            tree_init = False
        self.tree_init = tree_init and n_trees > 0

        # ---- build ----
        self._build_ctx = self._timer.trace()
        self._build_ctx.__enter__()
        forest = None
        if self.tree_init:
            if verbose:
                print("Building RP forest with", n_trees, "trees")
            with self._timer.phase("forest"):
                fkey = rng.derive(self._key, rng.ROLE_FOREST)
                seeds = jax.random.randint(
                    fkey, (n_trees,), 0, np.iinfo(np.int32).max, dtype=jnp.int32
                ).astype(jnp.uint32)
                # hyperplane splits don't need full precision — bf16 rows halve
                # the per-level gather traffic (distances stay f32 elsewhere);
                # bit-packed data splits by closest anchor under popcount; packed
                # ELL rows must stay exact f32 (they carry integer indices)
                if self._is_bit or self._ell is not None:
                    split_X = self._X
                else:
                    split_X = self._X.astype(jnp.bfloat16)
                forest = rp_trees.build_forest_orders(
                    split_X,
                    seeds,
                    leaf_size,
                    min(rp_trees.forest_depth(n, leaf_size), self.max_rptree_depth),
                    angular=self._angular_trees,
                    ell_nnz=self._ell["nnz"] if self._ell is not None else None,
                )
                self._timer.block(*jax.tree_util.tree_leaves(forest))

        init_state = None
        if init_graph is not None:
            from pynndescent_tpu.ops.neighbors import state_from_graph

            init_graph = np.asarray(init_graph, np.int32)
            if init_graph.shape[0] != n:
                raise ValueError("Init graph size does not match dataset size")
            if init_dist is None:
                init_dist = self._bulk_self_distances(init_graph)
            init_state = state_from_graph(
                jnp.asarray(init_graph), jnp.asarray(init_dist), k=self._build_k
            )

        if verbose:
            print(_ts(), "NN descent for", n_iters, "iterations")
        with self._timer.phase("descent"):
            if self._mesh is not None:
                if init_state is not None:
                    raise NotImplementedError(
                        "init_graph warm starts are not supported with "
                        "devices=/mesh builds yet"
                    )
                from pynndescent_tpu.parallel import mesh as mesh_mod

                dropped = [
                    name
                    for name, val, default in (
                        ("build_dtype", build_dtype, None),
                        ("block_rows", block_rows, nnd_ops.DEFAULT_BLOCK_ROWS),
                    )
                    if val != default
                ]
                if dropped:
                    warnings.warn(
                        f"devices=/mesh builds do not support {dropped} yet; "
                        "the options are ignored"
                    )
                idx, dist_internal = mesh_mod.sharded_nn_descent(
                    self._X,
                    self._build_k,
                    self._key,
                    self._mesh,
                    metric=self._internal_metric,
                    metric_kwds=self._internal_metric_kwds,
                    n_iters=n_iters,
                    delta=delta,
                    max_candidates=max_candidates,
                    forest=forest,
                    leaf_cap=min(leaf_size, 64),
                    shard_data=self.shard_data,
                    locality=self.locality,
                )
            else:
                mc = max_candidates
                if self._sketch is not None:
                    # sketch joins move [b, pool, D] tiles with D in the
                    # thousands — the candidate pool width multiplies that
                    # directly, and proxy noise makes the tail of a wide
                    # pool uninformative anyway. A trimmed pool keeps the
                    # graph navigable (query over-fetches + exact-reranks)
                    # at a fraction of the gather traffic.
                    mc = min(max_candidates, 12) if max_candidates else max_candidates
                idx, dist_internal = nnd_ops.nn_descent(
                    self._X,
                    self._build_k,
                    self._key,
                    metric=self._internal_metric,
                    metric_kwds=self._internal_metric_kwds,
                    n_iters=n_iters,
                    delta=delta,
                    max_candidates=mc,
                    init_graph=init_state,
                    forest=forest,
                    leaf_cap=min(leaf_size, 64),
                    block_rows=block_rows,
                    # sketch builds join in bfloat16: sign-minhash +-1 is
                    # EXACT in bf16, and the hash sketch's own estimator
                    # noise dwarfs bf16 rounding — half the gather traffic
                    # of the hottest loop for free (f32 rerank inside
                    # nn_descent keeps returned proxy distances exact)
                    compute_dtype=jnp.bfloat16
                    if build_dtype == "bfloat16" or self._sketch is not None
                    else None,
                    locality=self.locality,
                    verbose=verbose,
                )
            self._timer.block(idx, dist_internal)
        self._build_ctx.__exit__(None, None, None)
        self._build_ctx = None
        # keep the graph on device; host copies are materialized lazily on
        # first numpy access (neighbor_graph / update / pickle) — the eager
        # transfer was a multi-MB host pull on the build critical path
        self._neighbor_graph = (idx, dist_internal)
        self._incomplete_dev = jnp.any(jnp.asarray(idx) < 0)
        self._warned_incomplete = False

        self._search_graph = None
        self._search_tree = None
        self._visited = None

        if compressed:
            self.prepare()
            self.compress_index()

    # ------------------------------------------------------------------
    # metric plumbing
    # ------------------------------------------------------------------

    def _bulk_self_distances(self, idx):
        fn = nnd_ops._resolve_rowwise_metric(self._internal_metric, self._internal_metric_kwds)
        d = fn(self._X, self._X[jnp.maximum(jnp.asarray(idx), 0)])
        return np.where(idx < 0, np.inf, np.asarray(d))

    def _set_ell_metric(self):
        """Resolve the padded-ELL metric closure (rebuilt after unpickling —
        local closures are not picklable)."""
        from pynndescent_tpu.ops import sparse_ell

        nnz = self._ell["nnz"]
        alt = sparse_ell.ELL_ALTERNATIVES.get(self.metric)
        if alt is not None:
            self._ell_internal_name = alt[0]
            self._distance_correction = alt[1]
        else:
            self._ell_internal_name = self.metric
            self._distance_correction = None
        self._internal_metric = self._make_ell_closure(nnz, nnz)
        self._is_proxy = False

    def _make_ell_closure(self, nnz_x, nnz_y, name=None):
        """ELL metric closure for (x width, y width) packed operands; cached
        so jitted stages see a stable static identity across calls. ``name``
        overrides the internal metric name (the sketch path reranks with the
        TRUE metric, not the build-side alternative)."""
        from pynndescent_tpu.ops import sparse_ell

        cache = getattr(self, "_ell_metric_cache", None)
        if cache is None:
            cache = self._ell_metric_cache = {}
        if name is None:
            name = self._ell_internal_name
        meta = self._ell if self._ell is not None else self._sketch
        key = (name, nnz_x, nnz_y)
        if key not in cache:
            cache[key] = sparse_ell.make_ell_metric(
                name,
                nnz_x,
                nnz_y,
                n_features=meta["n_features"],
                **self.metric_kwds,
            )
        return cache[key]

    def _set_distance_func(self):
        """Registry lookup with fast-alternative / proxy substitution
        (reference _set_distance_func, pynndescent_.py:1271-1304)."""
        metric = self.metric
        self._distance_correction = None
        self._internal_metric_kwds = self.metric_kwds
        self._is_proxy = False
        self._true_metric = None
        if getattr(self, "_sketch", None) is not None:
            # hashed-sketch proxy: build/search under the dense metric of the
            # sketch space; every returned distance is ELL-exact-reranked
            metric = self._sketch["internal"]
            self._internal_metric_kwds = {}
        if callable(metric):
            self._internal_metric = metric
        elif metric in _OT_EXACT_ROUTES:
            # Exact-OT names build and search on their cheap jittable proxy
            # and exact-rerank on the host (the reference builds directly on
            # the numba network-simplex metric, distances.py:1484-1598; that
            # function cannot trace inside an XLA join, so here the proxy +
            # exact-rerank machinery carries the same user-facing contract).
            # metric_kwds (cost matrix, regularization) apply only to the
            # exact metric — the proxy takes none.
            entry = dst.proxy_distances[_OT_EXACT_ROUTES[metric]]
            self._internal_metric = entry["proxy_dist"]
            self._true_metric = entry["true_dist"]
            self._is_proxy = True
            self._internal_metric_kwds = {}
        elif metric in dst.proxy_distances:
            entry = dst.proxy_distances[metric]
            self._internal_metric = entry["proxy_dist"]
            self._true_metric = entry["true_dist"]
            self._is_proxy = True
        elif metric in dst.fast_distance_alternatives:
            entry = dst.fast_distance_alternatives[metric]
            self._internal_metric = entry["pairwise"] or entry["dist"]
            self._distance_correction = entry["correction"]
        elif metric in dst.named_distances:
            self._internal_metric = metric
        else:
            raise ValueError(f"Metric '{metric}' not recognized")

    def _maybe_warn_incomplete(self, flag=None):
        """Emit the incomplete-rows warning once; ``flag`` lets callers pass
        an already-pulled host bool so no extra round trip is paid."""
        if getattr(self, "_warned_incomplete", True):
            return
        if flag is None:
            flag = bool(np.asarray(self._incomplete_dev))
        self._warned_incomplete = True
        if flag:
            warnings.warn(
                "Failed to correctly find n_neighbors for some samples. "
                "Results may be less than ideal. Try re-running with "
                "different parameters."
            )

    def _graph_host(self):
        """Numpy view of the neighbor graph; transfers from device once and
        caches (the tuple is replaced in place by its host copy)."""
        if self._neighbor_graph is None:
            return None
        idx, d = self._neighbor_graph
        if not isinstance(idx, np.ndarray):
            self._neighbor_graph = (np.asarray(idx), np.asarray(d))
        return self._neighbor_graph

    @property
    def neighbor_graph(self):
        """(indices, distances) with corrected (true-metric) distances
        (reference pynndescent_.py:2145)."""
        if self._neighbor_graph is None:
            warnings.warn("The index is compressed; neighbor graph is not available.")
            return None
        self._maybe_warn_incomplete()
        idx, d = self._graph_host()
        if self._sketch is not None:
            return self._exact_graph()
        if isinstance(self.metric, str) and self.metric in _OT_EXACT_ROUTES:
            return self._exact_ot_graph()
        if self._distance_correction is not None:
            d = self._distance_correction(d)
        return idx, np.asarray(d)

    def _exact_ot_graph(self):
        """Exact-OT routed metrics: the internal graph ranks by the cheap
        proxy; the API-visible graph recomputes each edge with the exact
        host metric and reorders rows by true distance (same contract the
        reference gets by building directly on the exact metric)."""
        cached = getattr(self, "_graph_exact_ot", None)
        if cached is None:
            idx, _ = self._graph_host()
            true_metric = self._true_metric
            X = self._raw_data
            d = np.full(idx.shape, np.inf, np.float64)
            for i in range(idx.shape[0]):
                for j, c in enumerate(idx[i]):
                    if c >= 0:
                        d[i, j] = true_metric(X[i], X[c], **self.metric_kwds)
            order = np.argsort(d, axis=1)
            rows = np.arange(idx.shape[0])[:, None]
            cached = self._graph_exact_ot = (
                idx[rows, order],
                d[rows, order].astype(np.float32),
            )
        return cached

    def _ell_store_device(self):
        dev = getattr(self, "_ell_store_dev", None)
        if dev is None:
            dev = self._ell_store_dev = jnp.asarray(self._ell_store)
        return dev

    def _exact_graph(self):
        """Sketch path: the internal graph ranks by sketch distance over a
        2x-overfetched candidate set (_build_k); the API-visible graph
        reranks each row exactly from the packed ELL rows and keeps the
        true top n_neighbors (one [n, k_build] pair pass — off the build
        hot path)."""
        if self._graph_exact is None:
            idx, _ = self._graph_host()
            nnz = self._sketch["nnz"]
            fn = nnd_ops._resolve_rowwise_metric(
                self._make_ell_closure(nnz, nnz, name=self.metric), None
            )
            ell = self._ell_store_device()
            out_i, out_d = [], []
            b = 16384
            for s in range(0, idx.shape[0], b):
                ri, rd = _jit_rerank(
                    ell[s : s + b],
                    jnp.asarray(idx[s : s + b]),
                    ell,
                    dist_rowwise=fn,
                    k=min(self.n_neighbors, idx.shape[1]),
                )
                out_i.append(np.asarray(ri))
                out_d.append(np.asarray(rd))
            self._graph_exact = (
                np.concatenate(out_i, 0),
                np.concatenate(out_d, 0),
            )
        return self._graph_exact

    # ------------------------------------------------------------------
    # prepare: diversified, degree-pruned search graph + search tree
    # ------------------------------------------------------------------

    def prepare(self):
        """Build the search graph, search tree and (optionally) quantized
        codes (reference: prepare, pynndescent_.py:2174 /
        _init_search_graph :1333)."""
        if self._search_graph is not None:
            return
        idx, dist = self._neighbor_graph
        n, k = idx.shape
        deg_max = max(1, int(round(self.pruning_degree_multiplier * self.n_neighbors)))
        rev_cap = max(2 * deg_max, 16)
        metric = self._internal_metric
        metric_kwds = self._internal_metric_kwds
        prune_prob = self.diversify_prob
        aggression = self.degree_prune_aggressiveness
        degree_aware = self.diversify_method == "degree_aware"
        div_key = rng.derive(self._key, rng.ROLE_SEARCH, 7)

        from pynndescent_tpu.ops.neighbors import make_neighbor_state, merge_candidates

        @jax.jit
        def _assemble(idx, dist, X, key):
            row_ids = jnp.arange(n, dtype=jnp.int32)[:, None]
            degrees = prune_ops.compute_degrees(idx) if degree_aware else None
            # forward diversify (self edges at distance ~0 never occlude and
            # are dropped from the rows here); degree-aware variant relaxes
            # the occlusion threshold for hub targets (reference :433)
            keep_fwd = prune_ops.diversify_all(
                idx, dist, X, metric, metric_kwds, prune_prob, key,
                degrees=degrees, aggression=aggression,
            )
            fwd_idx = jnp.where(keep_fwd & (idx >= 0) & (idx != row_ids), idx, -1)
            fwd_dist = jnp.where(fwd_idx >= 0, dist, jnp.inf)
            # reverse rows = transpose of the diversified forward graph
            rev_idx, rev_dist = prune_ops.reverse_topk(fwd_idx, fwd_dist, rev_cap)
            keep_rev = prune_ops.diversify_all(
                rev_idx, rev_dist, X, metric, metric_kwds, prune_prob,
                jax.random.fold_in(key, 1),
                degrees=degrees, aggression=aggression,
            )
            rev_idx = jnp.where(keep_rev, rev_idx, -1)
            rev_dist = jnp.where(rev_idx >= 0, rev_dist, jnp.inf)
            # union forward + reverse per row, keep the deg_max closest
            # (merge maximum + degree_prune, reference :1595-1609)
            state = make_neighbor_state(n, deg_max)
            state, _ = merge_candidates(state, fwd_idx, fwd_dist)
            state, _ = merge_candidates(state, rev_idx, rev_dist)
            min_dist = jnp.min(jnp.where(jnp.isfinite(state.dist), state.dist, jnp.inf))
            # bundle every host-bound scalar into one array: one transfer
            # and one sync instead of one per scalar
            scalars = jnp.stack([
                jnp.where(jnp.isfinite(min_dist), min_dist, 0.0),
                jnp.any(idx < 0).astype(jnp.float32),
            ])
            return state.idx, scalars

        if self.verbose:
            print(_ts(), "Building and diversifying the search graph")
        with self._timer.phase("prepare/diversify"):
            adj, scalars = _assemble(
                jnp.asarray(idx), jnp.asarray(dist), self._X, div_key
            )
            self._timer.block(adj)
        if self.verbose:
            deg = np.asarray(jnp.sum(adj >= 0, axis=1))
            print(
                _ts(),
                f"Search graph: mean degree {deg.mean():.1f}, max {deg.max()}",
            )
        scalars = np.asarray(scalars)
        self._min_distance = float(scalars[0])
        self._maybe_warn_incomplete(bool(scalars[1]))
        self._search_graph = adj
        self._init_quantization()
        # bfloat16 copy for search gathers (halved HBM traffic); results are
        # exact-reranked in query(). Disabled for bit/quantized data, and for
        # legacy VALUE-encoded minhash signatures: their hamming proxy is an
        # exact-compare over 24-bit hash values stored as f32 — rounding the
        # stored copy to bfloat16 while the query signatures stay exact means
        # a true match almost never compares equal, so every proxy distance
        # saturates at ~1.0 and the beam search goes blind. The sign
        # encoding is +-1 and therefore bf16-EXACT — it keeps the copy.
        if (
            self.search_dtype == "bfloat16"
            and not self._is_bit
            and self.quantization is None
            and self._ell is None  # packed indices must stay exact f32
            and not (
                self._sketch is not None
                and self._sketch["kind"] == "minhash"
                and self._sketch.get("encode", "value") == "value"
            )
        ):
            self._X_search = self._X.astype(jnp.bfloat16)
        else:
            self._X_search = None

        # search tree: graph-informed scored hub splits (reference
        # make_hub_tree, rp_trees.py:1233; bit-packed data splits by closest
        # anchor under popcount, like make_bit_hub_tree :2111). When
        # n_search_trees > 1, that many candidate trees are built and the one
        # whose leaves capture the most true neighbor pairs wins (reference
        # pynndescent_.py:1353-1373 + score_linked_tree).
        idx0, _ = self._neighbor_graph
        degrees_dev = prune_ops.compute_degrees(jnp.asarray(idx0))
        st_leaf_size = self.search_tree_leaf_size or max(
            self.leaf_size, self.n_neighbors
        )
        st_depth = self.max_search_tree_depth or rp_trees.forest_depth(
            self._X.shape[0], st_leaf_size
        )
        ell_nnz = self._ell["nnz"] if self._ell is not None else None
        # sparse/bit hub splits are scored by graph edge cuts (reference
        # rp_trees.py:1414-1431); dense uses balance and ignores the graph
        nb_idx = (
            jnp.asarray(idx0)
            if (ell_nnz is not None or self._is_bit)
            else None
        )
        n_cand = max(1, int(self.n_search_trees))
        # host-side seed derivation: a device randint would cost a round trip
        # just to read the ints back
        cand_seeds = rng.host_ints(self._root_seed, rng.ROLE_SEARCH, n_cand)
        seed = cand_seeds[0]
        if n_cand > 1:
            best_score = -1.0
            for cand in cand_seeds:
                o, s, z = rp_trees.build_tree_order(
                    self._X, jnp.uint32(cand), st_leaf_size, st_depth,
                    angular=self._angular_trees, ell_nnz=ell_nnz,
                    degrees=degrees_dev, neighbor_idx=nb_idx,
                )
                sc = rp_trees.score_tree(o, s, z, idx0)
                if self.verbose:
                    print(_ts(), f"search-tree candidate seed {cand}: score {sc:.4f}")
                if sc > best_score:
                    best_score, seed = sc, cand
        with self._timer.phase("prepare/search_tree"):
            tree = rp_trees.flatten_search_tree(
                self._X,
                seed,
                leaf_size=st_leaf_size,
                max_depth=st_depth,
                angular=self._angular_trees,
                materialize=self.quantization is not None,
                degrees=degrees_dev,
                ell_nnz=ell_nnz,
                neighbor_idx=nb_idx,
            )
            self._search_tree = tree.to_arrays()

    def _init_quantization(self):
        """Compress the data and swap in the asymmetric quantized search
        distance (reference pynndescent_.py:2175-2263)."""
        if self.quantization is None:
            self._quantized = None
            return
        from pynndescent_tpu.ops import quantization as qz

        # Derive the codebook seed from the root seed: deterministic for int
        # seeds AND RandomState instances (the root captured the instance's
        # draw once at __init__; passing the instance through here would make
        # codebooks depend on how much of the generator was consumed since).
        seed = rng.host_ints(self._root_seed, rng.ROLE_QUANTIZE, 1)[0]
        rs = np.random.RandomState(seed)
        if self.quantization == "binary":
            codes = qz.binary_codes(self._raw_data)
            self._quantized = {"mode": "binary", "codes": codes}
        elif self.quantization == "uint8":
            codebook = qz.uint8_codebook(self._raw_data, rs)
            codes = qz.uint8_codes(self._raw_data, codebook)
            self._quantized = {"mode": "uint8", "codes": codes, "codebook": codebook}
        elif self.quantization == "uint4":
            codebook = qz.uint4_codebook(self._raw_data, rs)
            codes = qz.uint4_codes(self._raw_data, codebook)
            self._quantized = {"mode": "uint4", "codes": codes, "codebook": codebook}
        else:
            raise ValueError(f"Unknown quantization '{self.quantization}'")
        self._quantized_rowwise = self._build_quantized_fn()
        self._quantized_codes_dev = jnp.asarray(self._quantized["codes"])

    def _build_quantized_fn(self):
        """Rebuild the quantized search-distance closure from the stored
        mode/codebook (also used after unpickling)."""
        from pynndescent_tpu.ops import quantization as qz

        mode = self._quantized["mode"]
        if mode == "binary":
            return qz.make_binary_rowwise(self.metric)
        if mode == "uint8":
            return qz.make_uint8_rowwise(self.metric, self._quantized["codebook"])
        return qz.make_uint4_rowwise(self.metric, self._quantized["codebook"], self.dim)

    # ------------------------------------------------------------------
    # query
    # ------------------------------------------------------------------

    def query(self, query_data, k=10, epsilon=0.1, proxy_beam_size=4,
              expansions_per_step=2):
        """k nearest neighbors of each query point (reference: query,
        pynndescent_.py:2275). Returns (indices, distances).

        Proxy and quantized metrics over-fetch ``proxy_beam_size * k``
        candidates and rerank with the true metric (reference :2309-2312,
        rerank :775). ``expansions_per_step`` sets how many beam vertices
        expand per lockstep search step (more = fewer, bigger steps; the
        recall floors are tuned at 2)."""
        self.prepare()
        with self._timer.phase("query"):
            out = self._query_impl(query_data, k, epsilon, proxy_beam_size,
                                   expansions_per_step)
            self._timer.block(*out)
        return out

    @property
    def phase_times_(self):
        """Dict of accumulated wall seconds per phase (forest, descent,
        prepare/diversify, prepare/search_tree, query). Populated only when
        the index was constructed with ``profile=`` truthy."""
        return dict(self._timer.times)

    def _query_impl(self, query_data, k, epsilon, proxy_beam_size,
                    expansions_per_step=2):
        from pynndescent_tpu.ops import sparse as sparse_ops

        ell_query_nnz = None
        sketch_q_ell = None
        if self._sketch is not None:
            if not sparse_ops.is_sparse(query_data):
                raise ValueError(
                    "this index was built on sparse data; queries must be "
                    "scipy sparse matrices"
                )
            from pynndescent_tpu.ops import sparse_ell
            from pynndescent_tpu.ops import sketch as sketch_ops

            qcsr = query_data.tocsr()
            if qcsr.shape[1] != self._sketch["n_features"]:
                raise ValueError(
                    f"query data has {qcsr.shape[1]} features but the "
                    f"index was built with {self._sketch['n_features']}"
                )
            if self.metric == "dot":
                qcsr = sparse_ops.l2_normalize_rows(qcsr)
            # exact rows packed at the queries' own width for the rerank;
            # the search itself runs on the dense sketch of the queries
            nnz = self._sketch["nnz"]
            q_max = int(np.diff(qcsr.indptr).max(initial=1))
            qnnz = nnz if q_max <= nnz else 1 << (q_max - 1).bit_length()
            sketch_q_ell = (sparse_ell.csr_to_ell_packed(qcsr, qnnz), qnnz)
            query_data = sketch_ops.sketch_rows(
                qcsr, self._sketch, self._sketch["seed"]
            )
        elif sparse_ops.is_sparse(query_data):
            if self._ell is not None:
                from pynndescent_tpu.ops import sparse_ell

                qcsr = query_data.tocsr()
                if self.metric == "dot":
                    qcsr = sparse_ops.l2_normalize_rows(qcsr)
                # queries pack at their OWN width: rows wider than the train
                # nnz watermark are never truncated; the asymmetric metric
                # closure handles mixed widths. Bucket to the train width or
                # the next power of two so repeated query batches reuse the
                # compiled search program.
                if qcsr.shape[1] != self._ell["n_features"]:
                    raise ValueError(
                        f"query data has {qcsr.shape[1]} features but the "
                        f"index was built with {self._ell['n_features']}"
                    )
                nnz = self._ell["nnz"]
                q_max = int(np.diff(qcsr.indptr).max(initial=1))
                if q_max <= nnz:
                    ell_query_nnz = nnz
                else:
                    ell_query_nnz = 1 << (q_max - 1).bit_length()
                query_data = sparse_ell.csr_to_ell_packed(qcsr, ell_query_nnz)
            else:
                query_data = sparse_ops.densify(query_data)
        elif self._ell is not None:
            raise ValueError(
                "this index was built on sparse (padded-ELL) data; queries "
                "must be scipy sparse matrices"
            )
        # Device fast path: dense float queries already on device skip the
        # host round-trip entirely (pull + re-upload of the batch). The
        # finite-check result is pulled AFTER the search is dispatched so
        # its round-trip overlaps device compute; queries are sanitized
        # first so a NaN can't stall the search while_loop.
        finite_flag = None
        dense_device = (
            isinstance(query_data, jax.Array)
            and query_data.ndim in (1, 2)
            and self._ell is None
            and self._sketch is None
            and not self._is_bit
            and not (
                self._quantized is not None
                and self._quantized["mode"] == "binary"
            )
        )
        if dense_device:
            q = query_data.astype(jnp.float32)
            if q.ndim == 1:
                q = q.reshape(1, -1)
            expected_dim = self._raw_data.shape[1]
            if q.shape[1] != expected_dim:
                raise ValueError(
                    f"query data has {q.shape[1]} features but the index was "
                    f"built with {expected_dim}"
                )
            finite_flag = jnp.all(jnp.isfinite(q))
            q = jnp.where(jnp.isfinite(q), q, 0.0)
            if self.metric in ("cosine", "dot"):
                norms = jnp.linalg.norm(q, axis=1, keepdims=True)
                q = q / jnp.where(norms == 0.0, 1.0, norms)
        else:
            qdtype = np.uint8 if self._is_bit else np.float32
            q = np.ascontiguousarray(np.asarray(query_data, qdtype))
            if q.ndim == 1:
                q = q.reshape(1, -1)
            _check_finite(q, "query data")
            if self._ell is None:
                expected_dim = self._raw_data.shape[1]
                if q.shape[1] != expected_dim:
                    raise ValueError(
                        f"query data has {q.shape[1]} features but the index "
                        f"was built with {expected_dim}"
                    )
            if self.metric in ("cosine", "dot") and self._ell is None:
                norms = np.linalg.norm(q, axis=1, keepdims=True)
                q = q / np.where(norms == 0.0, 1.0, norms)

        use_bf16 = getattr(self, "_X_search", None) is not None and not self._is_bit
        is_proxy = (
            self._is_proxy
            or self._quantized is not None
            or self._sketch is not None
        )
        if is_proxy:
            search_k = proxy_beam_size * k
            if self._sketch is not None:
                # sketches are the noisiest proxies (hash: JL collision
                # noise; minhash: variance (1-J^2)/D at the tiny J real
                # corpora have). The 50k TF-IDF probe needs ~top-60 proxy
                # candidates to cover >=0.97 of the true top-10, so floor
                # the over-fetch at 6k; the rerank is ELL-exact either way
                search_k = max(search_k, 6 * k)
        elif use_bf16 or self._ell is not None:
            # modest over-fetch: the bf16 beam may mis-rank near-ties (exact
            # rerank below recovers them); on the exact ELL path the wider
            # result set loosens the ε-bound d_k, matching the effective
            # exploration of the dense path — the extra entries are dropped
            search_k = max(k + k // 2, k + 2)
        else:
            search_k = k
        tree_queries = None
        min_distance = self._min_distance
        if self._quantized is not None:
            cand_X = self._quantized_codes_dev
            dist_rowwise = self._quantized_rowwise
            tree_queries = q
            if self._quantized["mode"] == "binary":
                search_q = np.packbits((q > 0).astype(np.uint8), axis=1)
            else:
                search_q = q
            min_distance = 0.0
        elif use_bf16:
            cand_X = self._X_search
            dist_rowwise = nnd_ops._resolve_rowwise_metric(
                self._internal_metric, self._internal_metric_kwds,
                cast_candidates_f32=True,
            )
            search_q = q
        elif self._ell is not None:
            cand_X = self._X
            dist_rowwise = nnd_ops._resolve_rowwise_metric(
                self._make_ell_closure(ell_query_nnz, self._ell["nnz"]), None
            )
            search_q = q
        else:
            cand_X = self._X
            dist_rowwise = nnd_ops._resolve_rowwise_metric(
                self._internal_metric, self._internal_metric_kwds
            )
            search_q = q

        beam = self.beam_width or max(2 * search_k, 48)
        # single upload: queries go to the device once; search results stay
        # on device when a rerank follows (no host round-trip in between)
        q_dev = jnp.asarray(q)
        search_q_dev = q_dev if search_q is q else jnp.asarray(search_q)
        tree_q_dev = None
        if tree_queries is not None:
            tree_q_dev = q_dev if tree_queries is q else jnp.asarray(tree_queries)
        rerank_needed = is_proxy or use_bf16
        ell_widths = (
            (ell_query_nnz, self._ell["nnz"]) if self._ell is not None else None
        )
        if self._mesh is not None:
            # data-parallel serving: the query batch shards over the mesh,
            # the index (graph + tree + data) replicates (parallel.mesh)
            from pynndescent_tpu.parallel import mesh as mesh_mod

            idx, d = mesh_mod.sharded_search(
                search_q_dev,
                cand_X,
                self._search_graph,
                self._search_tree,
                rng.derive(self._key, rng.ROLE_SEARCH, 2),
                self._mesh,
                k=search_k,
                epsilon=epsilon,
                min_distance=min_distance,
                beam_width=beam,
                dist_rowwise=dist_rowwise,
                tree_queries=tree_q_dev,
                ell=ell_widths,
                expansions_per_step=int(expansions_per_step),
            )
        else:
            idx, d = search_ops.search(
                search_q_dev,
                cand_X,
                self._search_graph,
                self._search_tree,
                rng.derive(self._key, rng.ROLE_SEARCH, 2),
                k=search_k,
                epsilon=epsilon,
                min_distance=min_distance,
                beam_width=beam,
                dist_rowwise=dist_rowwise,
                tree_queries=tree_q_dev,
                ell=ell_widths,
                expansions_per_step=int(expansions_per_step),
                return_device=rerank_needed,
            )
        if rerank_needed:
            idx, d = self._rerank(q_dev, idx, k, ell_queries=sketch_q_ell)
        else:
            idx, d = idx[:, :k], d[:, :k]
            if self._distance_correction is not None:
                d = self._distance_correction(d)
        if finite_flag is not None and not bool(finite_flag):
            raise ValueError(
                "Input query data contains NaN or infinity; NNDescent "
                "requires finite values (matching sklearn check_array "
                "semantics)."
            )
        return idx, d

    def _rerank(self, queries, cand_idx, k, ell_queries=None):
        """Recompute true distances on the over-fetched candidate set and
        keep the top k (reference: rerank, pynndescent_.py:775-789)."""
        if ell_queries is not None:
            # sketch path: exact sparse rerank against the packed ELL rows
            q_ell, qnnz = ell_queries
            fn = nnd_ops._resolve_rowwise_metric(
                self._make_ell_closure(
                    qnnz, self._sketch["nnz"], name=self.metric
                ),
                None,
            )
            ridx, rd = _jit_rerank(
                jnp.asarray(q_ell),
                jnp.asarray(cand_idx),
                self._ell_store_device(),
                dist_rowwise=fn,
                k=k,
            )
            return np.asarray(ridx), np.asarray(rd)
        true_metric = self._true_metric if self._is_proxy else None
        if true_metric is None:
            # quantized index: the true metric is the user's original metric
            true_metric = dst.named_distances[self.metric] if isinstance(self.metric, str) else self.metric

        name = getattr(true_metric, "__name__", "")
        if name in ("kantorovich", "sinkhorn"):
            # host metrics: evaluate exactly on CPU (reference treats these
            # as expensive exact metrics behind proxies)
            queries = np.asarray(queries)
            cand_idx = np.asarray(cand_idx)
            d = np.full(cand_idx.shape, np.inf, np.float64)
            for i in range(cand_idx.shape[0]):
                for j, c in enumerate(cand_idx[i]):
                    if c >= 0:
                        d[i, j] = true_metric(
                            queries[i], self._raw_data[c], **self.metric_kwds
                        )
            order = np.argsort(d, axis=1)[:, :k]
            rows = np.arange(cand_idx.shape[0])[:, None]
            return cand_idx[rows, order], d[rows, order].astype(np.float32)
        fn = nnd_ops._resolve_rowwise_metric(true_metric, self.metric_kwds)
        ridx, rd = _jit_rerank(
            jnp.asarray(queries, jnp.float32),
            jnp.asarray(cand_idx),
            self._X,
            dist_rowwise=fn,
            k=k,
        )
        return np.asarray(ridx), np.asarray(rd)

    # ------------------------------------------------------------------

    def compress_index(self):
        """Drop build-side structures to shrink the serialized index
        (reference pynndescent_.py:2160)."""
        self.prepare()
        self.compressed = True
        self._neighbor_graph = None

    # ------------------------------------------------------------------
    # incremental update (reference pynndescent_.py:2381)
    # ------------------------------------------------------------------

    def update(self, xs_fresh=None, xs_updated=None, updated_indices=None):
        """Update the index with fresh rows and/or in-place row overwrites,
        then re-run descent seeded from the previous graph with a smaller
        forest (reference: NNDescent.update, pynndescent_.py:2381-2553)."""
        if self._neighbor_graph is None:
            raise ValueError("Cannot update a compressed index")
        if self._ell is not None:
            # append-only, like the reference's sparse update
            # (pynndescent_.py:2412, :2495-2496 rejects in-place mutation)
            if xs_updated is not None:
                raise NotImplementedError(
                    "in-place updates are not supported on sparse indexes "
                    "(reference pynndescent_.py:2412); append-only updates "
                    "(xs_fresh) are"
                )
            if xs_fresh is not None:
                from pynndescent_tpu.ops import sparse as sparse_ops
                from pynndescent_tpu.ops import sparse_ell

                if not sparse_ops.is_sparse(xs_fresh):
                    raise ValueError(
                        "xs_fresh must be a scipy sparse matrix for an index "
                        "built on sparse data"
                    )
                fcsr = xs_fresh.tocsr()
                if fcsr.shape[1] != self._ell["n_features"]:
                    raise ValueError(
                        f"xs_fresh has {fcsr.shape[1]} features but the index "
                        f"was built with {self._ell['n_features']}"
                    )
                _check_finite(fcsr.data, "xs_fresh")
                if self.metric == "dot":
                    fcsr = sparse_ops.l2_normalize_rows(fcsr)
                new_nnz = max(
                    self._ell["nnz"], int(np.diff(fcsr.indptr).max(initial=1))
                )
                if new_nnz > self._ell["nnz"]:
                    # fresh rows raise the row-width watermark: re-pad the
                    # stored rows and rebuild the metric closures
                    self._raw_data = sparse_ell.ell_repack(
                        self._raw_data, self._ell["nnz"], new_nnz
                    )
                    self._ell["nnz"] = new_nnz
                    self._set_ell_metric()
                xs_fresh = sparse_ell.csr_to_ell_packed(fcsr, new_nnz)
        elif self._sketch is not None:
            # sketch path: append-only like the ELL path; fresh rows are
            # ELL-packed into the exact store AND sketched into the dense
            # build space
            if xs_updated is not None:
                raise NotImplementedError(
                    "in-place updates are not supported on sparse indexes "
                    "(reference pynndescent_.py:2412); append-only updates "
                    "(xs_fresh) are"
                )
            if xs_fresh is not None:
                from pynndescent_tpu.ops import sparse as sparse_ops
                from pynndescent_tpu.ops import sparse_ell
                from pynndescent_tpu.ops import sketch as sketch_ops

                if not sparse_ops.is_sparse(xs_fresh):
                    raise ValueError(
                        "xs_fresh must be a scipy sparse matrix for an index "
                        "built on sparse data"
                    )
                fcsr = xs_fresh.tocsr()
                if fcsr.shape[1] != self._sketch["n_features"]:
                    raise ValueError(
                        f"xs_fresh has {fcsr.shape[1]} features but the index "
                        f"was built with {self._sketch['n_features']}"
                    )
                _check_finite(fcsr.data, "xs_fresh")
                if self.metric == "dot":
                    fcsr = sparse_ops.l2_normalize_rows(fcsr)
                new_nnz = max(
                    self._sketch["nnz"],
                    int(np.diff(fcsr.indptr).max(initial=1)),
                )
                if new_nnz > self._sketch["nnz"]:
                    self._ell_store = np.asarray(
                        sparse_ell.ell_repack(
                            self._ell_store, self._sketch["nnz"], new_nnz
                        )
                    )
                    self._sketch["nnz"] = new_nnz
                self._ell_store = np.vstack(
                    [
                        np.asarray(self._ell_store),
                        np.asarray(sparse_ell.csr_to_ell_packed(fcsr, new_nnz)),
                    ]
                )
                self._ell_store_dev = None
                xs_fresh = sketch_ops.sketch_rows(
                    fcsr, self._sketch, self._sketch["seed"]
                )
        data = self._raw_data
        idx, dist = self._graph_host()
        n_old, k = idx.shape

        if xs_updated is not None:
            # coerce to the index's input dtype: uint8 rows for bit metrics
            # would be silently corrupted by a float32 cast
            xs_updated = np.ascontiguousarray(np.asarray(xs_updated, self._input_dtype))
            _check_finite(xs_updated, "xs_updated")
            updated_indices = np.asarray(updated_indices, np.int64)
            if self.metric == "dot":
                norms = np.linalg.norm(xs_updated, axis=1, keepdims=True)
                xs_updated = xs_updated / np.where(norms == 0.0, 1.0, norms)
            data = data.copy()
            data[updated_indices] = xs_updated
            # invalidate graph entries referencing (or owned by) updated rows
            touched = np.zeros(n_old + 1, bool)
            touched[updated_indices] = True
            entry_touched = touched[np.maximum(idx, 0)] | touched[
                np.arange(n_old, dtype=np.int64), None
            ]
            idx = np.where(entry_touched, -1, idx)
            dist = np.where(entry_touched, np.inf, dist).astype(np.float32)

        if xs_fresh is not None:
            xs_fresh = np.ascontiguousarray(np.asarray(xs_fresh, self._input_dtype))
            _check_finite(xs_fresh, "xs_fresh")
            if self.metric == "dot" and self._ell is None:
                norms = np.linalg.norm(xs_fresh, axis=1, keepdims=True)
                xs_fresh = xs_fresh / np.where(norms == 0.0, 1.0, norms)
            data = np.vstack([data, xs_fresh])
            idx = np.vstack([idx, np.full((len(xs_fresh), k), -1, np.int32)])
            dist = np.vstack(
                [dist, np.full((len(xs_fresh), k), np.inf, np.float32)]
            ).astype(np.float32)

        self._raw_data = data
        self._X = jnp.asarray(data)
        n = data.shape[0]

        # shrunken forest (reference: n_trees_after_update, :1016, :2498)
        self._key = rng.derive(self._key, rng.ROLE_UPDATE)
        fkey = rng.derive(self._key, rng.ROLE_FOREST)
        seeds = jax.random.randint(
            fkey, (self.n_trees_after_update,), 0, np.iinfo(np.int32).max, dtype=jnp.int32
        ).astype(jnp.uint32)
        if self._is_bit or self._ell is not None:
            split_X = self._X
        else:
            split_X = self._X.astype(jnp.bfloat16)
        forest = rp_trees.build_forest_orders(
            split_X,
            seeds,
            self.leaf_size,
            min(rp_trees.forest_depth(n, self.leaf_size), self.max_rptree_depth),
            angular=self._angular_trees,
            ell_nnz=self._ell["nnz"] if self._ell is not None else None,
        )

        from pynndescent_tpu.ops.neighbors import state_from_graph

        init_state = state_from_graph(jnp.asarray(idx), jnp.asarray(dist), k=k)
        if self._mesh is not None:
            # the update's re-descent runs under the same parallelism as the
            # build (reference analog: update under the build's threading,
            # pynndescent_.py:2381-2553)
            from pynndescent_tpu.parallel import mesh as mesh_mod

            if self.shard_data:
                raise NotImplementedError(
                    "update() is not supported with shard_data=True builds "
                    "yet; rebuild the index instead"
                )
            new_idx, new_dist = mesh_mod.sharded_nn_descent(
                self._X,
                getattr(self, "_build_k", self.n_neighbors),
                self._key,
                self._mesh,
                metric=self._internal_metric,
                metric_kwds=self._internal_metric_kwds,
                n_iters=self.n_iters,
                delta=self.delta,
                max_candidates=self.max_candidates,
                forest=forest,
                leaf_cap=min(self.leaf_size, 64),
                init_state=init_state,
                locality=getattr(self, "locality", None),
            )
        else:
            new_idx, new_dist = nnd_ops.nn_descent(
                self._X,
                getattr(self, "_build_k", self.n_neighbors),
                self._key,
                metric=self._internal_metric,
                metric_kwds=self._internal_metric_kwds,
                n_iters=self.n_iters,
                delta=self.delta,
                max_candidates=self.max_candidates,
                init_graph=init_state,
                forest=forest,
                leaf_cap=min(self.leaf_size, 64),
                block_rows=self.block_rows,
                compute_dtype=(
                    jnp.bfloat16
                    if getattr(self, "build_dtype", None) == "bfloat16"
                    else None
                ),
                locality=getattr(self, "locality", None),
                verbose=self.verbose,
            )
        self._neighbor_graph = (new_idx, new_dist)
        self._incomplete_dev = jnp.any(jnp.asarray(new_idx) < 0)
        self._warned_incomplete = False

        # rebuild the search structures lazily (reference :2537-2553)
        self._search_graph = None
        self._search_tree = None
        self._graph_exact = None

    # ------------------------------------------------------------------
    # pickling (reference pynndescent_.py:1306-1331)
    # ------------------------------------------------------------------

    def __getstate__(self):
        self.prepare()  # search structures must exist (reference :1307)
        self._graph_host()  # materialize the numpy graph before serializing
        state = self.__dict__.copy()
        state["_incomplete_dev"] = None  # device scalar; warning state kept
        state["_X"] = None  # rebuilt from _raw_data
        state["_X_search"] = None
        state["_quantized_codes_dev"] = None
        state.pop("_ell_store_dev", None)  # rebuilt lazily from _ell_store
        # local closures are not picklable; rebuilt in __setstate__ from the
        # stored mode/codebook/metric name (reference pickles by recompiling
        # its jitted closures the same way, pynndescent_.py:1322-1331)
        state.pop("_quantized_rowwise", None)
        state.pop("_ell_metric_cache", None)
        state.pop("_timer", None)  # recreated in __setstate__
        state.pop("_build_ctx", None)
        # a Mesh (and raw Device objects) are process-local: serialize the
        # device COUNT and re-resolve on load (mesh builds load fine on a
        # single device — the index arrays are device-agnostic)
        state.pop("_mesh", None)
        if self._mesh is not None:
            state["devices"] = int(np.prod(list(self._mesh.shape.values())))
        else:
            state["devices"] = None
        if self._ell is not None:
            state["_internal_metric"] = None
            state["_distance_correction"] = None
        state["_search_graph"] = np.asarray(self._search_graph)
        state["_key"] = np.asarray(self._key)
        return state

    def save(self, path):
        """Array-native checkpoint: ONE ``.npz`` holding every flat array of
        the prepared index plus a JSON config blob — no pickle bytecode
        (loadable across Python versions, safe to inspect). On the device the
        index already IS flat arrays (graphs, trees, codebooks — SURVEY §5), so
        this is the natural serialization; the reference only offers pickle
        (pynndescent_.py:1306-1331).

        Callable (custom-function) metrics cannot be serialized this way —
        use pickle for those.
        """
        import json

        if callable(self.metric):
            raise ValueError(
                "save() supports registry (string) metrics; use pickle for "
                "callable metrics"
            )
        state = self.__getstate__()
        arrays = {}
        meta = {}

        def put(prefix, obj):
            for kk, vv in obj.items():
                key = f"{prefix}{kk}"
                if isinstance(vv, dict):
                    meta[key] = ["__dict__"]
                    put(key + "/", vv)
                elif isinstance(vv, (np.ndarray, jnp.ndarray)):
                    arrays[key] = np.asarray(vv)
                elif vv is None or isinstance(vv, (bool, int, float, str)):
                    meta[key] = ["__val__", vv]
                elif isinstance(vv, (list, tuple)) and all(
                    x is None or isinstance(x, (bool, int, float, str)) for x in vv
                ):
                    meta[key] = [
                        "__tuple__" if isinstance(vv, tuple) else "__list__",
                        list(vv),
                    ]
                elif isinstance(vv, tuple) and all(
                    isinstance(x, (np.ndarray, jnp.ndarray)) for x in vv
                ):
                    meta[key] = ["__arrtuple__", len(vv)]
                    for i, x in enumerate(vv):
                        arrays[f"{key}/__t{i}"] = np.asarray(x)
                elif isinstance(vv, np.random.RandomState):
                    meta[key] = ["__drop__"]  # _root_seed already captured
                elif isinstance(vv, (np.integer, np.floating, np.bool_)):
                    meta[key] = ["__val__", vv.item()]
                elif callable(vv):
                    meta[key] = ["__rebuild__"]  # re-derived from config
                else:
                    raise TypeError(
                        f"cannot checkpoint attribute {key!r} of type {type(vv)}"
                    )

        put("", state)
        arrays["__meta__"] = np.frombuffer(
            json.dumps(meta).encode(), dtype=np.uint8
        )
        np.savez(path, **arrays)

    @classmethod
    def load(cls, path):
        """Load an index checkpointed with :meth:`save`."""
        import json

        with np.load(path, allow_pickle=False) as z:
            meta = json.loads(bytes(z["__meta__"].tobytes()).decode())
            arrays = {k: z[k] for k in z.files if k != "__meta__"}

        def build(prefix):
            out = {}
            plen = len(prefix)
            for key, tag in meta.items():
                if not key.startswith(prefix) or "/" in key[plen:]:
                    continue
                name = key[plen:]
                if tag[0] == "__dict__":
                    out[name] = build(key + "/")
                elif tag[0] == "__val__":
                    out[name] = tag[1]
                elif tag[0] == "__tuple__":
                    out[name] = tuple(tag[1])
                elif tag[0] == "__list__":
                    out[name] = tag[1]
                elif tag[0] == "__arrtuple__":
                    out[name] = tuple(
                        arrays[f"{key}/__t{i}"] for i in range(tag[1])
                    )
                elif tag[0] in ("__drop__", "__rebuild__"):
                    out[name] = None
            for key, arr in arrays.items():
                if key.startswith(prefix) and "/" not in key[plen:]:
                    out[key[plen:]] = arr
            return out

        state = build("")
        obj = cls.__new__(cls)
        obj.__setstate__(state)
        # re-derive the jit-closure attributes the blob could not carry
        if getattr(obj, "_ell", None) is None:
            obj._set_distance_func()
        return obj

    def __setstate__(self, state):
        from pynndescent_tpu.utils.profiling import PhaseTimer

        self.__dict__.update(state)
        self._timer = PhaseTimer(getattr(self, "profile", False))
        self._build_ctx = None
        devices = getattr(self, "devices", None)
        if isinstance(devices, int) and devices > len(jax.devices()):
            # fewer devices here than where the index was built: serve
            # single-device (the index arrays are device-agnostic)
            devices = None
        self._mesh = _resolve_mesh(devices)
        self._X = jnp.asarray(self._raw_data)
        self._search_graph = jnp.asarray(state["_search_graph"])
        self._key = jnp.asarray(state["_key"])
        if getattr(self, "_ell", None) is not None:
            self._set_ell_metric()
        sk = getattr(self, "_sketch", None)
        if (
            getattr(self, "search_dtype", "bfloat16") == "bfloat16"
            and not getattr(self, "_is_bit", False)
            and getattr(self, "quantization", None) is None
            and getattr(self, "_ell", None) is None
            # value-encoded minhash signatures serve at exact f32 (see
            # prepare()); sign-encoded ones are +-1 and bf16-exact
            and not (
                sk is not None
                and sk["kind"] == "minhash"
                and sk.get("encode", "value") == "value"
            )
        ):
            self._X_search = self._X.astype(jnp.bfloat16)
        if getattr(self, "_quantized", None) is not None:
            self._quantized_codes_dev = jnp.asarray(self._quantized["codes"])
            self._quantized_rowwise = self._build_quantized_fn()


@functools.partial(jax.jit, static_argnames=("dist_rowwise", "k"))
def _jit_rerank(queries, cand_idx, X, *, dist_rowwise, k):
    """Recompute exact distances on candidates and keep the top k, on device
    (reference: rerank, pynndescent_.py:775)."""
    C = X[jnp.maximum(cand_idx, 0)]
    d = dist_rowwise(queries, C)
    d = jnp.where(cand_idx < 0, jnp.inf, d)
    nd, ni = jax.lax.sort((d, cand_idx), num_keys=1, dimension=-1)
    return ni[:, :k], nd[:, :k]
