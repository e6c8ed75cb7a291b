"""Test fixtures mirroring the reference suite (reference: tests/conftest.py).

Tests run on a *virtual 8-device CPU mesh* so multi-chip sharding logic is
exercised without GPUs; ``chip_smoke.py`` and the benchmark run on the card,
and the tests marked ``gpu`` run there with
``PYNNDESCENT_TEST_GPU=1 python -m pytest tests -m gpu`` (modules that need
scikit-learn skip where it is not installed).
These environment variables must be set before jax initialises.
"""

import os

# PYNNDESCENT_TEST_GPU=1 leaves the platform to JAX (on a GPU host: the
# card), so the tests marked ``gpu`` run; every other run is held to the
# virtual CPU mesh.
ON_GPU = os.environ.get("PYNNDESCENT_TEST_GPU") == "1"
if not ON_GPU:
    os.environ["JAX_PLATFORMS"] = "cpu"
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

if not ON_GPU:
    # jax may already be imported by a pytest plugin, in which case it
    # captured JAX_PLATFORMS at import time — override through the config.
    jax.config.update("jax_platforms", "cpu")
# NOTE: the persistent compilation cache is deliberately NOT enabled here —
# XLA:CPU AOT cache entries are machine-feature-specific and a poisoned
# entry silently produces WRONG numerics (observed: shard-invariance test
# failing only under a stale cache). bench.py and chip_smoke.py enable it.

import numpy as np
import pytest
from scipy import sparse

SEED = 189212  # same fixed seed as the reference suite

# ---------------------------------------------------------------------------
# Tiering: the full suite takes >20 min on the 8-device CPU mesh (every jit
# recompiles; the persistent cache is off for correctness, see note above).
# Heavy tests are centrally marked `slow` here so the quick tier
# (`pytest -m "not slow"`) stays under ~5 minutes while covering every
# subsystem with at least one representative.
# ---------------------------------------------------------------------------

SLOW_TESTS = {
    # m5 features — keep one quantized, one wide-ELL, minkowski in quick tier
    "test_sparse_cosine_build_recall",
    "test_sparse_build_recall",
    "test_sparse_query",
    "test_quantized_query[binary]",
    "test_bit_jaccard_build_and_query",
    "test_bit_hamming_build",
    "test_proxy_metric_query",
    "test_wide_sparse_ell_path",
    # updates — keep update_only scenarios in quick tier
    "test_repeated_updates_shrink_forest",
    "test_update_scenarios[fresh_only-euclidean]",
    "test_update_scenarios[fresh_only-cosine]",
    "test_update_scenarios[fresh_and_update-euclidean]",
    "test_update_scenarios[fresh_and_update-cosine]",
    "test_update_scenarios[small_fresh-euclidean]",
    "test_update_scenarios[small_fresh-cosine]",
    # index — keep the euclidean variants in quick tier
    "test_query_recall_angular",
    "test_build_recall_cosine",
    # hub trees — keep test_hub_tree_query_recall + the exact-anchor and
    # score-comparison unit tests in quick tier
    "test_hub_tree_self_query",
    "test_hub_vs_random_query_recall",
    "test_angular_hub_tree_query_recall",
    "test_sparse_hub_tree_query_recall",
    "test_bit_hub_tree_query_recall",
    "test_n_search_trees_selection",  # scoring covered by the unit tests
    # round-3 feature heavies — quick tier keeps test_connect_graph, the
    # exact-anchor unit test and the 8-device shard-equivalence checks
    "test_hub_heavy_reverse_diversify",
    "test_connect_graph_exact_min_edge",
    "test_sharded_search_recall_matches_single",
    "test_quantized_pickle_roundtrip",  # uint8/uint4 query tests remain quick
    # sketch — quick tier keeps resolve/hash units + the cosine end-to-end
    # and the auto-fallback check
    "test_sketch_jaccard_binarized",
    "test_sketch_update_append",
    "test_sketch_pickle_roundtrip",
    # api — keep transformer_sklearn_pipeline + quantized pickle
    "test_update_with_fresh_data",
    "test_update_with_changed_data",
    "test_update_bit_metric_data",
    "test_one_dimensional_data",
    "test_pickle_roundtrip",
    "test_transformer_transform_matches_query",
    "test_transformer_fit_transform",
    "test_transformer_fit_compresses_index",
    # parallel — keep sharded_build_recall + both graft checks in quick tier
    "test_sharded_build_shard_equivalence",
    # measured heaviest of the quick tier (compile-bound on the 1-core CPU
    # host); each keeps a cheaper quick-tier representative:
    "test_compressed_pickle_roundtrip",  # pickle via test_quantized_pickle_roundtrip
    "test_quantized_codebook_deterministic_with_randomstate",  # uint8/uint4 query tests remain
    "test_ell_dense_query_rejected",  # ELL via test_wide_sparse_ell_cosine
    "test_update_scenarios[update_only-cosine]",  # euclidean scenario remains
    "test_inf_query_rejected",  # NaN/inf build rejection tests remain
    "test_tree_init_false",  # random-init covered inside descent tests
    # exact-OT routing: each name recompiles the whole proxy pipeline
    # (minutes of XLA:CPU compile per test); kantorovich stays as the
    # quick-tier representative of the shared routing
    "test_exact_ot_metric_build_and_query[wasserstein]",
    "test_exact_ot_metric_build_and_query[sinkhorn]",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        if item.name in SLOW_TESTS:
            item.add_marker(pytest.mark.slow)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none. Decided here,
    at run time — never while a module is imported."""
    device = jax.devices()[0]
    if device.platform != "gpu":
        pytest.skip(
            "needs an NVIDIA GPU: run `PYNNDESCENT_TEST_GPU=1 python -m pytest "
            "tests -m gpu` on a GPU host"
        )
    return device


@pytest.fixture
def seed():
    return SEED


@pytest.fixture
def spatial_data():
    rng = np.random.RandomState(SEED)
    data = rng.randn(10, 20).astype(np.float32)
    # zero-vector corner cases, as in the reference fixture
    return np.vstack([data, np.zeros((2, 20), dtype=np.float32)])


@pytest.fixture
def binary_data():
    rng = np.random.RandomState(SEED)
    return rng.choice(a=[False, True], size=(10, 20), p=[0.66, 1 - 0.66])


@pytest.fixture
def sparse_spatial_data(spatial_data, binary_data):
    return sparse.csr_matrix(spatial_data * binary_data.astype(np.float32))


@pytest.fixture
def sparse_binary_data(binary_data):
    return sparse.csr_matrix(binary_data)


@pytest.fixture
def nn_data():
    rng = np.random.RandomState(SEED)
    data = rng.uniform(0, 1, size=(1000, 5)).astype(np.float32)
    return np.vstack([data, np.zeros((2, 5), dtype=np.float32)])


@pytest.fixture
def sparse_nn_data():
    rng = np.random.RandomState(SEED)
    dense = rng.uniform(0, 1, size=(1000, 50)).astype(np.float32)
    mask = rng.uniform(0, 1, size=dense.shape) >= 0.5
    return sparse.csr_matrix(dense * mask)


@pytest.fixture
def small_data():
    rng = np.random.RandomState(SEED)
    return rng.uniform(0, 1, size=(32, 5)).astype(np.float32)
