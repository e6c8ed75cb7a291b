"""Tests that need an NVIDIA GPU. They skip elsewhere; on a GPU host run

    PYNNDESCENT_TEST_GPU=1 python -m pytest tests -m gpu

(this file imports nothing beyond the package's own dependencies; the
modules that need scikit-learn skip where it is not installed)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from pynndescent_tpu.ops.rp_trees import build_forest_orders, forest_depth

pytestmark = pytest.mark.gpu


def test_forest_bit_identical_on_gpu(gpu):
    """Same seeds, same forest, on the card: the split means are summed in a
    fixed order (rp_trees._segment_means), never by float atomics, whose
    order changes from run to run on a GPU."""
    n, d = 200_000, 128
    X = jax.device_put(
        jax.random.normal(jax.random.PRNGKey(0), (n, d), jnp.float32), gpu
    )
    seeds = jnp.arange(10, dtype=jnp.uint32)
    a = build_forest_orders(X, seeds, 60, forest_depth(n, 60))
    b = build_forest_orders(X, seeds, 60, forest_depth(n, 60))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
