"""Deterministic counter-based PRNG plumbing.

The reference threads a mutable 3-word Tausworthe state through every kernel,
with per-thread streams made by offsetting the state with the thread id
(reference: utils.py:11-57, 261-262). In JAX the idiomatic equivalent is
JAX's stateless threefry keys: every (phase, iteration, role) derives its own
key via ``fold_in``, so results are bit-identical regardless of device count
or scheduling — the determinism contract the reference tests demand
(tests/test_pynndescent_.py:279-292) holds *by construction*.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Stable role tags so key derivation never depends on call order.
ROLE_FOREST = 1
ROLE_DESCENT_INIT = 2
ROLE_DESCENT_ITER = 3
ROLE_SEARCH = 4
ROLE_UPDATE = 5
ROLE_QUANTIZE = 6
ROLE_DESCENT_LOCAL = 7


def resolve_seed(seed) -> int:
    """Collapse an int seed / RandomState / None into one root int
    (matching the reference's check_random_state-based seeding,
    pynndescent_.py:1105)."""
    if isinstance(seed, np.random.RandomState):
        return int(seed.randint(0, np.iinfo(np.int32).max))
    if seed is None:
        return int(np.random.randint(0, np.iinfo(np.int32).max))
    return int(seed)


def state_from_seed(seed) -> jax.Array:
    """Build a root key from an int seed or numpy RandomState."""
    return jax.random.PRNGKey(resolve_seed(seed))


def host_ints(root_seed: int, role: int, count: int) -> list[int]:
    """Deterministic positive int31 draws derived on the HOST (splitmix64).
    Used wherever the index needs plain Python ints (tree seeds for host
    orchestration, codebook seeds): a device-side draw would cost a full
    host<->device round trip just to read the scalar back."""
    out = []
    with np.errstate(over="ignore"):
        x = (np.uint64(root_seed) * np.uint64(0x9E3779B97F4A7C15)
             + np.uint64(role) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(0xFFFFFFFFFFFFFFFF)
        for _ in range(count):
            x = (x + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
            z = x
            z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & np.uint64(0xFFFFFFFFFFFFFFFF)
            z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & np.uint64(0xFFFFFFFFFFFFFFFF)
            z = z ^ (z >> np.uint64(31))
            out.append(int(z & np.uint64(0x7FFFFFFF)))
    return out


def derive(key: jax.Array, *tags: int) -> jax.Array:
    """Derive a subkey from a stable tuple of integer tags."""
    for t in tags:
        key = jax.random.fold_in(key, t)
    return key


def uniform(key, shape, dtype=jnp.float32):
    return jax.random.uniform(key, shape, dtype=dtype)


def randint(key, shape, minval, maxval):
    return jax.random.randint(key, shape, minval, maxval, dtype=jnp.int32)
