"""Optimal-transport sub-engine.

Mirrors the capability surface of the reference's OT engine
(``pynndescent/optimal_transport.py``): entropy-regularised Sinkhorn
transport (single + batch) and exact Kantorovich / EMD distance.

Device/host split:

* **Sinkhorn** is batched matrix scaling — natural device work. It is
  implemented as jittable JAX loops (``sinkhorn_transport_plan``,
  ``sinkhorn``, ``sinkhorn_distance_batch``) so it can run inside the
  NN-descent hot path (reference: optimal_transport.py:1020-1163).

* **Exact Kantorovich** (reference: network-simplex port,
  optimal_transport.py:846) is pointer-chasing and sequential — hostile to
  XLA. Here it is solved exactly on the host as a transport linear program
  via scipy's HiGHS simplex. ``kantorovich`` is therefore a *host* metric:
  the index layer routes it through the proxy+rerank path
  (``proxy_kantorovich`` on-device, exact rerank on host) exactly as the
  reference's ``proxy_distances`` registry intends (distances.py:2190).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

_KANTOROVICH_CACHE_SIZE = 8


def sinkhorn_transport_plan(x, y, cost, regularization=1.0, max_iter=32):
    """Entropy-regularised transport plan between distributions x [d1], y [d2]
    with cost matrix [d1, d2] (reference: optimal_transport.py:1090).

    Fully jittable; fixed iteration count (matrix-scaling converges
    geometrically, and a fixed bound keeps shapes/control-flow static).
    """
    x = jnp.asarray(x, jnp.float32)
    y = jnp.asarray(y, jnp.float32)
    a = x / jnp.sum(x)
    b = y / jnp.sum(y)
    # Log-domain scaling for stability at small regularization (exp(-c/reg)
    # underflows in the naive form).
    log_a = jnp.log(jnp.maximum(a, 1e-35))
    log_b = jnp.log(jnp.maximum(b, 1e-35))
    negC = -cost / regularization

    def body(_, fg):
        f, g = fg
        f = log_a - jax.scipy.special.logsumexp(negC + g[None, :], axis=1)
        g = log_b - jax.scipy.special.logsumexp(negC + f[:, None], axis=0)
        return (f, g)

    f0 = jnp.zeros_like(a)
    g0 = jnp.zeros_like(b)
    f, g = jax.lax.fori_loop(0, max_iter, body, (f0, g0))
    return jnp.exp(f[:, None] + negC + g[None, :])


def sinkhorn(x, y, cost, regularization=1.0):
    """Sinkhorn distance: <plan, cost> (reference: optimal_transport.py:1120)."""
    plan = sinkhorn_transport_plan(x, y, cost, regularization)
    return jnp.sum(plan * cost)


def sinkhorn_distance_batch(X, Y, cost, regularization=1.0):
    """Batched Sinkhorn distances between rows of X [n, d] and Y [n, d]
    (reference: optimal_transport.py:1135)."""
    return jax.vmap(lambda x, y: sinkhorn(x, y, cost, regularization))(X, Y)


def make_fixed_cost_sinkhorn_distance(cost, regularization=1.0):
    """Close over a fixed cost matrix, returning a 2-arg metric suitable for
    the metric registry (reference: optimal_transport.py:1165)."""

    def _sinkhorn_fixed(x, y):
        return sinkhorn(x, y, cost, regularization)

    return _sinkhorn_fixed


# ---------------------------------------------------------------------------
# Exact Kantorovich via host LP (HiGHS dual simplex)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=_KANTOROVICH_CACHE_SIZE)
def _transport_constraints(n1: int, n2: int):
    """Sparse equality constraints of the transport polytope for an n1 x n2
    plan, with the (redundant) last column-constraint dropped."""
    from scipy import sparse

    nvar = n1 * n2
    rows = []
    cols = []
    for i in range(n1):
        rows.extend([i] * n2)
        cols.extend(range(i * n2, (i + 1) * n2))
    for j in range(n2 - 1):
        rows.extend([n1 + j] * n1)
        cols.extend(range(j, nvar, n2))
    data = np.ones(len(rows))
    return sparse.csr_matrix((data, (rows, cols)), shape=(n1 + n2 - 1, nvar))


def kantorovich(x, y, cost=None, max_iter=100000):
    """Exact Kantorovich (EMD / Wasserstein) distance, solved on the host.

    Matches the reference semantics (distances.py:1484): zero-mass bins are
    masked out, the remaining masses are normalised to probability vectors,
    and the transport LP is solved exactly over the masked cost submatrix.

    This function is NOT jittable — it is used for exact reranking and for
    direct distance evaluation, mirroring how the reference treats
    kantorovich as an expensive exact metric behind ``proxy_kantorovich``.
    """
    from scipy.optimize import linprog

    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    if cost is None:
        raise ValueError("kantorovich requires a cost matrix (metric_kwds={'cost': ...})")
    cost = np.asarray(cost, dtype=np.float64)

    if x.ndim > 1 or y.ndim > 1:
        # Batched host evaluation.
        xb = x.reshape(-1, x.shape[-1])
        yb = y.reshape(-1, y.shape[-1])
        out = np.array(
            [kantorovich(xi, yi, cost=cost, max_iter=max_iter) for xi, yi in zip(xb, yb)]
        )
        return out.reshape(x.shape[:-1])

    row_mask = x != 0
    col_mask = y != 0
    a = x[row_mask]
    b = y[col_mask]
    if a.sum() <= 0 or b.sum() <= 0:
        raise ValueError("Kantorovich distance inputs must be valid probability distributions.")
    a = a / a.sum()
    b = b / b.sum()
    sub_cost = cost[row_mask][:, col_mask]

    # native C++ successive-shortest-paths solver (pynndescent_tpu.native);
    # falls through to the HiGHS LP when unavailable
    from pynndescent_tpu import native

    val = native.emd_dense(a, b, sub_cost)
    if val is not None:
        return val

    n1, n2 = sub_cost.shape
    if n1 == 1:
        return float(np.dot(sub_cost[0], b))
    if n2 == 1:
        return float(np.dot(sub_cost[:, 0], a))

    A_eq = _transport_constraints(n1, n2)
    b_eq = np.concatenate([a, b[:-1]])
    res = linprog(
        sub_cost.ravel(),
        A_eq=A_eq,
        b_eq=b_eq,
        bounds=(0, None),
        method="highs",
        options={"maxiter": int(max_iter)},
    )
    if res.status == 2:
        raise ValueError("Optimal transport problem was INFEASIBLE. Please check inputs.")
    if res.status == 3:
        raise ValueError("Optimal transport problem was UNBOUNDED. Please check inputs.")
    return float(res.fun)
