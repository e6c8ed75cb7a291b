"""True sparse kernels: padded-ELL rows for wide feature spaces.

Completes the sparse story beyond the densification threshold
(ops/sparse.py): when ``n_features`` is too large to materialise, CSR rows
are packed into fixed-width ELL form and distances are computed directly on
the sparse representation — the batched equivalent of the reference's
merge-based CSR-row primitives (reference sparse.py:21-941,
``sparse_sum/diff/mul/dot_product`` etc.) and its ~25-metric sparse registry
(``sparse_named_distances``, sparse.py:1053-1095).

Representation: each row packs to one f32 vector of width ``2 * nnz_max``:
``[indices (as f32, -1 padding) | values (0 padding)]``. Packing indices and
values into a single trailing axis makes sparse rows *opaque* to every
existing kernel — gathers, candidate pools, diversification, tree splits and
beam search all move rows around without knowing they are sparse; only the
metric closure splits the axis. Rows of different widths coexist (queries
pack at their own nnz), so nothing is ever truncated.

Two batched primitives power every metric:

* ``sparse_dot`` — one sort per pair family: concatenate the two index lists
  with a side tag in the low bit (``idx*2 + side``), sort, and multiply
  adjacent entries whose keys differ by exactly 1 (a matching index pair from
  opposite sides). The batched replacement for ``sparse_dot_product``
  (reference sparse.py:277).
* ``union_pairs`` — the same sort, materialising the *aligned value pairs*
  over the union of stored indices: per union feature, (x value, y value)
  with zero fill for the absent side, plus structural masks. The batched
  replacement for ``sparse_sum/diff/mul`` (reference sparse.py:136-276):
  any merge-based metric becomes elementwise math + a masked reduction.

Everything stays fixed-shape and batched.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from pynndescent_tpu.ops import distances as dst

# f32 can represent integers exactly up to 2^24 — enough for any realistic
# feature count; the packing below would silently corrupt beyond that.
MAX_FEATURES_ELL = 1 << 24
_PAD_KEY = jnp.int32(2 * MAX_FEATURES_ELL + 8)


def csr_to_ell_packed(csr, nnz_max: int | None = None):
    """Pack a scipy CSR matrix into [n, 2*nnz_max] f32 (indices | values)."""
    csr = csr.tocsr()
    # duplicate entries are legal in directly-constructed scipy CSR; they
    # would break the tagged-sort adjacency assumption downstream
    csr.sum_duplicates()
    csr.sort_indices()
    n, d = csr.shape
    if d > MAX_FEATURES_ELL:
        raise ValueError(f"n_features {d} exceeds ELL index capacity {MAX_FEATURES_ELL}")
    counts = np.diff(csr.indptr)
    if nnz_max is None:
        nnz_max = max(1, int(counts.max(initial=1)))
    if counts.max(initial=0) > nnz_max:
        raise ValueError(f"row nnz {counts.max()} exceeds nnz_max {nnz_max}")
    inds = np.full((n, nnz_max), -1.0, np.float32)
    vals = np.zeros((n, nnz_max), np.float32)
    rows = np.repeat(np.arange(n), counts)
    cols = np.arange(len(csr.data)) - np.repeat(csr.indptr[:-1], counts)
    inds[rows, cols] = csr.indices
    vals[rows, cols] = csr.data
    return np.concatenate([inds, vals], axis=1)


def ell_repack(packed, old_nnz: int, new_nnz: int):
    """Re-pad packed ELL rows to a wider nnz (for appends that raise the
    row-width watermark)."""
    if new_nnz == old_nnz:
        return packed
    if new_nnz < old_nnz:
        raise ValueError("cannot shrink packed rows")
    packed = np.asarray(packed)
    lead = packed.shape[:-1]
    inds = packed[..., :old_nnz]
    vals = packed[..., old_nnz:]
    pad_i = np.full(lead + (new_nnz - old_nnz,), -1.0, np.float32)
    pad_v = np.zeros(lead + (new_nnz - old_nnz,), np.float32)
    return np.concatenate([inds, pad_i, vals, pad_v], axis=-1)


def _split(packed, nnz):
    return packed[..., :nnz], packed[..., nnz:]


def _tagged_sort(x_packed, y_packed, nnz_x: int, nnz_y: int):
    """Sort the union of both rows' (index, value) entries by a tagged key.

    Keys are int32 ``idx*2 + side`` (x entries even, y entries odd): f32
    indices are exact up to 2^24 and converting to int32 before the *2+side
    arithmetic keeps every key exact (f32 keys silently collide for
    idx >= 2^23). Padding maps beyond any real key."""
    xi, xv = _split(x_packed, nnz_x)
    yi, yv = _split(y_packed, nnz_y)
    lead = jnp.broadcast_shapes(xi.shape[:-1], yi.shape[:-1])
    xi = jnp.broadcast_to(xi, lead + xi.shape[-1:])
    xv = jnp.broadcast_to(xv, lead + xv.shape[-1:])
    yi = jnp.broadcast_to(yi, lead + yi.shape[-1:])
    yv = jnp.broadcast_to(yv, lead + yv.shape[-1:])
    kx = jnp.where(xi >= 0, xi.astype(jnp.int32) * 2, _PAD_KEY)
    ky = jnp.where(yi >= 0, yi.astype(jnp.int32) * 2 + 1, _PAD_KEY)
    keys = jnp.concatenate([kx, ky], axis=-1)
    vals = jnp.concatenate([xv, yv], axis=-1)
    return jax.lax.sort((keys, vals), num_keys=1, dimension=-1)


def sparse_dot(x_packed, y_packed, nnz_x: int, nnz_y: int | None = None):
    """<x, y> over packed ELL rows; broadcasts over leading axes
    (reference: sparse_dot_product, sparse.py:277)."""
    if nnz_y is None:
        nnz_y = nnz_x
    sk, sv = _tagged_sort(x_packed, y_packed, nnz_x, nnz_y)
    match = (sk[..., 1:] - sk[..., :-1]) == 1
    even = (sk[..., :-1] % 2) == 0
    prod = jnp.where(match & even, sv[..., 1:] * sv[..., :-1], 0.0)
    return jnp.sum(prod, axis=-1)


def union_pairs(x_packed, y_packed, nnz_x: int, nnz_y: int | None = None,
                compact: bool = False):
    """Aligned value pairs over the union of stored indices.

    Returns ``(xv, yv, feat, valid, both)``, each ``[..., nnz_x + nnz_y]``:

    * ``valid`` marks union slots (one per distinct stored feature index);
    * ``xv`` / ``yv`` are the rows' values at that feature (0 when absent);
    * ``feat`` is the feature index (int32);
    * ``both`` marks slots where *both* rows store the feature.

    Slots are in ascending feature order among the valid entries. With
    ``compact=True`` valid slots are additionally moved to the front (needed
    by order-walking metrics like wasserstein_1d)."""
    if nnz_y is None:
        nnz_y = nnz_x
    sk, sv = _tagged_sort(x_packed, y_packed, nnz_x, nnz_y)
    is_pad = sk >= _PAD_KEY
    is_x = ((sk % 2) == 0) & ~is_pad
    shape1 = sk.shape[:-1] + (1,)
    nxt_is_match = jnp.concatenate(
        [(sk[..., 1:] - sk[..., :-1]) == 1, jnp.zeros(shape1, bool)], axis=-1
    ) & is_x
    prev_was_match = jnp.concatenate(
        [jnp.zeros(shape1, bool), nxt_is_match[..., :-1]], axis=-1
    )
    valid = ~is_pad & ~prev_was_match
    both = nxt_is_match
    sv_next = jnp.concatenate([sv[..., 1:], jnp.zeros(shape1, sv.dtype)], axis=-1)
    xv = jnp.where(is_x, sv, 0.0)
    yv = jnp.where(both, sv_next, jnp.where(is_x, 0.0, sv))
    xv = jnp.where(valid, xv, 0.0)
    yv = jnp.where(valid, yv, 0.0)
    feat = jnp.where(valid, sk >> 1, jnp.int32(MAX_FEATURES_ELL + 4))
    if compact:
        w = sk.shape[-1]
        pos = jnp.broadcast_to(
            jnp.arange(w, dtype=jnp.int32), sk.shape
        )
        order_key = jnp.where(valid, pos, jnp.int32(w + 1))
        order_key, xv, yv, feat, valid = jax.lax.sort(
            (order_key, xv, yv, feat, valid), num_keys=1, dimension=-1
        )
    return xv, yv, feat, valid, both


def _sq_norm(packed, nnz):
    _, v = _split(packed, nnz)
    return jnp.sum(v * v, axis=-1)


def _l1_norm(packed, nnz):
    _, v = _split(packed, nnz)
    return jnp.sum(jnp.abs(v), axis=-1)


def _val_sum(packed, nnz):
    _, v = _split(packed, nnz)
    return jnp.sum(v, axis=-1)


def _stored_count(packed, nnz):
    i, _ = _split(packed, nnz)
    return jnp.sum(i >= 0, axis=-1).astype(jnp.float32)


def _bcast_lead(x, y, nnz_x, nnz_y):
    """Broadcast two packed operands over their leading axes."""
    lead = jnp.broadcast_shapes(x.shape[:-1], y.shape[:-1])
    return (
        jnp.broadcast_to(x, lead + x.shape[-1:]),
        jnp.broadcast_to(y, lead + y.shape[-1:]),
    )


# ---------------------------------------------------------------------------
# Metric factory
# ---------------------------------------------------------------------------


def make_ell_metric(metric: str, nnz_x: int, nnz_y: int | None = None,
                    n_features: int | None = None, **metric_kwds):
    """Batched metric over packed ELL rows, signature-compatible with the
    framework's custom-callable metrics (f(x, y), x over [..., 2*nnz_x],
    y over [..., 2*nnz_y]).

    Mirrors the reference's sparse metric registry
    (sparse_named_distances, sparse.py:1053-1095); metrics listed in the
    reference's ``sparse_need_n_features`` (sparse.py:1097) take the feature
    count here too."""
    if nnz_y is None:
        nnz_y = nnz_x
    nx, ny = nnz_x, nnz_y

    def dot(x, y):
        return sparse_dot(x, y, nx, ny)

    def pairs(x, y, compact=False):
        return union_pairs(x, y, nx, ny, compact=compact)

    def need_nf():
        if n_features is None:
            raise ValueError(f"sparse metric '{metric}' requires n_features")
        return float(n_features)

    if metric in ("euclidean", "l2"):
        def fn(x, y):
            d2 = _sq_norm(x, nx) + _sq_norm(y, ny) - 2.0 * dot(x, y)
            return jnp.sqrt(jnp.maximum(d2, 0.0))
    elif metric == "sqeuclidean":
        def fn(x, y):
            return jnp.maximum(
                _sq_norm(x, nx) + _sq_norm(y, ny) - 2.0 * dot(x, y), 0.0
            )
    elif metric == "cosine":
        def fn(x, y):
            num = dot(x, y)
            sx = _sq_norm(x, nx)
            sy = _sq_norm(y, ny)
            both_zero = (sx == 0.0) & (sy == 0.0)
            one_zero = (sx == 0.0) | (sy == 0.0)
            val = 1.0 - num / jnp.sqrt(jnp.where(one_zero, 1.0, sx * sy))
            return jnp.where(both_zero, 0.0, jnp.where(one_zero, 1.0, val))
    elif metric == "alternative_cosine":
        def fn(x, y):
            num = dot(x, y)
            sx = _sq_norm(x, nx)
            sy = _sq_norm(y, ny)
            both_zero = (sx == 0.0) & (sy == 0.0)
            bad = ((sx == 0.0) | (sy == 0.0) | (num <= 0.0)) & ~both_zero
            val = jnp.log2(
                jnp.sqrt(jnp.maximum(sx * sy, dst.FLOAT32_EPS))
                / jnp.where(num > 0.0, num, 1.0)
            )
            return jnp.where(both_zero, 0.0, jnp.where(bad, dst.FLOAT32_MAX, val))
    elif metric in ("dot", "inner_product"):
        def fn(x, y):
            num = dot(x, y)
            if metric == "dot":
                return jnp.where(num <= 0.0, 1.0, 1.0 - num)
            return -num
    elif metric == "alternative_dot":
        # reference sparse_alternative_dot (sparse.py:684): -log2 of the
        # (normalized-data) dot product
        def fn(x, y):
            num = dot(x, y)
            return jnp.where(num <= 0.0, dst.FLOAT32_MAX, -jnp.log2(num))
    elif metric in ("manhattan", "l1", "taxicab"):
        def fn(x, y):
            a, b, _, valid, _ = pairs(x, y)
            return jnp.sum(jnp.where(valid, jnp.abs(a - b), 0.0), axis=-1)
    elif metric in ("chebyshev", "linf", "linfty", "linfinity"):
        def fn(x, y):
            a, b, _, valid, _ = pairs(x, y)
            return jnp.max(jnp.where(valid, jnp.abs(a - b), 0.0), axis=-1)
    elif metric == "minkowski":
        p = float(metric_kwds.get("p", 2.0))

        def fn(x, y):
            a, b, _, valid, _ = pairs(x, y)
            s = jnp.sum(jnp.where(valid, jnp.abs(a - b) ** p, 0.0), axis=-1)
            return s ** (1.0 / p)
    elif metric == "canberra":
        def fn(x, y):
            a, b, _, valid, _ = pairs(x, y)
            denom = jnp.abs(a) + jnp.abs(b)
            term = jnp.where(valid & (denom > 0.0), jnp.abs(a - b) / jnp.where(denom > 0, denom, 1.0), 0.0)
            return jnp.sum(term, axis=-1)
    elif metric == "braycurtis":
        def fn(x, y):
            a, b, _, valid, _ = pairs(x, y)
            numer = jnp.sum(jnp.where(valid, jnp.abs(a - b), 0.0), axis=-1)
            denom = jnp.sum(jnp.where(valid, jnp.abs(a + b), 0.0), axis=-1)
            return jnp.where(denom > 0.0, numer / jnp.where(denom > 0, denom, 1.0), 0.0)
    elif metric == "hamming":
        def fn(x, y):
            a, b, _, valid, _ = pairs(x, y)
            not_equal = jnp.sum((valid & (a != b)).astype(jnp.float32), axis=-1)
            return not_equal / need_nf()
    elif metric == "jaccard":
        def fn(x, y):
            _, _, _, valid, both = pairs(x, y)
            num_non_zero = jnp.sum(valid.astype(jnp.float32), axis=-1)
            num_equal = jnp.sum(both.astype(jnp.float32), axis=-1)
            return jnp.where(
                num_non_zero == 0.0,
                0.0,
                (num_non_zero - num_equal) / jnp.maximum(num_non_zero, 1.0),
            )
    elif metric == "alternative_jaccard":
        # reference sparse_alternative_jaccard (sparse.py:517)
        def fn(x, y):
            _, _, _, valid, both = pairs(x, y)
            num_non_zero = jnp.sum(valid.astype(jnp.float32), axis=-1)
            num_equal = jnp.sum(both.astype(jnp.float32), axis=-1)
            val = -jnp.log2(jnp.maximum(num_equal, 0.5) / jnp.maximum(num_non_zero, 1.0))
            return jnp.where(
                num_non_zero == 0.0,
                0.0,
                jnp.where(num_equal == 0.0, dst.FLOAT32_MAX, val),
            )
    elif metric in ("matching", "dice", "kulsinski", "rogerstanimoto",
                    "russellrao", "sokalmichener", "sokalsneath"):
        def fn(x, y):
            _, _, _, valid, both = pairs(x, y)
            num_non_zero = jnp.sum(valid.astype(jnp.float32), axis=-1)
            num_tt = jnp.sum(both.astype(jnp.float32), axis=-1)
            num_ne = num_non_zero - num_tt
            if metric == "matching":
                return num_ne / need_nf()
            if metric == "dice":
                return jnp.where(
                    num_ne == 0.0, 0.0, num_ne / jnp.maximum(2.0 * num_tt + num_ne, 1.0)
                )
            if metric == "kulsinski":
                nf = need_nf()
                return jnp.where(
                    num_ne == 0.0, 0.0, (num_ne - num_tt + nf) / (num_ne + nf)
                )
            if metric in ("rogerstanimoto", "sokalmichener"):
                return (2.0 * num_ne) / (need_nf() + num_ne)
            if metric == "russellrao":
                cx = _stored_count(x, nx)
                cy = _stored_count(y, ny)
                cx, cy = jnp.broadcast_arrays(cx, cy)
                exact = (num_tt == cx) & (num_tt == cy)
                return jnp.where(exact, 0.0, (need_nf() - num_tt) / need_nf())
            # sokalsneath
            return jnp.where(
                num_ne == 0.0, 0.0, num_ne / jnp.maximum(0.5 * num_tt + num_ne, 0.5)
            )
    elif metric == "correlation":
        def fn(x, y):
            nf = need_nf()
            a, b, _, valid, _ = pairs(x, y)
            cx = _stored_count(x, nx)
            cy = _stored_count(y, ny)
            sum_x = _val_sum(x, nx)
            sum_y = _val_sum(y, ny)
            sq_x = _sq_norm(x, nx)
            sq_y = _sq_norm(y, ny)
            cx, cy, sum_x, sum_y, sq_x, sq_y = jnp.broadcast_arrays(
                cx, cy, sum_x, sum_y, sq_x, sq_y
            )
            empty_x = cx == 0.0
            empty_y = cy == 0.0
            mu_x = sum_x / nf
            mu_y = sum_y / nf
            # ||x - mu_x||^2 = sum stored (v - mu)^2 + (nf - n1) mu^2
            #               = sum v^2 - 2 mu sum v + nf mu^2
            norm1 = jnp.sqrt(jnp.maximum(sq_x - 2.0 * mu_x * sum_x + nf * mu_x**2, 0.0))
            norm2 = jnp.sqrt(jnp.maximum(sq_y - 2.0 * mu_y * sum_y + nf * mu_y**2, 0.0))
            u = jnp.sum(valid.astype(jnp.float32), axis=-1)
            dot_p = jnp.sum(
                jnp.where(valid, (a - mu_x[..., None]) * (b - mu_y[..., None]), 0.0),
                axis=-1,
            ) + mu_x * mu_y * (nf - u)
            val = 1.0 - dot_p / jnp.where(norm1 * norm2 == 0.0, 1.0, norm1 * norm2)
            val = jnp.where(dot_p == 0.0, 1.0, val)
            val = jnp.where((norm1 == 0.0) & (norm2 == 0.0), 0.0, val)
            return jnp.where(empty_x & empty_y, 0.0, jnp.where(empty_x | empty_y, 1.0, val))
    elif metric in ("hellinger", "alternative_hellinger"):
        def fn(x, y):
            a, b, _, valid, both = pairs(x, y)
            bc = jnp.sum(
                jnp.where(both & valid, jnp.sqrt(jnp.maximum(a * b, 0.0)), 0.0), axis=-1
            )
            l1x = _val_sum(x, nx)
            l1y = _val_sum(y, ny)
            l1x, l1y = jnp.broadcast_arrays(l1x, l1y)
            denom = jnp.sqrt(jnp.maximum(l1x * l1y, 0.0))
            if metric == "hellinger":
                val = jnp.sqrt(jnp.maximum(1.0 - bc / jnp.where(denom > 0, denom, 1.0), 0.0))
                val = jnp.where(bc > denom, 0.0, val)
                return jnp.where(
                    (l1x == 0.0) & (l1y == 0.0), 0.0,
                    jnp.where((l1x == 0.0) | (l1y == 0.0), 1.0, val),
                )
            val = jnp.log2(denom / jnp.where(bc > 0, bc, 1.0))
            bad = (bc <= 0.0) | ((l1x == 0.0) ^ (l1y == 0.0))
            return jnp.where(
                (l1x == 0.0) & (l1y == 0.0), 0.0,
                jnp.where(bad, dst.FLOAT32_MAX, val),
            )
    elif metric in ("jensen-shannon", "jensen_shannon", "symmetric-kl",
                    "symmetric_kl", "symmetric_kullback_liebler"):
        sym_kl = metric.startswith("symmetric")

        def fn(x, y):
            # reference: dense_union then the eps-smoothed dense formula with
            # dim = union size (sparse.py:932-940)
            a, b, _, valid, _ = pairs(x, y)
            u = jnp.sum(valid.astype(jnp.float32), axis=-1)
            eps = dst.FLOAT32_EPS
            l1x = _val_sum(x, nx)
            l1y = _val_sum(y, ny)
            l1x, l1y = jnp.broadcast_arrays(l1x, l1y)
            l1x = l1x + eps * u
            l1y = l1y + eps * u
            pa = (a + eps) / jnp.maximum(l1x[..., None], eps)
            pb = (b + eps) / jnp.maximum(l1y[..., None], eps)
            if sym_kl:
                term = pa * jnp.log(pa / pb) + pb * jnp.log(pb / pa)
            else:
                m = 0.5 * (pa + pb)
                term = 0.5 * (pa * jnp.log(pa / m) + pb * jnp.log(pb / m))
            return jnp.sum(jnp.where(valid, term, 0.0), axis=-1)
    elif metric in ("wasserstein_1d", "wasserstein-1d", "kantorovich-1d"):
        p = float(metric_kwds.get("p", 1.0))

        def fn(x, y):
            a, b, feat, valid, _ = pairs(x, y, compact=True)
            l1x = jnp.maximum(_val_sum(x, nx), dst.FLOAT32_EPS)
            l1y = jnp.maximum(_val_sum(y, ny), dst.FLOAT32_EPS)
            l1x, l1y = jnp.broadcast_arrays(l1x, l1y)
            cdf1 = jnp.cumsum(jnp.where(valid, a, 0.0), axis=-1) / l1x[..., None]
            cdf2 = jnp.cumsum(jnp.where(valid, b, 0.0), axis=-1) / l1y[..., None]
            delta = jnp.abs(cdf1 - cdf2) ** p
            nxt_feat = jnp.concatenate(
                [feat[..., 1:], feat[..., -1:]], axis=-1
            )
            nxt_valid = jnp.concatenate(
                [valid[..., 1:], jnp.zeros(valid.shape[:-1] + (1,), bool)], axis=-1
            )
            gap = jnp.where(valid & nxt_valid, (nxt_feat - feat).astype(jnp.float32), 0.0)
            return jnp.sum(delta * gap, axis=-1) ** (1.0 / p)
    else:
        raise NotImplementedError(
            f"metric '{metric}' is not available on the padded-ELL sparse path "
            "(the reference's sparse kantorovich additionally needs a custom "
            "ground metric, sparse.py:857)"
        )
    fn.__name__ = f"ell_{metric}"
    return fn


def _correct_alternative_jaccard(d):
    return 1.0 - np.power(2.0, -np.asarray(d))


def _correct_alternative_hellinger(d):
    d = np.asarray(d)
    return np.sqrt(np.where(d < 1e-7, 0.0, 1.0 - np.power(2.0, -d)))


# fast-alternative substitution for the ELL path (mirrors the reference's
# sparse_fast_distance_alternatives, sparse.py:1114-1133)
ELL_ALTERNATIVES = {
    "euclidean": ("sqeuclidean", np.sqrt),
    "l2": ("sqeuclidean", np.sqrt),
    "cosine": ("alternative_cosine", dst.correct_alternative_cosine),
    "dot": ("alternative_dot", dst.correct_alternative_cosine),
    "hellinger": ("alternative_hellinger", _correct_alternative_hellinger),
    "jaccard": ("alternative_jaccard", _correct_alternative_jaccard),
}

# metrics that need the feature count (reference sparse_need_n_features,
# sparse.py:1097-1105)
ELL_NEED_N_FEATURES = (
    "hamming",
    "matching",
    "kulsinski",
    "rogerstanimoto",
    "russellrao",
    "sokalmichener",
    "correlation",
)

# full registry of metric names the ELL path accepts (parity with
# sparse_named_distances, reference sparse.py:1053-1095, minus kantorovich
# variants that need a ground metric)
ELL_SUPPORTED = (
    "euclidean", "l2", "sqeuclidean", "manhattan", "l1", "taxicab",
    "chebyshev", "linf", "linfty", "linfinity", "minkowski",
    "canberra", "braycurtis",
    "hamming", "jaccard", "dice", "matching", "kulsinski", "rogerstanimoto",
    "russellrao", "sokalmichener", "sokalsneath",
    "cosine", "dot", "inner_product", "correlation",
    "hellinger", "jensen-shannon", "jensen_shannon",
    "symmetric-kl", "symmetric_kl", "symmetric_kullback_liebler",
    "wasserstein_1d", "wasserstein-1d", "kantorovich-1d",
)
