"""Feature-hash sketching: the dense proxy path for wide sparse data.

The reference computes exact sparse distances inside the NN-descent join
(`/root/reference/pynndescent/sparse.py:21-941`) because merge-based CSR row
intersection is cheap on a CPU. On an accelerator the equivalent (a tagged
sort per candidate pair, `ops/sparse_ell.py`) is sort-bound: the join evaluates
O(n * max_candidates^2) pair distances per iteration and every one costs a
width-2*nnz sort, while the dense path amortises the same pairs into
matmuls.

The dense formulation mirrors the reference's own ``proxy_distances``
design (`/root/reference/pynndescent/distances.py:2190-2239`: build/search
under a cheap order-preserving proxy, exact rerank on output): project each
sparse row into a dense h-dim space by signed feature hashing

    S[i, h1(f) % h] += sign(h2(f)) * x[i, f]

which preserves inner products and norms in expectation (collision noise
O(|x||y|/sqrt(h)) — the standard hashing-trick estimator). Build, trees,
search graph, and beam search then all run on the dense matmul path over S;
every *returned* distance (neighbor_graph and query results) is recomputed
exactly from the packed-ELL rows, so the proxy is invisible in the API
except as a recall/speed trade tuned by ``h``.

Metric mapping: cosine/dot/euclidean-family sketch their values directly
(hashing preserves <x,y> and |x-y|^2). Set metrics (jaccard/hamming/dice/
russellrao/sokal_sneath/matching/kulsinski/rogers_tanimoto) use a
**1-bit (sign) minhash**: D independent min-wise hashes of the support,
keeping one bit of each as s_t = +-1. Since P(minhash match) = J,
E[s_x . s_y] = J exactly, so squared euclidean over the sign vectors
(2D - 2<s_x, s_y>) orders by estimated Jaccard — and the whole dense
pipeline (pairwise matmuls, rowwise join einsums, RP-tree projections,
beam search) runs natively on it. Variance is (1 - J^2)/D per pair vs the
full-value signature's J(1-J)/h, i.e. D ~ 11h at J~0.1 for equal noise;
sign bits are cheaper per dimension because the join is a matmul
instead of an elementwise equality-compare, and +-1 is EXACT in
bfloat16, so the half-traffic bf16 gather paths stay lossless (the value
signature, 24-bit ints in f32, is destroyed by bf16 rounding — a real
bug we shipped: see models/nndescent.py prepare()). The legacy value
signature (``encode="value"``, internal ``hamming``) is kept for old
pickles. Exact rerank restores the true metric's ordering within the
over-fetched candidate set either way. Metrics with no order-compatible
dense proxy (KL, hellinger, canberra, ...) stay on the exact ELL path.
"""

from __future__ import annotations

import numpy as np

# metric -> (internal dense metric for the sketch space, binarize values?)
SKETCH_METRICS = {
    "cosine": ("cosine", False),
    "dot": ("dot", False),
    "euclidean": ("euclidean", False),
    "l2": ("euclidean", False),
    "sqeuclidean": ("sqeuclidean", False),
}

# Set metrics: all monotone in |x ∩ y| for near-constant row nnz, so a
# Jaccard-ordering proxy orders them too; the exact rerank fixes the rest.
MINHASH_METRICS = frozenset(
    {
        "jaccard",
        "hamming",
        "dice",
        "matching",
        "kulsinski",
        "rogers_tanimoto",
        "russellrao",
        "sokal_sneath",
        "sokal_michener",
    }
)

# hash-sketch width for dot-family metrics: the 50k TF-IDF probe's exact
# proxy top-60 covers 0.80 / 0.952 / 0.988 of the true cosine top-10 at
# h = 1024 / 2048 / 4096 — the bench floor (0.85 recall) needs >= 2048,
# and 4096 leaves headroom for the ANN search losses on top.
DEFAULT_H = 4096
# sign-minhash width: ~ an h=745 full-value signature in estimator noise
# ((1-J^2)/D vs J(1-J)/h at J~0.1). The 50k TF-IDF probe: an h=1024 value
# signature's exact top-60 covers 0.976 of the true top-10, h=256 only
# 0.728; D=8192 sits near the former with a matmul join instead of value
# hamming's equality-compare. Clamped by row count so the f32 signature
# matrix stays <~2.5 GB (see resolve()).
DEFAULT_D_SIGN = 8192
# legacy full-value signature width (encode="value", old pickles)
DEFAULT_H_MINHASH = 256


def resolve(sparse_sketch, metric, n_features, n_rows=None):
    """Resolve the ``sparse_sketch`` constructor kwarg to a config dict or
    None (exact ELL path). ``"auto"`` enables sketching for supported
    metrics; an int picks the sketch width; None/False disables."""
    if sparse_sketch in (None, False):
        return None
    is_minhash = isinstance(metric, str) and metric in MINHASH_METRICS
    if not is_minhash and (not isinstance(metric, str) or metric not in SKETCH_METRICS):
        if sparse_sketch == "auto":
            return None
        raise ValueError(
            f"sparse_sketch is not supported for metric {metric!r}; "
            f"supported: {sorted(SKETCH_METRICS) + sorted(MINHASH_METRICS)}"
        )
    if sparse_sketch == "auto":
        h = DEFAULT_D_SIGN if is_minhash else DEFAULT_H
        if n_rows:
            # keep the [n, h] f32 sketch under ~2.5 GB of HBM
            h = min(h, max(2048, ((5 << 29) // (4 * int(n_rows))) // 128 * 128))
    else:
        h = int(sparse_sketch)
        if h < 16:
            raise ValueError(f"sparse_sketch width must be >= 16, got {h}")
    if is_minhash:
        # signature width is a sample count, not a feature projection —
        # never clamp it to n_features
        return {
            "kind": "minhash",
            "encode": "sign",
            "h": h,
            "internal": "euclidean",
            "binarize": True,
        }
    internal, binarize = SKETCH_METRICS[metric]
    h = min(h, n_features)
    return {"kind": "hash", "h": h, "internal": internal, "binarize": binarize}


def sketch_rows(csr, cfg, seed):
    """Sketch CSR rows under a resolved config dict (one of the three
    encoders below). ``encode`` defaults to "value" so pickles from before
    the sign encoding keep their original proxy space."""
    if cfg["kind"] == "minhash":
        if cfg.get("encode", "value") == "sign":
            return sign_minhash_sketch_csr(csr, cfg["h"], seed)
        return minhash_sketch_csr(csr, cfg["h"], seed)
    return sketch_csr(csr, cfg["h"], seed, cfg["binarize"])


def _hash_features(feat_idx, seed):
    """splitmix64 of (feature index, seed) -> uint64; deterministic across
    processes (no Python hash randomization)."""
    offset = np.uint64((0x9E3779B97F4A7C15 * (int(seed) + 1)) & 0xFFFFFFFFFFFFFFFF)
    z = feat_idx.astype(np.uint64) + offset
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def sketch_csr(csr, h, seed=0, binarize=False):
    """Project a CSR matrix into a dense [n, h] float32 sketch by signed
    feature hashing. Host-side numpy: O(nnz) scatter-adds via a CSR->dense
    product, negligible next to the device build it feeds."""
    from scipy import sparse as sp

    n = csr.shape[0]
    idx = np.asarray(csr.indices, dtype=np.int64)
    codes = _hash_features(idx, seed)
    bucket = ((codes >> np.uint64(32)) % np.uint64(h)).astype(np.int64)
    sign = 1.0 - 2.0 * (codes & np.uint64(1)).astype(np.float32)
    vals = (
        np.ones_like(sign)
        if binarize
        else np.asarray(csr.data, dtype=np.float32)
    )
    rows = np.repeat(
        np.arange(n, dtype=np.int64), np.diff(csr.indptr).astype(np.int64)
    )
    out = sp.coo_matrix(
        (vals * sign, (rows, bucket)), shape=(n, h)
    ).toarray()
    return np.ascontiguousarray(out, dtype=np.float32)


def _minhash_block(idx_block, h, seed):
    """[b, nnz] int32 feature ids (pad -1) -> [b, h] f32 minhash values.

    One murmur3-fmix32 per (feature, hash-slot) pair, minimum over the row's
    support. The returned value keeps 24 high bits so float32 represents it
    exactly (hamming's `!=` compare must be collision-exact)."""
    import jax.numpy as jnp

    pad = idx_block < 0
    f = idx_block.astype(jnp.uint32)
    t = jnp.arange(h, dtype=jnp.uint32) * jnp.uint32(0x9E3779B9) + jnp.uint32(
        (int(seed) * 0x85EBCA6B + 1) & 0xFFFFFFFF
    )
    z = f[:, :, None] ^ t[None, None, :]
    z = z ^ (z >> 16)
    z = z * jnp.uint32(0x85EBCA6B)
    z = z ^ (z >> 13)
    z = z * jnp.uint32(0xC2B2AE35)
    z = z ^ (z >> 16)
    z = jnp.where(pad[:, :, None], jnp.uint32(0xFFFFFFFF), z)
    mn = jnp.min(z, axis=1)
    return (mn >> 8).astype(jnp.float32)


def _sign_minhash_rows(idx_block, D, chunk, seed):
    """[b, nnz] int32 feature ids (pad -1) -> [b, D] f32 +-1 sign minhash.

    One murmur3-fmix32 per (feature, hash-slot) pair, min over the row's
    support, keep bit 8 of the minimum as the sign (the min's high bits
    carry its magnitude; mid/low bits of a fmix output stay uniform).
    Slots run in ``chunk``-wide pieces under lax.map so one dispatch covers
    the whole [b, D] tile without a [b, nnz, D] materialization."""
    import jax
    import jax.numpy as jnp

    pad = idx_block < 0
    f = idx_block.astype(jnp.uint32)
    salt = jnp.uint32((int(seed) * 0x85EBCA6B + 1) & 0xFFFFFFFF)

    def one_chunk(c0):
        t = (c0 * chunk + jnp.arange(chunk, dtype=jnp.uint32)) * jnp.uint32(
            0x9E3779B9
        ) + salt
        z = f[:, :, None] ^ t[None, None, :]
        z = z ^ (z >> 16)
        z = z * jnp.uint32(0x85EBCA6B)
        z = z ^ (z >> 13)
        z = z * jnp.uint32(0xC2B2AE35)
        z = z ^ (z >> 16)
        z = jnp.where(pad[:, :, None], jnp.uint32(0xFFFFFFFF), z)
        mn = jnp.min(z, axis=1)  # [b, chunk]
        return ((mn >> 8) & 1).astype(jnp.float32) * 2.0 - 1.0

    out = jax.lax.map(one_chunk, jnp.arange(D // chunk, dtype=jnp.uint32))
    return jnp.moveaxis(out, 0, 1).reshape(idx_block.shape[0], D)


def sign_minhash_sketch_csr(csr, D, seed=0):
    """Sign (1-bit) minhash of a CSR matrix's binary support: [n, D] f32 of
    +-1 where entry t is one bit of the t-th min-wise hash of the row's
    feature set. E[s_x . s_y] = D * Jaccard(x, y) + 0 (each slot matches
    w.p. J giving +1, else an independent fair coin giving 0 in
    expectation), so euclidean over the signs orders by estimated J with
    variance (1 - J^2)/D. Exactly representable in bfloat16."""
    import functools

    import jax
    import jax.numpy as jnp

    if D % 128:
        raise ValueError(f"sign-minhash width must be a multiple of 128, got {D}")
    csr = csr.tocsr()
    n = csr.shape[0]
    counts = np.diff(csr.indptr)
    nnz_max = max(1, int(counts.max(initial=1)))
    inds = np.full((n, nnz_max), -1, np.int32)
    rows = np.repeat(np.arange(n), counts)
    cols = np.arange(len(csr.indices)) - np.repeat(csr.indptr[:-1], counts)
    inds[rows, cols] = csr.indices

    chunk = 128
    while chunk < D and chunk < 1024 and D % (chunk * 2) == 0:
        chunk *= 2
    block_fn = jax.jit(
        functools.partial(_sign_minhash_rows, D=D, chunk=chunk, seed=seed)
    )
    # bound the per-step [b, nnz, chunk] u32 grid to ~2^24 lanes
    b = max(16, (1 << 24) // max(nnz_max * chunk, 1))
    out = np.empty((n, D), np.float32)
    for s in range(0, n, b):
        blk = inds[s : s + b]  # ragged tail retraces once; cheap
        out[s : s + blk.shape[0]] = np.asarray(block_fn(jnp.asarray(blk)))
    return out


def minhash_sketch_csr(csr, h, seed=0):
    """Minhash value signature of a CSR matrix's binary support: [n, h]
    float32 where entry t is the h-th min-wise hash of the row's feature
    set. P(sig_x[t] == sig_y[t]) = Jaccard(x, y) (up to 2^-24 collisions),
    so internal metric ``hamming`` over signatures estimates 1 - J with
    variance J(1-J)/h. Computed on device in row blocks (the hash grid is
    O(n * nnz * h) integer ops — elementwise work, trivial next to the
    build)."""
    import functools

    import jax
    import jax.numpy as jnp

    csr = csr.tocsr()
    n = csr.shape[0]
    counts = np.diff(csr.indptr)
    nnz_max = max(1, int(counts.max(initial=1)))
    inds = np.full((n, nnz_max), -1, np.int32)
    rows = np.repeat(np.arange(n), counts)
    cols = np.arange(len(csr.indices)) - np.repeat(csr.indptr[:-1], counts)
    inds[rows, cols] = csr.indices

    block_fn = jax.jit(functools.partial(_minhash_block, h=h, seed=seed))
    b = max(1, (1 << 24) // max(nnz_max * h, 1))  # ~64M u32 lanes per block
    out = np.empty((n, h), np.float32)
    for s in range(0, n, b):
        blk = inds[s : s + b]  # ragged tail retraces once; cheap
        out[s : s + blk.shape[0]] = np.asarray(block_fn(jnp.asarray(blk)))
    return out
