"""Sparse (CSR) data path.

Capability parity with the reference's sparse layer (``sparse.py``: merge-based
CSR-row primitives + ~25 sparse metrics; ``sparse_nndescent.py``: the CSR
descent driver). The mathematical distances are identical to the dense
metrics evaluated on the materialised vectors — the reference's sparse
kernels exist because *numba on CPU* benefits from skipping zeros.

On an accelerator it is the opposite: zero-skipping creates data-dependent
shapes the compiler cannot tile, while dense tiles run as matrix products at
full rate. The sparse strategy here is therefore **block densification**:

* CSR input is densified (whole-matrix when ``n_features`` is small enough
  to fit device memory — the overwhelmingly common regime for the reference's users),
  and the dense pipeline runs unchanged;
* the sparse metric registry maps every reference sparse metric name to its
  dense batched kernel, preserving the API surface
  (``sparse_named_distances``, reference sparse.py:1053-1095, and
  ``sparse_fast_distance_alternatives``, :1114-1133).

For n_features beyond the densification threshold the true-sparse padded-ELL
kernel path takes over (ops/sparse_ell.py): packed fixed-width rows, the full
sparse metric registry, ELL tree splits, and append-only updates.
"""

from __future__ import annotations

import numpy as np

from pynndescent_tpu.ops import distances as dst

# Above this many features, whole-matrix densification of CSR input is
# refused (n * n_features * 4 bytes would not fit device memory sensibly).
DENSIFY_MAX_FEATURES = 16384


def is_sparse(data) -> bool:
    return hasattr(data, "tocsr") and hasattr(data, "indptr")


def densify(data, max_features: int = DENSIFY_MAX_FEATURES) -> np.ndarray:
    """Materialise CSR input for the dense device pipeline."""
    csr = data.tocsr()
    if csr.shape[1] > max_features:
        raise ValueError(
            f"Refusing to densify sparse input with {csr.shape[1]} features "
            f"(> {max_features}); use the padded-ELL path (the NNDescent "
            "constructor selects it automatically for wide sparse input)."
        )
    return np.ascontiguousarray(csr.toarray().astype(np.float32))


def l2_normalize_rows(data):
    """Scale each CSR row to unit L2 norm; all-zero rows stay zero (the
    semantics of ``sklearn.preprocessing.normalize(norm="l2")``)."""
    csr = data.tocsr()
    csr = csr.astype(np.result_type(csr.dtype, np.float32), copy=True)
    norms = np.sqrt(np.asarray(csr.multiply(csr).sum(axis=1)).ravel())
    norms[norms == 0.0] = 1.0
    csr.data /= np.repeat(norms, np.diff(csr.indptr)).astype(csr.dtype)
    return csr


# Registry mirroring reference sparse.py:1053-1095. Implementations are the
# batched dense kernels — identical math on materialised rows.
sparse_named_distances = {
    "euclidean": dst.euclidean,
    "l2": dst.euclidean,
    "sqeuclidean": dst.squared_euclidean,
    "manhattan": dst.manhattan,
    "l1": dst.manhattan,
    "taxicab": dst.manhattan,
    "chebyshev": dst.chebyshev,
    "linf": dst.chebyshev,
    "linfty": dst.chebyshev,
    "linfinity": dst.chebyshev,
    "minkowski": dst.minkowski,
    "canberra": dst.canberra,
    "braycurtis": dst.bray_curtis,
    "hamming": dst.hamming,
    "jaccard": dst.jaccard,
    "dice": dst.dice,
    "matching": dst.matching,
    "kulsinski": dst.kulsinski,
    "rogerstanimoto": dst.rogers_tanimoto,
    "russellrao": dst.russellrao,
    "sokalmichener": dst.sokal_michener,
    "sokalsneath": dst.sokal_sneath,
    "cosine": dst.cosine,
    "correlation": dst.correlation,
    "wasserstein_1d": dst.wasserstein_1d,
    "wasserstein-1d": dst.wasserstein_1d,
    "kantorovich-1d": dst.wasserstein_1d,
    "kantorovich_1d": dst.wasserstein_1d,
    "hellinger": dst.hellinger,
    "jensen-shannon": dst.jensen_shannon_divergence,
    "jensen_shannon": dst.jensen_shannon_divergence,
    "symmetric-kl": dst.symmetric_kl_divergence,
    "symmetric_kl": dst.symmetric_kl_divergence,
    "symmetric_kullback_liebler": dst.symmetric_kl_divergence,
}

# Metrics that need the feature count in the reference's sparse form
# (reference sparse.py:1097-1105); densification supplies it implicitly.
sparse_need_n_features = (
    "hamming",
    "matching",
    "kulsinski",
    "rogerstanimoto",
    "russellrao",
    "sokalmichener",
    "correlation",
)

sparse_fast_distance_alternatives = {
    "euclidean": {"dist": dst.squared_euclidean, "correction": np.sqrt},
    "l2": {"dist": dst.squared_euclidean, "correction": np.sqrt},
    "cosine": {
        "dist": dst.alternative_cosine,
        "correction": dst.correct_alternative_cosine,
    },
    "dot": {
        "dist": dst.alternative_dot,
        "correction": dst.correct_alternative_cosine,
    },
    "hellinger": {
        "dist": dst.alternative_hellinger,
        "correction": dst.correct_alternative_hellinger,
    },
    "jaccard": {
        "dist": dst.alternative_jaccard,
        "correction": dst.correct_alternative_jaccard,
    },
}
