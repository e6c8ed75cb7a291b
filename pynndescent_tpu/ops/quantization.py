"""Prepare-time data quantization: binary / uint8 / uint4 codebooks.

Capability parity with the reference's quantization block
(``pynndescent_.py:2175-2263`` and the ``quantized_distances`` registry,
``distances.py:2241-2263``): the raw float data is compressed once at
``prepare()`` and searched with an asymmetric (float query vs quantized
candidate) distance, then reranked with the true metric.

Batched shape: the reference JIT-compiles per-pair scalar loops that decode one
byte at a time. Here the asymmetric distance *dequantizes candidate tiles on
the fly* — a [b, m, d] uint8 gather through the (at most 256-entry) codebook
stays on chip and feeds the same batched distance kernels
the float path uses. Bit-packed binary data uses lax.population_count.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from pynndescent_tpu.ops import distances as dst


def binary_codes(data: np.ndarray) -> np.ndarray:
    """packbits(data > 0) per row (reference pynndescent_.py:2178)."""
    return np.packbits((np.asarray(data) > 0).astype(np.uint8), axis=1)


def uint8_codebook(data: np.ndarray, random_state=None) -> np.ndarray:
    """256-quantile codebook from a 10k-row sample (reference :2193-2206)."""
    rs = np.random.RandomState(random_state if not isinstance(random_state, np.random.RandomState) else None)
    if isinstance(random_state, np.random.RandomState):
        rs = random_state
    sample = data[rs.choice(data.shape[0], min(10000, data.shape[0]), replace=False)].ravel()
    if len(np.unique(sample)) <= 256:
        return np.unique(sample).astype(np.float32)
    return np.quantile(sample, np.linspace(0, 1, 256)).astype(np.float32)


def uint8_codes(data: np.ndarray, codebook: np.ndarray) -> np.ndarray:
    return np.clip(np.searchsorted(codebook, data), 0, len(codebook) - 1).astype(np.uint8)


def uint4_codebook(data: np.ndarray, random_state=None) -> np.ndarray:
    rs = np.random.RandomState(random_state if not isinstance(random_state, np.random.RandomState) else None)
    if isinstance(random_state, np.random.RandomState):
        rs = random_state
    sample = data[rs.choice(data.shape[0], min(10000, data.shape[0]), replace=False)].ravel()
    return np.quantile(sample, np.linspace(0, 1, 16)).astype(np.float32)


def uint4_codes(data: np.ndarray, codebook: np.ndarray) -> np.ndarray:
    """Two 4-bit codes per byte, high nibble first (reference :2240-2247)."""
    codes8 = np.clip(np.searchsorted(codebook, data), 0, 15).astype(np.uint8)
    if codes8.shape[1] % 2 == 1:
        codes8 = np.pad(codes8, ((0, 0), (0, 1)))
    return ((codes8[:, ::2] << 4) | codes8[:, 1::2]).astype(np.uint8)


# ---------------------------------------------------------------------------
# Asymmetric rowwise distance builders: fn(Q float [b, d], C codes [b, m, *])
# ---------------------------------------------------------------------------


def make_uint8_rowwise(metric: str, codebook):
    """Asymmetric float-vs-uint8 rowwise distance (reference
    quantized_uint8_*, distances.py:1869-1984): dequantize candidate codes
    through the codebook, then the standard batched kernel."""
    codebook = jnp.asarray(codebook, jnp.float32)

    if metric in ("euclidean", "l2", "sqeuclidean"):
        def fn(Q, C):
            Y = codebook[C.astype(jnp.int32)]  # [b, m, d]
            return dst.pairwise_rowwise("sqeuclidean", Q, Y)
    elif metric == "cosine":
        def fn(Q, C):
            Y = codebook[C.astype(jnp.int32)]
            sim = 1.0 - dst.cosine(Q[:, None, :], Y)
            # reference maps sim -> -log2((sim + 1) / 2) (distances.py:1935)
            bad = sim <= 0.0
            return jnp.where(
                bad, dst.FLOAT32_MAX, -jnp.log2(jnp.clip((sim + 1.0) / 2.0, 1e-30, None))
            )
    elif metric == "dot":
        def fn(Q, C):
            Y = codebook[C.astype(jnp.int32)]
            num = jnp.einsum("bd,bmd->bm", Q, Y, precision=dst.HIGHEST)
            ny = jnp.sqrt(jnp.sum(Y * Y, axis=-1))
            val = num / jnp.maximum(ny, 1e-30)
            return jnp.where(val <= 0.0, dst.FLOAT32_MAX, -jnp.log2(jnp.maximum(val, 1e-30)))
    else:
        raise ValueError(f"No uint8 quantized version of metric '{metric}'")
    return fn


def make_uint4_rowwise(metric: str, codebook, dim: int):
    """Asymmetric float-vs-uint4 rowwise distance (reference
    quantized_uint4_*, distances.py:1986-2100)."""
    codebook = jnp.asarray(codebook, jnp.float32)

    def dequant(C):
        hi = (C >> 4).astype(jnp.int32)
        lo = (C & 0x0F).astype(jnp.int32)
        codes = jnp.stack([hi, lo], axis=-1).reshape(*C.shape[:-1], -1)[..., :dim]
        return codebook[codes]

    if metric in ("euclidean", "l2", "sqeuclidean"):
        def fn(Q, C):
            return dst.pairwise_rowwise("sqeuclidean", Q, dequant(C))
    elif metric == "cosine":
        def fn(Q, C):
            Y = dequant(C)
            sim = 1.0 - dst.cosine(Q[:, None, :], Y)
            bad = sim <= 0.0
            return jnp.where(
                bad, dst.FLOAT32_MAX, -jnp.log2(jnp.clip((sim + 1.0) / 2.0, 1e-30, None))
            )
    elif metric == "dot":
        def fn(Q, C):
            Y = dequant(C)
            num = jnp.einsum("bd,bmd->bm", Q, Y, precision=dst.HIGHEST)
            ny = jnp.sqrt(jnp.sum(Y * Y, axis=-1))
            val = num / jnp.maximum(ny, 1e-30)
            return jnp.where(val <= 0.0, dst.FLOAT32_MAX, -jnp.log2(jnp.maximum(val, 1e-30)))
    else:
        raise ValueError(f"No uint4 quantized version of metric '{metric}'")
    return fn


def make_binary_rowwise(metric: str):
    """Float query packed to bits vs bit-packed candidates. Queries must be
    packed by the caller (reference packs queries at :2314-2334)."""
    if metric in ("euclidean", "l2", "hamming"):
        name = "bit_hamming"
    elif metric in ("cosine", "dot", "jaccard"):
        name = "bit_jaccard"
    else:
        raise ValueError(f"No binary quantized version of metric '{metric}'")
    base = dst.named_distances[name]
    return lambda Q, C: base(Q[:, None, :], C)
