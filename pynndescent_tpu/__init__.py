"""pynndescent_tpu — approximate-nearest-neighbor search on JAX.

Re-implements the full capability surface of ``lmcinnes/pynndescent``
(NN-descent k-NN graph construction, RP-forest initialisation, diversified
search-graph queries, incremental updates, quantization, a large metric
registry, and a scikit-learn compatible transformer) on JAX/XLA, designed
from scratch for accelerators; it runs on NVIDIA GPUs and on the CPU.
"""

__version__ = "0.1.0"

from pynndescent_tpu import ops, utils  # noqa: F401
from pynndescent_tpu.models.nndescent import NNDescent  # noqa: F401

__all__ = ["NNDescent", "PyNNDescentTransformer"]


def __getattr__(name):
    # the transformer needs scikit-learn (an optional extra): imported on
    # first use, so ``from pynndescent_tpu import NNDescent`` works without it
    if name == "PyNNDescentTransformer":
        from pynndescent_tpu.models.transformer import PyNNDescentTransformer

        return PyNNDescentTransformer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
