from pynndescent_tpu.models.nndescent import NNDescent  # noqa: F401


def __getattr__(name):
    # the transformer needs scikit-learn (an optional extra); import it on
    # first use so the index itself does not
    if name == "PyNNDescentTransformer":
        from pynndescent_tpu.models.transformer import PyNNDescentTransformer

        return PyNNDescentTransformer
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
