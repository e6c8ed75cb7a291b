"""Launch-side contracts: the compile-cache location of bench.py and
chip_smoke.py, an install without scikit-learn, and chip_smoke.py's refusal
to run anywhere but on a GPU. Each runs in a fresh CPU subprocess, so no
JAX state leaks into (or out of) the test process."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _run(args, cwd=REPO, env_extra=None, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env["JAX_PLATFORMS"] = "cpu"
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, *args], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


@pytest.mark.parametrize("env_set", [True, False], ids=["env_set", "env_unset"])
def test_compile_cache_dir(tmp_path, env_set):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is the cache and no
    other is configured; without it, the fixed .jax_cache/ of the checkout."""
    code = (
        "import bench, jax; print(bench.configure_compile_cache()); "
        "print(jax.config.jax_compilation_cache_dir)"
    )
    extra = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if env_set else None
    out = _run(["-c", code], env_extra=extra, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert out.returncode == 0, out.stderr
    returned, configured = out.stdout.split()
    want = str(tmp_path) if env_set else str(REPO / ".jax_cache")
    assert returned == configured == want


def test_nndescent_imports_without_sklearn():
    code = """
import sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name == "sklearn" or name.startswith("sklearn."):
            raise ImportError("scikit-learn is not installed")

sys.meta_path.insert(0, Block())
import numpy as np
from pynndescent_tpu import NNDescent

X = np.random.RandomState(0).rand(64, 4).astype(np.float32)
idx, _ = NNDescent(X, n_neighbors=4, random_state=0, n_trees=1).neighbor_graph
assert idx.shape == (64, 4)
assert not any(m.startswith("sklearn") for m in sys.modules)
import pynndescent_tpu
try:
    pynndescent_tpu.PyNNDescentTransformer
except ImportError:
    print("transformer needs sklearn")
"""
    out = _run(["-c", code])
    assert out.returncode == 0, out.stderr
    assert "transformer needs sklearn" in out.stdout


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_chip_smoke_refuses_non_gpu(tmp_path, where):
    """On the CPU (and in a directory holding nothing else of the repo) the
    smoke script exits non-zero and never prints an ok line."""
    cwd = REPO
    if where == "alone":
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd = tmp_path
    out = _run(["chip_smoke.py"], cwd=cwd)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs an NVIDIA GPU" in out.stderr
