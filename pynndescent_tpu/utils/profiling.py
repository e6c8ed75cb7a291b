"""Structured phase timings + optional JAX profiler trace capture.

The reference's only observability is wall-clock ``ts()`` prints at phase
boundaries (reference utils.py:881-883, pynndescent_.py:1116-1117 etc.).
The replacement here (SURVEY §5): a per-index dict of phase seconds
(``NNDescent(..., profile=True)`` → ``index.phase_times_``) and, when
``profile`` is a directory path, a ``jax.profiler.trace`` capture of the
build for xprof/tensorboard.

Timing truthfulness on an async backend: each phase exit waits for the
arrays the phase produced (``jax.block_until_ready``). When profiling is
off, no sync points are added — the build keeps its fully-async dispatch.
"""

from __future__ import annotations

import contextlib
import time


class PhaseTimer:
    """Accumulates wall seconds per named phase. Disabled instances are
    zero-overhead no-ops so the hot path can call them unconditionally."""

    def __init__(self, profile=False):
        self.enabled = bool(profile)
        self.trace_dir = profile if isinstance(profile, str) else None
        self.times: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name):
        if not self.enabled:
            yield self
            return
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            self.times[name] = (
                self.times.get(name, 0.0) + time.perf_counter() - t0
            )

    @contextlib.contextmanager
    def trace(self):
        """One profiler trace over the enclosing region (the whole build) —
        jax.profiler.trace does not nest, so this wraps once, not per phase."""
        if self.trace_dir is None:
            yield
            return
        import jax

        with jax.profiler.trace(self.trace_dir):
            yield

    def block(self, *arrays):
        """Wait for device arrays at a phase boundary (no-op when profiling
        is off)."""
        if self.enabled:
            import jax

            jax.block_until_ready(arrays)
        return arrays[0] if len(arrays) == 1 else arrays
