"""Debug modes: NaN guarding and determinism checks.

The single-threaded reference needs no race detection (SURVEY.md §5); the
equivalents here are (a) NaN-checked execution for flushing numeric
bugs out of jitted code and (b) bitwise determinism checks per PRNG key
(tests/test_properties.py::test_pipeline_deterministic_per_key).
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def nan_guard():
    """Raise on any NaN produced inside jitted code (jax_debug_nans).

    Slows execution (per-op checks + eager re-runs on failure) — a debug
    tool, not a production mode.
    """
    prev = jax.config.jax_debug_nans
    jax.config.update("jax_debug_nans", True)
    try:
        yield
    finally:
        jax.config.update("jax_debug_nans", prev)


def assert_deterministic(fn, *args, runs: int = 2):
    """Assert fn(*args) returns bitwise-identical pytrees across runs."""
    import numpy as np

    first = jax.tree_util.tree_map(lambda x: np.asarray(x), fn(*args))
    for _ in range(runs - 1):
        again = jax.tree_util.tree_map(lambda x: np.asarray(x), fn(*args))
        for a, b in zip(jax.tree_util.tree_leaves(first),
                        jax.tree_util.tree_leaves(again)):
            np.testing.assert_array_equal(a, b)
    return True
