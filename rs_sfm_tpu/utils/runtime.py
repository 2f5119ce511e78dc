"""Process set-up shared by the entry points (CLI, bench.py, chip_smoke.py):
the persistent compilation cache and the identity of the GPU.
"""

from __future__ import annotations

import os
import subprocess

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def setup_compile_cache() -> str:
    """Point JAX's persistent compilation cache at a fixed directory.

    If JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and nothing is
    set here.  Otherwise the cache lives at <checkout>/.jax_cache: a fixed
    path, since the path is part of the cache key.  Returns the directory.
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu():
    """The first device, which must be a GPU; raises otherwise (measuring
    paths never fall back to the CPU)."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise RuntimeError(f"no GPU: JAX found platform {dev.platform!r}")
    return dev


def nvidia_smi_name_power() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
