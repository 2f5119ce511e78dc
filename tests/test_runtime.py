"""Process set-up and tooling: compile cache, device checks of the GPU
entry points, distributed start-up, PNG I/O, trace reduction."""

import os
import socket
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from rs_sfm_tpu.data.png import read_png, write_png
from rs_sfm_tpu.utils import runtime

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_dir(env_set, monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    try:
        if env_set:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert runtime.setup_compile_cache() == str(tmp_path)
            # Nothing is set in code: JAX reads the variable itself.
            assert jax.config.jax_compilation_cache_dir == before
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            want = os.path.join(_REPO, ".jax_cache")
            assert runtime.setup_compile_cache() == want
            assert jax.config.jax_compilation_cache_dir == want
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_bench_peaks_unknown_device_raises():
    import bench

    assert bench.peaks_for("NVIDIA H100 80GB HBM3")["hbm_bytes_s"] == 3.35e12
    with pytest.raises(RuntimeError, match="no peak rates"):
        bench.peaks_for("TFRT_CPU_0")


def test_chip_smoke_fails_without_gpu():
    """Its device phase must fail on the CPU, printing no result line."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=_REPO,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_distributed_initialize_unreachable_coordinator_fails():
    """Explicit arguments and no coordinator: the process must fail, not
    fall back to a single process."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = ("from rs_sfm_tpu.parallel.distributed import initialize\n"
            f"initialize('127.0.0.1:{port}', 2, 1, timeout=2)\n"
            "print('JOINED')\n")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=_REPO, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "JOINED" not in r.stdout


@pytest.mark.parametrize("shape", [(31, 45), (31, 45, 3)])
def test_png_round_trip(shape, tmp_path):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, img)
    back = read_png(path)
    assert back.shape == img.shape and back.dtype == np.uint8
    np.testing.assert_array_equal(back, img)


def test_device_stage_times_on_recorded_trace(tmp_path):
    """The trace reduction attributes kernels to the named-scope stages
    (innermost wins, feedback swallows what runs inside it)."""
    from rs_sfm_tpu.utils.profiling import device_stage_times, stage_of

    assert stage_of("jit(f)/flow_pyramid/flow_sor/while/body") == "flow_sor"
    assert stage_of("jit(f)/feedback/refine_lm/dot") == "feedback"
    assert stage_of("jit(f)/transpose") == "other"

    def f(x):
        with jax.named_scope("flow_sor"):
            y = jnp.sin(x) @ x
        with jax.named_scope("feedback"):
            with jax.named_scope("refine_lm"):
                y = jnp.cos(y) @ y
        return y.sum()

    x = jnp.ones((128, 128), jnp.float32)
    compiled = jax.jit(f).lower(x).compile()
    jax.block_until_ready(compiled(x))
    jax.profiler.start_trace(str(tmp_path))
    try:
        for _ in range(2):
            jax.block_until_ready(compiled(x))
    finally:
        jax.profiler.stop_trace()
    out = device_stage_times(str(tmp_path), [compiled.as_text()],
                             plane_prefix="/host:CPU")
    assert {"flow_sor", "feedback"} <= set(out["stage_ms"])
    assert 0.0 <= out["idle_share"] < 1.0
    assert out["busy_ms"] <= out["window_ms"]
