"""Test configuration: CPU with 8 virtual devices, x64 enabled.

Multi-device sharding is tested on a virtual 8-device CPU mesh; numerical
parity tests run in float64 like the reference's double-precision
Eigen/Ceres code.  The platform is the CPU unless JAX_PLATFORMS names
another: the tests marked `gpu` run on the card with

    JAX_PLATFORMS=cuda python -m pytest tests -m gpu
"""

import os

# A long pytest run compiles hundreds of CPU executables; LLVM's JIT creates
# several memory mappings per executable and the kernel default
# vm.max_map_count (65530) is low enough to fail mid-suite with
# "LLVM compilation error: Cannot allocate memory" → SIGSEGV.  Raise it when
# we can (tests run as root in CI); ignore failures elsewhere.
try:
    if os.environ.get("RS_SFM_NO_SYSCTL", "0") != "1":
        with open("/proc/sys/vm/max_map_count") as _f:
            _old_map_count = int(_f.read())
        if _old_map_count < 1_000_000:
            with open("/proc/sys/vm/max_map_count", "w") as _g:
                _g.write("1048576")
            # Host-wide kernel state: restore the previous value when the
            # test process exits (set RS_SFM_NO_SYSCTL=1 to skip entirely).
            import atexit

            def _restore(old=_old_map_count):
                try:
                    with open("/proc/sys/vm/max_map_count", "w") as f:
                        f.write(str(old))
                except OSError:
                    pass

            atexit.register(_restore)
except OSError:
    pass

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", True)
