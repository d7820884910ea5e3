"""Test environment: force an 8-device virtual CPU mesh so sharding tests
stand in for several cards (SURVEY.md §4 'Implication').

Tests run on the CPU (``JAX_PLATFORMS=cpu``, the default here; Pallas
kernels in interpret mode). Tests that need the card carry the ``gpu``
marker and ask the ``gpu_device`` fixture, which skips them on the CPU;
on the card they run with ``JAX_PLATFORMS=cuda python -m pytest tests/
-m gpu``.
"""

import os

import jax

if os.environ.setdefault("JAX_PLATFORMS", "cpu") == "cpu":
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    # jax may be imported before this file: set the platform through
    # jax.config as well, before the first device query
    jax.config.update("jax_platforms", "cpu")
    assert jax.devices()[0].platform == "cpu"
    assert len(jax.devices()) == 8
jax.config.update("jax_enable_x64", False)

# Persistent on-disk compilation cache: with the aggressive clear_caches
# below (see fixture), re-JITs of shared stages become deserializations
# instead of full LLVM compiles. The cache directory is FINGERPRINTED by
# the host CPU: XLA:CPU AOT artifacts record the compile machine's
# feature set, and loading one on a host with different features
# SEGFAULTS inside the cache read (observed r5: a stale cache from a
# different container profile crashed test_ota_handover with the exact
# "machine features mismatch ... could lead to SIGILL" warning XLA
# prints). A per-host-profile directory makes a profile change a cache
# MISS instead of a crash.
import hashlib  # noqa: E402
import platform  # noqa: E402

from srsue_tpu.utils.jaxutil import use_compile_cache  # noqa: E402


def _cpu_fingerprint() -> str:
    """Hash of the machine and its CPU feature flags: only the first
    "flags" line of /proc/cpuinfo, so values that change per boot (clock
    rates, bogomips) do not move the cache."""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        flags = platform.platform()
    return hashlib.md5((platform.machine() + flags).encode()).hexdigest()[:10]


use_compile_cache(f"cpu-{_cpu_fingerprint()}")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


# ---------------------------------------------------------------------------
# XLA:CPU's JIT accumulates loaded executables per process; past a few
# hundred compilations the backend segfaults INSIDE backend_compile (LLVM
# code-memory exhaustion — observed deterministically ~30 modules into the
# suite, crash site varying with test order). Dropping compiled programs
# between modules keeps the live-executable count bounded. Costs recompiles
# of cross-module shared stages but keeps one `pytest tests/` process green.
# ---------------------------------------------------------------------------
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _bound_xla_cpu_executable_memory():
    # function-scoped since r3: a single OTA module's compilations can
    # exceed the code-memory budget on small hosts (observed segfault in
    # backend_compile inside tests/test_harq_ota.py standalone); the
    # persistent cache configured above keeps the recompile cost low.
    yield
    jax.clear_caches()


@pytest.fixture
def gpu_device():
    """The first GPU, for tests marked ``gpu``; skips where there is none
    (decided here, at run time, never while collecting)."""
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run on the card: see README)")
    return devs[0]
