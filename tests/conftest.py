"""Test configuration: the CPU suite runs on a virtual 8-device CPU mesh.

Sharding tests use XLA's host-platform device-count override.  The
platform is whatever ``JAX_PLATFORMS`` names, CPU when it is unset;
tests marked ``chip`` need a GPU and skip without one (run them with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m chip``, which
``chip_smoke.py`` does on the card).
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import pytest  # noqa: E402

from trackmaker_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

# persistent compile cache: the suite compiles hundreds of programs on
# one CPU core; caching makes reruns dramatically faster
enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

_mods_seen: set[str] = set()


@pytest.fixture(autouse=True)
def _clear_jax_caches_per_module(request):
    """Release compiled executables between test modules.

    A single pytest session accumulates hundreds of live XLA:CPU
    executables; observed late-session SIGSEGVs inside
    `backend_compile_and_load` / the compilation-cache zstandard path
    never reproduce when the same tests run in a fresh process.
    Dropping executables at module boundaries keeps the live-code
    footprint bounded; the persistent on-disk cache makes the re-loads
    cheap."""
    mod = request.node.nodeid.split("::", 1)[0]
    if mod not in _mods_seen:
        _mods_seen.add(mod)
        jax.clear_caches()
    yield


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none.  Decided
    at run time, never at import, so every worker collects the same
    tests."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX platform is {devs[0].platform!r}")
    return devs[0]
