"""Test configuration: CPU JAX with 8 virtual devices.

The tests run on the CPU backend (JAX_PLATFORMS=cpu); the mesh and
sharding tests use 8 virtual CPU devices.  Code that needs the GPU is
exercised by chip_smoke.py on the card.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

REF_TESTS = pathlib.Path("/root/reference/tests")
REF_BIN = pathlib.Path("/tmp/refbin")


def pytest_configure(config):
    """Oracle parity tests must not skip silently (round-3 lesson: a
    regression shipped because /tmp/refbin was absent and every parity
    test quietly skipped).  If the reference oracle binaries are missing,
    build them here — and if that fails, ERROR the session rather than
    skip.  Set TPUMAP_NO_ORACLE=1 to opt out explicitly (e.g. machines
    without the reference tree)."""
    if os.environ.get("TPUMAP_NO_ORACLE") == "1":
        return
    if not pathlib.Path("/root/reference/src").is_dir():
        return  # no reference tree on this machine; skipif marks apply
    if (REF_BIN / "gmap").exists() and (REF_BIN / "gsnap").exists():
        return
    build = REPO / "tools" / "build_reference.py"
    print("\n[conftest] /tmp/refbin missing -> building reference oracle "
          "binaries (tools/build_reference.py)...", flush=True)
    r = subprocess.run([sys.executable, str(build)], timeout=3600)
    if r.returncode != 0 or not (REF_BIN / "gmap").exists():
        raise pytest.UsageError(
            "reference oracle binaries unavailable and the build failed; "
            "parity tests would silently skip. Fix tools/build_reference.py "
            "or set TPUMAP_NO_ORACLE=1 to acknowledge running without "
            "oracle coverage.")


def have_ref_binary(name: str) -> bool:
    return (REF_BIN / name).exists()


@pytest.fixture(scope="session")
def ref_tests_dir():
    if not REF_TESTS.is_dir():
        pytest.skip("reference test fixtures unavailable")
    return REF_TESTS


def pytest_runtest_teardown(item, nextitem):
    """Periodically drop JAX's in-memory executable caches.

    A single long pytest process accumulates hundreds of live compiled
    executables; past ~300 tests the XLA CPU executable
    serialize/deserialize path segfaults (observed twice at different
    tests, always inside jax's compilation-cache read/write after the
    same cumulative load; jaxlib 0.9.0).  Clearing the in-process
    caches between modules bounds the live-executable count — the
    persistent on-disk cache makes re-loads cheap."""
    import sys
    mod = sys.modules[__name__]
    mod._teardown_count = getattr(mod, "_teardown_count", 0) + 1
    if mod._teardown_count % 60 == 0:
        import jax
        try:
            jax.clear_caches()
        except Exception:
            pass
