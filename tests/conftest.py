"""Test configuration: run on a virtual 8-device CPU mesh by default.

Must set env vars before jax initialises (SURVEY.md §4: multi-device
logic is validated with xla_force_host_platform_device_count, the piece
the reference lacks entirely).  An explicit JAX_PLATFORMS (for example
``cuda`` on a machine with a GPU) is honoured, so the ``gpu``-marked
tests can reach the card.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "parallel_codegen_split_count" not in flags:
    # this jaxlib's XLA:CPU parallel codegen segfaults intermittently
    # when compiling BA programs deep into the suite (observed twice at
    # the same mid-suite compile; single-test runs pass) — serialize it
    flags = (flags + " --xla_cpu_parallel_codegen_split_count=1").strip()
os.environ["XLA_FLAGS"] = flags

# The suite compiles hundreds of XLA:CPU executables whose JIT code
# pages accumulate ~45k+ memory mappings; at the default
# vm.max_map_count (65530) mmap starts failing ~halfway through and the
# LLVM JIT SEGFAULTS on the next big compile (observed 3x at ~48%,
# always inside backend_compile).  Raise the limit when we can
# (privileged container); harmless no-op otherwise.
try:
    with open("/proc/sys/vm/max_map_count") as _f:
        if int(_f.read()) < 1_000_000:
            with open("/proc/sys/vm/max_map_count", "w") as _g:
                _g.write("1000000")
except (OSError, PermissionError, ValueError):
    pass

# A pytest plugin (jaxtyping) can import jax BEFORE this conftest runs,
# which snapshots the environment's JAX_PLATFORMS into jax.config.  Set
# the already-imported config to the platform chosen above.
import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

# NOTE: do NOT enable the persistent compilation cache here — this
# jaxlib's XLA:CPU executable serialization segfaults intermittently
# when writing certain pose-graph/BA executables (observed crashing in
# compilation_cache.put_executable_and_time mid-suite).

import numpy as np  # noqa: E402
import pytest  # noqa: E402

REFERENCE_PIC = "/root/reference/pic"


@pytest.fixture(scope="session")
def luna_gray():
    """pic/luna.jpg as grayscale uint8 — the reference's main fixture."""
    import cv2

    img = cv2.imread(os.path.join(REFERENCE_PIC, "luna.jpg"), cv2.IMREAD_GRAYSCALE)
    assert img is not None
    return img


@pytest.fixture(scope="session")
def tum_pair():
    """Two TUM-VI corridor frames (the matcher demo's fixture)."""
    import cv2
    import glob

    paths = sorted(glob.glob(os.path.join(REFERENCE_PIC, "TUM", "*", "*.png")))
    if len(paths) < 2:
        paths = sorted(
            glob.glob(os.path.join(REFERENCE_PIC, "TUM", "**", "*.png"), recursive=True)
        )
    assert len(paths) >= 2, paths
    a = cv2.imread(paths[0], cv2.IMREAD_GRAYSCALE)
    b = cv2.imread(paths[1], cv2.IMREAD_GRAYSCALE)
    return a, b


@pytest.fixture(scope="session")
def scene_texture():
    """Seeded 1024x1024 texture of the synthetic two-plane scene."""
    from extractorb.sim import scenes

    return scenes.texture(0)


@pytest.fixture()
def gpu_device():
    """The first GPU; skips the test where JAX finds none.  Decided here,
    when the test runs, never while modules are collected."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {devices[0].platform}")
    return devices[0]


@pytest.fixture()
def rng():
    # function-scoped: a fresh fixed-seed generator per test, so scene
    # draws never depend on which tests ran before (order-flakiness)
    return np.random.default_rng(0)
