"""chip_smoke.py's own logic on the CPU: the device guard, the result
line, the comparison functions of the extraction-parity phase, the
multi-device comparisons on a virtual mesh, and the compile-cache
helper the entry scripts share."""

import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

from extractorb.config import ORBConfig  # noqa: E402
from extractorb.frontend.matcher import hamming_matrix  # noqa: E402
from extractorb.sim import scenes  # noqa: E402


def _fake_device(platform="gpu", kind="NVIDIA H100 80GB HBM3"):
    return types.SimpleNamespace(platform=platform, device_kind=kind)


def test_device_guard_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        cs.require_gpu(jax.devices())
    with pytest.raises(SystemExit, match="needs 4 GPUs"):
        cs.require_gpu([_fake_device()], count=4)
    cs.require_gpu([_fake_device()] * 4, count=4)


def test_script_fails_without_a_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
    assert "needs a GPU" in out.stderr


def test_final_line_names_the_device():
    line = cs.final_line([_fake_device()])
    assert line == ('{"ok": true, "device": {"platform": "gpu", '
                    '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}')
    four = json.loads(cs.final_line([_fake_device()] * 4))
    assert four["device"]["count"] == 4 and four["ok"] is True
    cpu = json.loads(cs.final_line(jax.devices()[:1]))
    assert cpu["device"]["platform"] == "cpu"


def test_bitwise_mismatches_counts_elements():
    a = {"x": np.arange(6, dtype=np.float32), "y": np.zeros(3, np.uint8)}
    b = {"x": a["x"].copy(), "y": np.zeros(4, np.uint8)}
    b["x"][2] += 1
    got = cs.bitwise_mismatches(a, b)
    assert got["y"] == 3                      # shape mismatch: every element
    assert got["x"] >= 1                      # bytes of the changed float
    assert cs.bitwise_mismatches(a, a) == {"x": 0, "y": 0}


def test_hamming_reference_matches_device_matrix(rng):
    d1 = rng.integers(0, 256, (70, 32), np.uint8)
    d2 = rng.integers(0, 256, (50, 32), np.uint8)
    ref = cs.hamming_numpy(d1, d2)
    np.testing.assert_array_equal(
        np.asarray(hamming_matrix(jnp.asarray(d1), jnp.asarray(d2))), ref)
    assert ref[0, 0] == int(np.unpackbits(d1[0] ^ d2[0]).sum())


def test_extraction_parity_cpu_against_cpu(scene_texture):
    """Phase (a)'s comparison between two devices of one process, here
    two virtual CPU devices at a reduced size."""
    cfg = ORBConfig(n_features=300, n_levels=4, max_kps_per_level=1024)
    img = scenes.render_sequence(scene_texture, 1)[0][0][:240, :320].copy()
    d0, d1 = jax.devices()[0], jax.devices()[1]
    a = cs.extraction_outputs(d0, img, cfg)
    b = cs.extraction_outputs(d1, img, cfg)
    assert len(a) == 3 * cfg.n_levels + 6
    assert a["valid"].sum() >= 250
    assert sum(cs.bitwise_mismatches(a, b).values()) == 0
    assert cs.octree_agreement(a, a) == 0.0


def test_multi_device_checks_on_virtual_mesh():
    """The --cards 4 comparisons, rehearsed on four virtual CPU devices
    at a small size: every sharded solver agrees with its single-device
    counterpart and its arrays span the four devices."""
    cs.multi_device_checks(jax.devices()[:4], "virtual cpu mesh", n_kf=16,
                           n_pts=480, obs_per_pt=5, n_loops=8)


@pytest.mark.gpu
def test_extraction_parity_on_gpu(gpu_device, scene_texture):
    cfg = ORBConfig()
    img = scenes.render_sequence(scene_texture, 1)[0][0]
    a = cs.extraction_outputs(gpu_device, img, cfg)
    b = cs.extraction_outputs(jax.devices("cpu")[0], img, cfg)
    assert sum(cs.bitwise_mismatches(a, b).values()) == 0


@pytest.mark.parametrize("env_dir", [None, "given"])
def test_compile_cache_location(tmp_path, env_dir):
    """With JAX_COMPILATION_CACHE_DIR set, JAX keeps it and no other
    directory is set; without it the cache is <checkout>/.jax_cache.
    Run in a child so the test process keeps no persistent cache."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / env_dir)
    code = ("import jax; from extractorb.utils.compile_cache import "
            "enable_compile_cache as e; print(e()); "
            "print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    returned, configured = out.stdout.split()[-2:]
    want = str(tmp_path / env_dir) if env_dir else os.path.join(ROOT, ".jax_cache")
    assert returned == configured == want


def test_extract_device_time_reduction_and_guard():
    """tools/extract_device_time.py: the busy-time union of trace
    intervals, the package lookup in a checkout, and its GPU guard."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import extract_device_time as edt

    assert edt.busy_ns([(30, 40), (0, 10), (5, 20), (32, 35)]) == 30
    assert edt.busy_ns([(0, 5), (5, 7)]) == 7
    assert edt.busy_ns([]) == 0
    assert edt.load_package(ROOT).__name__ == "extractorb"
    with pytest.raises(SystemExit, match="needs a GPU"):
        edt.main([])
