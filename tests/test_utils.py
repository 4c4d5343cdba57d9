"""CLAHE vs cv2, stage timer, verbose logging."""

import cv2
import numpy as np
import jax.numpy as jnp

from extractorb.utils.clahe import clahe
from extractorb.utils.timing import StageTimer


def test_clahe_close_to_cv2(luna_gray):
    img = cv2.resize(luna_gray, (640, 480))
    got = np.asarray(clahe(jnp.asarray(img), 3.0, 8))
    c = cv2.createCLAHE(3.0, (8, 8))
    exp = c.apply(img)
    diff = np.abs(got.astype(int) - exp.astype(int))
    assert diff.mean() < 3.0, diff.mean()
    assert np.median(diff) <= 2
    # contrast actually increased
    assert got.std() > img.std()


def test_stage_timer(tmp_path):
    t = StageTimer()
    with t.stage("extract"):
        sum(range(1000))
    with t.stage("extract"):
        sum(range(1000))
    with t.stage("pose-opt"):
        pass
    s = t.summary()
    assert s["extract"]["count"] == 2
    p = tmp_path / "times.csv"
    t.write_csv(str(p))
    assert "extract" in p.read_text()


def test_package_forces_full_matmul_precision():
    """With the default precision a GPU may run f32 matmuls in TF32
    (10-bit mantissa), which the solvers' float32 tolerances do not
    allow for.  Importing the package must pin full-precision f32
    matmuls."""
    import jax

    import extractorb  # noqa: F401

    assert jax.config.jax_default_matmul_precision == "highest"


def test_timestamp_guards():
    """Clock-sanity guards (reference Tracking.cc:1415-1451): a
    timestamp regression forks a fresh Atlas map; a >1 s jump drops the
    frame without corrupting state."""
    import numpy as np

    from extractorb.config import (
        CameraConfig, ORBConfig, SLAMConfig, TrackingConfig,
    )
    from extractorb.slam.system import System
    from extractorb.slam.tracking import TrackState

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (480, 640), np.uint8)
    cfg = SLAMConfig(
        orb=ORBConfig(n_features=300, max_kps_per_level=1024),
        camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                            width=640, height=480),
        tracking=TrackingConfig(max_frames=4),
    )
    s = System(cfg)
    s.track_monocular(img, 0.0)
    s.track_monocular(img, 1.0 / 30)
    n_maps = len(s.tracker.atlas.maps)
    # regression -> fresh map, frame dropped
    st = s.track_monocular(img, -5.0)
    assert len(s.tracker.atlas.maps) == n_maps + 1
    assert st in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED)
    # jump > 1 s on a visual-only run -> frame dropped, state unchanged
    s2 = System(cfg)
    s2.track_monocular(img, 0.0)
    st1 = s2.track_monocular(img, 1.0 / 30)
    st2 = s2.track_monocular(img, 10.0)
    assert st2 == st1
