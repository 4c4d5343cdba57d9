"""Full-session checkpoint/resume (reference surface: the
boost::serialization graph in inc/KeyFrame.h:56-146 + SaveAtlas/
LoadAtlas, inc/System.h:180-186)."""

import numpy as np
import pytest
import jax.numpy as jnp

from extractorb.config import (
    CameraConfig, IMUConfig, ORBConfig, SLAMConfig, TrackingConfig,
)
from extractorb.imu import preintegration as pre
from extractorb.slam import checkpoint as ckpt
from extractorb.slam.map import KeyFrame, SLAMMap
from extractorb.slam.system import System
from extractorb.slam.tracking import TrackState

from extractorb.sim.scenes import H, W, render_sequence
from test_loop_closing import make_features


def test_keyframe_full_roundtrip(tmp_path, rng):
    """Every KeyFrame field — stereo channels, inertial state, the
    spanning tree, loop edges, raw IMU window, Preintegrated — must
    survive a save/load cycle."""
    mp = SLAMMap()
    n = 64
    desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    xy = rng.uniform(0, 600, (n, 2)).astype(np.float32)
    feats, xy_un, d_arr, v_arr = make_features(desc, xy)
    meas = (
        rng.normal(0, 0.1, (17, 3)).astype(np.float32),
        rng.normal(0, 1.0, (17, 3)).astype(np.float32),
        np.full(17, 0.005, np.float32),
    )
    preint = pre.init_preintegrated(jnp.asarray(np.arange(6, dtype=np.float32)))
    kf = KeyFrame(
        kid=-1, frame_id=3, timestamp=0.1,
        R=np.eye(3, dtype=np.float32), t=np.asarray([1, 2, 3], np.float32),
        feats=feats, xy_un=xy_un,
        octave=np.zeros(512, np.int32), angle=np.zeros(512, np.float32),
        desc=d_arr, valid=v_arr, kp_mp=np.full(512, -1, np.int32),
        ur=rng.uniform(-1, 600, 512).astype(np.float32),
        depth=rng.uniform(-1, 30, 512).astype(np.float32),
        v=np.asarray([0.1, 0.2, 0.3], np.float32),
        bg=np.asarray([1e-3, 2e-3, 3e-3], np.float32),
        ba=np.asarray([0.01, 0.02, 0.03], np.float32),
        parent=7, prev_kf=5, loop_edges=[2, 9],
        imu_meas=meas, preint=preint,
    )
    mp.add_keyframe(kf)
    mid = mp.add_point(np.asarray([0, 0, 5.0], np.float32), desc[0],
                       np.zeros(3), 10.0, kf.kid)
    mp.add_observation(mid, kf.kid, 0)
    mp.imu_initialized = True
    mp.imu_ba1 = True

    path = str(tmp_path / "map.npz")
    ckpt.save_map(mp, path)
    mp2 = ckpt.load_map(path)

    kf2 = mp2.keyframes[kf.kid]
    np.testing.assert_allclose(kf2.R, kf.R)
    np.testing.assert_allclose(kf2.ur, kf.ur)
    np.testing.assert_allclose(kf2.depth, kf.depth)
    np.testing.assert_allclose(kf2.v, kf.v)
    np.testing.assert_allclose(kf2.bg, kf.bg)
    np.testing.assert_allclose(kf2.ba, kf.ba)
    assert kf2.parent == 7 and kf2.prev_kf == 5
    assert kf2.loop_edges == [2, 9]
    for a, b in zip(kf2.imu_meas, meas):
        np.testing.assert_allclose(a, b)
    np.testing.assert_allclose(np.asarray(kf2.preint.bias),
                               np.arange(6, dtype=np.float32))
    np.testing.assert_allclose(np.asarray(kf2.preint.dR), np.eye(3))
    assert mp2.imu_initialized and mp2.imu_ba1 and not mp2.imu_ba2
    assert mp2.obs == mp.obs


@pytest.mark.slow
def test_session_resume_keeps_tracking(scene_texture, tmp_path):
    """Stop a monocular session mid-sequence, reload it into a fresh
    Tracker, and keep tracking the remaining frames without going LOST
    — the resumed run must keep extending the same trajectory."""
    frames, poses = render_sequence(scene_texture, n_frames=14)
    cfg = SLAMConfig(
        orb=ORBConfig(n_features=1000),
        camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                            width=W, height=H),
        tracking=TrackingConfig(max_frames=4),
    )
    sys_ = System(cfg)
    cut = 8
    for k in range(cut):
        sys_.track_monocular(frames[k], k / 30.0)
    assert sys_.state == TrackState.OK
    n_traj_at_cut = len(sys_.tracker.trajectory)

    path = str(tmp_path / "session.npz")
    ckpt.save_session(sys_.tracker, path)
    tr2 = ckpt.load_session(path, cfg)

    assert tr2.state == TrackState.OK
    assert len(tr2.trajectory) == n_traj_at_cut
    assert len(tr2.atlas.current.keyframes) == sys_.n_keyframes()

    states = [tr2.track(frames[k], k / 30.0) for k in range(cut, 14)]
    assert all(s == TrackState.OK for s in states), states
    assert len(tr2.trajectory) == n_traj_at_cut + (14 - cut)
