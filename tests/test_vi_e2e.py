"""Visual-inertial monocular e2e through the full System: rendered
frames + analytically consistent IMU samples (extractorb.sim.scenes); the staged IMU
initialisation (reference LocalMapping.cc:162-219) must fire and
recover METRIC scale (monocular-visual-only cannot).  Also covers
checkpoint/resume of an inertial session mid-sequence."""

import numpy as np
import pytest

from extractorb.config import (
    CameraConfig, IMUConfig, ORBConfig, SLAMConfig, TrackingConfig,
)
from extractorb.slam import checkpoint as ckpt
from extractorb.slam.system import System
from extractorb.slam.tracking import TrackState

from extractorb.sim.scenes import (
    H, VI_FPS as FPS, W, render_vi_sequence, umeyama_align, vi_imu_window,
    vi_pose as _pose,
)

IMU_HZ = 100.0


def _imu_window(t0, t1):
    return vi_imu_window(t0, t1, IMU_HZ)


def _vi_cfg():
    return SLAMConfig(
        orb=ORBConfig(n_features=1000),
        camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                            width=W, height=H, fps=FPS),
        imu=IMUConfig(noise_gyro=1e-4, noise_acc=1e-3,
                      gyro_walk=1e-6, acc_walk=1e-5,
                      frequency=IMU_HZ),
        tracking=TrackingConfig(max_frames=3),
        sensor="imu-monocular",
    )


@pytest.fixture(scope="module")
def vi_scene(scene_texture):
    return render_vi_sequence(scene_texture, n_frames=40)


@pytest.mark.slow
def test_vi_mono_e2e_metric_scale(vi_scene):
    frames, poses = vi_scene
    sys_ = System(_vi_cfg())
    states = []
    for k, img in enumerate(frames):
        ts = k / FPS
        imu = _imu_window((k - 1) / FPS, ts) if k else None
        states.append(sys_.track_monocular(img, ts, imu=imu))
    assert states[-1] == TrackState.OK, states
    # brief losses with recovery are acceptable; a terminal LOST is not
    assert all(s == TrackState.OK for s in states[-4:]), states
    mp = sys_.tracker.atlas.current
    assert mp.imu_initialized, "IMU init stage never fired"

    traj = sys_.tracker.final_trajectory()
    est = np.array([-R.T @ t for _, R, t in traj])
    gt = np.array([
        -_pose(ts)[0].T @ _pose(ts)[1] for ts, _, _ in traj
    ])
    # similarity alignment: after VI init the recovered scale must be
    # metric (|s - 1| small); visual-only mono has arbitrary scale
    aligned, s = umeyama_align(est, gt, return_scale=True)
    ate = float(np.sqrt(((aligned - gt) ** 2).sum(-1).mean()))
    # visual-only mono is arbitrary-scale; a recovered metric scale
    # within 35% demonstrates the inertial init actually fired and
    # resolved it (the staged VIBA refinements tighten it further)
    assert abs(s - 1.0) < 0.35, s
    assert ate < 0.25, ate


@pytest.mark.slow
def test_vi_session_resume(vi_scene, tmp_path):
    """Stop an inertial session mid-sequence, reload, keep tracking —
    the IMU queue, bias, preintegration chain and velocities must all
    survive the round trip (reference KeyFrame.h:56-146 surface)."""
    frames, poses = vi_scene
    cfg = _vi_cfg()
    sys_ = System(cfg)
    cut = 30
    for k in range(cut):
        ts = k / FPS
        imu = _imu_window((k - 1) / FPS, ts) if k else None
        sys_.track_monocular(frames[k], ts, imu=imu)
    assert sys_.state == TrackState.OK

    path = str(tmp_path / "vi_session.npz")
    ckpt.save_session(sys_.tracker, path)
    tr2 = ckpt.load_session(path, cfg)
    assert tr2.inertial and tr2.imu_queue is not None
    assert tr2.atlas.current.imu_initialized \
        == sys_.tracker.atlas.current.imu_initialized

    states = []
    for k in range(cut, len(frames)):
        ts = k / FPS
        states.append(tr2.track(frames[k], ts,
                                imu=_imu_window((k - 1) / FPS, ts)))
    assert all(s == TrackState.OK for s in states), states


@pytest.mark.slow
def test_vi_fused_pipelined_engages(vi_scene):
    """After gravity/scale resolve, inertial tracking must ride the
    fused one-program path (IMU prediction + in-program joint
    pose-inertial optimization with the prior chain) with pipelined
    confirmation — and keep metric scale."""
    frames, poses = vi_scene
    base = _vi_cfg()
    cfg = SLAMConfig(
        orb=base.orb, camera=base.camera, imu=base.imu,
        tracking=TrackingConfig(max_frames=3, pipeline_depth=3),
        sensor="imu-monocular",
    )
    sys_ = System(cfg)
    states = []
    for k, img in enumerate(frames):
        ts = k / FPS
        imu = _imu_window((k - 1) / FPS, ts) if k else None
        states.append(sys_.track_monocular(img, ts, imu=imu))
    sys_.flush()
    assert states[-1] == TrackState.OK, states
    mp = sys_.tracker.atlas.current
    assert mp.imu_initialized
    # the fused VI path must have processed a meaningful share of the
    # post-init frames
    assert sys_.tracker.n_fused_frames >= 8, sys_.tracker.n_fused_frames

    traj = sys_.tracker.final_trajectory()
    est = np.array([-R.T @ t for _, R, t in traj])
    gt = np.array([
        -_pose(ts)[0].T @ _pose(ts)[1] for ts, _, _ in traj
    ])
    aligned, s = umeyama_align(est, gt, return_scale=True)
    ate = float(np.sqrt(((aligned - gt) ** 2).sum(-1).mean()))
    assert abs(s - 1.0) < 0.35, s
    assert ate < 0.25, ate
