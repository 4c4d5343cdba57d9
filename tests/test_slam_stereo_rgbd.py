"""End-to-end stereo and RGBD SLAM on the synthetic two-plane scene.

Exercises System.track_stereo / track_rgbd (reference System.cc:222/:288):
stereo initialization from depth (no two-view RANSAC), stereo pose
optimisation (3-dim residuals), close-point keyframe insertion, and the
metric scale these sensors pin down (checked against ground truth).
"""

import numpy as np
import pytest

from extractorb.config import (
    CameraConfig, ORBConfig, SLAMConfig, TrackingConfig,
)
from extractorb.slam.system import System
from extractorb.slam.tracking import TrackState
from extractorb.sim.scenes import BF, H, W, render_rgbd, render_stereo_pair


def _cfg():
    return SLAMConfig(
        orb=ORBConfig(n_features=1000),
        camera=CameraConfig(
            fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=W, height=H,
            bf=BF, th_depth=40.0,
        ),
        tracking=TrackingConfig(max_frames=4),
        sensor="rgbd",
    )


@pytest.mark.slow
def test_rgbd_e2e_metric_trajectory(scene_texture):
    frames, depths, poses = render_rgbd(scene_texture, n_frames=10)
    s = System(_cfg())
    states = []
    for k, (img, dep) in enumerate(zip(frames, depths)):
        states.append(s.track_rgbd(img, dep, k / 30.0))
    # RGBD initialises on the FIRST frame (no two-view init needed)
    assert states[0] == TrackState.OK, states
    assert all(st == TrackState.OK for st in states), states
    assert s.n_keyframes() >= 2
    assert s.n_map_points() > 200

    traj = s.tracker.trajectory
    assert len(traj) == len(frames)
    est = np.array([-(R.T @ t) for _, R, t in traj])
    gt = np.array([-(R.T @ t) for R, t in poses])
    # metric scale: no Sim3 needed — direct SE3 comparison after origin
    # alignment (first camera is the world origin in both)
    err = np.linalg.norm(est - gt, axis=1)
    assert err.max() < 0.08, err  # 8 cm on a ~1.1 m trajectory
    # scale is pinned by depth: total path length within 5%
    len_est = np.linalg.norm(np.diff(est, axis=0), axis=1).sum()
    len_gt = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    assert abs(len_est / len_gt - 1.0) < 0.05, (len_est, len_gt)


@pytest.mark.slow
def test_stereo_e2e_tracks(scene_texture):
    """Stereo pair rendered with a second camera displaced by the
    baseline along camera x; track_stereo must initialise from disparity
    and keep tracking with metric scale."""
    n_frames = 8
    frames_l, frames_r, poses = render_stereo_pair(scene_texture, n_frames)

    cfg = _cfg()
    s = System(cfg)
    states = []
    for k, (il, ir) in enumerate(zip(frames_l, frames_r)):
        states.append(s.track_stereo(il, ir, k / 30.0))
    assert states[0] == TrackState.OK, states
    n_ok = sum(st == TrackState.OK for st in states)
    assert n_ok >= n_frames - 1, states
    assert s.n_map_points() > 100

    traj = s.tracker.trajectory
    est = np.array([-(R.T @ t) for _, R, t in traj])
    gt = np.array([-(R.T @ t) for R, t in poses])[: len(est)]
    err = np.linalg.norm(est - gt, axis=1)
    assert err.max() < 0.15, err


@pytest.mark.slow
def test_stereo_pipelined_fused_path(scene_texture):
    """Stereo through the fused/pipelined one-program path (stereo
    match + 3-dim stereo residuals in-program, close-point counters
    riding the confirmation fetch): same metric-scale accuracy as the
    synchronous path, and the fused path must actually engage."""
    n_frames = 10
    frames_l, frames_r, poses = render_stereo_pair(scene_texture, n_frames)

    cfg = _cfg()
    cfg = SLAMConfig(
        orb=cfg.orb, camera=cfg.camera,
        tracking=TrackingConfig(max_frames=4, pipeline_depth=3),
        sensor="stereo",
    )
    s = System(cfg)
    states = []
    for k, (il, ir) in enumerate(zip(frames_l, frames_r)):
        states.append(s.track_stereo(il, ir, k / 30.0))
    s.flush()
    assert states[0] == TrackState.OK, states
    assert s.tracker.n_fused_frames >= n_frames - 3, \
        s.tracker.n_fused_frames
    assert s.n_map_points() > 100

    traj = s.tracker.final_trajectory()
    est = np.array([-(R.T @ t) for _, R, t in traj])
    gt = np.array([-(R.T @ t) for R, t in poses])[: len(est)]
    err = np.linalg.norm(est - gt, axis=1)
    assert err.max() < 0.15, err
    # metric scale pinned by the in-program stereo depth
    len_est = np.linalg.norm(np.diff(est, axis=0), axis=1).sum()
    len_gt = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    assert abs(len_est / len_gt - 1.0) < 0.07, (len_est, len_gt)


@pytest.mark.slow
def test_rgbd_pipelined_fused_path(scene_texture):
    """RGBD through the fused path: the depth map rides the frame upload
    and is sampled at the raw keypoint coords in-program (reference
    ComputeStereoFromRGBD)."""
    frames, depths, poses = render_rgbd(scene_texture, n_frames=10)
    base = _cfg()
    cfg = SLAMConfig(
        orb=base.orb, camera=base.camera,
        tracking=TrackingConfig(max_frames=4, pipeline_depth=3),
        sensor="rgbd",
    )
    s = System(cfg)
    states = [s.track_rgbd(img, dep, k / 30.0)
              for k, (img, dep) in enumerate(zip(frames, depths))]
    s.flush()
    assert states[0] == TrackState.OK, states
    assert s.tracker.n_fused_frames >= 5, s.tracker.n_fused_frames

    traj = s.tracker.final_trajectory()
    est = np.array([-(R.T @ t) for _, R, t in traj])
    gt = np.array([-(R.T @ t) for R, t in poses])[: len(est)]
    err = np.linalg.norm(est - gt, axis=1)
    assert err.max() < 0.1, err
    len_est = np.linalg.norm(np.diff(est, axis=0), axis=1).sum()
    len_gt = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    assert abs(len_est / len_gt - 1.0) < 0.06, (len_est, len_gt)


def test_th_far_points_gate(scene_texture):
    """thFarPoints (reference System.cc:183): stereo/RGBD observations
    deeper than the threshold never become map points."""
    # single init frame: the only creation path is the stereo/RGBD
    # depth unprojection the gate applies to (triangulated points are
    # legitimately allowed past thFarPoints, like the reference)
    frames, depths, poses = render_rgbd(scene_texture, n_frames=1)
    base = _cfg()
    from dataclasses import replace
    for far, expect_far_points in ((0.0, True), (4.0, False)):
        cfg = SLAMConfig(
            orb=base.orb,
            camera=replace(base.camera, th_far_points=far),
            tracking=TrackingConfig(max_frames=2),
            sensor="rgbd",
        )
        s = System(cfg)
        s.track_rgbd(frames[0], depths[0], 0.0)
        mp = s.tracker.atlas.current
        pts = mp.mp_pos[: mp._next_mp][mp.mp_valid[: mp._next_mp]]
        # the far wall sits at z=5 (world == first camera frame)
        has_far = bool((pts[:, 2] > 4.5).any())
        assert has_far == expect_far_points, (far, has_far)
