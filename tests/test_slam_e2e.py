"""End-to-end monocular SLAM on a synthetic planar scene with known
ground-truth poses (milestone M1, BASELINE config 3 analog).

A seeded textured two-plane scene is rendered through a moving pinhole
camera (extractorb.sim.scenes); the tracker must initialise, track every
frame and produce a trajectory whose Sim3-aligned ATE is small.
"""

import numpy as np
import pytest

from extractorb.config import CameraConfig, ORBConfig, SLAMConfig, TrackingConfig
from extractorb.sim.scenes import H, W, render_sequence, umeyama_align
from extractorb.slam.system import System
from extractorb.slam.tracking import TrackState


@pytest.mark.slow
def test_mono_slam_planar_sequence(scene_texture):
    frames, poses = render_sequence(scene_texture)

    cfg = SLAMConfig(
        orb=ORBConfig(n_features=1000),
        camera=CameraConfig(
            fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=W, height=H,
        ),
        tracking=TrackingConfig(max_frames=6),
    )
    sys_ = System(cfg)
    states = []
    for k, img in enumerate(frames):
        st = sys_.track_monocular(img, k / 30.0)
        states.append(st)

    assert states[-1] == TrackState.OK, states
    n_ok = sum(1 for s in states if s == TrackState.OK)
    assert n_ok >= len(frames) - 3, states
    assert sys_.n_map_points() > 100
    assert sys_.n_keyframes() >= 2

    # ATE after Sim3 alignment
    traj = sys_.tracker.trajectory
    assert len(traj) >= len(frames) - 3
    est_centers = np.array([-R.T @ t for _, R, t in traj])
    # ground truth centers for the tracked timestamps
    ts_list = [ts for ts, _, _ in traj]
    gt_centers = []
    for ts in ts_list:
        k = int(round(ts * 30.0))
        R, t = poses[k]
        gt_centers.append(-R.T @ t)
    gt_centers = np.array(gt_centers)
    aligned = umeyama_align(est_centers, gt_centers)
    ate = np.sqrt(((aligned - gt_centers) ** 2).sum(-1).mean())
    scene_scale = np.linalg.norm(gt_centers[-1] - gt_centers[0])
    assert ate < 0.05 * max(scene_scale, 1.0), (ate, scene_scale)


def test_trajectory_saver(tmp_path, scene_texture):
    frames, _ = render_sequence(scene_texture, n_frames=4)
    cfg = SLAMConfig(
        camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                            width=W, height=H),
    )
    sys_ = System(cfg)
    for k, img in enumerate(frames):
        sys_.track_monocular(img, k / 30.0)
    p = tmp_path / "traj.txt"
    sys_.save_trajectory_tum(str(p))
    lines = p.read_text().strip().splitlines()
    if lines:
        parts = lines[0].split()
        assert len(parts) == 8
