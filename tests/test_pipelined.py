"""Pipelined fused tracking (tracking.pipeline_depth > 0).

The fused tracking step chains device-to-device across frames (in-program
motion prediction, track_device.TrackStep._step) and the host confirms
whole batches with one fetch (tracking.Tracker._confirm_pipe).  These
tests pin the contract: pipelined runs produce the same kind of
trajectory as synchronous runs, flush() settles everything, and a frame
that fails its gates is replayed through the legacy state machine.
"""

import numpy as np
import pytest

from extractorb.config import (
    CameraConfig, ORBConfig, SLAMConfig, TrackingConfig,
)
from extractorb.slam.system import System
from extractorb.slam.tracking import TrackState

from extractorb.sim.scenes import H, W, render_sequence, umeyama_align


def _cfg(depth):
    return SLAMConfig(
        orb=ORBConfig(n_features=1000),
        camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                            width=W, height=H),
        tracking=TrackingConfig(max_frames=4, pipeline_depth=depth),
    )


def _ate(sys_, poses):
    traj = sys_.tracker.final_trajectory()
    idx = [int(round(ts * 30)) for ts, _, _ in traj]
    est = np.stack([-(R.T @ t) for _, R, t in traj])
    gt = np.stack([-(poses[i][0].T @ poses[i][1]) for i in idx])
    aligned = umeyama_align(est, gt)
    return float(np.sqrt(((aligned - gt) ** 2).sum(-1).mean()))


@pytest.mark.slow
def test_pipelined_matches_synchronous(scene_texture):
    frames, poses = render_sequence(scene_texture, n_frames=12)
    results = {}
    for depth in (0, 3):
        s = System(_cfg(depth))
        states = [s.track_monocular(img, k / 30.0)
                  for k, img in enumerate(frames)]
        s.flush()
        assert s.tracker.state == TrackState.OK, states
        # every frame lands a trajectory row after the flush
        assert len(s.tracker.trajectory) == len(frames), depth
        results[depth] = _ate(s, poses)
    # both modes track the synthetic scene accurately
    for depth, ate in results.items():
        assert ate < 0.15, results


@pytest.mark.slow
def test_pipelined_failure_replays_through_legacy(scene_texture):
    """Black frames mid-batch fail the fused gates; the tracker must
    settle in-flight frames through the legacy path (RECENTLY_LOST /
    relocalization) without crashing, then re-track."""
    frames, poses = render_sequence(scene_texture, n_frames=12)
    bad = np.zeros_like(frames[0])
    seq = frames[:7] + [bad, bad] + frames[7:]

    s = System(_cfg(3))
    for k, img in enumerate(seq):
        s.track_monocular(img, k / 30.0)
    s.flush()
    # the system survived and is tracking again (OK) or in a recovery
    # state with the original map intact
    assert s.tracker.state in (
        TrackState.OK, TrackState.RECENTLY_LOST, TrackState.LOST,
    )
    assert s.n_keyframes() >= 2
    # frames before the blackout all have committed trajectory rows
    assert len(s.tracker.trajectory) >= 7
