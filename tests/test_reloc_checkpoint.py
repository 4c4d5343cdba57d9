"""Relocalization after tracking loss + map checkpoint roundtrip."""

import numpy as np
import pytest
import jax.numpy as jnp

from extractorb.config import CameraConfig, ORBConfig, SLAMConfig, TrackingConfig
from extractorb.slam import checkpoint as ckpt
from extractorb.slam.system import System
from extractorb.slam.tracking import TrackState

from extractorb.sim.scenes import H, W, render_sequence


@pytest.fixture(scope="module")
def scene(scene_texture):
    return render_sequence(scene_texture, n_frames=12)


def run_system(scene, interrupt=False):
    frames, poses = scene
    cfg = SLAMConfig(
        orb=ORBConfig(n_features=1000),
        camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                            width=W, height=H),
        tracking=TrackingConfig(max_frames=4),
    )
    sys_ = System(cfg)
    states = []
    black = np.zeros((H, W), np.uint8)
    seq = list(enumerate(frames))
    for k, img in seq:
        if interrupt and k in (6, 7):
            img = black  # occlusion: tracking must fail
        states.append(sys_.track_monocular(img, k / 30.0))
    return sys_, states


def test_relocalization_after_occlusion(scene):
    sys_, states = run_system(scene, interrupt=True)
    # went LOST during the blackout
    assert TrackState.LOST in states[5:9], states
    # recovered afterwards (relocalize against the existing map)
    assert states[-1] == TrackState.OK, states
    assert sys_.n_keyframes() >= 2


def test_checkpoint_roundtrip(scene, tmp_path):
    sys_, states = run_system(scene)
    mp = sys_.tracker.atlas.current
    path = str(tmp_path / "map.npz")
    ckpt.save_map(mp, path)
    mp2 = ckpt.load_map(path)
    assert len(mp2.keyframes) == len(mp.keyframes)
    assert mp2._next_mp == mp._next_mp
    np.testing.assert_array_equal(
        mp2.mp_valid[: mp2._next_mp], mp.mp_valid[: mp._next_mp]
    )
    np.testing.assert_allclose(
        mp2.mp_pos[: mp2._next_mp], mp.mp_pos[: mp._next_mp]
    )
    k = sorted(mp.keyframes)[0]
    np.testing.assert_allclose(mp2.keyframes[k].R, mp.keyframes[k].R)
    np.testing.assert_array_equal(mp2.keyframes[k].kp_mp, mp.keyframes[k].kp_mp)
    assert mp2.obs == mp.obs
