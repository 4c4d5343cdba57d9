"""End-to-end loop closure from pixels (BASELINE config 4 stand-in):
an out-and-back camera path over the synthetic two-plane scene, driven
through the full System with a trained vocabulary; the loop closer must
detect the revisit and correct the map (reference flow:
src/LoopClosing.cc:56-248)."""

import numpy as np
import pytest
import jax.numpy as jnp

from extractorb.config import (
    CameraConfig, ORBConfig, SLAMConfig, TrackingConfig,
)
from extractorb.frontend.extractor import ORBExtractor
from extractorb.place.vocab import Vocabulary
from extractorb.slam.system import System
from extractorb.slam.tracking import TrackState

from extractorb.sim.scenes import (
    H, W, render_loop_sequence, texture, umeyama_align,
)

@pytest.mark.slow
def test_place_recognition_merge_from_pixels():
    """BASELINE config 4 stand-in, end-to-end from pixels: the camera
    sweeps out over a wide wall, a blackout at the turnaround severs
    tracking into a fresh Atlas map, and on the way back place
    recognition must recognise the old map and weld the two maps
    (reference LoopClosing merge path, src/LoopClosing.cc:56-248 +
    MergeLocal).  (On clean synthetic data a revisit within ONE map is
    re-associated by the local-map search before any loop is needed —
    the reference's bAbortByNearKF gate fires — so the genuine
    pixels-to-correction path here is the Atlas merge.)"""
    frames, poses = render_loop_sequence(texture(1, (1024, 4096)), n_frames=40)

    # vocabulary trained on the sequence's own ORB descriptors
    ext = ORBExtractor(ORBConfig(n_features=1000), octree="device")
    descs = []
    for img in frames[::5]:
        f = ext(jnp.asarray(img))
        descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
    vocab = Vocabulary.train(np.concatenate(descs, 0), k=8, L=3, seed=0)

    cfg = SLAMConfig(
        orb=ORBConfig(n_features=1000),
        camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                            width=W, height=H),
        tracking=TrackingConfig(max_frames=2, time_recently_lost=0.05),
    )
    sys_ = System(cfg, vocab=vocab)
    black = np.zeros((H, W), np.uint8)
    states = []
    for k, im in enumerate(frames):
        # 10 black frames: enough LOST frames after the RECENTLY_LOST
        # grace that the Atlas recovery fires DURING the blackout (a
        # shorter gap lets relocalization recover into the same map —
        # also correct, but then the merge path under test never runs)
        if 19 <= k <= 28:
            im = black  # blackout: severs into a fresh Atlas map
        states.append(sys_.track_monocular(im, k / 30.0))
    assert states[-1] == TrackState.OK, states

    lc = sys_.tracker.loop_closer
    assert lc.n_loops + lc.n_merges >= 1, (lc.n_loops, lc.n_merges)
    # after the weld there is ONE map again
    assert len(sys_.tracker.atlas.maps) == 1, len(sys_.tracker.atlas.maps)

    # trajectory quality after the merge: both segments must live in
    # one consistent frame (the merge re-expresses the welded segment)
    def ate(traj):
        est = np.array([-R.T @ t for _, R, t in traj])
        gt = np.array([
            -poses[int(round(ts * 30.0))][0].T
            @ poses[int(round(ts * 30.0))][1]
            for ts, _, _ in traj
        ])
        aligned = umeyama_align(est, gt)
        return float(np.sqrt(((aligned - gt) ** 2).sum(-1).mean()))

    # The bound checks the weld left both segments in ONE consistent
    # frame (a broken weld gives meters of error).  With pose rotations
    # kept on SO(3) the drift that used to make this chaotic is gone:
    # ~1% of the 14 m sweep, with 2x headroom for keyframe-cadence
    # variation between the two independently-scaled mono segments.
    ate_final = ate(sys_.tracker.final_trajectory())
    assert ate_final < 0.30, ate_final
