"""Asynchronous, interruptible global BA (reference: the transient
RunGlobalBundleAdjustment thread + mbStopGBA + spanning-tree propagation
to keyframes created during the solve, LoopClosing.cc:1013+231 and
:2430+8-66)."""

import numpy as np
import pytest

from extractorb.slam.loop_closing import LoopCloser, LoopThresholds
from extractorb.slam.map import KeyFrame
from extractorb.place.vocab import Vocabulary

from test_loop_closing import build_looped_map, make_features, project


TH = LoopThresholds(n_proj_matches=50, n_proj_opt_matches=60, n_proj_rep=60)


def _close_loop(mp, desc, async_gba):
    vocab = Vocabulary.train(desc, k=8, L=3, seed=0)
    lc = LoopCloser(vocab, project, thresholds=TH, async_gba=async_gba)
    for kid in sorted(mp.keyframes.keys()):
        if lc.process_keyframe(mp, kid):
            return lc
    raise AssertionError("loop not detected")


def _add_child_keyframe(mp, parent_id, dx=0.12):
    """A keyframe created AFTER the GBA dispatched: child of parent_id
    with a known relative pose (pure x-translation in the parent cam)."""
    par = mp.keyframes[parent_id]
    R = par.R.copy()
    t = par.t.copy() + np.array([-dx, 0, 0], np.float32)
    feats, xy_un, d_arr, v_arr = make_features(
        np.zeros((4, 32), np.uint8), np.zeros((4, 2), np.float32)
    )
    kf = KeyFrame(
        kid=-1, frame_id=999, timestamp=99.0, R=R, t=t,
        feats=feats, xy_un=xy_un,
        octave=np.zeros(512, np.int32), angle=np.zeros(512, np.float32),
        desc=d_arr, valid=v_arr, kp_mp=np.full(512, -1, np.int32),
        parent=parent_id,
    )
    mp.add_keyframe(kf)
    # a landmark triangulated after dispatch, referenced to the new KF
    pos = (-R.T @ t + np.array([0, 0, 5], np.float32)).astype(np.float32)
    mid = mp.add_point(pos, np.zeros(32, np.uint8), np.zeros(3), 10.0,
                       kf.kid)
    mp.add_observation(mid, kf.kid, 0)
    return kf, mid, pos


def test_async_gba_matches_sync(rng):
    """Dispatch-then-apply must land on exactly the synchronous result
    when nothing happens in between."""
    mp_a, _, desc = build_looped_map(rng)
    rng2 = np.random.default_rng(0)
    mp_s, _, desc2 = build_looped_map(rng2)

    lc_a = _close_loop(mp_a, desc, async_gba=True)
    assert lc_a.pending_gba is not None, "GBA was not dispatched"
    # tracking would keep running here — the solve is in flight on device
    lc_a.finish(mp_a)
    assert lc_a.pending_gba is None
    assert lc_a.n_gba_applied == 1

    lc_s = _close_loop(mp_s, desc2, async_gba=False)
    assert lc_s.n_gba_applied == 1

    for k in mp_a.keyframes:
        np.testing.assert_allclose(
            mp_a.keyframes[k].R, mp_s.keyframes[k].R, atol=1e-5
        )
        np.testing.assert_allclose(
            mp_a.keyframes[k].t, mp_s.keyframes[k].t, atol=1e-5
        )


def test_gba_propagates_to_keyframes_created_in_flight(rng):
    """A keyframe (and landmark) created between dispatch and apply gets
    the parent's correction through the spanning tree (reference
    LoopClosing.cc:2430+8-66)."""
    mp, _, desc = build_looped_map(rng)
    lc = _close_loop(mp, desc, async_gba=True)
    assert lc.pending_gba is not None

    parent_id = max(mp.keyframes.keys())
    kf, mid, pos_before = _add_child_keyframe(mp, parent_id)
    par = mp.keyframes[parent_id]
    R_rel = kf.R @ par.R.T
    t_rel = kf.t - R_rel @ par.t
    cam_before = kf.R @ pos_before + kf.t

    lc.finish(mp)
    assert lc.n_gba_applied == 1

    # relative pose child->parent survives the correction exactly
    par2 = mp.keyframes[parent_id]
    R_rel2 = kf.R @ par2.R.T
    t_rel2 = kf.t - R_rel2 @ par2.t
    np.testing.assert_allclose(R_rel2, R_rel, atol=1e-5)
    np.testing.assert_allclose(t_rel2, t_rel, atol=1e-5)
    # and the in-flight landmark moved with its reference keyframe:
    # camera-frame coordinates R p + t are preserved through the
    # correction (kf.R/kf.t were updated in place by the propagation)
    assert mp.mp_valid[mid]
    cam_after = kf.R @ mp.mp_pos[mid] + kf.t
    np.testing.assert_allclose(cam_after, cam_before, atol=1e-3)


def test_gba_superseded_by_new_correction(rng):
    """A second loop correction while a GBA is in flight drops the stale
    solve (reference mbStopGBA kill, LoopClosing.cc:1013+7-24)."""
    mp, _, desc = build_looped_map(rng)
    lc = _close_loop(mp, desc, async_gba=True)
    first = lc.pending_gba
    assert first is not None
    # a fresh correction dispatches a new solve and drops the old one
    kid = max(mp.keyframes.keys())
    lc._run_gba(mp)
    assert lc.pending_gba is not first
    lc.finish(mp)
    assert lc.n_gba_applied == 1  # only the superseding solve applied


def test_gba_dropped_when_map_changes(rng):
    """A pending GBA for a map that was dropped (reset/merge) must not
    write into the new map."""
    mp, _, desc = build_looped_map(rng)
    lc = _close_loop(mp, desc, async_gba=True)
    assert lc.pending_gba is not None
    mp.mid = mp.mid + 1000  # simulate: active map replaced
    poses = {k: (kf.R.copy(), kf.t.copy()) for k, kf in mp.keyframes.items()}
    lc.finish(mp)
    assert lc.pending_gba is None
    assert lc.n_gba_applied == 0
    for k, (R0, t0) in poses.items():
        np.testing.assert_allclose(mp.keyframes[k].R, R0)
        np.testing.assert_allclose(mp.keyframes[k].t, t0)
