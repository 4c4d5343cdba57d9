"""Atlas map-merge tests (reference LoopClosing::MergeLocal,
src/LoopClosing.cc:1252): after tracking loss the Atlas starts a fresh
map; when place recognition matches a keyframe of the old map, the new
map is welded into it."""

import numpy as np
import jax.numpy as jnp

from extractorb.core import lie
from extractorb.place.vocab import Vocabulary
from extractorb.slam import merge as mg
from extractorb.slam.loop_closing import LoopCloser
from extractorb.slam.map import Atlas, KeyFrame, SLAMMap

from test_loop_closing import FX, FY, CX, CY, make_features, project


def build_map_into(
    mp: SLAMMap, pts: np.ndarray, desc: np.ndarray,
    Rw: np.ndarray, tw: np.ndarray, sw: float,
    n_kf: int = 4, x_step: float = 0.25,
):
    """Populate `mp` with keyframes on a line observing `pts` (given in
    canonical world coords), with the map's own world frame related to
    the canonical one by p_map = sw*Rw@p + tw."""
    pts_m = (sw * pts @ Rw.T + tw).astype(np.float32)
    mp_ids = {}
    for k in range(n_kf):
        # canonical pose
        R = np.eye(3, dtype=np.float32)
        t = -R @ np.array([x_step * k, 0, 0], np.float32)
        # same camera expressed over the map's world frame: fold scale
        # into translation like the rest of the package (x_cam' = sw x_cam)
        Rm = (R @ Rw.T).astype(np.float32)
        tm = (sw * t - Rm @ tw).astype(np.float32)
        pc = pts @ R.T + t
        uv = np.stack(
            [FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], -1
        )
        vis = (
            (uv[:, 0] > 20) & (uv[:, 0] < 620)
            & (uv[:, 1] > 20) & (uv[:, 1] < 460) & (pc[:, 2] > 0.3)
        )
        obs_idx = np.where(vis)[0]
        feats, xy_un, d_arr, v_arr = make_features(desc[obs_idx], uv[obs_idx])
        kf = KeyFrame(
            kid=-1, frame_id=k, timestamp=k / 30.0, R=Rm, t=tm,
            feats=feats, xy_un=xy_un,
            octave=np.zeros(512, np.int32), angle=np.zeros(512, np.float32),
            desc=d_arr, valid=v_arr, kp_mp=np.full(512, -1, np.int32),
        )
        mp.add_keyframe(kf)
        for row, p in enumerate(obs_idx):
            if p not in mp_ids:
                mp_ids[p] = mp.add_point(
                    pts_m[p], desc[p], np.zeros(3), 10.0, kf.kid
                )
            if kf.kid not in mp.obs[mp_ids[p]]:
                mp.add_observation(mp_ids[p], kf.kid, row)
    return mp_ids


def _scene(rng, n_pts=200):
    pts = np.stack(
        [rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
         rng.uniform(4, 7, n_pts)], -1
    ).astype(np.float32)
    desc = rng.integers(0, 256, (n_pts, 32), dtype=np.uint8)
    return pts, desc


def _world_sim3():
    Rw = np.asarray(
        lie.so3_exp(jnp.asarray([0.1, -0.2, 0.3], jnp.float32))
    ).astype(np.float32)
    tw = np.array([0.7, -0.4, 1.1], np.float32)
    sw = 1.4
    return Rw, tw, sw


def test_merge_maps_exact(rng):
    """With the exact seam Sim3, welding reproduces the kept map's world
    frame for every dropped keyframe and landmark."""
    pts, desc = _scene(rng)
    Rw, tw, sw = _world_sim3()  # p_keep = sw Rw p_drop + tw

    atlas = Atlas()
    keep = atlas.current
    # keep map IS the canonical world
    build_map_into(keep, pts, desc, np.eye(3, dtype=np.float32),
                   np.zeros(3, np.float32), 1.0)
    atlas.create_new_map()
    drop = atlas.current
    # drop map world: p_drop = (1/sw) Rw^T (p_keep - tw)
    Rd = Rw.T.astype(np.float32)
    td = (-Rw.T @ tw / sw).astype(np.float32)
    build_map_into(drop, pts, desc, Rd, td, 1.0 / sw)

    kf1 = drop.keyframes[0]
    kf2 = keep.keyframes[0]
    # camera-frame Sim3 consistent with the world Sim3
    S_R = (kf2.R @ Rw @ kf1.R.T).astype(np.float32)
    S_s = sw
    S_t = (kf2.R @ tw + kf2.t - sw * S_R @ kf1.t).astype(np.float32)
    # sanity: the lift inverts the fold
    Rw2, tw2, sw2 = mg.world_sim3_from_camera_sim3(
        kf1.R, kf1.t, kf2.R, kf2.t, S_R, S_t, S_s
    )
    np.testing.assert_allclose(Rw2, Rw, atol=1e-5)
    np.testing.assert_allclose(tw2, tw, atol=1e-4)
    assert abs(sw2 - sw) < 1e-5

    n_keep_kf = len(keep.keyframes)
    info = mg.merge_maps(
        atlas, drop, keep, kf_drop_id=0, kf_keep_id=0,
        S_R=S_R, S_t=S_t, S_s=S_s,
    )
    assert len(atlas.maps) == 1 and atlas.current is keep
    assert info["kf_cur"] == info["kf_remap"][0] == n_keep_kf

    # welded keyframe centres land on the canonical trajectory
    for old_id, new_id in info["kf_remap"].items():
        kf = keep.keyframes[new_id]
        C = -kf.R.T @ kf.t
        C_gt = np.array([0.25 * old_id, 0, 0], np.float32)
        np.testing.assert_allclose(C, C_gt, atol=1e-3)
    # welded landmarks land on the canonical points, observations intact
    for old_id, new_id in info["mp_remap"].items():
        assert keep.mp_valid[new_id]
        o = keep.obs[new_id]
        assert o, "welded point lost its observations"
        for kf_id, kp in o.items():
            assert keep.keyframes[kf_id].kp_mp[kp] == new_id


def test_loop_closer_merges_across_maps(rng):
    """End-to-end: the LoopCloser's place recognition finds the old-map
    keyframe, verifies a Sim3, and welds the Atlas back to one map."""
    pts, desc = _scene(rng)
    Rw, tw, sw = _world_sim3()

    atlas = Atlas()
    keep = atlas.current
    build_map_into(keep, pts, desc, np.eye(3, dtype=np.float32),
                   np.zeros(3, np.float32), 1.0)
    atlas.create_new_map()
    drop = atlas.current
    Rd = Rw.T.astype(np.float32)
    td = (-Rw.T @ tw / sw).astype(np.float32)
    build_map_into(drop, pts, desc, Rd, td, 1.0 / sw)

    vocab = Vocabulary.train(desc, k=8, L=3, seed=0)
    lc = LoopCloser(vocab, project, inv_sigma2=(1.0,) * 8)

    # keyframes of the old map enter the database while it is active
    for kid in sorted(keep.keyframes):
        assert not lc.process_keyframe(keep, kid, atlas=atlas)
    # ... then the fresh map's keyframes trigger the cross-map merge
    merged = False
    for kid in sorted(drop.keyframes):
        info = lc.process_keyframe(drop, kid, atlas=atlas)
        if info:
            merged = True
            assert isinstance(info, dict) and info["type"] == "merge"
            break
    assert merged, "cross-map merge not detected"
    assert lc.n_merges == 1 and lc.n_loops == 0
    assert len(atlas.maps) == 1 and atlas.current is keep

    # welded keyframes sit on the canonical line (Sim3 from RANSAC)
    for old_id, new_id in info["kf_remap"].items():
        kf = keep.keyframes[new_id]
        C = -kf.R.T @ kf.t
        C_gt = np.array([0.25 * old_id, 0, 0], np.float32)
        assert np.linalg.norm(C - C_gt) < 0.05, (old_id, C, C_gt)
