"""Loop-closing test on a constructed map: two passes over the same
scene with odometry drift and duplicated landmarks; the closer must
detect the revisit, solve the Sim3, optimise the pose graph and merge
duplicates."""

import numpy as np
import pytest
import jax.numpy as jnp

from extractorb.core import lie
from extractorb.frontend.extractor import Features
from extractorb.place.vocab import Vocabulary
from extractorb.slam.loop_closing import LoopCloser, LoopThresholds
from extractorb.slam.map import KeyFrame, SLAMMap

FX, FY, CX, CY = 500.0, 500.0, 320.0, 240.0


def project(pc):
    return jnp.stack(
        [FX * pc[0] / pc[2] + CX, FY * pc[1] / pc[2] + CY], -1
    ).reshape(2)


def make_features(desc, xy, n_cap=512):
    n = len(desc)
    pad2 = np.zeros((n_cap, 2), np.float32)
    pad2[:n] = xy
    d = np.zeros((n_cap, 32), np.uint8)
    d[:n] = desc
    v = np.zeros(n_cap, bool)
    v[:n] = True
    return Features(
        xy=jnp.asarray(pad2),
        response=jnp.zeros(n_cap),
        angle=jnp.zeros(n_cap),
        octave=jnp.zeros(n_cap, jnp.int32),
        size=jnp.full(n_cap, 31.0),
        desc=jnp.asarray(d),
        valid=jnp.asarray(v),
    ), pad2, d, v


def build_looped_map(rng, n_kf=12, n_pts=200, drift_per_kf=0.02):
    """Keyframes on a line out and back; the return pass re-observes the
    first pass's world points but triangulates DUPLICATES under drift."""
    pts = np.stack(
        [rng.uniform(-3, 3, n_pts), rng.uniform(-2, 2, n_pts),
         rng.uniform(4, 7, n_pts)], -1
    ).astype(np.float32)
    desc = rng.integers(0, 256, (n_pts, 32), dtype=np.uint8)

    mp = SLAMMap()
    mp_ids_first = {}

    def kf_pose(k):
        # out: x = 0..1.5; back: 1.5..0 (same viewpoints revisited)
        half = n_kf // 2
        x = 0.3 * k if k < half else 0.3 * (n_kf - 1 - k)
        R = np.eye(3, dtype=np.float32)
        t = -R @ np.array([x, 0, 0], np.float32)
        return R, t

    # accumulated drift applied to the SECOND pass poses & points
    for k in range(n_kf):
        R, t = kf_pose(k)
        half = n_kf // 2
        drift = max(0, k - half + 1) * drift_per_kf
        dR, dt = lie.se3_exp(
            jnp.asarray([drift, drift * 0.5, 0, 0, 0, drift * 0.3], jnp.float32)
        )
        R_est = R @ np.asarray(dR)
        t_est = R @ np.asarray(dt) + t

        # observed subset: points in front and near image centre
        pc = pts @ R.T + t
        uv = np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], -1)
        vis = (uv[:, 0] > 20) & (uv[:, 0] < 620) & (uv[:, 1] > 20) & (uv[:, 1] < 460)
        obs_idx = np.where(vis)[0]
        feats, xy_un, d_arr, v_arr = make_features(desc[obs_idx], uv[obs_idx])
        kf = KeyFrame(
            kid=-1, frame_id=k, timestamp=k / 30.0, R=R_est, t=t_est,
            feats=feats, xy_un=xy_un,
            octave=np.zeros(512, np.int32), angle=np.zeros(512, np.float32),
            desc=d_arr, valid=v_arr,
            kp_mp=np.full(512, -1, np.int32),
        )
        mp.add_keyframe(kf)
        for row, p in enumerate(obs_idx):
            if k < half:
                if p not in mp_ids_first:
                    # first-pass landmark at TRUE position
                    mid = mp.add_point(pts[p], desc[p], np.zeros(3), 10.0, kf.kid)
                    mp_ids_first[p] = mid
                mid = mp_ids_first[p]
                if kf.kid not in mp.obs[mid]:
                    mp.add_observation(mid, kf.kid, row)
            else:
                # second pass: drifted duplicate landmarks (as if
                # triangulated from the drifted poses)
                key = (p, "dup")
                existing = kf.kp_mp[row]
                # position back-projected through the drifted pose
                pc_true = pts[p] @ R.T + t
                pos_drift = (pc_true - t_est) @ R_est  # R_est^T (pc - t_est)
                mid = mp.add_point(pos_drift, desc[p], np.zeros(3), 10.0, kf.kid)
                mp.add_observation(mid, kf.kid, row)
    # normals + scale-invariance ranges (the projection matchers apply
    # the reference's viewing-angle and distance gates)
    for p in range(mp._next_mp):
        if mp.mp_valid[p]:
            mp.update_point_stats(p)
    return mp, pts, desc


def test_loop_close_constructed(rng):
    mp, pts, desc = build_looped_map(rng)
    vocab = Vocabulary.train(desc, k=8, L=3, seed=0)
    # the constructed map has ~200 points/KF (vs the reference's 1000+),
    # so the projection-count gates scale down proportionally; the
    # cascade structure (BoW -> RANSAC -> proj -> OptimizeSim3 -> reproj
    # -> temporal consistency) is exercised unchanged
    th = LoopThresholds(
        n_proj_matches=50, n_proj_opt_matches=60, n_proj_rep=60,
    )
    lc = LoopCloser(vocab, project, thresholds=th)

    closed = False
    for kid in sorted(mp.keyframes.keys()):
        kf = mp.keyframes[kid]
        if lc.process_keyframe(mp, kid):
            closed = True
            break
    assert closed, "loop not detected"
    assert lc.n_loops == 1

    # after correction, the last keyframe's pose should be close to its
    # ground-truth (drift removed); check camera centre error shrank
    last = mp.keyframes[max(mp.keyframes.keys())]
    # ground truth for that kf
    n_kf = len(mp.keyframes)
    x = 0.3 * (n_kf - 1 - last.kid)
    C_gt = np.array([x, 0, 0], np.float32)
    C_est = -last.R.T @ last.t
    assert np.linalg.norm(C_est - C_gt) < 0.15, (C_est, C_gt)


def test_false_loop_rejected(rng):
    """A revisit candidate with matching APPEARANCE (identical
    descriptors) but geometrically scrambled structure must not close a
    loop: the Sim3 RANSAC / OptimizeSim3 / re-projection cascade rejects
    it (the round-1 closer accepted loops on appearance alone)."""
    mp, pts, desc = build_looped_map(rng)
    # scramble the SECOND-pass duplicate landmark positions: appearance
    # stays identical, geometry becomes inconsistent with any Sim3
    half_ids = [
        p for p in range(mp._next_mp)
        if mp.mp_valid[p] and len(mp.obs.get(p, {})) > 0
        and min(mp.obs[p]) >= len(mp.keyframes) // 2
    ]
    perm = rng.permutation(len(half_ids))
    scrambled = mp.mp_pos[half_ids][perm]
    mp.mp_pos[half_ids] = scrambled
    for p in half_ids:
        mp.update_point_stats(p)

    vocab = Vocabulary.train(desc, k=8, L=3, seed=0)
    th = LoopThresholds(
        n_proj_matches=50, n_proj_opt_matches=60, n_proj_rep=60,
    )
    lc = LoopCloser(vocab, project, thresholds=th)
    for kid in sorted(mp.keyframes.keys()):
        assert not lc.process_keyframe(mp, kid), f"false loop at kf {kid}"
    assert lc.n_loops == 0


def test_inertial_loop_preserves_gravity(rng):
    """Inertial maps route loop correction through the 4-DoF essential
    graph (reference Optimizer.cc:8153, call site LoopClosing.cc
    inertial branch): the correction applied to every keyframe must be
    yaw-only — roll/pitch (gravity alignment) survive exactly."""
    from extractorb.config import IMUConfig
    from extractorb.imu.calib import ImuCalib

    mp, pts, desc = build_looped_map(rng)
    mp.imu_initialized = True
    pre = {k: (kf.R.copy(), kf.t.copy()) for k, kf in mp.keyframes.items()}

    vocab = Vocabulary.train(desc, k=8, L=3, seed=0)
    th = LoopThresholds(
        n_proj_matches=50, n_proj_opt_matches=60, n_proj_rep=60,
    )
    lc = LoopCloser(vocab, project, thresholds=th,
                    imu_calib=ImuCalib.from_config(IMUConfig()))

    closed = False
    for kid in sorted(mp.keyframes.keys()):
        if lc.process_keyframe(mp, kid):
            closed = True
            break
    assert closed, "loop not detected"

    import jax.numpy as jnp
    from extractorb.core import lie
    for k, kf in mp.keyframes.items():
        R0, _ = pre[k]
        dR = R0 @ kf.R.T           # world-side correction rotation
        w = np.asarray(lie.so3_log(jnp.asarray(dR.astype(np.float32))))
        ang = np.linalg.norm(w)
        if ang < 1e-5:
            continue
        axis = w / ang
        # rotation axis must be the world z (gravity) axis: yaw only
        assert abs(abs(axis[2]) - 1.0) < 1e-3, (k, axis, ang)
