"""Inertial frontend integration tests: IMU queue preintegration,
state prediction, and the staged map-level IMU initialisation
(InitializeIMU analog) on a synthetic trajectory with analytic
kinematics — exercised through SLAMMap/KeyFrame rather than raw solver
arrays (the layer test_inertial.py stops below)."""

import jax.numpy as jnp
import numpy as np

from extractorb.config import IMUConfig
from extractorb.core import lie
from extractorb.imu import preintegration as pre
from extractorb.imu.calib import ImuCalib
from extractorb.slam import imu_frontend
from extractorb.slam.map import SLAMMap, KeyFrame
from extractorb.solver import inertial as vi

G = 9.81
IMU_HZ = 200.0

CAM = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0)


def make_calib():
    cfg = IMUConfig(
        noise_gyro=1e-4 / np.sqrt(IMU_HZ), noise_acc=1e-3 / np.sqrt(IMU_HZ),
        gyro_walk=1e-6 * np.sqrt(IMU_HZ), acc_walk=1e-5 * np.sqrt(IMU_HZ),
        frequency=IMU_HZ,
    )
    return ImuCalib.from_config(cfg)


def project(pc):
    return jnp.stack(
        [CAM["fx"] * pc[0] / pc[2] + CAM["cx"],
         CAM["fy"] * pc[1] / pc[2] + CAM["cy"]], -1
    ).reshape(2)


def truth(t):
    """Analytic body trajectory (world frame, gravity-aligned)."""
    w0 = np.array([0.02, -0.03, 0.1])
    p = np.array([np.sin(t), 0.5 * np.cos(2 * t), 0.2 * t])
    v = np.array([np.cos(t), -np.sin(2 * t), 0.2])
    a = np.array([-np.sin(t), -2 * np.cos(2 * t), 0.0])
    R = np.asarray(lie.so3_exp(jnp.asarray(w0 * t))).astype(np.float64)
    return R, p, v, a, w0


def fill_queue(q, t_end, g_world=None):
    g_world = np.array([0.0, 0.0, -G]) if g_world is None else g_world
    dt = 1.0 / IMU_HZ
    n = int(round(t_end / dt)) + 1
    for i in range(n + 1):
        t = i * dt
        R, _, _, a, w0 = truth(t)
        q.add(t, R.T @ (a - g_world), w0)


def test_queue_preintegration_matches_truth():
    calib = make_calib()
    q = imu_frontend.ImuQueue(calib)
    fill_queue(q, 1.0)
    p = q.preintegrate(0.25, 0.75, np.zeros(6, np.float32))
    assert p is not None
    assert abs(float(p.dT) - 0.5) < 1e-3
    R1, p1, v1, _, _ = truth(0.25)
    R2, p2, v2, _, _ = truth(0.75)
    r = pre.inertial_residual(
        p,
        jnp.asarray(R1, jnp.float32), jnp.asarray(p1, jnp.float32),
        jnp.asarray(v1, jnp.float32),
        jnp.asarray(R2, jnp.float32), jnp.asarray(p2, jnp.float32),
        jnp.asarray(v2, jnp.float32),
        jnp.zeros(6, jnp.float32),
    )
    assert np.abs(np.asarray(r)).max() < 5e-3, np.asarray(r)


def test_predict_state_matches_truth():
    calib = make_calib()
    q = imu_frontend.ImuQueue(calib)
    fill_queue(q, 1.0)
    p = q.preintegrate(0.2, 0.9, np.zeros(6, np.float32))
    R1, p1, v1, _, _ = truth(0.2)
    R2, p2, v2, _, _ = truth(0.9)
    Rp, tp, vp = imu_frontend.predict_state(
        R1.astype(np.float32), p1.astype(np.float32), v1.astype(np.float32),
        np.zeros(6, np.float32), p,
    )
    assert np.linalg.norm(tp - p2) < 5e-3
    assert np.linalg.norm(vp - v2) < 5e-3
    assert np.abs(Rp - R2).max() < 1e-3


def _build_scaled_map(calib, n_kf=12, kf_dt=0.25, s_true=2.0,
                      rot_vw=(0.06, -0.09, 0.0), seed=0):
    """A SLAMMap whose keyframes/points live in a visual frame V that is
    a rotated, 1/s_true-scaled copy of the metric gravity-aligned world
    W — exactly the state of a monocular map before IMU init."""
    rng = np.random.default_rng(seed)
    R_vw = np.asarray(lie.so3_exp(jnp.asarray(np.array(rot_vw)))).astype(
        np.float64
    )
    sp = 1.0 / s_true

    q = imu_frontend.ImuQueue(calib)
    fill_queue(q, n_kf * kf_dt + 0.1)

    # world-frame landmarks in front of the trajectory
    pts_w = np.stack(
        [rng.uniform(-3, 3, 120), rng.uniform(-2, 2, 120),
         rng.uniform(4, 9, 120)], -1
    )
    pts_v = sp * pts_w @ R_vw.T

    mp = SLAMMap()
    N = 128
    prev_kid = -1
    prev_ts = None
    for k in range(n_kf):
        ts = k * kf_dt
        Rwb, pwb, vwb, _, _ = truth(ts)
        # body==camera (Tbc = I): camera pose in V
        R_vb = R_vw @ Rwb
        C_v = sp * R_vw @ pwb
        Rcw = R_vb.T
        tcw = -Rcw @ C_v
        # observations: project the V-frame points
        pc = pts_v @ Rcw.T + tcw
        uv = np.stack(
            [CAM["fx"] * pc[:, 0] / pc[:, 2] + CAM["cx"],
             CAM["fy"] * pc[:, 1] / pc[:, 2] + CAM["cy"]], -1
        ).astype(np.float32)
        kf = KeyFrame(
            kid=-1, frame_id=k, timestamp=ts,
            R=Rcw.astype(np.float32), t=tcw.astype(np.float32),
            feats=None,
            xy_un=np.zeros((N, 2), np.float32),
            octave=np.zeros(N, np.int32),
            angle=np.zeros(N, np.float32),
            desc=np.zeros((N, 32), np.uint8),
            valid=np.zeros(N, bool),
            kp_mp=np.full(N, -1, np.int32),
        )
        mp.add_keyframe(kf)
        kf.prev_kf = prev_kid
        if prev_kid >= 0:
            kf.imu_meas = q.raw_window(prev_ts, ts)
            kf.preint = imu_frontend.integrate_raw(
                kf.imu_meas, np.zeros(6, np.float32), calib
            )
        prev_kid, prev_ts = kf.kid, ts

        for j in range(len(pts_v)):
            kf.xy_un[j] = uv[j]
            kf.valid[j] = True
            if k == 0:
                mid = mp.add_point(
                    pts_v[j].astype(np.float32),
                    np.zeros(32, np.uint8), np.zeros(3, np.float32),
                    1.0, kf.kid,
                )
            mp.add_observation(j, kf.kid, j)
    return mp, pts_w


def test_initialize_imu_recovers_scale_and_gravity():
    calib = make_calib()
    s_true = 2.0
    mp, pts_w = _build_scaled_map(calib, s_true=s_true)
    ok = imu_frontend.initialize_imu(
        mp, calib, project, prior_g=1e2, prior_a=1e10, fix_scale=False,
    )
    assert ok and mp.imu_initialized

    # metric scale: pairwise keyframe-center distances match the truth
    kids = sorted(mp.keyframes.keys())
    C = np.stack([mp.keyframes[k].center() for k in kids])
    C_gt = np.stack([truth(k * 0.25)[1] for k in range(len(kids))])
    d = np.linalg.norm(C[1:] - C[:-1], axis=1)
    d_gt = np.linalg.norm(C_gt[1:] - C_gt[:-1], axis=1)
    ratio = d / np.maximum(d_gt, 1e-9)
    assert np.abs(ratio - 1.0).max() < 0.05, ratio

    # gravity alignment: a fresh inertial-only solve on the corrected
    # map must find Rwg ~ identity and scale ~ 1
    kids2, Rwb, twb, preints, valids = imu_frontend._temporal_chain(
        mp, calib
    )
    v0 = np.stack([
        mp.keyframes[k].v if mp.keyframes[k].v is not None
        else np.zeros(3, np.float32) for k in kids2
    ])
    chain = vi.stack_chain(preints, valids)
    res = vi.inertial_only(
        jnp.asarray(Rwb), jnp.asarray(twb), chain,
        jnp.asarray(v0), jnp.zeros(6, jnp.float32),
        prior_g=1e2, prior_a=1e10, fix_scale=False,
    )
    assert abs(float(res.scale) - 1.0) < 0.03, float(res.scale)
    ang = np.linalg.norm(np.asarray(lie.so3_log(res.Rwg)))
    assert ang < 0.03, ang

    # velocities close to ground truth
    for i, k in enumerate(kids):
        v_gt = truth(i * 0.25)[2]
        assert np.linalg.norm(mp.keyframes[k].v - v_gt) < 0.1


def test_chain_repair_on_keyframe_cull():
    calib = make_calib()
    mp, _ = _build_scaled_map(calib, n_kf=6)
    from extractorb.slam.local_mapping import LocalMapper

    lm = LocalMapper(project, (1.0,), (1.0,), np.eye(3, dtype=np.float32),
                     imu_calib=calib)
    kids = sorted(mp.keyframes.keys())
    victim = kids[2]
    succ = kids[3]
    dT_before = float(mp.keyframes[succ].preint.dT) + float(
        mp.keyframes[victim].preint.dT
    )
    lm._remove_keyframe(mp, victim)
    kf = mp.keyframes[succ]
    assert kf.prev_kf == kids[1]
    assert abs(float(kf.preint.dT) - dT_before) < 1e-4
    # merged window still satisfies the residual between its endpoints
    R1, p1, v1, _, _ = truth(kids[1] * 0.25)
    R2, p2, v2, _, _ = truth(succ * 0.25)
    # map frame is scaled/rotated, so check in the metric world instead:
    r = pre.inertial_residual(
        kf.preint,
        jnp.asarray(R1, jnp.float32), jnp.asarray(p1, jnp.float32),
        jnp.asarray(v1, jnp.float32),
        jnp.asarray(R2, jnp.float32), jnp.asarray(p2, jnp.float32),
        jnp.asarray(v2, jnp.float32),
        jnp.zeros(6, jnp.float32),
    )
    assert np.abs(np.asarray(r)).max() < 5e-3


def test_local_inertial_ba_fixes_window_drift():
    """LocalInertialBA (reference Optimizer.cc:4413): pose + velocity
    noise injected into the newest temporal-window keyframes must be
    pulled back by the visual+preintegration window BA — including the
    velocity states, which a visual-only local BA cannot observe at
    all."""
    calib = make_calib()
    mp, _ = _build_scaled_map(calib, n_kf=12, s_true=1.0,
                              rot_vw=(0.0, 0.0, 0.0))
    mp.imu_initialized = True
    kids = sorted(mp.keyframes.keys())
    # ground-truth velocities, then perturb the last 5 keyframes
    for i, k in enumerate(kids):
        kf = mp.keyframes[k]
        Rwb, pwb, vwb, _, _ = truth(i * 0.25)
        kf.v = vwb.astype(np.float32)
        kf.bg = np.zeros(3, np.float32)
        kf.ba = np.zeros(3, np.float32)
    rng = np.random.default_rng(3)
    perturbed = kids[-5:]
    for k in perturbed:
        kf = mp.keyframes[k]
        dR = np.asarray(lie.so3_exp(jnp.asarray(
            rng.normal(size=3).astype(np.float32) * 0.01)))
        kf.R = (kf.R @ dR).astype(np.float32)
        kf.t = (kf.t + rng.normal(size=3) * 0.03).astype(np.float32)
        kf.v = (kf.v + rng.normal(size=3) * 0.3).astype(np.float32)

    def errors():
        ep, ev = [], []
        for i, k in enumerate(kids):
            if k not in perturbed:
                continue
            Rwb, pwb, vwb, _, _ = truth(i * 0.25)
            C = mp.keyframes[k].center()
            ep.append(np.linalg.norm(C - pwb))
            ev.append(np.linalg.norm(mp.keyframes[k].v - vwb))
        return np.mean(ep), np.mean(ev)

    ep0, ev0 = errors()
    ok = imu_frontend.local_inertial_ba(
        mp, calib, project, kids[-1], n_window=6,
    )
    assert ok
    ep1, ev1 = errors()
    assert ep1 < 0.5 * ep0, (ep0, ep1)
    assert ev1 < 0.5 * ev0, (ev0, ev1)
