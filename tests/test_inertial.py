"""Visual-inertial solver tests on a simulated trajectory with analytic
kinematics — preintegration residual consistency, gravity/scale/bias
recovery (InertialOptimization analog), VI-BA convergence, and the
tracking-time 15-dim pose-velocity-bias optimization.  This is the test
coverage the reference entirely lacks for its inertial stack
(SURVEY.md §4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from extractorb.core import lie
from extractorb.imu import preintegration as pre
from extractorb.solver import inertial as vi

G = 9.81
IMU_HZ = 200.0
NOISE_G = 1e-4
NOISE_A = 1e-3
WALK_G = 1e-6
WALK_A = 1e-5


def truth(t, w0=np.array([0.02, -0.03, 0.1])):
    """Analytic trajectory: p(t), v(t), a(t) world; Rwb(t)=Exp(w0 t)."""
    p = np.array([np.sin(t), 0.5 * np.cos(2 * t), 0.2 * t])
    v = np.array([np.cos(t), -np.sin(2 * t), 0.2])
    a = np.array([-np.sin(t), -2 * np.cos(2 * t), 0.0])
    R = np.asarray(lie.so3_exp(jnp.asarray(w0 * t, jnp.float64)))
    return R, p, v, a


def simulate(n_kf=8, kf_dt=0.5, bg=None, ba=None, g_world=None, seed=0,
             noise=0.0):
    """IMU measurements between keyframes + ground-truth states."""
    rng = np.random.default_rng(seed)
    bg = np.zeros(3) if bg is None else bg
    ba = np.zeros(3) if ba is None else ba
    g_world = np.array([0.0, 0.0, -G]) if g_world is None else g_world
    dt = 1.0 / IMU_HZ
    n_per = int(round(kf_dt / dt))
    w0 = np.array([0.02, -0.03, 0.1])

    kf_states = []
    segments = []
    for k in range(n_kf):
        t0 = k * kf_dt
        R, p, v, _ = truth(t0, w0)
        kf_states.append((R, p, v))
        if k == n_kf - 1:
            break
        gyro = np.zeros((n_per, 3))
        acc = np.zeros((n_per, 3))
        for i in range(n_per):
            # midpoint sampling of the analytic signals
            t = t0 + (i + 0.5) * dt
            Rt, _, _, a = truth(t, w0)
            gyro[i] = w0 + bg + noise * rng.normal(size=3) * NOISE_G
            acc[i] = Rt.T @ (a - g_world) + ba \
                + noise * rng.normal(size=3) * NOISE_A
        segments.append((gyro, acc, np.full(n_per, dt)))
    return kf_states, segments


def preintegrate_segments(segments, bias=np.zeros(6)):
    out = []
    for gyro, acc, dts in segments:
        p = pre.integrate(
            jnp.asarray(gyro, jnp.float32), jnp.asarray(acc, jnp.float32),
            jnp.asarray(dts, jnp.float32),
            jnp.ones(len(dts), bool), jnp.asarray(bias, jnp.float32),
            NOISE_G, NOISE_A, WALK_G, WALK_A,
        )
        out.append(p)
    return out


def test_preintegration_residual_zero_at_truth():
    kf_states, segments = simulate(n_kf=4)
    preints = preintegrate_segments(segments)
    for k in range(1, 4):
        R1, p1, v1 = kf_states[k - 1]
        R2, p2, v2 = kf_states[k]
        r = pre.inertial_residual(
            preints[k - 1],
            jnp.asarray(R1, jnp.float32), jnp.asarray(p1, jnp.float32),
            jnp.asarray(v1, jnp.float32),
            jnp.asarray(R2, jnp.float32), jnp.asarray(p2, jnp.float32),
            jnp.asarray(v2, jnp.float32),
            jnp.zeros(6, jnp.float32),
        )
        assert np.abs(np.asarray(r)).max() < 5e-3, (k, np.asarray(r))


def _chain_from(preints, n_kf):
    chain = vi.stack_chain(
        [preints[0]] + preints,  # slot 0 is a dummy (invalid)
        [False] + [True] * (n_kf - 1),
    )
    return chain


def test_inertial_only_recovers_gravity_scale_bias():
    true_bg = np.array([0.003, -0.005, 0.002])
    true_ba = np.array([0.02, 0.01, -0.03])
    Rwg_true = np.asarray(
        lie.so3_exp(jnp.asarray([0.05, -0.08, 0.0], jnp.float64))
    )
    g_world = Rwg_true @ np.array([0.0, 0.0, -G])
    s_true = 2.5

    n_kf = 8
    kf_states, segments = simulate(
        n_kf=n_kf, bg=true_bg, ba=true_ba, g_world=g_world
    )
    preints = preintegrate_segments(segments)  # integrated at zero bias
    chain = _chain_from(preints, n_kf)

    Rwb = jnp.asarray(np.stack([s[0] for s in kf_states]), jnp.float32)
    # the visual map is under-scaled by s_true
    twb = jnp.asarray(
        np.stack([s[1] for s in kf_states]) / s_true, jnp.float32
    )
    v0 = jnp.asarray(
        np.stack([s[2] for s in kf_states]) / s_true, jnp.float32
    )

    res = vi.inertial_only(
        Rwb, twb, chain, v0, jnp.zeros(6, jnp.float32),
        prior_g=1e2, prior_a=1e2, n_iters=40,
    )
    assert abs(float(res.scale) - s_true) / s_true < 0.05, float(res.scale)
    # gravity direction error in degrees
    g_est = np.asarray(res.Rwg) @ np.array([0, 0, -G])
    cosang = g_est @ g_world / (np.linalg.norm(g_est) * np.linalg.norm(g_world))
    assert np.degrees(np.arccos(np.clip(cosang, -1, 1))) < 2.0
    assert np.abs(np.asarray(res.bg) - true_bg).max() < 2e-3
    # accel bias is weakly observable in a short window; loose gate
    assert np.abs(np.asarray(res.ba) - true_ba).max() < 0.05


def _vi_problem(rng, n_kf=6, n_pts=120, perturb=0.0):
    kf_states, segments = simulate(n_kf=n_kf)
    preints = preintegrate_segments(segments)
    chain = _chain_from(preints, n_kf)

    pts = np.stack([
        rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
        rng.uniform(6, 14, n_pts),
    ], -1).astype(np.float32)

    Rwb = np.stack([s[0] for s in kf_states]).astype(np.float32)
    twb = np.stack([s[1] for s in kf_states]).astype(np.float32)
    v = np.stack([s[2] for s in kf_states]).astype(np.float32)

    def project(pc):
        return jnp.stack([pc[0] / pc[2], pc[1] / pc[2]], -1).reshape(2)

    obs_kf, obs_mp, obs_uv = [], [], []
    for k in range(n_kf):
        for j in range(n_pts):
            pb = Rwb[k].T @ (pts[j] - twb[k])
            if pb[2] < 0.5:
                continue
            obs_kf.append(k)
            obs_mp.append(j)
            obs_uv.append([pb[0] / pb[2], pb[1] / pb[2]])
    O = len(obs_kf)

    Rwb_n, twb_n, v_n = Rwb.copy(), twb.copy(), v.copy()
    pts_n = pts.copy()
    if perturb:
        for k in range(1, n_kf):
            dw = rng.normal(0, perturb * 0.02, 3)
            Rwb_n[k] = Rwb_n[k] @ np.asarray(lie.so3_exp(jnp.asarray(dw)))
            twb_n[k] += rng.normal(0, perturb * 0.05, 3)
            v_n[k] += rng.normal(0, perturb * 0.1, 3)
        pts_n += rng.normal(0, perturb * 0.05, pts.shape)

    fixed_kf = np.zeros(n_kf, bool)
    fixed_kf[0] = True
    prob = vi.VIBAProblem(
        Rwb=jnp.asarray(Rwb_n), twb=jnp.asarray(twb_n),
        v=jnp.asarray(v_n),
        bg=jnp.zeros((n_kf, 3), jnp.float32),
        ba=jnp.zeros((n_kf, 3), jnp.float32),
        points=jnp.asarray(pts_n),
        obs_kf=jnp.asarray(obs_kf, jnp.int32),
        obs_mp=jnp.asarray(obs_mp, jnp.int32),
        obs_uv=jnp.asarray(np.asarray(obs_uv, np.float32)),
        inv_sigma2=jnp.full((O,), 1e4, jnp.float32),  # ~0.01 px noise
        obs_valid=jnp.ones(O, bool),
        chain=chain,
        fixed_kf=jnp.asarray(fixed_kf),
        fixed_mp=jnp.zeros(n_pts, bool),
        Rcb=jnp.eye(3, dtype=jnp.float32),
        tcb=jnp.zeros(3, jnp.float32),
    )
    return prob, project, (Rwb, twb, v, pts)


def test_vi_ba_converges_from_perturbation(rng):
    prob, project, (Rwb, twb, v, pts) = _vi_problem(rng, perturb=1.0)
    res = vi.optimize_vi_ba(prob, project, n_iters=10, cg_iters=60)
    # poses recovered
    terr = np.abs(np.asarray(res.twb) - twb).max()
    assert terr < 0.02, terr
    for k in range(len(twb)):
        dR = np.asarray(res.Rwb[k]) @ Rwb[k].T
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        assert ang < 0.5, (k, ang)
    verr = np.abs(np.asarray(res.v) - v).max()
    assert verr < 0.1, verr


def test_vi_ba_keeps_fixed_frame(rng):
    prob, project, _ = _vi_problem(rng, perturb=1.0)
    res = vi.optimize_vi_ba(prob, project, n_iters=4, cg_iters=30)
    np.testing.assert_allclose(np.asarray(res.Rwb[0]), np.asarray(prob.Rwb[0]))
    np.testing.assert_allclose(np.asarray(res.twb[0]), np.asarray(prob.twb[0]))


def test_pose_inertial_optimization(rng):
    n_pts = 150
    kf_states, segments = simulate(n_kf=2)
    preint = preintegrate_segments(segments)[0]
    R1, p1, v1 = [x.astype(np.float32) for x in map(np.asarray, kf_states[0])]
    R2, p2, v2 = [x.astype(np.float32) for x in map(np.asarray, kf_states[1])]

    pts = np.stack([
        rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
        rng.uniform(6, 14, n_pts),
    ], -1).astype(np.float32)

    def project(pc):
        return jnp.stack([pc[0] / pc[2], pc[1] / pc[2]], -1).reshape(2)

    pb = (pts - p2) @ R2  # = R2^T (pts - p2) rowwise
    uv = pb[:, :2] / pb[:, 2:3]
    valid = pb[:, 2] > 0.5
    # add some outliers
    out = rng.choice(n_pts, 20, replace=False)
    uv[out] += 0.1

    # perturbed init
    dw = rng.normal(0, 0.02, 3)
    R0 = R2 @ np.asarray(lie.so3_exp(jnp.asarray(dw, jnp.float32)))
    t0 = p2 + rng.normal(0, 0.05, 3).astype(np.float32)
    v0 = v2 + rng.normal(0, 0.1, 3).astype(np.float32)

    res = vi.optimize_pose_inertial(
        jnp.asarray(R0), jnp.asarray(t0, jnp.float32), jnp.asarray(v0),
        jnp.zeros(3, jnp.float32), jnp.zeros(3, jnp.float32),
        (jnp.asarray(R1), jnp.asarray(p1), jnp.asarray(v1),
         jnp.zeros(3, jnp.float32), jnp.zeros(3, jnp.float32)),
        preint,
        jnp.asarray(pts), jnp.asarray(uv.astype(np.float32)),
        jnp.full(n_pts, 1e4, jnp.float32), jnp.asarray(valid),
        jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32),
        project,
    )
    dR = np.asarray(res.Rwb) @ R2.T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    assert ang < 0.3, ang
    assert np.linalg.norm(np.asarray(res.twb) - p2) < 0.02
    assert np.linalg.norm(np.asarray(res.v) - v2) < 0.1
    assert int(res.n_inliers) > 80
    # outliers rejected
    inl = np.asarray(res.inliers)
    assert inl[out].mean() < 0.3
    # marginal H is symmetric PSD-ish
    H = np.asarray(res.H)
    assert np.allclose(H, H.T, atol=1e-2)


def test_pose_inertial_last_frame_joint(rng):
    """PoseInertialOptimizationLastFrame (Optimizer.cc:7722): joint
    optimisation of the previous and current frame states, previous
    anchored by its ConstraintPoseImu prior, then marginalized out to
    produce the next prior (solver/marginal.py)."""
    n_pts = 150
    kf_states, segments = simulate(n_kf=2)
    preint = preintegrate_segments(segments)[0]
    R1, p1, v1 = [x.astype(np.float32) for x in map(np.asarray, kf_states[0])]
    R2, p2, v2 = [x.astype(np.float32) for x in map(np.asarray, kf_states[1])]

    pts = np.stack([
        rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
        rng.uniform(6, 14, n_pts),
    ], -1).astype(np.float32)

    def project(pc):
        return jnp.stack([pc[0] / pc[2], pc[1] / pc[2]], -1).reshape(2)

    pb = (pts - p2) @ R2
    uv = (pb[:, :2] / pb[:, 2:3]).astype(np.float32)
    valid = pb[:, 2] > 0.5

    # previous frame slightly perturbed from truth, anchored by a
    # strong prior AT TRUTH; current init perturbed
    dwp = rng.normal(0, 0.01, 3)
    Rp0 = R1 @ np.asarray(lie.so3_exp(jnp.asarray(dwp, jnp.float32)))
    tp0 = p1 + rng.normal(0, 0.02, 3).astype(np.float32)
    prior_H = jnp.eye(15, dtype=jnp.float32) * 1e6
    prior_state = (jnp.asarray(R1), jnp.asarray(p1), jnp.asarray(v1),
                   jnp.zeros(3, jnp.float32), jnp.zeros(3, jnp.float32))

    dw = rng.normal(0, 0.02, 3)
    R0 = R2 @ np.asarray(lie.so3_exp(jnp.asarray(dw, jnp.float32)))
    t0 = p2 + rng.normal(0, 0.05, 3).astype(np.float32)
    v0 = v2 + rng.normal(0, 0.1, 3).astype(np.float32)

    res = vi.optimize_pose_inertial_last_frame(
        jnp.asarray(R0), jnp.asarray(t0, jnp.float32), jnp.asarray(v0),
        jnp.zeros(3, jnp.float32), jnp.zeros(3, jnp.float32),
        (jnp.asarray(Rp0.astype(np.float32)), jnp.asarray(tp0),
         jnp.asarray(v1), jnp.zeros(3, jnp.float32),
         jnp.zeros(3, jnp.float32)),
        preint,
        jnp.asarray(pts), jnp.asarray(uv),
        jnp.full(n_pts, 1e4, jnp.float32), jnp.asarray(valid),
        jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32),
        project, prior=(prior_H, prior_state),
    )
    dR = np.asarray(res.Rwb) @ R2.T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    assert ang < 0.3, ang
    assert np.linalg.norm(np.asarray(res.twb) - p2) < 0.03
    assert np.linalg.norm(np.asarray(res.v) - v2) < 0.15
    assert int(res.n_inliers) > 80

    # the marginalized ConstraintPoseImu: symmetric, PSD, and
    # informative in the pose directions
    H = np.asarray(res.H)
    np.testing.assert_allclose(H, H.T, rtol=1e-4, atol=1e-2)
    w = np.linalg.eigvalsh(H)
    assert w.min() > -abs(w.max()) * 1e-4, w.min()  # PSD up to fp noise
    assert w.max() > 1e3                            # visual info present
