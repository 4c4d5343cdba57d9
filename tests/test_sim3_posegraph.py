"""Sim3 solver + pose-graph tests (loop closing machinery)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from extractorb.core import lie
from extractorb.geometry import sim3 as gsim3
from extractorb.solver import pose_graph as pg


FX, FY, CX, CY = 500.0, 500.0, 320.0, 240.0


def project(pc):
    return jnp.stack(
        [FX * pc[0] / pc[2] + CX, FY * pc[1] / pc[2] + CY], -1
    ).reshape(2)


def test_sim3_log_roundtrip(rng):
    xi = jnp.asarray(rng.normal(size=(16, 7)).astype(np.float32) * 0.6)
    R, t, s = lie.sim3_exp(xi)
    xi2 = lie.sim3_log(R, t, s)
    np.testing.assert_allclose(np.asarray(xi2), np.asarray(xi), atol=2e-5)


def test_horn_exact(rng):
    p1 = rng.normal(size=(30, 3)).astype(np.float32)
    w = np.array([0.3, -0.2, 0.5], np.float32)
    R = np.asarray(lie.so3_exp(jnp.asarray(w)))
    s, t = 1.7, np.array([0.5, -1.0, 2.0], np.float32)
    p2 = s * p1 @ R.T + t
    Rh, th, sh = gsim3.horn_sim3(jnp.asarray(p1), jnp.asarray(p2))
    np.testing.assert_allclose(np.asarray(Rh), R, atol=1e-4)
    np.testing.assert_allclose(float(sh), s, atol=1e-4)
    np.testing.assert_allclose(np.asarray(th), t, atol=1e-3)


def test_sim3_ransac(rng):
    n = 200
    p1 = np.stack(
        [rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)],
        -1,
    ).astype(np.float32)
    w = np.array([0.05, -0.1, 0.08], np.float32)
    R = np.asarray(lie.so3_exp(jnp.asarray(w)))
    s, t = 1.3, np.array([0.4, -0.1, 0.3], np.float32)
    p2 = s * p1 @ R.T + t
    # outliers
    out = rng.choice(n, 50, replace=False)
    p2[out] += rng.normal(size=(50, 3)) * 2.0

    def proj_np(p):
        return np.stack([FX * p[:, 0] / p[:, 2] + CX, FY * p[:, 1] / p[:, 2] + CY], -1)

    uv1 = proj_np(p1).astype(np.float32)
    uv2 = proj_np(p2).astype(np.float32)
    res = gsim3.solve_sim3_ransac(
        jax.random.PRNGKey(0), jnp.asarray(p1), jnp.asarray(p2),
        jnp.asarray(uv1), jnp.asarray(uv2), jnp.ones(n, bool), project,
    )
    assert bool(res.success)
    np.testing.assert_allclose(np.asarray(res.R12), R, atol=1e-2)
    np.testing.assert_allclose(float(res.s12), s, atol=1e-2)
    inl = np.asarray(res.inliers)
    assert not inl[out].any()
    mask = np.ones(n, bool); mask[out] = False
    assert inl[mask].mean() > 0.95


def test_pose_graph_closes_loop(rng):
    """Circle of keyframes with odometry drift; one loop edge fixes it."""
    K = 24
    # ground truth: poses on a circle
    Rs_gt, ts_gt = [], []
    for k in range(K):
        a = 2 * np.pi * k / K
        Rwc = np.asarray(lie.so3_exp(jnp.asarray([0.0, 0.0, a], jnp.float32)))
        C = np.array([np.cos(a), np.sin(a), 0.0], np.float32) * 3.0
        R = Rwc.T
        t = -R @ C
        Rs_gt.append(R.astype(np.float32))
        ts_gt.append(t.astype(np.float32))

    # odometry edges with drift: measurement from noisy relative poses
    def rel(Ri, ti, si, Rj, tj, sj):
        Rii, tii, sii = lie.sim3_inverse(
            jnp.asarray(Ri), jnp.asarray(ti), jnp.asarray(si)
        )
        return lie.sim3_compose(jnp.asarray(Rj), jnp.asarray(tj), jnp.asarray(sj), Rii, tii, sii)

    # build drifted initial estimate by chaining noisy odometry
    Rs_est = [Rs_gt[0]]
    ts_est = [ts_gt[0]]
    ss_est = [np.float32(1.0)]
    edges = []
    drift = np.asarray(
        lie.sim3_exp(jnp.asarray([0.01, 0.005, 0, 0, 0, 0.008, 0.004], jnp.float32))[0]
    )
    for k in range(1, K):
        mR, mt, ms = rel(Rs_gt[k - 1], ts_gt[k - 1], 1.0, Rs_gt[k], ts_gt[k], 1.0)
        edges.append((k - 1, k, np.asarray(mR), np.asarray(mt), float(ms), 1.0))
        # drifted estimate: compose measurement with an extra drift factor
        dR, dt, ds = lie.sim3_exp(
            jnp.asarray([0.02, 0.01, 0.0, 0.0, 0.0, 0.015, 0.01], jnp.float32)
        )
        mRd, mtd, msd = lie.sim3_compose(dR, dt, ds, mR, mt, ms)
        Re, te, se = lie.sim3_compose(
            mRd, mtd, msd,
            jnp.asarray(Rs_est[-1]), jnp.asarray(ts_est[-1]), jnp.asarray(ss_est[-1]),
        )
        Rs_est.append(np.asarray(Re))
        ts_est.append(np.asarray(te))
        ss_est.append(np.asarray(se))

    # loop edge K-1 -> 0 with the TRUE relative pose
    mR, mt, ms = rel(Rs_gt[K - 1], ts_gt[K - 1], 1.0, Rs_gt[0], ts_gt[0], 1.0)
    edges.append((K - 1, 0, np.asarray(mR), np.asarray(mt), float(ms), 5.0))

    E = len(edges)
    prob = pg.PoseGraphProblem(
        R=jnp.asarray(np.stack(Rs_est)),
        t=jnp.asarray(np.stack(ts_est)),
        s=jnp.asarray(np.stack(ss_est)),
        edge_i=jnp.asarray(np.array([e[0] for e in edges], np.int32)),
        edge_j=jnp.asarray(np.array([e[1] for e in edges], np.int32)),
        m_R=jnp.asarray(np.stack([e[2] for e in edges])),
        m_t=jnp.asarray(np.stack([e[3] for e in edges])),
        m_s=jnp.asarray(np.array([e[4] for e in edges], np.float32)),
        weight=jnp.asarray(np.array([e[5] for e in edges], np.float32)),
        edge_valid=jnp.ones(E, bool),
        fixed=jnp.asarray(np.arange(K) == 0),
    )
    R, t, s, cost = pg.optimize_pose_graph(prob, n_iters=25)
    R, t, s = map(np.asarray, (R, t, s))

    # drifted trajectory error before vs after
    def traj_err(Rs, ts, ss):
        e = 0.0
        for k in range(K):
            C_est = -(Rs[k].T @ ts[k]) / ss[k]
            C_gt = -(Rs_gt[k].T @ ts_gt[k])
            e += np.linalg.norm(C_est - C_gt) ** 2
        return np.sqrt(e / K)

    e0 = traj_err(np.stack(Rs_est), np.stack(ts_est), np.stack(ss_est))
    e1 = traj_err(R, t, s)
    assert e1 < e0 * 0.35, (e0, e1)
    assert abs(float(cost)) < 1e-2, cost


def test_pose_graph_4dof_closes_loop(rng):
    """Inertial essential graph (Optimizer.cc:8153): yaw+translation
    drift on a circle is corrected by one loop edge; roll/pitch stay
    exactly fixed because they are not in the tangent."""
    K = 24
    Rs_gt, ts_gt = [], []
    for k in range(K):
        a = 2 * np.pi * k / K
        Rwc = np.asarray(lie.so3_exp(jnp.asarray([0.0, 0.0, a], jnp.float32)))
        C = np.array([np.cos(a), np.sin(a), 0.0], np.float32) * 3.0
        R = Rwc.T
        ts_gt.append((-R @ C).astype(np.float32))
        Rs_gt.append(R.astype(np.float32))

    def rel(Ri, ti, Rj, tj):
        Rii, tii = lie.se3_inverse(jnp.asarray(Ri), jnp.asarray(ti))
        return lie.se3_compose(jnp.asarray(Rj), jnp.asarray(tj), Rii, tii)

    # drifted estimate: chain odometry with a yaw+translation drift factor
    Rs_est, ts_est = [Rs_gt[0]], [ts_gt[0]]
    edges = []
    for k in range(1, K):
        mR, mt = rel(Rs_gt[k - 1], ts_gt[k - 1], Rs_gt[k], ts_gt[k])
        edges.append((k - 1, k, np.asarray(mR), np.asarray(mt), 1.0))
        dR, dt = lie.se3_exp(
            jnp.asarray([0.0, 0.0, 0.02, 0.015, 0.01, 0.0], jnp.float32)
        )
        mRd, mtd = lie.se3_compose(dR, dt, mR, mt)
        Re, te = lie.se3_compose(
            mRd, mtd, jnp.asarray(Rs_est[-1]), jnp.asarray(ts_est[-1])
        )
        Rs_est.append(np.asarray(Re))
        ts_est.append(np.asarray(te))

    mR, mt = rel(Rs_gt[K - 1], ts_gt[K - 1], Rs_gt[0], ts_gt[0])
    edges.append((K - 1, 0, np.asarray(mR), np.asarray(mt), 5.0))

    E = len(edges)
    prob = pg.PoseGraph4DoFProblem(
        R=jnp.asarray(np.stack(Rs_est)),
        t=jnp.asarray(np.stack(ts_est)),
        edge_i=jnp.asarray(np.array([e[0] for e in edges], np.int32)),
        edge_j=jnp.asarray(np.array([e[1] for e in edges], np.int32)),
        m_R=jnp.asarray(np.stack([e[2] for e in edges])),
        m_t=jnp.asarray(np.stack([e[3] for e in edges])),
        weight=jnp.asarray(np.array([e[4] for e in edges], np.float32)),
        edge_valid=jnp.ones(E, bool),
        fixed=jnp.asarray(np.arange(K) == 0),
    )
    R, t, cost = pg.optimize_pose_graph_4dof(prob, n_iters=25)
    R, t = map(np.asarray, (R, t))

    def traj_err(Rs, ts):
        e = 0.0
        for k in range(K):
            C_est = -(Rs[k].T @ ts[k])
            C_gt = -(Rs_gt[k].T @ ts_gt[k])
            e += np.linalg.norm(C_est - C_gt) ** 2
        return np.sqrt(e / K)

    e0 = traj_err(np.stack(Rs_est), np.stack(ts_est))
    e1 = traj_err(R, t)
    assert e1 < e0 * 0.35, (e0, e1)
    # gravity direction untouched: world z in camera frame keeps its tilt
    for k in range(K):
        gz_est = R[k] @ np.array([0, 0, 1.0], np.float32)
        gz0 = np.stack(Rs_est)[k] @ np.array([0, 0, 1.0], np.float32)
        np.testing.assert_allclose(gz_est, gz0, atol=1e-4)


def test_optimize_sim3_refines_and_classifies(rng):
    """optimize_sim3 (reference Optimizer.cc:3888): from a perturbed
    initial Sim3 it must recover the true transform and reject the
    planted outlier correspondences."""
    import jax.numpy as jnp
    from extractorb.core import lie as _lie
    from extractorb.geometry import sim3 as gs

    n = 120
    p2 = np.stack(
        [rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)],
        -1,
    ).astype(np.float32)
    w = np.array([0.03, -0.05, 0.02], np.float32)
    R = np.asarray(_lie.so3_exp(jnp.asarray(w)), np.float32)
    t = np.array([0.4, -0.1, 0.2], np.float32)
    s = 1.3
    p1 = (s * (p2 @ R.T) + t).astype(np.float32)

    fx = fy = 450.0
    cx, cy = 320.0, 240.0

    def project(pc):
        return jnp.stack(
            [fx * pc[0] / pc[2] + cx, fy * pc[1] / pc[2] + cy], -1
        ).reshape(2)

    def proj_np(P):
        return np.stack(
            [fx * P[:, 0] / P[:, 2] + cx, fy * P[:, 1] / P[:, 2] + cy], -1
        )

    obs1 = proj_np(p1) + rng.normal(size=(n, 2)) * 0.4
    obs2 = proj_np(p2) + rng.normal(size=(n, 2)) * 0.4
    # plant outliers
    out = rng.choice(n, 15, replace=False)
    obs1[out] += rng.uniform(20, 60, size=(15, 2))

    # perturbed initial guess
    dR = np.asarray(_lie.so3_exp(jnp.asarray([0.02, 0.01, -0.015])), np.float32)
    res = gs.optimize_sim3(
        jnp.asarray(dR @ R), jnp.asarray(t + 0.1), jnp.float32(s * 1.08),
        jnp.asarray(p1), jnp.asarray(p2),
        jnp.asarray(obs1.astype(np.float32)),
        jnp.asarray(obs2.astype(np.float32)),
        jnp.ones(n, bool), project,
    )
    assert int(res.n_in) >= n - 20, int(res.n_in)
    inl = np.asarray(res.inliers)
    assert not inl[out].any()
    R_err = np.asarray(_lie.so3_log(jnp.asarray(np.asarray(res.R12) @ R.T)))
    assert np.linalg.norm(R_err) < 2e-3, R_err
    assert abs(float(res.s12) - s) < 0.01
    np.testing.assert_allclose(np.asarray(res.t12), t, atol=0.02)


def test_optimize_sim3_fixed_scale(rng):
    import jax.numpy as jnp
    from extractorb.core import lie as _lie
    from extractorb.geometry import sim3 as gs

    n = 80
    p2 = np.stack(
        [rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)],
        -1,
    ).astype(np.float32)
    R = np.asarray(_lie.so3_exp(jnp.asarray([0.0, 0.04, 0.0])), np.float32)
    t = np.array([0.3, 0.0, 0.1], np.float32)
    p1 = (p2 @ R.T + t).astype(np.float32)

    def project(pc):
        return jnp.stack(
            [450.0 * pc[0] / pc[2] + 320.0, 450.0 * pc[1] / pc[2] + 240.0], -1
        ).reshape(2)

    def proj_np(P):
        return np.stack(
            [450.0 * P[:, 0] / P[:, 2] + 320.0, 450.0 * P[:, 1] / P[:, 2] + 240.0],
            -1,
        )

    res = gs.optimize_sim3(
        jnp.asarray(R), jnp.asarray(t + 0.05), jnp.float32(1.0),
        jnp.asarray(p1), jnp.asarray(p2),
        jnp.asarray(proj_np(p1).astype(np.float32)),
        jnp.asarray(proj_np(p2).astype(np.float32)),
        jnp.ones(n, bool), project, True,
    )
    assert float(res.s12) == 1.0  # scale frozen (stereo mode)
    assert int(res.n_in) >= n - 2


def test_pose_graph_fixed_scale_mode(rng):
    """6-DoF essential graph (reference Optimizer.cc:2621): with
    fix_scale, vertex scales stay exactly 1 while rotations/translations
    still converge."""
    K = 12
    ang = np.linspace(0, np.pi, K)
    R_gt, t_gt = [], []
    for a in ang:
        R = np.asarray(lie.so3_exp(jnp.asarray([0.0, 0.0, a], jnp.float32)))
        C = np.array([np.cos(a), np.sin(a), 0], np.float32) * 2
        R_gt.append(R)
        t_gt.append(-R @ C)
    R_gt = np.stack(R_gt).astype(np.float32)
    t_gt = np.stack(t_gt).astype(np.float32)
    edges = [(k, k + 1) for k in range(K - 1)] + [(0, K - 1)]
    E = len(edges)

    def rel(i, j):
        Rm = R_gt[j] @ R_gt[i].T
        return Rm, t_gt[j] - Rm @ t_gt[i]

    R0, t0 = R_gt.copy(), t_gt.copy()
    for k in range(1, K):
        d = rng.normal(size=3).astype(np.float32) * 0.02
        R0[k] = R_gt[k] @ np.asarray(lie.so3_exp(jnp.asarray(d)))
        t0[k] = t_gt[k] + rng.normal(size=3).astype(np.float32) * 0.05

    prob = pg.PoseGraphProblem(
        R=jnp.asarray(R0), t=jnp.asarray(t0), s=jnp.ones(K, jnp.float32),
        edge_i=jnp.asarray(np.array([e[0] for e in edges], np.int32)),
        edge_j=jnp.asarray(np.array([e[1] for e in edges], np.int32)),
        m_R=jnp.asarray(np.stack([rel(*e)[0] for e in edges])),
        m_t=jnp.asarray(np.stack([rel(*e)[1] for e in edges])),
        m_s=jnp.ones(E, jnp.float32),
        weight=jnp.ones(E, jnp.float32),
        edge_valid=jnp.ones(E, bool),
        fixed=jnp.asarray(np.arange(K) == 0),
    )
    R, t, s, _ = pg.optimize_pose_graph(prob, n_iters=12, fix_scale=True)
    np.testing.assert_array_equal(np.asarray(s), np.ones(K, np.float32))
    err = np.linalg.norm(np.asarray(t) - t_gt, axis=-1).mean()
    err0 = np.linalg.norm(t0 - t_gt, axis=-1).mean()
    assert err < 0.3 * err0, (err0, err)


@pytest.mark.parametrize("variant", ["sim3", "sim3_sharded", "4dof"])
def test_pose_graph_spreads_long_drift(variant):
    """A long chain with few loop edges: the drift that a loop
    correction spreads is the graph's smoothest mode.  With the System's
    settings (15 LM iterations) every variant reaches the exact
    solution of the noise-free graph."""
    from extractorb.dist import mesh as dmesh
    from extractorb.dist import sharded_pose_graph as dpg
    from extractorb.sim import problems

    prob, truth = problems.pose_graph_problem(0, n_kf=160, n_loops=6)
    if variant == "sim3":
        t = pg.optimize_pose_graph(prob)[1]
    elif variant == "sim3_sharded":
        t = dpg.optimize_sharded_pose_graph(dmesh.make_mesh(8), prob)[1]
    else:
        # yaw-only drift: roll and pitch are observable under gravity
        rng = np.random.default_rng(0)
        yaw = np.cumsum(rng.normal(0, 0.003, len(truth.R)))
        yaw[0] = 0
        R0 = np.stack([R @ lie.so3_exp(jnp.float32([0, 0, y]))
                       for R, y in zip(truth.R, yaw)])
        prob = pg.PoseGraph4DoFProblem(
            R=jnp.asarray(R0, jnp.float32), t=prob.t, edge_i=prob.edge_i,
            edge_j=prob.edge_j, m_R=prob.m_R, m_t=prob.m_t,
            weight=prob.weight, edge_valid=prob.edge_valid, fixed=prob.fixed)
        t = pg.optimize_pose_graph_4dof(prob)[1]
    err0 = np.linalg.norm(np.asarray(prob.t) - truth.t, axis=1).max()
    err = np.linalg.norm(np.asarray(t) - truth.t, axis=1).max()
    assert err0 > 0.3 and err < 1e-3, (err0, err)
