"""Solver tests: pose optimization + bundle adjustment on synthetic data."""

import jax
import jax.numpy as jnp
import numpy as np

from extractorb.core import lie
from extractorb.solver import ba as sba
from extractorb.solver import pose_opt as spo

FX, FY, CX, CY = 500.0, 500.0, 320.0, 240.0


def project(pc):
    return jnp.stack(
        [FX * pc[0] / pc[2] + CX, FY * pc[1] / pc[2] + CY], -1
    ).reshape(2)


def make_pose_scene(rng, n=200, noise=0.5, n_out=40):
    pts = np.stack(
        [rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)],
        -1,
    ).astype(np.float32)
    w = np.array([0.05, -0.1, 0.03])
    R = np.asarray(lie.so3_exp(jnp.asarray(w))).astype(np.float32)
    t = np.array([0.2, -0.1, 0.15], np.float32)
    pc = pts @ R.T + t
    uv = np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], -1)
    uv += rng.normal(size=uv.shape) * noise
    out_idx = rng.choice(n, n_out, replace=False)
    uv[out_idx] += rng.uniform(20, 80, size=(n_out, 2)) * np.sign(
        rng.normal(size=(n_out, 2))
    )
    inl = np.ones(n, bool)
    inl[out_idx] = False
    return pts, R, t, uv.astype(np.float32), inl


def test_pose_optimization_converges(rng):
    pts, R, t, uv, inl = make_pose_scene(rng)
    # start from a perturbed pose
    dR, dt = lie.se3_exp(jnp.asarray([0.05, -0.03, 0.08, 0.02, 0.04, -0.05], jnp.float32))
    R0 = jnp.asarray(R) @ dR
    t0 = jnp.asarray(R) @ dt + jnp.asarray(t)
    res = spo.optimize_pose(
        R0, t0, jnp.asarray(pts), jnp.asarray(uv),
        jnp.ones(len(pts), jnp.float32), jnp.ones(len(pts), bool), project,
    )
    R_err = np.linalg.norm(np.asarray(lie.so3_log(res.R @ jnp.asarray(R).T)))
    t_err = np.linalg.norm(np.asarray(res.t) - t)
    assert R_err < 2e-3, R_err
    assert t_err < 8e-3, t_err
    got_inl = np.asarray(res.inliers)
    # all true outliers rejected; few true inliers lost
    assert (got_inl & ~inl).sum() <= 2
    assert (inl & got_inl).sum() >= 0.95 * inl.sum()


def make_ba_scene(rng, n_kf=6, n_mp=120, noise=0.3):
    pts = np.stack(
        [rng.uniform(-2, 2, n_mp), rng.uniform(-1.5, 1.5, n_mp),
         rng.uniform(4, 9, n_mp)], -1
    ).astype(np.float32)
    Rs, ts, obs = [], [], []
    for k in range(n_kf):
        w = rng.normal(size=3) * 0.03
        R = np.asarray(lie.so3_exp(jnp.asarray(w))).astype(np.float32)
        t = np.array([0.25 * k, 0, 0], np.float32) + rng.normal(size=3).astype(
            np.float32
        ) * 0.02
        Rs.append(R)
        ts.append(t)
        pc = pts @ R.T + t
        uv = np.stack(
            [FX * pc[:, 0] / pc[:, 2] + CX, FY * pc[:, 1] / pc[:, 2] + CY], -1
        )
        uv += rng.normal(size=uv.shape) * noise
        for i in range(n_mp):
            obs.append((k, i, uv[i, 0], uv[i, 1]))
    return np.stack(Rs), np.stack(ts), pts, obs


def test_bundle_adjustment_reduces_error(rng):
    Rs, ts, pts, obs = make_ba_scene(rng)
    K, P, O = len(Rs), len(pts), len(obs)
    obs_kf = np.array([o[0] for o in obs], np.int32)
    obs_mp = np.array([o[1] for o in obs], np.int32)
    obs_uv = np.array([[o[2], o[3]] for o in obs], np.float32)

    # perturb everything except pose 0 (gauge)
    Rs_n = Rs.copy()
    ts_n = ts.copy()
    for k in range(1, K):
        dR, dt = lie.se3_exp(jnp.asarray(rng.normal(size=6).astype(np.float32) * 0.01))
        Rs_n[k] = Rs[k] @ np.asarray(dR)
        ts_n[k] = Rs[k] @ np.asarray(dt) + ts[k]
    pts_n = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.05

    fixed_kf = np.zeros(K, bool)
    fixed_kf[0] = True
    prob = sba.BAProblem(
        R=jnp.asarray(Rs_n), t=jnp.asarray(ts_n), points=jnp.asarray(pts_n),
        obs_kf=jnp.asarray(obs_kf), obs_mp=jnp.asarray(obs_mp),
        obs_uv=jnp.asarray(obs_uv),
        inv_sigma2=jnp.ones(O, jnp.float32),
        obs_valid=jnp.ones(O, bool),
        fixed_kf=jnp.asarray(fixed_kf),
        fixed_mp=jnp.zeros(P, bool),
    )
    res = sba.optimize(prob, project, n_iters=12, cg_iters=50)

    def rms(R, t, points):
        r = []
        for o in range(O):
            pc = np.asarray(R)[obs_kf[o]] @ np.asarray(points)[obs_mp[o]] + np.asarray(t)[obs_kf[o]]
            uv = np.array([FX * pc[0] / pc[2] + CX, FY * pc[1] / pc[2] + CY])
            r.append(((uv - obs_uv[o]) ** 2).sum())
        return np.sqrt(np.mean(r))

    e0 = rms(Rs_n, ts_n, pts_n)
    e1 = rms(res.R, res.t, res.points)
    assert e1 < 0.6  # near the 0.3px noise floor
    assert e1 < e0 / 5, (e0, e1)
    # fixed pose untouched
    np.testing.assert_allclose(np.asarray(res.R)[0], Rs_n[0], atol=1e-7)
    np.testing.assert_allclose(np.asarray(res.t)[0], ts_n[0], atol=1e-7)


def test_ba_outlier_classification(rng):
    Rs, ts, pts, obs = make_ba_scene(rng, n_kf=4, n_mp=80)
    O = len(obs)
    obs_kf = np.array([o[0] for o in obs], np.int32)
    obs_mp = np.array([o[1] for o in obs], np.int32)
    obs_uv = np.array([[o[2], o[3]] for o in obs], np.float32)
    out = rng.choice(O, 30, replace=False)
    obs_uv[out] += 50.0
    fixed_kf = np.zeros(len(Rs), bool)
    fixed_kf[0] = True
    prob = sba.BAProblem(
        R=jnp.asarray(Rs), t=jnp.asarray(ts), points=jnp.asarray(pts),
        obs_kf=jnp.asarray(obs_kf), obs_mp=jnp.asarray(obs_mp),
        obs_uv=jnp.asarray(obs_uv),
        inv_sigma2=jnp.ones(O, jnp.float32),
        obs_valid=jnp.ones(O, bool),
        fixed_kf=jnp.asarray(fixed_kf),
        fixed_mp=jnp.zeros(len(pts), bool),
    )
    res = sba.optimize(prob, project, n_iters=8, cg_iters=40)
    inl = np.asarray(res.inliers)
    assert not inl[out].any()
    mask = np.ones(O, bool)
    mask[out] = False
    assert inl[mask].mean() > 0.90


def test_pose_optimization_stereo(rng):
    """Stereo observations (u, v, uR) should sharpen the pose estimate."""
    pts, R, t, uv, inl = make_pose_scene(rng, n_out=0, noise=0.3)
    bf = 50.0  # fx * b with b = 0.1
    pc = pts @ R.T + t
    ur = uv[:, 0] - bf / pc[:, 2] + rng.normal(size=len(pts)).astype(np.float32) * 0.3
    # half the observations mono (ur = -1)
    ur[::2] = -1.0
    dR, dt = lie.se3_exp(jnp.asarray([0.03, -0.02, 0.05, 0.01, 0.03, -0.04], jnp.float32))
    R0 = jnp.asarray(R) @ dR
    t0 = jnp.asarray(R) @ dt + jnp.asarray(t)
    res = spo.optimize_pose(
        R0, t0, jnp.asarray(pts), jnp.asarray(uv),
        jnp.ones(len(pts), jnp.float32), jnp.ones(len(pts), bool), project,
        4, 10, bf, jnp.asarray(ur.astype(np.float32)),
    )
    R_err = np.linalg.norm(np.asarray(lie.so3_log(res.R @ jnp.asarray(R).T)))
    t_err = np.linalg.norm(np.asarray(res.t) - t)
    assert R_err < 2e-3, R_err
    assert t_err < 8e-3, t_err
    assert int(res.n_inliers) > 0.9 * len(pts)


def test_ba_stereo_observations(rng):
    Rs, ts, pts, obs = make_ba_scene(rng, n_kf=4, n_mp=80, noise=0.3)
    O = len(obs)
    obs_kf = np.array([o[0] for o in obs], np.int32)
    obs_mp = np.array([o[1] for o in obs], np.int32)
    obs_uv = np.array([[o[2], o[3]] for o in obs], np.float32)
    bf = 50.0
    ur = np.full(O, -1.0, np.float32)
    for o in range(0, O, 2):  # half stereo
        pc = Rs[obs_kf[o]] @ pts[obs_mp[o]] + ts[obs_kf[o]]
        ur[o] = obs_uv[o, 0] - bf / pc[2] + rng.normal() * 0.3
    Rs_n = Rs.copy(); ts_n = ts.copy()
    for k in range(1, len(Rs)):
        dR, dt = lie.se3_exp(jnp.asarray(rng.normal(size=6).astype(np.float32) * 0.01))
        Rs_n[k] = Rs[k] @ np.asarray(dR)
        ts_n[k] = Rs[k] @ np.asarray(dt) + ts[k]
    pts_n = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.05
    fixed_kf = np.zeros(len(Rs), bool); fixed_kf[0] = True
    prob = sba.BAProblem(
        R=jnp.asarray(Rs_n), t=jnp.asarray(ts_n), points=jnp.asarray(pts_n),
        obs_kf=jnp.asarray(obs_kf), obs_mp=jnp.asarray(obs_mp),
        obs_uv=jnp.asarray(obs_uv),
        inv_sigma2=jnp.ones(O, jnp.float32),
        obs_valid=jnp.ones(O, bool),
        fixed_kf=jnp.asarray(fixed_kf),
        fixed_mp=jnp.zeros(len(pts), bool),
        obs_ur=jnp.asarray(ur),
    )
    res = sba.optimize(prob, project, n_iters=10, cg_iters=40, bf=bf)
    # reprojection error reduced near noise floor
    def rms(R, t, points):
        r = []
        for o in range(O):
            pc = np.asarray(R)[obs_kf[o]] @ np.asarray(points)[obs_mp[o]] + np.asarray(t)[obs_kf[o]]
            uv2 = np.array([FX * pc[0] / pc[2] + CX, FY * pc[1] / pc[2] + CY])
            r.append(((uv2 - obs_uv[o]) ** 2).sum())
        return np.sqrt(np.mean(r))
    assert rms(res.R, res.t, res.points) < 0.6
    assert np.asarray(res.inliers).mean() > 0.9


def test_marginalize_condition_sparsify(rng):
    """Schur utilities (reference Optimizer.cc:5026-5140): marginalizing
    a Gaussian block must reproduce the analytic Schur complement,
    conditioning zeroes it, and sparsify removes exactly the cross-block
    information."""
    import jax.numpy as jnp

    from extractorb.solver import marginal as mg

    n = 9
    A = rng.normal(size=(n, n + 3)).astype(np.float32)
    H = A @ A.T + 0.1 * np.eye(n, dtype=np.float32)

    # marginalize middle block [3..5]
    got = np.asarray(mg.marginalize(jnp.asarray(H), 3, 5))
    keep = np.r_[0:3, 6:9]
    marg = np.r_[3:6]
    schur = H[np.ix_(keep, keep)] - H[np.ix_(keep, marg)] @ np.linalg.inv(
        H[np.ix_(marg, marg)]) @ H[np.ix_(marg, keep)]
    np.testing.assert_allclose(got[np.ix_(keep, keep)], schur, rtol=2e-4,
                               atol=2e-4)
    assert np.all(got[3:6, :] == 0) and np.all(got[:, 3:6] == 0)

    got_c = np.asarray(mg.condition(jnp.asarray(H), 3, 5))
    assert np.all(got_c[3:6, :] == 0) and np.all(got_c[:, 3:6] == 0)
    np.testing.assert_array_equal(got_c[np.ix_(keep, keep)],
                                  H[np.ix_(keep, keep)])

    # sparsify blocks [0..2] and [6..8]: their cross coupling vanishes,
    # and marginalizing the rest out of H' gives (approximately) the
    # independent marginals
    got_s = np.asarray(mg.sparsify(jnp.asarray(H), 0, 2, 6, 8))
    np.testing.assert_allclose(got_s[0:3, 6:9], 0, atol=2e-3)
    np.testing.assert_allclose(got_s[6:9, 0:3], 0, atol=2e-3)


def test_schur_dense_matches_cg(rng):
    """The dense-Schur direct solver reaches the same fixed point as
    matrix-free CG (solver/ba.py solver= option)."""
    import jax.numpy as jnp
    from extractorb.core import lie

    Rs, ts, pts, obs = make_ba_scene(rng, n_kf=6, n_mp=120)
    K, P, O = len(Rs), len(pts), len(obs)
    obs_kf = np.array([o[0] for o in obs], np.int32)
    obs_mp = np.array([o[1] for o in obs], np.int32)
    obs_uv = np.array([[o[2], o[3]] for o in obs], np.float32)
    Rs_n, ts_n = Rs.copy(), ts.copy()
    for k in range(1, K):
        dR, dt = lie.se3_exp(
            jnp.asarray(rng.normal(size=6).astype(np.float32) * 0.01))
        Rs_n[k] = Rs[k] @ np.asarray(dR)
        ts_n[k] = Rs[k] @ np.asarray(dt) + ts[k]
    pts_n = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.05
    fixed = np.zeros(K, bool)
    fixed[0] = True
    prob = sba.BAProblem(
        R=jnp.asarray(Rs_n), t=jnp.asarray(ts_n), points=jnp.asarray(pts_n),
        obs_kf=jnp.asarray(obs_kf), obs_mp=jnp.asarray(obs_mp),
        obs_uv=jnp.asarray(obs_uv), inv_sigma2=jnp.ones(O, jnp.float32),
        obs_valid=jnp.ones(O, bool), fixed_kf=jnp.asarray(fixed),
        fixed_mp=jnp.zeros(P, bool),
    )
    r_cg = sba.optimize(prob, project, n_iters=8, cg_iters=60, solver="cg")
    r_d = sba.optimize(prob, project, n_iters=8, solver="schur_dense")
    assert float(r_d.cost) <= float(r_cg.cost) * 1.05 + 1e-3
    np.testing.assert_allclose(
        np.asarray(r_d.R), np.asarray(r_cg.R), atol=5e-3
    )
