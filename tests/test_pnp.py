"""RANSAC PnP (relocalization solver) tests: synthetic pose recovery
with outliers — the check the reference never automates for its
PnPsolver/MLPnPsolver (it only exercises them live in Relocalization).
"""

import jax
import jax.numpy as jnp
import numpy as np

from extractorb.core import lie
from extractorb.solver import pnp


def _scene(rng, n=200, n_out=60):
    pts = np.stack(
        [rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 9, n)],
        -1,
    ).astype(np.float32)
    w = np.array([0.1, -0.2, 0.05], np.float32)
    R = np.asarray(lie.so3_exp(jnp.asarray(w)))
    t = np.array([0.3, -0.1, 0.5], np.float32)
    pc = pts @ R.T + t
    xy = pc[:, :2] / pc[:, 2:3]
    xy += rng.normal(0, 0.001, xy.shape).astype(np.float32)
    out_idx = rng.choice(n, n_out, replace=False)
    xy[out_idx] += rng.uniform(0.1, 0.5, (n_out, 2)) * rng.choice([-1, 1], (n_out, 2))
    return pts, xy.astype(np.float32), R, t, out_idx


def test_ransac_pnp_recovers_pose(rng):
    pts, xy, R, t, out_idx = _scene(rng)
    valid = np.ones(len(pts), bool)
    res = pnp.ransac_pnp(
        jnp.asarray(pts), jnp.asarray(xy), jnp.asarray(valid),
        jax.random.PRNGKey(0),
    )
    assert bool(res.ok)
    assert int(res.n_inliers) > 100
    # recovered rotation within ~1 deg, translation within 5cm
    dR = np.asarray(res.R) @ R.T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    assert ang < 2.0, ang
    assert np.linalg.norm(np.asarray(res.t) - t) < 0.1
    # outliers are (mostly) excluded
    inl = np.asarray(res.inliers)
    assert inl[out_idx].mean() < 0.2


def test_ransac_pnp_refine_tightens(rng):
    pts, xy, R, t, _ = _scene(rng)
    valid = np.ones(len(pts), bool)
    res = pnp.ransac_pnp(
        jnp.asarray(pts), jnp.asarray(xy), jnp.asarray(valid),
        jax.random.PRNGKey(1),
    )
    refined = pnp.refine_pnp(
        res, jnp.asarray(pts), jnp.asarray(xy), lambda pc: pc[:2] / pc[2],
    )
    dR = np.asarray(refined.R) @ R.T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    assert ang < 0.5
    assert np.linalg.norm(np.asarray(refined.t) - t) < 0.02


def test_ransac_pnp_rejects_garbage(rng):
    n = 100
    pts = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    xy = rng.uniform(-1, 1, (n, 2)).astype(np.float32)
    valid = np.ones(n, bool)
    res = pnp.ransac_pnp(
        jnp.asarray(pts), jnp.asarray(xy), jnp.asarray(valid),
        jax.random.PRNGKey(2), min_inliers=30,
    )
    assert not bool(res.ok)


def test_ransac_pnp_respects_valid_mask(rng):
    pts, xy, R, t, _ = _scene(rng, n_out=0)
    valid = np.zeros(len(pts), bool)
    valid[:50] = True
    # corrupt every invalid entry completely
    xy[50:] = rng.uniform(-3, 3, (len(pts) - 50, 2))
    res = pnp.ransac_pnp(
        jnp.asarray(pts), jnp.asarray(xy), jnp.asarray(valid),
        jax.random.PRNGKey(3),
    )
    assert bool(res.ok)
    assert not np.asarray(res.inliers)[~valid].any()


def test_epnp_beats_dlt_under_noise(rng):
    """EPnP minimal solver (reference inc/PnPsolver.h:60-92) vs the
    round-1 DLT under realistic pixel noise (sigma ~ 2.5 px at f=500):
    the control-point parametrization must recover the pose and a large
    inlier set where the raw projective DLT degrades (the round-1
    verdict's noise-fragility finding)."""
    n = 150
    pts = np.stack(
        [rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
         rng.uniform(4, 9, n)], -1,
    ).astype(np.float32)
    R = np.asarray(lie.so3_exp(jnp.asarray([0.15, -0.1, 0.08], jnp.float32)))
    t = np.array([0.4, -0.2, 0.6], np.float32)
    pc = pts @ R.T + t
    xy = pc[:, :2] / pc[:, 2:3]
    sigma = 2.5 / 500.0  # 2.5 px at f=500, in normalized units
    xy = (xy + rng.normal(0, sigma, xy.shape)).astype(np.float32)
    valid = np.ones(n, bool)
    th = 3.0 * sigma

    def run(solver, seed):
        return pnp.ransac_pnp(
            jnp.asarray(pts), jnp.asarray(xy), jnp.asarray(valid),
            jax.random.PRNGKey(seed), th=th, n_hypotheses=128,
            solver=solver,
        )

    def ang_err(res):
        dR = np.asarray(res.R) @ R.T
        return np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))

    ep = [run("epnp", s) for s in range(5)]
    dl = [run("dlt", s) for s in range(5)]
    ep_inl = np.mean([int(r.n_inliers) for r in ep])
    dl_inl = np.mean([int(r.n_inliers) for r in dl])
    # EPnP finds a clearly larger consensus set and a tighter pose
    assert ep_inl > dl_inl * 1.15, (ep_inl, dl_inl)
    assert ep_inl > 0.75 * n, ep_inl
    assert np.mean([ang_err(r) for r in ep]) < 1.5  # unrefined minimal solve


def test_mlpnp_recovers_pose_with_off_axis_bearings(rng):
    """MLPnP (nullspace bearings) recovers a pose from a fisheye-like
    field of view INCLUDING rays >87 deg off-axis that a z=1 projection
    cannot express (the reference MLPnPsolver's raison d'etre)."""
    from extractorb.core import lie

    N = 120
    # points spread over more than a hemisphere around the camera
    dirs = rng.normal(size=(N, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs[:, 2] = np.abs(dirs[:, 2]) * 0.4 - 0.1  # many near/behind z=0
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    depth = rng.uniform(2, 8, N)[:, None]
    R_gt = np.asarray(lie.so3_exp(jnp.asarray([0.2, -0.3, 0.1])),
                      np.float32)
    t_gt = np.array([0.4, -0.2, 0.6], np.float32)
    pc = (dirs * depth).astype(np.float32)          # camera-frame points
    p3d = (pc - t_gt) @ R_gt                        # world points
    bear = (pc / np.linalg.norm(pc, axis=1, keepdims=True)).astype(
        np.float32)
    # sanity: a sizeable share of rays are >80 deg off-axis
    assert (bear[:, 2] < 0.17).mean() > 0.3

    valid = np.ones(N, bool)
    res = pnp.mlpnp_ransac(
        jnp.asarray(p3d), jnp.asarray(bear), jnp.asarray(valid),
        jax.random.PRNGKey(0),
    )
    assert bool(res.ok), int(res.n_inliers)
    R1, t1 = pnp.mlpnp_refine(
        res.R, res.t, jnp.asarray(p3d), jnp.asarray(bear),
        jnp.full(N, 1e4, jnp.float32), jnp.asarray(valid),
    )
    dR = np.asarray(R1) @ R_gt.T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    assert ang < 0.2, ang
    assert np.linalg.norm(np.asarray(t1) - t_gt) < 0.02


def test_mlpnp_robust_to_outliers(rng):
    from extractorb.core import lie

    N = 100
    dirs = rng.normal(size=(N, 3))
    dirs[:, 2] = np.abs(dirs[:, 2]) + 0.3
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    depth = rng.uniform(2, 8, N)[:, None]
    R_gt = np.asarray(lie.so3_exp(jnp.asarray([0.1, 0.2, -0.1])),
                      np.float32)
    t_gt = np.array([-0.3, 0.1, 0.2], np.float32)
    pc = (dirs * depth).astype(np.float32)
    p3d = (pc - t_gt) @ R_gt
    bear = (pc / np.linalg.norm(pc, axis=1, keepdims=True)).astype(
        np.float32)
    out = rng.choice(N, 30, replace=False)
    bear[out] = rng.normal(size=(30, 3)).astype(np.float32)
    bear[out] /= np.linalg.norm(bear[out], axis=1, keepdims=True)

    res = pnp.mlpnp_ransac(
        jnp.asarray(p3d), jnp.asarray(bear), jnp.ones(N, bool),
        jax.random.PRNGKey(1),
    )
    assert bool(res.ok)
    inl = np.asarray(res.inliers)
    assert inl[out].mean() < 0.2          # outliers rejected
    dR = np.asarray(res.R) @ R_gt.T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    assert ang < 1.0, ang
