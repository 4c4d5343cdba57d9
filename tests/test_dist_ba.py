"""Distributed BA on the virtual 8-device CPU mesh vs single-device BA."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from extractorb.core import lie
from extractorb.dist import mesh as dmesh
from extractorb.dist import sharded_ba as dba
from extractorb.solver import ba as sba

from test_solver import FX, FY, CX, CY, project, make_ba_scene


def build_problem(rng, n_kf=6, n_mp=100):
    Rs, ts, pts, obs = make_ba_scene(rng, n_kf=n_kf, n_mp=n_mp)
    K, P, O = len(Rs), len(pts), len(obs)
    obs_kf = np.array([o[0] for o in obs], np.int32)
    obs_mp = np.array([o[1] for o in obs], np.int32)
    obs_uv = np.array([[o[2], o[3]] for o in obs], np.float32)
    Rs_n = Rs.copy()
    ts_n = ts.copy()
    for k in range(1, K):
        dR, dt = lie.se3_exp(jnp.asarray(rng.normal(size=6).astype(np.float32) * 0.01))
        Rs_n[k] = Rs[k] @ np.asarray(dR)
        ts_n[k] = Rs[k] @ np.asarray(dt) + ts[k]
    pts_n = pts + rng.normal(size=pts.shape).astype(np.float32) * 0.05
    # pad O to a multiple of 8 for the mesh
    Opad = ((O + 7) // 8) * 8
    pad = lambda a, fill=0: np.concatenate(
        [a, np.full((Opad - O,) + a.shape[1:], fill, a.dtype)], 0
    )
    fixed_kf = np.zeros(K, bool)
    fixed_kf[0] = True
    prob = sba.BAProblem(
        R=jnp.asarray(Rs_n), t=jnp.asarray(ts_n), points=jnp.asarray(pts_n),
        obs_kf=jnp.asarray(pad(obs_kf)), obs_mp=jnp.asarray(pad(obs_mp)),
        obs_uv=jnp.asarray(pad(obs_uv)),
        inv_sigma2=jnp.asarray(pad(np.ones(O, np.float32), 1.0)),
        obs_valid=jnp.asarray(pad(np.ones(O, bool), False)),
        fixed_kf=jnp.asarray(fixed_kf),
        fixed_mp=jnp.zeros(P, bool),
    )
    return prob, (Rs, ts, pts, obs_kf, obs_mp, obs_uv)


def test_sharded_matches_single(rng):
    assert len(jax.devices()) >= 8, jax.devices()
    prob, truth = build_problem(rng)
    res1 = sba.optimize(prob, project, n_iters=8, cg_iters=40)
    mesh = dmesh.make_mesh(8)
    res8 = dba.optimize_sharded(mesh, prob, project, n_iters=8, cg_iters=40)
    # same fixed point: costs close, poses close
    assert float(res8.cost) <= float(res1.cost) * 1.2 + 1.0
    np.testing.assert_allclose(
        np.asarray(res8.R), np.asarray(res1.R), atol=5e-3
    )
    np.testing.assert_allclose(
        np.asarray(res8.t), np.asarray(res1.t), atol=5e-3
    )


def test_sharded_reduces_error(rng):
    prob, (Rs, ts, pts, obs_kf, obs_mp, obs_uv) = build_problem(rng)
    mesh = dmesh.make_mesh(8)
    res = dba.optimize_sharded(mesh, prob, project, n_iters=10, cg_iters=40)
    R_out, t_out, p_out = map(np.asarray, (res.R, res.t, res.points))

    def rms(R, t, points):
        e = []
        for o in range(len(obs_kf)):
            pc = R[obs_kf[o]] @ points[obs_mp[o]] + t[obs_kf[o]]
            uv = np.array([FX * pc[0] / pc[2] + CX, FY * pc[1] / pc[2] + CY])
            e.append(((uv - obs_uv[o]) ** 2).sum())
        return np.sqrt(np.mean(e))

    assert rms(R_out, t_out, p_out) < 0.6


def _ring_pose_graph(rng, K=24, E_pad=64):
    """Noisy Sim3 ring: K poses on a circle, chain + a few chords, with
    drift injected; returns a padded PoseGraphProblem."""
    from extractorb.solver import pose_graph as pg

    ang = np.linspace(0, 2 * np.pi, K, endpoint=False)
    R_gt, t_gt = [], []
    for a in ang:
        R = np.asarray(lie.so3_exp(jnp.asarray([0.0, 0.0, a], jnp.float32)))
        C = np.array([np.cos(a) * 3, np.sin(a) * 3, 0], np.float32)
        R_gt.append(R)
        t_gt.append(-R @ C)
    R_gt, t_gt = np.stack(R_gt).astype(np.float32), np.stack(t_gt).astype(np.float32)

    edges = [(k, (k + 1) % K) for k in range(K)]
    edges += [(k, (k + 5) % K) for k in range(0, K, 3)]

    def rel(i, j):
        Rm = R_gt[j] @ R_gt[i].T
        tm = t_gt[j] - Rm @ t_gt[i]
        return Rm, tm

    E = len(edges)
    ei = np.array([e[0] for e in edges], np.int32)
    ej = np.array([e[1] for e in edges], np.int32)
    mR = np.stack([rel(*e)[0] for e in edges]).astype(np.float32)
    mt = np.stack([rel(*e)[1] for e in edges]).astype(np.float32)

    # drifted initialisation
    R0, t0 = R_gt.copy(), t_gt.copy()
    for k in range(1, K):
        d = rng.normal(size=3).astype(np.float32) * 0.02
        dR = np.asarray(lie.so3_exp(jnp.asarray(d)))
        R0[k] = R_gt[k] @ dR
        t0[k] = t_gt[k] + rng.normal(size=3).astype(np.float32) * 0.05

    pad = E_pad - E
    prob = pg.PoseGraphProblem(
        R=jnp.asarray(R0), t=jnp.asarray(t0), s=jnp.ones(K, jnp.float32),
        edge_i=jnp.asarray(np.concatenate([ei, np.zeros(pad, np.int32)])),
        edge_j=jnp.asarray(np.concatenate([ej, np.zeros(pad, np.int32)])),
        m_R=jnp.asarray(np.concatenate(
            [mR, np.tile(np.eye(3, dtype=np.float32), (pad, 1, 1))])),
        m_t=jnp.asarray(np.concatenate([mt, np.zeros((pad, 3), np.float32)])),
        m_s=jnp.ones(E_pad, jnp.float32),
        weight=jnp.ones(E_pad, jnp.float32),
        edge_valid=jnp.asarray(
            np.concatenate([np.ones(E, bool), np.zeros(pad, bool)])),
        fixed=jnp.asarray(np.arange(K) == 0),
    )
    return prob, R_gt, t_gt


def test_sharded_pose_graph_matches_single(rng):
    """Edge-sharded essential-graph GN equals the single-device solver
    (SURVEY §5.7: pose graph shards edges, psum-reduces the system)."""
    from extractorb.dist import sharded_pose_graph as dpg
    from extractorb.solver import pose_graph as pg

    prob, R_gt, t_gt = _ring_pose_graph(rng)
    R1, t1, s1, c1 = pg.optimize_pose_graph(prob, n_iters=10)
    mesh = dmesh.make_mesh(8)
    R8, t8, s8, c8 = dpg.optimize_sharded_pose_graph(mesh, prob, n_iters=10)
    np.testing.assert_allclose(np.asarray(R8), np.asarray(R1), atol=5e-3)
    np.testing.assert_allclose(np.asarray(t8), np.asarray(t1), atol=5e-3)
    np.testing.assert_allclose(np.asarray(s8), np.asarray(s1), atol=5e-3)
    # and the optimisation actually fixed the drift
    err = np.linalg.norm(np.asarray(t8) - t_gt, axis=-1).mean()
    err0 = np.linalg.norm(np.asarray(prob.t) - t_gt, axis=-1).mean()
    assert err < 0.5 * err0, (err0, err)


def test_kf_block_sharding_roundtrip(rng):
    """KF-axis sharded place scores + all_gather covisibility fetch
    (SURVEY §5.7: covisibility fetch = all_gather of candidate blocks)."""
    from extractorb.dist import kf_blocks as kfb

    mesh = dmesh.make_mesh(8)
    K, W, N = 24, 64, 32
    hists = rng.random((K, W)).astype(np.float32)
    hists /= hists.sum(1, keepdims=True)
    has_word = hists > 1.0 / W
    valid = np.ones(K, bool)
    valid[-3:] = False
    q = hists[5] + rng.random(W).astype(np.float32) * 0.01
    q /= q.sum()

    Kp = 24  # multiple of 8
    scores, common = kfb.sharded_place_scores(
        mesh, kfb.shard_kf_axis(mesh, jnp.asarray(hists)),
        kfb.shard_kf_axis(mesh, jnp.asarray(has_word)),
        kfb.shard_kf_axis(mesh, jnp.asarray(valid)),
        jnp.asarray(q),
    )
    scores = np.asarray(scores)
    # matches the host formula
    ref = 1.0 - 0.5 * np.abs(hists - q[None]).sum(1)
    ref[~valid] = -np.inf
    np.testing.assert_allclose(scores, ref, atol=1e-5)
    assert int(np.argmax(scores)) == 5

    # covisibility fetch: every device receives the requested blocks
    desc = rng.integers(0, 256, (K, N, 32), np.uint8)
    idx = np.array([5, 17, 2], np.int32)
    got = kfb.all_gather_kf_blocks(
        mesh, kfb.shard_kf_axis(mesh, jnp.asarray(desc)), jnp.asarray(idx)
    )
    np.testing.assert_array_equal(np.asarray(got), desc[idx])


def test_sharded_loop_candidate_match(rng):
    """Distributed whole-database descriptor matching: the KF holding a
    copy of the query's descriptors wins."""
    from extractorb.dist import kf_blocks as kfb

    mesh = dmesh.make_mesh(8)
    K, N = 16, 64
    desc = rng.integers(0, 256, (K, N, 32), np.uint8)
    q = desc[11].copy()
    counts = kfb.sharded_loop_candidate_match(
        mesh,
        kfb.shard_kf_axis(mesh, jnp.asarray(desc)),
        kfb.shard_kf_axis(mesh, jnp.asarray(np.ones((K, N), bool))),
        jnp.asarray(q), jnp.asarray(np.ones(N, bool)),
    )
    counts = np.asarray(counts)
    assert int(np.argmax(counts)) == 11
    assert counts[11] >= N - 2


def _relayout_for_schur(prob, n_dev=8, block=16):
    """Re-order observations so each lives on its point's shard and pad
    points/obs to mesh-divisible sizes (the dist/global_ba.py layout)."""
    obs_kf = np.asarray(prob.obs_kf)
    obs_mp = np.asarray(prob.obs_mp)
    obs_uv = np.asarray(prob.obs_uv)
    osig = np.asarray(prob.inv_sigma2)
    oval = np.asarray(prob.obs_valid)
    P = prob.points.shape[0]
    Ps = -(-P // n_dev)
    P_pad = Ps * n_dev
    pts = np.zeros((P_pad, 3), np.float32)
    pts[:, 2] = 1.0
    pts[:P] = np.asarray(prob.points)
    fixed_mp = np.ones(P_pad, bool)
    fixed_mp[:P] = np.asarray(prob.fixed_mp)

    shard_of = obs_mp // Ps
    order = np.argsort(shard_of, kind="stable")
    obs_kf, obs_mp, obs_uv = obs_kf[order], obs_mp[order], obs_uv[order]
    osig, oval, shard_of = osig[order], oval[order], shard_of[order]
    counts = np.bincount(shard_of[oval], minlength=n_dev)
    # note: invalid (padding) obs from the original problem are dropped
    keep = oval
    obs_kf, obs_mp, obs_uv, osig = (
        obs_kf[keep], obs_mp[keep], obs_uv[keep], osig[keep]
    )
    shard_of = shard_of[keep]
    Os = int(np.ceil(max(int(counts.max()), 1) / block) * block)
    O_pad = Os * n_dev
    okf = np.zeros(O_pad, np.int32)
    omp = np.zeros(O_pad, np.int32)
    ouv = np.zeros((O_pad, 2), np.float32)
    osg = np.ones(O_pad, np.float32)
    ovl = np.zeros(O_pad, bool)
    start = 0
    for s in range(n_dev):
        n = int(counts[s])
        dst = s * Os
        sel = slice(start, start + n)
        okf[dst:dst + n] = obs_kf[sel]
        omp[dst:dst + n] = obs_mp[sel]
        ouv[dst:dst + n] = obs_uv[sel]
        osg[dst:dst + n] = osig[sel]
        ovl[dst:dst + n] = True
        omp[dst + n:dst + Os] = s * Ps
        start += n
    return sba.BAProblem(
        R=prob.R, t=prob.t, points=jnp.asarray(pts),
        obs_kf=jnp.asarray(okf), obs_mp=jnp.asarray(omp),
        obs_uv=jnp.asarray(ouv), inv_sigma2=jnp.asarray(osg),
        obs_valid=jnp.asarray(ovl), fixed_kf=prob.fixed_kf,
        fixed_mp=jnp.asarray(fixed_mp),
    )


def test_schur_sharded_matches_single(rng):
    """The landmark-sharded Schur GBA converges to the single-device
    solver's fixed point (poses close, cost comparable)."""
    prob, _ = build_problem(rng)
    res1 = sba.optimize(prob, project, n_iters=15, cg_iters=40)
    mesh = dmesh.make_mesh(8)
    sprob = _relayout_for_schur(prob, 8)
    res8 = dba.optimize_schur_sharded(mesh, sprob, project, n_iters=15,
                                      cg_iters=30)
    # different inner linear solvers (joint PCG vs reduced-system PCG):
    # same basin, near-identical costs, poses close
    assert float(res8.cost) <= float(res1.cost) * 1.1 + 1.0
    np.testing.assert_allclose(
        np.asarray(res8.R), np.asarray(res1.R), atol=1e-2
    )
    np.testing.assert_allclose(
        np.asarray(res8.t), np.asarray(res1.t), atol=1e-2
    )


def test_schur_sharded_reduces_error(rng):
    prob, (Rs, ts, pts, obs_kf, obs_mp, obs_uv) = build_problem(rng)
    mesh = dmesh.make_mesh(8)
    sprob = _relayout_for_schur(prob, 8)
    res = dba.optimize_schur_sharded(mesh, sprob, project, n_iters=10,
                                     cg_iters=20)
    R_out, t_out, p_out = map(np.asarray, (res.R, res.t, res.points))

    def rms(R, t, points):
        e = []
        for o in range(len(obs_kf)):
            pc = R[obs_kf[o]] @ points[obs_mp[o]] + t[obs_kf[o]]
            uv = np.array([FX * pc[0] / pc[2] + CX, FY * pc[1] / pc[2] + CY])
            e.append(((uv - obs_uv[o]) ** 2).sum())
        return np.sqrt(np.mean(e))

    assert rms(R_out, t_out, p_out) < 0.6


def test_vi_sharded_matches_single(rng):
    """optimize_vi_sharded (visual residuals/landmarks sharded over the
    mesh, inertial chain replicated) reaches the single-device
    optimize_vi_ba fixed point — the post-loop inertial GBA path
    (reference FullInertialBA, Optimizer.cc:420)."""
    import sys as _sys
    _sys.path.insert(0, "tests")
    from test_inertial import _vi_problem
    from extractorb.solver import inertial as vi

    prob, vproject, (Rwb, twb, v, pts) = _vi_problem(
        np.random.default_rng(3), n_kf=6, n_pts=128, perturb=1.0
    )
    res1 = vi.optimize_vi_ba(prob, vproject, n_iters=8, cg_iters=50)

    n_dev = 8
    mesh = dmesh.make_mesh(n_dev)
    P = prob.points.shape[0]
    P_pad = -(-P // n_dev) * n_dev
    pts_p = np.zeros((P_pad, 3), np.float32)
    pts_p[:, 2] = 1.0
    pts_p[:P] = np.asarray(prob.points)
    fmp = np.ones(P_pad, bool)
    fmp[:P] = np.asarray(prob.fixed_mp)
    okf, omp, ouv, osig, oval = dba.relayout_point_sharded(
        np.asarray(prob.obs_kf), np.asarray(prob.obs_mp),
        np.asarray(prob.obs_uv), np.asarray(prob.inv_sigma2),
        np.asarray(prob.obs_valid), P_pad, n_dev,
    )
    prob8 = vi.VIBAProblem(
        Rwb=prob.Rwb, twb=prob.twb, v=prob.v, bg=prob.bg, ba=prob.ba,
        points=jnp.asarray(pts_p),
        obs_kf=jnp.asarray(okf), obs_mp=jnp.asarray(omp),
        obs_uv=jnp.asarray(ouv), inv_sigma2=jnp.asarray(osig),
        obs_valid=jnp.asarray(oval), chain=prob.chain,
        fixed_kf=prob.fixed_kf, fixed_mp=jnp.asarray(fmp),
        Rcb=prob.Rcb, tcb=prob.tcb,
    )
    res8 = dba.optimize_vi_sharded(mesh, prob8, vproject,
                                   n_iters=8, cg_iters=50)
    np.testing.assert_allclose(
        np.asarray(res8.twb), np.asarray(res1.twb), atol=5e-3
    )
    np.testing.assert_allclose(
        np.asarray(res8.Rwb), np.asarray(res1.Rwb), atol=5e-3
    )
    np.testing.assert_allclose(
        np.asarray(res8.v), np.asarray(res1.v), atol=2e-2
    )
    # and both recover the ground truth
    assert np.abs(np.asarray(res8.twb) - twb).max() < 0.03
