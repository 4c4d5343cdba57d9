"""Seeded long-session solver problems with exact ground truth.

The shapes follow a long SLAM session: a few hundred keyframes along a
path, tens of thousands of map points each seen by a window of
consecutive keyframes, and an essential graph of spanning-tree,
covisibility and loop edges.  The multi-device solvers are checked
against their single-device counterparts on these problems.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..solver import ba as sba
from ..solver import inertial as vi
from ..solver import pose_graph as pg
from ..imu import preintegration as pre
from .scenes import so3_exp

FX = FY = 500.0
CX, CY = 320.0, 240.0


def project_pinhole(pc):
    """Camera point (3,) -> pixel (2,) for the 640x480, f=500 camera."""
    return jnp.stack([FX * pc[0] / pc[2] + CX, FY * pc[1] / pc[2] + CY], -1)


def project_normalized(pc):
    """Camera point (3,) -> normalized image plane (2,)."""
    return jnp.stack([pc[0] / pc[2], pc[1] / pc[2]], -1)


class Truth(NamedTuple):
    R: np.ndarray        # (K,3,3) world->cam (body->world for VI)
    t: np.ndarray        # (K,3)
    points: np.ndarray   # (P,3)


def _observe(rng, R, t, n_pts, obs_per_pt, proj, noise):
    """Points anchored in front of consecutive keyframes, each seen by a
    window of ``obs_per_pt`` keyframes starting at its anchor.  Returns
    (points_world, obs_kf, obs_mp, obs_uv)."""
    n_kf = len(R)
    anchor = np.arange(n_pts) * n_kf // n_pts
    z = rng.uniform(4.0, 8.0, n_pts)
    pc = np.stack([rng.uniform(-0.5, 0.5, n_pts) * z,
                   rng.uniform(-0.4, 0.4, n_pts) * z, z], -1)
    pw = np.einsum("pji,pj->pi", R[anchor], pc - t[anchor])
    start = np.minimum(anchor, n_kf - obs_per_pt)
    kf = (start[:, None] + np.arange(obs_per_pt)[None, :]).reshape(-1)
    mp = np.repeat(np.arange(n_pts), obs_per_pt)
    pcam = np.einsum("oij,oj->oi", R[kf], pw[mp]) + t[kf]
    uv = proj(pcam)
    keep = (pcam[:, 2] > 0.5) & (np.abs(pcam[:, 0] / pcam[:, 2]) < 0.62) \
        & (np.abs(pcam[:, 1] / pcam[:, 2]) < 0.46)
    uv = uv + rng.normal(0.0, noise, uv.shape)
    return (pw.astype(np.float32), kf[keep].astype(np.int32),
            mp[keep].astype(np.int32), uv[keep].astype(np.float32))


def ba_problem(seed: int, n_kf: int = 300, n_pts: int = 30000,
               obs_per_pt: int = 10):
    """Global BA over a long monocular session (world->cam poses, pixel
    observations with 0.5 px noise, perturbed initial poses and points;
    keyframe 0 fixed).  Returns (BAProblem, Truth)."""
    rng = np.random.default_rng(seed)
    k = np.arange(n_kf)
    R = np.stack([so3_exp([0.0, 0.1 * np.sin(0.02 * i), 0.0]) for i in k])
    C = np.stack([0.1 * k, 0.3 * np.sin(0.05 * k), 0.05 * np.cos(0.03 * k)], -1)
    t = -np.einsum("kij,kj->ki", R, C)

    def proj(pc):
        return np.stack([FX * pc[:, 0] / pc[:, 2] + CX,
                         FY * pc[:, 1] / pc[:, 2] + CY], -1)

    pw, okf, omp, ouv = _observe(rng, R, t, n_pts, obs_per_pt, proj, 0.5)
    Rn = np.stack([R[i] @ so3_exp(rng.normal(0, 0.002, 3)) if i else R[i]
                   for i in k]).astype(np.float32)
    tn = t + np.where(k[:, None] > 0, rng.normal(0, 0.02, (n_kf, 3)), 0.0)
    pn = pw + rng.normal(0, 0.05, pw.shape)
    O = len(okf)
    fixed = np.zeros(n_kf, bool)
    fixed[0] = True
    prob = sba.BAProblem(
        R=jnp.asarray(Rn), t=jnp.asarray(tn, jnp.float32),
        points=jnp.asarray(pn, jnp.float32),
        obs_kf=jnp.asarray(okf), obs_mp=jnp.asarray(omp),
        obs_uv=jnp.asarray(ouv), inv_sigma2=jnp.ones(O, jnp.float32),
        obs_valid=jnp.ones(O, bool), fixed_kf=jnp.asarray(fixed),
        fixed_mp=jnp.zeros(n_pts, bool),
    )
    return prob, Truth(R.astype(np.float32), t.astype(np.float32), pw)


_IMU_HZ = 200.0
_NOISE = (1e-4, 1e-3, 1e-6, 1e-5)   # gyro, acc, gyro walk, acc walk


def _vi_truth(tt):
    """Body->world rotation, position, velocity, acceleration at tt."""
    w0 = np.array([0.02, -0.03, 0.1])
    p = np.stack([np.sin(tt), 0.5 * np.cos(2 * tt), 0.2 * tt], -1)
    v = np.stack([np.cos(tt), -np.sin(2 * tt), np.full_like(tt, 0.2)], -1)
    a = np.stack([-np.sin(tt), -2 * np.cos(2 * tt), np.zeros_like(tt)], -1)
    R = np.stack([so3_exp(w0 * s) for s in np.ravel(tt)]).reshape(
        np.shape(tt) + (3, 3))
    return R, p, v, a, w0


def vi_problem(seed: int, n_kf: int = 300, n_pts: int = 30000,
               obs_per_pt: int = 10, kf_dt: float = 0.1):
    """Full inertial BA over a long visual-inertial session: analytic
    body trajectory, 200 Hz IMU preintegrated between keyframes,
    normalized-plane observations, perturbed initial states (keyframe 0
    fixed).  Camera == body.  Returns (VIBAProblem, Truth)."""
    rng = np.random.default_rng(seed)
    kt = np.arange(n_kf) * kf_dt
    Rwb, twb, v, _, w0 = _vi_truth(kt)
    n_per = int(round(kf_dt * _IMU_HZ))
    dt = 1.0 / _IMU_HZ
    ts = kt[:-1, None] + (np.arange(n_per)[None, :] + 0.5) * dt
    Rt, _, _, a, _ = _vi_truth(ts)
    g = np.array([0.0, 0.0, -9.81])
    acc = np.einsum("snji,snj->sni", Rt, a - g)
    gyro = np.broadcast_to(w0, acc.shape)
    integ = jax.vmap(lambda gy, ac: pre.integrate(
        gy, ac, jnp.full((n_per,), dt, jnp.float32), jnp.ones(n_per, bool),
        jnp.zeros(6, jnp.float32), *_NOISE))
    p = jax.device_get(integ(jnp.asarray(gyro, jnp.float32),
                             jnp.asarray(acc, jnp.float32)))
    # edge k links keyframe k-1 -> k; slot 0 is a dummy (invalid)
    lead = lambda x: np.concatenate([x[:1], x], 0)
    chain = vi.InertialChain(
        dR=lead(p.dR), dV=lead(p.dV), dP=lead(p.dP), JRg=lead(p.JRg),
        JVg=lead(p.JVg), JVa=lead(p.JVa), JPg=lead(p.JPg), JPa=lead(p.JPa),
        dT=lead(p.dT), C=lead(p.C), bias0=lead(p.bias),
        valid=np.arange(n_kf) > 0,
    )
    chain = jax.tree_util.tree_map(jnp.asarray, chain)

    # world->cam for the observation generator
    Rcw = np.transpose(Rwb, (0, 2, 1))
    tcw = -np.einsum("kij,kj->ki", Rcw, twb)
    proj = lambda pc: pc[:, :2] / pc[:, 2:3]
    pw, okf, omp, ouv = _observe(rng, Rcw, tcw, n_pts, obs_per_pt, proj, 1e-3)
    k = np.arange(n_kf)[:, None] > 0
    Rn = np.stack([Rwb[i] @ so3_exp(rng.normal(0, 0.002, 3)) if i else Rwb[i]
                   for i in range(n_kf)])
    tn = twb + np.where(k, rng.normal(0, 0.02, (n_kf, 3)), 0.0)
    vn = v + np.where(k, rng.normal(0, 0.05, (n_kf, 3)), 0.0)
    pn = pw + rng.normal(0, 0.05, pw.shape)
    O = len(okf)
    fixed = np.zeros(n_kf, bool)
    fixed[0] = True
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    prob = vi.VIBAProblem(
        Rwb=f32(Rn), twb=f32(tn), v=f32(vn),
        bg=jnp.zeros((n_kf, 3), jnp.float32),
        ba=jnp.zeros((n_kf, 3), jnp.float32),
        points=f32(pn), obs_kf=jnp.asarray(okf), obs_mp=jnp.asarray(omp),
        obs_uv=jnp.asarray(ouv), inv_sigma2=jnp.full((O,), 1e6, jnp.float32),
        obs_valid=jnp.ones(O, bool), chain=chain,
        fixed_kf=jnp.asarray(fixed), fixed_mp=jnp.zeros(n_pts, bool),
        Rcb=jnp.eye(3, dtype=jnp.float32), tcb=jnp.zeros(3, jnp.float32),
    )
    return prob, Truth(Rwb.astype(np.float32), twb.astype(np.float32), pw)


def pose_graph_problem(seed: int, n_kf: int = 300, covis: int = 8,
                       n_loops: int = 300, pad_to: int = 128):
    """Sim3 essential graph of a long session: spanning-tree chain,
    ``covis`` covisibility edges per keyframe, ``n_loops`` long-range
    loop edges, exact measurements and a drifted initialisation
    (keyframe 0 fixed).  Edge arrays are padded to a multiple of
    ``pad_to`` with edge_valid=False.  Returns (PoseGraphProblem, Truth)."""
    rng = np.random.default_rng(seed)
    k = np.arange(n_kf)
    ang = 2 * np.pi * k / n_kf
    R = np.stack([so3_exp([0.0, 0.0, a]) for a in ang])
    C = np.stack([30 * np.cos(ang), 30 * np.sin(ang), 0.5 * np.sin(3 * ang)], -1)
    t = -np.einsum("kij,kj->ki", R, C)

    edges = [(i, i + d) for d in range(1, covis + 2) for i in range(n_kf - d)]
    far = rng.integers(0, n_kf, (n_loops, 2))
    edges += [(int(a), int(b)) for a, b in far if abs(int(a) - int(b)) > covis + 1]
    ei = np.array([e[0] for e in edges], np.int32)
    ej = np.array([e[1] for e in edges], np.int32)
    mR = np.einsum("eij,ekj->eik", R[ej], R[ei])          # R_j R_i^T
    mt = t[ej] - np.einsum("eij,ej->ei", mR, t[ei])

    # drift accumulates along the path
    drift = np.cumsum(rng.normal(0, 0.003, (n_kf, 3)), 0)
    drift[0] = 0
    R0 = np.stack([R[i] @ so3_exp(drift[i]) for i in k])
    t0 = t + np.cumsum(rng.normal(0, 0.02, (n_kf, 3)), 0) * (k[:, None] > 0)

    E = len(edges)
    E_pad = -(-E // pad_to) * pad_to
    pad = E_pad - E
    cat = lambda a, fill: np.concatenate([a, np.broadcast_to(fill, (pad,) + a.shape[1:])])
    f32 = lambda x: jnp.asarray(x, jnp.float32)
    prob = pg.PoseGraphProblem(
        R=f32(R0), t=f32(t0), s=jnp.ones(n_kf, jnp.float32),
        edge_i=jnp.asarray(cat(ei, 0)), edge_j=jnp.asarray(cat(ej, 0)),
        m_R=f32(cat(mR, np.eye(3))), m_t=f32(cat(mt, np.zeros(3))),
        m_s=jnp.ones(E_pad, jnp.float32), weight=jnp.ones(E_pad, jnp.float32),
        edge_valid=jnp.asarray(np.arange(E_pad) < E), fixed=jnp.asarray(k == 0),
    )
    return prob, Truth(R.astype(np.float32), t.astype(np.float32), np.zeros((0, 3)))


def place_problem(seed: int, n_kf: int = 300, n_words: int = 1000,
                  words_per_kf: int = 300, n_desc: int = 256):
    """Keyframe database of a long session: normalized bag-of-words
    histograms, word-presence masks, descriptor blocks, a validity mask
    and a query close to keyframe n_kf//3.  Returns a dict of numpy
    arrays."""
    rng = np.random.default_rng(seed)
    hists = np.zeros((n_kf, n_words), np.float32)
    for i in range(n_kf):
        w = rng.choice(n_words, words_per_kf, replace=False)
        hists[i, w] = rng.random(words_per_kf)
    hists /= hists.sum(1, keepdims=True)
    valid = rng.random(n_kf) > 0.05
    target = n_kf // 3
    valid[target] = True
    q = hists[target] + (hists[target] > 0) * rng.random(n_words).astype(np.float32) * 1e-3
    q /= q.sum()
    return dict(hists=hists, has_word=hists > 0, valid=valid, query=q,
                target=target,
                desc=rng.integers(0, 256, (n_kf, n_desc, 32), np.uint8))
