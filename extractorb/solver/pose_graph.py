"""Sim3 pose-graph optimisation (essential graph).

Replaces Optimizer::OptimizeEssentialGraph (reference:
src/Optimizer.cc:2303, 7-DoF mono variant): keyframe poses become Sim3
vertices; spanning-tree/covisibility/loop edges carry relative Sim3
measurements; the graph is solved by LM.

Design: edges live in a COO (i, j, measurement); residuals
r = log_sim3(m_ij * S_i * S_j^-1) and their Jacobians (jacfwd through
the left-multiplicative sim3 retraction) are one vmap.  Each LM step
scatters them into the dense (K d, K d) normal equations and solves
them by Cholesky, as the reference's g2o solves its sparse ones
exactly.  A graph holds at most the map's keyframes (a few hundred),
so the dense system stays small, and an exact step matters here: the
drift a loop correction spreads is the graph's smoothest mode, which a
block-Jacobi PCG of a fixed step count leaves largely unconverged on a
long session.  Fixed vertices (the loop keyframe) are masked.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import lie


class PoseGraph4DoFProblem(NamedTuple):
    """Inertial essential graph (reference: Optimizer.cc:8153
    OptimizeEssentialGraph4DoF): gravity is observable, so only yaw and
    translation are free per keyframe; roll/pitch (and scale) stay
    fixed.  Vertices are world->cam SE3 poses with a 4-dim tangent
    (dyaw about world z, dt in world); edges carry relative SE3
    measurements with a full 6-dim log residual (Edge4DoF,
    inc/G2oTypes.h:833)."""

    R: jnp.ndarray        # (K,3,3) world->cam
    t: jnp.ndarray        # (K,3)
    edge_i: jnp.ndarray   # (E,) int32
    edge_j: jnp.ndarray   # (E,) int32
    # measurement m_ij = T_j * T_i^-1 at edge creation time
    m_R: jnp.ndarray      # (E,3,3)
    m_t: jnp.ndarray      # (E,3)
    weight: jnp.ndarray   # (E,)
    edge_valid: jnp.ndarray  # (E,)
    fixed: jnp.ndarray    # (K,)


def _apply_4dof(R, t, d):
    """World-frame 4-DoF update (ImuCamPose::UpdateW semantics): the
    camera->world pose rotates by Exp((0,0,dyaw)) about the world z axis
    and translates by (dx,dy,dz); expressed on the world->cam pose."""
    dR = lie.so3_exp(jnp.stack([jnp.zeros_like(d[0]), jnp.zeros_like(d[0]), d[0]]))
    # Twc' = [dR,dt] * Twc  =>  Tcw' = Tcw * [dR,dt]^-1
    Rn = jnp.matmul(R, dR.T)
    tn = t - jnp.matmul(Rn, d[1:4])
    return Rn, tn


def _edge_residual_4dof(Ri, ti, Rj, tj, mR, mt, di, dj):
    """r = log_se3(m_ij * (T_i <+ di) * (T_j <+ dj)^-1), 6-dim."""
    Ri2, ti2 = _apply_4dof(Ri, ti, di)
    Rj2, tj2 = _apply_4dof(Rj, tj, dj)
    Rji, tji = lie.se3_inverse(Rj2, tj2)
    Ra, ta = lie.se3_compose(Ri2, ti2, Rji, tji)
    Rb, tb = lie.se3_compose(mR, mt, Ra, ta)
    return lie.se3_log(Rb, tb)


def normal_equations(r, Ji, Jj, w, edge_i, edge_j, K):
    """Gradient (K, d) and dense Gauss-Newton Hessian (K, K, d, d) of
    sum_e w_e |r_e|^2 over an edge list (the local shard's when the
    edges are sharded: the caller psums both)."""
    d = Ji.shape[-1]
    Jiw = Ji * w[:, None, None]
    Jjw = Jj * w[:, None, None]
    g = jnp.zeros((K, d), r.dtype)
    g = g.at[edge_i].add(jnp.einsum("eif,ei->ef", Jiw, r))
    g = g.at[edge_j].add(jnp.einsum("eif,ei->ef", Jjw, r))
    H = jnp.zeros((K, K, d, d), r.dtype)
    H = H.at[edge_i, edge_i].add(jnp.einsum("eif,eig->efg", Jiw, Ji))
    H = H.at[edge_j, edge_j].add(jnp.einsum("eif,eig->efg", Jjw, Jj))
    H = H.at[edge_i, edge_j].add(jnp.einsum("eif,eig->efg", Jiw, Jj))
    H = H.at[edge_j, edge_i].add(jnp.einsum("eif,eig->efg", Jjw, Ji))
    return g, H


def damped_step(H, g, lam, free):
    """LM step d = -(H + lam I)^-1 g by one dense Cholesky over the free
    coordinates (``free``: (K, d) of 0/1); fixed coordinates get 0."""
    K, d = g.shape
    f = free.reshape(-1)
    A = H.transpose(0, 2, 1, 3).reshape(K * d, K * d)
    A = A * f[:, None] * f[None, :] + jnp.diag(lam * f + (1.0 - f))
    L = jnp.linalg.cholesky(A)
    x = jax.scipy.linalg.cho_solve((L, True), g.reshape(-1) * f)
    return -x.reshape(K, d) * free


@functools.partial(jax.jit, static_argnums=(1,))
def optimize_pose_graph_4dof(
    p: PoseGraph4DoFProblem, n_iters: int = 15
):
    """LM over the 4-DoF essential graph; same dense Cholesky step as
    the Sim3 variant below, with 4-dim vertex blocks."""
    K = p.R.shape[0]
    dtype = p.t.dtype
    free = jnp.broadcast_to((~p.fixed).astype(dtype)[:, None], (K, 4))
    zero4 = jnp.zeros(4, dtype)

    def build(R, t):
        Ri, ti = R[p.edge_i], t[p.edge_i]
        Rj, tj = R[p.edge_j], t[p.edge_j]

        def per_edge(Ri, ti, Rj, tj, mR, mt):
            r = _edge_residual_4dof(Ri, ti, Rj, tj, mR, mt, zero4, zero4)
            Ji = jax.jacfwd(
                lambda d: _edge_residual_4dof(Ri, ti, Rj, tj, mR, mt, d, zero4)
            )(zero4)
            Jj = jax.jacfwd(
                lambda d: _edge_residual_4dof(Ri, ti, Rj, tj, mR, mt, zero4, d)
            )(zero4)
            return r, Ji, Jj

        return jax.vmap(per_edge)(Ri, ti, Rj, tj, p.m_R, p.m_t)

    def lm_step(state, _):
        R, t, lam = state
        r, Ji, Jj = build(R, t)
        w = p.weight * p.edge_valid.astype(dtype)
        g, H = normal_equations(r, Ji, Jj, w, p.edge_i, p.edge_j, K)
        d = damped_step(H, g, lam, free)

        Rn, tn = jax.vmap(_apply_4dof)(R, t, d)
        Rn = jax.vmap(lie.normalize_rotation)(Rn)

        def cost(R, t):
            r2, _, _ = build(R, t)
            return jnp.sum(
                jnp.where(p.edge_valid, jnp.sum(r2 * r2, -1) * p.weight, 0.0)
            )

        c_new = cost(Rn, tn)
        c_old = cost(R, t)
        better = c_new < c_old
        R = jnp.where(better, Rn, R)
        t = jnp.where(better, tn, t)
        lam = jnp.where(better, lam * 0.5, lam * 4.0)
        return (R, t, lam), c_new

    state = (p.R, p.t, jnp.asarray(1e-4, dtype))
    state, costs = jax.lax.scan(lm_step, state, None, length=n_iters)
    R, t, _ = state
    return R, t, costs[-1]


def vertex_mask(fixed, fix_scale: bool, dtype):
    """(K, 7) of 0/1: the free tangent coordinates of each Sim3 vertex.
    fix_scale masks the scale coordinate (index 6 of the sim3 log)."""
    free = (~fixed).astype(dtype)[:, None] * jnp.ones(7, dtype)
    if fix_scale:
        free = free * (jnp.arange(7) < 6).astype(dtype)
    return free


class PoseGraphProblem(NamedTuple):
    R: jnp.ndarray        # (K,3,3) world->cam
    t: jnp.ndarray        # (K,3)
    s: jnp.ndarray        # (K,)
    edge_i: jnp.ndarray   # (E,) int32
    edge_j: jnp.ndarray   # (E,) int32
    # measurement m_ij = S_j * S_i^-1 at edge creation time
    m_R: jnp.ndarray      # (E,3,3)
    m_t: jnp.ndarray      # (E,3)
    m_s: jnp.ndarray      # (E,)
    weight: jnp.ndarray   # (E,)
    edge_valid: jnp.ndarray  # (E,)
    fixed: jnp.ndarray    # (K,)


def _edge_residual(Ri, ti, si, Rj, tj, sj, mR, mt, ms, di, dj):
    """r = log(m_ij * (Exp(di) S_i) * (Exp(dj) S_j)^-1)."""
    dRi, dti, dsi = lie.sim3_exp(di)
    dRj, dtj, dsj = lie.sim3_exp(dj)
    Ri2, ti2, si2 = lie.sim3_compose(dRi, dti, dsi, Ri, ti, si)
    Rj2, tj2, sj2 = lie.sim3_compose(dRj, dtj, dsj, Rj, tj, sj)
    Rji, tji, sji = lie.sim3_inverse(Rj2, tj2, sj2)
    Ra, ta, sa = lie.sim3_compose(Ri2, ti2, si2, Rji, tji, sji)
    Rb, tb, sb = lie.sim3_compose(mR, mt, ms, Ra, ta, sa)
    return lie.sim3_log(Rb, tb, sb)


@functools.partial(jax.jit, static_argnums=(1, 2))
def optimize_pose_graph(
    p: PoseGraphProblem, n_iters: int = 15, fix_scale: bool = False,
):
    """fix_scale=True freezes the per-vertex scale coordinate — the
    reference's 6-DoF stereo/RGBD essential graph
    (OptimizeEssentialGraph with bFixScale, src/Optimizer.cc:2621)."""
    K = p.R.shape[0]
    dtype = p.t.dtype
    free = vertex_mask(p.fixed, fix_scale, dtype)
    zero7 = jnp.zeros(7, dtype)

    def build(R, t, s):
        Ri, ti, si = R[p.edge_i], t[p.edge_i], s[p.edge_i]
        Rj, tj, sj = R[p.edge_j], t[p.edge_j], s[p.edge_j]

        def per_edge(Ri, ti, si, Rj, tj, sj, mR, mt, ms):
            r = _edge_residual(Ri, ti, si, Rj, tj, sj, mR, mt, ms, zero7, zero7)
            Ji = jax.jacfwd(
                lambda d: _edge_residual(Ri, ti, si, Rj, tj, sj, mR, mt, ms, d, zero7)
            )(zero7)
            Jj = jax.jacfwd(
                lambda d: _edge_residual(Ri, ti, si, Rj, tj, sj, mR, mt, ms, zero7, d)
            )(zero7)
            return r, Ji, Jj

        return jax.vmap(per_edge)(
            Ri, ti, si, Rj, tj, sj, p.m_R, p.m_t, p.m_s
        )

    def lm_step(state, _):
        R, t, s, lam = state
        r, Ji, Jj = build(R, t, s)
        w = p.weight * p.edge_valid.astype(dtype)
        g, H = normal_equations(r, Ji, Jj, w, p.edge_i, p.edge_j, K)
        d = damped_step(H, g, lam, free)

        dR, dt, ds = jax.vmap(lie.sim3_exp)(d)
        Rn, tn, sn = jax.vmap(lie.sim3_compose)(dR, dt, ds, R, t, s)
        Rn = jax.vmap(lie.normalize_rotation)(Rn)

        def cost(R, t, s):
            r2, _, _ = build(R, t, s)
            return jnp.sum(
                jnp.where(p.edge_valid, jnp.sum(r2 * r2, -1) * p.weight, 0.0)
            )

        c_new = cost(Rn, tn, sn)
        c_old = cost(R, t, s)
        better = c_new < c_old
        R = jnp.where(better, Rn, R)
        t = jnp.where(better, tn, t)
        s = jnp.where(better, sn, s)
        lam = jnp.where(better, lam * 0.5, lam * 4.0)
        return (R, t, s, lam), c_new

    state = (p.R, p.t, p.s, jnp.asarray(1e-4, dtype))
    state, costs = jax.lax.scan(lm_step, state, None, length=n_iters)
    R, t, s, _ = state
    return R, t, s, costs[-1]
