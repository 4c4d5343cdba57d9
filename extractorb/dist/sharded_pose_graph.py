"""Distributed Sim3 pose-graph (essential graph) optimisation.

The multi-chip analog of OptimizeEssentialGraph (reference
src/Optimizer.cc:2303; SURVEY.md §5.7: "pose-graph optimization
similarly shards edges and psum-reduces the Gauss-Newton system").

Edges are the dominant axis (spanning tree + covisibility + loop
edges ~ O(K * covis)); they shard over the mesh while the K Sim3
vertices stay replicated.  Every device builds residuals/Jacobians for
its edge shard; the gradient and the dense normal equations are
psum-reduced and every device takes the same Cholesky step — identical
fixed point to solver.pose_graph.optimize_pose_graph.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import lie
from ..solver.pose_graph import (PoseGraphProblem, _edge_residual, damped_step,
                                 normal_equations, vertex_mask)


def optimize_sharded_pose_graph(
    mesh: Mesh,
    p: PoseGraphProblem,
    n_iters: int = 15,
    axis: str = "shard",
    fix_scale: bool = False,
):
    """Edge-sharded pose-graph LM.  Edge arrays must have length
    divisible by the mesh size (pad with edge_valid=False).  Returns
    (R, t, s, final_cost) like the single-device solver; fix_scale
    freezes the per-vertex scale coordinate (the reference's 6-DoF
    stereo/RGBD essential graph, Optimizer.cc:2621)."""
    n_dev = mesh.shape[axis]
    E = p.edge_i.shape[0]
    assert E % n_dev == 0, (E, n_dev)

    run = _make_run(mesh, n_iters, axis, fix_scale)

    eshard = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    p = PoseGraphProblem(
        R=jax.device_put(p.R, rep), t=jax.device_put(p.t, rep),
        s=jax.device_put(p.s, rep),
        edge_i=jax.device_put(p.edge_i, eshard),
        edge_j=jax.device_put(p.edge_j, eshard),
        m_R=jax.device_put(p.m_R, eshard),
        m_t=jax.device_put(p.m_t, eshard),
        m_s=jax.device_put(p.m_s, eshard),
        weight=jax.device_put(p.weight, eshard),
        edge_valid=jax.device_put(p.edge_valid, eshard),
        fixed=jax.device_put(p.fixed, rep),
    )

    return run(
        p.R, p.t, p.s, p.edge_i, p.edge_j, p.m_R, p.m_t, p.m_s,
        p.weight, p.edge_valid, p.fixed,
    )


@functools.lru_cache(maxsize=64)
def _make_run(mesh, n_iters, axis, fix_scale=False):
    """Build + jit the sharded pose-graph program once per
    (mesh, config); bare shard_map calls re-trace every invocation."""

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(), P(), P(),                                   # R, t, s
            P(axis), P(axis), P(axis), P(axis), P(axis),     # edges
            P(axis), P(axis),                                # weight, valid
            P(),                                             # fixed
        ),
        out_specs=(P(), P(), P(), P()),
        check_vma=False,
    )
    def run(R0, t0, s0, edge_i, edge_j, m_R, m_t, m_s, weight, edge_valid,
            fixed):
        K = R0.shape[0]
        dtype = t0.dtype
        free = vertex_mask(fixed, fix_scale, dtype)
        zero7 = jnp.zeros(7, dtype)

        def build(R, t, s):
            Ri, ti, si = R[edge_i], t[edge_i], s[edge_i]
            Rj, tj, sj = R[edge_j], t[edge_j], s[edge_j]

            def per_edge(Ri, ti, si, Rj, tj, sj, mR, mt, ms):
                r = _edge_residual(Ri, ti, si, Rj, tj, sj, mR, mt, ms,
                                   zero7, zero7)
                Ji = jax.jacfwd(
                    lambda d: _edge_residual(Ri, ti, si, Rj, tj, sj,
                                             mR, mt, ms, d, zero7)
                )(zero7)
                Jj = jax.jacfwd(
                    lambda d: _edge_residual(Ri, ti, si, Rj, tj, sj,
                                             mR, mt, ms, zero7, d)
                )(zero7)
                return r, Ji, Jj

            return jax.vmap(per_edge)(Ri, ti, si, Rj, tj, sj, m_R, m_t, m_s)

        def lm_step(state, _):
            R, t, s, lam = state
            r, Ji, Jj = build(R, t, s)
            w = weight * edge_valid.astype(dtype)
            g, H = normal_equations(r, Ji, Jj, w, edge_i, edge_j, K)
            g, H = jax.lax.psum((g, H), axis)
            d = damped_step(H, g, lam, free)

            dR, dt, ds = jax.vmap(lie.sim3_exp)(d)
            Rn, tn, sn = jax.vmap(lie.sim3_compose)(dR, dt, ds, R, t, s)
            Rn = jax.vmap(lie.normalize_rotation)(Rn)

            def cost(R, t, s):
                r2, _, _ = build(R, t, s)
                return jax.lax.psum(
                    jnp.sum(
                        jnp.where(edge_valid,
                                  jnp.sum(r2 * r2, -1) * weight, 0.0)
                    ),
                    axis,
                )

            c_new = cost(Rn, tn, sn)
            c_old = cost(R, t, s)
            better = c_new < c_old
            R = jnp.where(better, Rn, R)
            t = jnp.where(better, tn, t)
            s = jnp.where(better, sn, s)
            lam = jnp.where(better, lam * 0.5, lam * 4.0)
            return (R, t, s, lam), c_new

        state = (R0, t0, s0, jnp.asarray(1e-4, dtype))
        state, costs = jax.lax.scan(lm_step, state, None, length=n_iters)
        R, t, s, _ = state
        return R, t, s, costs[-1]

    return run
