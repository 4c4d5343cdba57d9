"""Distributed bundle adjustment over a device mesh.

The replacement for what the reference cannot do at all:
global BA sharded across chips (SURVEY.md §5.7-5.8 and the BASELINE
north star).  Two schemes:

- ``optimize_sharded``: observations sharded, poses+points replicated,
  joint-PCG psum-reduced per CG iteration.  Simple, but the psum
  operands include the (P,3) landmark vectors, so collective traffic
  grows with map size.

- ``optimize_schur_sharded`` (the engine's GBA path): LANDMARKS and
  their observations are sharded over the mesh; each device eliminates
  its own landmark blocks with batched 3x3 inverses (the Schur trade of
  reference Optimizer.cc:5026 Marginalize, re-expressed as batched
  dense algebra) and only the REDUCED camera system — (K,6) vectors and
  (K,6,6) block diagonals — ever rides the psum.  Per-device memory
  scales ~1/d in points and observations; per-CG-iteration collective
  traffic is independent of map size.

The LM structure matches solver/ba.py — same fixed point — so the
single-chip and multi-chip paths are interchangeable.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..core import lie
from ..solver.ba import (BAProblem, BAResult, _obs_residual_jac,
                         _obs_residual_only)
from ..solver.robust import DELTA_MONO, CHI2_MONO, huber_weight


def optimize_sharded(
    mesh: Mesh,
    p: BAProblem,
    project,
    n_iters: int = 10,
    cg_iters: int = 40,
    use_huber: bool = True,
    axis: str = "shard",
) -> BAResult:
    """LM-PCG bundle adjustment with observations sharded over `mesh`.

    The observation arrays of `p` must have length divisible by the mesh
    size (pad with obs_valid=False).  Returns the same BAResult as the
    single-device solver.
    """
    n_dev = mesh.shape[axis]
    O = p.obs_kf.shape[0]
    assert O % n_dev == 0, (O, n_dev)

    run = _make_run(mesh, project, n_iters, cg_iters, use_huber, axis)

    obs_sharding = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())

    p = BAProblem(
        R=jax.device_put(p.R, rep),
        t=jax.device_put(p.t, rep),
        points=jax.device_put(p.points, rep),
        obs_kf=jax.device_put(p.obs_kf, obs_sharding),
        obs_mp=jax.device_put(p.obs_mp, obs_sharding),
        obs_uv=jax.device_put(p.obs_uv, obs_sharding),
        inv_sigma2=jax.device_put(p.inv_sigma2, obs_sharding),
        obs_valid=jax.device_put(p.obs_valid, obs_sharding),
        fixed_kf=jax.device_put(p.fixed_kf, rep),
        fixed_mp=jax.device_put(p.fixed_mp, rep),
    )

    R, t, points, inliers, cost = run(
        p.R, p.t, p.points, p.obs_kf, p.obs_mp, p.obs_uv, p.inv_sigma2,
        p.obs_valid, p.fixed_kf, p.fixed_mp,
    )
    return BAResult(R=R, t=t, points=points, inliers=inliers, cost=cost)


@functools.lru_cache(maxsize=64)
def _make_run(mesh, project, n_iters, cg_iters, use_huber, axis):
    """Build + jit the sharded LM program ONCE per (mesh, config): a
    bare shard_map call re-traces on every invocation (~18 s of tracing
    per BA call for the scan-of-jacfwd body), so the jitted callable is
    cached here and jit's shape cache handles the rest."""

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(), P(), P(),                      # R, t, points
            P(axis), P(axis), P(axis), P(axis), P(axis),  # obs shards
            P(), P(),                            # fixed masks
        ),
        out_specs=(P(), P(), P(), P(axis), P()),
        check_vma=False,
    )
    def run(R, t, points, obs_kf, obs_mp, obs_uv, inv_sigma2, obs_valid,
            fixed_kf, fixed_mp):
        K = R.shape[0]
        Pn = points.shape[0]
        dtype = points.dtype
        free_kf = (~fixed_kf).astype(dtype)[:, None]
        free_mp = (~fixed_mp).astype(dtype)[:, None]
        shard = BAProblem(
            R=R, t=t, points=points, obs_kf=obs_kf, obs_mp=obs_mp,
            obs_uv=obs_uv, inv_sigma2=inv_sigma2, obs_valid=obs_valid,
            fixed_kf=fixed_kf, fixed_mp=fixed_mp,
        )

        def build(R, t, points):
            r, Jp, Jl = _obs_residual_jac(R, t, points, shard, project)
            chi2 = jnp.sum(r * r, -1) * inv_sigma2
            w = huber_weight(chi2, DELTA_MONO) if use_huber else jnp.ones_like(chi2)
            w = w * inv_sigma2 * obs_valid.astype(dtype)
            return r, Jp, Jl, w

        def lm_step(state, _):
            R, t, points, lam = state
            r, Jp, Jl, w = build(R, t, points)
            Jpw = Jp * w[:, None, None]
            Jlw = Jl * w[:, None, None]

            # partial accumulations + psum over the mesh
            g_pose = jax.lax.psum(
                jnp.zeros((K, 6), dtype).at[obs_kf].add(
                    jnp.einsum("oif,oi->of", Jpw, r)
                ),
                axis,
            ) * free_kf
            g_point = jax.lax.psum(
                jnp.zeros((Pn, 3), dtype).at[obs_mp].add(
                    jnp.einsum("oif,oi->of", Jlw, r)
                ),
                axis,
            ) * free_mp
            Hpp = jax.lax.psum(
                jnp.zeros((K, 6, 6), dtype).at[obs_kf].add(
                    jnp.einsum("oif,oig->ofg", Jpw, Jp)
                ),
                axis,
            )
            Hll = jax.lax.psum(
                jnp.zeros((Pn, 3, 3), dtype).at[obs_mp].add(
                    jnp.einsum("oif,oig->ofg", Jlw, Jl)
                ),
                axis,
            )
            Mp = jnp.linalg.inv(Hpp + lam * jnp.eye(6, dtype=dtype)[None])
            Ml = jnp.linalg.inv(Hll + lam * jnp.eye(3, dtype=dtype)[None])

            def hv(vp, vl):
                vp = vp * free_kf
                vl = vl * free_mp
                u = jnp.einsum("oif,of->oi", Jp, vp[obs_kf]) + jnp.einsum(
                    "oif,of->oi", Jl, vl[obs_mp]
                )
                uw = u * w[:, None]
                hp = jax.lax.psum(
                    jnp.zeros((K, 6), dtype).at[obs_kf].add(
                        jnp.einsum("oif,oi->of", Jp, uw)
                    ),
                    axis,
                ) * free_kf
                hl = jax.lax.psum(
                    jnp.zeros((Pn, 3), dtype).at[obs_mp].add(
                        jnp.einsum("oif,oi->of", Jl, uw)
                    ),
                    axis,
                ) * free_mp
                return hp + lam * vp, hl + lam * vl

            def precond(vp, vl):
                return (
                    jnp.einsum("kfg,kg->kf", Mp, vp) * free_kf,
                    jnp.einsum("pfg,pg->pf", Ml, vl) * free_mp,
                )

            def dot(a, b):
                return jnp.sum(a[0] * b[0]) + jnp.sum(a[1] * b[1])

            x = (jnp.zeros_like(g_pose), jnp.zeros_like(g_point))
            rr = (g_pose, g_point)
            z = precond(*rr)
            pdir = z
            rz = dot(rr, z)

            def cg_body(carry, _):
                x, rr, pdir, rz = carry
                Ap = hv(*pdir)
                alpha = rz / jnp.maximum(dot(pdir, Ap), 1e-20)
                x = (x[0] + alpha * pdir[0], x[1] + alpha * pdir[1])
                rr = (rr[0] - alpha * Ap[0], rr[1] - alpha * Ap[1])
                z = precond(*rr)
                rz_new = dot(rr, z)
                beta = rz_new / jnp.maximum(rz, 1e-20)
                pdir = (z[0] + beta * pdir[0], z[1] + beta * pdir[1])
                return (x, rr, pdir, rz_new), None

            (x, _, _, _), _ = jax.lax.scan(
                cg_body, (x, rr, pdir, rz), None, length=cg_iters
            )
            dp, dl = -x[0], -x[1]

            dR, dt = jax.vmap(lie.se3_exp)(dp)
            Rn = R @ dR
            tn = jnp.einsum("kij,kj->ki", R, dt) + t
            pn = points + dl

            def cost(Rc, tc, pc):
                r2 = _obs_residual_only(Rc, tc, pc, shard, project)
                c2 = jnp.sum(r2 * r2, -1) * inv_sigma2
                if use_huber:
                    d2 = DELTA_MONO * DELTA_MONO
                    rho = jnp.where(
                        c2 <= d2, c2, 2.0 * DELTA_MONO * jnp.sqrt(c2) - d2
                    )
                else:
                    rho = c2
                return jax.lax.psum(
                    jnp.sum(jnp.where(obs_valid, rho, 0.0)), axis
                )

            c_new = cost(Rn, tn, pn)
            c_old = cost(R, t, points)
            better = c_new < c_old
            R = jnp.where(better, Rn, R)
            t = jnp.where(better, tn, t)
            points = jnp.where(better, pn, points)
            lam = jnp.where(better, lam * 0.5, lam * 4.0)
            return (R, t, points, lam), None

        lam0 = jnp.asarray(1e-4, dtype)
        state, _ = jax.lax.scan(
            lm_step, (R, t, points, lam0), None, length=n_iters
        )
        R, t, points, _ = state
        R = lie.orthonormalize(R)  # keep keyframe rotations on SO(3)
        r = _obs_residual_only(R, t, points, shard, project)
        chi2 = jnp.sum(r * r, -1) * inv_sigma2
        inliers = obs_valid & (chi2 <= CHI2_MONO)
        cost = jax.lax.psum(jnp.sum(jnp.where(obs_valid, chi2, 0.0)), axis)
        return R, t, points, inliers, cost

    return run


# ---------------------------------------------------------------------------
# Landmark-sharded Schur-complement BA (the engine's distributed GBA)
# ---------------------------------------------------------------------------


def optimize_schur_sharded(
    mesh: Mesh,
    p: BAProblem,
    project,
    n_iters: int = 10,
    cg_iters: int = 20,
    use_huber: bool = True,
    axis: str = "shard",
) -> BAResult:
    """LM bundle adjustment with landmarks + observations sharded.

    Requirements (the host-side builder in dist/global_ba.py arranges
    both):
    - p.points / p.fixed_mp lengths divisible by the mesh size, with
      each observation's point living on the observation's shard;
    - p.obs_* lengths divisible by the mesh size, with obs_mp indexing
      points GLOBALLY (the shard offset is subtracted device-side).

    Returns the replicated poses and the globally re-assembled points/
    inlier mask (same BAResult as the single-device solver).
    """
    n_dev = mesh.shape[axis]
    O = p.obs_kf.shape[0]
    Pn = p.points.shape[0]
    assert O % n_dev == 0 and Pn % n_dev == 0, (O, Pn, n_dev)

    run = _make_schur_run(mesh, project, n_iters, cg_iters, use_huber, axis)

    shd = NamedSharding(mesh, P(axis))
    rep = NamedSharding(mesh, P())
    args = (
        jax.device_put(p.R, rep), jax.device_put(p.t, rep),
        jax.device_put(p.points, shd),
        jax.device_put(p.obs_kf, shd), jax.device_put(p.obs_mp, shd),
        jax.device_put(p.obs_uv, shd), jax.device_put(p.inv_sigma2, shd),
        jax.device_put(p.obs_valid, shd),
        jax.device_put(p.fixed_kf, rep), jax.device_put(p.fixed_mp, shd),
    )
    R, t, points, inliers, cost = run(*args)
    return BAResult(R=R, t=t, points=points, inliers=inliers, cost=cost)


@functools.lru_cache(maxsize=64)
def _make_schur_run(mesh, project, n_iters, cg_iters, use_huber, axis):
    """Build + jit the landmark-sharded Schur LM program once per
    (mesh, config) — see _make_run for why the cache matters."""
    n_dev = mesh.shape[axis]

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            P(), P(),                    # R, t (replicated)
            P(axis),                     # points (sharded)
            P(axis), P(axis), P(axis), P(axis), P(axis),   # obs shards
            P(), P(axis),                # fixed_kf, fixed_mp
        ),
        out_specs=(P(), P(), P(axis), P(axis), P()),
        check_vma=False,
    )
    def run(R, t, points, obs_kf, obs_mp, obs_uv, inv_sigma2, obs_valid,
            fixed_kf, fixed_mp):
        K = R.shape[0]
        Ps = points.shape[0]            # LOCAL landmark count
        dtype = points.dtype
        free_kf = (~fixed_kf).astype(dtype)[:, None]
        free_mp = (~fixed_mp).astype(dtype)[:, None]
        # global -> local landmark ids for this shard
        shard_id = jax.lax.axis_index(axis)
        obs_mp_l = obs_mp - shard_id * Ps

        def build(R, t, pts):
            shard = BAProblem(
                R=R, t=t, points=pts, obs_kf=obs_kf, obs_mp=obs_mp_l,
                obs_uv=obs_uv, inv_sigma2=inv_sigma2, obs_valid=obs_valid,
                fixed_kf=fixed_kf, fixed_mp=fixed_mp,
            )
            r, Jp, Jl = _obs_residual_jac(R, t, pts, shard, project)
            chi2 = jnp.sum(r * r, -1) * inv_sigma2
            w = huber_weight(chi2, DELTA_MONO) if use_huber \
                else jnp.ones_like(chi2)
            w = w * inv_sigma2 * obs_valid.astype(dtype)
            return r, Jp, Jl, w

        def lm_step(state, _):
            R, t, points, lam = state
            r, Jp, Jl, w = build(R, t, points)
            Jpw = Jp * w[:, None, None]
            Jlw = Jl * w[:, None, None]

            # right-hand sides b = J^T W r
            bp = jax.lax.psum(
                jnp.zeros((K, 6), dtype).at[obs_kf].add(
                    jnp.einsum("oif,oi->of", Jpw, r)
                ), axis,
            ) * free_kf
            bl = jnp.zeros((Ps, 3), dtype).at[obs_mp_l].add(
                jnp.einsum("oif,oi->of", Jlw, r)
            ) * free_mp                                     # local

            # landmark elimination: batched 3x3 inverses of the damped
            # local Hll blocks (reference Marginalize semantics,
            # Optimizer.cc:5026, block-diagonal case)
            Hll = jnp.zeros((Ps, 3, 3), dtype).at[obs_mp_l].add(
                jnp.einsum("oif,oig->ofg", Jlw, Jl)
            )
            Ml = jnp.linalg.inv(Hll + lam * jnp.eye(3, dtype=dtype)[None])

            # camera block diagonal (psum once per LM iteration)
            Hpp = jax.lax.psum(
                jnp.zeros((K, 6, 6), dtype).at[obs_kf].add(
                    jnp.einsum("oif,oig->ofg", Jpw, Jp)
                ), axis,
            )
            Mp = jnp.linalg.inv(Hpp + lam * jnp.eye(6, dtype=dtype)[None])

            def wt_v(v):
                """W^T v: (K,6) pose vector -> local (Ps,3) landmark."""
                u = jnp.einsum("oif,of->oi", Jp, v[obs_kf]) * w[:, None]
                return jnp.zeros((Ps, 3), dtype).at[obs_mp_l].add(
                    jnp.einsum("oif,oi->of", Jl, u)
                ) * free_mp

            def w_y(y):
                """W y: local (Ps,3) landmark -> psum-reduced (K,6)."""
                u = jnp.einsum("oif,of->oi", Jl, y[obs_mp_l]) * w[:, None]
                return jax.lax.psum(
                    jnp.zeros((K, 6), dtype).at[obs_kf].add(
                        jnp.einsum("oif,oi->of", Jp, u)
                    ), axis,
                ) * free_kf

            def schur_mv(v):
                """(Hpp + lam - W (Hll+lam)^-1 W^T) v, psum-reduced."""
                v = v * free_kf
                hv = jnp.einsum("kfg,kg->kf", Hpp, v) * free_kf
                y = jnp.einsum("pfg,pg->pf", Ml, wt_v(v))
                return hv + lam * v - w_y(y)

            # reduced RHS: bp - W Hll^-1 bl
            b_red = bp - w_y(jnp.einsum("pfg,pg->pf", Ml, bl))

            # PCG on the reduced camera system (collective traffic per
            # iteration: one (K,6) psum inside schur_mv)
            def precond(v):
                return jnp.einsum("kfg,kg->kf", Mp, v) * free_kf

            x = jnp.zeros((K, 6), dtype)
            rr = b_red
            z = precond(rr)
            pdir = z
            rz = jnp.sum(rr * z)

            def cg_body(carry, _):
                x, rr, pdir, rz = carry
                Ap = schur_mv(pdir)
                alpha = rz / jnp.maximum(jnp.sum(pdir * Ap), 1e-20)
                x = x + alpha * pdir
                rr = rr - alpha * Ap
                z = precond(rr)
                rz_new = jnp.sum(rr * z)
                beta = rz_new / jnp.maximum(rz, 1e-20)
                pdir = z + beta * pdir
                return (x, rr, pdir, rz_new), None

            (x, _, _, _), _ = jax.lax.scan(
                cg_body, (x, rr, pdir, rz), None, length=cg_iters
            )
            dp = -x
            # back-substitute the local landmarks:
            # dl = -(Hll+lam)^-1 (bl - W^T dp)   [dp already negated]
            dl = -jnp.einsum("pfg,pg->pf", Ml, bl - wt_v(-dp)) * free_mp

            dR, dt = jax.vmap(lie.se3_exp)(dp * free_kf)
            Rn = R @ dR
            tn = jnp.einsum("kij,kj->ki", R, dt) + t
            pn = points + dl

            def cost(Rc, tc, pc):
                shard = BAProblem(
                    R=Rc, t=tc, points=pc, obs_kf=obs_kf, obs_mp=obs_mp_l,
                    obs_uv=obs_uv, inv_sigma2=inv_sigma2,
                    obs_valid=obs_valid, fixed_kf=fixed_kf,
                    fixed_mp=fixed_mp,
                )
                r2 = _obs_residual_only(Rc, tc, pc, shard, project)
                c2 = jnp.sum(r2 * r2, -1) * inv_sigma2
                if use_huber:
                    d2 = DELTA_MONO * DELTA_MONO
                    rho = jnp.where(
                        c2 <= d2, c2, 2.0 * DELTA_MONO * jnp.sqrt(c2) - d2
                    )
                else:
                    rho = c2
                return jax.lax.psum(
                    jnp.sum(jnp.where(obs_valid, rho, 0.0)), axis
                )

            c_new = cost(Rn, tn, pn)
            c_old = cost(R, t, points)
            better = c_new < c_old
            R = jnp.where(better, Rn, R)
            t = jnp.where(better, tn, t)
            points = jnp.where(better, pn, points)
            lam = jnp.where(better, lam * 0.5, lam * 4.0)
            return (R, t, points, lam), None

        lam0 = jnp.asarray(1e-4, dtype)
        state, _ = jax.lax.scan(
            lm_step, (R, t, points, lam0), None, length=n_iters
        )
        R, t, points, _ = state
        R = lie.orthonormalize(R)  # keep keyframe rotations on SO(3)
        shard = BAProblem(
            R=R, t=t, points=points, obs_kf=obs_kf, obs_mp=obs_mp_l,
            obs_uv=obs_uv, inv_sigma2=inv_sigma2, obs_valid=obs_valid,
            fixed_kf=fixed_kf, fixed_mp=fixed_mp,
        )
        r = _obs_residual_only(R, t, points, shard, project)
        chi2 = jnp.sum(r * r, -1) * inv_sigma2
        inliers = obs_valid & (chi2 <= CHI2_MONO)
        cost = jax.lax.psum(jnp.sum(jnp.where(obs_valid, chi2, 0.0)), axis)
        return R, t, points, inliers, cost

    return run


def relayout_for_schur(p: BAProblem, n_dev: int, block: int = 128) -> BAProblem:
    """Re-arrange an arbitrary BAProblem into the landmark-sharded layout
    optimize_schur_sharded requires: points padded to a multiple of
    n_dev, observations grouped by their point's shard with per-shard
    padding (obs_valid=False), obs_mp global.  Drops pre-existing
    padding observations."""
    import numpy as np

    obs_kf = np.asarray(p.obs_kf)
    obs_mp = np.asarray(p.obs_mp)
    obs_uv = np.asarray(p.obs_uv)
    osig = np.asarray(p.inv_sigma2)
    oval = np.asarray(p.obs_valid)
    Pn = p.points.shape[0]
    Ps = -(-Pn // n_dev)
    P_pad = Ps * n_dev
    pts = np.zeros((P_pad, 3), np.float32)
    pts[:, 2] = 1.0
    pts[:Pn] = np.asarray(p.points)
    fixed_mp = np.ones(P_pad, bool)
    fixed_mp[:Pn] = np.asarray(p.fixed_mp)

    keep = oval
    obs_kf, obs_mp = obs_kf[keep], obs_mp[keep]
    obs_uv, osig = obs_uv[keep], osig[keep]
    shard_of = obs_mp // Ps
    order = np.argsort(shard_of, kind="stable")
    obs_kf, obs_mp = obs_kf[order], obs_mp[order]
    obs_uv, osig, shard_of = obs_uv[order], osig[order], shard_of[order]
    counts = np.bincount(shard_of, minlength=n_dev)
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
        okf[dst:dst + n] = obs_kf[start:start + n]
        omp[dst:dst + n] = obs_mp[start:start + n]
        ouv[dst:dst + n] = obs_uv[start:start + n]
        osg[dst:dst + n] = osig[start:start + n]
        ovl[dst:dst + n] = True
        omp[dst + n:dst + Os] = s * Ps
        start += n
    return BAProblem(
        R=p.R, t=p.t, points=jnp.asarray(pts),
        obs_kf=jnp.asarray(okf), obs_mp=jnp.asarray(omp),
        obs_uv=jnp.asarray(ouv), inv_sigma2=jnp.asarray(osg),
        obs_valid=jnp.asarray(ovl), fixed_kf=p.fixed_kf,
        fixed_mp=jnp.asarray(fixed_mp),
    )


# --------------------------------------------------------------------------
# Sharded visual-inertial global BA (FullInertialBA over the mesh)
# --------------------------------------------------------------------------

from ..solver.inertial import (  # noqa: E402
    GRAVITY, VIBAProblem, VIBAResult, _apply_delta, _edge_residual_jac,
    _vis_residual_jac,
)


def relayout_point_sharded(obs_kf, obs_mp, obs_uv, obs_sig, obs_val,
                           P: int, n_dev: int):
    """Group observations by their point's shard and pad each group to a
    common length (the layout optimize_vi_sharded / the Schur runner
    expect).  P must be divisible by n_dev.  Returns the re-laid-out
    (obs_kf, obs_mp, obs_uv, obs_sig, obs_val) numpy arrays."""
    import numpy as np

    Ps = P // n_dev
    live = np.where(obs_val)[0]
    shard_of = obs_mp[live] // Ps
    order = np.argsort(shard_of, kind="stable")
    live = live[order]
    counts = np.bincount(shard_of[order], minlength=n_dev)
    Os = int(np.ceil(max(int(counts.max()), 1) / 128) * 128)
    O_pad = Os * n_dev
    okf = np.zeros(O_pad, np.int32)
    omp = np.zeros(O_pad, np.int32)
    ouv = np.zeros((O_pad, 2), np.float32)
    osig = np.ones(O_pad, np.float32)
    oval = np.zeros(O_pad, bool)
    start = 0
    for s in range(n_dev):
        n = int(counts[s])
        dst = s * Os
        sel = live[start:start + n]
        okf[dst:dst + n] = obs_kf[sel]
        omp[dst:dst + n] = obs_mp[sel]
        ouv[dst:dst + n] = obs_uv[sel]
        osig[dst:dst + n] = obs_sig[sel]
        oval[dst:dst + n] = True
        omp[dst + n:dst + Os] = s * Ps   # padding addresses this shard
        start += n
    return okf, omp, ouv, osig, oval


def optimize_vi_sharded(
    mesh: Mesh,
    p: VIBAProblem,
    project,
    n_iters: int = 8,
    cg_iters: int = 40,
    use_huber: bool = True,
    axis: str = "shard",
) -> VIBAResult:
    """Landmark/observation-sharded FullInertialBA (reference
    Optimizer.cc:420, the post-loop inertial GBA): visual residuals are
    sharded over the mesh like optimize_schur_sharded, while the 15-dim
    body states and the O(K) inertial chain stay REPLICATED — the chain
    contributes identical terms on every device and is added after the
    psum, so per-CG-iteration traffic is the (K,15) state block only.
    Points must be evenly divisible over the mesh and observations
    grouped by their point's shard (relayout_point_sharded)."""
    n_dev = mesh.shape[axis]
    P = p.points.shape[0]
    O = p.obs_kf.shape[0]
    assert P % n_dev == 0 and O % n_dev == 0, (P, O, n_dev)

    run = _make_vi_run(mesh, project, n_iters, cg_iters, use_huber, axis)

    from jax.sharding import PartitionSpec as PS
    eshard = NamedSharding(mesh, PS(axis))
    rep = NamedSharding(mesh, PS())
    put_e = lambda a: jax.device_put(a, eshard)
    put_r = lambda a: jax.device_put(a, rep)

    chain = jax.tree_util.tree_map(put_r, p.chain)
    out = run(
        put_r(p.Rwb), put_r(p.twb), put_r(p.v), put_r(p.bg), put_r(p.ba),
        put_e(p.points),
        put_e(p.obs_kf), put_e(p.obs_mp), put_e(p.obs_uv),
        put_e(p.inv_sigma2), put_e(p.obs_valid),
        chain,
        put_r(p.fixed_kf), put_e(p.fixed_mp),
        put_r(p.Rcb), put_r(p.tcb),
        jnp.float32(p.prior_g), jnp.float32(p.prior_a),
    )
    Rwb, twb, v, bg, ba, points, inliers, cost = out
    return VIBAResult(Rwb=Rwb, twb=twb, v=v, bg=bg, ba=ba,
                      points=points, inliers=inliers, cost=cost)


@functools.lru_cache(maxsize=64)
def _make_vi_run(mesh, project, n_iters, cg_iters, use_huber, axis):
    """Build + jit the sharded VI-BA program once per (mesh, config)."""
    from jax.sharding import PartitionSpec as PS
    from ..solver.robust import CHI2_MONO, DELTA_MONO, huber_weight

    @jax.jit
    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(
            PS(), PS(), PS(), PS(), PS(),       # Rwb twb v bg ba
            PS(axis),                           # points
            PS(axis), PS(axis), PS(axis), PS(axis), PS(axis),  # obs
            PS(),                               # chain (replicated pytree)
            PS(), PS(axis),                     # fixed_kf, fixed_mp
            PS(), PS(),                         # Rcb tcb
            PS(), PS(),                         # priors
        ),
        out_specs=(PS(), PS(), PS(), PS(), PS(), PS(axis), PS(axis), PS()),
        check_vma=False,
    )
    def run(Rwb0, twb0, v0, bg0, ba0, points0,
            obs_kf, obs_mp, obs_uv, inv_sigma2, obs_valid,
            chain, fixed_kf, fixed_mp, Rcb, tcb, prior_g, prior_a):
        K = Rwb0.shape[0]
        Ps_ = points0.shape[0]
        dtype = points0.dtype
        gvec = jnp.asarray([0.0, 0.0, -GRAVITY], dtype)
        free_kf = (~fixed_kf).astype(dtype)[:, None]
        free_mp = (~fixed_mp).astype(dtype)[:, None]
        shard_id = jax.lax.axis_index(axis)
        obs_mp_l = obs_mp - shard_id * Ps_

        prior_diag = jnp.zeros((K, 15), dtype)
        prior_diag = prior_diag.at[0, 9:12].set(prior_g)
        prior_diag = prior_diag.at[0, 12:15].set(prior_a)

        def local_prob(Rwb, twb, v, bg, ba, points):
            return VIBAProblem(
                Rwb=Rwb, twb=twb, v=v, bg=bg, ba=ba, points=points,
                obs_kf=obs_kf, obs_mp=obs_mp_l, obs_uv=obs_uv,
                inv_sigma2=inv_sigma2, obs_valid=obs_valid, chain=chain,
                fixed_kf=fixed_kf, fixed_mp=fixed_mp, Rcb=Rcb, tcb=tcb,
            )

        def lm_step(state, _):
            Rwb, twb, v, bg, ba, points, lam, _c = state
            lp = local_prob(Rwb, twb, v, bg, ba, points)
            r, Jp6, Jl = _vis_residual_jac(Rwb, twb, points, lp, project)
            chi2 = jnp.sum(r * r, -1) * inv_sigma2
            w = huber_weight(chi2, DELTA_MONO) if use_huber \
                else jnp.ones_like(chi2)
            w = w * inv_sigma2 * obs_valid.astype(dtype)
            (re, Ji, Jj), idx_i, idx_j = _edge_residual_jac(
                Rwb, twb, v, bg, ba, lp, gvec
            )
            Jpw6 = Jp6 * w[:, None, None]
            Jlw = Jl * w[:, None, None]

            # gradient: visual part psum'd; chain/prior added once after
            g_vis = jax.lax.psum(
                jnp.zeros((K, 6), dtype).at[obs_kf].add(
                    jnp.einsum("oif,oi->of", Jpw6, r)
                ), axis,
            )
            g_state = jnp.zeros((K, 15), dtype).at[:, :6].add(g_vis)
            g_state = g_state.at[idx_i].add(
                jnp.einsum("eif,ei->ef", Ji, re))
            g_state = g_state.at[idx_j].add(
                jnp.einsum("eif,ei->ef", Jj, re))
            g_state = g_state * free_kf
            g_point = jnp.zeros((Ps_, 3), dtype).at[obs_mp_l].add(
                jnp.einsum("oif,oi->of", Jlw, r)
            ) * free_mp

            Hpp6 = jax.lax.psum(
                jnp.zeros((K, 6, 6), dtype).at[obs_kf].add(
                    jnp.einsum("oif,oig->ofg", Jpw6, Jp6)
                ), axis,
            )
            Hpp = jnp.zeros((K, 15, 15), dtype).at[:, :6, :6].add(Hpp6)
            Hpp = Hpp.at[idx_i].add(jnp.einsum("eif,eig->efg", Ji, Ji))
            Hpp = Hpp.at[idx_j].add(jnp.einsum("eif,eig->efg", Jj, Jj))
            Hpp = Hpp + jnp.vectorize(
                jnp.diag, signature="(n)->(n,n)")(prior_diag)
            Hll = jnp.zeros((Ps_, 3, 3), dtype).at[obs_mp_l].add(
                jnp.einsum("oif,oig->ofg", Jlw, Jl)
            )
            lamI15 = lam * jnp.eye(15, dtype=dtype)
            lamI3 = lam * jnp.eye(3, dtype=dtype)
            Mp = jnp.linalg.inv(Hpp + lamI15[None])
            Ml = jnp.linalg.inv(Hll + lamI3[None])

            def hv(vp, vl):
                vp = vp * free_kf
                vl = vl * free_mp
                u = jnp.einsum("oif,of->oi", Jp6, vp[obs_kf, :6]) + \
                    jnp.einsum("oif,of->oi", Jl, vl[obs_mp_l])
                uw = u * w[:, None]
                hp_vis = jax.lax.psum(
                    jnp.zeros((K, 6), dtype).at[obs_kf].add(
                        jnp.einsum("oif,oi->of", Jp6, uw)
                    ), axis,
                )
                hp = jnp.zeros((K, 15), dtype).at[:, :6].add(hp_vis)
                ue = jnp.einsum("eif,ef->ei", Ji, vp[idx_i]) + \
                    jnp.einsum("eif,ef->ei", Jj, vp[idx_j])
                hp = hp.at[idx_i].add(jnp.einsum("eif,ei->ef", Ji, ue))
                hp = hp.at[idx_j].add(jnp.einsum("eif,ei->ef", Jj, ue))
                hp = (hp + prior_diag * vp) * free_kf
                hl = jnp.zeros((Ps_, 3), dtype).at[obs_mp_l].add(
                    jnp.einsum("oif,oi->of", Jl, uw)
                ) * free_mp
                return hp + lam * vp, hl + lam * vl

            def precond(vp, vl):
                return (
                    jnp.einsum("kfg,kg->kf", Mp, vp) * free_kf,
                    jnp.einsum("pfg,pg->pf", Ml, vl) * free_mp,
                )

            def dot(a, b):
                # state part replicated (no psum); landmark part sharded
                return jnp.sum(a[0] * b[0]) + jax.lax.psum(
                    jnp.sum(a[1] * b[1]), axis)

            bp, bl = g_state, g_point
            x = (jnp.zeros_like(bp), jnp.zeros_like(bl))
            rr = (bp, bl)
            z = precond(*rr)
            pdir = z
            rz = dot(rr, z)

            def cg_body(carry, _):
                x, rr, pdir, rz = carry
                Ap = hv(*pdir)
                alpha = rz / jnp.maximum(dot(pdir, Ap), 1e-20)
                x = (x[0] + alpha * pdir[0], x[1] + alpha * pdir[1])
                rr = (rr[0] - alpha * Ap[0], rr[1] - alpha * Ap[1])
                z = precond(*rr)
                rz2 = dot(rr, z)
                beta = rz2 / jnp.maximum(rz, 1e-20)
                pdir = (z[0] + beta * pdir[0], z[1] + beta * pdir[1])
                return (x, rr, pdir, rz2), None

            (x, _, _, _), _ = jax.lax.scan(
                cg_body, (x, rr, pdir, rz), None, length=cg_iters
            )
            dp = -x[0] * free_kf
            dl = -x[1] * free_mp

            Rn, tn, vn, bgn, ban = jax.vmap(_apply_delta)(
                Rwb, twb, v, bg, ba, dp
            )
            pn = points + dl

            def total_cost(Rc, tc, vc, bgc, bac, pc):
                lp2 = local_prob(Rc, tc, vc, bgc, bac, pc)
                rr2, _, _ = _vis_residual_jac(Rc, tc, pc, lp2, project)
                c2 = jnp.sum(rr2 * rr2, -1) * inv_sigma2
                if use_huber:
                    d2 = DELTA_MONO * DELTA_MONO
                    rho = jnp.where(
                        c2 <= d2, c2, 2.0 * DELTA_MONO * jnp.sqrt(c2) - d2
                    )
                else:
                    rho = c2
                cvis = jax.lax.psum(
                    jnp.sum(jnp.where(obs_valid, rho, 0.0)), axis)
                (re2, _, _), _, _ = _edge_residual_jac(
                    Rc, tc, vc, bgc, bac, lp2, gvec)
                return cvis + jnp.sum(re2 * re2)

            c_new = total_cost(Rn, tn, vn, bgn, ban, pn)
            c_old = total_cost(Rwb, twb, v, bg, ba, points)
            better = c_new < c_old
            pick = lambda a, b: jnp.where(better, a, b)
            return (
                pick(Rn, Rwb), pick(tn, twb), pick(vn, v),
                pick(bgn, bg), pick(ban, ba), pick(pn, points),
                jnp.where(better, lam * 0.5, lam * 4.0),
                jnp.minimum(c_new, c_old),
            ), None

        lam0 = jnp.asarray(1e-4, dtype)
        state = (Rwb0, twb0, v0, bg0, ba0, points0, lam0,
                 jnp.asarray(jnp.inf, dtype))
        state, _ = jax.lax.scan(lm_step, state, None, length=n_iters)
        Rwb, twb, v, bg, ba, points, _, cost = state
        Rwb = lie.orthonormalize(Rwb)

        lp = local_prob(Rwb, twb, v, bg, ba, points)
        r, _, _ = _vis_residual_jac(Rwb, twb, points, lp, project)
        chi2 = jnp.sum(r * r, -1) * inv_sigma2
        inliers = obs_valid & (chi2 <= CHI2_MONO)
        return Rwb, twb, v, bg, ba, points, inliers, cost

    return run
