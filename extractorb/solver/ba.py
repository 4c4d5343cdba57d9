"""Bundle adjustment: the g2o replacement.

Replaces the reference's Optimizer g2o layer (src/Optimizer.cc:62
BundleAdjustment, :1694 LocalBundleAdjustment, :54 GlobalBundleAdjustemnt
[sic]) with one jit Levenberg-Marquardt solver over (poses, points).

Design: the sparse normal equations are never materialised.  Each LM
step runs preconditioned conjugate gradients with a matrix-free
Hessian-vector product evaluated over the observation COO via gathers +
segment-sums (all dense and regular), with a block-Jacobi preconditioner
(batched 6x6 / 3x3 block inverses — the same blocks a Schur solver would
form).  This is the landmark-elimination trade re-expressed as regular
dense work (SURVEY.md §7.4): identical fixed point, no irregular sparse
factorisation.  The same machinery shards over a device mesh by psum-ing
the segment sums (dist/sharded_ba.py).

Observations are padded COO arrays with a validity mask; fixed
keyframes/points are masked out of the update (g2o's setFixed).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core import lie
from .robust import CHI2_MONO, CHI2_STEREO, DELTA_MONO, DELTA_STEREO, huber_weight


class BAProblem(NamedTuple):
    R: jnp.ndarray            # (K,3,3) world->cam
    t: jnp.ndarray            # (K,3)
    points: jnp.ndarray       # (P,3)
    obs_kf: jnp.ndarray       # (O,) int32
    obs_mp: jnp.ndarray       # (O,) int32
    obs_uv: jnp.ndarray       # (O,2) float32
    inv_sigma2: jnp.ndarray   # (O,)
    obs_valid: jnp.ndarray    # (O,) bool
    fixed_kf: jnp.ndarray     # (K,) bool
    fixed_mp: jnp.ndarray     # (P,) bool
    obs_ur: Optional[jnp.ndarray] = None  # (O,) right-image u; <0 = mono


class BAResult(NamedTuple):
    R: jnp.ndarray
    t: jnp.ndarray
    points: jnp.ndarray
    inliers: jnp.ndarray      # (O,) bool after chi2 classification
    cost: jnp.ndarray


def _obs_residual_jac(R, t, points, p: BAProblem, project, bf: float = 0.0):
    """Residuals + Jacobians wrt pose tangent and point at the current
    estimate.  Mono: (O,2)/(O,2,6)/(O,2,3).  When p.obs_ur is set the
    residual is 3-dim with the stereo component u_r - (u' - bf/z)
    masked to 0 for mono observations (reference EdgeStereo,
    G2oTypes.h:422)."""
    Rk = R[p.obs_kf]
    tk = t[p.obs_kf]
    pw = points[p.obs_mp]
    uv = p.obs_uv
    # Invalid (padding) observations may address garbage points; a z=0
    # camera point yields NaN, and NaN * 0-weight still poisons the
    # normal equations.  Substitute a point 1m in front of the camera.
    safe_pw = jnp.einsum("oji,oj->oi", Rk, -tk + jnp.array([0.0, 0.0, 1.0],
                                                           points.dtype))
    pw = jnp.where(p.obs_valid[:, None], pw, safe_pw)
    stereo = p.obs_ur is not None
    ur = p.obs_ur if stereo else None

    def r_fn(delta, dp, Rk1, tk1, pw1, uv1, ur1):
        dR, dt = lie.se3_exp(delta)
        Rn = Rk1 @ dR
        tn = Rk1 @ dt + tk1
        pc = Rn @ (pw1 + dp) + tn
        duv = uv1 - project(pc)
        if not stereo:
            return duv
        u_proj_r = project(pc)[0] - bf / pc[2]
        r3 = jnp.where(ur1 >= 0, ur1 - u_proj_r, 0.0)
        return jnp.concatenate([duv, r3[None]])

    zero6 = jnp.zeros(6, points.dtype)
    zero3 = jnp.zeros(3, points.dtype)

    def per_obs(Rk1, tk1, pw1, uv1, ur1):
        r = r_fn(zero6, zero3, Rk1, tk1, pw1, uv1, ur1)
        Jp = jax.jacfwd(r_fn, argnums=0)(zero6, zero3, Rk1, tk1, pw1, uv1, ur1)
        Jl = jax.jacfwd(r_fn, argnums=1)(zero6, zero3, Rk1, tk1, pw1, uv1, ur1)
        return r, Jp, Jl

    ur_arg = ur if stereo else jnp.full(uv.shape[0], -1.0, points.dtype)
    return jax.vmap(per_obs)(Rk, tk, pw, uv, ur_arg)


def _obs_residual_only(R, t, points, p: BAProblem, project, bf: float = 0.0):
    """Residuals WITHOUT Jacobians — for cost evaluation.  The jacfwd
    in _obs_residual_jac evaluates the projection once per tangent
    (9 extra passes); cost checks only need the primal, and they run
    twice per LM iteration."""
    Rk = R[p.obs_kf]
    tk = t[p.obs_kf]
    pw = points[p.obs_mp]
    safe_pw = jnp.einsum("oji,oj->oi", Rk, -tk + jnp.array([0.0, 0.0, 1.0],
                                                           points.dtype))
    pw = jnp.where(p.obs_valid[:, None], pw, safe_pw)
    pc = jnp.einsum("oij,oj->oi", Rk, pw) + tk
    duv = p.obs_uv - jax.vmap(project)(pc)
    if p.obs_ur is None:
        return duv
    u_proj_r = jax.vmap(project)(pc)[:, 0] - bf / pc[:, 2]
    r3 = jnp.where(p.obs_ur >= 0, p.obs_ur - u_proj_r, 0.0)
    return jnp.concatenate([duv, r3[:, None]], axis=1)


def _inv3x3(M):
    """Closed-form batched symmetric-friendly 3x3 inverse (adjugate):
    avoids the LAPACK-style batched-LU path in favour of arithmetic
    that fuses."""
    m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    m10, m11, m12 = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    m20, m21, m22 = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    c00 = m11 * m22 - m12 * m21
    c01 = m12 * m20 - m10 * m22
    c02 = m10 * m21 - m11 * m20
    det = m00 * c00 + m01 * c01 + m02 * c02
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    c10 = m02 * m21 - m01 * m22
    c11 = m00 * m22 - m02 * m20
    c12 = m01 * m20 - m00 * m21
    c20 = m01 * m12 - m02 * m11
    c21 = m02 * m10 - m00 * m12
    c22 = m00 * m11 - m01 * m10
    row0 = jnp.stack([c00, c10, c20], -1)
    row1 = jnp.stack([c01, c11, c21], -1)
    row2 = jnp.stack([c02, c12, c22], -1)
    return jnp.stack([row0, row1, row2], -2) * inv_det[..., None, None]


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5, 6, 7))
def optimize(
    p: BAProblem,
    project,
    n_iters: int = 10,
    cg_iters: int = 40,
    use_huber: bool = True,
    chi2_outlier: float = CHI2_MONO,
    bf: float = 0.0,
    solver: str = "cg",
) -> BAResult:
    """LM bundle adjustment.  project: cam point (3,) -> pixel (2,).

    With p.obs_ur set, stereo observations (ur >= 0) use the 3-dim
    residual, Huber delta sqrt(7.815) and the stereo chi2 gate.

    solver="cg": matrix-free PCG over the full (pose, point) system —
    scales to any size, but runs cg_iters sequential small steps.  solver=
    "schur_dense": eliminate landmarks (closed-form 3x3 inverses) and
    solve the DENSE (6K, 6K) reduced camera system directly — one
    Cholesky per LM iteration instead of cg_iters sequential sweeps
    (its speed on the GPU for window problems, K <= 64, is not
    measured).  Both share build/retraction/acceptance, so they reach
    the same fixed point (dense is the exact solve)."""
    stereo = p.obs_ur is not None
    if stereo:
        delta_h = jnp.where(p.obs_ur >= 0, DELTA_STEREO, DELTA_MONO)
        chi2_th = jnp.where(p.obs_ur >= 0, CHI2_STEREO, chi2_outlier)
    else:
        delta_h = DELTA_MONO
        chi2_th = chi2_outlier
    K = p.R.shape[0]
    P = p.points.shape[0]
    dtype = p.points.dtype

    free_kf = (~p.fixed_kf).astype(dtype)[:, None]      # (K,1)
    free_mp = (~p.fixed_mp).astype(dtype)[:, None]      # (P,1)

    def build(R, t, points):
        r, Jp, Jl = _obs_residual_jac(R, t, points, p, project, bf)
        chi2 = jnp.sum(r * r, -1) * p.inv_sigma2
        w = huber_weight(chi2, delta_h) if use_huber else jnp.ones_like(chi2)
        w = w * p.inv_sigma2 * p.obs_valid.astype(dtype)
        return r, Jp, Jl, w, chi2

    def lm_step(state, _):
        R, t, points, lam, cost_prev = state
        r, Jp, Jl, w, chi2 = build(R, t, points)
        Jpw = Jp * w[:, None, None]
        Jlw = Jl * w[:, None, None]

        # gradient (negative: we solve H d = b with b = J^T W r)
        g_pose = jnp.zeros((K, 6), dtype).at[p.obs_kf].add(
            jnp.einsum("oif,oi->of", Jpw, r)
        ) * free_kf
        g_point = jnp.zeros((P, 3), dtype).at[p.obs_mp].add(
            jnp.einsum("oif,oi->of", Jlw, r)
        ) * free_mp

        # block diagonals (also the Jacobi preconditioner / LM damping)
        Hpp = jnp.zeros((K, 6, 6), dtype).at[p.obs_kf].add(
            jnp.einsum("oif,oig->ofg", Jpw, Jp)
        )
        Hll = jnp.zeros((P, 3, 3), dtype).at[p.obs_mp].add(
            jnp.einsum("oif,oig->ofg", Jlw, Jl)
        )

        lamI6 = lam * jnp.eye(6, dtype=dtype)
        lamI3 = lam * jnp.eye(3, dtype=dtype)
        bp, bl = g_pose, g_point

        if solver == "schur_dense":
            # landmark elimination + direct dense reduced camera solve
            Ml = _inv3x3(Hll + lamI3[None])              # (P,3,3)
            W_o = jnp.einsum("oif,oig->ofg", Jpw, Jl)    # (O,6,3)
            A_o = jnp.einsum("ofg,ogh->ofh", W_o, Ml[p.obs_mp])  # W C
            G1 = jnp.zeros((K, P, 6, 3), dtype).at[
                p.obs_kf, p.obs_mp].add(A_o)
            G2 = jnp.zeros((K, P, 6, 3), dtype).at[
                p.obs_kf, p.obs_mp].add(W_o)
            G1m = G1.transpose(0, 2, 1, 3).reshape(K * 6, P * 3)
            G2m = G2.transpose(0, 2, 1, 3).reshape(K * 6, P * 3)
            # S = blockdiag(Hpp + lam I) - W C W^T
            S = -(G1m @ G2m.T)
            kk = jnp.arange(K)
            S = S.reshape(K, 6, K, 6).at[kk, :, kk, :].add(
                Hpp + lamI6[None]
            ).reshape(K * 6, K * 6)
            b_red = bp.reshape(-1) - G1m @ bl.reshape(-1)
            # freeze fixed poses: identity rows/cols, zero rhs
            fvec = jnp.repeat(free_kf[:, 0], 6)
            S = S * fvec[:, None] * fvec[None, :] \
                + jnp.diag(1.0 - fvec)
            b_red = b_red * fvec
            xp = jnp.linalg.solve(S, b_red).reshape(K, 6) * free_kf
            # back-substitute landmarks
            wtd = jnp.zeros((P, 3), dtype).at[p.obs_mp].add(
                jnp.einsum("ofg,of->og", W_o, xp[p.obs_kf])
            )
            xl = jnp.einsum("pfg,pg->pf", Ml, bl - wtd) * free_mp
            dp, dl = -xp, -xl
        else:
            Mp = jnp.linalg.inv(Hpp + lamI6[None])   # (K,6,6)
            Ml = _inv3x3(Hll + lamI3[None])          # (P,3,3)

            def hv(vp, vl):
                """(H + lam I) (vp, vl), matrix-free over the COO."""
                vp = vp * free_kf
                vl = vl * free_mp
                u = jnp.einsum("oif,of->oi", Jp, vp[p.obs_kf]) + jnp.einsum(
                    "oif,of->oi", Jl, vl[p.obs_mp]
                )
                uw = u * w[:, None]
                hp = jnp.zeros((K, 6), dtype).at[p.obs_kf].add(
                    jnp.einsum("oif,oi->of", Jp, uw)
                ) * free_kf
                hl = jnp.zeros((P, 3), dtype).at[p.obs_mp].add(
                    jnp.einsum("oif,oi->of", Jl, uw)
                ) * free_mp
                return hp + lam * vp, hl + lam * vl

            def precond(vp, vl):
                return (
                    jnp.einsum("kfg,kg->kf", Mp, vp) * free_kf,
                    jnp.einsum("pfg,pg->pf", Ml, vl) * free_mp,
                )

            def dot(a, b):
                return jnp.sum(a[0] * b[0]) + jnp.sum(a[1] * b[1])

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
                rz_new = dot(rr, z)
                beta = rz_new / jnp.maximum(rz, 1e-20)
                pdir = (z[0] + beta * pdir[0], z[1] + beta * pdir[1])
                return (x, rr, pdir, rz_new), None

            (x, _, _, _), _ = jax.lax.scan(
                cg_body, (x, rr, pdir, rz), None, length=cg_iters
            )
            # r = obs - pred and J = dr/dx, the GN step is -H^-1 J^T W r
            dp, dl = -x[0], -x[1]

        # apply retraction
        dR, dt = jax.vmap(lie.se3_exp)(dp)
        Rn = R @ dR
        tn = jnp.einsum("kij,kj->ki", R, dt) + t
        pn = points + dl

        def rho_of(c2):
            if use_huber:
                d2 = delta_h * delta_h
                return jnp.where(
                    c2 <= d2, c2, 2.0 * delta_h * jnp.sqrt(c2) - d2
                )
            return c2

        def total_cost(Rc, tc, pc):
            rr2 = _obs_residual_only(Rc, tc, pc, p, project, bf)
            c2 = jnp.sum(rr2 * rr2, -1) * p.inv_sigma2
            return jnp.sum(jnp.where(p.obs_valid, rho_of(c2), 0.0))

        c_new = total_cost(Rn, tn, pn)
        # current-state cost from build's chi2 (no extra evaluation)
        c_old = jnp.sum(jnp.where(p.obs_valid, rho_of(chi2), 0.0))
        better = c_new < c_old
        R = jnp.where(better, Rn, R)
        t = jnp.where(better, tn, t)
        points = jnp.where(better, pn, points)
        lam = jnp.where(better, lam * 0.5, lam * 4.0)
        return (R, t, points, lam, jnp.minimum(c_new, c_old)), None

    lam0 = jnp.asarray(1e-4, dtype)
    state = (p.R, p.t, p.points, lam0, jnp.asarray(jnp.inf, dtype))
    state, _ = jax.lax.scan(lm_step, state, None, length=n_iters)
    R, t, points, _, cost = state
    # keep keyframe rotations on SO(3) (see solver/pose_opt.py: residual
    # distortion feeds back exponentially through chained predictions)
    R = lie.orthonormalize(R)

    r = _obs_residual_only(R, t, points, p, project, bf)
    chi2 = jnp.sum(r * r, -1) * p.inv_sigma2
    inliers = p.obs_valid & (chi2 <= chi2_th)
    return BAResult(R=R, t=t, points=points, inliers=inliers, cost=cost)
