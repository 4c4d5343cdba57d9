"""Visual-inertial optimization: the inertial half of the g2o surface.

Replaces the reference's inertial Optimizer entry points and custom g2o
types with three jit LM solvers sharing the preintegration residual of
`imu/preintegration.py`:

- `optimize_vi_ba`      — LocalInertialBA / FullInertialBA
  (src/Optimizer.cc:4413 / :420): visual reprojection edges + 9-dim
  EdgeInertial chain + EdgeGyroRW/EdgeAccRW bias random walks + bias
  priors, solved matrix-free (PCG over 15-dim KF states and 3-dim
  landmarks — same design as solver/ba.py, widened pose blocks).
- `inertial_only`       — InertialOptimization (src/Optimizer.cc:5142):
  gravity direction (2-DoF), scale, velocities and one shared bias with
  poses fixed (EdgeInertialGS, inc/G2oTypes.h:545), dense LM.
- `optimize_pose_inertial` — PoseInertialOptimizationLastKeyFrame/
  LastFrame (src/Optimizer.cc:7327/:7722): tracking-time 15-dim state
  (pose, velocity, biases) against visual unary edges, one inertial
  edge to the (fixed) previous state, bias random walk, and an optional
  15-dim marginalization prior (ConstraintPoseImu/EdgePriorPoseImu,
  inc/G2oTypes.h:703/:748), with the 4-round chi2 outlier schedule.

States are body-in-world (Rwb, twb, v, bg, ba) as in the reference's
VertexPose (ImuCamPose, inc/G2oTypes.h:71); the camera sees points via
the fixed extrinsics Tcb.  Edge residuals are whitened with the
Cholesky factor of the preintegration information, turning every factor
into unit-weight least squares — regular batched 15x15 algebra.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core import lie
from ..imu import preintegration as pre
from .robust import CHI2_MONO, DELTA_MONO, huber_weight

GRAVITY = 9.81


class InertialChain(NamedTuple):
    """Per-KF preintegration from its temporal predecessor (edge k
    connects KF k-1 -> KF k; k=0 and broken chains have valid=False).
    Built by stacking `imu.preintegration.Preintegrated` results."""
    dR: jnp.ndarray      # (K,3,3)
    dV: jnp.ndarray      # (K,3)
    dP: jnp.ndarray      # (K,3)
    JRg: jnp.ndarray     # (K,3,3)
    JVg: jnp.ndarray
    JVa: jnp.ndarray
    JPg: jnp.ndarray
    JPa: jnp.ndarray
    dT: jnp.ndarray      # (K,)
    C: jnp.ndarray       # (K,15,15)
    bias0: jnp.ndarray   # (K,6) bias used at integration time
    valid: jnp.ndarray   # (K,) bool


def stack_chain(preints, valids) -> InertialChain:
    """Stack per-KF Preintegrated tuples (host-side helper)."""
    import numpy as np

    def f(field):
        return jnp.asarray(np.stack([np.asarray(getattr(p, field)) for p in preints]))

    return InertialChain(
        dR=f("dR"), dV=f("dV"), dP=f("dP"),
        JRg=f("JRg"), JVg=f("JVg"), JVa=f("JVa"),
        JPg=f("JPg"), JPa=f("JPa"),
        dT=f("dT"), C=f("C"), bias0=f("bias"),
        valid=jnp.asarray(np.asarray(valids, bool)),
    )


def _chain_at(c: InertialChain, k):
    return pre.Preintegrated(
        dR=c.dR[k], dV=c.dV[k], dP=c.dP[k], C=c.C[k],
        JRg=c.JRg[k], JVg=c.JVg[k], JVa=c.JVa[k],
        JPg=c.JPg[k], JPa=c.JPa[k], dT=c.dT[k], bias=c.bias0[k],
    )


def _info_sqrt(C, eps=1e-8):
    """Upper-triangular square root of C^-1 (whitener): C = LL^T =>
    returns U with U @ U.T = C^-1 approx; we use chol(inv(C+eps I))."""
    n = C.shape[-1]
    Ci = jnp.linalg.inv(C + eps * jnp.eye(n, dtype=C.dtype))
    Ci = 0.5 * (Ci + jnp.swapaxes(Ci, -1, -2))
    return jnp.linalg.cholesky(Ci)


def _apply_delta(R, t, v, bg, ba, d):
    """15-dim retraction matching VertexPose/VertexVelocity/Vertex*Bias:
    right-multiplicative rotation, body-frame translation delta.

    No SVD re-normalization here: this function is differentiated
    (jacfwd), and the SVD jacobian is NaN at the repeated singular
    values of an exact rotation; R @ Exp(d) is orthonormal to float
    precision already."""
    dR = lie.so3_exp(d[0:3])
    return (
        R @ dR,
        t + R @ d[3:6],
        v + d[6:9],
        bg + d[9:12],
        ba + d[12:15],
    )


def _edge_resid15(chain_k, Lr, Lb, g,
                  Ri, ti, vi, bgi, bai, Rj, tj, vj, bgj, baj):
    """Whitened [9 inertial; 6 bias-RW] residual for one chain edge.
    Inertial part uses the FIRST state's bias (EdgeInertial convention,
    inc/G2oTypes.h:492); bias RW ties b_i -> b_j."""
    b_i = jnp.concatenate([bgi, bai])
    r9 = pre.inertial_residual(
        chain_k, Ri, ti, vi, Rj, tj, vj, b_i, gravity=g
    )
    r6 = jnp.concatenate([bgj - bgi, baj - bai])
    return jnp.concatenate([Lr.T @ r9, Lb.T @ r6])


# --------------------------------------------------------------------------
# Visual-inertial bundle adjustment (LocalInertialBA / FullInertialBA)
# --------------------------------------------------------------------------

class VIBAProblem(NamedTuple):
    Rwb: jnp.ndarray          # (K,3,3) body->world rotation
    twb: jnp.ndarray          # (K,3)
    v: jnp.ndarray            # (K,3) world velocity
    bg: jnp.ndarray           # (K,3)
    ba: jnp.ndarray           # (K,3)
    points: jnp.ndarray       # (P,3)
    obs_kf: jnp.ndarray       # (O,)
    obs_mp: jnp.ndarray       # (O,)
    obs_uv: jnp.ndarray       # (O,2)
    inv_sigma2: jnp.ndarray   # (O,)
    obs_valid: jnp.ndarray    # (O,) bool
    chain: InertialChain      # K edges (edge k: k-1 -> k)
    fixed_kf: jnp.ndarray     # (K,) bool (pose+vel+bias frozen)
    fixed_mp: jnp.ndarray     # (P,) bool
    Rcb: jnp.ndarray          # (3,3) camera-from-body rotation
    tcb: jnp.ndarray          # (3,)
    prior_g: float = 0.0      # EdgePriorGyro info (on KF 0)
    prior_a: float = 0.0      # EdgePriorAcc info


class VIBAResult(NamedTuple):
    Rwb: jnp.ndarray
    twb: jnp.ndarray
    v: jnp.ndarray
    bg: jnp.ndarray
    ba: jnp.ndarray
    points: jnp.ndarray
    inliers: jnp.ndarray
    cost: jnp.ndarray


def _vis_residual_jac(Rwb, twb, points, p: VIBAProblem, project):
    """Reprojection residual/jacobian wrt the 6-dim pose slice of the
    15-dim body state (EdgeMono through ImuCamPose)."""
    Rk = Rwb[p.obs_kf]
    tk = twb[p.obs_kf]
    pw = points[p.obs_mp]
    # padding slots may address garbage points; z=0 in the camera yields
    # NaN which poisons the normal equations through NaN*0 -- substitute
    # a point 1m in front of the camera (see solver/pose_opt.py)
    pb_safe = p.Rcb.T @ (jnp.array([0.0, 0.0, 1.0], points.dtype) - p.tcb)
    pw_safe = jnp.einsum("kij,j->ki", Rk, pb_safe) + tk
    pw = jnp.where(p.obs_valid[:, None], pw, pw_safe)

    def r_fn(d6, dp, Rk1, tk1, pw1, uv1):
        Rn = Rk1 @ lie.so3_exp(d6[0:3])
        tn = tk1 + Rk1 @ d6[3:6]
        # camera pose from body pose: pc = Rcb (Rbw pw + tbw) + tcb
        pb = Rn.T @ (pw1 + dp - tn)
        pc = p.Rcb @ pb + p.tcb
        return uv1 - project(pc)

    zero6 = jnp.zeros(6, points.dtype)
    zero3 = jnp.zeros(3, points.dtype)

    def per_obs(Rk1, tk1, pw1, uv1):
        r = r_fn(zero6, zero3, Rk1, tk1, pw1, uv1)
        Jp = jax.jacfwd(r_fn, argnums=0)(zero6, zero3, Rk1, tk1, pw1, uv1)
        Jl = jax.jacfwd(r_fn, argnums=1)(zero6, zero3, Rk1, tk1, pw1, uv1)
        return r, Jp, Jl

    return jax.vmap(per_obs)(Rk, tk, pw, p.obs_uv)


def _edge_residual_jac(Rwb, twb, v, bg, ba, p: VIBAProblem, g):
    """Whitened 15-dim chain-edge residual + jacobians wrt both 15-dim
    endpoint states.  Edge k connects KF k-1 (i) and KF k (j)."""
    K = Rwb.shape[0]
    idx_j = jnp.arange(K)
    idx_i = jnp.maximum(idx_j - 1, 0)

    def per_edge(k):
        chain_k = _chain_at(p.chain, k)
        Lr = _info_sqrt(chain_k.C[:9, :9])
        Lb = _info_sqrt(chain_k.C[9:, 9:])
        i, j = idx_i[k], idx_j[k]

        def r_fn(di, dj):
            Ri, ti, vi, bgi, bai = _apply_delta(
                Rwb[i], twb[i], v[i], bg[i], ba[i], di
            )
            Rj, tj, vj, bgj, baj = _apply_delta(
                Rwb[j], twb[j], v[j], bg[j], ba[j], dj
            )
            return _edge_resid15(
                chain_k, Lr, Lb, g, Ri, ti, vi, bgi, bai, Rj, tj, vj, bgj, baj
            )

        z = jnp.zeros(15, Rwb.dtype)
        r = r_fn(z, z)
        Ji = jax.jacfwd(r_fn, argnums=0)(z, z)
        Jj = jax.jacfwd(r_fn, argnums=1)(z, z)
        ok = p.chain.valid[k]
        m = ok.astype(Rwb.dtype)
        return r * m, Ji * m, Jj * m

    return jax.vmap(per_edge)(jnp.arange(K)), idx_i, idx_j


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def optimize_vi_ba(
    p: VIBAProblem,
    project,
    n_iters: int = 8,
    cg_iters: int = 50,
    use_huber: bool = True,
) -> VIBAResult:
    """LM visual-inertial BA, matrix-free PCG (the analog of
    LocalInertialBA src/Optimizer.cc:4413 and FullInertialBA :420)."""
    K = p.Rwb.shape[0]
    P = p.points.shape[0]
    dtype = p.points.dtype
    g = jnp.asarray([0.0, 0.0, -GRAVITY], dtype)
    free_kf = (~p.fixed_kf).astype(dtype)[:, None]   # (K,1)
    free_mp = (~p.fixed_mp).astype(dtype)[:, None]   # (P,1)

    # bias prior on KF 0 (FullInertialBA's EdgePriorGyro/Acc)
    prior_diag = jnp.zeros((K, 15), dtype)
    prior_diag = prior_diag.at[0, 9:12].set(p.prior_g)
    prior_diag = prior_diag.at[0, 12:15].set(p.prior_a)

    def build(Rwb, twb, v, bg, ba, points):
        r, Jp6, Jl = _vis_residual_jac(Rwb, twb, points, p, project)
        chi2 = jnp.sum(r * r, -1) * p.inv_sigma2
        w = huber_weight(chi2, DELTA_MONO) if use_huber else jnp.ones_like(chi2)
        w = w * p.inv_sigma2 * p.obs_valid.astype(dtype)
        (re, Ji, Jj), idx_i, idx_j = _edge_residual_jac(
            Rwb, twb, v, bg, ba, p, g
        )
        return r, Jp6, Jl, w, re, Ji, Jj, idx_i, idx_j

    def lm_step(state, _):
        Rwb, twb, v, bg, ba, points, lam, cost_prev = state
        r, Jp6, Jl, w, re, Ji, Jj, idx_i, idx_j = build(
            Rwb, twb, v, bg, ba, points
        )
        # widen visual pose jac to 15 dims (pose slice 0:6)
        Jpw6 = Jp6 * w[:, None, None]
        Jlw = Jl * w[:, None, None]

        g_state = jnp.zeros((K, 15), dtype)
        g_state = g_state.at[:, :6].add(
            jnp.zeros((K, 6), dtype).at[p.obs_kf].add(
                jnp.einsum("oif,oi->of", Jpw6, r)
            )
        )
        g_state = g_state.at[idx_i].add(jnp.einsum("eif,ei->ef", Ji, re))
        g_state = g_state.at[idx_j].add(jnp.einsum("eif,ei->ef", Jj, re))
        # prior gradient: r_prior = -delta (delta=0) => only Hessian term
        g_state = g_state * free_kf

        g_point = jnp.zeros((P, 3), dtype).at[p.obs_mp].add(
            jnp.einsum("oif,oi->of", Jlw, r)
        ) * free_mp

        # block-diag preconditioner
        Hpp = jnp.zeros((K, 15, 15), dtype)
        Hpp = Hpp.at[:, :6, :6].add(
            jnp.zeros((K, 6, 6), dtype).at[p.obs_kf].add(
                jnp.einsum("oif,oig->ofg", Jpw6, Jp6)
            )
        )
        Hpp = Hpp.at[idx_i].add(jnp.einsum("eif,eig->efg", Ji, Ji))
        Hpp = Hpp.at[idx_j].add(jnp.einsum("eif,eig->efg", Jj, Jj))
        Hpp = Hpp + jnp.vectorize(jnp.diag, signature="(n)->(n,n)")(prior_diag)
        Hll = jnp.zeros((P, 3, 3), dtype).at[p.obs_mp].add(
            jnp.einsum("oif,oig->ofg", Jlw, Jl)
        )
        lamI15 = lam * jnp.eye(15, dtype=dtype)
        lamI3 = lam * jnp.eye(3, dtype=dtype)
        Mp = jnp.linalg.inv(Hpp + lamI15[None])
        Ml = jnp.linalg.inv(Hll + lamI3[None])

        def hv(vp, vl):
            vp = vp * free_kf
            vl = vl * free_mp
            u = jnp.einsum("oif,of->oi", Jp6, vp[p.obs_kf, :6]) + jnp.einsum(
                "oif,of->oi", Jl, vl[p.obs_mp]
            )
            uw = u * w[:, None]
            hp = jnp.zeros((K, 15), dtype)
            hp = hp.at[:, :6].add(
                jnp.zeros((K, 6), dtype).at[p.obs_kf].add(
                    jnp.einsum("oif,oi->of", Jp6, uw)
                )
            )
            ue = jnp.einsum("eif,ef->ei", Ji, vp[idx_i]) + jnp.einsum(
                "eif,ef->ei", Jj, vp[idx_j]
            )
            hp = hp.at[idx_i].add(jnp.einsum("eif,ei->ef", Ji, ue))
            hp = hp.at[idx_j].add(jnp.einsum("eif,ei->ef", Jj, ue))
            hp = hp + prior_diag * vp
            hp = hp * free_kf
            hl = jnp.zeros((P, 3), dtype).at[p.obs_mp].add(
                jnp.einsum("oif,oi->of", Jl, uw)
            ) * free_mp
            return hp + lam * vp, hl + lam * vl

        def precond(vp, vl):
            return (
                jnp.einsum("kfg,kg->kf", Mp, vp) * free_kf,
                jnp.einsum("pfg,pg->pf", Ml, vl) * free_mp,
            )

        bp, bl = g_state, g_point

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
        dp = -x[0] * free_kf
        dl = -x[1] * free_mp

        Rn, tn, vn, bgn, ban = jax.vmap(_apply_delta)(
            Rwb, twb, v, bg, ba, dp
        )
        pn = points + dl

        def total_cost(Rc, tc, vc, bgc, bac, pc):
            rr2, _, _ = _vis_residual_jac(Rc, tc, pc, p, project)
            c2 = jnp.sum(rr2 * rr2, -1) * p.inv_sigma2
            if use_huber:
                d2 = DELTA_MONO * DELTA_MONO
                rho = jnp.where(
                    c2 <= d2, c2, 2.0 * DELTA_MONO * jnp.sqrt(c2) - d2
                )
            else:
                rho = c2
            cvis = jnp.sum(jnp.where(p.obs_valid, rho, 0.0))
            (re2, _, _), _, _ = _edge_residual_jac(Rc, tc, vc, bgc, bac, p, g)
            return cvis + jnp.sum(re2 * re2)

        c_new = total_cost(Rn, tn, vn, bgn, ban, pn)
        c_old = total_cost(Rwb, twb, v, bg, ba, points)
        better = c_new < c_old
        pick = lambda a, b: jnp.where(better, a, b)
        state = (
            pick(Rn, Rwb), pick(tn, twb), pick(vn, v),
            pick(bgn, bg), pick(ban, ba), pick(pn, points),
            jnp.where(better, lam * 0.5, lam * 4.0),
            jnp.minimum(c_new, c_old),
        )
        return state, None

    lam0 = jnp.asarray(1e-4, dtype)
    state = (p.Rwb, p.twb, p.v, p.bg, p.ba, p.points, lam0,
             jnp.asarray(jnp.inf, dtype))
    state, _ = jax.lax.scan(lm_step, state, None, length=n_iters)
    Rwb, twb, v, bg, ba, points, _, cost = state
    Rwb = lie.orthonormalize(Rwb)  # keep body rotations on SO(3)

    r, _, _ = _vis_residual_jac(Rwb, twb, points, p, project)
    chi2 = jnp.sum(r * r, -1) * p.inv_sigma2
    inliers = p.obs_valid & (chi2 <= CHI2_MONO)
    return VIBAResult(Rwb, twb, v, bg, ba, points, inliers, cost)


# --------------------------------------------------------------------------
# Inertial-only optimization (gravity + scale + velocities + bias)
# --------------------------------------------------------------------------

class InertialOnlyResult(NamedTuple):
    Rwg: jnp.ndarray     # (3,3) gravity-frame rotation (g_world = Rwg @ [0,0,-G])
    scale: jnp.ndarray   # ()
    v: jnp.ndarray       # (K,3)
    bg: jnp.ndarray      # (3,)
    ba: jnp.ndarray      # (3,)
    cost: jnp.ndarray


@functools.partial(jax.jit, static_argnums=(5, 6, 7, 8))
def inertial_only(
    Rwb, twb, chain: InertialChain, v0, bias0,
    prior_g: float = 1e2,
    prior_a: float = 1e6,
    fix_scale: bool = False,
    n_iters: int = 30,
    Rwg0=None,
):
    """InertialOptimization (src/Optimizer.cc:5142): with all body poses
    fixed, solve for gravity direction Rwg (2-DoF), scale, per-KF
    velocities and a single shared bias — the EdgeInertialGS problem
    (inc/G2oTypes.h:545).  Dense LM over the packed parameter vector
    (the window is tens of KFs; the problem is tiny but stiff)."""
    K = Rwb.shape[0]
    dtype = twb.dtype
    g0 = jnp.asarray([0.0, 0.0, -GRAVITY], dtype)
    # data-driven gravity seed (reference LocalMapping.cc:1258 computes
    # dirG from the preintegrated velocity deltas before optimising):
    # the 2-DoF tangent step cannot travel ~90 deg from a cold start
    # without collapsing the scale into a local minimum.
    Rwg_seed = jnp.eye(3, dtype=dtype) if Rwg0 is None \
        else jnp.asarray(Rwg0, dtype)

    idx_j = jnp.arange(K)
    idx_i = jnp.maximum(idx_j - 1, 0)
    Lr = jax.vmap(lambda C: _info_sqrt(C[:9, :9]))(chain.C)  # (K,9,9)

    def unpack(x):
        theta = x[0:2]               # gravity 2-dof (rot about x,y)
        logs = x[2]
        bg = x[3:6]
        ba = x[6:9]
        v = x[9:].reshape(K, 3)
        Rwg = Rwg_seed @ lie.so3_exp(
            jnp.concatenate([theta, jnp.zeros(1, dtype)])
        )
        s = jnp.where(fix_scale, 1.0, jnp.exp(logs))
        return Rwg, s, bg, ba, v

    def residuals(x):
        Rwg, s, bg, ba, v = unpack(x)
        g = Rwg @ g0
        b = jnp.concatenate([bg, ba])

        def per_edge(k):
            i, j = idx_i[k], idx_j[k]
            chain_k = _chain_at(chain, k)
            dT = chain_k.dT
            Ri, Rj = Rwb[i], Rwb[j]
            ti, tj = twb[i], twb[j]
            vi, vj = v[i], v[j]
            eR = lie.so3_log(pre.delta_rotation(chain_k, b).T @ (Ri.T @ Rj))
            eV = Ri.T @ (s * (vj - vi) - g * dT) - pre.delta_velocity(chain_k, b)
            eP = Ri.T @ (
                s * (tj - ti - vi * dT) - 0.5 * g * dT * dT
            ) - pre.delta_position(chain_k, b)
            r9 = Lr[k].T @ jnp.concatenate([eR, eV, eP])
            return r9 * chain.valid[k].astype(dtype)

        r = jax.vmap(per_edge)(jnp.arange(K)).reshape(-1)
        rp = jnp.concatenate([
            jnp.sqrt(prior_g) * bg, jnp.sqrt(prior_a) * ba
        ])
        return jnp.concatenate([r, rp])

    x0 = jnp.concatenate([
        jnp.zeros(3, dtype),
        bias0.astype(dtype),
        v0.reshape(-1).astype(dtype),
    ])

    def lm_step(state, _):
        x, lam, _ = state
        r = residuals(x)
        J = jax.jacfwd(residuals)(x)
        H = J.T @ J
        b = J.T @ r
        n = x.shape[0]
        dx = -jnp.linalg.solve(H + lam * jnp.eye(n, dtype=dtype)
                               + 1e-9 * jnp.eye(n, dtype=dtype), b)
        xn = x + dx
        c_new = jnp.sum(residuals(xn) ** 2)
        c_old = jnp.sum(r ** 2)
        better = c_new < c_old
        x = jnp.where(better, xn, x)
        lam = jnp.where(better, lam * 0.5, lam * 5.0)
        return (x, lam, jnp.minimum(c_new, c_old)), None

    state = (x0, jnp.asarray(1e-2, dtype), jnp.asarray(jnp.inf, dtype))
    (x, _, cost), _ = jax.lax.scan(lm_step, state, None, length=n_iters)
    Rwg, s, bg, ba, v = unpack(x)
    return InertialOnlyResult(Rwg=Rwg, scale=s, v=v, bg=bg, ba=ba, cost=cost)


# --------------------------------------------------------------------------
# Tracking-time pose-velocity-bias optimization
# --------------------------------------------------------------------------

class PoseInertialResult(NamedTuple):
    Rwb: jnp.ndarray
    twb: jnp.ndarray
    v: jnp.ndarray
    bg: jnp.ndarray
    ba: jnp.ndarray
    inliers: jnp.ndarray
    n_inliers: jnp.ndarray
    H: jnp.ndarray        # (15,15) marginal information for the next prior


@functools.partial(jax.jit, static_argnums=(13, 14, 15))
def optimize_pose_inertial(
    Rwb0, twb0, v0, bg0, ba0,
    prev_state,            # (Rwb, twb, v, bg, ba) of previous KF/frame (fixed)
    preint: pre.Preintegrated,
    pts_w, obs_uv, inv_sigma2, valid,
    Rcb, tcb,
    project,
    n_rounds: int = 4,
    n_iters: int = 10,
    prior=None,            # optional (H15, state15) marginalization prior
):
    """PoseInertialOptimizationLastKeyFrame/LastFrame
    (src/Optimizer.cc:7327/:7722): GN on the current frame's 15-dim
    state with visual unary edges (chi2-reclassified over 4 rounds,
    EdgeMonoOnlyPose), one inertial edge to the fixed previous state,
    bias random walk, and an optional EdgePriorPoseImu prior."""
    dtype = twb0.dtype
    g = jnp.asarray([0.0, 0.0, -GRAVITY], dtype)
    Rp, tp, vp_, bgp, bap = prev_state
    Lr = _info_sqrt(preint.C[:9, :9])
    Lb = _info_sqrt(preint.C[9:, 9:])

    def run_round(carry, use_huber_and_mask):
        active = carry[5]
        Rc, tc, vc, bgc, bac = carry[:5]
        use_huber = use_huber_and_mask

        def one_iter(st, _):
            Rc, tc, vc, bgc, bac = st
            # keep padded slots finite (NaN*0 poisons H; see pose_opt.py)
            pb_safe = Rcb.T @ (jnp.array([0.0, 0.0, 1.0], dtype) - tcb)
            pts_safe = jnp.where(
                valid[:, None], pts_w, Rc @ pb_safe + tc
            )

            def resid_all(d):
                R, t, vv, bgn, ban = _apply_delta(Rc, tc, vc, bgc, bac, d)

                def per_kp(pw, uv):
                    pb = R.T @ (pw - t)
                    pc = Rcb @ pb + tcb
                    return uv - project(pc)

                rv = jax.vmap(per_kp)(pts_safe, obs_uv)  # (N,2)
                ri = _edge_resid15(
                    preint, Lr, Lb, g,
                    Rp, tp, vp_, bgp, bap, R, t, vv, bgn, ban,
                )
                if prior is not None:
                    Hp, s15 = prior
                    # prior residual: whitened deviation from prior state
                    Rpr, tpr, vpr, bgpr, bapr = s15
                    er = lie.so3_log(Rpr.T @ R)
                    et = Rpr.T @ (t - tpr)
                    rp = jnp.concatenate([
                        er, et, vv - vpr, bgn - bgpr, ban - bapr
                    ])
                    Lp = _info_sqrt(
                        jnp.linalg.inv(
                            Hp + 1e-6 * jnp.eye(15, dtype=dtype)
                        )
                    )
                    rpw = Lp.T @ rp
                else:
                    rpw = jnp.zeros(0, dtype)
                return rv, ri, rpw

            z15 = jnp.zeros(15, dtype)
            rv, ri, rpw = resid_all(z15)
            Jv, Jji, Jp = jax.jacfwd(resid_all)(z15)
            chi2 = jnp.sum(rv * rv, -1) * inv_sigma2
            w = jnp.where(use_huber, huber_weight(chi2, DELTA_MONO), 1.0)
            w = w * inv_sigma2 * active.astype(dtype)
            Jvw = Jv * w[:, None, None]
            H = (
                jnp.einsum("nio,nij->oj", Jvw, Jv)
                + Jji.T @ Jji
            )
            b = (
                jnp.einsum("nio,ni->o", Jvw, rv)
                + Jji.T @ ri
            )
            if prior is not None:
                H = H + Jp.T @ Jp
                b = b + Jp.T @ rpw
            d = -jnp.linalg.solve(H + 1e-8 * jnp.eye(15, dtype=dtype), b)
            return _apply_delta(Rc, tc, vc, bgc, bac, d), None

        (Rc, tc, vc, bgc, bac), _ = jax.lax.scan(
            one_iter, (Rc, tc, vc, bgc, bac), None, length=n_iters
        )

        # reclassify outliers
        def per_kp(pw, uv):
            pb = Rc.T @ (pw - tc)
            pc = Rcb @ pb + tcb
            return uv - project(pc)

        rv = jax.vmap(per_kp)(pts_w, obs_uv)
        chi2 = jnp.sum(rv * rv, -1) * inv_sigma2
        active = valid & (chi2 <= CHI2_MONO)
        return (Rc, tc, vc, bgc, bac, active), None

    carry = (Rwb0, twb0, v0, bg0, ba0, valid)
    use_huber_sched = jnp.asarray(
        [True] * (n_rounds - 1) + [False], bool
    )
    carry, _ = jax.lax.scan(run_round, carry, use_huber_sched)
    Rc, tc, vc, bgc, bac, active = carry
    Rc = lie.orthonormalize(Rc)  # keep body rotation on SO(3)

    # final Hessian (marginal information for the next frame's prior)
    pb_safe = Rcb.T @ (jnp.array([0.0, 0.0, 1.0], dtype) - tcb)
    pts_fin = jnp.where(valid[:, None], pts_w, Rc @ pb_safe + tc)

    def resid_final(d):
        R, t, vv, bgn, ban = _apply_delta(Rc, tc, vc, bgc, bac, d)

        def per_kp(pw, uv):
            pb = R.T @ (pw - t)
            pc = Rcb @ pb + tcb
            return uv - project(pc)

        rv = jax.vmap(per_kp)(pts_fin, obs_uv)
        ri = _edge_resid15(
            preint, Lr, Lb, g, Rp, tp, vp_, bgp, bap, R, t, vv, bgn, ban
        )
        return rv, ri

    z15 = jnp.zeros(15, dtype)
    Jv, Jji = jax.jacfwd(resid_final)(z15)
    wf = inv_sigma2 * active.astype(dtype)
    H = jnp.einsum("nio,nij->oj", Jv * wf[:, None, None], Jv) + Jji.T @ Jji
    return PoseInertialResult(
        Rwb=Rc, twb=tc, v=vc, bg=bgc, ba=bac,
        inliers=active, n_inliers=jnp.sum(active), H=H,
    )


class PoseInertialLastFrameResult(NamedTuple):
    Rwb: jnp.ndarray      # current body rotation
    twb: jnp.ndarray
    v: jnp.ndarray
    bg: jnp.ndarray
    ba: jnp.ndarray
    inliers: jnp.ndarray
    n_inliers: jnp.ndarray
    H: jnp.ndarray        # (15,15) ConstraintPoseImu info for the NEXT frame


@functools.partial(jax.jit, static_argnums=(13, 14, 15))
def optimize_pose_inertial_last_frame(
    Rwb0, twb0, v0, bg0, ba0,
    prev_state,            # (Rwb, twb, v, bg, ba) previous FRAME (free)
    preint: pre.Preintegrated,
    pts_w, obs_uv, inv_sigma2, valid,
    Rcb, tcb,
    project,
    n_rounds: int = 4,
    n_iters: int = 10,
    prior=None,            # (H15, prev_prior_state) ConstraintPoseImu on prev
):
    """PoseInertialOptimizationLastFrame (reference src/Optimizer.cc:7722):
    JOINT GN over the previous frame's and the current frame's 15-dim
    body states — the previous frame is FREE, anchored only by its
    marginalization prior (EdgePriorPoseImu / ConstraintPoseImu) — with
    visual unary edges on the current frame, one inertial edge between
    the two states, and chi2 reclassification across 4 rounds.  After
    convergence the previous state is marginalized out of the joint
    30x30 Hessian (solver/marginal.py, reference Marginalize(H,0,14) at
    Optimizer.cc:7722 tail) to produce the current frame's
    ConstraintPoseImu for the next call.
    """
    from . import marginal as mg

    dtype = twb0.dtype
    g = jnp.asarray([0.0, 0.0, -GRAVITY], dtype)
    Rp0, tp0, vp0, bgp0, bap0 = prev_state
    Lr = _info_sqrt(preint.C[:9, :9])
    Lb = _info_sqrt(preint.C[9:, 9:])
    if prior is not None:
        Hp, prior_state = prior
    else:
        # no marginal info yet: anchor the previous state softly
        Hp = jnp.eye(15, dtype=dtype) * 1e4
        prior_state = prev_state
    # square root of the INFORMATION matrix (Lp Lp^T = Hp) via eigh:
    # the marginalized H can be slightly indefinite in f32 (clamp the
    # spectrum at 0) and a Cholesky NaN would poison the whole chain;
    # the upper cap keeps a runaway recursive prior from freezing the
    # state outright
    Hp = 0.5 * (Hp + Hp.T)
    w_e, V_e = jnp.linalg.eigh(Hp)
    w_e = jnp.clip(w_e, 0.0, 1e7)
    Lp = V_e * jnp.sqrt(w_e)[None, :]
    Rpr, tpr, vpr, bgpr, bapr = prior_state

    def split(d30):
        return d30[:15], d30[15:]

    def states_of(st, d30):
        (Rp, tp, vp, bgp, bap, Rc, tc, vc, bgc, bac) = st
        dp, dc = split(d30)
        prev = _apply_delta(Rp, tp, vp, bgp, bap, dp)
        cur = _apply_delta(Rc, tc, vc, bgc, bac, dc)
        return prev, cur

    def run_round(carry, use_huber):
        st = carry[:10]
        active = carry[10]

        def one_iter(st, _):
            Rc, tc = st[5], st[6]
            pb_safe = Rcb.T @ (jnp.array([0.0, 0.0, 1.0], dtype) - tcb)
            pts_safe = jnp.where(valid[:, None], pts_w, Rc @ pb_safe + tc)

            def resid_all(d30):
                (Rp, tp, vp, bgp, bap), (R, t, vv, bgn, ban) = \
                    states_of(st, d30)

                def per_kp(pw, uv):
                    pb = R.T @ (pw - t)
                    pc = Rcb @ pb + tcb
                    return uv - project(pc)

                rv = jax.vmap(per_kp)(pts_safe, obs_uv)
                ri = _edge_resid15(
                    preint, Lr, Lb, g,
                    Rp, tp, vp, bgp, bap, R, t, vv, bgn, ban,
                )
                # prior residual on the PREVIOUS state (EdgePriorPoseImu)
                er = lie.so3_log(Rpr.T @ Rp)
                et = Rpr.T @ (tp - tpr)
                rp = Lp.T @ jnp.concatenate([
                    er, et, vp - vpr, bgp - bgpr, bap - bapr
                ])
                return rv, ri, rp

            z30 = jnp.zeros(30, dtype)
            rv, ri, rp = resid_all(z30)
            Jv, Ji, Jp = jax.jacfwd(resid_all)(z30)
            chi2 = jnp.sum(rv * rv, -1) * inv_sigma2
            w = jnp.where(use_huber, huber_weight(chi2, DELTA_MONO), 1.0)
            w = w * inv_sigma2 * active.astype(dtype)
            Jvw = Jv * w[:, None, None]
            H = (jnp.einsum("nio,nij->oj", Jvw, Jv)
                 + Ji.T @ Ji + Jp.T @ Jp)
            b = (jnp.einsum("nio,ni->o", Jvw, rv)
                 + Ji.T @ ri + Jp.T @ rp)
            d = -jnp.linalg.solve(H + 1e-8 * jnp.eye(30, dtype=dtype), b)
            prev, cur = states_of(st, d)
            return prev + cur, None

        st, _ = jax.lax.scan(one_iter, st, None, length=n_iters)

        Rc, tc = st[5], st[6]

        def per_kp(pw, uv):
            pb = Rc.T @ (pw - tc)
            pc = Rcb @ pb + tcb
            return uv - project(pc)

        rv = jax.vmap(per_kp)(pts_w, obs_uv)
        chi2 = jnp.sum(rv * rv, -1) * inv_sigma2
        active = valid & (chi2 <= CHI2_MONO)
        return st + (active,), None

    st0 = (Rp0, tp0, vp0, bgp0, bap0, Rwb0, twb0, v0, bg0, ba0, valid)
    use_huber_sched = jnp.asarray([True] * (n_rounds - 1) + [False], bool)
    carry, _ = jax.lax.scan(run_round, st0, use_huber_sched)
    st, active = carry[:10], carry[10]
    Rpf, tpf, vpf, bgpf, bapf = st[:5]
    Rc, tc, vc, bgc, bac = st[5:]
    Rc = lie.orthonormalize(Rc)
    Rpf = lie.orthonormalize(Rpf)

    # joint Hessian at the solution -> marginalize the previous state
    pb_safe = Rcb.T @ (jnp.array([0.0, 0.0, 1.0], dtype) - tcb)
    pts_fin = jnp.where(valid[:, None], pts_w, Rc @ pb_safe + tc)
    st_fin = (Rpf, tpf, vpf, bgpf, bapf, Rc, tc, vc, bgc, bac)

    def resid_fin(d30):
        (Rp, tp, vp, bgp, bap), (R, t, vv, bgn, ban) = \
            states_of(st_fin, d30)

        def per_kp(pw, uv):
            pb = R.T @ (pw - t)
            pc = Rcb @ pb + tcb
            return uv - project(pc)

        rv = jax.vmap(per_kp)(pts_fin, obs_uv)
        ri = _edge_resid15(
            preint, Lr, Lb, g, Rp, tp, vp, bgp, bap, R, t, vv, bgn, ban
        )
        er = lie.so3_log(Rpr.T @ Rp)
        et = Rpr.T @ (tp - tpr)
        rp = Lp.T @ jnp.concatenate([
            er, et, vp - vpr, bgp - bgpr, bap - bapr
        ])
        return rv, ri, rp

    z30 = jnp.zeros(30, dtype)
    Jv, Ji, Jp = jax.jacfwd(resid_fin)(z30)
    wf = inv_sigma2 * active.astype(dtype)
    H30 = (jnp.einsum("nio,nij->oj", Jv * wf[:, None, None], Jv)
           + Ji.T @ Ji + Jp.T @ Jp)
    H_marg = mg.marginalize(H30, 0, 14)[15:, 15:]
    H_marg = 0.5 * (H_marg + H_marg.T)  # exact symmetry (f32 pinv chain)
    return PoseInertialLastFrameResult(
        Rwb=Rc, twb=tc, v=vc, bg=bgc, ba=bac,
        inliers=active, n_inliers=jnp.sum(active), H=H_marg,
    )
