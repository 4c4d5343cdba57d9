"""Batched RANSAC PnP for relocalization.

Batched replacement for the reference's RANSAC PnP solvers
(`inc/PnPsolver.h:60-92` EPnP, `inc/MLPnPsolver.h:59-157` MLPnP — the
one Relocalization actually uses, `src/Tracking.cc:3184` region).  Both
reference solvers draw random minimal sets sequentially and iterate
until enough inliers; here all hypotheses are drawn up front and solved
as ONE batched linear-algebra program (vmap over hypotheses, batched
12x12 SVD, dense inlier scoring), then the winner is refined
with the shared LM pose optimizer (`solver/pose_opt.py`).

Like MLPnP, the solver operates on normalized bearing-plane coordinates
(x/z, y/z after camera unprojection), so it is camera-model agnostic
(pinhole and KB8 fisheye both reduce to the same problem).
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

MIN_SAMPLE = 6  # DLT minimal set (12 unknowns / 2 eqs per point)


class PnPResult(NamedTuple):
    R: jnp.ndarray        # [3,3]
    t: jnp.ndarray        # [3]
    inliers: jnp.ndarray  # [N] bool
    n_inliers: jnp.ndarray  # scalar int
    ok: jnp.ndarray       # scalar bool


def _dlt_pose(p3d, xy):
    """Direct linear transform for P=[R|t] from 6+ correspondences.

    p3d: [S,3] world points, xy: [S,2] normalized image coords.
    Returns (R, t) with R orthogonalized by Procrustes and the sign
    fixed so the sample centroid has positive depth.
    """
    S = p3d.shape[0]
    X = jnp.concatenate([p3d, jnp.ones((S, 1), p3d.dtype)], -1)  # [S,4]
    z = jnp.zeros((S, 4), p3d.dtype)
    # rows: [X 0 -x*X ; 0 X -y*X]
    r1 = jnp.concatenate([X, z, -xy[:, :1] * X], -1)
    r2 = jnp.concatenate([z, X, -xy[:, 1:2] * X], -1)
    A = jnp.concatenate([r1, r2], 0)  # [2S,12]
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    p = vt[-1]  # [12]
    P = p.reshape(3, 4)

    def orth(M):
        # nearest SO(3) to M (Procrustes) + positive scale
        u, s, vtm = jnp.linalg.svd(M)
        d = jnp.linalg.det(u @ vtm)
        R = u @ jnp.diag(jnp.array([1.0, 1.0, 0.0], M.dtype)
                         + jnp.array([0.0, 0.0, 1.0], M.dtype) * d) @ vtm
        return R, jnp.maximum(jnp.mean(s), 1e-12)

    # P is defined up to sign: build both candidates, keep the one that
    # puts the sample centroid at positive depth.
    Ra, sa = orth(P[:, :3])
    Rb, sb = orth(-P[:, :3])
    ta = P[:, 3] / sa
    tb = -P[:, 3] / sb
    c = jnp.mean(p3d, 0)
    za = (Ra @ c + ta)[2]
    use_a = za > 0
    R = jnp.where(use_a, Ra, Rb)
    t = jnp.where(use_a, ta, tb)
    return R, t


def _epnp_pose(p3d, xy):
    """EPnP (reference inc/PnPsolver.h:60-92) for one minimal sample,
    batched via vmap: 4 control points (centroid + PCA axes), barycentric
    coordinates, the 2S x 12 system's null vector as the camera-frame
    control points (the N=1 beta case), scale fixed by inter-control
    distance consistency, sign by cheirality, and the final (R, t) from
    a closed-form rigid alignment (Horn) of the camera-frame points onto
    the world sample.

    p3d: [S,3] world points, xy: [S,2] normalized image coords.
    Far more noise-robust than the 6-point DLT: the control-point
    parametrization confines the solution to a 12-dim subspace aligned
    with the sample's geometry instead of a raw projective P.
    """
    S = p3d.shape[0]
    dtype = p3d.dtype
    c0 = jnp.mean(p3d, 0)
    X = p3d - c0
    cov = X.T @ X / S
    w, V = jnp.linalg.eigh(cov)  # ascending
    # principal axes scaled by sqrt(eigenvalue); floor for (near-)planar
    # samples so the 4th control point stays affinely independent
    s_ax = jnp.sqrt(jnp.maximum(w, 1e-8))
    C_w = jnp.concatenate(
        [c0[None], c0[None] + (V * s_ax[None, :]).T], 0
    )  # [4,3] control points: centroid + 3 axes

    # barycentric coordinates: [C_w^T;1] alpha = [p;1]
    A4 = jnp.concatenate(
        [C_w.T, jnp.ones((1, 4), dtype)], 0
    )  # [4,4]
    rhs = jnp.concatenate([p3d.T, jnp.ones((1, S), dtype)], 0)  # [4,S]
    alpha = jnp.linalg.solve(A4, rhs).T  # [S,4]

    # M (2S x 12): alpha_j * [1 0 -u; 0 1 -v] per control point
    u = xy[:, 0:1]
    v = xy[:, 1:2]
    z = jnp.zeros_like(u)
    o = jnp.ones_like(u)
    rows_u = (alpha[:, :, None] * jnp.concatenate([o, z, -u], -1)[:, None, :])
    rows_v = (alpha[:, :, None] * jnp.concatenate([z, o, -v], -1)[:, None, :])
    M = jnp.concatenate(
        [rows_u.reshape(S, 12), rows_v.reshape(S, 12)], 0
    )  # [2S,12]
    _, _, vt = jnp.linalg.svd(M, full_matrices=True)
    Cc = vt[-1].reshape(4, 3)  # camera-frame control points, up to scale

    # scale from control-point distance consistency (beta, N=1 case)
    ii, jj = jnp.triu_indices(4, 1)
    d_c = jnp.linalg.norm(Cc[ii] - Cc[jj], axis=-1)
    d_w = jnp.linalg.norm(C_w[ii] - C_w[jj], axis=-1)
    beta = jnp.sum(d_w * d_c) / jnp.maximum(jnp.sum(d_c * d_c), 1e-12)
    Cc = Cc * beta
    pc = alpha @ Cc  # [S,3] camera-frame sample points
    # cheirality: flip if the solution puts the cloud behind the camera
    pc = jnp.where(jnp.mean(pc[:, 2]) < 0, -pc, pc)

    # rigid alignment p_c = R p_w + t (Horn, fixed scale)
    mu_w = jnp.mean(p3d, 0)
    mu_c = jnp.mean(pc, 0)
    H = (p3d - mu_w).T @ (pc - mu_c)
    U, _, Vt = jnp.linalg.svd(H)
    d = jnp.linalg.det(Vt.T @ U.T)
    D = jnp.diag(jnp.array([1.0, 1.0, 0.0], dtype)
                 + jnp.array([0.0, 0.0, 1.0], dtype) * d)
    R = Vt.T @ D @ U.T
    t = mu_c - R @ mu_w
    return R, t


def _score(R, t, p3d, xy, valid, th2):
    pc = p3d @ R.T + t
    zok = pc[:, 2] > 1e-6
    proj = pc[:, :2] / jnp.where(zok, pc[:, 2], 1.0)[:, None]
    err2 = jnp.sum((proj - xy) ** 2, -1)
    inl = valid & zok & (err2 < th2)
    return inl, jnp.sum(inl)


@partial(jax.jit, static_argnames=("n_hypotheses", "min_inliers", "solver"))
def ransac_pnp(
    p3d,
    xy,
    valid,
    key,
    th=0.01,
    n_hypotheses=256,
    min_inliers=15,
    solver: str = "epnp",
):
    """RANSAC PnP: p3d [N,3] world points, xy [N,2] normalized bearing
    coords, valid [N] mask.  th is the inlier threshold in normalized
    image units (~pixels / focal length).

    All hypotheses are solved and scored in parallel (batched SVD +
    one [H,N] scoring pass) — the replacement for the reference's
    sequential `PnPsolver::iterate` loop.
    """
    N = p3d.shape[0]
    nvalid = jnp.sum(valid)
    # sample weighted toward valid entries: draw uniform over N but
    # reject invalid by re-rolling via categorical over the mask
    logits = jnp.where(valid, 0.0, -1e9)
    idx = jax.random.categorical(
        key, logits[None, None, :], axis=-1,
        shape=(n_hypotheses, MIN_SAMPLE),
    )  # [H,6]
    p3s = p3d[idx]          # [H,6,3]
    xys = xy[idx]           # [H,6,2]
    minimal = _epnp_pose if solver == "epnp" else _dlt_pose
    Rs, ts = jax.vmap(minimal)(p3s, xys)
    th2 = th * th
    inls, counts = jax.vmap(lambda R, t: _score(R, t, p3d, xy, valid, th2))(Rs, ts)
    best = jnp.argmax(counts)
    R, t, inliers, n_inl = Rs[best], ts[best], inls[best], counts[best]
    ok = (n_inl >= min_inliers) & (nvalid >= MIN_SAMPLE)
    return PnPResult(R, t, inliers, n_inl, ok)


def refine_pnp(result: PnPResult, p3d, xy, project, inv_sigma2=None):
    """LM refinement of the RANSAC winner on its inlier set using the
    shared robust pose optimizer (reference: PnPsolver GN refine +
    PoseOptimization follow-up in Relocalization)."""
    from extractorb.solver import pose_opt as spo

    N = p3d.shape[0]
    if inv_sigma2 is None:
        inv_sigma2 = jnp.ones((N,), jnp.float32)
    return spo.optimize_pose(
        result.R, result.t, p3d, xy, inv_sigma2, result.inliers, project,
    )


# --------------------------------------------------------------------------
# MLPnP: maximum-likelihood PnP on unit bearing vectors
# --------------------------------------------------------------------------


def _null_basis(bear):
    """Per-bearing 2D nullspace basis (r, s) with r,s ⟂ v, |r|=|s|=1
    (reference MLPnPsolver nullspace parameterization,
    inc/MLPnPsolver.h:59-157): residuals live in the tangent plane of
    the unit sphere, so bearings anywhere on the sphere — including the
    >87-degree off-axis fisheye rays a z=1 projection cannot express —
    are first-class measurements."""
    v = bear / jnp.linalg.norm(bear, axis=-1, keepdims=True)
    # pick the axis least aligned with v for a stable cross product
    ref = jnp.where(
        (jnp.abs(v[..., 2:3]) < 0.9), jnp.array([0.0, 0.0, 1.0], v.dtype),
        jnp.array([1.0, 0.0, 0.0], v.dtype),
    )
    r = jnp.cross(v, ref)
    r = r / jnp.maximum(jnp.linalg.norm(r, axis=-1, keepdims=True), 1e-12)
    s = jnp.cross(v, r)
    return r, s


def _mlpnp_pose(p3d, bear):
    """Closed-form MLPnP initial pose from S >= 6 (point, bearing)
    pairs: stack the nullspace constraints r_i^T(R p_i + t) = 0,
    s_i^T(R p_i + t) = 0 into a (2S,12) system, take the smallest
    singular vector, project onto SO(3) (Procrustes) and fix the sign
    by bearing cheirality."""
    r, s = _null_basis(bear)

    def rows(n):
        # n^T (R p + t): coefficients for vec(R row-major) then t
        return jnp.concatenate(
            [n[:, 0:1] * p3d, n[:, 1:2] * p3d, n[:, 2:3] * p3d, n], -1
        )

    A = jnp.concatenate([rows(r), rows(s)], 0)       # (2S,12)
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    v = vt[-1]                     # layout: [vec(R) row-major, t]
    M = v[:9].reshape(3, 3)
    t_raw = v[9:12]
    # sign first (the singular vector is defined up to sign): transformed
    # points must align with their bearings — decided on the RAW estimate
    # so the Procrustes projection below sees a positively-scaled rotation
    pc_raw = p3d @ M.T + t_raw
    agree = jnp.sum(jnp.sum(pc_raw * bear, -1))
    M = jnp.where(agree < 0, -M, M)
    t_raw = jnp.where(agree < 0, -t_raw, t_raw)
    u, sv, vtm = jnp.linalg.svd(M)
    d = jnp.linalg.det(u @ vtm)
    R = u @ jnp.diag(jnp.asarray([1.0, 1.0, 0.0], M.dtype)
                     + jnp.asarray([0.0, 0.0, 1.0], M.dtype) * d) @ vtm
    scale = jnp.maximum(jnp.mean(sv), 1e-12)
    t = t_raw / scale
    return R, t


def _score_bearing(R, t, p3d, bear, valid, cos_th):
    pc = p3d @ R.T + t
    n = jnp.maximum(jnp.linalg.norm(pc, axis=-1), 1e-12)
    cosang = jnp.sum(pc * bear, -1) / n
    inl = valid & (cosang > cos_th)
    return inl, jnp.sum(inl.astype(jnp.int32))


@partial(jax.jit, static_argnums=(4, 5, 6))
def mlpnp_ransac(
    p3d, bear, valid, key,
    n_hyp: int = 256, ang_th_deg: float = 0.6, min_inliers: int = 12,
):
    """Batched-RANSAC MLPnP (the solver the reference's Relocalization
    actually uses, inc/MLPnPsolver.h): all hypotheses drawn up front,
    solved as one vmapped (2S,12) SVD batch, scored by bearing angle."""
    N = p3d.shape[0]
    cos_th = jnp.cos(jnp.deg2rad(ang_th_deg))
    logits = jnp.where(valid, 0.0, -1e9)
    idx = jax.random.categorical(
        key, logits[None, None, :], axis=-1,
        shape=(n_hyp, MIN_SAMPLE),
    )

    def solve_one(rows):
        return _mlpnp_pose(p3d[rows], bear[rows])

    Rs, ts = jax.vmap(solve_one)(idx)
    inls, counts = jax.vmap(
        lambda R, t: _score_bearing(R, t, p3d, bear, valid, cos_th)
    )(Rs, ts)
    best = jnp.argmax(counts)
    R, t = Rs[best], ts[best]
    inl = inls[best]
    n = counts[best]
    return PnPResult(R=R, t=t, inliers=inl, n_inliers=n,
                     ok=n >= min_inliers)


@partial(jax.jit, static_argnums=(6,))
def mlpnp_refine(R0, t0, p3d, bear, info, valid, n_iters: int = 8):
    """Covariance-weighted Gauss-Newton refinement on the nullspace
    residuals [r_i^T u; s_i^T u], u = (R p + t)/|R p + t| — the ML part
    of MLPnP (reference refineGaussNewton, inc/MLPnPsolver.h:120
    region).  ``info`` is the per-observation information weight
    (inverse bearing-tangent variance, e.g. inv_sigma2 of the keypoint
    octave mapped through the unprojection)."""
    from ..core import lie

    r_b, s_b = _null_basis(bear)
    w = info * valid.astype(p3d.dtype)

    def step(carry, _):
        R, t = carry

        def resid(d6):
            dR, dt = lie.se3_exp(d6)
            Rn = R @ dR
            tn = R @ dt + t
            pc = p3d @ Rn.T + tn
            u = pc / jnp.maximum(
                jnp.linalg.norm(pc, axis=-1, keepdims=True), 1e-12)
            return jnp.stack(
                [jnp.sum(r_b * u, -1), jnp.sum(s_b * u, -1)], -1
            )  # (N,2)

        z6 = jnp.zeros(6, p3d.dtype)
        r = resid(z6)
        J = jax.jacfwd(resid)(z6)           # (N,2,6)
        Jw = J * w[:, None, None]
        H = jnp.einsum("nio,nij->oj", Jw, J)
        b = jnp.einsum("nio,ni->o", Jw, r)
        d = -jnp.linalg.solve(H + 1e-8 * jnp.eye(6, dtype=H.dtype), b)
        dR, dt = lie.se3_exp(d)
        return (R @ dR, R @ dt + t), None

    (R, t), _ = jax.lax.scan(step, (R0, t0), None, length=n_iters)
    from ..core import lie as _lie
    return _lie.orthonormalize(R), t
