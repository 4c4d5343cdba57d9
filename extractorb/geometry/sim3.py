"""Sim3 estimation between keyframes (loop closing).

Replaces Sim3Solver (reference: inc/Sim3Solver.h:37-61,
src/Sim3Solver.cc): Horn 1987 closed-form similarity from 3 point
correspondences inside a RANSAC loop, inliers checked by reprojection in
both images.

Design: all RANSAC hypotheses are one vmapped batch — each computes
the Horn alignment via the 4x4 quaternion eigen problem (batched eigh)
— and all correspondences are scored against all hypotheses at once.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import lie


class Sim3Result(NamedTuple):
    success: jnp.ndarray
    R12: jnp.ndarray      # (3,3)
    t12: jnp.ndarray      # (3,)
    s12: jnp.ndarray      # ()
    inliers: jnp.ndarray  # (N,) bool


def horn_sim3(p1, p2, fix_scale: bool = False):
    """Closed-form s,R,t with p2 ~= s R p1 + t.  p1/p2: (M,3)."""
    c1 = p1.mean(0)
    c2 = p2.mean(0)
    x1 = p1 - c1
    x2 = p2 - c2
    M = x1.T @ x2  # (3,3) cross-dispersion S_ab = sum x1_a x2_b (Horn)
    # N matrix (4x4 symmetric), largest eigenvector = quaternion (w,x,y,z)
    Sxx, Sxy, Sxz = M[0, 0], M[0, 1], M[0, 2]
    Syx, Syy, Syz = M[1, 0], M[1, 1], M[1, 2]
    Szx, Szy, Szz = M[2, 0], M[2, 1], M[2, 2]
    N = jnp.array(
        [
            [Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx],
            [Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz],
            [Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy],
            [Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz],
        ]
    )
    w, v = jnp.linalg.eigh(N)
    q = v[:, -1]  # largest eigenvalue
    R = lie.quat_to_rot(q)
    if fix_scale:
        s = jnp.asarray(1.0, p1.dtype)
    else:
        # Horn's symmetric scale: sqrt(sum|x2|^2 / sum|x1|^2)
        s = jnp.sqrt(
            jnp.sum(x2 * x2) / jnp.maximum(jnp.sum(x1 * x1), 1e-12)
        )
    t = c2 - s * (R @ c1)
    return R, t, s


class Sim3OptResult(NamedTuple):
    R12: jnp.ndarray      # (3,3)
    t12: jnp.ndarray      # (3,)
    s12: jnp.ndarray      # ()
    inliers: jnp.ndarray  # (N,) bool
    n_in: jnp.ndarray     # () int32


@functools.partial(jax.jit, static_argnums=(8, 9, 10))
def optimize_sim3(
    R12, t12, s12,        # initial Sim3: x1 = s R x2 + t
    p1, p2,               # (N,3) points in cam1 / cam2 frames
    obs1, obs2,           # (N,2) pixel measurements in image1 / image2
    valid,                # (N,)
    project,              # cam point -> pixel (shared camera model)
    fix_scale: bool = False,
    th2: float = 10.0,
):
    """LM refinement of a relative Sim3 with bidirectional projection
    edges (reference Optimizer::OptimizeSim3, src/Optimizer.cc:3888):

        e12_i = obs1_i - project(S12 * p2_i)        (cam1 image)
        e21_i = obs2_i - project(S12^-1 * p1_i)     (cam2 image)

    Huber delta = sqrt(th2); 5 iterations, chi2-based outlier drop, then
    10 more on inliers (the reference's two-stage schedule).  Scale is
    frozen when fix_scale (stereo/RGBD; VertexSim3Expmap::_fix_scale).
    Returns the refined Sim3 + final inlier set and count.
    """
    R0 = R12.astype(jnp.float32)
    t0 = t12.astype(jnp.float32)
    ls0 = jnp.log(jnp.maximum(s12.astype(jnp.float32), 1e-12))
    delta = jnp.sqrt(jnp.float32(th2))

    def chi2_of(R, t, ls):
        s = jnp.exp(ls)
        p2_in_1 = s * (p2 @ R.T) + t
        r12 = obs1 - jax.vmap(project)(p2_in_1)
        Ri, ti, si = lie.sim3_inverse(R, t, s)
        p1_in_2 = si * (p1 @ Ri.T) + ti
        r21 = obs2 - jax.vmap(project)(p1_in_2)
        return jnp.sum(r12 * r12, -1), jnp.sum(r21 * r21, -1), r12, r21

    def gn_step(carry, active):
        R, t, ls = carry

        def r_of(x):
            phi, tau, dls = x[:3], x[3:6], x[6]
            Rn = lie.so3_exp(phi) @ R
            tn = t + tau
            sn = jnp.exp(ls + jnp.where(fix_scale, 0.0, dls))
            p2_in_1 = sn * (p2 @ Rn.T) + tn
            r12 = obs1 - jax.vmap(project)(p2_in_1)
            Ri, ti, si = lie.sim3_inverse(Rn, tn, sn)
            p1_in_2 = si * (p1 @ Ri.T) + ti
            r21 = obs2 - jax.vmap(project)(p1_in_2)
            return jnp.concatenate([r12.reshape(-1), r21.reshape(-1)])

        x0 = jnp.zeros(7, jnp.float32)
        r = r_of(x0)
        J = jax.jacfwd(r_of)(x0)  # (4N, 7)
        # Huber IRLS weights per EDGE (2 components share one weight)
        c12, c21, _, _ = chi2_of(R, t, ls)
        e12 = jnp.sqrt(jnp.maximum(c12, 1e-12))
        e21 = jnp.sqrt(jnp.maximum(c21, 1e-12))
        w12 = jnp.where(e12 <= delta, 1.0, delta / e12) * active
        w21 = jnp.where(e21 <= delta, 1.0, delta / e21) * active
        w = jnp.concatenate(
            [jnp.repeat(w12, 2), jnp.repeat(w21, 2)]
        )
        H = J.T @ (J * w[:, None])
        b = J.T @ (r * w)
        H = H + jnp.eye(7, dtype=jnp.float32) * 1e-6
        if fix_scale:
            # freeze the scale coordinate
            H = H.at[6, :].set(0.0).at[:, 6].set(0.0).at[6, 6].set(1.0)
            b = b.at[6].set(0.0)
        dx = -jnp.linalg.solve(H, b)
        dx = jnp.where(jnp.all(jnp.isfinite(dx)), dx, jnp.zeros_like(dx))
        Rn = lie.so3_exp(dx[:3]) @ R
        tn = t + dx[3:6]
        lsn = ls + jnp.where(fix_scale, 0.0, dx[6])
        return (Rn, tn, lsn), None

    active0 = valid.astype(jnp.float32)
    carry = (R0, t0, ls0)
    carry, _ = jax.lax.scan(
        lambda c, _: gn_step(c, active0), carry, None, length=5
    )
    c12, c21, _, _ = chi2_of(*carry)
    inl = valid & (c12 <= th2) & (c21 <= th2)
    # reference: bail out (return 0 inliers) if fewer than 10 survive
    enough = jnp.sum(inl.astype(jnp.int32)) >= 10
    active1 = (inl & enough).astype(jnp.float32)
    carry2, _ = jax.lax.scan(
        lambda c, _: gn_step(c, active1), carry, None, length=10
    )
    R_f, t_f, ls_f = jax.tree_util.tree_map(
        lambda a, b: jnp.where(enough, a, b), carry2, carry
    )
    c12, c21, _, _ = chi2_of(R_f, t_f, ls_f)
    inl_f = valid & (c12 <= th2) & (c21 <= th2) & enough
    return Sim3OptResult(
        R12=R_f, t12=t_f, s12=jnp.exp(ls_f),
        inliers=inl_f,
        n_in=jnp.sum(inl_f.astype(jnp.int32)),
    )


@functools.partial(jax.jit, static_argnums=(6, 7, 8))
def solve_sim3_ransac(
    key,
    p3d_1,        # (N,3) points in camera-1 frame
    p3d_2,        # (N,3) corresponding points in camera-2 frame
    uv1, uv2,     # (N,2) observed pixels in each image
    valid,        # (N,)
    project,      # cam point -> pixel
    fix_scale: bool = False,
    n_hyp: int = 128,
    th2: float = 9.21,   # chi2(2) at 99% like the reference defaults
):
    """Batched RANSAC Sim3: returns the best hypothesis + inliers.

    Inlier check: reproject each 3D point through the hypothesised Sim3
    into the OTHER camera and threshold squared pixel error in both
    directions (reference CheckInliers, Sim3Solver.cc).
    """
    n = p3d_1.shape[0]

    def sample(k):
        p = jax.random.uniform(k, (n,)) + (~valid) * 10.0
        return jnp.argsort(p)[:3]

    sets = jax.vmap(sample)(jax.random.split(key, n_hyp))

    def hyp(idx):
        R, t, s = horn_sim3(p3d_1[idx], p3d_2[idx], fix_scale)
        # project points 1 into image 2: p2' = s R p1 + t
        p2p = s * (p3d_1 @ R.T) + t
        uv2p = jax.vmap(project)(p2p)
        e2 = jnp.sum((uv2p - uv2) ** 2, -1)
        # inverse transform: p1' = (1/s) R^T (p2 - t)
        Rt, tt, st = lie.sim3_inverse(R, t, s)
        p1p = st * (p3d_2 @ Rt.T) + tt
        uv1p = jax.vmap(project)(p1p)
        e1 = jnp.sum((uv1p - uv1) ** 2, -1)
        inl = valid & (e1 < th2) & (e2 < th2) & (p2p[:, 2] > 0) & (p1p[:, 2] > 0)
        return inl.sum(), R, t, s, inl

    counts, Rs, ts, ss, inls = jax.vmap(hyp)(sets)
    best = jnp.argmax(counts)
    n_valid = jnp.sum(valid.astype(jnp.int32))
    ok = counts[best] >= jnp.maximum(20, (0.4 * n_valid).astype(jnp.int32))
    return Sim3Result(
        success=ok, R12=Rs[best], t12=ts[best], s12=ss[best],
        inliers=inls[best],
    )
