"""Two-view reconstruction: monocular map initialisation.

Replaces TwoViewReconstruction (reference:
src/TwoViewReconstruction.cc:39-934): RANSAC over homography H and
fundamental F in parallel, model selection by score ratio, motion
recovery (E decomposition / Faugeras H decomposition), DLT triangulation
and cheirality checks.

Design: where the reference spawns two threads each looping 200
RANSAC iterations with early data-dependent exits
(TwoViewReconstruction.cc:103-104), we vmap ALL hypotheses for BOTH
models as one batch: 200 8-point minimal sets -> batched SVDs -> a
(200, N) score matrix -> argmax.  Motion hypotheses (4 for E, 8 for H)
are checked as one batched triangulation.  Everything is static-shape:
matches arrive as padded arrays with a validity mask.

Constants follow the reference: 200 iterations, sigma=1.0,
chi2 thresholds 3.841/5.991, model select ratio 0.4, minParallax=1.0
(deg), minTriangulated=50.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

N_RANSAC = 200
CHI2_F = 3.841
CHI2_H = 5.991
MIN_PARALLAX_DEG = 1.0
MIN_TRIANGULATED = 50


class TwoViewResult(NamedTuple):
    success: jnp.ndarray      # () bool
    R21: jnp.ndarray          # (3,3) rotation cam1 -> cam2
    t21: jnp.ndarray          # (3,)  unit-norm translation
    points3d: jnp.ndarray     # (N,3) in cam1 frame
    is_triangulated: jnp.ndarray  # (N,) bool
    used_homography: jnp.ndarray  # () bool


def _normalize(pts, valid):
    """Reference Normalize (TwoViewReconstruction.cc): mean + mean abs dev."""
    w = valid.astype(pts.dtype)
    n = jnp.maximum(jnp.sum(w), 1.0)
    mean = jnp.sum(pts * w[:, None], 0) / n
    dev = jnp.sum(jnp.abs(pts - mean) * w[:, None], 0) / n
    s = 1.0 / jnp.maximum(dev, 1e-9)
    norm = (pts - mean) * s
    T = jnp.array(
        [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]], pts.dtype
    )
    T = T.at[0, 0].set(s[0]).at[1, 1].set(s[1])
    T = T.at[0, 2].set(-mean[0] * s[0]).at[1, 2].set(-mean[1] * s[1])
    return norm, T


def _compute_h(x1, x2, w=None):
    """DLT homography: (N,2),(N,2)[, (N,) weights] -> (3,3)."""
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    z = jnp.zeros_like(u1)
    o = jnp.ones_like(u1)
    r1 = jnp.stack([z, z, z, -u1, -v1, -o, v2 * u1, v2 * v1, v2], -1)
    r2 = jnp.stack([u1, v1, o, z, z, z, -u2 * u1, -u2 * v1, -u2], -1)
    A = jnp.concatenate([r1, r2], 0)  # (2N,9)
    if w is not None:
        A = A * jnp.concatenate([w, w])[:, None]
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    return vt[-1].reshape(3, 3)


def _compute_f(x1, x2, w=None):
    """8-point fundamental with rank-2 projection (optionally weighted)."""
    u1, v1 = x1[:, 0], x1[:, 1]
    u2, v2 = x2[:, 0], x2[:, 1]
    o = jnp.ones_like(u1)
    A = jnp.stack(
        [u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, o], -1
    )  # (N,9)
    if w is not None:
        A = A * w[:, None]
    _, _, vt = jnp.linalg.svd(A, full_matrices=True)
    Fpre = vt[-1].reshape(3, 3)
    u, s, vt2 = jnp.linalg.svd(Fpre)
    s = s.at[2].set(0.0)
    return (u * s[None, :]) @ vt2


def _score_h(H21, x1, x2, valid, sigma=1.0):
    """CheckHomography (TwoViewReconstruction.cc:308)."""
    H12 = jnp.linalg.inv(H21)

    def transfer(H, a, b):
        w = H[2, 0] * a[:, 0] + H[2, 1] * a[:, 1] + H[2, 2]
        inv_w = 1.0 / w
        u = (H[0, 0] * a[:, 0] + H[0, 1] * a[:, 1] + H[0, 2]) * inv_w
        v = (H[1, 0] * a[:, 0] + H[1, 1] * a[:, 1] + H[1, 2]) * inv_w
        return (b[:, 0] - u) ** 2 + (b[:, 1] - v) ** 2

    inv_s2 = 1.0 / (sigma * sigma)
    chi1 = transfer(H12, x2, x1) * inv_s2
    chi2 = transfer(H21, x1, x2) * inv_s2
    in1 = chi1 <= CHI2_H
    in2 = chi2 <= CHI2_H
    score = jnp.sum(
        jnp.where(valid & in1, CHI2_H - chi1, 0.0)
        + jnp.where(valid & in2, CHI2_H - chi2, 0.0)
    )
    return score, valid & in1 & in2


def _score_f(F21, x1, x2, valid, sigma=1.0):
    """CheckFundamental (TwoViewReconstruction.cc:393)."""
    o = jnp.ones_like(x1[:, :1])
    p1 = jnp.concatenate([x1, o], 1)
    p2 = jnp.concatenate([x2, o], 1)
    l2 = p1 @ F21.T  # epipolar line in image 2
    l1 = p2 @ F21   # line in image 1
    inv_s2 = 1.0 / (sigma * sigma)
    d2 = (jnp.sum(l2 * p2, 1) ** 2) / (l2[:, 0] ** 2 + l2[:, 1] ** 2 + 1e-12)
    d1 = (jnp.sum(l1 * p1, 1) ** 2) / (l1[:, 0] ** 2 + l1[:, 1] ** 2 + 1e-12)
    chi1 = d2 * inv_s2
    chi2 = d1 * inv_s2
    in1 = chi1 <= CHI2_F
    in2 = chi2 <= CHI2_F
    score = jnp.sum(
        jnp.where(valid & in1, CHI2_H - chi1, 0.0)
        + jnp.where(valid & in2, CHI2_H - chi2, 0.0)
    )
    return score, valid & in1 & in2


def triangulate(P1, P2, x1, x2):
    """Batched DLT triangulation (reference Triangulate, :737).

    P1/P2: (3,4) projection matrices; x1/x2: (N,2).  Returns (N,3).

    Note: the reference solves the HOMOGENEOUS system via 4x4 SVD,
    a batched iterative factorisation per keyframe event.  This solves
    the equivalent INHOMOGENEOUS system (w = 1) through the
    3x3 normal equations with a closed-form adjugate inverse: pure
    arithmetic, fuses completely.  The two differ only for points at
    infinity (w ~ 0), which every caller rejects anyway (depth,
    parallax and reprojection gates).
    """
    A0 = x1[..., 0:1] * P1[2] - P1[0]
    A1 = x1[..., 1:2] * P1[2] - P1[1]
    A2 = x2[..., 0:1] * P2[2] - P2[0]
    A3 = x2[..., 1:2] * P2[2] - P2[1]
    A = jnp.stack([A0, A1, A2, A3], -2)  # (N,4,4)
    B = A[..., :3]
    a3 = A[..., 3]
    M = jnp.einsum("...ki,...kj->...ij", B, B)
    b = -jnp.einsum("...ki,...k->...i", B, a3)
    return _solve3x3(M, b)


def _solve3x3(M, b):
    """Closed-form batched 3x3 solve via the adjugate (Cramer): no
    LAPACK-style factorization, vectorizes to pure elementwise arithmetic.
    Near-singular systems return huge values the callers' acceptance
    gates reject."""
    m00, m01, m02 = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    m10, m11, m12 = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    m20, m21, m22 = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    c00 = m11 * m22 - m12 * m21
    c01 = m12 * m20 - m10 * m22
    c02 = m10 * m21 - m11 * m20
    det = m00 * c00 + m01 * c01 + m02 * c02
    c10 = m02 * m21 - m01 * m22
    c11 = m00 * m22 - m02 * m20
    c12 = m01 * m20 - m00 * m21
    c20 = m01 * m12 - m02 * m11
    c21 = m02 * m10 - m00 * m12
    c22 = m00 * m11 - m01 * m10
    inv_det = 1.0 / jnp.where(jnp.abs(det) < 1e-20, 1e-20, det)
    x0 = (c00 * b[..., 0] + c10 * b[..., 1] + c20 * b[..., 2]) * inv_det
    x1 = (c01 * b[..., 0] + c11 * b[..., 1] + c21 * b[..., 2]) * inv_det
    x2 = (c02 * b[..., 0] + c12 * b[..., 1] + c22 * b[..., 2]) * inv_det
    return jnp.stack([x0, x1, x2], -1)


def _check_rt(R, t, x1, x2, valid, K, sigma2=1.0):
    """CheckRT (reference :801): triangulate and count good points.

    Returns (n_good, parallax_deg, good_mask, points3d_cam1).
    """
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    P1 = jnp.concatenate([K, jnp.zeros((3, 1), K.dtype)], 1)
    Rt = jnp.concatenate([R, t[:, None]], 1)
    P2 = K @ Rt
    O2 = -R.T @ t

    X = triangulate(P1, P2, x1, x2)  # cam1 frame
    finite = jnp.all(jnp.isfinite(X), -1)

    n1 = X  # vector from cam1 origin
    n2 = X - O2[None, :]
    d1 = jnp.linalg.norm(n1, axis=-1)
    d2n = jnp.linalg.norm(n2, axis=-1)
    cos_par = jnp.sum(n1 * n2, -1) / jnp.maximum(d1 * d2n, 1e-12)

    z1 = X[:, 2]
    X2 = X @ R.T + t[None, :]
    z2 = X2[:, 2]
    # Deliberate deviation from TwoViewReconstruction.cc:862-871 (which
    # admits z<=0 points when cosParallax >= 0.99998): we require positive
    # depth unconditionally.  The reference's bypass lets exactly-H-
    # consistent near-infinite points inflate nGood for the degenerate
    # Faugeras mirror motions, weakening the n_similar disambiguation;
    # strict cheirality is a strictly better discriminator.
    low_par = cos_par >= 0.99998
    depth_ok = (z1 > 0) & (z2 > 0)

    u1 = fx * X[:, 0] / X[:, 2] + cx
    v1 = fy * X[:, 1] / X[:, 2] + cy
    e1 = (u1 - x1[:, 0]) ** 2 + (v1 - x1[:, 1]) ** 2
    u2 = fx * X2[:, 0] / X2[:, 2] + cx
    v2 = fy * X2[:, 1] / X2[:, 2] + cy
    e2 = (u2 - x2[:, 0]) ** 2 + (v2 - x2[:, 1]) ** 2
    th2 = 4.0 * sigma2
    counted = valid & finite & depth_ok & (e1 <= th2) & (e2 <= th2)
    good = counted & ~low_par  # vbGood: triangulated map-point mask

    # parallax: ascending-cos sort over counted points, element
    # min(50, n-1) like the reference (the 51st-best parallax)
    cos_masked = jnp.where(counted, cos_par, 1.0)
    n_good = jnp.sum(counted.astype(jnp.int32))
    k = jnp.minimum(50, jnp.maximum(n_good - 1, 0))
    cos_sorted = jnp.sort(cos_masked)  # ascending
    cos_sel = cos_sorted[k]
    parallax = jnp.degrees(jnp.arccos(jnp.clip(cos_sel, -1.0, 1.0)))
    return n_good, parallax, good, X


def _decompose_e(E):
    """DecomposeE (reference :912): 2 rotations + t."""
    u, _, vt = jnp.linalg.svd(E)
    t = u[:, 2]
    t = t / jnp.maximum(jnp.linalg.norm(t), 1e-12)
    W = jnp.array([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], E.dtype)
    R1 = u @ W @ vt
    R1 = jnp.where(jnp.linalg.det(R1) < 0, -R1, R1)
    R2 = u @ W.T @ vt
    R2 = jnp.where(jnp.linalg.det(R2) < 0, -R2, R2)
    return R1, R2, t


def _decompose_h(H21, K):
    """Faugeras SVD-based homography decomposition (ReconstructH, :576):
    8 motion hypotheses (R, t, n)."""
    A = jnp.linalg.inv(K) @ H21 @ K
    U, w, Vt = jnp.linalg.svd(A)
    V = Vt.T
    s = jnp.linalg.det(U) * jnp.linalg.det(V)
    d1, d2, d3 = w[0], w[1], w[2]

    aux1 = jnp.sqrt(jnp.maximum((d1 * d1 - d2 * d2) / (d1 * d1 - d3 * d3), 0.0))
    aux3 = jnp.sqrt(jnp.maximum((d2 * d2 - d3 * d3) / (d1 * d1 - d3 * d3), 0.0))
    x1s = jnp.array([aux1, aux1, -aux1, -aux1])
    x3s = jnp.array([aux3, -aux3, aux3, -aux3])

    # case d' > 0
    aux_stheta = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / ((d1 + d3) * d2)
    ctheta = (d2 * d2 + d1 * d3) / ((d1 + d3) * d2)
    stheta = jnp.array([1.0, -1.0, -1.0, 1.0]) * aux_stheta

    def make_pos(i):
        Rp = jnp.eye(3, dtype=H21.dtype)
        Rp = Rp.at[0, 0].set(ctheta).at[2, 2].set(ctheta)
        Rp = Rp.at[0, 2].set(-stheta[i]).at[2, 0].set(stheta[i])
        R = s * U @ Rp @ Vt
        tp = jnp.array([x1s[i], 0.0, -x3s[i]]) * (d1 - d3)
        t = U @ tp
        return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-12)

    # case d' < 0
    aux_sphi = jnp.sqrt(
        jnp.maximum((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), 0.0)
    ) / ((d1 - d3) * d2)
    cphi = (d1 * d3 - d2 * d2) / ((d1 - d3) * d2)
    sphi = jnp.array([1.0, -1.0, -1.0, 1.0]) * aux_sphi

    def make_neg(i):
        Rp = jnp.eye(3, dtype=H21.dtype)
        Rp = Rp.at[0, 0].set(cphi).at[2, 2].set(-cphi)
        Rp = Rp.at[0, 2].set(sphi[i]).at[2, 0].set(sphi[i])
        Rp = Rp.at[1, 1].set(-1.0)
        R = s * U @ Rp @ Vt
        tp = jnp.array([x1s[i], 0.0, x3s[i]]) * (d1 + d3)
        t = U @ tp
        return R, t / jnp.maximum(jnp.linalg.norm(t), 1e-12)

    Rs, ts = [], []
    for i in range(4):
        R, t = make_pos(i)
        Rs.append(R)
        ts.append(t)
    for i in range(4):
        R, t = make_neg(i)
        Rs.append(R)
        ts.append(t)
    return jnp.stack(Rs), jnp.stack(ts)


@functools.partial(jax.jit, static_argnums=())
def reconstruct(
    key: jax.Array,
    x1: jnp.ndarray,
    x2: jnp.ndarray,
    valid: jnp.ndarray,
    K: jnp.ndarray,
    sigma: float = 1.0,
) -> TwoViewResult:
    """Full two-view init on matched (padded) keypoint pairs.

    x1/x2: (N,2) float32 pixel coords of matches; valid: (N,) mask.
    """
    x1 = x1.astype(jnp.float32)
    x2 = x2.astype(jnp.float32)
    n = x1.shape[0]
    n_valid = jnp.sum(valid.astype(jnp.int32))

    # --- minimal-set sampling: vmapped, with replacement-free 8-sets via
    # per-hypothesis random permutation keys over valid indices
    def sample(k):
        p = jax.random.uniform(k, (n,)) + (~valid) * 10.0
        return jnp.argsort(p)[:8]  # 8 distinct, valid-first

    sets = jax.vmap(sample)(jax.random.split(key, N_RANSAC))  # (200,8)

    xn1, T1 = _normalize(x1, valid)
    xn2, T2 = _normalize(x2, valid)
    T2inv = jnp.linalg.inv(T2)

    def hyp(idx):
        a = xn1[idx]
        b = xn2[idx]
        Hn = _compute_h(a, b)
        H21 = T2inv @ Hn @ T1
        Fn = _compute_f(a, b)
        F21 = T2.T @ Fn @ T1
        sh, _ = _score_h(H21, x1, x2, valid, sigma)
        sf, _ = _score_f(F21, x1, x2, valid, sigma)
        return H21, sh, F21, sf

    H_all, SH_all, F_all, SF_all = jax.vmap(hyp)(sets)
    bh = jnp.argmax(SH_all)
    bf = jnp.argmax(SF_all)
    H21, SH = H_all[bh], SH_all[bh]
    F21, SF = F_all[bf], SF_all[bf]

    RH = SH / jnp.maximum(SH + SF, 1e-9)
    use_h = RH > 0.40  # reference :94 (0.40 threshold, "more restrictive")

    _, inl_h = _score_h(H21, x1, x2, valid, sigma)
    _, inl_f = _score_f(F21, x1, x2, valid, sigma)

    # Gold-standard refit on all inliers (improvement over the reference,
    # which keeps the minimal-set model, TwoViewReconstruction.cc:127-227:
    # an 8-point F on noisy points leaves ~5-10% of true inliers outside
    # the CheckRT reprojection gate, making the 0.9*N accept threshold
    # flaky).  One masked SVD per model; strictly tighter fits.
    Hn2 = _compute_h(xn1, xn2, inl_h.astype(xn1.dtype))
    H_refit = T2inv @ Hn2 @ T1
    sh2, inl_h2 = _score_h(H_refit, x1, x2, valid, sigma)
    better_h = sh2 > SH
    H21 = jnp.where(better_h, H_refit, H21)
    inl_h = jnp.where(better_h, inl_h2, inl_h)

    Fn2 = _compute_f(xn1, xn2, inl_f.astype(xn1.dtype))
    F_refit = T2.T @ Fn2 @ T1
    sf2, inl_f2 = _score_f(F_refit, x1, x2, valid, sigma)
    better_f = sf2 > SF
    F21 = jnp.where(better_f, F_refit, F21)
    inl_f = jnp.where(better_f, inl_f2, inl_f)

    # --- motion hypotheses
    E21 = K.T @ F21 @ K
    R1, R2, t = _decompose_e(E21)
    Rs_f = jnp.stack([R1, R1, R2, R2])
    ts_f = jnp.stack([t, -t, t, -t])
    Rs_h, ts_h = _decompose_h(H21, K)

    Rs = jnp.concatenate([Rs_f, Rs_f], 0)  # pad F's 4 hypotheses to 8
    Rs = jnp.where(use_h, Rs_h, Rs)
    ts = jnp.concatenate([ts_f, ts_f], 0)
    ts = jnp.where(use_h, ts_h, ts)
    hyp_valid = jnp.where(
        use_h,
        jnp.ones((8,), bool),
        jnp.arange(8) < 4,
    )
    inliers = jnp.where(use_h, inl_h, inl_f)

    sigma2 = sigma * sigma
    check = jax.vmap(lambda R, t: _check_rt(R, t, x1, x2, inliers, jnp.asarray(K), sigma2))
    n_good, parallax, good_masks, Xs = check(Rs, ts)
    n_good = jnp.where(hyp_valid, n_good, -1)

    best = jnp.argmax(n_good)
    max_good = n_good[best]
    n_inl = jnp.sum(inliers.astype(jnp.int32))
    n_min_good = jnp.maximum(
        (0.9 * n_inl.astype(jnp.float32)).astype(jnp.int32), MIN_TRIANGULATED
    )
    n_similar = jnp.sum(
        (n_good > (0.7 * max_good.astype(jnp.float32)).astype(jnp.int32)).astype(
            jnp.int32
        )
    )
    ok = (
        (max_good >= n_min_good)
        & (n_similar == 1)
        & (parallax[best] > MIN_PARALLAX_DEG)
    )

    return TwoViewResult(
        success=ok,
        R21=Rs[best],
        t21=ts[best],
        points3d=Xs[best],
        is_triangulated=good_masks[best],
        used_homography=use_h,
    )
