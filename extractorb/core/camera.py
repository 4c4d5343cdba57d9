"""Camera models: Pinhole and Kannala-Brandt 8-parameter fisheye.

Array-first redesign of the reference's GeometricCamera hierarchy
(inc/CameraModels/GeometricCamera.h:37, src/CameraModels/Pinhole.cpp,
src/CameraModels/KannalaBrandt8.cpp).  Instead of virtual dispatch, each
model is a frozen pytree dataclass with pure project/unproject functions;
all functions broadcast over leading batch dims and are differentiable
(Jacobians via jax.jacfwd replace the hand-written projectJac).

KB8 unprojection uses a fixed-iteration Newton solve on theta
(reference iterates 10 times with 1e-6 early-exit,
KannalaBrandt8.cpp:103-160; we run a static 10 iterations — identical
fixed point, shape-static for jit).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from ..config import CameraConfig


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Pinhole:
    """Pinhole intrinsics; radial-tangential distortion handled separately
    at keypoint-undistortion time (as in the reference, Frame.cc:748)."""

    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray

    @staticmethod
    def from_config(c: CameraConfig) -> "Pinhole":
        f = lambda v: jnp.asarray(v, jnp.float32)
        return Pinhole(f(c.fx), f(c.fy), f(c.cx), f(c.cy))

    def K(self):
        z = jnp.zeros_like(self.fx)
        o = jnp.ones_like(self.fx)
        return jnp.stack(
            [
                jnp.stack([self.fx, z, self.cx], -1),
                jnp.stack([z, self.fy, self.cy], -1),
                jnp.stack([z, z, o], -1),
            ],
            -2,
        )

    def project(self, p3d):
        """Camera-frame points (...,3) -> pixels (...,2)."""
        z = p3d[..., 2]
        inv_z = 1.0 / z
        return jnp.stack(
            [
                self.fx * p3d[..., 0] * inv_z + self.cx,
                self.fy * p3d[..., 1] * inv_z + self.cy,
            ],
            -1,
        )

    def unproject(self, uv):
        """Pixels (...,2) -> unit-depth rays (...,3)."""
        x = (uv[..., 0] - self.cx) / self.fx
        y = (uv[..., 1] - self.cy) / self.fy
        return jnp.stack([x, y, jnp.ones_like(x)], -1)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class KannalaBrandt8:
    """KB8 fisheye: r(theta) = theta + k1 th^3 + k2 th^5 + k3 th^7 + k4 th^9
    (reference: KannalaBrandt8.cpp:28-56 project, :103-160 unproject)."""

    fx: jnp.ndarray
    fy: jnp.ndarray
    cx: jnp.ndarray
    cy: jnp.ndarray
    k: jnp.ndarray  # (4,)

    newton_iters: int = dataclasses.field(default=10, metadata=dict(static=True))

    @staticmethod
    def from_config(c: CameraConfig) -> "KannalaBrandt8":
        f = lambda v: jnp.asarray(v, jnp.float32)
        return KannalaBrandt8(
            f(c.fx), f(c.fy), f(c.cx), f(c.cy),
            jnp.asarray([c.k1, c.k2, c.k3, c.k4], jnp.float32),
        )

    def K(self):
        z = jnp.zeros_like(self.fx)
        o = jnp.ones_like(self.fx)
        return jnp.stack(
            [
                jnp.stack([self.fx, z, self.cx], -1),
                jnp.stack([z, self.fy, self.cy], -1),
                jnp.stack([z, z, o], -1),
            ],
            -2,
        )

    def _theta_to_r(self, theta):
        t2 = theta * theta
        k = self.k
        return theta * (1.0 + t2 * (k[0] + t2 * (k[1] + t2 * (k[2] + t2 * k[3]))))

    def project(self, p3d):
        x, y, z = p3d[..., 0], p3d[..., 1], p3d[..., 2]
        r2 = x * x + y * y
        r = jnp.sqrt(r2)
        theta = jnp.arctan2(r, z)
        d = self._theta_to_r(theta)
        safe_r = jnp.where(r < 1e-8, 1.0, r)
        scale = jnp.where(r < 1e-8, 0.0, d / safe_r)
        return jnp.stack(
            [self.fx * scale * x + self.cx, self.fy * scale * y + self.cy], -1
        )

    def unproject(self, uv):
        """Invert the distortion with a static-count Newton iteration."""
        wx = (uv[..., 0] - self.cx) / self.fx
        wy = (uv[..., 1] - self.cy) / self.fy
        r_d = jnp.sqrt(wx * wx + wy * wy)
        r_d = jnp.minimum(r_d, jnp.pi)  # clamp like the reference

        k = self.k

        def body(_, theta):
            t2 = theta * theta
            t4, t6, t8 = t2 * t2, t2 * t2 * t2, t2 * t2 * t2 * t2
            f = theta * (1 + k[0] * t2 + k[1] * t4 + k[2] * t6 + k[3] * t8) - r_d
            fp = 1 + 3 * k[0] * t2 + 5 * k[1] * t4 + 7 * k[2] * t6 + 9 * k[3] * t8
            return theta - f / jnp.where(jnp.abs(fp) < 1e-8, 1.0, fp)

        theta = jax.lax.fori_loop(0, self.newton_iters, body, r_d)
        safe_rd = jnp.where(r_d < 1e-8, 1.0, r_d)
        # Return a unit bearing (sin(th)*x/r, sin(th)*y/r, cos(th)) rather
        # than a z=1 homogeneous point: fisheye FOVs exceed 180 deg, so
        # theta may pass pi/2 where tan(theta) flips sign and a z=1
        # parameterisation cannot represent the ray.
        s = jnp.where(r_d < 1e-8, 1.0, jnp.sin(theta) / safe_rd)
        return jnp.stack([wx * s, wy * s, jnp.cos(theta)], -1)


def undistort_points_pinhole(uv, cam: Pinhole, dist):
    """Undistort pixel coords with radial-tangential (k1,k2,p1,p2,k3).

    Replaces cv::undistortPoints as used in Frame::UndistortKeyPoints
    (Frame.cc:748-782).  Iterative compensation (8 fixed iterations, the
    OpenCV default count), then re-projection through K.
    """
    k1, k2, p1, p2, k3 = (dist[i] for i in range(5))
    x0 = (uv[..., 0] - cam.cx) / cam.fx
    y0 = (uv[..., 1] - cam.cy) / cam.fy

    def body(_, xy):
        x, y = xy
        r2 = x * x + y * y
        icdist = 1.0 / (1.0 + r2 * (k1 + r2 * (k2 + r2 * k3)))
        dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
        dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
        return ((x0 - dx) * icdist, (y0 - dy) * icdist)

    x, y = jax.lax.fori_loop(0, 8, body, (x0, y0))
    return jnp.stack([x * cam.fx + cam.cx, y * cam.fy + cam.cy], -1)


def triangulate_matches(
    cam_l,
    cam_r,
    uv_l,
    uv_r,
    R_rl,
    t_rl,
    sigma2_l,
    sigma2_r,
    min_parallax_cos: float = 0.9998,
    chi2: float = 5.991,
):
    """Batched two-view triangulation with parallax and chi2 gating.

    Replaces KannalaBrandt8::TriangulateMatches
    (src/CameraModels/KannalaBrandt8.cpp:336-438): unproject both
    keypoints to bearing rays, reject low-parallax pairs
    (cos > 0.9998), mid-point/DLT triangulate against the relative pose
    [R_rl|t_rl] (left-camera coords -> right-camera coords), require
    positive depth in both views and reprojection error below
    chi2 * sigma2 in each image.

    Design: the reference solves one 4x4 SVD per match inside a
    loop; here every match is one row of a batched (N,4,4) SVD, and the
    DLT rows are written against the unit bearings (b x P p = 0) so rays
    beyond 90 deg off-axis remain representable.

    Returns (p3d_left (N,3), depth_left (N,), valid (N,)).
    """
    b1 = cam_l.unproject(uv_l)  # (N,3) unit bearings, left cam
    b2 = cam_r.unproject(uv_r)
    b2_in_l = b2 @ R_rl  # R_lr = R_rl^T; rotate right bearings into left
    cos_par = jnp.sum(b1 * b2_in_l, axis=-1)
    parallax_ok = cos_par < min_parallax_cos

    # DLT rows: for bearing b and projection P (3x4), b x (P p) = 0
    # gives two independent rows  b_z P_0 - b_x P_2  and  b_z P_1 - b_y P_2.
    P1 = jnp.concatenate([jnp.eye(3), jnp.zeros((3, 1))], axis=1)  # left = identity
    P2 = jnp.concatenate([R_rl, t_rl[:, None]], axis=1)  # (3,4)

    def rows(b, P):
        return jnp.stack(
            [
                b[..., 2:3] * P[0] - b[..., 0:1] * P[2],
                b[..., 2:3] * P[1] - b[..., 1:2] * P[2],
            ],
            axis=-2,
        )

    A = jnp.concatenate([rows(b1, P1), rows(b2, P2)], axis=-2)  # (N,4,4)
    _, _, vt = jnp.linalg.svd(A)
    hp = vt[..., 3, :]  # (N,4) homogeneous solution
    w = hp[..., 3]
    safe_w = jnp.where(jnp.abs(w) < 1e-12, 1.0, w)
    p3d = hp[..., :3] / safe_w[..., None]  # left-camera coords
    # Depth along each bearing (not raw z: fisheye rays can pass 90 deg).
    z1 = jnp.sum(p3d * b1, axis=-1)
    p3d_r = p3d @ R_rl.T + t_rl
    z2 = jnp.sum(p3d_r * b2, axis=-1)
    depth_ok = (z1 > 0) & (z2 > 0) & (jnp.abs(w) > 1e-12)

    uv1_hat = cam_l.project(p3d)
    uv2_hat = cam_r.project(p3d_r)
    e1 = jnp.sum((uv1_hat - uv_l) ** 2, axis=-1)
    e2 = jnp.sum((uv2_hat - uv_r) ** 2, axis=-1)
    reproj_ok = (e1 <= chi2 * sigma2_l) & (e2 <= chi2 * sigma2_r)

    valid = parallax_ok & depth_ok & reproj_ok
    depth = p3d[..., 2]
    return p3d, jnp.where(valid, depth, -1.0), valid


def distort_points_pinhole(xy_norm, dist):
    """Apply radial-tangential distortion to normalised coords (...,2)."""
    k1, k2, p1, p2, k3 = (dist[i] for i in range(5))
    x, y = xy_norm[..., 0], xy_norm[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    dx = 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    dy = p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return jnp.stack([x * radial + dx, y * radial + dy], -1)
