"""Camera model tests: roundtrips + parity with cv2 fisheye/undistort."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from extractorb.config import CameraConfig
from extractorb.core.camera import (
    KannalaBrandt8,
    Pinhole,
    distort_points_pinhole,
    undistort_points_pinhole,
)

@pytest.fixture(autouse=True)
def _x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)

# TUM-VI 512 fisheye calibration hard-coded in the reference matcher demo
# (src/matcher/main_matcher.cpp:95-100).
TUMVI = CameraConfig(
    model="KannalaBrandt8",
    fx=190.978477, fy=190.973307, cx=254.931706, cy=256.897442,
    k1=0.003482389402, k2=0.000715034845, k3=-0.002053236141, k4=0.000202936736,
    width=512, height=512,
)

FR1 = CameraConfig(  # TUM fr1 pinhole
    fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
    k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314,
)


def test_pinhole_roundtrip(rng):
    cam = Pinhole.from_config(FR1)
    p = jnp.asarray(rng.uniform(-1, 1, size=(100, 3)) * [2, 2, 0] + [0, 0, 3])
    uv = cam.project(p)
    rays = cam.unproject(uv)
    # rays scaled by depth should recover points
    rec = rays * p[:, 2:3]
    np.testing.assert_allclose(np.asarray(rec), np.asarray(p), atol=1e-6)


def test_kb8_project_matches_cv2_fisheye(rng):
    cam = KannalaBrandt8.from_config(TUMVI)
    pts = rng.uniform(-1, 1, size=(200, 3)) * [1.5, 1.5, 0] + [0, 0, 2.5]
    uv = np.asarray(cam.project(jnp.asarray(pts)))
    K = np.array([[TUMVI.fx, 0, TUMVI.cx], [0, TUMVI.fy, TUMVI.cy], [0, 0, 1]])
    D = np.array([TUMVI.k1, TUMVI.k2, TUMVI.k3, TUMVI.k4])
    uv_cv, _ = cv2.fisheye.projectPoints(
        pts.reshape(-1, 1, 3), np.zeros(3), np.zeros(3), K, D
    )
    np.testing.assert_allclose(uv, uv_cv.reshape(-1, 2), atol=1e-3)


def test_kb8_unproject_roundtrip(rng):
    cam = KannalaBrandt8.from_config(TUMVI)
    uv = jnp.asarray(rng.uniform(40, 470, size=(500, 2)))
    rays = cam.unproject(uv)
    uv2 = cam.project(rays)
    np.testing.assert_allclose(np.asarray(uv2), np.asarray(uv), atol=1e-3)


def test_undistort_matches_cv2(rng):
    cam = Pinhole.from_config(FR1)
    dist = jnp.asarray([FR1.k1, FR1.k2, FR1.p1, FR1.p2, FR1.k3])
    uv = rng.uniform(50, 590, size=(300, 2))
    uv = uv * [1, 480 / 640.0]
    got = np.asarray(undistort_points_pinhole(jnp.asarray(uv), cam, dist))
    K = np.array([[FR1.fx, 0, FR1.cx], [0, FR1.fy, FR1.cy], [0, 0, 1]])
    D = np.array([FR1.k1, FR1.k2, FR1.p1, FR1.p2, FR1.k3])
    exp = cv2.undistortPoints(uv.reshape(-1, 1, 2).astype(np.float64), K, D, P=K)
    np.testing.assert_allclose(got, exp.reshape(-1, 2), atol=2e-2)


def test_distort_undistort_roundtrip(rng):
    cam = Pinhole.from_config(FR1)
    dist = jnp.asarray([FR1.k1, FR1.k2, FR1.p1, FR1.p2, FR1.k3])
    xy = jnp.asarray(rng.uniform(-0.4, 0.4, size=(200, 2)))
    uv_dist = distort_points_pinhole(xy, dist)
    uv_pix = jnp.stack(
        [uv_dist[:, 0] * cam.fx + cam.cx, uv_dist[:, 1] * cam.fy + cam.cy], -1
    )
    uv_undist = undistort_points_pinhole(uv_pix, cam, dist)
    xy2 = jnp.stack(
        [(uv_undist[:, 0] - cam.cx) / cam.fx, (uv_undist[:, 1] - cam.cy) / cam.fy], -1
    )
    np.testing.assert_allclose(np.asarray(xy2), np.asarray(xy), atol=1e-6)


def test_project_jacobian_finite_diff(rng):
    cam = Pinhole.from_config(FR1)
    p = jnp.asarray([0.3, -0.2, 2.0], jnp.float64)
    J = jax.jacfwd(cam.project)(p)
    eps = 1e-6
    for i in range(3):
        d = np.zeros(3); d[i] = eps
        fd = (np.asarray(cam.project(p + jnp.asarray(d))) - np.asarray(cam.project(p))) / eps
        np.testing.assert_allclose(np.asarray(J)[:, i], fd, atol=1e-4)
