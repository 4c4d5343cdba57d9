"""Two-view reconstruction tests on synthetic geometry."""

import jax
import jax.numpy as jnp
import numpy as np

from extractorb.core import lie
from extractorb.geometry import two_view as tv


def make_scene(rng, n=300, noise=0.5, planar=False, n_out=30):
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)
    if planar:
        pts = np.stack(
            [rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), np.full(n, 4.0)], -1
        )
    else:
        pts = np.stack(
            [rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
             rng.uniform(3, 8, n)], -1
        )
    w = np.array([0.02, -0.03, 0.01])
    R = np.asarray(lie.so3_exp(jnp.asarray(w)))
    t = np.array([0.3, 0.02, 0.01])

    def project(P, Rm, tm):
        pc = P @ Rm.T + tm
        uv = pc @ K.T
        return uv[:, :2] / uv[:, 2:]

    x1 = project(pts, np.eye(3), np.zeros(3)) + rng.normal(size=(n, 2)) * noise
    x2 = project(pts, R, t) + rng.normal(size=(n, 2)) * noise
    # outliers
    idx = rng.choice(n, n_out, replace=False)
    x2[idx] = rng.uniform(0, 640, size=(n_out, 2))
    inlier_mask = np.ones(n, bool)
    inlier_mask[idx] = False
    return K, R, t, x1, x2, pts, inlier_mask


def run(rng, planar, seed=0):
    K, R, t, x1, x2, pts, inliers = make_scene(rng, planar=planar)
    res = tv.reconstruct(
        jax.random.PRNGKey(seed),
        jnp.asarray(x1), jnp.asarray(x2),
        jnp.ones(len(x1), bool), jnp.asarray(K),
    )
    return K, R, t, res, inliers


def test_general_scene_pose(rng):
    K, R, t, res, inliers = run(rng, planar=False)
    assert bool(res.success)
    assert not bool(res.used_homography)
    R_err = np.asarray(lie.so3_log(jnp.asarray(np.asarray(res.R21) @ R.T)))
    assert np.linalg.norm(R_err) < 0.01, R_err
    t_est = np.asarray(res.t21)
    t_dir = t / np.linalg.norm(t)
    assert abs(abs(t_est @ t_dir) - 1.0) < 0.01
    # triangulated set should be mostly inliers
    tri = np.asarray(res.is_triangulated)
    assert tri.sum() > 0.8 * inliers.sum()
    assert (tri & ~inliers).sum() <= 3


def test_planar_scene_uses_homography(rng):
    K, R, t, res, inliers = run(rng, planar=True)
    assert bool(res.used_homography)
    assert bool(res.success)
    R_err = np.asarray(lie.so3_log(jnp.asarray(np.asarray(res.R21) @ R.T)))
    assert np.linalg.norm(R_err) < 0.02, R_err


def test_degenerate_rejected(rng):
    # pure rotation (no parallax) must not "succeed"
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)
    n = 200
    pts = np.stack(
        [rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)], -1
    )
    w = np.array([0.0, 0.05, 0.0])
    R = np.asarray(lie.so3_exp(jnp.asarray(w)))
    uv1 = pts @ K.T
    x1 = uv1[:, :2] / uv1[:, 2:]
    pc2 = pts @ R.T
    uv2 = pc2 @ K.T
    x2 = uv2[:, :2] / uv2[:, 2:]
    res = tv.reconstruct(
        jax.random.PRNGKey(0), jnp.asarray(x1.astype(np.float32)),
        jnp.asarray(x2.astype(np.float32)), jnp.ones(n, bool), jnp.asarray(K),
    )
    assert not bool(res.success)


def test_triangulate_exact():
    K = np.array([[500.0, 0, 320], [0, 500, 240], [0, 0, 1]], np.float32)
    P1 = np.concatenate([K, np.zeros((3, 1), np.float32)], 1)
    R = np.eye(3, dtype=np.float32)
    t = np.array([0.5, 0, 0], np.float32)
    P2 = K @ np.concatenate([R, t[:, None]], 1)
    pts = np.array([[0.3, -0.2, 4.0], [1.0, 0.5, 6.0]], np.float32)
    x1 = (pts @ K.T)
    x1 = x1[:, :2] / x1[:, 2:]
    pc2 = pts + t
    x2 = pc2 @ K.T
    x2 = x2[:, :2] / x2[:, 2:]
    X = np.asarray(tv.triangulate(jnp.asarray(P1), jnp.asarray(P2),
                                  jnp.asarray(x1), jnp.asarray(x2)))
    np.testing.assert_allclose(X, pts, atol=1e-3)
