"""Property tests for Lie-group ops against closed forms and scipy."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.spatial.transform import Rotation as Rsp

from extractorb.core import lie

@pytest.fixture(autouse=True)
def _x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", old)


def random_w(rng, n=64, scale=2.0):
    return jnp.asarray(rng.normal(size=(n, 3)) * scale, jnp.float64)


def test_exp_matches_scipy(rng):
    w = random_w(rng)
    R = lie.so3_exp(w)
    R_sp = Rsp.from_rotvec(np.array(w)).as_matrix()
    np.testing.assert_allclose(np.asarray(R), R_sp, atol=1e-10)


def test_log_roundtrip(rng):
    w = np.asarray(random_w(rng, scale=1.0))
    # keep |w| < pi for unique log
    norm = np.linalg.norm(w, axis=-1, keepdims=True)
    w = w / np.maximum(norm, 1e-9) * np.minimum(norm, 3.0)
    R = lie.so3_exp(jnp.asarray(w))
    w2 = lie.so3_log(R)
    np.testing.assert_allclose(np.asarray(w2), w, atol=1e-7)


def test_log_small_and_near_pi():
    for theta in [1e-9, 1e-5, 3.14, np.pi - 1e-4]:
        w = np.array([[0.3, -0.5, 0.8]])
        w = w / np.linalg.norm(w) * theta
        R = lie.so3_exp(jnp.asarray(w))
        w2 = np.asarray(lie.so3_log(R))
        np.testing.assert_allclose(w2, w, atol=1e-5)


def test_right_jacobian_fd(rng):
    """J_r: Exp(w + dw) ~= Exp(w) Exp(J_r dw)."""
    w = np.asarray(random_w(rng, n=8, scale=1.0))
    dw = rng.normal(size=(8, 3)) * 1e-6
    lhs = np.asarray(lie.so3_exp(jnp.asarray(w + dw)))
    Jr = np.asarray(lie.so3_right_jacobian(jnp.asarray(w)))
    rhs = np.asarray(lie.so3_exp(jnp.asarray(w))) @ np.asarray(
        lie.so3_exp(jnp.asarray(np.einsum("nij,nj->ni", Jr, dw)))
    )
    np.testing.assert_allclose(lhs, rhs, atol=1e-10)


def test_right_jacobian_inverse(rng):
    w = random_w(rng, n=16, scale=1.5)
    J = lie.so3_right_jacobian(w)
    Jinv = lie.so3_right_jacobian_inv(w)
    eye = np.broadcast_to(np.eye(3), (16, 3, 3))
    np.testing.assert_allclose(np.asarray(J @ Jinv), eye, atol=1e-8)


def test_se3_exp_log_roundtrip(rng):
    xi = jnp.asarray(rng.normal(size=(32, 6)), jnp.float64)
    # bound rotation below pi
    phi = np.asarray(xi[:, 3:])
    n = np.linalg.norm(phi, axis=-1, keepdims=True)
    phi = phi / np.maximum(n, 1e-9) * np.minimum(n, 3.0)
    xi = jnp.concatenate([xi[:, :3], jnp.asarray(phi)], -1)
    R, t = lie.se3_exp(xi)
    xi2 = lie.se3_log(R, t)
    np.testing.assert_allclose(np.asarray(xi2), np.asarray(xi), atol=1e-7)


def test_se3_compose_inverse(rng):
    xi = jnp.asarray(rng.normal(size=(8, 6)), jnp.float64)
    R, t = lie.se3_exp(xi)
    Ri, ti = lie.se3_inverse(R, t)
    Rc, tc = lie.se3_compose(R, t, Ri, ti)
    np.testing.assert_allclose(np.asarray(Rc), np.broadcast_to(np.eye(3), (8, 3, 3)), atol=1e-10)
    np.testing.assert_allclose(np.asarray(tc), np.zeros((8, 3)), atol=1e-10)


def test_quat_roundtrip(rng):
    w = random_w(rng, n=64, scale=2.0)
    R = lie.so3_exp(w)
    q = lie.rot_to_quat(R)
    R2 = lie.quat_to_rot(q)
    np.testing.assert_allclose(np.asarray(R2), np.asarray(R), atol=1e-9)


def test_sim3_exp_sigma_zero_matches_se3(rng):
    xi6 = jnp.asarray(rng.normal(size=(16, 6)), jnp.float64)
    xi7 = jnp.concatenate([xi6, jnp.zeros((16, 1), jnp.float64)], -1)
    R7, t7, s7 = lie.sim3_exp(xi7)
    R6, t6 = lie.se3_exp(xi6)
    np.testing.assert_allclose(np.asarray(s7), np.ones(16), atol=1e-12)
    np.testing.assert_allclose(np.asarray(R7), np.asarray(R6), atol=1e-10)
    np.testing.assert_allclose(np.asarray(t7), np.asarray(t6), atol=1e-8)


def test_sim3_exp_fd_consistency(rng):
    """Exp(xi) applied to a point matches the ODE integral numerically."""
    xi = jnp.asarray(rng.normal(size=(7,)) * 0.5, jnp.float64)
    R, t, s = lie.sim3_exp(xi)
    # integrate dx/dt = sigma*x + w x x + rho from x0
    x = np.array([0.7, -0.3, 1.1])
    rho, w, sigma = np.asarray(xi[:3]), np.asarray(xi[3:6]), float(xi[6])
    N = 20000
    dt = 1.0 / N
    for _ in range(N):
        x = x + dt * (sigma * x + np.cross(w, x) + rho)
    got = np.asarray(lie.sim3_apply(R, t, s, jnp.asarray([0.7, -0.3, 1.1], jnp.float64)))
    np.testing.assert_allclose(got, x, atol=2e-3)


def test_normalize_rotation(rng):
    w = random_w(rng, n=8)
    R = np.asarray(lie.so3_exp(w)) + rng.normal(size=(8, 3, 3)) * 1e-3
    Rn = np.asarray(lie.normalize_rotation(jnp.asarray(R)))
    eye = np.broadcast_to(np.eye(3), (8, 3, 3))
    np.testing.assert_allclose(Rn @ Rn.transpose(0, 2, 1), eye, atol=1e-10)
    assert np.all(np.linalg.det(Rn) > 0.99)
