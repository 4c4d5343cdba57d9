"""IMU preintegration tests vs direct numerical integration."""

import jax.numpy as jnp
import numpy as np

from extractorb.core import lie
from extractorb.imu import preintegration as pre

G = np.array([0.0, 0.0, -9.81])


def simulate(rng, T=100, dt=0.005):
    """Ground-truth trajectory + perfect IMU measurements."""
    R = np.eye(3)
    v = np.array([0.1, 0.0, 0.0])
    p = np.zeros(3)
    gyro = []
    acc = []
    Rs, vs, ps = [R.copy()], [v.copy()], [p.copy()]
    for k in range(T):
        w = np.array([0.2 * np.sin(0.01 * k), 0.1, -0.05])
        a_world = np.array([0.3 * np.cos(0.02 * k), 0.1, 0.05])
        a_body = R.T @ (a_world - G)
        gyro.append(w)
        acc.append(a_body)
        # integrate (midpoint-free Euler, same order as preintegration)
        p = p + v * dt + 0.5 * a_world * dt * dt
        v = v + a_world * dt
        R = R @ np.asarray(lie.so3_exp(jnp.asarray(w * dt)))
        Rs.append(R.copy())
        vs.append(v.copy())
        ps.append(p.copy())
    return (
        np.array(gyro, np.float32), np.array(acc, np.float32), dt,
        Rs, vs, ps,
    )


def test_preintegration_matches_integration(rng):
    gyro, acc, dt, Rs, vs, ps = simulate(rng)
    T = len(gyro)
    p = pre.integrate(
        jnp.asarray(gyro), jnp.asarray(acc),
        jnp.full((T,), dt, jnp.float32), jnp.ones(T, bool),
        jnp.zeros(6, jnp.float32),
        1e-3, 1e-2, 1e-5, 1e-4,
    )
    dT = T * dt
    # ground-truth deltas (preintegration identities)
    R1, v1, p1 = Rs[0], vs[0], ps[0]
    R2, v2, p2 = Rs[-1], vs[-1], ps[-1]
    dR_gt = R1.T @ R2
    dV_gt = R1.T @ (v2 - v1 - G * dT)
    dP_gt = R1.T @ (p2 - p1 - v1 * dT - 0.5 * G * dT * dT)
    np.testing.assert_allclose(np.asarray(p.dR), dR_gt, atol=1e-4)
    np.testing.assert_allclose(np.asarray(p.dV), dV_gt, atol=1e-3)
    np.testing.assert_allclose(np.asarray(p.dP), dP_gt, atol=1e-3)
    # residual ~ 0 at the true states
    r = pre.inertial_residual(
        p,
        jnp.asarray(R1.astype(np.float32)), jnp.asarray(p1.astype(np.float32)),
        jnp.asarray(v1.astype(np.float32)),
        jnp.asarray(R2.astype(np.float32)), jnp.asarray(p2.astype(np.float32)),
        jnp.asarray(v2.astype(np.float32)),
        jnp.zeros(6, jnp.float32),
    )
    assert np.abs(np.asarray(r)).max() < 2e-3, r


def test_bias_jacobians_first_order(rng):
    gyro, acc, dt, *_ = simulate(rng, T=50)
    T = len(gyro)
    args = (jnp.asarray(gyro), jnp.asarray(acc),
            jnp.full((T,), dt, jnp.float32), jnp.ones(T, bool))
    noise = (1e-3, 1e-2, 1e-5, 1e-4)
    b0 = jnp.zeros(6, jnp.float32)
    p0 = pre.integrate(*args, b0, *noise)
    db = jnp.asarray(rng.normal(size=6).astype(np.float32) * 1e-3)
    p1 = pre.integrate(*args, b0 + db, *noise)
    # first-order correction from p0 should match re-integration
    np.testing.assert_allclose(
        np.asarray(pre.delta_rotation(p0, b0 + db)), np.asarray(p1.dR),
        atol=5e-4,
    )
    np.testing.assert_allclose(
        np.asarray(pre.delta_velocity(p0, b0 + db)), np.asarray(p1.dV),
        atol=5e-4,
    )
    np.testing.assert_allclose(
        np.asarray(pre.delta_position(p0, b0 + db)), np.asarray(p1.dP),
        atol=5e-4,
    )


def test_covariance_psd_and_growth(rng):
    gyro, acc, dt, *_ = simulate(rng, T=50)
    T = len(gyro)
    p = pre.integrate(
        jnp.asarray(gyro), jnp.asarray(acc),
        jnp.full((T,), dt, jnp.float32), jnp.ones(T, bool),
        jnp.zeros(6, jnp.float32), 1e-3, 1e-2, 1e-5, 1e-4,
    )
    C = np.asarray(p.C, np.float64)
    eig = np.linalg.eigvalsh(0.5 * (C + C.T))
    assert eig.min() >= -1e-10
    assert np.trace(C) > 0


def test_padding_mask(rng):
    gyro, acc, dt, *_ = simulate(rng, T=50)
    T = len(gyro)
    pad = 20
    g2 = np.concatenate([gyro, np.ones((pad, 3), np.float32) * 99])
    a2 = np.concatenate([acc, np.ones((pad, 3), np.float32) * 99])
    d2 = np.concatenate([np.full(T, dt, np.float32), np.full(pad, dt, np.float32)])
    v2 = np.concatenate([np.ones(T, bool), np.zeros(pad, bool)])
    noise = (1e-3, 1e-2, 1e-5, 1e-4)
    pa = pre.integrate(
        jnp.asarray(gyro), jnp.asarray(acc),
        jnp.full(T, dt, jnp.float32), jnp.ones(T, bool),
        jnp.zeros(6, jnp.float32), *noise,
    )
    pb = pre.integrate(
        jnp.asarray(g2), jnp.asarray(a2), jnp.asarray(d2), jnp.asarray(v2),
        jnp.zeros(6, jnp.float32), *noise,
    )
    np.testing.assert_allclose(np.asarray(pa.dR), np.asarray(pb.dR), atol=1e-7)
    np.testing.assert_allclose(np.asarray(pa.dP), np.asarray(pb.dP), atol=1e-7)
    assert float(pa.dT) == float(pb.dT)
