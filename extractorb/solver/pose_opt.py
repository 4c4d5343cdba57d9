"""Motion-only bundle adjustment (pose optimization).

Replaces Optimizer::PoseOptimization (reference:
src/Optimizer.cc:854-1168): one SE3 vertex, unary mono reprojection
edges with Huber(sqrt(5.991)), 4 rounds x 10 LM iterations with chi2
outlier re-classification between rounds and the robust kernel dropped
after round 3 (the reference's it==2 setRobustKernel(0)).

Design: the whole optimisation is one jit: residuals/Jacobians for
all (padded) observations come from jax.jacfwd of the projection through
a right-multiplicative se3 retraction; the 6x6 normal equations are a
masked einsum and the rounds/iterations are lax.scan — no
data-dependent control flow.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..core import lie
from .robust import CHI2_MONO, CHI2_STEREO, DELTA_MONO, DELTA_STEREO, huber_weight


class PoseOptResult(NamedTuple):
    R: jnp.ndarray         # (3,3) world->camera
    t: jnp.ndarray         # (3,)
    inliers: jnp.ndarray   # (N,) bool
    n_inliers: jnp.ndarray  # () int32


def _residuals_and_jac(R, t, pts_w, obs_uv, project, obs_ur=None, bf=0.0):
    """r_i(delta) = obs - project((R,t) * Exp(delta) applied to p).

    Returns residuals (N,2) and Jacobian (N,2,6) at delta=0; with obs_ur
    given, 3-dim stereo residuals (third component masked for mono).
    """
    stereo = obs_ur is not None

    def r_of_delta(delta, p, uv, ur):
        dR, dt = lie.se3_exp(delta)
        Rn = R @ dR
        tn = R @ dt + t
        pc = Rn @ p + tn
        duv = uv - project(pc)
        if not stereo:
            return duv
        u_r = project(pc)[0] - bf / pc[2]
        return jnp.concatenate([duv, jnp.where(ur >= 0, ur - u_r, 0.0)[None]])

    def per_obs(p, uv, ur):
        zero = jnp.zeros(6, pts_w.dtype)
        r = r_of_delta(zero, p, uv, ur)
        J = jax.jacfwd(r_of_delta)(zero, p, uv, ur)
        return r, J

    ur_arg = obs_ur if stereo else jnp.full(obs_uv.shape[0], -1.0, pts_w.dtype)
    return jax.vmap(per_obs)(pts_w, obs_uv, ur_arg)


def _residuals_only(R, t, pts_w, obs_uv, project, obs_ur=None, bf=0.0):
    """Residuals without Jacobians (cost checks only need the primal;
    the jacfwd path evaluates the projection once per tangent)."""
    pc = pts_w @ R.T + t
    duv = obs_uv - jax.vmap(project)(pc)
    if obs_ur is None:
        return duv
    u_r = jax.vmap(project)(pc)[:, 0] - bf / pc[:, 2]
    r3 = jnp.where(obs_ur >= 0, obs_ur - u_r, 0.0)
    return jnp.concatenate([duv, r3[:, None]], axis=1)


@functools.partial(jax.jit, static_argnums=(6, 7, 8, 9))
def optimize_pose(
    R0, t0, pts_w, obs_uv, inv_sigma2, valid, project,
    n_rounds: int = 4, n_iters: int = 10, bf: float = 0.0,
    obs_ur=None,
):
    """Run the reference's 4x10 robust pose optimisation.

    project: camera-frame point (3,) -> pixel (2,) (static callable).
    Returns PoseOptResult.  Invalid slots never contribute.  With obs_ur
    given (stereo), the 3-dim residual + stereo thresholds apply per obs.
    """
    if obs_ur is not None:
        chi2_th = jnp.where(obs_ur >= 0, CHI2_STEREO, CHI2_MONO)
        delta_h = jnp.where(obs_ur >= 0, DELTA_STEREO, DELTA_MONO)
    else:
        chi2_th = CHI2_MONO
        delta_h = DELTA_MONO

    # Padded (invalid) slots may hold zeros; projecting z=0 yields NaN
    # residuals/Jacobians, and NaN * 0-weight still poisons H (NaN*0=NaN).
    # Substitute a safe point so masked slots stay finite.
    safe = jnp.zeros_like(pts_w).at[:, 2].set(1.0)
    pts_w = jnp.where(valid[:, None], pts_w, safe)

    def lm_iters(carry, use_huber):
        R, t, active = carry

        def one_iter(state, _):
            R, t, lam = state
            r, J = _residuals_and_jac(R, t, pts_w, obs_uv, project, obs_ur, bf)
            chi2 = jnp.sum(r * r, -1) * inv_sigma2
            w = jnp.where(use_huber, huber_weight(chi2, delta_h), 1.0)
            w = w * inv_sigma2 * active.astype(r.dtype)
            Jw = J * w[:, None, None]
            H = jnp.einsum("nio,nij->oj", Jw, J)
            b = jnp.einsum("nio,ni->o", Jw, r)
            # Levenberg damping on the diagonal
            Hd = H + lam * jnp.diag(jnp.diag(H))
            # r = obs - pred and J = dr/ddelta, so the GN step is -H^-1 b
            delta = -jnp.linalg.solve(Hd + 1e-9 * jnp.eye(6, dtype=H.dtype), b)
            dR, dt = lie.se3_exp(delta)
            Rn = R @ dR
            tn = R @ dt + t
            # accept if cost decreased, else raise lambda (Levenberg)
            def rho_of(c2):
                d2 = delta_h * delta_h
                rho = jnp.where(
                    c2 <= d2, c2, 2.0 * delta_h * jnp.sqrt(c2) - d2
                )
                return jnp.where(use_huber, rho, c2)

            def cost(Rc, tc):
                rr = _residuals_only(Rc, tc, pts_w, obs_uv, project,
                                     obs_ur, bf)
                c2 = jnp.sum(rr * rr, -1) * inv_sigma2
                return jnp.sum(jnp.where(active, rho_of(c2), 0.0))

            # current-state cost from this iteration's own residuals
            c_old = jnp.sum(jnp.where(active, rho_of(chi2), 0.0))
            c_new = cost(Rn, tn)
            better = c_new < c_old
            R_out = jnp.where(better, Rn, R)
            t_out = jnp.where(better, tn, t)
            lam_out = jnp.where(better, lam * 0.5, lam * 4.0)
            return (R_out, t_out, lam_out), None

        (R, t, _), _ = jax.lax.scan(
            one_iter, (R, t, jnp.asarray(1e-3, R.dtype)), None, length=n_iters
        )
        # outlier re-classification for the next round
        r = _residuals_only(R, t, pts_w, obs_uv, project, obs_ur, bf)
        chi2 = jnp.sum(r * r, -1) * inv_sigma2
        active = valid & (chi2 <= chi2_th)
        return (R, t, active), None

    state = (R0, t0, valid)
    # rounds 1-3 with Huber, round 4 without (reference drops the kernel
    # after round 3)
    for rnd in range(n_rounds):
        use_huber = jnp.asarray(rnd < 3)
        state, _ = lm_iters(state, use_huber)
    R, t, active = state
    # Project back onto SO(3): the multiplicative updates preserve any
    # input non-orthonormality and add f32 roundoff; downstream the
    # device-chained motion prediction uses R.T as R^-1, which squares
    # residual distortion every frame (exponential blow-up over a
    # sequence) unless each program output is re-orthonormalized.
    R = lie.orthonormalize(R)
    return PoseOptResult(
        R=R, t=t, inliers=active, n_inliers=jnp.sum(active.astype(jnp.int32))
    )
