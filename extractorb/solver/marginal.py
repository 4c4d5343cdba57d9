"""Dense Hessian-block Schur utilities.

Replaces Optimizer::Marginalize / Condition / Sparsify (reference:
src/Optimizer.cc:5026, :5108, :5128) — the marginalization toolbox the
inertial optimizers use to turn a solved window's Hessian into a prior
on the surviving states (ConstraintPoseImu / EdgePriorPoseImu).

Design: the reference reorders blocks with Eigen::block copies and a
JacobiSVD pseudo-inverse; here the reorder is an index permutation and
the pseudo-inverse is one jnp.linalg SVD — jittable for fixed
(start, end), so a marginalization inside a solver loop fuses with it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp


@functools.partial(jax.jit, static_argnums=(1, 2))
def marginalize(H: jnp.ndarray, start: int, end: int) -> jnp.ndarray:
    """Schur-complement marginalization of the [start..end] block
    (inclusive), SVD pseudo-inverse with the reference's 1e-6 singular
    value cutoff.  Rows/cols of the marginalized block come back zero.
    """
    n = H.shape[0]
    a = start
    b = end - start + 1
    keep = jnp.concatenate(
        [jnp.arange(0, a), jnp.arange(end + 1, n)]
    ).astype(jnp.int32)
    marg = jnp.arange(a, end + 1, dtype=jnp.int32)

    Haa = H[jnp.ix_(keep, keep)]
    Hab = H[jnp.ix_(keep, marg)]
    Hba = H[jnp.ix_(marg, keep)]
    Hbb = H[jnp.ix_(marg, marg)]

    U, s, Vt = jnp.linalg.svd(Hbb)
    s_inv = jnp.where(s > 1e-6, 1.0 / jnp.where(s > 1e-6, s, 1.0), 0.0)
    Hbb_pinv = (Vt.T * s_inv[None, :]) @ U.T
    Haa_new = Haa - Hab @ Hbb_pinv @ Hba

    out = jnp.zeros_like(H)
    out = out.at[jnp.ix_(keep, keep)].set(Haa_new)
    return out


@functools.partial(jax.jit, static_argnums=(1, 2))
def condition(H: jnp.ndarray, start: int, end: int) -> jnp.ndarray:
    """Zero all rows/cols of the [start..end] block (reference
    Optimizer::Condition, :5108): drops the block's information without
    transferring it (vs marginalize, which transfers it via Schur)."""
    n = H.shape[0]
    idx = jnp.arange(n)
    in_blk = (idx >= start) & (idx <= end)
    mask = ~(in_blk[:, None] | in_blk[None, :])
    return jnp.where(mask, H, 0.0)


def sparsify(H: jnp.ndarray, start1: int, end1: int,
             start2: int, end2: int) -> jnp.ndarray:
    """Remove the information link between blocks 1 and 2 (reference
    Optimizer::Sparsify, :5128):  H' = marg(H, blk2) + marg(H, blk1)
    - marg(marg(H, blk2), blk1)."""
    Hac = marginalize(H, start2, end2)
    Hbc = marginalize(H, start1, end1)
    Hc = marginalize(Hac, start1, end1)
    return Hac + Hbc - Hc
