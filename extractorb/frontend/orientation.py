"""IC_Angle keypoint orientation (intensity centroid).

Replaces ORBextractor::IC_Angle + computeOrientation (reference:
src/orb_extractor/ORBextractor.cc:75-102, :477-484) and the umax
circular-patch bounds from the ctor (:453-475).

Design: instead of a scalar loop per keypoint, all keypoints gather
their 31x31 patches in one batched gather and the circular moment sums
m01/m10 are masked reductions — one (K, 31, 31) contraction.  The angle
uses OpenCV's fastAtan2 polynomial (exactly, in float32) because the
reference's BRIEF rotation consumes that approximate angle and descriptor
parity requires reproducing it bit-for-bit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import fp

HALF_PATCH_SIZE = 15  # reference inc/ORBExtractor.h:19


def compute_umax() -> np.ndarray:
    """Circular patch bounds, exactly the reference ctor loop
    (ORBextractor.cc:453-475)."""
    hp = HALF_PATCH_SIZE
    umax = np.zeros(hp + 2, np.int64)
    vmax = int(np.floor(hp * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(hp * np.sqrt(2.0) / 2))
    hp2 = float(hp * hp)
    for v in range(vmax + 1):
        umax[v] = int(np.rint(np.sqrt(hp2 - v * v)))
    # ensure symmetry
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    return umax[: hp + 1]


_UMAX = compute_umax()


def _moment_masks() -> np.ndarray:
    """(31, 31) boolean mask of the circular patch: row v in [-15, 15],
    |u| <= umax[|v|]."""
    hp = HALF_PATCH_SIZE
    vs = np.arange(-hp, hp + 1)
    us = np.arange(-hp, hp + 1)
    mask = np.abs(us)[None, :] <= _UMAX[np.abs(vs)][:, None]
    return mask


_MASK = _moment_masks()
_WU = (np.arange(-15, 16)[None, :] * _MASK).astype(np.int32)  # u weights
_WV = (np.arange(-15, 16)[:, None] * _MASK).astype(np.int32)  # v weights


# OpenCV fastAtan2 constants (modules/core/src/mathfuncs.cpp)
_P1 = np.float32(0.9997878412794807 * (180.0 / np.pi))
_P3 = np.float32(-0.3258083974640975 * (180.0 / np.pi))
_P5 = np.float32(0.1555786518463281 * (180.0 / np.pi))
_P7 = np.float32(-0.04432655554792128 * (180.0 / np.pi))


def fast_atan2_deg(y, x):
    """cv::fastAtan2 in float32: degrees in [0, 360).

    The quotient is correctly rounded and every product is rounded on
    its own, as in the reference's scalar C++, so the angle is bitwise
    the same on every backend (frontend/fp.py)."""
    y = y.astype(jnp.float32)
    x = x.astype(jnp.float32)
    ax, ay = jnp.abs(x), jnp.abs(y)
    big = ax >= ay
    # the reference divides by (max + (float)DBL_EPSILON), which only
    # matters for max == 0, where the quotient is 0 either way
    c = fp.div_rn(jnp.where(big, ay, ax), jnp.where(big, ax, ay))
    c2 = fp.round_f32(c * c)
    a = fp.round_f32(_P7 * c2) + _P5
    a = fp.round_f32(a * c2) + _P3
    a = fp.round_f32(a * c2) + _P1
    a = fp.round_f32(a * c)
    a = jnp.where(big, a, jnp.float32(90.0) - a)
    a = jnp.where(x < 0, jnp.float32(180.0) - a, a)
    a = jnp.where(y < 0, jnp.float32(360.0) - a, a)
    return a


@functools.partial(jax.jit, static_argnums=(3,))
def gather_patches(bordered, xy, valid, patch: int = 31, border: int = 19):
    """Gather (K, patch, patch) uint8 patches centred on inner coords xy.

    Uses a vmapped dynamic_slice (contiguous 2-D block per keypoint)
    instead of pointwise fancy indexing.  Whether the contiguous slice
    still beats a plain gather on the GPU is not measured.

    Invalid slots gather from (0, 0) — harmless, masked downstream.
    """
    half = patch // 2
    x = jnp.where(valid, xy[:, 0], 0) + border - half
    y = jnp.where(valid, xy[:, 1], 0) + border - half

    def one(yy, xx):
        return jax.lax.dynamic_slice(bordered, (yy, xx), (patch, patch))

    return jax.vmap(one)(y, x)


@jax.jit
def ic_angle(bordered, xy, valid):
    """Batched IC_Angle: returns angles in degrees (K,), float32.

    Computed on the UNBLURRED image like the reference (computeOrientation
    runs before the per-level blur, ORBextractor.cc:1106 vs :1127).
    """
    # f32 contraction is exact here (products <= 2^12, sums <= 2^24);
    # HIGHEST pins full f32 operands at the call, so descriptor parity
    # does not rest on the process-global matmul precision.
    patches = gather_patches(bordered, xy, valid).astype(jnp.float32)
    m10 = jnp.einsum(
        "kij,ij->k", patches, jnp.asarray(_WU, jnp.float32),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    m01 = jnp.einsum(
        "kij,ij->k", patches, jnp.asarray(_WV, jnp.float32),
        preferred_element_type=jnp.float32,
        precision=jax.lax.Precision.HIGHEST,
    )
    return fast_atan2_deg(m01, m10)
