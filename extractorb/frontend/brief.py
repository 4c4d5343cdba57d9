"""Rotated-BRIEF 256-bit descriptors.

Replaces ORBextractor::computeOrbDescriptor (reference:
src/orb_extractor/ORBextractor.cc:106-145) and computeDescriptors
(:1069-1076).  The 512-point sampling pattern is OpenCV's public
bit_pattern_31_ constant (shipped as data/orb_pattern.npy; same values as
inc/pattern.h:11 / OpenCV orb.cpp).

Design: one batched gather of 512 rotated samples per keypoint from
the blurred level image, then 256 pairwise compares packed into uint8[32]
for the bit-plane Hamming matcher.  The rotation uses the
fastAtan2 angle in degrees and cvRound (round-half-even), matching the
reference's GET_VALUE arithmetic in float32.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

from . import fp

_PATTERN = np.load(
    os.path.join(os.path.dirname(__file__), "..", "data", "orb_pattern.npy")
).astype(np.float32)  # (256, 4): x0 y0 x1 y1 per pair

# 512-point order used by the reference: pattern[2i], pattern[2i+1] are
# the pair compared for bit i.
_PX = _PATTERN[:, [0, 2]].reshape(-1)
_PY = _PATTERN[:, [1, 3]].reshape(-1)

_DEG2RAD = np.float32(np.pi / 180.0)


@jax.jit
def compute_descriptors(blurred_bordered, xy, angles_deg, valid, border: int = 19):
    """(K,) keypoints -> (K, 256) bool descriptor bits.

    blurred_bordered: uint8 (H+2b, W+2b) with the inner region blurred
    (see blur.blur_level).  xy: (K, 2) int32 inner coords.  angles_deg:
    (K,) float32 from ic_angle.
    """
    angle = angles_deg.astype(jnp.float32) * _DEG2RAD
    # float32 a = cos(angle), b = sin(angle) like the reference, from an
    # implementation that rounds the same on every backend (frontend/fp.py)
    b, a = fp.sincos(angle)

    px = jnp.asarray(_PX)  # (512,)
    py = jnp.asarray(_PY)

    # GET_VALUE: row offset = round(px*b + py*a), col = round(px*a - py*b),
    # each product rounded on its own as in the reference's C++
    r = fp.round_f32
    dy = jnp.rint(r(px[None, :] * b[:, None]) + r(py[None, :] * a[:, None])).astype(jnp.int32)
    dx = jnp.rint(r(px[None, :] * a[:, None]) - r(py[None, :] * b[:, None])).astype(jnp.int32)

    # Rotated pattern points stay within radius 18.4 (max over OpenCV's
    # bit_pattern_31_), so a 37x37 patch per keypoint covers every sample,
    # fetched as one vmapped contiguous dynamic_slice.
    PR = 18  # patch radius
    PS = 2 * PR + 1
    y0 = jnp.where(valid, xy[:, 1], 0) + border - PR
    x0 = jnp.where(valid, xy[:, 0], 0) + border - PR

    def one(yy, xx):
        return jax.lax.dynamic_slice(blurred_bordered, (yy, xx), (PS, PS))

    patches = jax.vmap(one)(y0, x0).astype(jnp.bfloat16)  # (K, 37, 37)
    dyc = jnp.clip(dy, -PR, PR)
    dxc = jnp.clip(dx, -PR, PR)
    # The per-sample patch lookup is expressed as SEPARABLE one-hot
    # contractions (row-select then column-select) instead of K*512
    # irregular gathers; whether that still pays on the GPU is an open
    # question.  Each contraction has exactly one nonzero term per
    # output, an integer <= 255, and bf16 holds every integer <= 256
    # exactly, so the bf16 operands and accumulator are exact.
    rows = jnp.arange(PS, dtype=jnp.int32)
    A = ((dyc + PR)[:, :, None] == rows[None, None, :]).astype(jnp.bfloat16)
    B = ((dxc + PR)[:, :, None] == rows[None, None, :]).astype(jnp.bfloat16)
    rowsel = jnp.einsum(
        "ksr,krc->ksc", A, patches, preferred_element_type=jnp.bfloat16
    )
    samples = jnp.einsum(
        "ksc,ksc->ks", rowsel, B, preferred_element_type=jnp.float32
    ).astype(jnp.int32)

    t0 = samples[:, 0::2]
    t1 = samples[:, 1::2]
    return t0 < t1  # (K, 256) bool; bit i of byte i//8 at position i%8


@jax.jit
def pack_bits_u8(bits):
    """(K, 256) bool -> (K, 32) uint8 with the reference's bit order
    (val |= (t0 < t1) << bit_in_byte)."""
    K = bits.shape[0]
    b = bits.reshape(K, 32, 8).astype(jnp.uint8)
    weights = jnp.asarray([1 << j for j in range(8)], jnp.uint8)  # bit j -> 2^j
    return jnp.sum(b * weights[None, None, :], axis=-1).astype(jnp.uint8)
