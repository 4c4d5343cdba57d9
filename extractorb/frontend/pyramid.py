"""Image pyramid with bit-exact OpenCV INTER_LINEAR semantics.

Replaces ORBextractor::ComputePyramid (reference:
src/orb_extractor/ORBextractor.cc:1164-1219): level L is resized from
level L-1 with cv::INTER_LINEAR to cvRound(w0*invScale[L]) and padded
with a 19-px BORDER_REFLECT_101 border (EDGE_THRESHOLD).

Design: OpenCV's fixed-point bilinear (11-bit weights, the uchar
specialisation of VResizeLinear) is reproduced exactly, with the
horizontal pass expressed as a matrix product (the interpolation matrix
is constant per shape pair) followed by exact int32 shift/round
arithmetic.  Products are <= 2^19 so the f32 accumulation is exact, as
long as the product runs at full f32 precision (not TF32 or bf16
passes): the call asks for ``Precision.HIGHEST`` itself.

Pyramid levels have different static shapes; the per-level functions are
jitted separately and the whole pyramid is wrapped by the extractor.
"""

from __future__ import annotations

import functools
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

EDGE_THRESHOLD = 19  # reference inc/ORBExtractor.h:20
_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS  # 2048


def cv_round(x):
    """OpenCV cvRound = round-half-to-even (banker's rounding)."""
    return np.rint(x).astype(np.int64)


def pyramid_sizes(w0: int, h0: int, n_levels: int, scale_factor: float) -> List[Tuple[int, int]]:
    """Per-level (w, h), using cvRound(dim * invScale) like the reference."""
    # reference: invScale[l] = 1/scale^l applied to the level-0 dims
    inv_acc = [1.0 / (scale_factor ** l) for l in range(n_levels)]
    return [(int(cv_round(w0 * s)), int(cv_round(h0 * s))) for s in inv_acc]


def _interp_tables(src: int, dst: int):
    """OpenCV resize INTER_LINEAR offsets + 11-bit fixed-point weights."""
    # Bit-exactness requires OpenCV's float32 weight math: fx is computed
    # in double then CAST TO FLOAT32 before the fractional split, and the
    # 2048-scale products are float32 (resize.cpp).
    scale = src / dst
    dx = np.arange(dst)
    fx = ((dx + 0.5) * scale - 0.5).astype(np.float32)
    sx = np.floor(fx).astype(np.int64)
    fx = (fx - sx).astype(np.float32)
    # boundary clamps (resize.cpp)
    low = sx < 0
    fx[low] = 0.0
    sx[low] = 0
    high = sx >= src - 1
    fx[high] = 0.0
    sx[high] = src - 1
    csc = np.float32(_COEF_SCALE)
    a0 = cv_round(((np.float32(1.0) - fx) * csc).astype(np.float32)).astype(np.int32)
    a1 = cv_round((fx * csc).astype(np.float32)).astype(np.int32)
    s1 = np.minimum(sx + 1, src - 1)
    return sx, s1, a0, a1


def _interp_matrix(src: int, dst: int) -> np.ndarray:
    """(src, dst) dense matrix with the two fixed-point weights per column."""
    sx, s1, a0, a1 = _interp_tables(src, dst)
    M = np.zeros((src, dst), np.float32)
    M[sx, np.arange(dst)] += a0
    M[s1, np.arange(dst)] += a1
    return M


@functools.partial(jax.jit, static_argnums=(1, 2))
def _resize_u8(img: jnp.ndarray, dst_w: int, dst_h: int) -> jnp.ndarray:
    """Bit-exact cv2.resize(img, (dst_w, dst_h), INTER_LINEAR) for uint8."""
    src_h, src_w = img.shape
    Mx = jnp.asarray(_interp_matrix(src_w, dst_w))  # (src_w, dst_w)
    _, _, b0, b1 = _interp_tables(src_h, dst_h)
    sy0, sy1, _, _ = _interp_tables(src_h, dst_h)

    # Horizontal pass: exact int sums in f32 (products <= 2^19), which
    # needs full-precision f32 operands (11-bit weights exceed TF32/bf16).
    S = jnp.dot(img.astype(jnp.float32), Mx, preferred_element_type=jnp.float32,
                precision=jax.lax.Precision.HIGHEST)
    S = S.astype(jnp.int32)  # exact

    # Vertical pass: uchar specialisation of VResizeLinear (resize.cpp):
    # D = (((b0*(S0>>4))>>16) + ((b1*(S1>>4))>>16) + 2) >> 2
    S4 = S >> 4
    T0 = S4[jnp.asarray(sy0)] * jnp.asarray(b0)[:, None]
    T1 = S4[jnp.asarray(sy1)] * jnp.asarray(b1)[:, None]
    out = ((T0 >> 16) + (T1 >> 16) + 2) >> 2
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


def _reflect101_indices(n: int, border: int) -> np.ndarray:
    """Index map implementing BORDER_REFLECT_101: gfedcb|abcdefgh|gfedcba."""
    idx = np.arange(-border, n + border)
    # reflect without repeating the edge pixel
    period = 2 * (n - 1) if n > 1 else 1
    idx = np.abs(idx) % period
    idx = np.where(idx >= n, period - idx, idx)
    return idx.astype(np.int64)


@functools.partial(jax.jit, static_argnums=(1,))
def add_border_reflect101(img: jnp.ndarray, border: int = EDGE_THRESHOLD) -> jnp.ndarray:
    """copyMakeBorder(..., BORDER_REFLECT_101) equivalent."""
    h, w = img.shape
    ry = jnp.asarray(_reflect101_indices(h, border))
    rx = jnp.asarray(_reflect101_indices(w, border))
    return img[ry][:, rx]


def compute_pyramid(
    img: jnp.ndarray, n_levels: int, scale_factor: float
) -> List[jnp.ndarray]:
    """Full pyramid; returns BORDERED uint8 images (h+38, w+38) per level.

    The bordered image is the sampling surface for blur + descriptors,
    exactly like the reference's shared-memory trick where
    mvImagePyramid[level] is a view into the bordered temp
    (ORBextractor.cc:1178).  Inner image = bordered[19:-19, 19:-19].
    """
    h0, w0 = img.shape
    sizes = pyramid_sizes(w0, h0, n_levels, scale_factor)
    out = []
    prev_inner = img
    for lvl, (w, h) in enumerate(sizes):
        if lvl == 0:
            inner = img
        else:
            inner = _resize_u8(prev_inner, w, h)
        out.append(add_border_reflect101(inner, EDGE_THRESHOLD))
        prev_inner = inner
    return out
