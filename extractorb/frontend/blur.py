"""7x7 sigma=2 Gaussian blur applied before descriptor sampling.

Replaces the per-level GaussianBlur(workingMat, Size(7,7), 2, 2,
BORDER_REFLECT_101) in the reference (ORBextractor.cc:1127).

Implementation: OpenCV's *bit-exact* fixed-point path for CV_8U
(smooth.dispatch.cpp GaussianBlurFixedPoint with ufixedpoint16
coefficients, 8 fractional bits).  The 7-tap sigma=2 kernel quantises to
[18, 34, 48, 56, 48, 34, 18] / 256; the row pass accumulates exact
integer sums (<= 255*256 < 2^16) and the column pass accumulates
row_sum * coeff (<= 2^24), so BOTH passes are exact in float32 as 14
shifted multiply-adds.  Final rounding is OpenCV's
fixedround: (acc + 2^15) >> 16.  Verified bitwise against
cv2.GaussianBlur (cv2 5.0) on random and real images.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _fixed_kernel7_sigma2() -> np.ndarray:
    """cv2.getGaussianKernel(7, 2) quantised like ufixedpoint16(softdouble):
    round(k * 256), with OpenCV's sum-to-256 correction applied to the
    centre taps (the float kernel rounds to sum 257; OpenCV's bit-exact
    kernel is [18, 34, 48, 56, 48, 34, 18])."""
    return np.array([18, 34, 48, 56, 48, 34, 18], np.float32)


_K = _fixed_kernel7_sigma2()


@jax.jit
def gaussian_blur7(img: jnp.ndarray) -> jnp.ndarray:
    """Bit-exact cv2.GaussianBlur(img, (7,7), 2) for uint8; rolls wrap at
    edges so only pixels >= 3 from the edge are valid (callers pass
    bordered images whose reflect-101 ring supplies the border reads)."""
    x = img.astype(jnp.float32)
    k = [float(v) for v in _K]
    rows = sum(k[i] * jnp.roll(x, 3 - i, axis=1) for i in range(7))
    acc = sum(k[j] * jnp.roll(rows, 3 - j, axis=0) for j in range(7))
    # fixedround(acc) >> 16, exactly (acc + 2^15 <= 2^24: f32-exact)
    out = jnp.floor((acc + jnp.float32(32768.0)) * jnp.float32(2.0 ** -16))
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


@functools.partial(jax.jit, static_argnums=(1,))
def blur_level(bordered: jnp.ndarray, border: int = 19) -> jnp.ndarray:
    """Blur the inner region of a bordered pyramid level, leaving the
    border ring unblurred.

    Matches the reference's memory aliasing: GaussianBlur writes only the
    inner view (the clone in ORBextractor.cc:1122-1127) while descriptor
    sampling may read a couple of pixels beyond it.  The reference's
    out-of-view reads are undefined behaviour (clone row wrap-around); we
    instead expose the reflect-101 border pixels, which is well-defined
    and agrees for all keypoints >= 16 px from the image edge whose
    rotated pattern stays inside the view.

    The bordered ring was built with BORDER_REFLECT_101 (compute_pyramid),
    so blurring the bordered plane and keeping the inner region is
    pixel-identical to cv2.GaussianBlur(inner, ..., BORDER_REFLECT_101).
    """
    blurred = gaussian_blur7(bordered)
    h, w = bordered.shape
    inner = blurred[border : h - border, border : w - border]
    return bordered.at[border : h - border, border : w - border].set(inner)
