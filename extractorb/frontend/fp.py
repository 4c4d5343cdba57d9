"""Float32 arithmetic that rounds the same on every XLA backend.

ORB's orientation and descriptor stages feed float results into
rounding decisions (fastAtan2's angle, then cvRound of rotated pattern
offsets), so one last-bit difference can flip a descriptor bit.  Three
backend differences matter, each measured on an H100 against the CPU:

- XLA:CPU fuses a product into a following add as one FMA (a single
  rounding); XLA:GPU rounds the product first, like the reference's
  C++.  ``round_f32`` pins the separate rounding everywhere.
- XLA:GPU's float32 division is not correctly rounded; ``div_rn`` is.
- cos/sin use a different approximation per backend; ``sincos`` is one
  polynomial built only from the operations above.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax


def round_f32(p):
    """``p`` rounded to float32 as an operation of its own, so it is
    never fused with a following add into one FMA.  The xor is with a
    zero no compiler can prove zero (``p != p`` holds only for NaN)."""
    bits = lax.bitcast_convert_type(p, jnp.int32)
    return lax.bitcast_convert_type(bits ^ (p != p).astype(jnp.int32), jnp.float32)


def div_rn(num, den):
    """``num / den`` rounded to nearest even, for finite float32
    0 <= num <= den with den > 0, by integer long division of the
    significands.  Quotients below 2**-100 (and zero or subnormal
    numerators) give 0."""
    nb = lax.bitcast_convert_type(num.astype(jnp.float32), jnp.int32)
    db = lax.bitcast_convert_type(den.astype(jnp.float32), jnp.int32)
    ne, de = (nb >> 23) & 0xFF, (db >> 23) & 0xFF
    nm, dm = (nb & 0x7FFFFF) | 0x800000, (db & 0x7FFFFF) | 0x800000
    shift = (nm < dm).astype(jnp.int32)    # nm << shift lies in [dm, 2 dm)
    r = (nm << shift) - dm                 # leading quotient bit is 1
    m = jnp.ones_like(r)
    for _ in range(24):                    # 23 fraction bits + round bit
        r = r << 1
        bit = (r >= dm).astype(jnp.int32)
        r = r - bit * dm
        m = (m << 1) | bit
    sig = m >> 1
    sig = sig + ((m & 1) & ((r != 0) | ((sig & 1) == 1)).astype(jnp.int32))
    e = ne - de - shift - 23               # value = sig * 2**e, sig <= 2**24
    scale = lax.bitcast_convert_type((jnp.maximum(e, -126) + 127) << 23, jnp.float32)
    out = sig.astype(jnp.float32) * scale
    return jnp.where((ne == 0) | (e < -126), jnp.float32(0.0), out)


_TWO_OVER_PI = np.float32(2.0 / np.pi)
# pi/2 = _PIO2_1 + _PIO2_2 + _PIO2_3; the first two have 8 and 12
# significant bits, so k * _PIO2_1 and k * _PIO2_2 are exact for k <= 8
_PIO2_1 = np.float32(1.5703125)
_PIO2_2 = np.float32(0.0004838705062866211)
_PIO2_3 = np.float32(-4.371138828673793e-08)
# minimax polynomials on [-pi/4, pi/4] (Cephes sinf/cosf)
_S = (np.float32(-1.9515295891e-4), np.float32(8.3321608736e-3),
      np.float32(-1.6666654611e-1))
_C = (np.float32(2.443315711809948e-5), np.float32(-1.388731625493765e-3),
      np.float32(4.166664568298827e-2))


def _two_sum(a, b):
    """(s, e) with s = fl(a + b) and a + b = s + e exactly."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def sincos(x):
    """(sin x, cos x) in float32 for 0 <= x < 8 (one turn and a bit),
    bitwise the same on every backend and within one ulp of the
    correctly rounded value that the reference's double-precision
    cos/sin give (equal to it in ~96 % of cases on CPU, against ~99 % for
    XLA's own float32 cos, which differs between backends).  The reduced
    argument is carried as a float pair."""
    x = round_f32(x.astype(jnp.float32))   # x may itself be a product
    k = jnp.rint(x * _TWO_OVER_PI)
    r_hi, r_lo = _two_sum(x - k * _PIO2_1, -(k * _PIO2_2))
    r_lo = r_lo - round_f32(k * _PIO2_3)
    r_hi, r_lo = _two_sum(r_hi, r_lo)
    z = round_f32(r_hi * r_hi)

    def horner(coef):
        acc = coef[0]
        for c in coef[1:]:
            acc = round_f32(acc * z) + c
        return acc

    # sin r = r + r z S(z), with r = r_hi + r_lo
    s = r_hi + (round_f32(round_f32(r_hi * z) * horner(_S)) + r_lo)
    # cos r = 1 - z/2 + z^2 C(z) - r_hi r_lo, keeping 1 - z/2's rounding error
    hz = np.float32(0.5) * z
    w = np.float32(1.0) - hz
    tail = round_f32(round_f32(z * z) * horner(_C)) - round_f32(r_hi * r_lo)
    c = w + (((np.float32(1.0) - w) - hz) + tail)
    q = k.astype(jnp.int32) & 3
    sin = jnp.where(q == 0, s, jnp.where(q == 1, c, jnp.where(q == 2, -s, -c)))
    cos = jnp.where(q == 0, c, jnp.where(q == 1, -s, jnp.where(q == 2, -c, s)))
    return sin, cos
