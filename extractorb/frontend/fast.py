"""FAST-9/16 corner detection with OpenCV-exact scores and the reference's
per-cell structure, fully vectorised.

Replaces the FAST calls in ORBextractor::ComputeKeyPointsOctTree
(reference: src/orb_extractor/ORBextractor.cc:773-888): the level image is
split into ~30px cells; FAST runs per cell at iniThFAST=20 with non-max
suppression confined to the cell, and cells with no survivors retry at
minThFAST=7.

Design: instead of 100s of tiny per-cell FAST calls, one dense pass
computes the OpenCV corner score for every pixel (the closed form of
cv::cornerScore<16>:  score = max(arcmin_bright, -arcmax_dark) - 1 over
all 16 9-long contiguous arcs), then non-max suppression is applied with
neighbours masked across cell boundaries, which reproduces the per-cell
call semantics exactly.  Everything is shift-and-min/max on (H, W) planes
— elementwise work that XLA fuses.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .pyramid import EDGE_THRESHOLD

# Bresenham circle of radius 3, OpenCV makeOffsets order (x, y):
_CIRCLE = np.array(
    [
        (0, 3), (1, 3), (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3),
        (0, -3), (-1, -3), (-2, -2), (-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    ],
    dtype=np.int32,
)

MIN_BORDER = EDGE_THRESHOLD - 3  # 16; reference ORBextractor.cc:781-784


def _shift(bordered: jnp.ndarray, dx: int, dy: int, border: int) -> jnp.ndarray:
    """Inner-image view shifted by (dx, dy), reading into the border ring."""
    h, w = bordered.shape
    H, W = h - 2 * border, w - 2 * border
    return jax.lax.dynamic_slice(bordered, (border + dy, border + dx), (H, W))


@functools.partial(jax.jit, static_argnums=(1,))
def corner_score(bordered: jnp.ndarray, border: int = EDGE_THRESHOLD) -> jnp.ndarray:
    """OpenCV cornerScore<16> for every inner pixel, as int16 (H, W).

    A pixel is a FAST corner at threshold t iff score >= t.
    """
    v = _shift(bordered, 0, 0, border).astype(jnp.int16)
    d = [v - _shift(bordered, int(dx), int(dy), border).astype(jnp.int16) for dx, dy in _CIRCLE]
    d = d + d[:9]  # wrap to 25 for contiguous windows

    # min over 9 contiguous, for each of 16 starts (tree reduction)
    def win9(op, arr):
        m2 = [op(arr[s], arr[s + 1]) for s in range(24)]
        m4 = [op(m2[s], m2[s + 2]) for s in range(22)]
        m8 = [op(m4[s], m4[s + 4]) for s in range(18)]
        return [op(m8[s], arr[s + 8]) for s in range(16)]

    arc_min = win9(jnp.minimum, d)   # bright arcs
    arc_max = win9(jnp.maximum, d)   # dark arcs
    s_bright = functools.reduce(jnp.maximum, arc_min)
    s_dark = functools.reduce(jnp.minimum, arc_max)
    return jnp.maximum(s_bright, -s_dark) - 1


def cell_layout(width: int, height: int, cell: float = 30.0):
    """Reference cell grid over the valid FAST region (ORBextractor.cc:787-795).

    width/height are maxBorder-minBorder for the level.  Returns
    (n_cols, n_rows, w_cell, h_cell).
    """
    n_cols = int(width / cell)
    n_rows = int(height / cell)
    w_cell = int(np.ceil(width / n_cols))
    h_cell = int(np.ceil(height / n_rows))
    return n_cols, n_rows, w_cell, h_cell


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def detect_keypoints(
    bordered: jnp.ndarray,
    ini_th: int = 20,
    min_th: int = 7,
    border: int = EDGE_THRESHOLD,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Full per-level FAST with the reference's cell/retry semantics.

    Returns (keep, score): boolean keep-mask and int16 score over the
    inner (H, W) image.  keep is nonzero only inside the valid region
    [MIN_BORDER+3, maxBorder-3).
    """
    h, w = bordered.shape
    H, W = h - 2 * border, w - 2 * border
    min_b = MIN_BORDER
    max_x, max_y = W - min_b, H - min_b
    width, height = max_x - min_b, max_y - min_b
    n_cols, n_rows, w_cell, h_cell = cell_layout(width, height)

    score = corner_score(bordered, border)

    # All cell geometry is static per image shape: build the valid-region
    # and cross-cell-boundary neighbour masks as COMPILE-TIME constants
    # (numpy), so the nonmax pass is 8 shifted compares with constant
    # masks — no dynamic cell-id arithmetic on device.
    ys_np = np.arange(H)[:, None]
    xs_np = np.arange(W)[None, :]
    in_region_np = (
        (xs_np >= min_b + 3) & (xs_np < max_x - 3)
        & (ys_np >= min_b + 3) & (ys_np < max_y - 3)
        & (xs_np < min_b + n_cols * w_cell + 3)
        & (ys_np < min_b + n_rows * h_cell + 3)
    )
    cell_x_np = np.clip((xs_np - (min_b + 3)) // w_cell, 0, n_cols - 1)
    cell_y_np = np.clip((ys_np - (min_b + 3)) // h_cell, 0, n_rows - 1)
    cell_x_np = np.broadcast_to(cell_x_np, (H, W))
    cell_y_np = np.broadcast_to(cell_y_np, (H, W))

    def np_shift(a, dx, dy, fill):
        out = np.full_like(a, fill)
        ys0, ys1 = max(0, -dy), min(H, H - dy)
        xs0, xs1 = max(0, -dx), min(W, W - dx)
        out[ys0:ys1, xs0:xs1] = a[ys0 + dy : ys1 + dy, xs0 + dx : xs1 + dx]
        return out

    same_masks = {}
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if dx == 0 and dy == 0:
                continue
            same_masks[(dx, dy)] = jnp.asarray(
                (np_shift(cell_x_np, dx, dy, -1) == cell_x_np)
                & (np_shift(cell_y_np, dx, dy, -1) == cell_y_np)
            )
    in_region = jnp.asarray(in_region_np)

    def shift2(a, dx, dy):
        return jax.lax.dynamic_slice(
            jnp.pad(a, ((1, 1), (1, 1))), (1 + dy, 1 + dx), (H, W)
        )

    def nonmax(th: int):
        cand = (score >= th) & in_region
        s = jnp.where(cand, score, 0).astype(jnp.int16)
        keep = cand
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dx == 0 and dy == 0:
                    continue
                ns = shift2(s, dx, dy)
                keep &= s > jnp.where(same_masks[(dx, dy)], ns, 0)
        return keep

    keep_ini = nonmax(ini_th)
    keep_min = nonmax(min_th)

    # Per-cell retry: use min_th survivors only in cells with no ini_th
    # survivor.  Cells are uniform tiles, so the per-cell reduction is a
    # pad + reshape pooling (no scatter).
    Wp = n_cols * w_cell
    Hp = n_rows * h_cell
    x0, y0 = min_b + 3, min_b + 3
    ki = keep_ini.astype(jnp.int32)
    tile = jax.lax.dynamic_slice(
        jnp.pad(ki, ((0, max(0, y0 + Hp - H)), (0, max(0, x0 + Wp - W)))),
        (y0, x0), (Hp, Wp),
    )
    counts = tile.reshape(n_rows, h_cell, n_cols, w_cell).sum(axis=(1, 3))
    has_ini = counts > 0  # (n_rows, n_cols)
    # broadcast back to pixel grid
    has_px = jnp.repeat(jnp.repeat(has_ini, h_cell, axis=0), w_cell, axis=1)
    has_full = jnp.zeros((H, W), bool)
    has_full = jax.lax.dynamic_update_slice(
        jnp.zeros((max(H, y0 + Hp), max(W, x0 + Wp)), bool), has_px, (y0, x0)
    )[:H, :W]
    keep = jnp.where(has_full, keep_ini, keep_min) & in_region
    return keep, score


@functools.partial(jax.jit, static_argnums=(2,))
def collect_keypoints(keep: jnp.ndarray, score: jnp.ndarray, capacity: int):
    """Compact a keep-mask into a fixed-size keypoint list.

    Returns (xy int32 (K,2) inner coords, response int32 (K,), valid (K,)).
    Order: descending score, ties by row-major position (deterministic).
    """
    H, W = keep.shape
    flat_score = jnp.where(keep, score.astype(jnp.int32), -1).reshape(-1)
    flat_idx = jnp.arange(H * W, dtype=jnp.int32)
    # key: score-major, earlier-pixel tiebreak.  H*W < 2^21 for our sizes.
    key = flat_score * (1 << 21) + ((1 << 21) - 1 - flat_idx)
    top, idx = jax.lax.top_k(key, capacity)
    valid = top >= 0  # score >= 0 and real corner (masked were -1)
    ys, xs = idx // W, idx % W
    xy = jnp.stack([xs, ys], -1)
    resp = jnp.where(valid, score.reshape(-1)[idx].astype(jnp.int32), 0)
    return xy, resp, valid
