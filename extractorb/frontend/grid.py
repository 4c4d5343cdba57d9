"""Frame feature grid: AssignFeaturesToGrid / GetFeaturesInArea.

Replaces the reference's 64x48 keypoint acceleration grid (reference:
src/Frame.cc:383-417 AssignFeaturesToGrid, :655-724 GetFeaturesInArea,
:726-737 PosInGrid; grid constants FRAME_GRID_COLS/ROWS inc/Frame.h:39-40).

Design: the reference's grid exists to avoid O(N) scans on a CPU.
On an accelerator the idiomatic fast path is the opposite — a dense
(N,) window mask computed in one pass (`features_in_area_mask`), which is
what frontend/matcher.py's search modes use internally.  The explicit
grid is still provided for API parity and for host-side consumers
(viz overlays, debugging, exact candidate-set comparisons against the
reference): `assign_features_to_grid` builds the same cell->indices
structure as a fixed-shape (ROWS, COLS, CAP) tensor via a sort-by-cell
rank (no scatter contention, fully jittable).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

FRAME_GRID_COLS = 64  # reference inc/Frame.h:39
FRAME_GRID_ROWS = 48  # reference inc/Frame.h:40


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def pos_in_grid(
    xy_un: jnp.ndarray,
    bounds: jnp.ndarray,
    valid: jnp.ndarray,
    rows: int = FRAME_GRID_ROWS,
    cols: int = FRAME_GRID_COLS,
    strict: bool = True,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Cell (col, row) per keypoint + in-grid mask (Frame::PosInGrid).

    bounds: (4,) [min_x, max_x, min_y, max_y] undistorted image bounds
    (Frame::ComputeImageBounds).  Keypoints whose undistorted coords fall
    outside (possible with distortion) are masked out, like the
    reference's posX/posY range check (src/Frame.cc:728-735).
    """
    min_x, max_x, min_y, max_y = bounds[0], bounds[1], bounds[2], bounds[3]
    inv_w = cols / (max_x - min_x)
    inv_h = rows / (max_y - min_y)
    cx = jnp.floor((xy_un[:, 0] - min_x) * inv_w).astype(jnp.int32)
    cy = jnp.floor((xy_un[:, 1] - min_y) * inv_h).astype(jnp.int32)
    ok = valid & (cx >= 0) & (cx < cols) & (cy >= 0) & (cy < rows)
    if not strict:
        cx = jnp.clip(cx, 0, cols - 1)
        cy = jnp.clip(cy, 0, rows - 1)
    return jnp.stack([cx, cy], -1), ok


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def assign_features_to_grid(
    xy_un: jnp.ndarray,
    bounds: jnp.ndarray,
    valid: jnp.ndarray,
    rows: int = FRAME_GRID_ROWS,
    cols: int = FRAME_GRID_COLS,
    cell_capacity: int = 16,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Fixed-shape grid index: (rows, cols, cell_capacity) int32 of
    keypoint indices (-1 padded) + (rows, cols) int32 counts.

    Equivalent to Frame::AssignFeaturesToGrid's vector<size_t> cells,
    with insertion order preserved (ascending keypoint index within a
    cell).  Built as one sort by cell id: the rank of each keypoint
    within its cell is its position among equal cell ids, so the final
    placement is a single scatter with unique destinations.
    """
    n = xy_un.shape[0]
    cell, ok = pos_in_grid(xy_un, bounds, valid, rows, cols)
    cid = jnp.where(ok, cell[:, 1] * cols + cell[:, 0], rows * cols)
    order = jnp.argsort(cid, stable=True)          # groups cells, keeps index order
    cid_s = cid[order]
    pos = jnp.arange(n, dtype=jnp.int32)
    # rank within run of equal cid: pos - first position of this cid
    first = jnp.searchsorted(cid_s, cid_s, side="left").astype(jnp.int32)
    rank = pos - first
    keep = (cid_s < rows * cols) & (rank < cell_capacity)
    dest = jnp.where(keep, cid_s * cell_capacity + jnp.minimum(rank, cell_capacity - 1),
                     rows * cols * cell_capacity)
    flat = jnp.full((rows * cols * cell_capacity + 1,), -1, jnp.int32)
    flat = flat.at[dest].set(jnp.where(keep, order.astype(jnp.int32), -1))[:-1]
    grid = flat.reshape(rows, cols, cell_capacity)
    counts = jnp.zeros((rows * cols + 1,), jnp.int32).at[cid_s].add(1)[:-1]
    return grid, counts.reshape(rows, cols)


@jax.jit
def features_in_area_mask(
    xy_un: jnp.ndarray,
    octave: jnp.ndarray,
    valid: jnp.ndarray,
    x: jnp.ndarray,
    y: jnp.ndarray,
    r: jnp.ndarray,
    min_level: jnp.ndarray,
    max_level: jnp.ndarray,
) -> jnp.ndarray:
    """(N,) bool: Frame::GetFeaturesInArea as a dense mask.

    Matches the reference's final per-keypoint check (src/Frame.cc:692-719):
    |x_i - x| < r, |y_i - y| < r, minLevel <= octave <= maxLevel
    (level gate skipped when min_level < 0 AND max_level < 0, like the
    bCheckLevels flag).  The cell pre-filter is an optimization the dense
    mask does not need; the accepted set is identical.
    """
    dx = jnp.abs(xy_un[:, 0] - x)
    dy = jnp.abs(xy_un[:, 1] - y)
    in_box = (dx < r) & (dy < r)
    check = (min_level > 0) | (max_level >= 0)
    lvl_ok = jnp.where(
        check, (octave >= min_level) & (octave <= max_level), True
    )
    return valid & in_box & lvl_ok
