"""frontend/grid.py vs a NumPy oracle of Frame::AssignFeaturesToGrid /
GetFeaturesInArea / PosInGrid (reference src/Frame.cc:383-417, :655-724,
:726-737)."""

import numpy as np
import jax.numpy as jnp

from extractorb.frontend import grid as fg


def _oracle_pos_in_grid(xy, bounds, rows, cols):
    min_x, max_x, min_y, max_y = bounds
    inv_w = cols / (max_x - min_x)
    inv_h = rows / (max_y - min_y)
    cx = np.floor((xy[:, 0] - min_x) * inv_w).astype(int)
    cy = np.floor((xy[:, 1] - min_y) * inv_h).astype(int)
    ok = (cx >= 0) & (cx < cols) & (cy >= 0) & (cy < rows)
    return cx, cy, ok


def _scene(rng, n=400, bounds=(0.0, 640.0, 0.0, 480.0)):
    xy = rng.uniform(-20, 660, (n, 2)).astype(np.float32)
    xy[:, 1] = rng.uniform(-20, 500, n)
    valid = rng.random(n) > 0.1
    octave = rng.integers(0, 8, n).astype(np.int32)
    return xy, valid, octave


def test_assign_features_to_grid_matches_oracle(rng):
    bounds = np.array([0.0, 640.0, 0.0, 480.0], np.float32)
    xy, valid, _ = _scene(rng)
    grid, counts = fg.assign_features_to_grid(
        jnp.asarray(xy), jnp.asarray(bounds), jnp.asarray(valid),
        cell_capacity=32,
    )
    grid = np.asarray(grid)
    counts = np.asarray(counts)

    cx, cy, ok = _oracle_pos_in_grid(xy, bounds, fg.FRAME_GRID_ROWS, fg.FRAME_GRID_COLS)
    ok &= valid
    cells = {}
    for i in np.nonzero(ok)[0]:
        cells.setdefault((cy[i], cx[i]), []).append(i)

    total = 0
    for (r, c), idxs in cells.items():
        got = [v for v in grid[r, c] if v >= 0]
        assert got == idxs, (r, c)
        assert counts[r, c] == len(idxs)
        total += len(idxs)
    assert total == ok.sum()
    assert counts.sum() == total


def test_features_in_area_mask_matches_oracle(rng):
    xy, valid, octave = _scene(rng)
    for (x, y, r, lo, hi) in [
        (320.0, 240.0, 50.0, -1, -1),
        (100.0, 100.0, 30.0, 0, 0),
        (500.0, 400.0, 120.0, 2, 7),
        (320.0, 240.0, 15.0, 0, -1),
    ]:
        mask = np.asarray(
            fg.features_in_area_mask(
                jnp.asarray(xy), jnp.asarray(octave), jnp.asarray(valid),
                x, y, r, lo, hi,
            )
        )
        in_box = (np.abs(xy[:, 0] - x) < r) & (np.abs(xy[:, 1] - y) < r)
        check = (lo > 0) or (hi >= 0)
        lvl = ((octave >= lo) & (octave <= hi)) if check else np.ones_like(valid)
        exp = valid & in_box & lvl
        np.testing.assert_array_equal(mask, exp)


def test_grid_overflow_drops_excess_keeps_first(rng):
    # 100 points in one cell with capacity 8: first 8 indices kept
    bounds = np.array([0.0, 640.0, 0.0, 480.0], np.float32)
    xy = np.full((100, 2), 5.0, np.float32)
    valid = np.ones(100, bool)
    grid, counts = fg.assign_features_to_grid(
        jnp.asarray(xy), jnp.asarray(bounds), jnp.asarray(valid),
        cell_capacity=8,
    )
    cx, cy, _ = _oracle_pos_in_grid(xy, bounds, fg.FRAME_GRID_ROWS, fg.FRAME_GRID_COLS)
    cell = np.asarray(grid)[cy[0], cx[0]]
    assert list(cell) == list(range(8))
    assert np.asarray(counts)[cy[0], cx[0]] == 100  # true count reported
