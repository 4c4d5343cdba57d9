"""Visualization layer tests (reference FrameDrawer/MapDrawer/Viewer)."""

import numpy as np

from extractorb.viz import FrameDrawer, MapDrawer
from extractorb.viz.frame_drawer import GREEN
from extractorb.viz.map_drawer import covisibility_segments, frustum_segments


def test_frame_drawer_overlay(rng):
    gray = rng.integers(0, 200, (480, 640), dtype=np.uint8)
    n = 50
    xy = np.stack(
        [rng.uniform(10, 630, n), rng.uniform(10, 470, n)], -1
    ).astype(np.float32)
    valid = np.ones(n, bool)
    kp_mp = np.where(np.arange(n) % 2 == 0, np.arange(n), -1)

    fd = FrameDrawer()
    img = fd.update(
        gray, xy, valid, kp_mp, state="OK", n_keyframes=7, n_map_points=1234
    )
    assert img.shape == (480 + 12, 640, 3) and img.dtype == np.uint8
    # tracked keypoints got green squares
    i = int(np.where(kp_mp >= 0)[0][0])
    x, y = int(round(float(xy[i, 0]))), int(round(float(xy[i, 1])))
    assert tuple(img[y - 4, x]) == GREEN
    # status bar has text pixels
    assert (img[480:, :, :] == 255).any()


def test_frustum_and_covisibility_segments(rng):
    R = np.eye(3, dtype=np.float32)
    t = np.array([0.5, 0, 0], np.float32)
    segs = frustum_segments(R, t)
    assert segs.shape == (16, 3)
    # apex is the camera centre
    np.testing.assert_allclose(segs[0], -R.T @ t, atol=1e-6)

    # covisibility over a tiny constructed map
    from test_loop_closing import build_looped_map

    mp, _, _ = build_looped_map(rng, n_kf=6, n_pts=80)
    cov = covisibility_segments(mp, min_weight=5)
    assert cov.shape[0] % 2 == 0 and cov.shape[0] > 0


def test_map_drawer_render(rng):
    from test_loop_closing import build_looped_map

    mp, _, _ = build_looped_map(rng, n_kf=6, n_pts=80)
    md = MapDrawer()
    img = md.render(mp, view="top", figsize=(3, 3))
    assert img.shape == (300, 300, 3) and img.dtype == np.uint8
    # something was drawn (not a blank canvas)
    assert (img < 250).mean() > 0.01
