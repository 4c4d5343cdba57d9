"""Stereo matching test on a synthetic rectified pair with known disparity."""

import cv2
import numpy as np
import jax.numpy as jnp

from extractorb.config import ORBConfig
from extractorb.frontend import stereo as fstereo
from extractorb.frontend.extractor import ORBExtractor
from extractorb.frontend.pyramid import compute_pyramid


def test_stereo_constant_disparity(luna_gray):
    """Right image = left shifted by a constant disparity: every matched
    keypoint must recover that disparity (depth = bf/d)."""
    disparity = 12.0
    left = cv2.resize(luna_gray, (640, 480))
    M = np.float32([[1, 0, -disparity], [0, 1, 0]])
    right = cv2.warpAffine(left, M, (640, 480), borderMode=cv2.BORDER_REPLICATE)

    cfg = ORBConfig(n_features=800)
    ext = ORBExtractor(cfg, octree="device")
    fl = ext(jnp.asarray(left))
    fr = ext(jnp.asarray(right))

    pyr_l = tuple(compute_pyramid(jnp.asarray(left), cfg.n_levels, cfg.scale_factor))
    pyr_r = tuple(compute_pyramid(jnp.asarray(right), cfg.n_levels, cfg.scale_factor))

    fx, b = 500.0, 0.1
    bf = fx * b
    res = fstereo.compute_stereo_matches(
        fl.xy, fl.octave, fl.desc, fl.valid,
        fr.xy, fr.octave, fr.desc, fr.valid,
        pyr_l, pyr_r, tuple(float(s) for s in ext.scales), bf, b,
    )
    valid = np.asarray(res.valid)
    ur = np.asarray(res.u_right)
    depth = np.asarray(res.depth)
    xy = np.asarray(fl.xy)
    n = valid.sum()
    assert n > 200, n
    d_est = xy[valid, 0] - ur[valid]
    # subpixel refinement should put most within 0.6 px of truth
    err = np.abs(d_est - disparity)
    assert np.median(err) < 0.4, np.median(err)
    assert (err < 1.0).mean() > 0.9
    expected_depth = bf / disparity
    assert abs(np.median(depth[valid]) - expected_depth) < 0.2
