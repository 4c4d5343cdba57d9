"""Stereo-fisheye matching + triangulation on a synthetic KB8 rig.

Covers the reference's non-rectified stereo path:
KannalaBrandt8::TriangulateMatches (KannalaBrandt8.cpp:336-438) and
Frame::ComputeStereoFishEyeMatches (Frame.cc:1139).
"""

import numpy as np
import jax.numpy as jnp

from extractorb.config import CameraConfig
from extractorb.core.camera import KannalaBrandt8, triangulate_matches
from extractorb.frontend import stereo as fstereo

TUMVI = CameraConfig(
    model="KannalaBrandt8",
    fx=190.978477, fy=190.973307, cx=254.931706, cy=256.897442,
    k1=0.003482389402, k2=0.000715034845, k3=-0.002053236141,
    k4=0.000202936736,
    width=512, height=512,
)


def _rig(rng, n=200, baseline=0.101):
    """Random 3D points in front of a fisheye stereo rig; returns
    left/right cameras, relative pose, and pixel projections."""
    cam_l = KannalaBrandt8.from_config(TUMVI)
    cam_r = KannalaBrandt8.from_config(TUMVI)
    R_rl = np.eye(3, dtype=np.float32)
    t_rl = np.array([-baseline, 0.0, 0.0], np.float32)

    pts = np.stack(
        [
            rng.uniform(-0.8, 0.8, n),
            rng.uniform(-0.8, 0.8, n),
            # depth capped at 3.5 m: beyond that a 0.101 m baseline gives
            # <1.15 deg parallax and the reference's cos>0.9998 gate
            # (KannalaBrandt8.cpp:336+) correctly rejects the pair
            rng.uniform(1.0, 3.5, n),
        ],
        -1,
    ).astype(np.float32)
    uv_l = np.asarray(cam_l.project(jnp.asarray(pts)))
    uv_r = np.asarray(cam_r.project(jnp.asarray(pts @ R_rl.T + t_rl)))
    return cam_l, cam_r, R_rl, t_rl, pts, uv_l, uv_r


def test_triangulate_matches_recovers_depth(rng):
    cam_l, cam_r, R_rl, t_rl, pts, uv_l, uv_r = _rig(rng)
    s2 = np.ones(len(pts), np.float32)
    p3d, depth, valid = triangulate_matches(
        cam_l, cam_r, jnp.asarray(uv_l), jnp.asarray(uv_r),
        jnp.asarray(R_rl), jnp.asarray(t_rl), s2, s2,
    )
    valid = np.asarray(valid)
    assert valid.mean() > 0.9
    np.testing.assert_allclose(
        np.asarray(p3d)[valid], pts[valid], rtol=2e-2, atol=2e-2
    )


def test_triangulate_matches_rejects_zero_parallax(rng):
    """Identical rays (no baseline) must be gated by the parallax check."""
    cam_l, cam_r, R_rl, _, pts, uv_l, _ = _rig(rng, n=50)
    t0 = jnp.zeros(3, jnp.float32)
    s2 = np.ones(len(pts), np.float32)
    _, _, valid = triangulate_matches(
        cam_l, cam_r, jnp.asarray(uv_l), jnp.asarray(uv_l),
        jnp.asarray(R_rl), t0, s2, s2,
    )
    assert not np.asarray(valid).any()


def test_triangulate_matches_rejects_bad_correspondences(rng):
    """Shuffled right-image points fail the reprojection chi2 gate."""
    cam_l, cam_r, R_rl, t_rl, pts, uv_l, uv_r = _rig(rng, n=100)
    perm = rng.permutation(len(pts))
    s2 = np.ones(len(pts), np.float32)
    _, _, valid = triangulate_matches(
        cam_l, cam_r, jnp.asarray(uv_l), jnp.asarray(uv_r[perm]),
        jnp.asarray(R_rl), jnp.asarray(t_rl), s2, s2,
    )
    moved = perm != np.arange(len(pts))
    assert np.asarray(valid)[moved].mean() < 0.05


def test_compute_stereo_fisheye_matches(rng):
    cam_l, cam_r, R_rl, t_rl, pts, uv_l, uv_r = _rig(rng, n=128)
    n = len(pts)
    # Unique random descriptors; right descriptors = matching left ones.
    desc = rng.integers(0, 256, (n, 32), dtype=np.uint8)
    perm = rng.permutation(n)  # scramble right order
    desc_r = desc[perm]
    uv_r_shuf = uv_r[perm]
    octv = np.zeros(n, np.int32)
    lap = np.ones(n, bool)
    sigma2 = np.ones(8, np.float32)

    res = fstereo.compute_stereo_fisheye_matches(
        cam_l, cam_r,
        jnp.asarray(uv_l), jnp.asarray(octv), jnp.asarray(desc),
        jnp.asarray(lap),
        jnp.asarray(uv_r_shuf), jnp.asarray(octv), jnp.asarray(desc_r),
        jnp.asarray(lap),
        jnp.asarray(R_rl), jnp.asarray(t_rl), sigma2,
    )
    valid = np.asarray(res.valid)
    assert valid.mean() > 0.85
    # matched index must invert the permutation
    ridx = np.asarray(res.right_idx)
    assert (perm[ridx[valid]] == np.arange(n)[valid]).all()
    np.testing.assert_allclose(
        np.asarray(res.depth)[valid], pts[valid, 2], rtol=2e-2, atol=2e-2
    )


def test_lapping_mask():
    xy = jnp.asarray([[10.0, 0.0], [100.0, 0.0], [300.0, 0.0]])
    valid = jnp.asarray([True, True, False])
    m = fstereo.lapping_mask(xy, 50.0, 400.0, valid)
    assert np.asarray(m).tolist() == [False, True, False]


def test_fisheye_stereo_tracking_smoke(luna_gray):
    """TrackStereo with a KB8 two-camera rig: exercises the fisheye
    frame ctor (lapping masks + triangulation) and the tracking loop
    end-to-end without crashing; depths that survive the chi2 gates
    must be positive."""
    import cv2
    import dataclasses as dc

    from extractorb.config import ORBConfig, SLAMConfig, TrackingConfig
    from extractorb.slam.tracking import Tracker

    cam = dc.replace(TUMVI, bf=190.97 * 0.101, th_depth=35.0)
    cfg = SLAMConfig(
        orb=ORBConfig(n_features=500),
        camera=cam,
        camera2=TUMVI,
        T_lr=tuple(
            float(v)
            for v in [1, 0, 0, 0.101, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1]
        ),
        tracking=TrackingConfig(max_frame_kps=1024),
        sensor="stereo",
    )
    tr = Tracker(cfg)
    assert tr.is_fisheye and tr.cam_r is not None

    left = cv2.resize(luna_gray, (512, 512))
    M = np.float32([[1, 0, -6.0], [0, 1, 0]])
    right = cv2.warpAffine(left, M, (512, 512),
                           borderMode=cv2.BORDER_REPLICATE)
    f = tr._make_frame_stereo(left, right, 0.0)
    assert f.depth is not None and f.p3d_stereo is not None
    d = f.depth[f.valid]
    assert ((d > 0) | (d == -1.0)).all()

    for k in range(3):
        Mk = np.float32([[1, 0, -2.0 * k], [0, 1, 0]])
        lk = cv2.warpAffine(left, Mk, (512, 512),
                            borderMode=cv2.BORDER_REPLICATE)
        rk = cv2.warpAffine(right, Mk, (512, 512),
                            borderMode=cv2.BORDER_REPLICATE)
        tr.track_stereo(lk, rk, 0.1 * k)
