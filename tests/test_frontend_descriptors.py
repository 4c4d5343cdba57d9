"""Orientation + BRIEF descriptor parity tests.

Oracles: cv2.fastAtan2 for the angle polynomial, an independent numpy
re-implementation of the IC_Angle moment loop (reference
ORBextractor.cc:75-102), and cv2.ORB.compute for descriptors (the same
computeOrbDescriptor code the reference copied from OpenCV)."""

import cv2
import numpy as np
import pytest
import jax.numpy as jnp

from extractorb.frontend import (
    blur as fblur,
    brief as fbrief,
    extractor as fext,
    fast as ffast,
    orientation as forient,
    pyramid as fpyr,
)
from extractorb.config import ORBConfig


def test_fast_atan2_matches_cv2(rng):
    ys = rng.normal(size=512) * 1000
    xs = rng.normal(size=512) * 1000
    got = np.asarray(forient.fast_atan2_deg(jnp.asarray(ys), jnp.asarray(xs)))
    exp = np.array([cv2.fastAtan2(float(y), float(x)) for y, x in zip(ys, xs)])
    np.testing.assert_allclose(got, exp, atol=2e-3)


def test_umax_reference_values():
    # the reference ctor produces this exact table for HALF_PATCH_SIZE=15
    assert list(forient.compute_umax()) == [
        15, 15, 15, 15, 14, 14, 14, 13, 13, 12, 11, 10, 9, 8, 6, 3
    ]


def ic_angle_numpy(img, x, y):
    """Literal reimplementation of the reference IC_Angle loop."""
    umax = forient.compute_umax()
    m01 = 0
    m10 = 0
    for u in range(-15, 16):
        m10 += u * int(img[y, x + u])
    for v in range(1, 16):
        v_sum = 0
        d = umax[v]
        for u in range(-d, d + 1):
            plus = int(img[y + v, x + u])
            minus = int(img[y - v, x + u])
            v_sum += plus - minus
            m10 += u * (plus + minus)
        m01 += v * v_sum
    return cv2.fastAtan2(float(m01), float(m10))


def test_ic_angle_matches_loop(luna_gray):
    bordered = fpyr.add_border_reflect101(jnp.asarray(luna_gray), 19)
    keep, score = ffast.detect_keypoints(bordered, 20, 7)
    xy, resp, valid = ffast.collect_keypoints(keep, score, 128)
    angles = np.asarray(forient.ic_angle(bordered, xy, valid))
    xy = np.asarray(xy)
    for i in range(int(np.asarray(valid).sum())):
        x, y = xy[i]
        exp = ic_angle_numpy(luna_gray, int(x), int(y))
        assert abs(angles[i] - exp) < 2e-3, ((x, y), angles[i], exp)


def test_descriptors_close_to_cv2(luna_gray):
    """cv2.ORB.compute with our keypoints+angles should agree with our
    descriptors up to the blur deviation (a few bits of 256)."""
    bordered = fpyr.add_border_reflect101(jnp.asarray(luna_gray), 19)
    keep, score = ffast.detect_keypoints(bordered, 20, 7)
    xy, resp, valid = ffast.collect_keypoints(keep, score, 512)
    angles = forient.ic_angle(bordered, xy, valid)
    blurred = fblur.blur_level(bordered)
    bits = fbrief.compute_descriptors(blurred, xy, angles, valid)
    desc = np.asarray(fbrief.pack_bits_u8(bits))

    xy_np, ang_np, val_np = map(np.asarray, (xy, angles, valid))
    n = int(val_np.sum())
    # keep keypoints far from the border so cv2's own boundary handling
    # (it works on its own bordered copy) agrees
    sel = [
        i for i in range(n)
        if 35 <= xy_np[i, 0] < luna_gray.shape[1] - 35
        and 35 <= xy_np[i, 1] < luna_gray.shape[0] - 35
    ]
    kps = [
        cv2.KeyPoint(float(xy_np[i, 0]), float(xy_np[i, 1]), 31.0,
                     float(ang_np[i]), float(0), 0)
        for i in sel
    ]
    orb = cv2.ORB_create(nfeatures=len(kps))
    kps_out, desc_cv = orb.compute(luna_gray, kps)
    assert len(kps_out) == len(sel)
    ham = []
    for j, i in enumerate(sel):
        h = bin(int.from_bytes(bytes(desc[i]), "big")
                ^ int.from_bytes(bytes(desc_cv[j]), "big")).count("1")
        ham.append(h)
    ham = np.array(ham)
    # blur is bit-exact (frontend/blur.py), so interior descriptors must
    # be bitwise identical to cv2's computeOrbDescriptor
    assert np.median(ham) == 0, (ham.mean(), ham.max())
    assert ham.mean() < 0.5, (ham.mean(), ham.max())
    assert ham.max() <= 8, ham.max()  # allow rare cvRound fp edge cases


def test_blur_bitwise_exact_cv2(luna_gray):
    """gaussian_blur7 reproduces cv2 5.0's fixed-point GaussianBlur
    (7x7 sigma=2, BORDER_REFLECT_101) bit-for-bit (ORBextractor.cc:1127)."""
    ref = cv2.GaussianBlur(luna_gray, (7, 7), 2,
                           borderType=cv2.BORDER_REFLECT_101)
    got = np.asarray(fblur.gaussian_blur7(jnp.asarray(luna_gray)))
    np.testing.assert_array_equal(got[3:-3, 3:-3], ref[3:-3, 3:-3])
    # and through the bordered-level path: the reflect-101 ring makes the
    # inner region exactly GaussianBlur(inner, BORDER_REFLECT_101)
    bordered = fpyr.add_border_reflect101(jnp.asarray(luna_gray), 19)
    lvl = np.asarray(fblur.blur_level(bordered))
    np.testing.assert_array_equal(lvl[19:-19, 19:-19], ref)


def test_extractor_end_to_end_host(luna_gray):
    cfg = ORBConfig(n_features=1000)
    ext = fext.ORBExtractor(cfg, octree="host")
    feats = ext(jnp.asarray(luna_gray))
    n = int(feats.count())
    assert 900 <= n <= 1200, n
    v = np.asarray(feats.valid)
    octv = np.asarray(feats.octave)[v]
    # all 8 levels represented, higher levels fewer features
    assert set(octv) == set(range(8))
    xy = np.asarray(feats.xy)[v]
    assert xy[:, 0].max() < luna_gray.shape[1] * 1.01
    assert xy[:, 0].min() >= 0


def test_extractor_end_to_end_device(luna_gray):
    cfg = ORBConfig(n_features=1000)
    ext = fext.ORBExtractor(cfg, octree="device")
    feats = ext(jnp.asarray(luna_gray))
    n = int(feats.count())
    assert 800 <= n <= 1600, n
    # device octree should produce a similar spatial distribution: compare
    # per-level counts with host mode
    ext_h = fext.ORBExtractor(cfg, octree="host")
    fh = ext_h(jnp.asarray(luna_gray))
    for lvl in range(8):
        cd = int((np.asarray(feats.octave)[np.asarray(feats.valid)] == lvl).sum())
        ch = int((np.asarray(fh.octave)[np.asarray(fh.valid)] == lvl).sum())
        assert cd >= 0.5 * ch, (lvl, cd, ch)


def test_device_octree_spatial_distribution(luna_gray):
    """Device vs host-exact octree end-to-end: the per-cell occupancy
    histogram over an 8x6 grid must closely agree — the whole point of
    DistributeOctTree (reference ORBextractor.cc:544-771) is spatial
    uniformity, so matching counts per LEVEL is not enough."""
    cfg = ORBConfig(n_features=1000)
    fd = fext.ORBExtractor(cfg, octree="device")(jnp.asarray(luna_gray))
    fh = fext.ORBExtractor(cfg, octree="host")(jnp.asarray(luna_gray))
    h, w = luna_gray.shape

    def occupancy(f):
        v = np.asarray(f.valid)
        xy = np.asarray(f.xy)[v]
        gx = np.clip((xy[:, 0] / w * 8).astype(int), 0, 7)
        gy = np.clip((xy[:, 1] / h * 6).astype(int), 0, 5)
        hist = np.zeros((6, 8), np.float64)
        np.add.at(hist, (gy, gx), 1.0)
        return hist / hist.sum()

    hd, hh = occupancy(fd), occupancy(fh)
    # total-variation distance between the two occupancy distributions
    tv = 0.5 * np.abs(hd - hh).sum()
    assert tv < 0.10, (tv, hd, hh)
    # every cell the host path fills substantially is also filled by the
    # device path (no dead zones)
    assert ((hd > 0.2 * hh) | (hh < 0.01)).all(), (hd, hh)


def test_native_octree_matches_python(luna_gray, rng):
    """The C++ DistributeOctTree must agree with the python-exact one."""
    from extractorb.frontend import octree as foct
    from extractorb.native import distribute_octree_native

    n = 3000
    xs = rng.uniform(16, 480, n).astype(np.float32)
    ys = rng.uniform(16, 460, n).astype(np.float32)
    resp = rng.integers(7, 200, n).astype(np.float32)
    args = (xs, ys, resp, 16, 496, 16, 464, 250)
    out_c = distribute_octree_native(*args)
    assert out_c is not None, "native build failed"
    out_py = foct._distribute_host_py(*args)
    assert set(out_c.tolist()) == set(out_py.tolist()), (
        len(out_c), len(out_py), len(set(out_c.tolist()) ^ set(out_py.tolist()))
    )


@pytest.mark.slow
def test_device_vs_host_octree_tracking_ate(scene_texture):
    """Downstream acceptance: the synthetic-sequence ATE with the
    device octree must match the host-exact octree path (reference
    distribution semantics ORBextractor.cc:544-771) within tolerance."""
    import dataclasses as dc

    from extractorb.sim.scenes import H, W, render_sequence, umeyama_align
    from extractorb.config import (
        CameraConfig, SLAMConfig, TrackingConfig,
    )
    from extractorb.slam.system import System

    frames, poses = render_sequence(scene_texture, n_frames=12)

    def ate_for(octree):
        cfg = SLAMConfig(
            orb=ORBConfig(n_features=1000, octree=octree),
            camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                                width=W, height=H),
            # legacy tracking stack for BOTH paths: octree="host"
            # cannot take the fused step, so comparing through the
            # fused stack would conflate octree choice with tracking
            # path — this test isolates the octree distribution
            tracking=TrackingConfig(max_frames=6, use_fused=False),
        )
        s = System(cfg)
        for k, im in enumerate(frames):
            s.track_monocular(im, k / 30.0)
        traj = s.tracker.final_trajectory()
        assert len(traj) >= 8, len(traj)
        est = np.array([-R.T @ t for _, R, t in traj])
        gt = np.array([
            -poses[int(round(ts * 30.0))][0].T
            @ poses[int(round(ts * 30.0))][1]
            for ts, _, _ in traj
        ])
        aligned = umeyama_align(est, gt)
        return float(np.sqrt(((aligned - gt) ** 2).sum(-1).mean()))

    ate_dev = ate_for("device")
    ate_host = ate_for("host")
    assert ate_dev < max(2.0 * ate_host, 0.05), (ate_dev, ate_host)
