"""Parity tests: pyramid resize vs cv2.resize, FAST vs a cv2-based oracle
reproducing the reference's per-cell detection loop
(ORBextractor::ComputeKeyPointsOctTree, ORBextractor.cc:773-888)."""

import cv2
import numpy as np
import pytest

from extractorb.frontend import fast as ffast
from extractorb.frontend import pyramid as fpyr

import jax.numpy as jnp


def cv2_pyramid(img, n_levels=8, scale=1.2):
    """Oracle: the reference's ComputePyramid chain via cv2."""
    out = [img]
    h0, w0 = img.shape
    for lvl in range(1, n_levels):
        inv = 1.0 / (scale ** lvl)
        sz = (int(np.rint(w0 * inv)), int(np.rint(h0 * inv)))
        out.append(cv2.resize(out[-1], sz, interpolation=cv2.INTER_LINEAR))
    return out


def cv2_cell_fast(img, ini_th=20, min_th=7):
    """Oracle: per-cell FAST with retry, exactly the reference loop."""
    minB = 16
    maxBX, maxBY = img.shape[1] - 16, img.shape[0] - 16
    width, height = maxBX - minB, maxBY - minB
    nCols, nRows = int(width / 30.0), int(height / 30.0)
    wCell, hCell = int(np.ceil(width / nCols)), int(np.ceil(height / nRows))
    det = cv2.FastFeatureDetector_create(ini_th, True)
    det_min = cv2.FastFeatureDetector_create(min_th, True)
    kps = []
    for i in range(nRows):
        iniY = minB + i * hCell
        maxY = min(iniY + hCell + 6, maxBY)
        if iniY >= maxBY - 3:
            continue
        for j in range(nCols):
            iniX = minB + j * wCell
            maxX = min(iniX + wCell + 6, maxBX)
            if iniX >= maxBX - 6:
                continue
            sub = img[iniY:maxY, iniX:maxX]
            cell = det.detect(sub)
            if not cell:
                cell = det_min.detect(sub)
            for kp in cell:
                kps.append(
                    (kp.pt[0] + iniX, kp.pt[1] + iniY, kp.response)
                )
    return sorted(kps)


@pytest.fixture(scope="module")
def luna(luna_gray):
    return luna_gray


def test_pyramid_bitwise_vs_cv2(luna):
    ours = fpyr.compute_pyramid(jnp.asarray(luna), 8, 1.2)
    oracle = cv2_pyramid(luna)
    for lvl in range(8):
        inner = np.asarray(ours[lvl])[19:-19, 19:-19]
        assert inner.shape == oracle[lvl].shape, lvl
        assert np.array_equal(inner, oracle[lvl]), (
            lvl,
            np.abs(inner.astype(int) - oracle[lvl].astype(int)).max(),
            (inner != oracle[lvl]).mean(),
        )


def test_border_reflect101_vs_cv2(luna):
    ours = np.asarray(fpyr.add_border_reflect101(jnp.asarray(luna), 19))
    oracle = cv2.copyMakeBorder(luna, 19, 19, 19, 19, cv2.BORDER_REFLECT_101)
    assert np.array_equal(ours, oracle)


def test_corner_score_matches_cv2_fast(luna):
    """Plain (non-celled) FAST: our score>=th mask+nonmax == cv2.FAST."""
    bordered = fpyr.add_border_reflect101(jnp.asarray(luna), 19)
    score = np.asarray(ffast.corner_score(bordered))
    th = 20
    kps = cv2.FastFeatureDetector_create(th, False).detect(luna)
    got = {(int(kp.pt[0]), int(kp.pt[1])): kp.response for kp in kps}
    H, W = luna.shape
    cand = score >= th
    cand[:3, :] = cand[-3:, :] = False
    cand[:, :3] = cand[:, -3:] = False
    exp = np.zeros_like(cand)
    for (x, y), r in got.items():
        exp[y, x] = True
    assert np.array_equal(cand, exp), (cand.sum(), exp.sum(), np.argwhere(cand != exp)[:5])
    # responses match too (cv2 only fills response with nonmax enabled)
    for kp in cv2.FastFeatureDetector_create(th, True).detect(luna):
        x, y = int(kp.pt[0]), int(kp.pt[1])
        assert score[y, x] == kp.response, ((x, y), score[y, x], kp.response)


def test_detect_keypoints_parity_all_levels(luna):
    pyr = fpyr.compute_pyramid(jnp.asarray(luna), 8, 1.2)
    for lvl in [0, 3, 7]:
        bordered = pyr[lvl]
        inner = np.asarray(bordered)[19:-19, 19:-19]
        keep, score = ffast.detect_keypoints(bordered, 20, 7)
        keep, score = np.asarray(keep), np.asarray(score)
        got = sorted(
            (float(x), float(y), float(score[y, x]))
            for y, x in np.argwhere(keep)
        )
        exp = sorted(cv2_cell_fast(inner))
        assert got == exp, (
            lvl, len(got), len(exp),
            set(map(lambda t: t[:2], got)) ^ set(map(lambda t: t[:2], exp)),
        )


def test_collect_keypoints_deterministic(luna):
    pyr = fpyr.compute_pyramid(jnp.asarray(luna), 2, 1.2)
    keep, score = ffast.detect_keypoints(pyr[0], 20, 7)
    xy, resp, valid = ffast.collect_keypoints(keep, score, 8192)
    n = int(np.asarray(keep).sum())
    assert int(valid.sum()) == min(n, 8192)
    xy, resp, valid = map(np.asarray, (xy, resp, valid))
    # all returned slots are real corners with matching responses
    k = np.asarray(keep)
    s = np.asarray(score)
    for i in range(int(valid.sum())):
        x, y = xy[i]
        assert k[y, x] and s[y, x] == resp[i]
    # descending score order
    r = resp[valid]
    assert np.all(np.diff(r) <= 0)
