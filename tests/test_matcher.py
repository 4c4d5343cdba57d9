"""Matcher tests: Hamming matrix vs numpy popcount, mutual-best vs cv2
BFMatcher (the reference demo's oracle, main_matcher.cpp:243-250), and
SearchForInitialization vs an exact sequential oracle of
ORBmatcher.cc:706-822."""

import cv2
import numpy as np
import jax.numpy as jnp

from extractorb.config import ORBConfig
from extractorb.frontend import extractor as fext
from extractorb.frontend import matcher as fmatch


def np_hamming(d1, d2):
    a = np.unpackbits(d1, axis=1).astype(np.int32)
    b = np.unpackbits(d2, axis=1).astype(np.int32)
    return (a[:, None, :] != b[None, :, :]).sum(-1)


def test_hamming_matrix_exact(rng):
    d1 = rng.integers(0, 256, (64, 32), dtype=np.uint8)
    d2 = rng.integers(0, 256, (96, 32), dtype=np.uint8)
    got = np.asarray(fmatch.hamming_matrix(jnp.asarray(d1), jnp.asarray(d2)))
    exp = np_hamming(d1, d2)
    assert np.array_equal(got, exp)


def extract_pair(tum_pair, n_features=1000):
    cfg = ORBConfig(n_features=n_features)
    ext = fext.ORBExtractor(cfg, octree="host")
    a, b = tum_pair
    return ext(jnp.asarray(a)), ext(jnp.asarray(b))


def test_mutual_best_vs_bfmatcher(tum_pair):
    f1, f2 = extract_pair(tum_pair)
    m12, dmin = fmatch.mutual_best_match(f1.desc, f1.valid, f2.desc, f2.valid)
    m12 = np.asarray(m12)
    v1, v2 = np.asarray(f1.valid), np.asarray(f2.valid)
    d1 = np.asarray(f1.desc)[v1]
    d2 = np.asarray(f2.desc)[v2]
    bf = cv2.BFMatcher(cv2.NORM_HAMMING, crossCheck=True)
    matches = bf.match(d1, d2)
    exp = {(m.queryIdx, m.trainIdx) for m in matches if m.distance <= 50}
    got = {(i, m12[i]) for i in range(len(m12)) if m12[i] >= 0}
    # identical up to distance ties in argmin order
    inter = len(exp & got)
    assert inter >= 0.95 * max(len(exp), 1), (len(exp), len(got), inter)
    assert abs(len(exp) - len(got)) <= 0.05 * max(len(exp), 1) + 2


def seq_search_for_initialization(f1, f2, window=100, ratio=0.9):
    """Exact sequential oracle (numpy) of the reference algorithm."""
    v1, v2 = np.asarray(f1.valid), np.asarray(f2.valid)
    xy1, xy2 = np.asarray(f1.xy), np.asarray(f2.xy)
    a1, a2 = np.asarray(f1.angle), np.asarray(f2.angle)
    o1, o2 = np.asarray(f1.octave), np.asarray(f2.octave)
    dist = np_hamming(np.asarray(f1.desc), np.asarray(f2.desc))
    N1, N2 = dist.shape
    matches12 = np.full(N1, -1)
    matches21 = np.full(N2, -1)
    matched_dist = np.full(N2, 1 << 30)
    rot_hist = [[] for _ in range(30)]
    for i1 in range(N1):
        if not v1[i1] or o1[i1] != 0:
            continue
        cand = np.where(
            v2 & (o2 == 0)
            & (np.abs(xy2[:, 0] - xy1[i1, 0]) < window)
            & (np.abs(xy2[:, 1] - xy1[i1, 1]) < window)
        )[0]
        best, best2, best_idx = 1 << 30, 1 << 30, -1
        for i2 in cand:
            d = dist[i1, i2]
            if matched_dist[i2] <= d:
                continue
            if d < best:
                best2, best, best_idx = best, d, i2
            elif d < best2:
                best2 = d
        if best <= 50 and best < best2 * ratio:
            if matches21[best_idx] >= 0:
                matches12[matches21[best_idx]] = -1
            matches12[i1] = best_idx
            matches21[best_idx] = i1
            matched_dist[best_idx] = best
            rot = a1[i1] - a2[best_idx]
            if rot < 0:
                rot += 360.0
            b = int(np.rint(rot / 30.0))
            if b == 30:
                b = 0
            rot_hist[b].append(i1)
    counts = [len(h) for h in rot_hist]
    order = np.argsort(counts)[::-1]
    ind = [order[0], -1, -1]
    if counts[order[1]] >= 0.1 * counts[order[0]]:
        ind[1] = order[1]
    if counts[order[2]] >= 0.1 * counts[order[0]]:
        ind[2] = order[2]
    for b in range(30):
        if b in ind:
            continue
        for i1 in rot_hist[b]:
            if matches12[i1] >= 0:
                matches12[i1] = -1
    return matches12


def test_search_for_initialization_vs_oracle(tum_pair):
    f1, f2 = extract_pair(tum_pair)
    got = np.asarray(
        fmatch.search_for_initialization(
            f1.desc, f1.xy, f1.angle, f1.octave, f1.valid,
            f2.desc, f2.xy, f2.angle, f2.octave, f2.valid,
        )
    )
    exp = seq_search_for_initialization(f1, f2)
    got_pairs = {(i, got[i]) for i in np.where(got >= 0)[0]}
    exp_pairs = {(i, exp[i]) for i in np.where(exp >= 0)[0]}
    inter = len(got_pairs & exp_pairs)
    # the sequential vMatchedDistance side effect on second-best values is
    # not modelled on device; everything else is exact
    assert len(exp_pairs) > 50, len(exp_pairs)
    assert inter >= 0.97 * len(exp_pairs), (len(exp_pairs), len(got_pairs), inter)
    assert abs(len(got_pairs) - len(exp_pairs)) <= max(3, 0.03 * len(exp_pairs))


def test_search_by_bow_word_gating(rng):
    """SearchByBoW: only same-word candidates; nn-ratio; TH_LOW gate."""
    N1, N2 = 48, 64
    d1 = rng.integers(0, 256, (N1, 32), dtype=np.uint8)
    # frame2: first N1 entries are near-copies of frame1 (few bit flips)
    d2 = rng.integers(0, 256, (N2, 32), dtype=np.uint8)
    d2[:N1] = d1
    for i in range(N1):
        d2[i, rng.integers(0, 32)] ^= 1 << int(rng.integers(0, 8))
    w1 = rng.integers(0, 8, N1).astype(np.int32)
    w2 = np.full(N2, -1, np.int32)
    w2[:N1] = w1  # same words for the copies
    a1 = np.zeros(N1, np.float32)
    a2 = np.zeros(N2, np.float32)
    v1 = np.ones(N1, bool)
    v2 = np.ones(N2, bool)
    m = np.asarray(fmatch.search_by_bow(
        jnp.asarray(d1), jnp.asarray(w1), jnp.asarray(a1), jnp.asarray(v1),
        jnp.asarray(d2), jnp.asarray(w2), jnp.asarray(a2), jnp.asarray(v2),
    ))
    matched = m >= 0
    # most near-copies should match to themselves
    assert (m[matched] == np.arange(N1)[matched]).all()
    assert matched.sum() >= 0.8 * N1
    # word mismatch must block: shuffle words
    w2_bad = np.full(N2, 7, np.int32)
    w1_bad = np.zeros(N1, np.int32)
    m_bad = np.asarray(fmatch.search_by_bow(
        jnp.asarray(d1), jnp.asarray(w1_bad), jnp.asarray(a1), jnp.asarray(v1),
        jnp.asarray(d2), jnp.asarray(w2_bad), jnp.asarray(a2), jnp.asarray(v2),
    ))
    assert (m_bad == -1).all()


def _synthetic_cloud(rng, M=60):
    pts = np.stack([
        rng.uniform(-2, 2, M), rng.uniform(-1.5, 1.5, M), rng.uniform(4, 8, M)
    ], -1).astype(np.float32)
    desc = rng.integers(0, 256, (M, 32), dtype=np.uint8)
    return pts, desc


def _pinhole_project():
    import jax.numpy as jnp2

    def project(pc):
        return jnp2.stack(
            [500.0 * pc[0] / pc[2] + 320.0, 500.0 * pc[1] / pc[2] + 240.0], -1
        ).reshape(2)

    return project


def test_fuse_by_projection_finds_reobservations(rng):
    pts, desc = _synthetic_cloud(rng)
    M = len(pts)
    project = _pinhole_project()
    scale_factors = tuple(1.2 ** i for i in range(8))
    uv = np.stack([
        500 * pts[:, 0] / pts[:, 2] + 320, 500 * pts[:, 1] / pts[:, 2] + 240
    ], -1).astype(np.float32)
    keep = (uv[:, 0] > 5) & (uv[:, 0] < 635) & (uv[:, 1] > 5) & (uv[:, 1] < 475)
    normal = np.zeros((M, 3), np.float32)
    normal[:, 2] = -1.0  # viewing direction from origin
    normal = (pts / np.linalg.norm(pts, axis=1, keepdims=True)).astype(np.float32)
    dist = np.linalg.norm(pts, axis=1).astype(np.float32)
    max_dist = (dist * 1.05).astype(np.float32)
    m = np.asarray(fmatch.fuse_by_projection(
        jnp.asarray(pts), jnp.asarray(desc), jnp.asarray(np.ones(M, bool)),
        jnp.asarray(normal), jnp.asarray(max_dist),
        jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32),
        jnp.asarray(uv), jnp.asarray(desc), jnp.zeros(M, jnp.int32),
        jnp.asarray(np.ones(M, bool)),
        project, scale_factors, (640.0, 480.0),
    ))
    ok = m >= 0
    assert ok[keep].mean() > 0.9
    assert (m[ok] == np.arange(M)[ok]).all()


def test_search_by_projection_reloc_rotation_filter(rng):
    pts, desc = _synthetic_cloud(rng)
    M = len(pts)
    project = _pinhole_project()
    scale_factors = tuple(1.2 ** i for i in range(8))
    uv = np.stack([
        500 * pts[:, 0] / pts[:, 2] + 320, 500 * pts[:, 1] / pts[:, 2] + 240
    ], -1).astype(np.float32)
    dist = np.linalg.norm(pts, axis=1).astype(np.float32)
    max_dist = (dist * 1.05).astype(np.float32)
    angles = rng.uniform(0, 360, M).astype(np.float32)
    m = np.asarray(fmatch.search_by_projection_reloc(
        jnp.asarray(pts), jnp.asarray(desc), jnp.asarray(np.ones(M, bool)),
        jnp.zeros(M, jnp.int32), jnp.asarray(angles), jnp.asarray(max_dist),
        jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32),
        jnp.asarray(uv), jnp.asarray(desc), jnp.zeros(M, jnp.int32),
        jnp.asarray(angles), jnp.asarray(np.ones(M, bool)),
        project, scale_factors, (640.0, 480.0),
    ))
    ok = m >= 0
    # consistent rotation (same angle both sides -> bin 0 dominates)
    assert ok.mean() > 0.7
    assert (m[ok] == np.arange(M)[ok]).all()


def test_search_by_projection_sim3_scale(rng):
    """Points expressed in a scaled/rotated frame are still re-found when
    projected through the matching Sim3."""
    pts, desc = _synthetic_cloud(rng)
    M = len(pts)
    project = _pinhole_project()
    scale_factors = tuple(1.2 ** i for i in range(8))
    uv = np.stack([
        500 * pts[:, 0] / pts[:, 2] + 320, 500 * pts[:, 1] / pts[:, 2] + 240
    ], -1).astype(np.float32)
    s = 2.0
    # world points w = pts / s  (so s * I * w + 0 = pts = camera coords)
    w = (pts / s).astype(np.float32)
    normal = (w / np.linalg.norm(w, axis=1, keepdims=True)).astype(np.float32)
    dist = np.linalg.norm(w, axis=1).astype(np.float32)
    max_dist = (dist * 1.05).astype(np.float32)
    m = np.asarray(fmatch.search_by_projection_sim3(
        jnp.asarray(w), jnp.asarray(desc), jnp.asarray(np.ones(M, bool)),
        jnp.asarray(normal), jnp.asarray(max_dist),
        jnp.float32(s), jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32),
        jnp.asarray(uv), jnp.asarray(desc), jnp.zeros(M, jnp.int32),
        jnp.asarray(np.ones(M, bool)),
        project, scale_factors, (640.0, 480.0),
    ))
    ok = m >= 0
    assert ok.mean() > 0.8
    assert (m[ok] == np.arange(M)[ok]).all()


def test_search_by_sim3_mutual(rng):
    pts, desc = _synthetic_cloud(rng)
    M = len(pts)
    project = _pinhole_project()
    scale_factors = tuple(1.2 ** i for i in range(8))
    uv = np.stack([
        500 * pts[:, 0] / pts[:, 2] + 320, 500 * pts[:, 1] / pts[:, 2] + 240
    ], -1).astype(np.float32)
    dist = np.linalg.norm(pts, axis=1).astype(np.float32)
    max_dist = (dist * 1.05).astype(np.float32)
    m = np.asarray(fmatch.search_by_sim3(
        jnp.asarray(pts), jnp.asarray(desc), jnp.asarray(np.ones(M, bool)),
        jnp.asarray(pts), jnp.asarray(desc), jnp.asarray(np.ones(M, bool)),
        jnp.float32(1.0), jnp.eye(3, dtype=jnp.float32),
        jnp.zeros(3, jnp.float32),
        jnp.asarray(np.zeros(M, bool)),
        project, scale_factors,
        kp_xy1=jnp.asarray(uv), kp_xy2=jnp.asarray(uv),
        kp_octave1=jnp.zeros(M, jnp.int32), kp_octave2=jnp.zeros(M, jnp.int32),
        max_dist1=jnp.asarray(max_dist), max_dist2=jnp.asarray(max_dist),
    ))
    ok = m >= 0
    assert ok.mean() > 0.8
    assert (m[ok] == np.arange(M)[ok]).all()
