"""Descriptor matching as dense bit-plane products.

Replaces ORBmatcher's Hamming-distance searches (reference:
src/ORBmatcher.cc).  The 256-bit popcount distance (DescriptorDistance,
ORBmatcher.cc:2349-2366) becomes a bit-plane matmul:

    popcount(a XOR b) = sum(a) + sum(b) - 2 a.b      for bits a, b

so a whole (N1, N2) distance matrix is one (N1,256)x(256,N2) matmul with
exactly the XOR+popcount semantics.  The reference's
grid-window candidate gating, mutual-conflict stealing, NN-ratio test and
rotation-histogram filtering are reproduced as masks and scatter-max ops
over the dense matrix.

Constants TH_LOW=50, TH_HIGH=100, HISTO_LENGTH=30 (ORBmatcher.cc:36-38).
The reference's rotation histogram uses factor = 1/HISTO_LENGTH (a
well-known ORB-SLAM quirk: 30-degree-wide bins, only bins 0..12 used) —
reproduced bit-for-bit (ORBmatcher.cc:706+60).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp

TH_LOW = 50
TH_HIGH = 100
HISTO_LENGTH = 30


@jax.jit
def unpack_bits(desc_u8: jnp.ndarray) -> jnp.ndarray:
    """(N, 32) uint8 -> (N, 256) bit planes in bf16 (exact 0/1)."""
    n = desc_u8.shape[0]
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (desc_u8[:, :, None] >> shifts[None, None, :]) & 1
    return bits.reshape(n, 256).astype(jnp.bfloat16)


@jax.jit
def hamming_matrix(desc1_u8: jnp.ndarray, desc2_u8: jnp.ndarray) -> jnp.ndarray:
    """(N1, N2) int32 Hamming distances between packed descriptors.

    The bf16 0/1 operands are exact, and every dot product is an integer
    <= 256 accumulated in f32, so the result is exact at any precision."""
    a = unpack_bits(desc1_u8)
    b = unpack_bits(desc2_u8)
    dots = jnp.dot(a, b.T, preferred_element_type=jnp.float32)
    sa = jnp.sum(a.astype(jnp.float32), axis=1)
    sb = jnp.sum(b.astype(jnp.float32), axis=1)
    return (sa[:, None] + sb[None, :] - 2.0 * dots).astype(jnp.int32)


def rotation_consistency_mask(angle1, angle2, cand_valid):
    """Reference rotation-histogram filter (ComputeThreeMaxima,
    ORBmatcher.cc:2303): returns per-candidate keep mask.

    angle1/angle2: (N1,) angles of kp1 and its matched kp2.
    cand_valid: (N1,) bool — entries that were entered into the histogram.
    """
    rot = angle1 - angle2
    rot = jnp.where(rot < 0, rot + 360.0, rot)
    factor = jnp.float32(1.0 / HISTO_LENGTH)  # reference quirk
    binf = jnp.rint(rot * factor).astype(jnp.int32)
    binf = jnp.where(binf == HISTO_LENGTH, 0, binf)
    binf = jnp.clip(binf, 0, HISTO_LENGTH - 1)
    hist = jnp.zeros((HISTO_LENGTH,), jnp.int32).at[binf].add(
        cand_valid.astype(jnp.int32)
    )
    top3 = jax.lax.top_k(hist, 3)
    max1, max2, max3 = top3[0][0], top3[0][1], top3[0][2]
    i1, i2, i3 = top3[1][0], top3[1][1], top3[1][2]
    # reference drops bin2/bin3 when much weaker than bin1
    keep2 = max2.astype(jnp.float32) >= 0.1 * max1.astype(jnp.float32)
    keep3 = max3.astype(jnp.float32) >= 0.1 * max1.astype(jnp.float32)
    ok = (binf == i1) | (keep2 & (binf == i2)) | (keep3 & (binf == i3))
    return ok & cand_valid


@functools.partial(jax.jit, static_argnums=(10,))
def search_for_initialization(
    desc1, xy1, angle1, octave1, valid1,
    desc2, xy2, angle2, octave2, valid2,
    window: int = 100,
    prev_matched=None,
    nn_ratio: float = 0.9,
):
    """ORBmatcher::SearchForInitialization (reference ORBmatcher.cc:706-822).

    Level-0 keypoints of frame1 search a +-window box (around
    prev_matched, default their own position) in frame2's level-0
    keypoints; best/second-best with NN ratio, TH_LOW gate, sequential
    conflict stealing (later i1 wins), rotation histogram top-3 filter.

    Returns (matches12 (N1,) int32 index into frame2 or -1).
    """
    if prev_matched is None:
        prev_matched = xy1

    dist = hamming_matrix(desc1, desc2)  # (N1, N2)

    dx = jnp.abs(prev_matched[:, 0:1] - xy2[None, :, 0])
    dy = jnp.abs(prev_matched[:, 1:2] - xy2[None, :, 1])
    in_window = (dx < window) & (dy < window)
    ok2 = valid2 & (octave2 == 0)
    ok1 = valid1 & (octave1 == 0)
    mask = in_window & ok2[None, :] & ok1[:, None]

    INF = jnp.int32(1 << 20)
    d = jnp.where(mask, dist, INF)
    best = jnp.min(d, axis=1)
    best_idx = jnp.argmin(d, axis=1)
    # second best: mask out the best column per row
    d2 = d.at[jnp.arange(d.shape[0]), best_idx].set(INF)
    second = jnp.min(d2, axis=1)

    accept = (
        (best <= TH_LOW)
        & (best.astype(jnp.float32) < nn_ratio * second.astype(jnp.float32))
        & ok1
    )

    # Conflict resolution.  The reference processes i1 sequentially with
    # vMatchedDistance gating (a later i1 steals kp2 only with a strictly
    # smaller distance), so the final owner of a kp2 is the minimum-dist
    # claimant (ties keep the earlier i1).  We reproduce that fixed point
    # directly with a scatter-min; the one sequential effect not modelled
    # is vMatchedDistance's influence on later rows' second-best values.
    n1, n2 = d.shape
    i1 = jnp.arange(n1, dtype=jnp.int32)
    claim_key = best * n1 + i1  # dist-major, earlier-i1 tiebreak
    INF_KEY = jnp.int32(2**31 - 1)
    winner = jnp.full((n2,), INF_KEY, jnp.int32).at[
        jnp.where(accept, best_idx, n2)
    ].min(jnp.where(accept, claim_key, INF_KEY), mode="drop")
    final = accept & (winner[best_idx] == claim_key)

    # rotation histogram built from ALL accepted-at-some-point entries
    # (stale stolen entries included, like the reference)
    a2 = angle2[best_idx]
    rot_ok = rotation_consistency_mask(angle1, a2, accept)
    final = final & rot_ok

    return jnp.where(final, best_idx, -1)


@jax.jit
def mutual_best_match(desc1, valid1, desc2, valid2, max_dist: int = TH_LOW):
    """Simple mutual-nearest matcher (the demos' BFMatcher oracle analog,
    main_matcher.cpp:243-250): used for tests and generic two-view ops."""
    dist = hamming_matrix(desc1, desc2)
    INF = jnp.int32(1 << 20)
    d = jnp.where(valid1[:, None] & valid2[None, :], dist, INF)
    best12 = jnp.argmin(d, axis=1)
    best21 = jnp.argmin(d, axis=0)
    i1 = jnp.arange(d.shape[0], dtype=jnp.int32)
    mutual = best21[best12] == i1
    dmin = jnp.min(d, axis=1)
    ok = mutual & (dmin <= max_dist) & valid1
    return jnp.where(ok, best12, -1), dmin


def _first_claim(best_idx, accept, n_kp):
    """First-come conflict resolution: the smallest map-point index claims
    a keypoint (the reference skips already-assigned keypoints, so earlier
    map points win; ORBmatcher.cc:2028 region)."""
    M = best_idx.shape[0]
    mp_i = jnp.arange(M, dtype=jnp.int32)
    winner = jnp.full((n_kp,), M, jnp.int32).at[
        jnp.where(accept, best_idx, n_kp)
    ].min(jnp.where(accept, mp_i, M), mode="drop")
    return accept & (winner[best_idx] == mp_i)


@functools.partial(jax.jit, static_argnums=(12, 13, 14))
def search_by_projection_last_frame(
    mp_pos, mp_desc, mp_valid, mp_octave, mp_angle,
    R, t,
    kp_xy, kp_desc, kp_octave, kp_angle, kp_valid_and_free,
    project, scale_factors, img_wh,
    th: float = 15.0,
):
    """SearchByProjection, track-with-motion-model variant (reference
    ORBmatcher.cc:2028 region): project the last frame's map points with
    the predicted pose, search a th*scale[lastOctave] window in levels
    [lastOct-1, lastOct+1], keep best <= TH_HIGH, rotation-histogram
    filter, first-come conflict resolution.

    Returns matches (M,) int32: keypoint index per map point or -1.
    """
    M = mp_pos.shape[0]
    N = kp_xy.shape[0]
    scales = jnp.asarray(scale_factors, jnp.float32)

    pc = jnp.einsum("ij,mj->mi", R, mp_pos) + t[None]
    z_ok = pc[:, 2] > 0
    uv = jax.vmap(project)(pc)
    in_img = (
        (uv[:, 0] >= 0) & (uv[:, 0] < img_wh[0])
        & (uv[:, 1] >= 0) & (uv[:, 1] < img_wh[1])
    )

    radius = th * scales[jnp.clip(mp_octave, 0, len(scale_factors) - 1)]
    dx = jnp.abs(uv[:, 0:1] - kp_xy[None, :, 0])
    dy = jnp.abs(uv[:, 1:2] - kp_xy[None, :, 1])
    in_win = (dx < radius[:, None]) & (dy < radius[:, None])
    lvl_ok = (kp_octave[None, :] >= (mp_octave - 1)[:, None]) & (
        kp_octave[None, :] <= (mp_octave + 1)[:, None]
    )
    row_ok = mp_valid & z_ok & in_img
    mask = in_win & lvl_ok & row_ok[:, None] & kp_valid_and_free[None, :]

    dist = hamming_matrix(mp_desc, kp_desc)
    INF = jnp.int32(1 << 20)
    d = jnp.where(mask, dist, INF)
    best = jnp.min(d, axis=1)
    best_idx = jnp.argmin(d, axis=1)
    accept = (best <= TH_HIGH) & row_ok

    final = _first_claim(best_idx, accept, N)
    rot_ok = rotation_consistency_mask(mp_angle, kp_angle[best_idx], accept)
    final = final & rot_ok
    return jnp.where(final, best_idx, -1)


@functools.partial(jax.jit, static_argnums=(12, 13, 14))
def search_by_projection_local_map(
    mp_pos, mp_desc, mp_valid, mp_normal, mp_max_dist,
    R, t,
    kp_xy, kp_desc, kp_octave, kp_valid_and_free, kp_taken_dist_gate,
    project, scale_factors, img_wh,
    th: float = 1.0,
    nn_ratio: float = 0.8,
):
    """SearchByProjection, track-local-map variant (reference
    ORBmatcher.cc:44-216): frustum check, viewing-cos radius (2.5 or 4.0),
    predicted scale from distance, levels [pred-1, pred], NN-ratio applied
    only when best and second-best are on the same level, TH_HIGH gate.

    Returns matches (M,) int32 keypoint index per map point or -1.
    """
    M = mp_pos.shape[0]
    N = kp_xy.shape[0]
    n_levels = len(scale_factors)
    scales = jnp.asarray(scale_factors, jnp.float32)
    log_scale = jnp.log(scales[1])

    pc = jnp.einsum("ij,mj->mi", R, mp_pos) + t[None]
    z_ok = pc[:, 2] > 0
    uv = jax.vmap(project)(pc)
    in_img = (
        (uv[:, 0] >= 0) & (uv[:, 0] < img_wh[0])
        & (uv[:, 1] >= 0) & (uv[:, 1] < img_wh[1])
    )

    # viewing direction check (isInFrustum: cos(normal, view) >= 0.5)
    Ow = -jnp.einsum("ji,j->i", R, t)  # camera centre in world
    view = mp_pos - Ow[None]
    dist3 = jnp.linalg.norm(view, axis=-1)
    view_cos = jnp.sum(view * mp_normal, -1) / jnp.maximum(dist3, 1e-9)
    frustum_ok = view_cos >= 0.5
    # distance within scale-invariance region [0.8 min, 1.2 max]; minDist
    # = maxDist / scale^(nlevels-1)
    min_dist = mp_max_dist / scales[n_levels - 1]
    dist_ok = (dist3 >= 0.8 * min_dist) & (dist3 <= 1.2 * mp_max_dist)

    # predicted scale level (MapPoint::PredictScale)
    ratio = mp_max_dist / jnp.maximum(dist3, 1e-9)
    pred = jnp.ceil(jnp.log(ratio) / log_scale).astype(jnp.int32)
    pred = jnp.clip(pred, 0, n_levels - 1)

    radius = jnp.where(view_cos > 0.998, 2.5, 4.0) * scales[pred] * th

    dx = jnp.abs(uv[:, 0:1] - kp_xy[None, :, 0])
    dy = jnp.abs(uv[:, 1:2] - kp_xy[None, :, 1])
    in_win = (dx < radius[:, None]) & (dy < radius[:, None])
    lvl_ok = (kp_octave[None, :] >= (pred - 1)[:, None]) & (
        kp_octave[None, :] <= pred[:, None]
    )
    row_ok = mp_valid & z_ok & in_img & frustum_ok & dist_ok
    mask = in_win & lvl_ok & row_ok[:, None] & kp_valid_and_free[None, :]

    dist = hamming_matrix(mp_desc, kp_desc)
    INF = jnp.int32(1 << 20)
    d = jnp.where(mask, dist, INF)
    best = jnp.min(d, axis=1)
    best_idx = jnp.argmin(d, axis=1)
    d2 = d.at[jnp.arange(M), best_idx].set(INF)
    second = jnp.min(d2, axis=1)
    second_idx = jnp.argmin(d2, axis=1)
    best_lvl = kp_octave[best_idx]
    second_lvl = kp_octave[second_idx]
    ratio_fail = (
        (best_lvl == second_lvl)
        & (best.astype(jnp.float32) > nn_ratio * second.astype(jnp.float32))
        & (second < INF)
    )
    accept = (best <= TH_HIGH) & row_ok & ~ratio_fail
    final = _first_claim(best_idx, accept, N)
    return jnp.where(final, best_idx, -1)


@jax.jit
def search_for_triangulation(
    desc1, xy1, octave1, free1,
    desc2, xy2, octave2, free2,
    F12, sigma2_levels,
):
    """ORBmatcher::SearchForTriangulation (reference ORBmatcher.cc:965):
    match unassociated keypoints of two keyframes under the epipolar
    constraint dist(kp2, F12^T kp1)^2 < 3.84 sigma2[octave2], best
    distance <= TH_LOW, min-dist conflict resolution per kp2.

    (The reference restricts candidates via shared BoW nodes — a speed
    optimisation; the dense matrix covers the superset.)

    Returns matches (N1,) int32 index into kf2 or -1.
    """
    N1 = xy1.shape[0]
    N2 = xy2.shape[0]
    dist = hamming_matrix(desc1, desc2)

    # epipolar lines in image 2: l = F12^T p1 (reference computes
    # a = kp1.x*F[0,0]+kp1.y*F[1,0]+F[2,0], i.e. columns of F12)
    o = jnp.ones((N1, 1), xy1.dtype)
    p1 = jnp.concatenate([xy1, o], 1)
    l2 = p1 @ F12  # (N1,3): [a, b, c]
    num = l2[:, 0:1] * xy2[None, :, 0] + l2[:, 1:2] * xy2[None, :, 1] + l2[:, 2:3]
    den = l2[:, 0:1] ** 2 + l2[:, 1:2] ** 2
    d2 = num * num / jnp.maximum(den, 1e-12)
    sig2 = sigma2_levels[jnp.clip(octave2, 0, sigma2_levels.shape[0] - 1)]
    epi_ok = d2 < 3.84 * sig2[None, :]

    mask = epi_ok & free1[:, None] & free2[None, :]
    INF = jnp.int32(1 << 20)
    d = jnp.where(mask, dist, INF)
    best = jnp.min(d, axis=1)
    best_idx = jnp.argmin(d, axis=1)
    accept = best <= TH_LOW

    # one kp2 per kp1: min-dist claim
    i1 = jnp.arange(N1, dtype=jnp.int32)
    claim_key = best * N1 + i1
    INF_KEY = jnp.int32(2**31 - 1)
    winner = jnp.full((N2,), INF_KEY, jnp.int32).at[
        jnp.where(accept, best_idx, N2)
    ].min(jnp.where(accept, claim_key, INF_KEY), mode="drop")
    final = accept & (winner[best_idx] == claim_key)
    return jnp.where(final, best_idx, -1)


@functools.partial(jax.jit, static_argnums=(9,))
def search_by_bow(
    desc1, word1, angle1, valid1,
    desc2, word2, angle2, valid2,
    nn_ratio: float = 0.7,
    check_rotation: bool = True,
):
    """ORBmatcher::SearchByBoW (reference ORBmatcher.cc:269 KF<->Frame and
    :823 KF<->KF): candidates are restricted to keypoints whose vocabulary
    tree node (FeatureVector level-4 node id) agrees -- here a dense
    (N1,N2) word-equality mask over the Hamming matrix -- then best/
    second-best NN-ratio, TH_LOW gate, rotation-histogram filter, and
    min-dist conflict resolution per kp2.

    word1/word2: (N,) int32 vocabulary node ids (-1 = invalid).
    Returns (N1,) int32 index into set 2 or -1.
    """
    N1, N2 = desc1.shape[0], desc2.shape[0]
    dist = hamming_matrix(desc1, desc2)
    same_node = word1[:, None] == word2[None, :]
    mask = (
        same_node
        & valid1[:, None] & valid2[None, :]
        & (word1 >= 0)[:, None] & (word2 >= 0)[None, :]
    )
    INF = jnp.int32(1 << 20)
    d = jnp.where(mask, dist, INF)
    best = jnp.min(d, axis=1)
    best_idx = jnp.argmin(d, axis=1)
    d2 = d.at[jnp.arange(N1), best_idx].set(INF)
    second = jnp.min(d2, axis=1)
    accept = (
        (best <= TH_LOW)
        & (best.astype(jnp.float32) < nn_ratio * second.astype(jnp.float32))
    )

    # one kp2 per kp1 (min-dist claim, earlier row tie-break)
    i1 = jnp.arange(N1, dtype=jnp.int32)
    claim_key = best * N1 + i1
    INF_KEY = jnp.int32(2**31 - 1)
    winner = jnp.full((N2,), INF_KEY, jnp.int32).at[
        jnp.where(accept, best_idx, N2)
    ].min(jnp.where(accept, claim_key, INF_KEY), mode="drop")
    final = accept & (winner[best_idx] == claim_key)

    if check_rotation:
        rot_ok = rotation_consistency_mask(angle1, angle2[best_idx], accept)
        final = final & rot_ok
    return jnp.where(final, best_idx, -1)


def _predict_scale(dist3, mp_max_dist, scale_factors):
    """MapPoint::PredictScale (reference inc/MapPoint.h:172-173)."""
    n_levels = len(scale_factors)
    scales = jnp.asarray(scale_factors, jnp.float32)
    log_scale = jnp.log(scales[1])
    ratio = mp_max_dist / jnp.maximum(dist3, 1e-9)
    pred = jnp.ceil(jnp.log(ratio) / log_scale).astype(jnp.int32)
    return jnp.clip(pred, 0, n_levels - 1)


@functools.partial(jax.jit, static_argnums=(11, 12, 13))
def fuse_by_projection(
    mp_pos, mp_desc, mp_valid, mp_normal, mp_max_dist,
    R, t,
    kp_xy, kp_desc, kp_octave, kp_valid,
    project, scale_factors, img_wh,
    th: float = 3.0,
):
    """ORBmatcher::Fuse (reference ORBmatcher.cc:1399): project map points
    into a keyframe; candidates within th*scale[pred] of the projection at
    levels [pred-1, pred+1]; accept best Hamming <= TH_LOW.  Depth must be
    inside the scale-invariance region and viewing cos >= 0.5.

    Returns (M,) int32: best keypoint index per map point or -1.  The
    host decides replace-vs-add-observation per the reference semantics.
    """
    M = mp_pos.shape[0]
    scales = jnp.asarray(scale_factors, jnp.float32)

    pc = jnp.einsum("ij,mj->mi", R, mp_pos) + t[None]
    z_ok = pc[:, 2] > 0
    uv = jax.vmap(project)(pc)
    in_img = (
        (uv[:, 0] >= 0) & (uv[:, 0] < img_wh[0])
        & (uv[:, 1] >= 0) & (uv[:, 1] < img_wh[1])
    )
    Ow = -jnp.einsum("ji,j->i", R, t)
    view = mp_pos - Ow[None]
    dist3 = jnp.linalg.norm(view, axis=-1)
    n_levels = len(scale_factors)
    min_dist = mp_max_dist / scales[n_levels - 1]
    dist_ok = (dist3 >= min_dist) & (dist3 <= mp_max_dist)
    view_cos = jnp.sum(view * mp_normal, -1) / jnp.maximum(dist3, 1e-9)
    angle_ok = view_cos >= 0.5

    pred = _predict_scale(dist3, mp_max_dist, scale_factors)
    radius = th * scales[pred]
    dx = jnp.abs(uv[:, 0:1] - kp_xy[None, :, 0])
    dy = jnp.abs(uv[:, 1:2] - kp_xy[None, :, 1])
    in_win = (dx < radius[:, None]) & (dy < radius[:, None])
    lvl_ok = (kp_octave[None, :] >= (pred - 1)[:, None]) & (
        kp_octave[None, :] <= (pred + 1)[:, None]
    )
    row_ok = mp_valid & z_ok & in_img & dist_ok & angle_ok
    mask = in_win & lvl_ok & row_ok[:, None] & kp_valid[None, :]

    dist = hamming_matrix(mp_desc, kp_desc)
    INF = jnp.int32(1 << 20)
    d = jnp.where(mask, dist, INF)
    best = jnp.min(d, axis=1)
    best_idx = jnp.argmin(d, axis=1)
    accept = (best <= TH_LOW) & row_ok
    return jnp.where(accept, best_idx, -1)


@functools.partial(jax.jit, static_argnums=(12, 13, 14))
def search_by_projection_sim3(
    mp_pos, mp_desc, mp_valid, mp_normal, mp_max_dist,
    s, R, t,
    kp_xy, kp_desc, kp_octave, kp_valid_and_free,
    project, scale_factors, img_wh,
    th: float = 7.5,
):
    """SearchByProjection through a Sim3 Scw (reference ORBmatcher.cc:473,
    used by loop closing to re-find loop map points in the current
    keyframe): project s*R*p + t, depth within scale-invariance region,
    radius th*scale[pred], best Hamming <= TH_LOW (no rotation check).

    Returns (M,) int32 keypoint index per map point or -1.
    """
    scales = jnp.asarray(scale_factors, jnp.float32)
    n_levels = len(scale_factors)

    pc = s * jnp.einsum("ij,mj->mi", R, mp_pos) + t[None]
    z_ok = pc[:, 2] > 0
    uv = jax.vmap(project)(pc)
    in_img = (
        (uv[:, 0] >= 0) & (uv[:, 0] < img_wh[0])
        & (uv[:, 1] >= 0) & (uv[:, 1] < img_wh[1])
    )
    # camera centre of Scw in world coords: -(1/s) R^T t
    Ow = -jnp.einsum("ji,j->i", R, t) / jnp.maximum(s, 1e-12)
    view = mp_pos - Ow[None]
    dist3 = jnp.linalg.norm(view, axis=-1)
    min_dist = mp_max_dist / scales[n_levels - 1]
    dist_ok = (dist3 >= min_dist) & (dist3 <= mp_max_dist)
    view_cos = jnp.sum(view * mp_normal, -1) / jnp.maximum(dist3, 1e-9)
    angle_ok = view_cos >= 0.5

    pred = _predict_scale(dist3, mp_max_dist, scale_factors)
    radius = th * scales[pred]
    dx = jnp.abs(uv[:, 0:1] - kp_xy[None, :, 0])
    dy = jnp.abs(uv[:, 1:2] - kp_xy[None, :, 1])
    in_win = (dx < radius[:, None]) & (dy < radius[:, None])
    lvl_ok = (kp_octave[None, :] >= (pred - 1)[:, None]) & (
        kp_octave[None, :] <= (pred + 1)[:, None]
    )
    row_ok = mp_valid & z_ok & in_img & dist_ok & angle_ok
    mask = in_win & lvl_ok & row_ok[:, None] & kp_valid_and_free[None, :]

    dist = hamming_matrix(mp_desc, kp_desc)
    INF = jnp.int32(1 << 20)
    d = jnp.where(mask, dist, INF)
    best = jnp.min(d, axis=1)
    best_idx = jnp.argmin(d, axis=1)
    accept = (best <= TH_LOW) & row_ok
    final = _first_claim(best_idx, accept, kp_xy.shape[0])
    return jnp.where(final, best_idx, -1)


@functools.partial(jax.jit, static_argnums=(13, 14, 15))
def search_by_projection_reloc(
    mp_pos, mp_desc, mp_valid, mp_octave, mp_angle, mp_max_dist,
    R, t,
    kp_xy, kp_desc, kp_octave, kp_angle, kp_valid_and_free,
    project, scale_factors, img_wh,
    th: float = 10.0,
    orb_dist: int = 100,
):
    """SearchByProjection, relocalization variant (reference
    ORBmatcher.cc:2179): project candidate-KF map points with the PnP
    pose; window th*scale[pred] from predicted scale, levels
    [pred-1, pred+1], best <= ORBdist, rotation-histogram filter,
    first-come conflict resolution.

    Returns (M,) int32 keypoint index per map point or -1.
    """
    N = kp_xy.shape[0]
    scales = jnp.asarray(scale_factors, jnp.float32)

    pc = jnp.einsum("ij,mj->mi", R, mp_pos) + t[None]
    z_ok = pc[:, 2] > 0
    uv = jax.vmap(project)(pc)
    in_img = (
        (uv[:, 0] >= 0) & (uv[:, 0] < img_wh[0])
        & (uv[:, 1] >= 0) & (uv[:, 1] < img_wh[1])
    )
    Ow = -jnp.einsum("ji,j->i", R, t)
    dist3 = jnp.linalg.norm(mp_pos - Ow[None], axis=-1)
    pred = _predict_scale(dist3, mp_max_dist, scale_factors)
    radius = th * scales[pred]

    dx = jnp.abs(uv[:, 0:1] - kp_xy[None, :, 0])
    dy = jnp.abs(uv[:, 1:2] - kp_xy[None, :, 1])
    in_win = (dx < radius[:, None]) & (dy < radius[:, None])
    lvl_ok = (kp_octave[None, :] >= (pred - 1)[:, None]) & (
        kp_octave[None, :] <= (pred + 1)[:, None]
    )
    row_ok = mp_valid & z_ok & in_img
    mask = in_win & lvl_ok & row_ok[:, None] & kp_valid_and_free[None, :]

    dist = hamming_matrix(mp_desc, kp_desc)
    INF = jnp.int32(1 << 20)
    d = jnp.where(mask, dist, INF)
    best = jnp.min(d, axis=1)
    best_idx = jnp.argmin(d, axis=1)
    accept = (best <= orb_dist) & row_ok
    final = _first_claim(best_idx, accept, N)
    rot_ok = rotation_consistency_mask(mp_angle, kp_angle[best_idx], accept)
    final = final & rot_ok
    return jnp.where(final, best_idx, -1)


@functools.partial(jax.jit, static_argnums=(10, 11))
def search_by_sim3(
    pos1, desc1, valid1, pos2, desc2, valid2,
    s12, R12, t12,
    already,
    project, scale_factors,
    kp_xy1=None, kp_xy2=None, kp_octave1=None, kp_octave2=None,
    max_dist1=None, max_dist2=None,
    img_wh=(640.0, 480.0),
    th: float = 7.5,
):
    """ORBmatcher::SearchBySim3 (reference ORBmatcher.cc:1735): given a
    candidate Sim3 S12 between the map points of KF1 and KF2 (both given
    in their own camera frames), project each side's points into the
    other image, gate by predicted scale window, best <= TH_HIGH, and
    keep only MUTUALLY agreeing pairs.

    pos1/pos2: (N,3) map-point positions in camera frames 1 / 2.
    already: (N1,) bool -- pairs already matched (excluded).
    Returns (N1,) int32 index into set 2 or -1.
    """
    scales = jnp.asarray(scale_factors, jnp.float32)
    N1, N2 = pos1.shape[0], pos2.shape[0]

    # S21 = inverse of S12
    s21 = 1.0 / jnp.maximum(s12, 1e-12)
    R21 = R12.T
    t21 = -s21 * jnp.einsum("ji,j->i", R12, t12)

    def gated_best(pos_src, desc_src, valid_src, max_dist_src,
                   s, R, t, kp_xy, kp_oct, desc_dst, valid_dst):
        pc = s * jnp.einsum("ij,mj->mi", R, pos_src) + t[None]
        z_ok = pc[:, 2] > 0
        uv = jax.vmap(project)(pc)
        in_img = (
            (uv[:, 0] >= 0) & (uv[:, 0] < img_wh[0])
            & (uv[:, 1] >= 0) & (uv[:, 1] < img_wh[1])
        )
        dist3 = jnp.linalg.norm(pc, axis=-1)
        n_levels = len(scale_factors)
        min_d = max_dist_src / scales[n_levels - 1]
        dist_ok = (dist3 >= min_d) & (dist3 <= max_dist_src)
        pred = _predict_scale(dist3, max_dist_src, scale_factors)
        radius = th * scales[pred]
        dx = jnp.abs(uv[:, 0:1] - kp_xy[None, :, 0])
        dy = jnp.abs(uv[:, 1:2] - kp_xy[None, :, 1])
        in_win = (dx < radius[:, None]) & (dy < radius[:, None])
        lvl_ok = (kp_oct[None, :] >= (pred - 1)[:, None]) & (
            kp_oct[None, :] <= (pred + 1)[:, None]
        )
        row_ok = valid_src & z_ok & in_img & dist_ok
        mask = in_win & lvl_ok & row_ok[:, None] & valid_dst[None, :]
        d = jnp.where(mask, hamming_matrix(desc_src, desc_dst), jnp.int32(1 << 20))
        best = jnp.min(d, axis=1)
        idx = jnp.argmin(d, axis=1)
        return jnp.where((best <= TH_HIGH) & row_ok, idx, -1)

    m12 = gated_best(pos1, desc1, valid1 & ~already, max_dist1,
                     s21, R21, t21, kp_xy2, kp_octave2, desc2, valid2)
    m21 = gated_best(pos2, desc2, valid2, max_dist2,
                     s12, R12, t12, kp_xy1, kp_octave1, desc1, valid1)
    i1 = jnp.arange(N1, dtype=jnp.int32)
    mutual = (m12 >= 0) & (jnp.take(m21, jnp.clip(m12, 0, N2 - 1)) == i1)
    return jnp.where(mutual, m12, -1)
