"""Stereo matching: per-keypoint disparity/depth from a rectified pair.

Replaces Frame::ComputeStereoMatches (reference: src/Frame.cc:813-991):
row-banded Hamming search (band 2*scale[octaveR], levels +-1, disparity
in [0, bf/b]), then SAD sub-pixel refinement with an 11x11
centre-subtracted window slid +-5 px at the left keypoint's pyramid
level, parabola interpolation, and a median-distance outlier cut
(1.5*1.4*median).

Design: the candidate search is a masked dense Hamming matrix (one
bit-plane matmul); the SAD refinement gathers one 11x11 left window and one
11x21 right strip per keypoint with vmapped dynamic_slice and evaluates
all 11 shifts as one tensor op.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from .matcher import TH_HIGH, TH_LOW, hamming_matrix

TH_ORB = (TH_HIGH + TH_LOW) // 2  # 75


class StereoMatches(NamedTuple):
    u_right: jnp.ndarray   # (NL,) refined right-image u or -1
    depth: jnp.ndarray     # (NL,) metric depth or -1
    valid: jnp.ndarray     # (NL,) bool


@functools.partial(jax.jit, static_argnums=(10, 11, 12))
def compute_stereo_matches(
    xy_l, octave_l, desc_l, valid_l,
    xy_r, octave_r, desc_r, valid_r,
    pyr_l_bordered, pyr_r_bordered,
    scale_factors: Tuple[float, ...],
    bf: float,
    baseline: float,
) -> StereoMatches:
    """bf = fx * baseline (Camera.bf); baseline = b (metres).
    pyr_*_bordered: tuples of bordered pyramid level images (uint8)."""
    NL = xy_l.shape[0]
    scales = jnp.asarray(scale_factors, jnp.float32)
    inv_scales = 1.0 / scales
    maxD = jnp.float32(bf / baseline)  # reference: mbf / minZ, minZ = mb
    minD = jnp.float32(0.0)

    # --- banded Hamming search (reference :829-895)
    dist = hamming_matrix(desc_l, desc_r)  # (NL, NR)
    rowband = 2.0 * scales[jnp.clip(octave_r, 0, len(scale_factors) - 1)]
    dy = jnp.abs(xy_l[:, 1:2] - xy_r[None, :, 1])
    band_ok = dy <= rowband[None, :] + 1.0  # reference ceil/floor slack
    lvl_ok = (octave_r[None, :] >= (octave_l - 1)[:, None]) & (
        octave_r[None, :] <= (octave_l + 1)[:, None]
    )
    du = xy_l[:, 0:1] - xy_r[None, :, 0]  # candidate disparities
    disp_ok = (du >= minD) & (du <= maxD)
    mask = band_ok & lvl_ok & disp_ok & valid_l[:, None] & valid_r[None, :]

    INF = jnp.int32(1 << 20)
    d = jnp.where(mask, dist, INF)
    best = jnp.min(d, axis=1)
    best_idx = jnp.argmin(d, axis=1)
    cand_ok = best < TH_ORB

    # --- SAD sub-pixel refinement (reference :896-960)
    #
    # Formulation: a per-keypoint lax.switch over the 8 pyramid levels
    # would make every vmapped keypoint gather patches from EVERY level
    # (vmap turns cond/switch into select-all-branches).  Instead the bordered pyramid levels
    # are flattened into ONE buffer with per-level (offset, stride)
    # tables, each keypoint's patch indices are computed arithmetically
    # from its own level, and the whole batch issues a single gather.
    w, L = 5, 5
    border = 19

    flat_l = jnp.concatenate([p.reshape(-1) for p in pyr_l_bordered])
    flat_r = jnp.concatenate([p.reshape(-1) for p in pyr_r_bordered])
    offs_np, strides_np, hs_np, ws_np = [], [], [], []
    acc = 0
    for p in pyr_l_bordered:
        offs_np.append(acc)
        strides_np.append(p.shape[1])
        hs_np.append(p.shape[0])
        ws_np.append(p.shape[1])
        acc += p.shape[0] * p.shape[1]
    offs = jnp.asarray(offs_np, jnp.int32)
    strides = jnp.asarray(strides_np, jnp.int32)
    hs = jnp.asarray(hs_np, jnp.int32)
    ws = jnp.asarray(ws_np, jnp.int32)

    lvl = jnp.clip(octave_l, 0, len(scale_factors) - 1)
    inv = inv_scales[lvl]
    uL = jnp.round(xy_l[:, 0] * inv).astype(jnp.int32)
    vL = jnp.round(xy_l[:, 1] * inv).astype(jnp.int32)
    uR0 = jnp.round(xy_r[best_idx, 0] * inv).astype(jnp.int32)

    # dynamic_slice clamps start indices into range; replicate with clip
    v0 = jnp.clip(vL - w + border, 0, hs[lvl] - 11)
    u0_l = jnp.clip(uL - w + border, 0, ws[lvl] - 11)
    u0_r = jnp.clip(uR0 - L - w + border, 0, ws[lvl] - (11 + 2 * L))

    dy = jnp.arange(11, dtype=jnp.int32)
    dxl = jnp.arange(11, dtype=jnp.int32)
    dxr = jnp.arange(11 + 2 * L, dtype=jnp.int32)
    base = offs[lvl][:, None, None]
    stride = strides[lvl][:, None, None]
    idx_l = base + (v0[:, None, None] + dy[None, :, None]) * stride \
        + (u0_l[:, None, None] + dxl[None, None, :])
    idx_r = base + (v0[:, None, None] + dy[None, :, None]) * stride \
        + (u0_r[:, None, None] + dxr[None, None, :])
    il = flat_l[idx_l].astype(jnp.int32)          # (NL,11,11)
    ir = flat_r[idx_r].astype(jnp.int32)          # (NL,11,21)
    il = il - il[:, w:w + 1, w:w + 1]
    sads = []
    for inc in range(2 * L + 1):
        win = ir[:, :, inc:inc + 11]
        win = win - win[:, w:w + 1, w:w + 1]
        sads.append(jnp.sum(jnp.abs(il - win), axis=(1, 2)))
    sads = jnp.stack(sads, -1).astype(jnp.float32)     # (NL,11)
    best_inc = jnp.argmin(sads, axis=-1)
    interior = (best_inc > 0) & (best_inc < 2 * L)
    bi = jnp.clip(best_inc, 1, 2 * L - 1)
    take = lambda a, i: jnp.take_along_axis(a, i[:, None], 1)[:, 0]
    d1 = take(sads, bi - 1)
    d2 = take(sads, bi)
    d3 = take(sads, bi + 1)
    denom = 2.0 * (d1 + d3 - 2.0 * d2)
    delta = jnp.where(jnp.abs(denom) > 1e-9, (d1 - d3) / denom, 2.0)
    delta_ok = (delta >= -1.0) & (delta <= 1.0)
    u_r = scales[lvl] * (
        uR0.astype(jnp.float32) + (bi - L).astype(jnp.float32) + delta
    )
    sad = d2
    ref_ok = interior & delta_ok
    disparity = xy_l[:, 0] - u_r
    disp_in = (disparity >= minD) & (disparity < maxD)
    # clamp tiny disparities like the reference
    u_r = jnp.where(disparity <= 0, xy_l[:, 0] - 0.01, u_r)
    disparity = jnp.where(disparity <= 0, 0.01, disparity)
    ok = cand_ok & ref_ok & disp_in & valid_l

    # median SAD outlier cut
    sad_masked = jnp.where(ok, sad, jnp.inf)
    n_ok = jnp.sum(ok.astype(jnp.int32))
    srt = jnp.sort(sad_masked)
    median = srt[jnp.clip(n_ok // 2, 0, NL - 1)]
    ok = ok & (sad < 1.5 * 1.4 * median)

    depth = jnp.float32(bf) / disparity
    return StereoMatches(
        u_right=jnp.where(ok, u_r, -1.0),
        depth=jnp.where(ok, depth, -1.0),
        valid=ok,
    )


class FisheyeStereoMatches(NamedTuple):
    right_idx: jnp.ndarray  # (NL,) matched right-kp index or -1
    depth: jnp.ndarray      # (NL,) depth in the left camera or -1
    p3d: jnp.ndarray        # (NL,3) triangulated point, left-camera coords
    valid: jnp.ndarray      # (NL,) bool


def lapping_mask(xy, lap_begin: float, lap_end: float, valid):
    """Stereo-overlap membership for fisheye keypoints.

    The reference reorders keypoints so the lapping-area ones sit at the
    end of the array (ORBextractor.cc:1078-1162 operator() with
    vLappingArea, Camera.lappingBegin/End); with padded fixed-shape
    arrays a boolean mask carries the same information.
    """
    x = xy[..., 0]
    return valid & (x >= lap_begin) & (x <= lap_end)


def compute_stereo_fisheye_matches(
    cam_l,
    cam_r,
    xy_l, octave_l, desc_l, lap_l,
    xy_r, octave_r, desc_r, lap_r,
    R_rl, t_rl,
    sigma2,
    ratio: float = 0.7,
) -> FisheyeStereoMatches:
    """Non-rectified (fisheye) stereo matching + triangulation.

    Replaces Frame::ComputeStereoFishEyeMatches (src/Frame.cc:1139):
    the reference brute-force knn-matches the lapping-area descriptors
    (BFMatcher, ratio 0.7) and triangulates each surviving pair with
    KannalaBrandt8::TriangulateMatches, keeping matches whose depth
    gates pass.  Here the knn search is one dense Hamming matrix over the
    masked descriptor sets and all candidate pairs triangulate as one
    batched SVD.

    sigma2: per-octave variance table (n_levels,) — reference uses
    mvLevelSigma2[octave].
    """
    sigma2 = jnp.asarray(sigma2, jnp.float32)
    dist = hamming_matrix(desc_l, desc_r)  # (NL, NR)
    INF = jnp.int32(1 << 20)
    mask = lap_l[:, None] & lap_r[None, :]
    d = jnp.where(mask, dist, INF)
    best = jnp.min(d, axis=1)
    best_idx = jnp.argmin(d, axis=1)
    # second-best for the ratio test
    d2 = jnp.where(
        jax.nn.one_hot(best_idx, d.shape[1], dtype=bool), INF, d
    )
    second = jnp.min(d2, axis=1)
    cand_ok = (best < TH_ORB) & (
        best.astype(jnp.float32) < ratio * second.astype(jnp.float32)
    )

    from ..core.camera import triangulate_matches

    uv_r_m = xy_r[best_idx]
    oct_r_m = octave_r[best_idx]
    s2_l = sigma2[jnp.clip(octave_l, 0, sigma2.shape[0] - 1)]
    s2_r = sigma2[jnp.clip(oct_r_m, 0, sigma2.shape[0] - 1)]
    p3d, depth, tri_ok = triangulate_matches(
        cam_l, cam_r, xy_l, uv_r_m, R_rl, t_rl, s2_l, s2_r
    )
    ok = cand_ok & tri_ok & lap_l
    return FisheyeStereoMatches(
        right_idx=jnp.where(ok, best_idx, -1),
        depth=jnp.where(ok, depth, -1.0),
        p3d=p3d,
        valid=ok,
    )
