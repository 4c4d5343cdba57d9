"""End-to-end ORB extraction.

Replaces ORBextractor::operator() (reference:
src/orb_extractor/ORBextractor.cc:1078-1162): pyramid -> per-level FAST
(cells + retry) -> octree distribution -> IC_Angle orientation -> blur ->
rotated BRIEF, with keypoints finally scaled to level-0 coordinates.

Design: each pyramid level is a separately jitted static-shape stage
(8 specialisations per camera resolution, compiled once).  The octree
distribution runs either fully on device (``octree='device'``, default:
keeps the pipeline async, approximate final-stage splits) or host-exact
(``octree='host'``, used for reference-parity tests and offline tools).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ORBConfig
from . import blur as fblur
from . import brief as fbrief
from . import fast as ffast
from . import octree as foctree
from . import orientation as forient
from .pyramid import EDGE_THRESHOLD, compute_pyramid


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Features:
    """Padded per-image feature set (the reference's vector<KeyPoint> +
    descriptor Mat, as fixed-shape arrays)."""

    xy: jnp.ndarray        # (N, 2) float32, level-0 coordinates
    response: jnp.ndarray  # (N,) float32
    angle: jnp.ndarray     # (N,) float32 degrees
    octave: jnp.ndarray    # (N,) int32
    size: jnp.ndarray      # (N,) float32 (scaled patch size)
    desc: jnp.ndarray      # (N, 32) uint8 packed 256-bit descriptors
    valid: jnp.ndarray     # (N,) bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]

    def count(self):
        return jnp.sum(self.valid.astype(jnp.int32))


def _scale_factors(cfg: ORBConfig) -> np.ndarray:
    """float32 cumulative scale factors, like the reference ctor
    (mvScaleFactor[i] = mvScaleFactor[i-1]*scaleFactor in float)."""
    s = np.empty(cfg.n_levels, np.float32)
    s[0] = 1.0
    for i in range(1, cfg.n_levels):
        s[i] = np.float32(s[i - 1] * np.float32(cfg.scale_factor))
    return s


# Global program cache: jitted extraction programs are keyed on the
# (frozen) config + image shape + capacity, NOT the ORBExtractor
# instance, so a fresh Tracker/System reuses the already-traced-and-
# compiled program instead of paying a multi-second retrace per
# instance (the extractor's behaviour is a pure function of its cfg).
_PROGRAM_CACHE: dict = {}


class ORBExtractor:
    """Stateless orchestration object (caches static tables per level)."""

    def __init__(self, cfg: ORBConfig, octree: str = "device"):
        assert octree in ("device", "host")
        self.cfg = cfg
        self.octree = octree
        self.scales = _scale_factors(cfg)
        self.budgets = cfg.features_per_level

    def __call__(self, img: jnp.ndarray, capacity: Optional[int] = None) -> Features:
        """Extract ORB features from a uint8 grayscale image (H, W).

        The device-octree path compiles the WHOLE per-level pipeline
        (pyramid -> FAST -> octree -> orientation -> blur -> BRIEF ->
        merge) into one XLA program per image shape instead of ~56 eager
        per-stage dispatches per frame.
        """
        cfg = self.cfg
        capacity = capacity or cfg.n_features + cfg.n_levels * 16
        if self.octree == "host":
            return self._extract(img, capacity)
        key = (cfg, self.octree, img.shape, capacity)
        fn = _PROGRAM_CACHE.get(key)
        if fn is None:
            fn = jax.jit(functools.partial(self._extract, capacity=capacity))
            _PROGRAM_CACHE[key] = fn
        return fn(img)

    def _extract(self, img: jnp.ndarray, capacity: int) -> Features:
        cfg = self.cfg
        pyr = compute_pyramid(img, cfg.n_levels, cfg.scale_factor)

        per_level = []
        for lvl in range(cfg.n_levels):
            bordered = pyr[lvl]
            keep, score = ffast.detect_keypoints(
                bordered, cfg.ini_th_fast, cfg.min_th_fast
            )
            budget = self.budgets[lvl]
            # host octree returns <= budget+3 (final stage overshoot); the
            # device octree can overshoot more and is trimmed by response.
            cap_l = min(cfg.max_kps_per_level, budget + 16)
            if self.octree == "host":
                xy, resp, valid = _host_octree_select(
                    np.asarray(keep), np.asarray(score), bordered.shape, budget, cap_l
                )
                xy, resp, valid = jnp.asarray(xy), jnp.asarray(resp), jnp.asarray(valid)
            else:
                h, w = bordered.shape
                H, W = h - 2 * EDGE_THRESHOLD, w - 2 * EDGE_THRESHOLD
                # candidate capacity scales with level area (sorts dominate
                # the downstream octree cost; a flat capacity wastes 3-8x
                # work on the small upper levels)
                k_lvl = min(
                    cfg.max_kps_per_level,
                    max(512, -(-(H * W) // 75 // 512) * 512),
                )
                xy_all, resp_all, valid_all = ffast.collect_keypoints(
                    keep, score, k_lvl
                )
                min_b = ffast.MIN_BORDER
                sel, _ = foctree.distribute_device(
                    xy_all, resp_all, valid_all, budget,
                    W - 2 * min_b, H - 2 * min_b, min_b, min_b,
                )
                # cap cannot exceed the candidate buffer (small levels of
                # small images with large budgets: k_lvl < budget+16)
                xy, resp, valid = _compact(
                    xy_all, resp_all, valid_all & sel, min(cap_l, k_lvl)
                )

            angles = forient.ic_angle(bordered, xy, valid)
            blurred = fblur.blur_level(bordered)
            bits = fbrief.compute_descriptors(blurred, xy, angles, valid)
            desc = fbrief.pack_bits_u8(bits)
            per_level.append((lvl, xy, resp, valid, angles, desc))

        return self._merge(per_level, capacity)

    def _merge(self, per_level, capacity: int) -> Features:
        cfg = self.cfg
        xs, ys, resp, ang, octv, size, desc, valid = [], [], [], [], [], [], [], []
        for lvl, xy, r, v, a, d in per_level:
            scale = jnp.float32(self.scales[lvl])
            xs.append(xy[:, 0].astype(jnp.float32) * scale)
            ys.append(xy[:, 1].astype(jnp.float32) * scale)
            resp.append(r.astype(jnp.float32))
            ang.append(a)
            octv.append(jnp.full((xy.shape[0],), lvl, jnp.int32))
            patch = jnp.float32(31.0 * self.scales[lvl])
            size.append(jnp.full((xy.shape[0],), patch, jnp.float32))
            desc.append(d)
            valid.append(v)

        xy = jnp.stack([jnp.concatenate(xs), jnp.concatenate(ys)], -1)
        feats = Features(
            xy=xy,
            response=jnp.concatenate(resp),
            angle=jnp.concatenate(ang),
            octave=jnp.concatenate(octv),
            size=jnp.concatenate(size),
            desc=jnp.concatenate(desc),
            valid=jnp.concatenate(valid),
        )
        return _truncate(feats, capacity)


@jax.jit
def _truncate_key(feats: Features):
    # keep valid entries, stable by (level, position in level array)
    n = feats.valid.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    return jnp.where(feats.valid, idx, n + idx)


def _truncate(feats: Features, capacity: int) -> Features:
    """Front-pack valid features into a fixed-capacity Features pytree,
    preserving level order (like the reference's per-level concatenation)."""
    key = _truncate_key(feats)
    order = jnp.argsort(key)[:capacity]
    valid = jnp.sort(key)[:capacity] < feats.valid.shape[0]
    take = lambda a: a[order]
    return Features(
        xy=jnp.where(valid[:, None], take(feats.xy), 0.0),
        response=jnp.where(valid, take(feats.response), 0.0),
        angle=jnp.where(valid, take(feats.angle), 0.0),
        octave=jnp.where(valid, take(feats.octave), -1),
        size=jnp.where(valid, take(feats.size), 0.0),
        desc=jnp.where(valid[:, None], take(feats.desc), 0),
        valid=valid,
    )


def _compact(xy, resp, mask, capacity: int):
    """Select the best `capacity` masked keypoints (response-major,
    earlier-index tiebreak) into a fixed-size buffer."""
    n = mask.shape[0]
    idx = jnp.arange(n, dtype=jnp.int32)
    key = jnp.where(mask, resp * n - idx, -1)
    top, order = jax.lax.top_k(key, capacity)
    valid = top >= 0
    xy_o = jnp.where(valid[:, None], xy[order], 0)
    resp_o = jnp.where(valid, resp[order], 0)
    return xy_o, resp_o, valid


def _host_octree_select(keep, score, bordered_shape, budget, capacity):
    """Host-exact path: reference keypoint ordering + DistributeOctTree."""
    h, w = bordered_shape
    H, W = h - 2 * EDGE_THRESHOLD, w - 2 * EDGE_THRESHOLD
    min_b = ffast.MIN_BORDER
    max_x, max_y = W - min_b, H - min_b
    ys_all, xs_all = np.nonzero(keep)
    resp_all = score[ys_all, xs_all].astype(np.float32)
    # reference insertion order: cells row-major, row-major within cell
    width, height = max_x - min_b, max_y - min_b
    n_cols, n_rows, w_cell, h_cell = ffast.cell_layout(width, height)
    ci = (ys_all - (min_b + 3)) // h_cell
    cj = (xs_all - (min_b + 3)) // w_cell
    order = np.lexsort((xs_all, ys_all, cj, ci))
    xs_all, ys_all, resp_all = xs_all[order], ys_all[order], resp_all[order]
    sel = foctree.distribute_host(
        xs_all, ys_all, resp_all, min_b, max_x, min_b, max_y, budget
    )
    k = len(sel)
    xy = np.zeros((capacity, 2), np.int32)
    resp = np.zeros((capacity,), np.int32)
    valid = np.zeros((capacity,), bool)
    k = min(k, capacity)
    xy[:k, 0] = xs_all[sel[:k]]
    xy[:k, 1] = ys_all[sel[:k]]
    resp[:k] = resp_all[sel[:k]]
    valid[:k] = True
    return xy, resp, valid
