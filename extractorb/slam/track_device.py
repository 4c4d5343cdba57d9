"""Fused device-resident tracking step.

The reference's per-frame hot path (Tracking.cc:1390-1907: extract ->
TrackWithMotionModel's SearchByProjection + PoseOptimization ->
TrackLocalMap's SearchLocalPoints + PoseOptimization) is a chain of
dense stages whose only host decisions are success thresholds.  Running
those stages as separate jit calls costs a device round trip each.
What one round trip costs on a local GPU is not measured yet.

Design: the WHOLE chain is one XLA program.  Per ordinary frame the
host does exactly

    1 upload  (the camera image; pose prediction rides along, ~50 B)
    1 dispatch
    1 fetch   (pose + per-keypoint map-point ids + counters, ~10 KB)

and every other input lives on device already: the previous frame's
features/associations are the previous step's outputs, and the map is a
device mirror (positions + validity) refreshed only when the map version
changes (keyframe events).  Host python keeps only the state machine and
bookkeeping, exactly the split the reference runs on its Tracking
thread.

Programs are cached at module level keyed by the static configuration,
so constructing a second System (or re-running a sequence) never
retraces or recompiles.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import ORBConfig
from ..core.camera import KannalaBrandt8, Pinhole, undistort_points_pinhole
from ..frontend import matcher as fm
from ..frontend.extractor import Features, ORBExtractor
from ..solver import pose_opt as spo

# --------------------------------------------------------------- closures
#
# jit caches key on the identity of static callables: a projection
# closure rebuilt per Tracker would retrace (seconds per program) every
# downstream jit for every new System instance.  These module-level
# caches make closures canonical per camera parameter set.


@functools.lru_cache(maxsize=None)
def pinhole_project(fx: float, fy: float, cx: float, cy: float):
    """Canonical pinhole projection closure (camera frame (3,) -> (2,))."""

    def project(pc):
        return jnp.stack(
            [fx * pc[0] / pc[2] + cx, fy * pc[1] / pc[2] + cy], -1
        ).reshape(2)

    return project


@functools.lru_cache(maxsize=None)
def kb8_project(fx: float, fy: float, cx: float, cy: float,
                k1: float, k2: float, k3: float, k4: float):
    """Canonical KB8 fisheye projection closure."""
    cam = KannalaBrandt8(
        jnp.float32(fx), jnp.float32(fy), jnp.float32(cx), jnp.float32(cy),
        jnp.asarray([k1, k2, k3, k4], jnp.float32),
    )

    def project(pc):
        return cam.project(pc).reshape(2)

    return project


def project_for_camera(cam_cfg):
    """The canonical projection closure for a CameraConfig."""
    if cam_cfg.model == "KannalaBrandt8":
        return kb8_project(cam_cfg.fx, cam_cfg.fy, cam_cfg.cx, cam_cfg.cy,
                           cam_cfg.k1, cam_cfg.k2, cam_cfg.k3, cam_cfg.k4)
    return pinhole_project(cam_cfg.fx, cam_cfg.fy, cam_cfg.cx, cam_cfg.cy)


# ------------------------------------------------------------ the program


class FusedOut(NamedTuple):
    feats: Features          # device, current frame (capacity N)
    xy_un: jnp.ndarray       # (N,2) device undistorted coords
    R: jnp.ndarray           # (3,3) final pose
    t: jnp.ndarray           # (3,)
    kp_mp: jnp.ndarray       # (N,) int32 final map-point id per keypoint
    n_match_motion: jnp.ndarray   # () int32 motion-model match count
    n_inl_motion: jnp.ndarray     # () int32 pose-opt-1 inliers
    n_inl_final: jnp.ndarray      # () int32 pose-opt-2 inliers
    lm_searched: jnp.ndarray      # (M,) bool local points actually searched
    used_ref: jnp.ndarray         # () bool: ref-KF fallback branch taken
    n_pre: jnp.ndarray            # () int32 inliers entering local search
    # stereo channels (reference mvuRight/mvDepth) — mono programs fill
    # ur/depth with -1 and the close counters with 0
    ur: jnp.ndarray = None        # (N,) refined right-image u or -1
    depth: jnp.ndarray = None     # (N,) metric depth or -1
    n_close_tracked: jnp.ndarray = None    # () int32 close & associated
    n_close_untracked: jnp.ndarray = None  # () int32 close & free
    # inertial channels (body state + next ConstraintPoseImu); zeros for
    # visual-only programs
    v: jnp.ndarray = None         # (3,) body velocity in world
    bg: jnp.ndarray = None        # (3,) gyro bias
    ba: jnp.ndarray = None        # (3,) acc bias
    H15: jnp.ndarray = None       # (15,15) marginal info for the chain


class TrackStep:
    """One compiled tracking step for a fixed static configuration.

    With ``stereo_bf > 0`` the program also extracts the right image,
    runs the rectified stereo match in-program (frontend/stereo.py,
    reference Frame::ComputeStereoMatches) and adds stereo residuals to
    both pose optimisations (reference EdgeStereoOnlyPose); the close-
    point keyframe-pressure counters (reference NeedNewKeyFrame's
    bNeedToInsertClose) come back as scalars so the host never needs a
    per-frame depth copy."""

    def __init__(self, cam_cfg, orb_cfg: ORBConfig, img_shape: Tuple[int, int],
                 map_cap: int, local_cap: int,
                 stereo_bf: float = 0.0, baseline: float = 0.0,
                 th_depth: float = 0.0, depth_mode: str = "stereo",
                 inertial: bool = False):
        self.cam_cfg = cam_cfg
        self.orb_cfg = orb_cfg
        self.img_shape = img_shape
        self.map_cap = map_cap
        self.local_cap = local_cap
        # depth source: "none" (mono), "stereo" (right image in-program
        # match), "rgbd" (depth map sampled at the raw keypoint coords,
        # reference ComputeStereoFromRGBD, Frame.cc:994)
        self.depth_mode = depth_mode if stereo_bf > 0.0 else "none"
        self.stereo = self.depth_mode != "none"
        # inertial: IMU-predicted motion + in-program joint pose-
        # inertial optimization with the marginalization-prior chain
        # (reference TrackWithMotionModel's PredictStateIMU +
        # PoseInertialOptimizationLastFrame, Tracking.cc:2450/:2574)
        self.inertial = inertial
        self.bf = float(stereo_bf)
        self.baseline = float(baseline)
        self.th_depth = float(th_depth)
        self.extractor = ORBExtractor(orb_cfg, octree="device")
        self.capacity = orb_cfg.n_features + orb_cfg.n_levels * 16
        self.project = project_for_camera(cam_cfg)
        self.is_fisheye = cam_cfg.model == "KannalaBrandt8"
        self.has_dist = abs(cam_cfg.k1) > 1e-12 and not self.is_fisheye
        self.cam = Pinhole.from_config(cam_cfg)
        self.dist = jnp.asarray(
            [cam_cfg.k1, cam_cfg.k2, cam_cfg.p1, cam_cfg.p2, cam_cfg.k3],
            jnp.float32,
        )
        scales = np.empty(orb_cfg.n_levels, np.float32)
        scales[0] = 1.0
        for i in range(1, orb_cfg.n_levels):
            scales[i] = np.float32(scales[i - 1] * np.float32(orb_cfg.scale_factor))
        self.scale_factors = tuple(float(s) for s in scales)
        self.inv_sigma2 = tuple(1.0 / float(s * s) for s in scales)
        self.img_wh = (float(cam_cfg.width), float(cam_cfg.height))
        self._fn = jax.jit(self._step)

    # the traced body ---------------------------------------------------

    def _step(
        self,
        img,                     # (H,W) uint8
        last_xy_un,              # (N,2) previous frame undistorted coords
        last_desc, last_oct, last_ang,   # previous frame features
        last_kp_mp,              # (N,) int32 previous associations
        map_pos, map_valid,      # (CAP,3) f32 / (CAP,) bool  device mirror
        lm_ids, lm_pos, lm_desc, lm_norm, lm_maxd, lm_val,  # (M,...) local block
        ref_desc, ref_valid, ref_kp_mp,  # reference-KF block (fallback)
        R_last, t_last,          # previous frame pose (device chainable)
        R_prev, t_prev,          # frame before that (for the velocity)
        img_r=None,              # (H,W) uint8 right image (stereo only)
        imu=None,                # inertial inputs (see _step body) or None
    ) -> FusedOut:
        N = self.capacity
        CAP = self.map_cap
        inv_sig = jnp.asarray(self.inv_sigma2, jnp.float32)

        # motion-model prediction IN-PROGRAM (reference mVelocity,
        # Tracking.cc:2437): T_pred = (T_last T_prev^-1) T_last.  Taking
        # the two poses as inputs (instead of a host-computed prediction)
        # lets consecutive frames chain device-to-device with no host
        # round trip between dispatches.  Inertial runs predict through
        # the preintegrated IMU delta instead (PredictStateIMU,
        # Tracking.cc:1230).
        if self.inertial:
            from ..imu import preintegration as pre
            from ..solver.inertial import GRAVITY

            preint, v_last, bg_last, ba_last, prior_H, Rcb, tcb = imu
            gvec = jnp.asarray([0.0, 0.0, -GRAVITY], jnp.float32)
            Rwb1 = R_last.T @ Rcb
            twb1 = R_last.T @ (tcb - t_last)
            b = jnp.concatenate([bg_last, ba_last])
            dRb = pre.delta_rotation(preint, b)
            dVb = pre.delta_velocity(preint, b)
            dPb = pre.delta_position(preint, b)
            dt = preint.dT
            Rwb2 = Rwb1 @ dRb
            v_pred = v_last + gvec * dt + Rwb1 @ dVb
            twb2 = twb1 + v_last * dt + 0.5 * gvec * dt * dt + Rwb1 @ dPb
            R_pred = Rcb @ Rwb2.T
            t_pred = tcb - R_pred @ twb2
        else:
            Rv = R_last @ R_prev.T
            tv = t_last - Rv @ t_prev
            R_pred = Rv @ R_last
            t_pred = Rv @ t_last + tv

        feats = self.extractor._extract(img, self.capacity)
        if self.has_dist:
            xy_un = undistort_points_pinhole(feats.xy, self.cam, self.dist)
        else:
            xy_un = feats.xy

        # ---- ComputeStereoMatches IN-PROGRAM (reference Frame.cc:813):
        # right-image extraction + banded Hamming search + SAD refine,
        # producing mvuRight/mvDepth device arrays for the stereo
        # residuals below
        if self.depth_mode == "stereo":
            from ..frontend import stereo as fstereo
            from ..frontend.pyramid import compute_pyramid

            feats_r = self.extractor._extract(img_r, self.capacity)
            cfgo = self.orb_cfg
            pyr_l = tuple(compute_pyramid(img, cfgo.n_levels,
                                          cfgo.scale_factor))
            pyr_r = tuple(compute_pyramid(img_r, cfgo.n_levels,
                                          cfgo.scale_factor))
            sres = fstereo.compute_stereo_matches(
                feats.xy, feats.octave, feats.desc, feats.valid,
                feats_r.xy, feats_r.octave, feats_r.desc, feats_r.valid,
                pyr_l, pyr_r, self.scale_factors, self.bf, self.baseline,
            )
            ur = jnp.where(sres.valid, sres.u_right, -1.0)
            depth = jnp.where(sres.valid, sres.depth, -1.0)
        elif self.depth_mode == "rgbd":
            # img_r is the (H,W) float32 depth map: sample at the RAW
            # keypoint coords, virtual right coord uR = u_un - bf/d
            H_, W_ = self.img_shape
            vv = jnp.clip(jnp.round(feats.xy[:, 1]), 0, H_ - 1).astype(
                jnp.int32)
            uu = jnp.clip(jnp.round(feats.xy[:, 0]), 0, W_ - 1).astype(
                jnp.int32)
            d = img_r[vv, uu]
            ok = feats.valid & (d > 0)
            depth = jnp.where(ok, d, -1.0)
            ur = jnp.where(
                ok, xy_un[:, 0] - self.bf / jnp.maximum(d, 1e-9), -1.0
            )
        else:
            ur = jnp.full((N,), -1.0, jnp.float32)
            depth = jnp.full((N,), -1.0, jnp.float32)

        # ---- TrackWithMotionModel: search previous-frame points
        # (reference ORBmatcher.cc:2028 region; matches vs the LAST
        # frame's descriptors, like Tracking.cc:2469)
        has_mp = last_kp_mp >= 0
        safe_ids = jnp.clip(last_kp_mp, 0, CAP - 1)
        prev_pos = map_pos[safe_ids]
        prev_val = has_mp & map_valid[safe_ids]

        def msearch(th):
            return fm.search_by_projection_last_frame(
                prev_pos, last_desc, prev_val, last_oct, last_ang,
                R_pred, t_pred,
                xy_un, feats.desc, feats.octave, feats.angle, feats.valid,
                self.project, self.scale_factors, self.img_wh, th,
            )

        m15 = msearch(15.0)
        n15 = jnp.sum((m15 >= 0).astype(jnp.int32))
        # reference widens the window when <20 matches (Tracking.cc:2475)
        m = jax.lax.cond(n15 >= 20, lambda: m15, lambda: msearch(30.0))
        n_match = jnp.sum((m >= 0).astype(jnp.int32))

        kp_mp0 = (
            jnp.full((N,), -1, jnp.int32)
            .at[jnp.where(m >= 0, m, N)]
            .set(jnp.where(m >= 0, last_kp_mp, -1), mode="drop")
        )

        # ---- PoseOptimization #1 (reference Tracking.cc:2492)
        isig = inv_sig[jnp.clip(feats.octave, 0, len(self.inv_sigma2) - 1)]
        pts0 = map_pos[jnp.clip(kp_mp0, 0, CAP - 1)]
        val0 = (kp_mp0 >= 0) & map_valid[jnp.clip(kp_mp0, 0, CAP - 1)]
        res1 = spo.optimize_pose(
            R_pred, t_pred, pts0, xy_un, isig, val0, self.project,
            bf=self.bf, obs_ur=ur if self.stereo else None,
        )
        kp_mp1m = jnp.where(val0 & ~res1.inliers, -1, kp_mp0)

        # ---- TrackReferenceKeyFrame fallback IN-PROGRAM (reference
        # Tracking.cc:1549, :2308): when the motion-model track is weak,
        # mutual-best descriptor match against the reference keyframe's
        # map-point-bearing keypoints + pose optimisation from the LAST
        # pose.  Keeping this branch on device means a hard stretch
        # costs one program, not a host replay through the legacy
        # matchers.
        ok_motion = (n_match >= 20) & (res1.n_inliers >= 10)

        def ref_branch():
            m12, _ = fm.mutual_best_match(
                feats.desc, feats.valid, ref_desc, ref_valid,
            )
            good = (m12 >= 0)
            kp_r = jnp.where(
                good, ref_kp_mp[jnp.clip(m12, 0, ref_kp_mp.shape[0] - 1)],
                -1,
            ).astype(jnp.int32)
            val_r = (kp_r >= 0) & map_valid[jnp.clip(kp_r, 0, CAP - 1)]
            kp_r = jnp.where(val_r, kp_r, -1)
            pts_r = map_pos[jnp.clip(kp_r, 0, CAP - 1)]
            res_r = spo.optimize_pose(
                R_last, t_last, pts_r, xy_un, isig, kp_r >= 0, self.project,
                bf=self.bf, obs_ur=ur if self.stereo else None,
            )
            kp_out = jnp.where((kp_r >= 0) & ~res_r.inliers, -1, kp_r)
            return res_r.R, res_r.t, kp_out, res_r.n_inliers

        def motion_branch():
            return res1.R, res1.t, kp_mp1m, res1.n_inliers

        R1_, t1_, kp_mp1, n_pre = jax.lax.cond(
            ok_motion, motion_branch, ref_branch
        )

        # ---- TrackLocalMap: search the local-map block
        # (reference SearchLocalPoints, Tracking.cc:2916)
        taken = (
            jnp.zeros((CAP + 1,), bool)
            .at[jnp.where(kp_mp1 >= 0, kp_mp1, CAP)]
            .set(True)[:CAP]
        )
        lm_already = taken[jnp.clip(lm_ids, 0, CAP - 1)]
        lm_searched = lm_val & ~lm_already
        kp_free = feats.valid & (kp_mp1 < 0)
        m2 = fm.search_by_projection_local_map(
            lm_pos, lm_desc, lm_searched, lm_norm, lm_maxd,
            R1_, t1_,
            xy_un, feats.desc, feats.octave, kp_free, None,
            self.project, self.scale_factors, self.img_wh,
        )
        kp_mp2 = kp_mp1.at[jnp.where(m2 >= 0, m2, N)].set(
            jnp.where(m2 >= 0, lm_ids, -1), mode="drop"
        )

        # ---- PoseOptimization #2 (reference Tracking.cc:2554); with
        # IMU, the joint pose-inertial optimization against the chained
        # previous state + its marginalization prior (reference
        # PoseInertialOptimizationLastFrame, :2574), producing this
        # frame's body state and the next prior in-program
        pts2 = map_pos[jnp.clip(kp_mp2, 0, CAP - 1)]
        val2 = (kp_mp2 >= 0) & map_valid[jnp.clip(kp_mp2, 0, CAP - 1)]
        if self.inertial:
            from ..solver import inertial as sin

            Rwb0 = R1_.T @ Rcb
            twb0 = R1_.T @ (tcb - t1_)
            vres = sin.optimize_pose_inertial_last_frame(
                Rwb0, twb0, v_pred, bg_last, ba_last,
                (Rwb1, twb1, v_last, bg_last, ba_last),
                preint,
                pts2, xy_un, isig, val2,
                Rcb, tcb, self.project,
                prior=(prior_H, (Rwb1, twb1, v_last, bg_last, ba_last)),
            )
            R2o = Rcb @ vres.Rwb.T
            t2o = tcb - R2o @ vres.twb
            res2_inl = vres.inliers
            res2_n = vres.n_inliers
            v_out, bg_out, ba_out, H_out = (
                vres.v, vres.bg, vres.ba, vres.H)
        else:
            res2 = spo.optimize_pose(
                R1_, t1_, pts2, xy_un, isig, val2, self.project,
                bf=self.bf, obs_ur=ur if self.stereo else None,
            )
            R2o, t2o = res2.R, res2.t
            res2_inl = res2.inliers
            res2_n = res2.n_inliers
            v_out = jnp.zeros(3, jnp.float32)
            bg_out = jnp.zeros(3, jnp.float32)
            ba_out = jnp.zeros(3, jnp.float32)
            H_out = jnp.zeros((15, 15), jnp.float32)
        kp_mp3 = jnp.where(val2 & ~res2_inl, -1, kp_mp2)

        close = feats.valid & (depth > 0)
        if self.th_depth > 0:
            close = close & (depth < self.th_depth)
        return FusedOut(
            feats=feats, xy_un=xy_un, R=R2o, t=t2o, kp_mp=kp_mp3,
            n_match_motion=n_match, n_inl_motion=res1.n_inliers,
            n_inl_final=jnp.sum(val2 & res2_inl), lm_searched=lm_searched,
            used_ref=~ok_motion, n_pre=n_pre,
            ur=ur, depth=depth,
            n_close_tracked=jnp.sum((close & (kp_mp3 >= 0)).astype(jnp.int32)),
            n_close_untracked=jnp.sum((close & (kp_mp3 < 0)).astype(jnp.int32)),
            v=v_out, bg=bg_out, ba=ba_out, H15=H_out,
        )

    def __call__(self, *args, img_r=None, imu=None) -> FusedOut:
        kw = {}
        if img_r is not None:
            kw["img_r"] = img_r
        if imu is not None:
            kw["imu"] = imu
        return self._fn(*args, **kw)


# module-level program cache: a second Tracker/System with the same
# configuration reuses traces AND compiled executables
_STEP_CACHE = {}


def get_track_step(cam_cfg, orb_cfg: ORBConfig, img_shape, map_cap: int,
                   local_cap: int, stereo_bf: float = 0.0,
                   baseline: float = 0.0, th_depth: float = 0.0,
                   depth_mode: str = "stereo",
                   inertial: bool = False) -> TrackStep:
    key = (cam_cfg, orb_cfg, tuple(img_shape), map_cap, local_cap,
           float(stereo_bf), float(baseline), float(th_depth), depth_mode,
           inertial)
    step = _STEP_CACHE.get(key)
    if step is None:
        step = TrackStep(cam_cfg, orb_cfg, tuple(img_shape), map_cap,
                         local_cap, stereo_bf=stereo_bf, baseline=baseline,
                         th_depth=th_depth, depth_mode=depth_mode,
                         inertial=inertial)
        _STEP_CACHE[key] = step
    return step


# --------------------------------------------------------- device mirror


@functools.lru_cache(maxsize=None)
def _mirror_update_prog(n_rows: int):
    """Jitted row-scatter into the mirror arrays; padded row indices out
    of range are dropped."""

    def upd(pos, valid, rows, new_pos, new_valid):
        return (
            pos.at[rows].set(new_pos, mode="drop"),
            valid.at[rows].set(new_valid, mode="drop"),
        )

    # no donation: in-flight pipelined programs may still hold the
    # previous mirror buffers as inputs; a device-side copy is cheap
    return jax.jit(upd)


class MapMirror:
    """Device mirror of a map's point block (positions + validity).

    Updated only when the map version changes (keyframe events), so
    ordinary frames touch the device with zero map traffic; updates are
    INCREMENTAL — only the rows that actually changed since the last
    sync are uploaded (a full re-upload of a 32k-point arena is ~400 KB
    on every keyframe event otherwise).
    Capacity is padded to a static ladder so XLA programs never
    re-specialise when the host arena grows.
    """

    LADDER = (32768, 65536, 131072, 262144)
    ROW_BUCKETS = (256, 1024, 4096, 16384)

    def __init__(self):
        self._key = None
        self.cap = 0
        self.pos = None
        self.valid = None
        self._h_pos = None     # host shadow of the device state
        self._h_valid = None

    @staticmethod
    def _pad_cap(n: int) -> int:
        for c in MapMirror.LADDER:
            if n <= c:
                return c
        return int(np.ceil(n / MapMirror.LADDER[-1])) * MapMirror.LADDER[-1]

    def _full_upload(self, mp, cap: int):
        pos = np.zeros((cap, 3), np.float32)
        valid = np.zeros((cap,), bool)
        n = mp._next_mp
        pos[: len(mp.mp_pos)] = mp.mp_pos
        valid[:n] = mp.mp_valid[:n]
        self.pos = jnp.asarray(pos)
        self.valid = jnp.asarray(valid)
        self._h_pos = pos
        self._h_valid = valid
        self.cap = cap

    def sync(self, mp) -> None:
        key = (mp.mid, mp.version)
        if key == self._key:
            return
        cap = self._pad_cap(len(mp.mp_valid))
        same_map = (
            self._key is not None and self._key[0] == mp.mid
            and cap == self.cap and self._h_pos is not None
        )
        if not same_map:
            self._full_upload(mp, cap)
            self._key = key
            return
        n = mp._next_mp
        changed = (mp.mp_valid[:n] != self._h_valid[:n]) | np.any(
            mp.mp_pos[:n] != self._h_pos[:n], axis=1
        )
        rows = np.where(changed)[0]
        if len(rows) > n // 3 and len(rows) > 4096:
            self._full_upload(mp, cap)
            self._key = key
            return
        if len(rows):
            b = next((b for b in self.ROW_BUCKETS if len(rows) <= b),
                     None)
            if b is None:
                self._full_upload(mp, cap)
                self._key = key
                return
            rows_p = np.full(b, cap, np.int32)   # out-of-range -> drop
            rows_p[: len(rows)] = rows
            new_pos = np.zeros((b, 3), np.float32)
            new_val = np.zeros((b,), bool)
            new_pos[: len(rows)] = mp.mp_pos[rows]
            new_val[: len(rows)] = mp.mp_valid[rows]
            self.pos, self.valid = _mirror_update_prog(b)(
                self.pos, self.valid, jnp.asarray(rows_p),
                jnp.asarray(new_pos), jnp.asarray(new_val),
            )
            self._h_pos[rows] = mp.mp_pos[rows]
            self._h_valid[rows] = mp.mp_valid[rows]
        self._key = key


class LocalBlock(NamedTuple):
    ids: np.ndarray          # (M,) int32 map-point ids (host)
    ids_dev: jnp.ndarray
    pos: jnp.ndarray
    desc: jnp.ndarray
    norm: jnp.ndarray
    maxd: jnp.ndarray
    val: jnp.ndarray         # (M,) bool: in-block validity (host-known part)
    val_host: np.ndarray


def build_local_block(mp, local_kfs, M: int) -> Optional[LocalBlock]:
    """Gather the local-map point block (reference UpdateLocalPoints,
    Tracking.cc:3000) into fixed-capacity device arrays."""
    pt_ids = mp.points_seen_by(local_kfs)
    if len(pt_ids) == 0:
        return None
    pt_ids = pt_ids[:M]
    k = len(pt_ids)
    pos = np.zeros((M, 3), np.float32)
    desc = np.zeros((M, 32), np.uint8)
    norm = np.zeros((M, 3), np.float32)
    maxd = np.ones((M,), np.float32)
    val = np.zeros((M,), bool)
    ids = np.zeros((M,), np.int32)
    pos[:k] = mp.mp_pos[pt_ids]
    desc[:k] = mp.mp_desc[pt_ids]
    norm[:k] = mp.mp_normal[pt_ids]
    maxd[:k] = mp.mp_max_dist[pt_ids]
    val[:k] = mp.mp_valid[pt_ids]
    ids[:k] = pt_ids
    return LocalBlock(
        ids=ids, ids_dev=jnp.asarray(ids), pos=jnp.asarray(pos),
        desc=jnp.asarray(desc), norm=jnp.asarray(norm),
        maxd=jnp.asarray(maxd), val=jnp.asarray(val), val_host=val,
    )
