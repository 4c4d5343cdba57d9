"""Monocular tracking: the per-frame hot path.

Replaces Tracking (reference: src/Tracking.cc:1390-1907 Track(), :2018
MonocularInitialization, :2437 TrackWithMotionModel, :2308
TrackReferenceKeyFrame, :2532 TrackLocalMap, :2647 NeedNewKeyFrame).

Design: the host runs the state machine (the data-dependent part the
reference also runs on one thread) while every dense stage — extraction,
projection search, pose optimisation — is a jit call on device arrays.
Local mapping runs synchronously after keyframe insertion with a bounded
work budget per step instead of a competing thread (SURVEY.md §2.7).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import SLAMConfig
from ..core.camera import Pinhole, undistort_points_pinhole
from ..frontend import matcher as fm
from ..utils.packed_fetch import pack_fetch
from ..frontend.extractor import Features, ORBExtractor
from ..geometry import two_view as tv
from ..solver import ba as sba
from ..solver import pnp
from ..solver import pose_opt as spo
from .map import INVALID, Atlas, KeyFrame, SLAMMap
from . import imu_frontend, local_mapping, track_device as td


class TrackState(enum.Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    RECENTLY_LOST = 3
    LOST = 4


@dataclasses.dataclass
class Frame:
    frame_id: int
    timestamp: float
    feats: Features            # device
    xy_un: np.ndarray          # (N,2) undistorted (host)
    octave: np.ndarray
    angle: np.ndarray
    desc: np.ndarray
    valid: np.ndarray
    kp_mp: np.ndarray          # (N,) associated map point or -1
    R: Optional[np.ndarray] = None
    t: Optional[np.ndarray] = None
    # stereo/RGBD channels (reference mvuRight/mvDepth); None for mono
    ur: Optional[np.ndarray] = None
    depth: Optional[np.ndarray] = None
    # stereo-fisheye: triangulated point per keypoint in left-camera
    # coords (reference stores these via TriangulateMatches into
    # mvStereo3Dpoints, Frame.cc:1139 region); None for rectified rigs
    p3d_stereo: Optional[np.ndarray] = None
    # inertial state (reference Frame mVw/mImuBias/mpImuPreintegratedFrame)
    v: Optional[np.ndarray] = None
    bg: Optional[np.ndarray] = None
    ba: Optional[np.ndarray] = None
    preint_frame: Optional[object] = None   # from the previous frame
    preint_kf: Optional[object] = None      # from the last keyframe
    # Device-resident bookkeeping for the fused tracking step
    # (slam/track_device.py): undistorted coords and associations stay
    # on device between frames; host copies are fetched on demand.
    un_dev: Optional[object] = None         # (N,2) device undistorted xy
    kp_mp_dev: Optional[object] = None      # (N,) device association ids
    ur_dev: Optional[object] = None         # (N,) device mvuRight (stereo)
    depth_dev: Optional[object] = None      # (N,) device mvDepth (stereo)
    kp_mp_dirty: bool = False               # host kp_mp modified since fetch
    host_ready: bool = True

    def host_handles(self):
        """Device handles of the feature arrays, for batching this
        frame's host-copy fetch with other transfers.  Stereo frames
        append their ur/depth channels."""
        un = self.un_dev if self.un_dev is not None else self.feats.xy
        base = (un, self.feats.octave, self.feats.angle, self.feats.desc,
                self.feats.valid)
        if self.ur_dev is not None:
            return base + (self.ur_dev, self.depth_dev)
        return base

    def set_host(self, vals):
        """Install already-fetched host copies (host_handles order)."""
        xy_un, octave, angle, desc, valid = vals[:5]
        self.xy_un = np.asarray(xy_un, np.float32)
        self.octave = np.asarray(octave)
        self.angle = np.asarray(angle)
        self.desc = np.asarray(desc)
        self.valid = np.asarray(valid)
        if len(vals) > 5:
            self.ur = np.asarray(vals[5], np.float32)
            self.depth = np.asarray(vals[6], np.float32)
        self.host_ready = True

    def ensure_host(self):
        """Materialise the host copies of the feature arrays (one
        batched device fetch); no-op for eagerly-built frames."""
        if self.host_ready:
            return
        fetch_kp = self.kp_mp is None and self.kp_mp_dev is not None
        handles = self.host_handles()
        n_base = len(handles)
        if fetch_kp:
            handles = handles + (self.kp_mp_dev,)
        vals = pack_fetch(handles)
        self.set_host(vals[:n_base])
        if fetch_kp:
            self.kp_mp = np.asarray(vals[n_base]).copy()


@dataclasses.dataclass
class _PipeEntry:
    """One in-flight pipelined frame: the dispatched program's outputs
    plus what the confirmation step needs to commit it."""
    frame: Frame
    out: object                # track_device.FusedOut (device arrays)
    ts: float
    prev_frame: Frame          # chain predecessor (for the velocity)
    blk_ids: np.ndarray        # local-block ids used at dispatch


class Tracker:
    def __init__(self, cfg: SLAMConfig, vocab=None):
        self.cfg = cfg
        cam_cfg = cfg.camera
        self.cam = Pinhole.from_config(cam_cfg)
        self.dist = jnp.asarray(
            [cam_cfg.k1, cam_cfg.k2, cam_cfg.p1, cam_cfg.p2, cam_cfg.k3],
            jnp.float32,
        )
        self.is_fisheye = cam_cfg.model == "KannalaBrandt8"
        self.has_dist = abs(cam_cfg.k1) > 1e-12 and not self.is_fisheye
        fx, fy, cx, cy = cam_cfg.fx, cam_cfg.fy, cam_cfg.cx, cam_cfg.cy

        if self.is_fisheye:
            # KB8: keypoints stay raw (reference keeps mvKeysUn == mvKeys
            # for fisheye) and all residuals project through the full
            # theta-polynomial model.
            from ..core.camera import KannalaBrandt8

            self.kb8 = KannalaBrandt8.from_config(cam_cfg)
        else:
            self.kb8 = None
        # canonical cached closure: jit programs keyed on it are shared
        # across Tracker/System instances (no per-instance retracing)
        self.project = td.project_for_camera(cam_cfg)

        # Stereo-fisheye rig (Camera2.* + Tlr): right camera + extrinsics
        # (reference: Tracking::ParseCamParamFile KB8 two-camera branch).
        self.cam_r = None
        self.R_rl = self.t_rl = None
        if cfg.camera2 is not None and self.is_fisheye:
            from ..core.camera import KannalaBrandt8

            self.cam_r = KannalaBrandt8.from_config(cfg.camera2)
            T = (
                np.asarray(cfg.T_lr, np.float32).reshape(4, 4)
                if cfg.T_lr is not None
                else np.eye(4, dtype=np.float32)
            )
            R_lr, t_lr = T[:3, :3], T[:3, 3]
            self.R_rl = R_lr.T.copy()
            self.t_rl = (-R_lr.T @ t_lr).astype(np.float32)
        self.K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
        self.img_wh = (float(cam_cfg.width), float(cam_cfg.height))

        self.extractor = ORBExtractor(cfg.orb, octree=cfg.orb.octree)
        init_orb = dataclasses.replace(cfg.orb, n_features=5 * cfg.orb.n_features)
        self.init_extractor = ORBExtractor(init_orb, octree=cfg.orb.octree)
        self.scale_factors = tuple(float(s) for s in self.extractor.scales)
        sig = [s * s for s in self.scale_factors]
        self.sigma2 = tuple(sig)
        self.inv_sigma2 = tuple(1.0 / v for v in sig)

        # Stereo/RGBD geometry (reference: Camera.bf, ThDepth; mThDepth =
        # mbf * ThDepth / fx, src/Tracking.cc:169 region).
        self.bf = float(cam_cfg.bf)
        self.baseline = self.bf / fx if self.bf > 0 else 0.0
        self.th_depth = (
            self.bf * float(cam_cfg.th_depth) / fx if self.bf > 0 else 0.0
        )
        # thFarPoints gate on stereo/RGBD point creation (reference
        # System.cc:183 -> Tracking mThFarPoints/mbFarPoints)
        self.th_far_points = float(cam_cfg.th_far_points)
        self.sensor = cfg.sensor

        self.state = TrackState.NO_IMAGES_YET
        self.atlas = Atlas()
        self.local_mapper = local_mapping.LocalMapper(
            self.project, self.scale_factors, self.inv_sigma2, self.K
        )
        from .loop_closing import LoopCloser

        self.loop_closer = LoopCloser(
            vocab, self.project, scale_factors=self.scale_factors,
            img_wh=(cfg.camera.width, cfg.camera.height),
            inv_sigma2=self.inv_sigma2,
            fix_scale=cfg.sensor in ("stereo", "rgbd"),
        )
        if self.loop_closer.db is not None:
            from .loop_closing import encode_dbid

            self.local_mapper.on_kf_removed = lambda m, k: (
                self.loop_closer.db.erase(encode_dbid(m.mid, k))
            )
        self._next_frame_id = 0
        self.init_frame: Optional[Frame] = None
        self.prev_matched: Optional[np.ndarray] = None
        self.last_frame: Optional[Frame] = None
        self.ref_kf: Optional[int] = None
        self.velocity: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.last_kf_frame_id = 0
        self.trajectory: List[Tuple[float, np.ndarray, np.ndarray]] = []
        # Relative trajectory (reference SaveTrajectoryTUM semantics,
        # src/System.cc:480): each frame pose stored RELATIVE to its
        # reference keyframe so loop-closure / GBA corrections reach the
        # saved trajectory when composed at save time
        # (final_trajectory()).  Entries: (ts, map mid, kf_id, R_rel,
        # t_rel) with T_cw(frame) = T_rel @ T_cw(kf); kf_id = -1 stores
        # an absolute pose.
        self.traj_rel: List[Tuple[float, int, int, np.ndarray, np.ndarray]] = []
        # first trajectory index recorded in the CURRENT Atlas map's
        # coordinates (reset on Atlas recovery; used to re-express the
        # segment when maps merge)
        self._map_traj_start = 0
        self._rng = np.random.default_rng(0)
        self._frames_lost = 0
        self._lost_ts = 0.0   # timestamp of the OK->RECENTLY_LOST drop
        self._prev_kf_id = -1   # temporal predecessor for the IMU chain

        # fused device tracking step (mono, non-inertial fast path)
        self._mirror = td.MapMirror()
        self._fused_local = None   # (key, LocalBlock) cache
        self._ref_blk = None       # (key, device ref-KF block) cache
        self._ref_tracked_cache = None  # ((mid, version, ref_kf), count)
        self._pipe: List[_PipeEntry] = []  # in-flight pipelined frames
        # (last_frame_id, R, t) of the frame BEFORE last_frame, for
        # chain-start motion prediction without a virtual-pose detour
        self._prev_pose = None
        # first frame id whose dispatch could see the latest keyframe's
        # triangulated points (set when deferred tri/fuse results land)
        self._pts_fresh_fid = 0
        self.local_mapper.on_tf_applied = (
            lambda: setattr(self, "_pts_fresh_fid", self._next_frame_id)
        )
        self._fused_local_cap = 4096
        self.n_fused_frames = 0   # diagnostics: frames on the fused path
        # (frame_id, (mid, version), (H15, state)) ConstraintPoseImu of
        # the last inertially-optimised frame (reference mpcpi)
        self._marg_prior = None

        # inertial mode (reference: sensor IMU_MONOCULAR/IMU_STEREO)
        self.inertial = cfg.imu is not None and cfg.sensor.startswith("imu")
        self.imu_calib = None
        self.imu_queue = None
        self.last_kf_ts: Optional[float] = None
        self.first_kf_ts: Optional[float] = None
        self.cur_bias = np.zeros(6, np.float32)   # (bg, ba) carried forward
        if self.inertial:
            from ..imu.calib import ImuCalib

            self.imu_calib = ImuCalib.from_config(cfg.imu)
            self.imu_queue = imu_frontend.ImuQueue(self.imu_calib)
            self.local_mapper.imu_calib = self.imu_calib
            self.loop_closer.imu_calib = self.imu_calib

    # ------------------------------------------------------------ frames

    def _make_frame(self, img: np.ndarray, ts: float, init: bool = False,
                    lazy: bool = False) -> Frame:
        ext = self.init_extractor if init else self.extractor
        feats = ext(jnp.asarray(img))
        if self.has_dist:
            un_dev = undistort_points_pinhole(feats.xy, self.cam, self.dist)
        else:
            un_dev = feats.xy
        f = Frame(
            frame_id=self._next_frame_id,
            timestamp=ts,
            feats=feats,
            xy_un=None, octave=None, angle=None, desc=None, valid=None,
            kp_mp=np.full(feats.capacity, INVALID, np.int32),
            un_dev=un_dev,
            host_ready=False,
        )
        self._next_frame_id += 1
        if not lazy:
            # single device fetch for all host copies (each np.asarray
            # of a device array is one blocking round trip)
            f.ensure_host()
        return f

    def _make_frame_stereo(self, img_l: np.ndarray, img_r: np.ndarray,
                           ts: float) -> Frame:
        """Stereo Frame ctor (reference src/Frame.cc:88): extract both
        images, then ComputeStereoMatches -> mvuRight/mvDepth."""
        from ..frontend import stereo as fstereo
        from ..frontend.pyramid import compute_pyramid

        frame = self._make_frame(img_l, ts)
        feats_r = self.extractor(jnp.asarray(img_r))

        if self.cam_r is not None:
            # Non-rectified fisheye rig: match lapping-area descriptors
            # and triangulate (reference ComputeStereoFishEyeMatches,
            # Frame.cc:1139; stereo-overlap split ORBextractor.cc:1078).
            cc, cc2 = self.cfg.camera, self.cfg.camera2
            lap0 = cc.lapping_begin if cc.lapping_begin >= 0 else 0.0
            lap1 = cc.lapping_end if cc.lapping_end >= 0 else float(cc.width)
            lap0r = cc2.lapping_begin if cc2.lapping_begin >= 0 else 0.0
            lap1r = cc2.lapping_end if cc2.lapping_end >= 0 else float(cc2.width)
            lap_l = fstereo.lapping_mask(
                frame.feats.xy, lap0, lap1, frame.feats.valid
            )
            lap_r = fstereo.lapping_mask(feats_r.xy, lap0r, lap1r,
                                         feats_r.valid)
            res = fstereo.compute_stereo_fisheye_matches(
                self.kb8, self.cam_r,
                frame.feats.xy, frame.feats.octave, frame.feats.desc, lap_l,
                feats_r.xy, feats_r.octave, feats_r.desc, lap_r,
                jnp.asarray(self.R_rl), jnp.asarray(self.t_rl),
                np.asarray(self.sigma2, np.float32),
            )
            ok = np.asarray(res.valid)
            frame.depth = np.where(ok, np.asarray(res.depth), -1.0).astype(
                np.float32
            )
            frame.p3d_stereo = np.asarray(res.p3d).astype(np.float32)
            # no rectified virtual-right coordinate for fisheye
            # (reference keeps mvuRight = -1): residuals stay monocular
            return frame

        cfg = self.cfg.orb
        pyr_l = tuple(compute_pyramid(jnp.asarray(img_l), cfg.n_levels,
                                      cfg.scale_factor))
        pyr_r = tuple(compute_pyramid(jnp.asarray(img_r), cfg.n_levels,
                                      cfg.scale_factor))
        res = fstereo.compute_stereo_matches(
            frame.feats.xy, frame.feats.octave, frame.feats.desc,
            frame.feats.valid,
            feats_r.xy, feats_r.octave, feats_r.desc, feats_r.valid,
            pyr_l, pyr_r, self.scale_factors, self.bf, self.baseline,
        )
        frame.ur = np.where(np.asarray(res.valid), np.asarray(res.u_right),
                            -1.0).astype(np.float32)
        frame.depth = np.where(np.asarray(res.valid), np.asarray(res.depth),
                               -1.0).astype(np.float32)
        return frame

    def _make_frame_rgbd(self, img: np.ndarray, depthmap: np.ndarray,
                         ts: float) -> Frame:
        """RGBD Frame ctor (reference src/Frame.cc:191 +
        ComputeStereoFromRGBD :994): depth sampled at the raw keypoint
        coords; virtual right coord uR = uU - bf/d."""
        frame = self._make_frame(img, ts)
        xy = np.asarray(frame.feats.xy)
        v = np.round(np.clip(xy[:, 1], 0, depthmap.shape[0] - 1)).astype(int)
        u = np.round(np.clip(xy[:, 0], 0, depthmap.shape[1] - 1)).astype(int)
        d = depthmap[v, u].astype(np.float32)
        ok = frame.valid & (d > 0)
        frame.depth = np.where(ok, d, -1.0).astype(np.float32)
        frame.ur = np.where(
            ok, frame.xy_un[:, 0] - self.bf / np.maximum(d, 1e-9), -1.0
        ).astype(np.float32)
        return frame

    # ------------------------------------------------------------- entry

    def grab_imu(self, measurements):
        """Reference Tracking::GrabImuData (src/Tracking.cc:1111):
        measurements are (t, acc(3,), gyro(3,)) tuples."""
        if self.imu_queue is not None and measurements is not None:
            self.imu_queue.extend(measurements)

    def _preintegrate(self, frame: Frame):
        """Reference Tracking::PreintegrateIMU (src/Tracking.cc:1117):
        integrate the queue over (last frame, frame] and (last KF,
        frame] with the current bias estimate."""
        if not self.inertial or self.last_frame is None:
            return
        frame.preint_frame = self.imu_queue.preintegrate(
            self.last_frame.timestamp, frame.timestamp, self.cur_bias,
            host=True,
        )
        if self.last_kf_ts is not None:
            frame.preint_kf = self.imu_queue.preintegrate(
                self.last_kf_ts, frame.timestamp, self.cur_bias,
                host=True,
            )

    def _check_timestamps(self, ts: float) -> bool:
        """Clock-sanity guards (reference Tracking.cc:1415-1451).

        Returns True when the frame must be dropped: a timestamp
        REGRESSION clears the IMU queue and starts a fresh Atlas map (a
        bad clock would silently corrupt preintegration), and a JUMP of
        more than one second resets/forks the map for inertial runs
        (preintegrating across the gap is meaningless) and skips the
        frame for visual-only runs.
        """
        if self.state == TrackState.NO_IMAGES_YET or self.last_frame is None:
            return False
        last_ts = self.last_frame.timestamp
        if last_ts > ts:
            if self.inertial:
                self.imu_queue.drop_before(float("inf"))
            self._reset_map()
            return True
        if ts > last_ts + 1.0 and self.inertial:
            # Only inertial runs reset/fork on a gap (preintegrating
            # across it is meaningless); visual-only frames are processed
            # normally, like the reference.
            mp = self.atlas.current
            if mp.imu_initialized and mp.imu_ba2:
                self._reset_map()          # CreateMapInAtlas
            else:
                self._reset_active_map()   # ResetActiveMap
            return True
        return False

    def _reset_active_map(self):
        """System::ResetActiveMap analog (src/System.cc:441): discard the
        current map's contents and restart in place."""
        old_mid = self.atlas.current.mid
        self._reset_map()
        self.atlas.remove_map(old_mid)

    def track(self, img: np.ndarray, ts: float, imu=None):
        """GrabImageMonocular + Track (reference Tracking.cc:1038, :1390).
        `imu` is the optional list of (t, acc, gyro) measurements since
        the previous frame (inertial sensors)."""
        self.grab_imu(imu)
        if self._check_timestamps(ts):
            return self.state
        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            self._monocular_initialization(img, ts)
            return self.state
        if self._fused_applicable():
            st = self._track_fused(img, ts)
            if st is not None:
                return st
        # leaving the fused fast path: settle any in-flight frames first
        self._confirm_pipe()
        frame = self._make_frame(img, ts)
        self._preintegrate(frame)
        return self._track_existing(frame, ts)

    # --------------------------------------------------- fused fast path

    def _fused_applicable(self) -> bool:
        """The fused one-program step covers the common steady state:
        monocular, non-inertial, OK with a motion model, previous frame
        device-resident.  The previous frame's capacity is free to
        differ (the frame after initialisation chains from the 5x init
        extractor's arrays — jit just specialises a second variant)."""
        last = self.last_frame
        mp = self.atlas.current
        if self.inertial:
            # the inertial fused step (IMU prediction + in-program joint
            # pose-inertial optimization) engages once gravity/scale are
            # resolved; the staged-init prefix runs the legacy machinery
            return (
                self.cfg.tracking.use_fused
                and self.sensor == "imu-monocular"
                and self.cfg.orb.octree == "device"
                and self.state == TrackState.OK
                and mp.imu_initialized
                and last is not None
                and (last.R is not None or bool(self._pipe))
                and last.un_dev is not None
                and (last.v is not None or bool(self._pipe))
            )
        return (
            self.cfg.tracking.use_fused
            and (self.sensor == "monocular"
                 or (self.sensor == "stereo" and self.cam_r is None)
                 or self.sensor == "rgbd")
            and self.cfg.orb.octree == "device"  # fused step extracts on device
            and self.state == TrackState.OK
            and self.velocity is not None
            and last is not None
            and (last.R is not None or bool(self._pipe))
            and last.un_dev is not None
        )

    def _track_fused(self, img: np.ndarray, ts: float, img_r=None,
                     depth_mode: str = "stereo"):
        """One-program frame step (slam/track_device.py): extract ->
        motion-model search -> pose opt -> local-map search -> pose opt.
        Returns the new state, or None to fall back to the legacy path
        before any work was done.

        With ``tracking.pipeline_depth = K > 0`` consecutive frames form
        a device-to-device chain: each dispatch consumes the previous
        dispatch's pose/feature/association arrays (motion prediction
        runs in-program), and the host pays ONE round-trip fetch per K+1
        frames to confirm the whole batch.  This is the analog of
        the reference's decoupled tracking thread: decisions (keyframe
        insertion, failure handling) lag by at most K frames, exactly
        like LocalMapping's queue latency (src/LocalMapping.cc:278)."""
        mp = self.atlas.current
        if self.ref_kf is None:
            return None
        if self.ref_kf not in mp.keyframes:  # culled by local mapping
            if not mp.keyframes:
                return None
            self.ref_kf = max(mp.keyframes.keys())
        self._mirror.sync(mp)
        key = (mp.mid, mp.version, self.ref_kf)
        if self._fused_local is None or self._fused_local[0] != key:
            local_kfs = [self.ref_kf] + [
                k for k, _ in
                mp.covisible_keyframes(self.ref_kf, min_weight=1)[:10]
            ]
            blk = td.build_local_block(mp, local_kfs, self._fused_local_cap)
            if blk is None:
                return None
            self._fused_local = (key, blk)
        blk = self._fused_local[1]

        # inertial inputs: preintegrate (last frame, this frame] with the
        # current bias (host window slice + one async device scan, no
        # fetch); chained body state + prior ride from the pipe tail's
        # device outputs
        imu_in = None
        if self.inertial:
            last = self.last_frame
            preint = self.imu_queue.preintegrate(
                last.timestamp if not self._pipe else self._pipe[-1].ts,
                ts, self.cur_bias,
            )
            if preint is None:
                return None  # no IMU coverage: legacy path
            calib = self.imu_calib
            if self._pipe:
                tail = self._pipe[-1].out
                v_in, bg_in, ba_in, H_in = (
                    tail.v, tail.bg, tail.ba, tail.H15)
            else:
                v_in = jnp.asarray(np.asarray(last.v, np.float32))
                bg_in = jnp.asarray(np.asarray(
                    last.bg if last.bg is not None else self.cur_bias[:3],
                    np.float32))
                ba_in = jnp.asarray(np.asarray(
                    last.ba if last.ba is not None else self.cur_bias[3:],
                    np.float32))
                mh = self._marg_prior
                if mh is not None and mh[0] == last.frame_id:
                    H_in = mh[2][0]
                else:
                    H_in = jnp.eye(15, dtype=jnp.float32) * 1e4
            imu_in = (preint, v_in, bg_in, ba_in, H_in,
                      jnp.asarray(calib.Rcb), jnp.asarray(calib.tcb))

        step = td.get_track_step(
            self.cfg.camera, self.cfg.orb, img.shape, self._mirror.cap,
            self._fused_local_cap,
            stereo_bf=self.bf if img_r is not None else 0.0,
            baseline=self.baseline if img_r is not None else 0.0,
            th_depth=self.th_depth if img_r is not None else 0.0,
            depth_mode=depth_mode,
            inertial=self.inertial,
        )
        ref_desc, ref_valid, ref_kp = self._ref_block(mp)
        last = self.last_frame
        # pose-chain inputs: device arrays from the pipeline tail when
        # chaining, else the committed host pose + the virtual previous
        # pose implied by the motion model (T_prev = V^-1 T_last)
        if self._pipe:
            tail = self._pipe[-1]
            R_last_in, t_last_in = tail.out.R, tail.out.t
            if len(self._pipe) >= 2:
                R_prev_in = self._pipe[-2].out.R
                t_prev_in = self._pipe[-2].out.t
            else:
                pf = tail.prev_frame
                R_prev_in = jnp.asarray(pf.R)
                t_prev_in = jnp.asarray(pf.t)
        else:
            R1, t1 = last.R, last.t
            R_last_in = jnp.asarray(R1)
            t_last_in = jnp.asarray(t1)
            if self.inertial:
                # IMU prediction ignores the virtual-velocity inputs
                R_prev_in, t_prev_in = R_last_in, t_last_in
            elif self._prev_pose is not None \
                    and self._prev_pose[0] == last.frame_id:
                # actual predecessor pose: the in-program velocity
                # R_last @ R_prev^T then matches the host formula
                # bit-for-bit.  (Reconstructing a virtual predecessor
                # as Rv^T R1 injects R1 R1^T — pose-opt rotations are
                # not exactly orthonormal, and feeding that asymmetry
                # back into every prediction measurably degrades
                # accuracy at pipeline_depth=0.)
                _, Rp, tp = self._prev_pose
                R_prev_in = jnp.asarray(Rp)
                t_prev_in = jnp.asarray(tp)
            else:
                Rv, tv = self.velocity
                R_prev_in = jnp.asarray((Rv.T @ R1).astype(np.float32))
                t_prev_in = jnp.asarray(
                    (Rv.T @ (t1 - tv)).astype(np.float32))
        last_kp = (
            last.kp_mp_dev
            if last.kp_mp_dev is not None and not last.kp_mp_dirty
            else jnp.asarray(last.kp_mp)
        )
        out = step(
            jnp.asarray(img),
            last.un_dev, last.feats.desc, last.feats.octave,
            last.feats.angle, last_kp,
            self._mirror.pos, self._mirror.valid,
            blk.ids_dev, blk.pos, blk.desc, blk.norm, blk.maxd, blk.val,
            ref_desc, ref_valid, ref_kp,
            R_last_in, t_last_in, R_prev_in, t_prev_in,
            img_r=None if img_r is None else jnp.asarray(img_r),
            imu=imu_in,
        )
        frame = Frame(
            frame_id=self._next_frame_id, timestamp=ts, feats=out.feats,
            xy_un=None, octave=None, angle=None, desc=None, valid=None,
            kp_mp=None, un_dev=out.xy_un,
            kp_mp_dev=out.kp_mp, host_ready=False,
            ur_dev=None if img_r is None else out.ur,
            depth_dev=None if img_r is None else out.depth,
        )
        self._next_frame_id += 1
        self._pipe.append(_PipeEntry(
            frame=frame, out=out, ts=ts, prev_frame=last, blk_ids=blk.ids,
        ))
        self.n_fused_frames += 1
        # optimistic: in-flight frames report OK; the confirmation fetch
        # corrects state/trajectory (and replays through the legacy path
        # on a failed gate)
        self.last_frame = frame
        self.state = TrackState.OK
        if len(self._pipe) > self.cfg.tracking.pipeline_depth:
            # keep the 2 newest frames computing on device while the
            # host settles the older ones
            self._confirm_pipe(keep=min(2, self.cfg.tracking.pipeline_depth - 1))
        return self.state

    def _ref_block(self, mp: SLAMMap):
        """Device block of the reference keyframe's map-point-bearing
        keypoints (descriptors + map-point ids), for the in-program
        TrackReferenceKeyFrame fallback.  Cached per (map version,
        ref_kf); re-uploaded only when the map changes."""
        key = (mp.mid, mp.version, self.ref_kf)
        if self._ref_blk is not None and self._ref_blk[0] == key:
            return self._ref_blk[1]
        kf = mp.keyframes[self.ref_kf]
        N = self.cfg.orb.n_features + self.cfg.orb.n_levels * 16
        desc = np.zeros((N, 32), np.uint8)
        valid = np.zeros((N,), bool)
        kp_mp_arr = np.full((N,), -1, np.int32)
        idx = np.where(kf.valid & (kf.kp_mp >= 0))[0][:N]
        k = len(idx)
        if k:
            desc[:k] = kf.desc[idx]
            mpids = kf.kp_mp[idx]
            live = mp.mp_valid[mpids]
            valid[:k] = live
            kp_mp_arr[:k] = np.where(live, mpids, -1)
        blk = (jnp.asarray(desc), jnp.asarray(valid),
               jnp.asarray(kp_mp_arr))
        self._ref_blk = (key, blk)
        return blk

    def flush(self):
        """Settle all in-flight pipelined frames (states, trajectory,
        keyframe decisions), deferred mapping results, and any in-flight
        async global BA.  No-op in synchronous mode."""
        self._confirm_pipe()
        self.local_mapper.flush_tf(self.atlas.current)
        self.local_mapper.flush_ba(self.atlas.current)
        self.loop_closer.finish(self.atlas.current)

    def _confirm_pipe(self, keep: int = 0):
        """Pay one device round trip to confirm in-flight frames:
        gates, velocity/trajectory commits, keyframe decisions.  A frame
        that fails its gates (or follows a pose-rewriting loop closure /
        merge) is replayed through the legacy state machine.  The local
        mapper's deferred triangulation/fuse results ride the same
        fetch.

        ``keep`` leaves that many of the NEWEST frames in flight: the
        blocking fetch then only waits for work dispatched >= keep
        frames ago (usually already finished), so the device keeps
        computing the chain tail while the host does confirmation
        bookkeeping — without it every confirm stalls on the frame
        dispatched microseconds earlier."""
        if not self._pipe:
            self.local_mapper.flush_tf(self.atlas.current)
            return
        keep = min(keep, len(self._pipe) - 1)
        n_confirm = len(self._pipe) - keep
        pending = self._pipe[:n_confirm]
        self._pipe = self._pipe[n_confirm:]
        tf_handles = self.local_mapper.pending_tf_handles()
        # kp_mp + lm_searched ride along for every entry (~9 KB each):
        # the found/visible counters MUST tick every frame — sampling
        # them only on keyframes stretches MapPointCulling's probation
        # from 3 frames to 3 keyframes and lets bad triangulations
        # accumulate (measured as progressive ATE drift)
        payload = [
            (e.out.R, e.out.t, e.out.n_match_motion, e.out.n_inl_motion,
             e.out.n_inl_final, e.out.used_ref, e.out.n_pre,
             e.out.kp_mp, e.out.lm_searched,
             e.out.n_close_tracked, e.out.n_close_untracked,
             e.out.v, e.out.bg, e.out.ba)
            for e in pending
        ]
        n_gate = len(payload)
        # the previous keyframe's in-flight window BA result rides this
        # same round trip (a separate flush_ba fetch pays one more
        # round trip at the next keyframe event)
        ba_handles = self.local_mapper.pending_ba_handles()
        if ba_handles:
            payload.append(ba_handles)
        if tf_handles:
            payload.append(tf_handles)
        # speculative keyframe prefetch: the cadence trigger (c1a) is
        # deterministic from frame ids, so the entry it will fire on is
        # known BEFORE the fetch — ride its feature host copies on this
        # same round trip instead of paying a second one
        spec_idx = None
        for i, e in enumerate(pending):
            if e.frame.frame_id >= (self.last_kf_frame_id
                                    + self.cfg.tracking.max_frames):
                spec_idx = i
                break
        if spec_idx is not None:
            payload.append(self._kf_fetch_handles(pending[spec_idx]))
        fetched = pack_fetch(payload)
        extra = n_gate
        if ba_handles:
            # apply the OLDER result first: window BA predates the
            # deferred triangulation/fuse of the newest keyframe
            self.local_mapper.apply_ba_fetched(
                self.atlas.current, fetched[extra]
            )
            extra += 1
        spec_vals = fetched[extra + bool(tf_handles)] \
            if spec_idx is not None else None
        if tf_handles:
            self.local_mapper.apply_tf(self.atlas.current, fetched[extra])
        fetched = fetched[:n_gate]
        kf_created = False
        for i, (e, (R, t, n_match, n1, n2, used_ref, n_pre,
                    kp_mp_h, lm_searched, n_ct, n_cu,
                    v_h, bg_h, ba_h)) in enumerate(
                zip(pending, fetched)):
            frame = e.frame
            # motion-model gates (reference Tracking.cc:2475-2528) or
            # the in-program TrackReferenceKeyFrame fallback's
            # (>=10 map-point inliers, :2308); TrackLocalMap then needs
            # >=30 final inliers either way (:2612)
            min_final = 15 if self.inertial else 30
            ok = int(n2) >= min_final and (
                (int(n_match) >= 20 and int(n1) >= 10)
                or (bool(used_ref) and int(n_pre) >= 10)
            )
            if not ok:
                rest = pending[i:] + self._pipe
                self._pipe = []
                self._replay(rest)
                return
            frame.R = np.asarray(R).copy()
            frame.t = np.asarray(t).copy()
            if self.inertial:
                frame.v = np.asarray(v_h).copy()
                frame.bg = np.asarray(bg_h).copy()
                frame.ba = np.asarray(ba_h).copy()
                self.cur_bias = np.concatenate(
                    [frame.bg, frame.ba]).astype(np.float32)
            self.state = TrackState.OK
            self._frames_lost = 0
            prev = e.prev_frame
            Rv = frame.R @ prev.R.T
            self.velocity = (Rv, frame.t - Rv @ prev.t)
            # remember the predecessor pose so the next chain start can
            # use it directly instead of a reconstructed virtual pose
            self._prev_pose = (frame.frame_id, prev.R.copy(),
                               prev.t.copy())
            mp = self.atlas.current
            # per-frame found/visible bookkeeping (reference
            # IncreaseVisible/IncreaseFound, Tracking.cc:2540+)
            frame.kp_mp = np.asarray(kp_mp_h).copy()
            ids = e.blk_ids[np.asarray(lm_searched)]
            ids = ids[ids < len(mp.mp_visible)]
            mp.mp_visible[ids] += 1
            found = frame.kp_mp[frame.kp_mp >= 0]
            found = found[found < len(mp.mp_found)]
            mp.mp_found[found] += 1
            # at most ONE keyframe per confirmation batch: the later
            # entries were tracked against the pre-keyframe map, so
            # their inlier counts can't reflect it — inserting on them
            # cascades keyframes.  This is the reference's
            # SetAcceptKeyFrames(false) while LocalMapping is busy
            # (src/LocalMapping.cc:75,264).
            close_counts = (int(n_ct), int(n_cu)) \
                if e.frame.ur_dev is not None else None
            if not kf_created and \
                    self._need_new_keyframe(frame, tracked=int(n2),
                                            close_counts=close_counts):
                kf_created = True
                # feature host copies: prefetched when this is the
                # speculated cadence keyframe, one extra fetch otherwise
                # (rare weak-tracking keyframes)
                vals = spec_vals if i == spec_idx else pack_fetch(
                    self._kf_fetch_handles(e)
                )
                frame.set_host(vals)
                self._create_keyframe(frame)
                stale = self.velocity is None or \
                    getattr(self, "_vi_stage_fired", False)
                self._vi_stage_fired = False
                if stale and (i + 1 < len(pending) or self._pipe):
                    # a loop closure / merge / IMU-init stage rewrote
                    # the map poses: the remaining chained frames were
                    # predicted in the old frame of reference
                    rest = pending[i + 1:] + self._pipe
                    self._pipe = []
                    self._replay(rest)
                    return
            self._record_traj(e.ts, frame.R, frame.t)
            if i == len(pending) - 1 and not self._pipe:
                self.last_frame = frame

    @staticmethod
    def _kf_fetch_handles(e: "_PipeEntry"):
        """Device handles for a pipe entry's keyframe-promotion feature
        host copies (Frame.set_host order; stereo frames append their
        ur/depth channels)."""
        return e.frame.host_handles()

    def _replay(self, entries):
        """Re-run in-flight frames through the legacy state machine
        (reference falls back to TrackReferenceKeyFrame / relocalization
        on a failed motion-model track, Tracking.cc:1549)."""
        prev = entries[0].prev_frame
        prev.ensure_host()
        self.last_frame = prev
        for e in entries:
            f = e.frame
            f.ensure_host()
            f.R = f.t = None
            f.kp_mp[:] = INVALID
            f.kp_mp_dirty = True
            self._preintegrate(f)
            self._track_existing(f, e.ts)

    def track_stereo(self, img_l: np.ndarray, img_r: np.ndarray, ts: float,
                     imu=None):
        """GrabImageStereo + Track (reference Tracking.cc + System.cc:222)."""
        self.grab_imu(imu)
        if self._check_timestamps(ts):
            return self.state
        if self._fused_applicable():
            st = self._track_fused(img_l, ts, img_r=img_r)
            if st is not None:
                return st
        frame = self._make_frame_stereo(img_l, img_r, ts)
        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            self._stereo_initialization(frame)
            return self.state
        self._preintegrate(frame)
        return self._track_existing(frame, ts)

    def track_rgbd(self, img: np.ndarray, depthmap: np.ndarray, ts: float):
        """GrabImageRGBD + Track (reference System.cc:288)."""
        if self._check_timestamps(ts):
            return self.state
        if self._fused_applicable():
            st = self._track_fused(
                img, ts, img_r=np.asarray(depthmap, np.float32),
                depth_mode="rgbd",
            )
            if st is not None:
                return st
        frame = self._make_frame_rgbd(img, depthmap, ts)
        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            self._stereo_initialization(frame)
            return self.state
        return self._track_existing(frame, ts)

    def _track_existing(self, frame: Frame, ts: float):
        """Shared post-initialization state machine (Track(), :1390)."""
        if self.state == TrackState.RECENTLY_LOST:
            return self._track_recently_lost(frame, ts)
        if self.state == TrackState.LOST:
            if self._relocalize(frame) and self._track_local_map(frame):
                self.state = TrackState.OK
                self.velocity = None
            else:
                self._frames_lost += 1
                # Atlas recovery (reference Tracking.cc:1607-1625): enough
                # map to keep -> start a fresh map, else reset in place
                if self._frames_lost > 5:
                    # reference keeps the map at >=10 keyframes
                    # (Tracking.cc:1607: KeyFramesInMap()<10 -> reset)
                    if len(self.atlas.current.keyframes) >= 10:
                        self._reset_map()
                    else:
                        # discard the failed map via remove_map so the
                        # Atlas `active` index keeps tracking the new
                        # map (a raw list pop left it dangling)
                        failed_mid = self.atlas.current.mid
                        self._reset_map()
                        self.atlas.remove_map(failed_mid)
                    self._frames_lost = 0
            self.last_frame = frame
            if frame.R is not None and self.state == TrackState.OK:
                self._record_traj(ts, frame.R, frame.t)
        else:
            ok = self._track_frame(frame)
            if ok:
                self.state = TrackState.OK
                self._frames_lost = 0
            else:
                self._enter_lost(ts)
            self.last_frame = frame
            if frame.R is not None and ok:
                self._record_traj(ts, frame.R, frame.t)
        return self.state

    def _enter_lost(self, ts: float):
        """Track-failure transition (reference Tracking.cc:1576-1605):
        with a mature map (>10 KFs, and IMU initialized when inertial)
        hold RECENTLY_LOST for ``time_recently_lost`` seconds instead of
        dropping straight to LOST."""
        mp = self.atlas.current
        mature = len(mp.keyframes) > 10 and (
            not self.inertial or mp.imu_initialized
        )
        if mature:
            self.state = TrackState.RECENTLY_LOST
            self._lost_ts = ts
        else:
            self.state = TrackState.LOST

    def _track_recently_lost(self, frame: Frame, ts: float):
        """RECENTLY_LOST handling (reference Tracking.cc:1576-1605):
        inertial runs keep predicting the pose with the IMU so the
        output trajectory stays continuous; every run retries
        relocalization each frame.  After ``time_recently_lost`` seconds
        without recovery the state drops to LOST (Atlas recovery)."""
        predicted = False
        if self.inertial and self._imu_ready(frame):
            # PredictStateIMU (reference Tracking.cc:1589) keeps the
            # pose estimate alive while relocalization is attempted.
            last = self.last_frame
            Rwb1, twb1 = self.imu_calib.body_from_cam(last.R, last.t)
            Rwb2, twb2, v2 = imu_frontend.predict_state(
                Rwb1, twb1, last.v, self.cur_bias, frame.preint_frame
            )
            frame.R, frame.t = self.imu_calib.cam_from_body(Rwb2, twb2)
            frame.v = v2
            frame.bg = self.cur_bias[:3].copy()
            frame.ba = self.cur_bias[3:].copy()
            predicted = True
        pred_Rt = (frame.R, frame.t) if predicted else None
        if self._relocalize(frame) and self._track_local_map(frame):
            self.state = TrackState.OK
            self.velocity = None
            self._frames_lost = 0
            # the dead-reckoned velocity estimate is stale after a
            # visual relocalization; re-seed it from visual tracking
            frame.v = None
        else:
            if pred_Rt is not None:
                # _relocalize writes candidate poses/matches into the
                # frame on failed attempts; restore the IMU prediction.
                frame.R, frame.t = pred_Rt
                frame.kp_mp[:] = INVALID
            if ts - self._lost_ts > self.cfg.tracking.time_recently_lost:
                self.state = TrackState.LOST
        self.last_frame = frame
        if frame.R is not None and (
            self.state == TrackState.OK or predicted
        ):
            self._record_traj(ts, frame.R, frame.t)
        return self.state

    def _stereo_initialization(self, frame: Frame):
        """Reference StereoInitialization (Tracking.cc:1924 region): with
        >500 keypoints, the first frame becomes a keyframe at the origin
        and every positive-depth keypoint is unprojected into a map
        point."""
        if int(frame.feats.count()) <= 500:
            self.last_frame = frame
            return
        mp = self.atlas.current
        frame.R = np.eye(3, dtype=np.float32)
        frame.t = np.zeros(3, np.float32)
        kf = self._promote(frame, mp)
        fx, fy = self.K[0, 0], self.K[1, 1]
        cx, cy = self.K[0, 2], self.K[1, 2]
        n_pts = 0
        for i in np.where(frame.valid & (frame.depth > 0))[0]:
            z = float(frame.depth[i])
            if self.th_far_points > 0 and z > self.th_far_points:
                continue  # thFarPoints (reference Tracking mbFarPoints)
            if frame.p3d_stereo is not None:
                pos = frame.p3d_stereo[i].astype(np.float32)
            else:
                u, v = frame.xy_un[i]
                pos = np.array(
                    [(u - cx) * z / fx, (v - cy) * z / fy, z], np.float32
                )
            mid = mp.add_point(pos, frame.desc[i], np.zeros(3, np.float32),
                               1.0, kf.kid)
            mp.add_observation(mid, kf.kid, int(i))
            frame.kp_mp[i] = mid
            n_pts += 1
        mp.update_point_stats_batch(frame.kp_mp[frame.kp_mp >= 0])
        if n_pts < 100:
            self._reset_map()
            self.last_frame = frame
            return
        if self.inertial:
            self._prev_kf_id = kf.kid
            self.last_kf_ts = frame.timestamp
            self.first_kf_ts = frame.timestamp
            kf.bg = self.cur_bias[:3].copy()
            kf.ba = self.cur_bias[3:].copy()
            self.imu_queue.drop_before(frame.timestamp - 0.01)
        self.ref_kf = kf.kid
        self.last_kf_frame_id = frame.frame_id
        self.velocity = None
        self.state = TrackState.OK
        self.last_frame = frame
        self._record_traj(frame.timestamp, frame.R, frame.t)

    def _relocalize(self, frame: Frame) -> bool:
        """Relocalization (reference Tracking.cc:3184): place-recognition
        candidates + descriptor matching + batched RANSAC PnP initial
        pose (solver/pnp.py, the MLPnPsolver replacement) + robust pose
        optimisation; falls back to the candidate keyframe's pose when
        PnP fails."""
        mp = self.atlas.current
        db = self.loop_closer.db
        candidates = []
        if db is not None:
            from .loop_closing import decode_dbid, encode_dbid

            def covis_keys(key):
                m, k = decode_dbid(key)
                target = self.atlas.map_by_mid(m)
                if target is None or k not in target.keyframes:
                    return []
                return [encode_dbid(m, nk)
                        for nk, _ in target.covisible_keyframes(k, 1)[:10]]

            # DetectRelocalizationCandidates (reference
            # KeyFrameDatabase.cc:783): covisibility-group accumulation,
            # all groups within 0.75x of the best accumulated score
            candidates = [
                k
                for key, _ in db.query(
                    frame.desc, valid=frame.valid, n_best=5,
                    covis_fn=covis_keys, rel_score_ratio=0.75,
                )
                for m, k in [decode_dbid(key)]
                if m == mp.mid
            ][:5]
        if not candidates:
            # fallback: most recent keyframes
            candidates = sorted(mp.keyframes.keys())[-3:]
        for cand in candidates:
            if cand not in mp.keyframes:
                continue
            kf = mp.keyframes[cand]
            m12, _ = fm.mutual_best_match(
                frame.feats.desc, frame.feats.valid,
                jnp.asarray(kf.desc), jnp.asarray(kf.valid & (kf.kp_mp >= 0)),
            )
            m12 = np.asarray(m12)
            frame.kp_mp[:] = INVALID
            for i, j in enumerate(m12):
                if j >= 0 and kf.kp_mp[j] >= 0 and mp.mp_valid[kf.kp_mp[j]]:
                    frame.kp_mp[i] = kf.kp_mp[j]
            if (frame.kp_mp >= 0).sum() < 15:
                continue
            matched = frame.kp_mp >= 0
            p3d = np.zeros((len(frame.kp_mp), 3), np.float32)
            p3d[matched] = mp.mp_pos[frame.kp_mp[matched]]
            fx, fy = self.K[0, 0], self.K[1, 1]
            if self.is_fisheye:
                # MLPnP (reference inc/MLPnPsolver.h:59-157, the solver
                # Relocalization actually uses): unproject through the
                # full KB8 model to UNIT BEARINGS and solve with the
                # nullspace-parameterized estimator + covariance-
                # weighted GN — bearings anywhere on the sphere,
                # including >87-degree off-axis fisheye rays a z=1
                # projection cannot express, are first-class.
                bear = np.asarray(self.kb8.unproject(
                    jnp.asarray(frame.xy_un)))
                bear = (bear / np.maximum(np.linalg.norm(
                    bear, axis=1, keepdims=True), 1e-12)).astype(np.float32)
                res = pnp.mlpnp_ransac(
                    jnp.asarray(p3d), jnp.asarray(bear),
                    jnp.asarray(matched),
                    jax.random.PRNGKey(frame.frame_id),
                    min_inliers=12,
                )
                if bool(res.ok):
                    info = np.asarray(self.inv_sigma2, np.float32)[
                        np.clip(frame.octave, 0,
                                len(self.inv_sigma2) - 1)
                    ] * (fx * fx)
                    R_r, t_r = pnp.mlpnp_refine(
                        res.R, res.t, jnp.asarray(p3d),
                        jnp.asarray(bear), jnp.asarray(info),
                        jnp.asarray(matched & np.asarray(res.inliers)),
                    )
                    frame.R = np.asarray(R_r)
                    frame.t = np.asarray(t_r)
                else:
                    frame.R = kf.R.copy()
                    frame.t = kf.t.copy()
                if self._pose_opt(frame, min_inliers=20):
                    self.ref_kf = cand
                    return True
                continue
            xy_n = (frame.xy_un - self.K[:2, 2]) / np.array(
                [fx, fy], np.float32
            )
            res = pnp.ransac_pnp(
                jnp.asarray(p3d), jnp.asarray(xy_n), jnp.asarray(matched),
                jax.random.PRNGKey(frame.frame_id),
                th=float(3.0 / fx), min_inliers=12,
            )
            if bool(res.ok):
                frame.R = np.asarray(res.R)
                frame.t = np.asarray(res.t)
            else:
                frame.R = kf.R.copy()
                frame.t = kf.t.copy()
            if self._pose_opt(frame, min_inliers=20):
                self.ref_kf = cand
                return True
        return False

    # ---------------------------------------------------- initialization

    def _monocular_initialization(self, img, ts):
        """Reference MonocularInitialization (Tracking.cc:2018).

        Frames are extracted LAZILY (host copies deferred) and the
        window search is dispatched on the device arrays; one combined
        fetch then lands the match vector together with both frames'
        host copies — 3 round trips fewer than eager frames."""
        frame = self._make_frame(img, ts, init=True, lazy=True)
        if self.init_frame is None or self.state == TrackState.NO_IMAGES_YET:
            if int(frame.feats.count()) >= 100:
                self.init_frame = frame
                self.prev_matched = None  # host copy lands on the fetch
                self.state = TrackState.NOT_INITIALIZED
            self.last_frame = frame
            return
        if int(frame.feats.count()) <= 100:
            self.init_frame = None
            self.state = TrackState.NO_IMAGES_YET
            self.last_frame = frame
            return

        f1, f2 = self.init_frame, frame
        un1 = f1.un_dev if f1.un_dev is not None else f1.feats.xy
        un2 = f2.un_dev if f2.un_dev is not None else f2.feats.xy
        prev = (jnp.asarray(self.prev_matched)
                if self.prev_matched is not None else un1)
        m12_dev = fm.search_for_initialization(
            f1.feats.desc, un1, f1.feats.angle,
            f1.feats.octave, f1.feats.valid,
            f2.feats.desc, un2, f2.feats.angle,
            f2.feats.octave, f2.feats.valid,
            100,
            prev,
        )
        fetch = jax.device_get(
            (m12_dev,)
            + (f1.host_handles() if not f1.host_ready else ())
            + (f2.host_handles() if not f2.host_ready else ())
        )
        m12 = np.asarray(fetch[0])
        off = 1
        if not f1.host_ready:
            f1.set_host(fetch[off:off + 5])
            off += 5
        if not f2.host_ready:
            f2.set_host(fetch[off:off + 5])
        if self.prev_matched is None:
            self.prev_matched = f1.xy_un.copy()
        n = (m12 >= 0).sum()
        if n < 100:
            self.init_frame = None
            self.state = TrackState.NO_IMAGES_YET
            self.last_frame = frame
            return
        # update prev_matched like the reference
        idx1 = np.where(m12 >= 0)[0]
        self.prev_matched[idx1] = f2.xy_un[m12[idx1]]

        cap = 1024
        sel = idx1[:cap]
        x1 = np.zeros((cap, 2), np.float32)
        x2 = np.zeros((cap, 2), np.float32)
        vmask = np.zeros(cap, bool)
        x1[: len(sel)] = f1.xy_un[sel]
        x2[: len(sel)] = f2.xy_un[m12[sel]]
        vmask[: len(sel)] = True
        res = tv.reconstruct(
            jax.random.PRNGKey(int(self._rng.integers(1 << 30))),
            jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(vmask),
            jnp.asarray(self.K),
        )
        # one batched fetch of the whole reconstruction result (field-by
        # -field np.asarray costs a round trip each)
        success, R21, t21, tri, pts = jax.device_get(
            (res.success, res.R21, res.t21, res.is_triangulated,
             res.points3d)
        )
        if not bool(success):
            self.last_frame = frame
            return
        self._create_initial_map(
            f1, f2, sel, m12,
            np.asarray(R21), np.asarray(t21), np.asarray(tri),
            np.asarray(pts),
        )
        self.last_frame = frame

    def _create_initial_map(self, f1: Frame, f2: Frame, sel, m12,
                            R21, t21, tri, pts):
        """Reference CreateInitialMapMonocular (Tracking.cc:2099)."""
        mp = self.atlas.current

        f1.R, f1.t = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        f2.R, f2.t = R21.astype(np.float32), t21.astype(np.float32)

        kf1 = self._promote(f1, mp)
        kf2 = self._promote(f2, mp)

        for j, i1 in enumerate(sel):
            if not tri[j]:
                continue
            i2 = int(m12[i1])
            pos = pts[j]
            kp = int(i2)
            d = f2.desc[kp]
            mid = mp.add_point(pos, d, np.zeros(3, np.float32), 1.0, kf2.kid)
            mp.add_observation(mid, kf1.kid, int(i1))
            mp.add_observation(mid, kf2.kid, i2)

        # global BA on the 2-KF map (reference: 20 iters)
        local_mapping.run_ba(
            mp, [kf1.kid, kf2.kid], set(), self.project, self.inv_sigma2,
            # reference runs GlobalBundleAdjustemnt(map, 20) here with
            # g2o's early convergence exit; our fixed-budget LM-PCG has
            # no early exit.  12 LM iterations match 20 in measured ATE;
            # cutting the CG budget below 40 measurably hurts (0.039 ->
            # 0.050 on the synthetic sequence), so only the LM count is
            # trimmed.
            n_iters=12, cg_iters=40,
        )

        # median-depth normalisation (reference Tracking.cc:2166-2195)
        valid_ids = np.where(mp.mp_valid[: mp._next_mp])[0]
        if len(valid_ids) < 50:
            self._reset_map()
            return
        pc1 = mp.mp_pos[valid_ids] @ kf1.R.T + kf1.t
        median_depth = float(np.median(pc1[:, 2]))
        if median_depth <= 0:
            self._reset_map()
            return
        inv_md = 1.0 / median_depth
        kf2.t = kf2.t * inv_md
        mp.mp_pos[valid_ids] *= inv_md
        mp.update_point_stats_batch(valid_ids)

        f2.R, f2.t = kf2.R.copy(), kf2.t.copy()
        f1.kp_mp = kf1.kp_mp
        f2.kp_mp = kf2.kp_mp
        if self.inertial:
            # seed the temporal IMU chain with the two init keyframes
            self._prev_kf_id = kf1.kid
            self.last_kf_ts = f1.timestamp
            self.first_kf_ts = f1.timestamp
            kf2.prev_kf = kf1.kid
            kf2.imu_meas = self.imu_queue.raw_window(
                f1.timestamp, f2.timestamp
            )
            kf2.preint = self.imu_queue.preintegrate(
                f1.timestamp, f2.timestamp, self.cur_bias
            )
            kf1.bg = kf2.bg = self.cur_bias[:3].copy()
            kf1.ba = kf2.ba = self.cur_bias[3:].copy()
            self._prev_kf_id = kf2.kid
            self.last_kf_ts = f2.timestamp
            self.imu_queue.drop_before(f2.timestamp - 0.01)
        self.ref_kf = kf2.kid
        self.last_kf_frame_id = f2.frame_id
        if not self.inertial:
            # seed the motion model from the two init frames (both
            # poses known, typically adjacent) so the first post-init
            # frame takes the fused fast path; the actual predecessor
            # pose rides along so the in-program prediction is exact.
            # Inertial runs keep the reference behavior (no velocity
            # until the first tracked frame): their early frames must
            # route through TrackReferenceKeyFrame while the IMU
            # initialisation window builds.
            Rv = (f2.R @ f1.R.T).astype(np.float32)
            self.velocity = (Rv, (f2.t - Rv @ f1.t).astype(np.float32))
            self._prev_pose = (f2.frame_id, f1.R.copy(), f1.t.copy())
        else:
            self.velocity = None
        self.state = TrackState.OK
        self._record_traj(f1.timestamp, f1.R, f1.t)
        self._record_traj(f2.timestamp, f2.R, f2.t)

    def _record_traj(self, ts: float, R: np.ndarray, t: np.ndarray):
        """Append to both trajectory forms (absolute for live reads,
        reference-keyframe-relative for corrected saves)."""
        self.trajectory.append((ts, R.copy(), t.copy()))
        mp = self.atlas.current
        k = self.ref_kf
        if k is not None and k in mp.keyframes:
            kf = mp.keyframes[k]
            R_rel = (R @ kf.R.T).astype(np.float32)
            t_rel = (t - R_rel @ kf.t).astype(np.float32)
            self.traj_rel.append((ts, mp.mid, k, R_rel, t_rel))
        else:
            self.traj_rel.append((ts, mp.mid, -1, R.copy(), t.copy()))

    def final_trajectory(self) -> List[Tuple[float, np.ndarray, np.ndarray]]:
        """Frame poses with all map corrections applied (reference
        SaveTrajectoryTUM, src/System.cc:480): compose each stored
        relative pose with its reference keyframe's CURRENT pose,
        walking tombstones of culled keyframes up the spanning tree
        (reference KeyFrame::SetBadFlag stores mTcp for this)."""
        self._confirm_pipe()
        out = []
        for i, (ts, mid, kf_id, R_rel, t_rel) in enumerate(self.traj_rel):
            mp = self.atlas.map_by_mid(mid)
            if kf_id < 0:
                out.append((ts, R_rel, t_rel))
                continue
            if mp is None:
                # map was dropped and the entry never re-expressed
                # (stale reference): degrade to the absolute pose we
                # recorded live rather than emitting a relative
                # transform as if it were a pose
                _, Ra, ta = self.trajectory[i]
                out.append((ts, Ra, ta))
                continue
            R_acc, t_acc = R_rel, t_rel
            k = kf_id
            guard = 0
            while k >= 0 and k not in mp.keyframes and k in mp.dead_kfs \
                    and guard < 1000:
                pk, R_cp, t_cp = mp.dead_kfs[k]
                t_acc = (R_acc @ t_cp + t_acc).astype(np.float32)
                R_acc = (R_acc @ R_cp).astype(np.float32)
                k = pk
                guard += 1
            kf = mp.keyframes.get(k)
            if kf is None:
                _, Ra, ta = self.trajectory[i]
                out.append((ts, Ra, ta))
            else:
                out.append((
                    ts,
                    (R_acc @ kf.R).astype(np.float32),
                    (R_acc @ kf.t + t_acc).astype(np.float32),
                ))
        return out

    def _reset_map(self):
        # in-flight pipelined frames belong to the abandoned map; their
        # poses are meaningless now (like frames dropped by a reference
        # reset), so discard rather than confirm
        self._pipe = []
        self.local_mapper.discard_ba()
        self.atlas.create_new_map()
        self._map_traj_start = len(self.trajectory)
        self.init_frame = None
        self.state = TrackState.NO_IMAGES_YET
        self.ref_kf = None
        self.velocity = None
        self._prev_kf_id = -1
        self.last_kf_ts = None
        self.first_kf_ts = None
        self.cur_bias = np.zeros(6, np.float32)

    def _after_map_merge(self, info: dict, frame: Frame):
        """Fixup after an Atlas map merge (reference MergeLocal tail,
        src/LoopClosing.cc:1252 region): the active map changed, the
        welded keyframes got new ids, and everything recorded in the
        dropped map's coordinates must be re-expressed."""
        remap = info["kf_remap"]
        mp = self.atlas.current
        if self.ref_kf is not None:
            self.ref_kf = remap.get(self.ref_kf, info["kf_cur"])
        if self._prev_kf_id >= 0:
            self._prev_kf_id = remap.get(self._prev_kf_id, -1)
        kf = mp.keyframes[info["kf_cur"]]
        frame.R = kf.R.copy()
        frame.t = kf.t.copy()
        frame.kp_mp = kf.kp_mp.copy()
        if frame.v is not None and kf.v is not None:
            frame.v = kf.v.copy()
        Rw, tw, sw = info["world_sim3"]
        for i in range(self._map_traj_start, len(self.trajectory)):
            ts, R, t = self.trajectory[i]
            Rn = (R @ Rw.T).astype(np.float32)
            tn = (sw * t - Rn @ tw).astype(np.float32)
            self.trajectory[i] = (ts, Rn, tn)
        self._map_traj_start = 0
        # relative trajectory: rewrite entries of the dropped map onto
        # the welded keyframe ids (scale rides on the keyframe poses;
        # the frame-to-keyframe relative translation scales by sw)
        dropped_mid = info["dropped_mid"]
        kept_mid = mp.mid
        dead_remap = info.get("dead_remap", {})
        for i, (ts, mid, k, R_rel, t_rel) in enumerate(self.traj_rel):
            if mid != dropped_mid:
                continue
            nk = remap.get(k, dead_remap.get(k, -1)) if k >= 0 else -1
            if nk >= 0:
                self.traj_rel[i] = (
                    ts, kept_mid, nk, R_rel,
                    (sw * t_rel).astype(np.float32),
                )
            elif k < 0:
                # absolute entry: re-express through the world Sim3
                Rn = (R_rel @ Rw.T).astype(np.float32)
                tn = (sw * t_rel - Rn @ tw).astype(np.float32)
                self.traj_rel[i] = (ts, kept_mid, -1, Rn, tn)
            else:
                # reference keyframe unknown to both remaps (should not
                # happen: culls always leave tombstones) — fall back to
                # the already-corrected absolute trajectory entry
                _, Ra, ta = self.trajectory[i]
                self.traj_rel[i] = (
                    ts, kept_mid, -1, Ra.copy(), ta.copy()
                )

    def _promote(self, f: Frame, mp: SLAMMap) -> KeyFrame:
        kf = KeyFrame(
            kid=-1, frame_id=f.frame_id, timestamp=f.timestamp,
            R=f.R.copy(), t=f.t.copy(), feats=f.feats,
            xy_un=f.xy_un, octave=f.octave, angle=f.angle,
            desc=f.desc, valid=f.valid, kp_mp=f.kp_mp.copy(),
            ur=None if f.ur is None else f.ur.copy(),
            depth=None if f.depth is None else f.depth.copy(),
        )
        mp.add_keyframe(kf)
        # share the association array so frame/keyframe stay consistent;
        # mapping/loop-closing mutate it on host, so the device copy of
        # the associations is stale from here on
        f.kp_mp = kf.kp_mp
        f.kp_mp_dirty = True
        return kf

    # ----------------------------------------------------------- tracking

    def _imu_ready(self, frame: Frame) -> bool:
        return (
            self.inertial
            and self.atlas.current.imu_initialized
            and self.last_frame is not None
            and self.last_frame.v is not None
            and frame.preint_frame is not None
        )

    def _track_frame(self, frame: Frame) -> bool:
        mp = self.atlas.current
        if self.last_frame is not None:
            # the fused fast path leaves frames device-resident; the
            # legacy matchers need the host copies
            self.last_frame.ensure_host()
        ok = False
        if (self.velocity is not None or self._imu_ready(frame)) \
                and self.last_frame is not None:
            ok = self._track_with_motion_model(frame)
        if not ok and self.last_frame is not None:
            ok = self._track_reference_keyframe(frame)
        if not ok:
            self.velocity = None
            return False

        ok = self._track_local_map(frame)
        if not ok:
            self.velocity = None
            return False

        # motion model (reference: mVelocity = Tcw * Twl)
        lR, lt = self.last_frame.R, self.last_frame.t
        if lR is not None:
            Rv = frame.R @ lR.T
            tv_ = frame.t - Rv @ lt
            self.velocity = (Rv, tv_)
            self._prev_pose = (frame.frame_id, lR.copy(), lt.copy())

        if self._need_new_keyframe(frame):
            self._create_keyframe(frame)
        return True

    def _predict_pose(self):
        Rv, tv_ = self.velocity
        lR, lt = self.last_frame.R, self.last_frame.t
        return (Rv @ lR).astype(np.float32), (Rv @ lt + tv_).astype(np.float32)

    def _matched_point_arrays(self, frame: Frame, pad: int):
        """Gather (mp_id, kp_idx) pairs of current associations."""
        idx = np.where(frame.kp_mp >= 0)[0]
        return idx

    def _track_with_motion_model(self, frame: Frame) -> bool:
        """Reference TrackWithMotionModel (Tracking.cc:2437)."""
        mp = self.atlas.current
        last = self.last_frame
        if self._imu_ready(frame):
            # PredictStateIMU (reference Tracking.cc:1230)
            Rwb1, twb1 = self.imu_calib.body_from_cam(last.R, last.t)
            Rwb2, twb2, v2 = imu_frontend.predict_state(
                Rwb1, twb1, last.v, self.cur_bias, frame.preint_frame
            )
            R, t = self.imu_calib.cam_from_body(Rwb2, twb2)
            frame.v = v2
            frame.bg = self.cur_bias[:3].copy()
            frame.ba = self.cur_bias[3:].copy()
        else:
            R, t = self._predict_pose()
        frame.R, frame.t = R, t

        lm_idx = np.where(last.kp_mp >= 0)[0]
        if len(lm_idx) < 10:
            return False
        M = 2048
        lm_idx = lm_idx[:M]
        mp_ids = last.kp_mp[lm_idx]
        mp_pos = np.zeros((M, 3), np.float32)
        mp_desc = np.zeros((M, 32), np.uint8)
        mp_oct = np.zeros((M,), np.int32)
        mp_ang = np.zeros((M,), np.float32)
        mp_val = np.zeros((M,), bool)
        k = len(lm_idx)
        mp_pos[:k] = mp.mp_pos[mp_ids]
        mp_desc[:k] = last.desc[lm_idx]   # reference matches vs LAST FRAME desc
        mp_oct[:k] = last.octave[lm_idx]
        mp_ang[:k] = last.angle[lm_idx]
        mp_val[:k] = mp.mp_valid[mp_ids]

        def run(th):
            return np.asarray(
                fm.search_by_projection_last_frame(
                    jnp.asarray(mp_pos), jnp.asarray(mp_desc),
                    jnp.asarray(mp_val), jnp.asarray(mp_oct),
                    jnp.asarray(mp_ang),
                    jnp.asarray(R), jnp.asarray(t),
                    jnp.asarray(frame.xy_un), frame.feats.desc,
                    frame.feats.octave, frame.feats.angle, frame.feats.valid,
                    self.project, self.scale_factors, self.img_wh, th,
                )
            )

        matches = run(15.0)
        if (matches >= 0).sum() < 20:
            matches = run(30.0)  # reference widens the window
        n = (matches >= 0).sum()
        if n < 20:
            return False

        frame.kp_mp[:] = INVALID
        rows = np.where(matches >= 0)[0]
        frame.kp_mp[matches[rows]] = mp_ids[rows]
        return self._pose_opt(frame, min_inliers=10)

    def _track_reference_keyframe(self, frame: Frame) -> bool:
        """Reference TrackReferenceKeyFrame (Tracking.cc:2308); BoW match
        replaced by a mutual-best descriptor match (place/ vocab lands in
        a later round)."""
        mp = self.atlas.current
        if self.ref_kf is None or self.ref_kf not in mp.keyframes:
            return False
        kf = mp.keyframes[self.ref_kf]
        m12, _ = fm.mutual_best_match(
            frame.feats.desc, frame.feats.valid,
            jnp.asarray(kf.desc), jnp.asarray(kf.valid),
        )
        m12 = np.asarray(m12)
        frame.kp_mp[:] = INVALID
        for i, j in enumerate(m12):
            if j >= 0 and kf.kp_mp[j] >= 0 and mp.mp_valid[kf.kp_mp[j]]:
                frame.kp_mp[i] = kf.kp_mp[j]
        if (frame.kp_mp >= 0).sum() < 15:
            return False
        frame.R = self.last_frame.R.copy() if self.last_frame.R is not None else np.eye(3, dtype=np.float32)
        frame.t = self.last_frame.t.copy() if self.last_frame.t is not None else np.zeros(3, np.float32)
        return self._pose_opt(frame, min_inliers=10)

    def _track_local_map(self, frame: Frame) -> bool:
        """Reference TrackLocalMap (Tracking.cc:2532)."""
        mp = self.atlas.current
        if self.ref_kf is None:
            return False
        if self.ref_kf not in mp.keyframes:  # culled by local mapping
            if not mp.keyframes:
                return False
            self.ref_kf = max(mp.keyframes.keys())
        # local keyframes: ref KF + covisibles (reference UpdateLocalKeyFrames)
        local_kfs = [self.ref_kf] + [
            k for k, _ in mp.covisible_keyframes(self.ref_kf, min_weight=1)[:10]
        ]
        # Device-array cache: between keyframes the map is unchanged
        # (version counter constant), so the padded local-point blocks
        # from the previous frame are reused instead of re-uploading
        # ~0.6 MB over the device link every frame.
        cache_key = (mp.mid, mp.version, self.ref_kf)
        cached = getattr(self, "_local_map_cache", None)
        M = 4096
        if cached is not None and cached[0] == cache_key:
            _, pt_ids, d_pos, d_desc, d_norm, d_maxd, base_val = cached
            k = len(pt_ids)
        else:
            pt_ids = mp.points_seen_by(local_kfs)
            if len(pt_ids) == 0:
                return False
            pt_ids = pt_ids[:M]
            k = len(pt_ids)
            mp_pos = np.zeros((M, 3), np.float32)
            mp_desc = np.zeros((M, 32), np.uint8)
            mp_norm = np.zeros((M, 3), np.float32)
            mp_maxd = np.ones((M,), np.float32)
            base_val = np.zeros((M,), bool)
            mp_pos[:k] = mp.mp_pos[pt_ids]
            mp_desc[:k] = mp.mp_desc[pt_ids]
            mp_norm[:k] = mp.mp_normal[pt_ids]
            mp_maxd[:k] = mp.mp_max_dist[pt_ids]
            base_val[:k] = mp.mp_valid[pt_ids]
            d_pos = jnp.asarray(mp_pos)
            d_desc = jnp.asarray(mp_desc)
            d_norm = jnp.asarray(mp_norm)
            d_maxd = jnp.asarray(mp_maxd)
            self._local_map_cache = (
                cache_key, pt_ids, d_pos, d_desc, d_norm, d_maxd, base_val,
            )
        if len(pt_ids) == 0:
            return False
        # points already matched in the frame are not searched again
        mp_val = base_val.copy()
        already = np.isin(pt_ids, frame.kp_mp[frame.kp_mp >= 0])
        mp_val[:k] &= ~already

        kp_free = frame.valid & (frame.kp_mp < 0)
        matches = np.asarray(
            fm.search_by_projection_local_map(
                d_pos, d_desc, jnp.asarray(mp_val),
                d_norm, d_maxd,
                jnp.asarray(frame.R), jnp.asarray(frame.t),
                jnp.asarray(frame.xy_un), frame.feats.desc,
                frame.feats.octave, jnp.asarray(kp_free), None,
                self.project, self.scale_factors, self.img_wh,
            )
        )
        rows = np.where(matches >= 0)[0]
        frame.kp_mp[matches[rows]] = pt_ids[rows]
        mp.mp_visible[pt_ids[: k][mp_val[:k]]] += 1

        if self._imu_ready(frame) and self.state == TrackState.OK:
            # PoseInertialOptimizationLastFrame (reference
            # Optimizer.cc:7722); the IMU factor keeps tracking stable
            # with fewer visual inliers (reference threshold 15).  Only
            # when the previous frame tracked normally: after a
            # relocalization / RECENTLY_LOST stretch the previous
            # frame's state is IMU-dead-reckoned and an inertial edge
            # to it would drag the solution off the map (the reference
            # re-anchors on the keyframe after map updates for the same
            # reason, Tracking.cc mbMapUpdated branch).
            ok = self._pose_opt_inertial(frame, min_inliers=15)
        else:
            ok = self._pose_opt(frame, min_inliers=30)
        if ok:
            found = frame.kp_mp[frame.kp_mp >= 0]
            mp.mp_found[found] += 1
        return ok

    def _pose_opt_inertial(self, frame: Frame, min_inliers: int) -> bool:
        """Visual-inertial tracking-time state optimisation (reference
        PoseInertialOptimizationLastFrame, src/Optimizer.cc:7722): the
        frame's 15-dim body state against visual unary edges + one
        inertial edge to the previous frame's (fixed) state."""
        from ..solver import inertial as sin

        mp = self.atlas.current
        last = self.last_frame
        calib = self.imu_calib
        idx = np.where(frame.kp_mp >= 0)[0]
        if len(idx) < min_inliers:
            return False
        N = 2048
        idx = idx[:N]
        pts = np.zeros((N, 3), np.float32)
        uv = np.zeros((N, 2), np.float32)
        isig = np.ones((N,), np.float32)
        val = np.zeros((N,), bool)
        k = len(idx)
        pts[:k] = mp.mp_pos[frame.kp_mp[idx]]
        uv[:k] = frame.xy_un[idx]
        isig[:k] = np.asarray(self.inv_sigma2, np.float32)[
            np.clip(frame.octave[idx], 0, len(self.inv_sigma2) - 1)
        ]
        val[:k] = True

        Rwb1, twb1 = calib.body_from_cam(last.R, last.t)
        bg1 = last.bg if last.bg is not None else self.cur_bias[:3]
        ba1 = last.ba if last.ba is not None else self.cur_bias[3:]
        prev_state = (
            jnp.asarray(Rwb1), jnp.asarray(twb1), jnp.asarray(last.v),
            jnp.asarray(bg1), jnp.asarray(ba1),
        )
        Rwb0, twb0 = calib.body_from_cam(frame.R, frame.t)
        v0 = frame.v if frame.v is not None else last.v
        # LastFrame vs LastKeyFrame variant (reference Tracking.cc:2554-
        # 2574 chooses by mbMapUpdated): with a fresh marginalization
        # prior on the previous frame and an unchanged map, jointly
        # optimise both frame states with the previous one anchored by
        # its ConstraintPoseImu and produce the next prior by
        # marginalizing it out (solver/marginal.py); after a map update
        # (keyframe/loop/gravity) the previous state is fixed instead
        # and the prior chain restarts from this solve's information.
        mp_ver = (mp.mid, mp.version)
        prior = None
        if (self._marg_prior is not None
                and self._marg_prior[0] == last.frame_id
                and self._marg_prior[1] == mp_ver):
            prior = self._marg_prior[2]
        if prior is not None:
            res = sin.optimize_pose_inertial_last_frame(
                jnp.asarray(Rwb0), jnp.asarray(twb0), jnp.asarray(v0),
                jnp.asarray(bg1), jnp.asarray(ba1),
                prev_state, frame.preint_frame,
                jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(isig),
                jnp.asarray(val),
                jnp.asarray(calib.Rcb), jnp.asarray(calib.tcb),
                self.project, prior=prior,
            )
        else:
            res = sin.optimize_pose_inertial(
                jnp.asarray(Rwb0), jnp.asarray(twb0), jnp.asarray(v0),
                jnp.asarray(bg1), jnp.asarray(ba1),
                prev_state, frame.preint_frame,
                jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(isig),
                jnp.asarray(val),
                jnp.asarray(calib.Rcb), jnp.asarray(calib.tcb),
                self.project,
            )
        Rwb, twb, v_n, bg_n, ba_n, inl, H_marg = jax.device_get(
            (res.Rwb, res.twb, res.v, res.bg, res.ba, res.inliers, res.H)
        )
        # this frame's ConstraintPoseImu for the next call
        self._marg_prior = (
            frame.frame_id, mp_ver,
            (jnp.asarray(H_marg),
             (jnp.asarray(Rwb), jnp.asarray(twb), jnp.asarray(v_n),
              jnp.asarray(bg_n), jnp.asarray(ba_n))),
        )
        frame.R, frame.t = calib.cam_from_body(
            np.asarray(Rwb), np.asarray(twb)
        )
        frame.v = np.asarray(v_n)
        frame.bg = np.asarray(bg_n)
        frame.ba = np.asarray(ba_n)
        self.cur_bias = np.concatenate([frame.bg, frame.ba]).astype(
            np.float32
        )
        inl = np.asarray(inl)[:k]
        frame.kp_mp[idx[~inl]] = INVALID
        return int(inl.sum()) >= min_inliers

    def _pose_opt(self, frame: Frame, min_inliers: int) -> bool:
        """Motion-only BA; drops outlier associations like the reference."""
        mp = self.atlas.current
        idx = np.where(frame.kp_mp >= 0)[0]
        if len(idx) < min_inliers:
            return False
        N = 2048
        idx = idx[:N]
        pts = np.zeros((N, 3), np.float32)
        uv = np.zeros((N, 2), np.float32)
        isig = np.ones((N,), np.float32)
        val = np.zeros((N,), bool)
        k = len(idx)
        pts[:k] = mp.mp_pos[frame.kp_mp[idx]]
        uv[:k] = frame.xy_un[idx]
        isig[:k] = np.asarray(self.inv_sigma2, np.float32)[
            np.clip(frame.octave[idx], 0, len(self.inv_sigma2) - 1)
        ]
        val[:k] = True
        obs_ur = None
        if frame.ur is not None and self.bf > 0:
            # stereo observations: 3-dim residual with virtual right u
            obs_ur_np = np.full((N,), -1.0, np.float32)
            obs_ur_np[:k] = frame.ur[idx]
            obs_ur = jnp.asarray(obs_ur_np)
        res = spo.optimize_pose(
            jnp.asarray(frame.R), jnp.asarray(frame.t),
            jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(isig),
            jnp.asarray(val), self.project,
            bf=self.bf, obs_ur=obs_ur,
        )
        inl, R_new, t_new = jax.device_get((res.inliers, res.R, res.t))
        inl = inl[:k]
        frame.R = np.asarray(R_new)
        frame.t = np.asarray(t_new)
        # drop outlier associations
        frame.kp_mp[idx[~inl]] = INVALID
        return int(inl.sum()) >= min_inliers

    # ---------------------------------------------------------- keyframes

    def _need_new_keyframe(self, frame: Frame,
                           tracked: Optional[int] = None,
                           close_counts: Optional[Tuple[int, int]] = None,
                           ) -> bool:
        """Reference NeedNewKeyFrame (Tracking.cc:2647), mono subset.
        ``tracked`` lets the fused path pass the device-counted inlier
        total so the frame's associations never need a host copy."""
        mp = self.atlas.current
        if tracked is None:
            tracked = int((frame.kp_mp >= 0).sum())
        if self.ref_kf is None or self.ref_kf not in mp.keyframes:
            return False
        ref = mp.keyframes[self.ref_kf]
        # ref_tracked only changes when the map does; cache on the map
        # version so steady-state frames skip the observation-count scan
        rt_key = (mp.mid, mp.version, self.ref_kf)
        if self._ref_tracked_cache is None \
                or self._ref_tracked_cache[0] != rt_key:
            kp = ref.kp_mp
            mids = kp[kp >= 0]
            ref_tracked = int(sum(
                1 for m in mids
                if mp.mp_valid[m] and mp.n_observations(int(m)) >= 3
            ))
            self._ref_tracked_cache = (rt_key, ref_tracked)
        ref_tracked = self._ref_tracked_cache[1]
        # Stereo/RGBD close-point pressure (reference Tracking.cc:2647+:
        # bNeedToInsertClose when <100 tracked close and >70 untracked
        # close points; thRefRatio drops to 0.75).
        need_close = False
        th_ref_ratio = 0.9
        if close_counts is not None:
            # device-counted (fused stereo path): no per-frame depth copy
            tracked_close, untracked_close = close_counts
            need_close = tracked_close < 100 and untracked_close > 70
            th_ref_ratio = 0.75
        elif frame.depth is not None and self.th_depth > 0:
            close = frame.valid & (frame.depth > 0) & (
                frame.depth < self.th_depth
            )
            tracked_close = int((close & (frame.kp_mp >= 0)).sum())
            untracked_close = int((close & (frame.kp_mp < 0)).sum())
            need_close = tracked_close < 100 and untracked_close > 70
            th_ref_ratio = 0.75
        c1a = frame.frame_id >= self.last_kf_frame_id + self.cfg.tracking.max_frames
        c1b = frame.frame_id >= self.last_kf_frame_id + self.cfg.tracking.min_frames
        # The weak-tracking trigger (c2) compares this frame's inlier
        # count against the reference keyframe's point set — meaningless
        # for frames dispatched before the last keyframe's deferred
        # triangulation landed (their searches couldn't see the new
        # points), and firing on them cascades keyframes with near-zero
        # baselines.  Suppress c2 until the map the frame saw is fresh
        # (reference analog: SetAcceptKeyFrames(false) while
        # LocalMapping is mid-keyframe, src/LocalMapping.cc:75,264).
        c2_allowed = (
            not self.local_mapper.has_pending_tf()
            and frame.frame_id >= self._pts_fresh_fid
        )
        c2 = c2_allowed and (
            tracked < ref_tracked * th_ref_ratio or need_close
        ) and tracked > 15
        # inertial pre-init: insert keyframes at >=4 Hz so the IMU
        # initialisation window fills quickly (reference Tracking.cc:2647
        # region: ((mSensor == IMU_*) && !initialized && dt >= 0.25))
        if (
            self.inertial
            and not mp.imu_initialized
            and self.last_kf_ts is not None
            and frame.timestamp - self.last_kf_ts >= 0.25
            and tracked > 15
        ):
            return True
        return bool((c1a or (c1b and c2)) and tracked > 15)

    def _attach_inertial(self, kf: KeyFrame, frame: Frame):
        """Store the IMU chain link on a new keyframe (reference
        CreateNewKeyFrame: mpImuPreintegratedFromLastKF, mPrevKF)."""
        if not self.inertial:
            return
        kf.prev_kf = self._prev_kf_id
        if self.last_kf_ts is not None:
            kf.imu_meas = self.imu_queue.raw_window(
                self.last_kf_ts, frame.timestamp
            )
            kf.preint = frame.preint_kf or (
                None if kf.imu_meas is None
                else imu_frontend.integrate_raw_host(
                    kf.imu_meas, self.cur_bias, self.imu_calib
                )
            )
        kf.bg = self.cur_bias[:3].copy()
        kf.ba = self.cur_bias[3:].copy()
        kf.v = None if frame.v is None else frame.v.copy()
        self._prev_kf_id = kf.kid
        self.last_kf_ts = frame.timestamp
        if self.first_kf_ts is None:
            self.first_kf_ts = frame.timestamp
        # keep only the measurements still needed (next KF preint)
        self.imu_queue.drop_before(frame.timestamp - 0.01)

    def _imu_init_stage(self, frame: Frame):
        """Staged inertial initialisation (reference LocalMapping.cc
        :162-219: InitializeIMU(1e2,1e10) -> VIBA1 (1.f,1e5) at 5s ->
        VIBA2 (0,0) at 15s)."""
        mp = self.atlas.current
        if not self.inertial or self.first_kf_ts is None:
            return
        elapsed = frame.timestamp - self.first_kf_ts
        mono = "stereo" not in self.sensor and "rgbd" not in self.sensor
        fix_scale = not mono
        done = False
        if not mp.imu_initialized:
            if elapsed >= (2.0 if mono else 1.0) and \
                    len(mp.keyframes) >= 10:
                done = imu_frontend.initialize_imu(
                    mp, self.imu_calib, self.project,
                    prior_g=1e2, prior_a=1e10, fix_scale=fix_scale,
                )
        elif not mp.imu_ba1 and elapsed >= 5.0:
            done = imu_frontend.initialize_imu(
                mp, self.imu_calib, self.project,
                prior_g=1.0, prior_a=1e5, fix_scale=fix_scale,
            )
            mp.imu_ba1 = True
        elif mp.imu_ba1 and not mp.imu_ba2 and elapsed >= 15.0:
            done = imu_frontend.initialize_imu(
                mp, self.imu_calib, self.project,
                prior_g=0.0, prior_a=0.0, fix_scale=fix_scale,
            )
            mp.imu_ba2 = True
        if done:
            # map was rotated/rescaled under us: refresh the frame state
            # from its keyframe and drop the visual motion model (and
            # any in-flight async window BA, now stale)
            self.local_mapper.discard_ba()
            # re-express recorded trajectory segments of this map in the
            # new world frame (reference Tracking::UpdateFrameIMU
            # rescales mlRelativeFramePoses on scale change)
            Ryw, s_up = done
            for i, (ts_i, mid, kk, R_rel, t_rel) in enumerate(self.traj_rel):
                if mid != mp.mid:
                    continue
                if kk >= 0:
                    self.traj_rel[i] = (
                        ts_i, mid, kk, R_rel,
                        (s_up * t_rel).astype(np.float32),
                    )
                else:
                    self.traj_rel[i] = (
                        ts_i, mid, kk,
                        (R_rel @ Ryw.T).astype(np.float32),
                        (s_up * t_rel).astype(np.float32),
                    )
            for i in range(self._map_traj_start, len(self.trajectory)):
                ts_i, R_i, t_i = self.trajectory[i]
                self.trajectory[i] = (
                    ts_i, (R_i @ Ryw.T).astype(np.float32),
                    (s_up * t_i).astype(np.float32),
                )
            kf = mp.keyframes[self._prev_kf_id]
            frame.R, frame.t = kf.R.copy(), kf.t.copy()
            frame.v = None if kf.v is None else kf.v.copy()
            frame.bg, frame.ba = kf.bg.copy(), kf.ba.copy()
            self.cur_bias = np.concatenate([kf.bg, kf.ba]).astype(
                np.float32
            )
            self.velocity = None
        return bool(done)

    def _create_keyframe(self, frame: Frame):
        mp = self.atlas.current
        frame.ensure_host()
        kf = self._promote(frame, mp)
        self._attach_inertial(kf, frame)
        touched = []
        for kp in np.where(kf.kp_mp >= 0)[0]:
            mid = int(kf.kp_mp[kp])
            if mp.mp_valid[mid]:
                mp.add_observation(mid, kf.kid, int(kp))
                touched.append(mid)
            else:
                kf.kp_mp[kp] = INVALID
        mp.update_point_stats_batch(touched)
        # Stereo/RGBD: unproject close unmatched keypoints into new map
        # points, nearest first, until 100 created or depth > thDepth
        # (reference CreateNewKeyFrame, Tracking.cc:2907 region).
        if frame.depth is not None and self.th_depth > 0:
            free = np.where(frame.valid & (frame.depth > 0)
                            & (kf.kp_mp < 0))[0]
            order = free[np.argsort(frame.depth[free])]
            fx, fy = self.K[0, 0], self.K[1, 1]
            cx, cy = self.K[0, 2], self.K[1, 2]
            Rcw, tcw = kf.R, kf.t
            n_created = 0
            touched = []
            for i in order:
                z = float(frame.depth[i])
                if n_created >= 100 and z > self.th_depth:
                    break
                if self.th_far_points > 0 and z > self.th_far_points:
                    break  # depth-sorted: everything after is farther
                if frame.p3d_stereo is not None:
                    pc = frame.p3d_stereo[i].astype(np.float32)
                else:
                    u, v = frame.xy_un[i]
                    pc = np.array(
                        [(u - cx) * z / fx, (v - cy) * z / fy, z], np.float32
                    )
                pos = Rcw.T @ (pc - tcw)
                mid = mp.add_point(pos, frame.desc[i],
                                   np.zeros(3, np.float32), 1.0, kf.kid)
                mp.add_observation(mid, kf.kid, int(i))
                touched.append(mid)
                kf.kp_mp[i] = mid
                n_created += 1
            mp.update_point_stats_batch(touched)
        self.ref_kf = kf.kid
        self.last_kf_frame_id = frame.frame_id
        # synchronous local mapping step (bounded work budget); in
        # pipelined mode the triangulation/fuse FETCH is deferred to the
        # next confirmation round trip (reference LocalMapping queue
        # latency) — synchronous mode keeps the same-event apply so
        # keyframe decisions always see a fresh map
        defer = (
            self.cfg.tracking.pipeline_depth > 0
            and not self.inertial
            and self.cfg.orb.octree == "device"
            and (self.sensor == "monocular"
                 or (self.sensor == "stereo" and self.cam_r is None)
                 or self.sensor == "rgbd")
        )
        self.local_mapper.process_keyframe(mp, kf.kid, defer_fetch=defer)
        # staged IMU initialisation / refinement; a fired stage
        # rotated/rescaled the map under any in-flight pipelined frames
        self._vi_stage_fired = self._imu_init_stage(frame)
        # loop closing (enabled when a vocabulary was provided)
        lc = self.loop_closer.process_keyframe(mp, kf.kid, atlas=self.atlas)
        if lc:
            # poses/points moved under us: drop the motion model and
            # refresh the frame pose from the corrected keyframe; any
            # in-flight async window BA is now stale
            self.local_mapper.discard_ba()
            self.velocity = None
            if isinstance(lc, dict) and lc.get("type") == "merge":
                self._after_map_merge(lc, frame)
            else:
                frame.R = mp.keyframes[kf.kid].R.copy()
                frame.t = mp.keyframes[kf.kid].t.copy()
