"""Inertial frontend: IMU queue, per-frame preintegration, state
prediction, and the staged IMU initialisation.

Replaces the reference's inertial tracking plumbing
(Tracking::GrabImuData src/Tracking.cc:1111, PreintegrateIMU :1117,
PredictStateIMU :1230) and LocalMapping's staged initialisation
(InitializeIMU src/LocalMapping.cc:1213, ScaleRefinement :1396, and the
VIBA1/VIBA2 schedule :162-219).

Design: measurements accumulate in a host ring; preintegration runs
as one jit lax.scan over a padded window (bucketed lengths so programs
are reused), producing the Preintegrated pytree the solvers consume
directly.  The initialisation solves gravity/scale/bias with
solver.inertial.inertial_only (EdgeInertialGS analog) and refines with
the matrix-free visual-inertial BA.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..imu import preintegration as pre
from ..imu.calib import ImuCalib
from ..solver import inertial as sin

GRAVITY = 9.81

_BUCKETS = (32, 64, 128, 256, 512, 1024, 2048, 4096)


def _bucket(n: int) -> int:
    for b in _BUCKETS:
        if n <= b:
            return b
    return ((n + 4095) // 4096) * 4096


@functools.partial(jax.jit, static_argnums=(5, 6, 7, 8))
def _integrate_jit(gyro, acc, dts, valid, bias,
                   ng: float, na: float, wg: float, wa: float):
    return pre.integrate(gyro, acc, dts, valid, bias, ng, na, wg, wa)


class ImuQueue:
    """Measurement buffer (reference mlQueueImuData, src/Tracking.cc:1111).

    Measurements are (t, acc[3], gyro[3]); `preintegrate(t0, t1, bias)`
    integrates the samples covering (t0, t1] with boundary dt clipping
    like the reference's PreintegrateIMU (src/Tracking.cc:1117)."""

    def __init__(self, calib: ImuCalib):
        self.calib = calib
        self.t: List[float] = []
        self.acc: List[np.ndarray] = []
        self.gyro: List[np.ndarray] = []

    def add(self, t: float, acc, gyro):
        self.t.append(float(t))
        self.acc.append(np.asarray(acc, np.float32))
        self.gyro.append(np.asarray(gyro, np.float32))

    def extend(self, measurements):
        """measurements: iterable of (t, acc(3,), gyro(3,))."""
        for t, a, w in measurements:
            self.add(t, a, w)

    def drop_before(self, t0: float):
        while len(self.t) > 1 and self.t[1] <= t0:
            self.t.pop(0)
            self.acc.pop(0)
            self.gyro.pop(0)

    def snapshot(self):
        """(t, gyro, acc) arrays for checkpointing (slam/checkpoint.py)."""
        return (
            np.asarray(self.t, np.float64),
            np.stack(self.gyro) if self.gyro else np.zeros((0, 3), np.float32),
            np.stack(self.acc) if self.acc else np.zeros((0, 3), np.float32),
        )

    def restore(self, t, gyro, acc):
        self.t = [float(x) for x in t]
        self.gyro = [np.asarray(g, np.float32) for g in gyro]
        self.acc = [np.asarray(a, np.float32) for a in acc]

    def raw_window(self, t0: float, t1: float):
        """Un-padded (gyro, acc, dt) measurement window covering (t0, t1]
        with boundary dt clipping; None when no samples cover it."""
        ts = np.asarray(self.t)
        if len(ts) < 2 or t1 <= t0:
            return None
        # sample intervals [t_i, t_{i+1}) clipped to (t0, t1)
        lo = np.maximum(ts[:-1], t0)
        hi = np.minimum(ts[1:], t1)
        dts = np.maximum(hi - lo, 0.0).astype(np.float32)
        sel = np.where(dts > 1e-9)[0]
        if len(sel) == 0:
            return None
        # midpoint measurement per interval (reference averages the two
        # endpoint samples, ImuTypes-based PreintegrateIMU :1117+40)
        a = np.stack(self.acc)
        w = np.stack(self.gyro)
        gyro = 0.5 * (w[sel] + w[sel + 1])
        acc = 0.5 * (a[sel] + a[sel + 1])
        return (
            gyro.astype(np.float32), acc.astype(np.float32), dts[sel]
        )

    def preintegrate(self, t0: float, t1: float,
                     bias: np.ndarray,
                     host: bool = False) -> Optional[pre.Preintegrated]:
        """Integrate measurements spanning (t0, t1]; returns None when no
        samples cover the interval.  host=True fetches the result pytree
        with one packed round trip (for host-side consumers)."""
        win = self.raw_window(t0, t1)
        if win is None:
            return None
        if host:
            return integrate_raw_host(win, bias, self.calib)
        return integrate_raw(win, bias, self.calib)


def integrate_raw_host(meas, bias, calib: ImuCalib) -> pre.Preintegrated:
    """integrate_raw + ONE packed fetch of the whole result pytree.

    The host-side consumers (legacy tracking, the IMU init stages,
    stack_chain) read every field with np.asarray; each device-array
    field fetched on its own is a separate blocking transfer, and a
    Preintegrated has 11 of them.  The fused tracking path
    keeps the device pytree (integrate_raw) and never fetches."""
    from ..utils.packed_fetch import pack_fetch

    return pack_fetch(integrate_raw(meas, bias, calib))


def integrate_raw(meas, bias, calib: ImuCalib) -> pre.Preintegrated:
    """Pad a raw (gyro, acc, dt) window to a bucketed length and run the
    jit scan."""
    gyro_r, acc_r, dt_r = meas
    n = len(dt_r)
    cap = _bucket(n)
    gyro = np.zeros((cap, 3), np.float32)
    acc = np.zeros((cap, 3), np.float32)
    dt = np.zeros((cap,), np.float32)
    ok = np.zeros((cap,), bool)
    gyro[:n] = gyro_r
    acc[:n] = acc_r
    dt[:n] = dt_r
    ok[:n] = True
    return _integrate_jit(
        jnp.asarray(gyro), jnp.asarray(acc), jnp.asarray(dt),
        jnp.asarray(ok), jnp.asarray(bias, dtype=jnp.float32),
        calib.noise_gyro, calib.noise_acc, calib.walk_gyro, calib.walk_acc,
    )


def merge_measurements(a, b):
    """Concatenate two raw measurement windows (reference
    Preintegrated::MergePrevious, src/ImuTypes.cc:312, which re-runs
    integration over the joined measurement list)."""
    if a is None:
        return b
    if b is None:
        return a
    return (
        np.concatenate([a[0], b[0]], 0),
        np.concatenate([a[1], b[1]], 0),
        np.concatenate([a[2], b[2]], 0),
    )


def predict_state(Rwb1, twb1, v1, bias, preint: pre.Preintegrated):
    """Reference Tracking::PredictStateIMU (src/Tracking.cc:1230):
    propagate the body state through a preintegrated delta under
    gravity."""
    from ..utils.packed_fetch import pack_fetch

    g = np.array([0.0, 0.0, -GRAVITY], np.float32)
    b = jnp.asarray(bias, dtype=jnp.float32)
    dt = float(preint.dT)
    # one packed fetch for all three bias-corrected deltas (three
    # separate np.asarray calls are three blocking transfers)
    dR, dV, dP = pack_fetch((
        pre.delta_rotation(preint, b),
        pre.delta_velocity(preint, b),
        pre.delta_position(preint, b),
    ))
    Rwb2 = Rwb1 @ dR
    v2 = v1 + g * dt + Rwb1 @ dV
    twb2 = twb1 + v1 * dt + 0.5 * g * dt * dt + Rwb1 @ dP
    # re-orthonormalise (float32 drift)
    u, _, vt = np.linalg.svd(Rwb2)
    Rwb2 = (u @ vt).astype(np.float32)
    return Rwb2, twb2.astype(np.float32), v2.astype(np.float32)


def _temporal_chain(mp, calib: ImuCalib):
    """Sorted keyframes with body poses and stacked preintegrations.
    Edge k connects KF k-1 -> KF k (first edge invalid)."""
    kids = sorted(mp.keyframes.keys())
    Rwb, twb, preints, valids = [], [], [], []
    for i, kid in enumerate(kids):
        kf = mp.keyframes[kid]
        R, t = calib.body_from_cam(kf.R, kf.t)
        Rwb.append(R)
        twb.append(t)
        if i == 0 or kf.preint is None or kf.prev_kf != kids[i - 1]:
            preints.append(pre.init_preintegrated())
            valids.append(False)
        else:
            preints.append(kf.preint)
            valids.append(True)
    return kids, np.stack(Rwb), np.stack(twb), preints, valids


def initialize_imu(
    mp,
    calib: ImuCalib,
    project=None,
    prior_g: float = 1e2,
    prior_a: float = 1e10,
    fix_scale: bool = False,
    fiba: bool = True,
    min_kfs: int = 10,
) -> bool:
    """Reference LocalMapping::InitializeIMU (src/LocalMapping.cc:1213):

    1. velocities seeded from pose differences over the temporal chain,
    2. inertial-only optimisation (gravity dir, scale, shared bias) with
       poses fixed,
    3. map re-expressed in the gravity frame at metric scale
       (ApplyScaledRotation),
    4. optional full visual-inertial BA with bias priors.

    Returns True when the map was initialised (mp.imu_initialized)."""
    kids, Rwb, twb, preints, valids = _temporal_chain(mp, calib)
    K = len(kids)
    if K < min_kfs or sum(valids) < K - 1:
        return False

    # Scale observability: the accelerometer signal in a position edge
    # grows as 0.5*|a|*dT^2 while the visual pose noise is constant, so
    # short (~0.25 s) keyframe edges ATTENUATE the estimated scale
    # (classical errors-in-variables shrinkage: s_hat ~ s *
    # signal^2/(signal^2+noise^2)).  Re-chain the init solve over
    # merged edges of >= min_edge_dt seconds: the raw measurement
    # windows stored per keyframe (kf.imu_meas) concatenate exactly.
    min_edge_dt = 0.8
    kts = [mp.keyframes[k].timestamp for k in kids]
    sel = [0]
    for i in range(1, K):
        if kts[i] - kts[sel[-1]] >= min_edge_dt or i == K - 1:
            sel.append(i)
    if len(sel) >= 4:
        sub_preints = [pre.init_preintegrated()]
        sub_valids = [False]
        ok_chain = True
        for a, b in zip(sel[:-1], sel[1:]):
            meas = None
            for i in range(a + 1, b + 1):
                m = mp.keyframes[kids[i]].imu_meas
                if m is None:
                    ok_chain = False
                    break
                meas = merge_measurements(meas, m)
            if not ok_chain:
                break
            sub_preints.append(integrate_raw_host(
                meas, np.zeros(6, np.float32), calib
            ))
            sub_valids.append(True)
        if ok_chain:
            kids_full, Rwb_full, twb_full = kids, Rwb, twb
            kids = [kids[i] for i in sel]
            Rwb = Rwb[sel]
            twb = twb[sel]
            preints, valids = sub_preints, sub_valids
            K = len(kids)

    # seed velocities: finite differences of body centers (reference
    # LocalMapping.cc:1213+40: (pose_j - pose_i)/dt)
    dTs = np.asarray([float(p.dT) for p in preints])
    v0 = np.zeros((K, 3), np.float32)
    for k in range(1, K):
        if dTs[k] > 1e-6:
            v0[k] = (twb[k] - twb[k - 1]) / dTs[k]
    v0[0] = v0[1]

    # gravity-direction seed from the preintegrated velocity deltas
    # (reference LocalMapping.cc:1258: dirG = -sum Rwb_i * dV_i): for
    # slow motion  sum Rwb_i dV_i ~ -g * total_dT, so rotate the
    # solver's nominal -z gravity onto the measured direction before
    # optimising (a cold 2-DoF start ~90 deg away collapses the scale).
    dirG = np.zeros(3)
    for k in range(1, K):
        if valids[k]:
            dirG += Rwb[k - 1] @ np.asarray(preints[k].dV)
    nG = np.linalg.norm(dirG)
    Rwg0 = np.eye(3, dtype=np.float32)
    if nG > 1e-6:
        d = dirG / nG                      # ~ -g direction
        z = np.array([0.0, 0.0, 1.0])      # solver's g0 is -G * z
        ax = np.cross(z, d)
        na = np.linalg.norm(ax)
        if na > 1e-8:
            ang = float(np.arctan2(na, float(z @ d)))
            Rwg0 = np.asarray(jax.device_get(pre.lie.so3_exp(
                jnp.asarray(ax / na * ang, jnp.float32)
            )))

    chain = sin.stack_chain(preints, valids)
    res = sin.inertial_only(
        jnp.asarray(Rwb), jnp.asarray(twb), chain,
        jnp.asarray(v0), jnp.zeros(6, jnp.float32),
        prior_g=prior_g, prior_a=prior_a, fix_scale=fix_scale,
        Rwg0=jnp.asarray(Rwg0),
    )
    s = float(res.scale)
    # reference InitializeIMU rejects mScale < 0.1 for monocular
    # (LocalMapping.cc:1213 region): a collapsed scale means the
    # fixed-pose solve failed (weak excitation / noisy visual poses);
    # retry at the next keyframe instead of corrupting the map
    if not np.isfinite(s) or s < 1e-1:
        return False
    bg = np.asarray(res.bg)
    ba = np.asarray(res.ba)
    v = np.asarray(res.v)
    Rwg = np.asarray(res.Rwg)

    # re-express the map in the gravity frame: p_y = s * Rwg^T @ p_w
    Ryw = Rwg.T
    s_applied = s if not fix_scale else 1.0
    mp.apply_scaled_rotation(Ryw, s_applied)
    for k, kid in enumerate(kids):
        kf = mp.keyframes[kid]
        kf.v = (s * (Ryw @ v[k])).astype(np.float32) if not fix_scale \
            else (Ryw @ v[k]).astype(np.float32)
        kf.bg = bg.copy()
        kf.ba = ba.copy()
    # keyframes not part of the (possibly subsampled) init chain:
    # velocity from finite differences of the now-metric poses
    solved = set(kids)
    all_kids = sorted(mp.keyframes.keys())
    for i, kid in enumerate(all_kids):
        kf = mp.keyframes[kid]
        if kid in solved:
            continue
        if i > 0:
            pa = mp.keyframes[all_kids[i - 1]]
            dt = kf.timestamp - pa.timestamp
            if dt > 1e-6:
                Ra, ta = calib.body_from_cam(pa.R, pa.t)
                Rb, tb = calib.body_from_cam(kf.R, kf.t)
                kf.v = ((tb - ta) / dt).astype(np.float32)
        if kf.v is None:
            kf.v = np.zeros(3, np.float32)
        kf.bg = bg.copy()
        kf.ba = ba.copy()
    mp.imu_initialized = True

    if fiba and project is not None:
        # the reference's init-time FullInertialBA runs to convergence
        # (100-200 g2o iterations); a short budget leaves the map scale
        # and velocities inconsistent with the metric preintegrations,
        # which then breaks every subsequent VI tracking step
        full_inertial_ba(mp, calib, project,
                         prior_g=prior_g, prior_a=prior_a, n_iters=25)
    # truthy result carrying the applied world update so the tracker
    # can re-express recorded trajectory segments (reference
    # Tracking::UpdateFrameIMU rescales mlRelativeFramePoses)
    return (Ryw, s_applied)


def full_inertial_ba(mp, calib: ImuCalib, project,
                     prior_g: float = 1.0,
                     prior_a: float = 1e5, n_iters: int = 8,
                     cg_iters: int = 40, mesh=None):
    """FullInertialBA analog (reference src/Optimizer.cc:420): joint
    visual-inertial BA over the whole temporal chain, first pose+bias
    anchored by priors.

    With a multi-device ``mesh`` the visual residuals/landmarks shard
    over the devices (dist/sharded_ba.optimize_vi_sharded) while the
    O(K) inertial chain stays replicated — the post-loop inertial GBA
    gets the same no-size-gate treatment as the visual one."""
    kids, Rwb, twb, preints, valids = _temporal_chain(mp, calib)
    K = len(kids)
    if K < 3:
        return
    v = np.zeros((K, 3), np.float32)
    bg = np.zeros((K, 3), np.float32)
    ba = np.zeros((K, 3), np.float32)
    for k, kid in enumerate(kids):
        kf = mp.keyframes[kid]
        if kf.v is not None:
            v[k] = kf.v
        if kf.bg is not None:
            bg[k] = kf.bg
            ba[k] = kf.ba

    # observation COO over valid points
    pt_ids = np.where(mp.mp_valid[: mp._next_mp])[0]
    if len(pt_ids) == 0:
        return
    remap = {int(p): i for i, p in enumerate(pt_ids)}
    kf_of = {kid: k for k, kid in enumerate(kids)}
    obs_kf, obs_mp, obs_uv, obs_sig = [], [], [], []
    for p in pt_ids:
        for kid, kp in mp.obs.get(int(p), {}).items():
            kf = mp.keyframes.get(kid)
            if kf is None:
                continue
            obs_kf.append(kf_of[kid])
            obs_mp.append(remap[int(p)])
            obs_uv.append(kf.xy_un[kp])
            obs_sig.append(1.0 / (1.2 ** (2 * int(kf.octave[kp]))))
    O = _bucket(max(len(obs_kf), 1))
    pad = O - len(obs_kf)
    obs_kf = np.asarray(obs_kf + [0] * pad, np.int32)
    obs_mp = np.asarray(obs_mp + [0] * pad, np.int32)
    obs_uv = np.concatenate(
        [np.asarray(obs_uv, np.float32).reshape(-1, 2),
         np.zeros((pad, 2), np.float32)], 0
    )
    obs_sig = np.asarray(obs_sig + [1.0] * pad, np.float32)
    obs_val = np.concatenate(
        [np.ones(O - pad, bool), np.zeros(pad, bool)]
    )

    P = _bucket(len(pt_ids))
    pts = np.zeros((P, 3), np.float32)
    pts[: len(pt_ids)] = mp.mp_pos[pt_ids]
    fixed_mp = np.ones(P, bool)
    fixed_mp[: len(pt_ids)] = False
    fixed_kf = np.zeros(K, bool)
    fixed_kf[0] = True

    chain = sin.stack_chain(preints, valids)
    prob = sin.VIBAProblem(
        Rwb=jnp.asarray(Rwb), twb=jnp.asarray(twb),
        v=jnp.asarray(v), bg=jnp.asarray(bg), ba=jnp.asarray(ba),
        points=jnp.asarray(pts),
        obs_kf=jnp.asarray(obs_kf), obs_mp=jnp.asarray(obs_mp),
        obs_uv=jnp.asarray(obs_uv), inv_sigma2=jnp.asarray(obs_sig),
        obs_valid=jnp.asarray(obs_val),
        chain=chain,
        fixed_kf=jnp.asarray(fixed_kf), fixed_mp=jnp.asarray(fixed_mp),
        Rcb=jnp.asarray(calib.Rcb), tcb=jnp.asarray(calib.tcb),
        prior_g=prior_g, prior_a=prior_a,
    )
    import numpy as _np

    n_dev = 1
    if mesh is not None:
        n_dev = int(_np.prod(list(mesh.shape.values())))
    if n_dev > 1:
        from ..dist import sharded_ba as dba

        # points already bucket-padded; pad up to mesh divisibility and
        # regroup the observations by their point's shard
        P_pad = -(-P // n_dev) * n_dev
        if P_pad != P:
            pts2 = _np.zeros((P_pad, 3), _np.float32)
            pts2[:, 2] = 1.0
            pts2[:P] = _np.asarray(prob.points)
            fmp2 = _np.ones(P_pad, bool)
            fmp2[:P] = _np.asarray(prob.fixed_mp)
        else:
            pts2 = _np.asarray(prob.points)
            fmp2 = _np.asarray(prob.fixed_mp)
        okf, omp, ouv, osig, oval = dba.relayout_point_sharded(
            _np.asarray(prob.obs_kf), _np.asarray(prob.obs_mp),
            _np.asarray(prob.obs_uv), _np.asarray(prob.inv_sigma2),
            _np.asarray(prob.obs_valid), P_pad, n_dev,
        )
        prob = sin.VIBAProblem(
            Rwb=prob.Rwb, twb=prob.twb, v=prob.v, bg=prob.bg, ba=prob.ba,
            points=jnp.asarray(pts2),
            obs_kf=jnp.asarray(okf), obs_mp=jnp.asarray(omp),
            obs_uv=jnp.asarray(ouv), inv_sigma2=jnp.asarray(osig),
            obs_valid=jnp.asarray(oval), chain=prob.chain,
            fixed_kf=prob.fixed_kf, fixed_mp=jnp.asarray(fmp2),
            Rcb=prob.Rcb, tcb=prob.tcb,
            prior_g=prob.prior_g, prior_a=prob.prior_a,
        )
        res = dba.optimize_vi_sharded(
            mesh, prob, project, n_iters=n_iters, cg_iters=cg_iters,
        )
    else:
        res = sin.optimize_vi_ba(prob, project, n_iters=n_iters,
                                 cg_iters=cg_iters)
    Rwb_n = np.asarray(res.Rwb)
    twb_n = np.asarray(res.twb)
    v_n = np.asarray(res.v)
    bg_n = np.asarray(res.bg)
    ba_n = np.asarray(res.ba)
    for k, kid in enumerate(kids):
        kf = mp.keyframes[kid]
        kf.R, kf.t = calib.cam_from_body(Rwb_n[k], twb_n[k])
        kf.v = v_n[k]
        kf.bg = bg_n[k]
        kf.ba = ba_n[k]
    mp.mp_pos[pt_ids] = np.asarray(res.points)[: len(pt_ids)]
    mp.version += 1


def local_inertial_ba(mp, calib: ImuCalib, project, kf_id: int,
                      n_window: int = 10, max_fixed: int = 20,
                      n_iters: int = 6, cg_iters: int = 40):
    """LocalInertialBA analog (reference src/Optimizer.cc:4413): sliding
    temporal window of Nd keyframes over the mPrevKF chain ending at the
    new keyframe, with visual + preintegration + bias-random-walk edges.
    The window's temporal predecessor is included FIXED (its pose,
    velocity and biases anchor the window); other keyframes observing
    the window's points are appended as fixed visual-only anchors
    (reference lFixedKeyFrames).

    Reference uses Nd=10, or 25 when tracking is strong (bLarge) — pass
    n_window accordingly.
    """
    # temporal window via the prev_kf chain (reference :4413+6-13)
    window: List[int] = []
    k = kf_id
    while k in mp.keyframes and len(window) < n_window:
        window.append(k)
        k = mp.keyframes[k].prev_kf
    window.reverse()  # temporal ascending
    if len(window) < 3:
        return False
    boundary = mp.keyframes[window[0]].prev_kf
    kids = ([boundary] if boundary in mp.keyframes else []) + window
    n_anchor = 1 if boundary in mp.keyframes else 0

    # fixed visual anchors: other observers of the window's points
    win_set = set(kids)
    pt_ids = mp.points_seen_by(window)
    obs_count: dict = {}
    for p in pt_ids:
        for kid in mp.obs.get(int(p), {}):
            if kid not in win_set and kid in mp.keyframes:
                obs_count[kid] = obs_count.get(kid, 0) + 1
    anchors = sorted(obs_count, key=lambda kk: -obs_count[kk])[:max_fixed]
    kids = kids + anchors

    K = len(kids)
    Rwb = np.zeros((K, 3, 3), np.float32)
    twb = np.zeros((K, 3), np.float32)
    v = np.zeros((K, 3), np.float32)
    bg = np.zeros((K, 3), np.float32)
    ba = np.zeros((K, 3), np.float32)
    preints, valids = [], []
    for i, kid in enumerate(kids):
        kf = mp.keyframes[kid]
        Rwb[i], twb[i] = calib.body_from_cam(kf.R, kf.t)
        if kf.v is not None:
            v[i] = kf.v
        if kf.bg is not None:
            bg[i] = kf.bg
            ba[i] = kf.ba
        in_chain = (
            0 < i < n_anchor + len(window)
            and kf.preint is not None and kf.prev_kf == kids[i - 1]
        )
        if in_chain:
            preints.append(kf.preint)
            valids.append(True)
        else:
            preints.append(pre.init_preintegrated())
            valids.append(False)

    if len(pt_ids) < 8:
        return False
    remap = {int(p): i for i, p in enumerate(pt_ids)}
    kf_of = {kid: i for i, kid in enumerate(kids)}
    obs_kf, obs_mp, obs_uv, obs_sig = [], [], [], []
    for p in pt_ids:
        for kid, kp in mp.obs.get(int(p), {}).items():
            i = kf_of.get(kid)
            if i is None:
                continue
            kf = mp.keyframes[kid]
            obs_kf.append(i)
            obs_mp.append(remap[int(p)])
            obs_uv.append(kf.xy_un[kp])
            obs_sig.append(1.0 / (1.2 ** (2 * int(kf.octave[kp]))))
    if len(obs_kf) < 16:
        return False
    O = _bucket(len(obs_kf))
    pad = O - len(obs_kf)
    obs_kf = np.asarray(obs_kf + [0] * pad, np.int32)
    obs_mp = np.asarray(obs_mp + [0] * pad, np.int32)
    obs_uv = np.concatenate(
        [np.asarray(obs_uv, np.float32).reshape(-1, 2),
         np.zeros((pad, 2), np.float32)], 0
    )
    obs_sig = np.asarray(obs_sig + [1.0] * pad, np.float32)
    obs_val = np.concatenate([np.ones(O - pad, bool), np.zeros(pad, bool)])

    P = _bucket(len(pt_ids))
    pts = np.zeros((P, 3), np.float32)
    pts[: len(pt_ids)] = mp.mp_pos[pt_ids]
    pts[len(pt_ids):, 2] = 1.0
    fixed_mp = np.ones(P, bool)
    fixed_mp[: len(pt_ids)] = False
    fixed_kf = np.zeros(K, bool)
    if n_anchor:
        fixed_kf[0] = True
    fixed_kf[n_anchor + len(window):] = True  # visual anchors
    if not fixed_kf.any():
        fixed_kf[0] = True  # gauge

    chain = sin.stack_chain(preints, valids)
    prob = sin.VIBAProblem(
        Rwb=jnp.asarray(Rwb), twb=jnp.asarray(twb),
        v=jnp.asarray(v), bg=jnp.asarray(bg), ba=jnp.asarray(ba),
        points=jnp.asarray(pts),
        obs_kf=jnp.asarray(obs_kf), obs_mp=jnp.asarray(obs_mp),
        obs_uv=jnp.asarray(obs_uv), inv_sigma2=jnp.asarray(obs_sig),
        obs_valid=jnp.asarray(obs_val),
        chain=chain,
        fixed_kf=jnp.asarray(fixed_kf), fixed_mp=jnp.asarray(fixed_mp),
        Rcb=jnp.asarray(calib.Rcb), tcb=jnp.asarray(calib.tcb),
        prior_g=0.0, prior_a=0.0,
    )
    res = sin.optimize_vi_ba(prob, project, n_iters=n_iters,
                             cg_iters=cg_iters)
    Rwb_n = np.asarray(res.Rwb)
    twb_n = np.asarray(res.twb)
    v_n = np.asarray(res.v)
    bg_n = np.asarray(res.bg)
    ba_n = np.asarray(res.ba)
    for i, kid in enumerate(kids):
        if fixed_kf[i]:
            continue
        kf = mp.keyframes[kid]
        kf.R, kf.t = calib.cam_from_body(Rwb_n[i], twb_n[i])
        kf.v = v_n[i]
        kf.bg = bg_n[i]
        kf.ba = ba_n[i]
    mp.mp_pos[pt_ids] = np.asarray(res.points)[: len(pt_ids)]
    mp.version += 1
    return True
