"""Local mapping: per-keyframe map growth and refinement.

Replaces LocalMapping (reference: src/LocalMapping.cc:67-276 Run loop,
:341 MapPointCulling, :383 CreateNewMapPoints, :935 KeyFrameCulling) and
the window BA (src/Optimizer.cc:1694 LocalBundleAdjustment).

Runs synchronously after keyframe insertion with a bounded iteration
budget (the replacement for the mbAbortBA/SetAcceptKeyFrames thread
interplay, SURVEY.md §2.7): every step costs a fixed number of jit
calls, so mapping latency is bounded by construction.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Set

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..frontend import matcher as fm
from ..utils.packed_fetch import pack_fetch
from ..geometry import two_view as tv
from ..solver import ba as sba
from .map import INVALID, SLAMMap


def run_ba(
    mp: SLAMMap,
    kf_ids: Sequence[int],
    fixed_ids: Set[int],
    project,
    inv_sigma2: Sequence[float],
    n_iters: int = 10,
    max_points: int = 8192,
    max_obs: int = 32768,
    cg_iters: int = 40,
    async_apply: bool = False,
):
    """Build a BAProblem from a keyframe window and write results back.

    kf_ids: optimised + fixed keyframes (fixed ones listed in fixed_ids).
    Points: all points observed by the non-fixed keyframes.  Outlier
    observations (chi2 > 5.991 after optimisation) are erased from the
    map like the reference's post-BA loop (Optimizer.cc:2190 region).
    """
    kf_ids = [k for k in kf_ids if k in mp.keyframes]
    if len(kf_ids) < 2:
        return
    kf_index = {k: i for i, k in enumerate(kf_ids)}
    opt_ids = [k for k in kf_ids if k not in fixed_ids]

    pt_ids = mp.points_seen_by(opt_ids)[:max_points]
    if len(pt_ids) < 8:
        return

    # vectorized observation gather: iterate keyframes (few dozen), not
    # observations (up to 10^5 python dict hits for a global BA)
    lookup = np.full(len(mp.mp_valid), -1, np.int32)
    lookup[pt_ids] = np.arange(len(pt_ids), dtype=np.int32)
    inv_s = np.asarray(inv_sigma2, np.float32)
    okf_l, omp_l, ouv_l, osig_l = [], [], [], []
    for ki, kf_id in enumerate(kf_ids):
        kf = mp.keyframes[kf_id]
        rows = np.where(kf.kp_mp >= 0)[0]
        pidx = lookup[kf.kp_mp[rows]]
        keep = pidx >= 0
        rows, pidx = rows[keep], pidx[keep]
        okf_l.append(np.full(len(rows), ki, np.int32))
        omp_l.append(pidx.astype(np.int32))
        ouv_l.append(kf.xy_un[rows])
        osig_l.append(inv_s[np.clip(kf.octave[rows], 0, len(inv_s) - 1)])
    obs_kf = np.concatenate(okf_l) if okf_l else np.zeros(0, np.int32)
    obs_mp = np.concatenate(omp_l) if omp_l else np.zeros(0, np.int32)
    obs_uv = (
        np.concatenate(ouv_l, 0) if ouv_l else np.zeros((0, 2), np.float32)
    )
    obs_sig = np.concatenate(osig_l) if osig_l else np.zeros(0, np.float32)
    if len(obs_kf) < 16:
        return
    O = min(len(obs_kf), max_obs)

    K = len(kf_ids)
    P = len(pt_ids)
    Rs = np.stack([mp.keyframes[k].R for k in kf_ids]).astype(np.float32)
    ts = np.stack([mp.keyframes[k].t for k in kf_ids]).astype(np.float32)
    fixed = np.array([k in fixed_ids for k in kf_ids])
    if not fixed.any():
        fixed[0] = True  # gauge

    # Coarse bucket ladders so jit shapes repeat across calls: the
    # fine-grained buckets (K/8, P/1024, O/4096) would produce a new
    # XLA program almost every keyframe, each a multi-second compile.
    def bucket(n, ladder):
        for b in ladder:
            if n <= b:
                return b
        return int(np.ceil(n / ladder[-1]) * ladder[-1])

    Kp = bucket(K, (32, 64, 128, 256))
    # device solve time scales ~linearly with the padded observation
    # count, so a 2x ladder keeps the padding waste bounded at <2x
    Pp = bucket(P, (2048, 4096, 8192, 16384, 32768))
    Op = bucket(O, (8192, 16384, 32768, 65536, 131072))
    Rs_p = np.tile(np.eye(3, dtype=np.float32), (Kp, 1, 1))
    ts_p = np.zeros((Kp, 3), np.float32)
    Rs_p[:K], ts_p[:K] = Rs, ts
    fixed_p = np.ones(Kp, bool)
    fixed_p[:K] = fixed
    pts_p = np.zeros((Pp, 3), np.float32)
    pts_p[:P] = mp.mp_pos[pt_ids]
    pts_p[P:, 2] = 1.0  # keep padded points off the camera plane
    fixed_mp_p = np.ones(Pp, bool)
    fixed_mp_p[:P] = False
    okf = np.zeros(Op, np.int32)
    omp = np.zeros(Op, np.int32)
    ouv = np.zeros((Op, 2), np.float32)
    osig = np.ones(Op, np.float32)
    oval = np.zeros(Op, bool)
    okf[:O] = obs_kf[:O]
    omp[:O] = obs_mp[:O]
    ouv[:O] = obs_uv[:O]
    osig[:O] = obs_sig[:O]
    oval[:O] = True

    prob = sba.BAProblem(
        R=jnp.asarray(Rs_p), t=jnp.asarray(ts_p),
        points=jnp.asarray(pts_p),
        obs_kf=jnp.asarray(okf),
        obs_mp=jnp.asarray(omp),
        obs_uv=jnp.asarray(ouv),
        inv_sigma2=jnp.asarray(osig),
        obs_valid=jnp.asarray(oval),
        fixed_kf=jnp.asarray(fixed_p),
        fixed_mp=jnp.asarray(fixed_mp_p),
    )
    # Deliberately matrix-free CG, not the exact dense-Schur solve: the
    # truncated CG step is an implicit trust region along the window's
    # weakly-observable directions (monocular scale), and switching the
    # engine's window BA to solver="schur_dense" measurably degraded
    # end-to-end ATE (0.009 -> 0.043 on the 40-frame synthetic) for a
    # ~7 ms/solve win.  The dense solver remains available for
    # well-anchored problems.
    res = sba.optimize(prob, project, n_iters=n_iters, cg_iters=cg_iters)
    pending = PendingBA(
        res=res, kf_ids=kf_ids, kf_index=kf_index, fixed=fixed,
        pt_ids=pt_ids, obs_kf=obs_kf, obs_mp=obs_mp, K=K, P=P, O=O,
    )
    if async_apply:
        # JAX dispatch is asynchronous: the LM/PCG solve executes on
        # device while the tracker keeps processing frames (the
        # analog of the reference's concurrent LocalMapping thread);
        # PendingBA.apply() at the next keyframe fetches + writes back.
        return pending
    pending.apply(mp)
    return None


class PendingBA:
    """A dispatched-but-unfetched window BA (see run_ba async_apply)."""

    def __init__(self, res, kf_ids, kf_index, fixed, pt_ids,
                 obs_kf, obs_mp, K, P, O):
        self.res = res
        self.kf_ids = kf_ids
        self.kf_index = kf_index
        self.fixed = fixed
        self.pt_ids = pt_ids
        self.obs_kf = obs_kf
        self.obs_mp = obs_mp
        self.K, self.P, self.O = K, P, O

    def apply(self, mp: SLAMMap):
        res = self.res
        self.apply_fetched(mp, pack_fetch(
            (res.R, res.t, res.points, res.inliers)
        ))

    def apply_fetched(self, mp: SLAMMap, fetched):
        R_all, t_all, pts_out, inl = fetched
        R_out = np.asarray(R_all)[: self.K]
        t_out = np.asarray(t_all)[: self.K]
        for k, i in self.kf_index.items():
            if not self.fixed[i] and k in mp.keyframes:
                mp.keyframes[k].R = R_out[i]
                mp.keyframes[k].t = t_out[i]
        live = mp.mp_valid[self.pt_ids]
        mp.mp_pos[self.pt_ids[live]] = np.asarray(pts_out)[: self.P][live]

        inl = np.asarray(inl)
        for o in np.where(~inl[: self.O])[0]:
            p = int(self.pt_ids[self.obs_mp[o]])
            kf_id = self.kf_ids[self.obs_kf[o]]
            if kf_id in mp.keyframes:
                mp.erase_observation(p, kf_id)
        mp.version += 1


@functools.lru_cache(maxsize=None)
def _triangulation_program(scale_factors, inv_sigma2, B, N):
    """One-program CreateNewMapPoints device stage: vmapped epipolar
    search + DLT triangulation + acceptance checks over B neighbour
    keyframes (reference LocalMapping.cc:383 runs these per neighbour;
    batching removes ~2 dispatches x ~30 ms per neighbour)."""
    sf = jnp.asarray(scale_factors, jnp.float32)
    sigma2 = jnp.asarray([1.0 / s for s in inv_sigma2], jnp.float32)
    n_lvl = len(scale_factors)
    factor = 1.5 * float(scale_factors[1])

    @jax.jit
    def run(desc1, xy1, oct1, free1,
            desc2B, xy2B, oct2B, free2B,
            F12B, P1, P2B, R1, t1, R2B, t2B, O1, O2B, Kvec):
        def per_neighbor(desc2, xy2, oct2, free2, F12, P2, R2, t2, O2):
            m12 = fm.search_for_triangulation(
                desc1, xy1, oct1, free1, desc2, xy2, oct2, free2, F12,
                sigma2,
            )
            j = jnp.clip(m12, 0, N - 1)
            x1, x2 = xy1, xy2[j]
            X = tv.triangulate(P1, P2, x1, x2)
            r1, r2 = X - O1, X - O2
            n1 = jnp.linalg.norm(r1, axis=-1)
            n2 = jnp.linalg.norm(r2, axis=-1)
            cos_par = (r1 * r2).sum(-1) / jnp.maximum(n1 * n2, 1e-12)
            pc1 = X @ R1.T + t1
            pc2 = X @ R2.T + t2
            ok = (m12 >= 0) & (pc1[:, 2] > 0) & (pc2[:, 2] > 0) \
                & (cos_par < 0.9998)
            fx, fy, cx, cy = Kvec[0], Kvec[1], Kvec[2], Kvec[3]
            for pc, x, octv in ((pc1, x1, oct1), (pc2, x2, oct2[j])):
                u = fx * pc[:, 0] / jnp.maximum(pc[:, 2], 1e-9) + cx
                v = fy * pc[:, 1] / jnp.maximum(pc[:, 2], 1e-9) + cy
                s2 = sigma2[jnp.clip(octv, 0, n_lvl - 1)]
                err = (u - x[:, 0]) ** 2 + (v - x[:, 1]) ** 2
                ok &= err <= 5.991 * s2
            ratio_dist = n2 / jnp.maximum(n1, 1e-12)
            ratio_oct = sf[jnp.clip(oct1, 0, n_lvl - 1)] \
                / sf[jnp.clip(oct2[j], 0, n_lvl - 1)]
            ok &= (ratio_dist < ratio_oct * factor) \
                & (ratio_dist * factor > ratio_oct)
            return m12, X, ok

        return jax.vmap(per_neighbor)(
            desc2B, xy2B, oct2B, free2B, F12B, P2B, R2B, t2B, O2B
        )

    return run


def _bucket_b(b: int) -> int:
    """Pad the neighbour/job axis to a coarse ladder: each distinct B is
    a separate XLA program with its own first compile.  Padded batch
    entries are NOT free — each is a full (M, N) search — so a middle
    bucket keeps the common 5-8-job fuse/triangulation events from
    paying the 12-wide program."""
    if b <= 4:
        return 4
    if b <= 8:
        return 8
    return 12


@functools.lru_cache(maxsize=None)
def _fuse_program(project, scale_factors, B, M, N):
    """One-program SearchInNeighbors device stage: vmapped
    search_by_projection over B (point-block, keyframe) jobs (reference
    LocalMapping.cc:729 projects per neighbour; batching removes a
    ~30 ms dispatch per neighbour)."""

    @jax.jit
    def run(mp_posB, mp_descB, mp_valB, mp_normB, mp_maxdB,
            R_B, t_B, xyB, descB, octB, validB):
        def per(mpp, mpd, mpv, mpn, mpm, R, t, xy, dsc, oc, vl):
            return fm.search_by_projection_local_map(
                mpp, mpd, mpv, mpn, mpm, R, t, xy, dsc, oc, vl, None,
                project, scale_factors, (1e9, 1e9), 0.75,
            )

        return jax.vmap(per)(
            mp_posB, mp_descB, mp_valB, mp_normB, mp_maxdB,
            R_B, t_B, xyB, descB, octB, validB,
        )

    return run


class LocalMapper:
    def __init__(self, project, scale_factors, inv_sigma2, K,
                 imu_calib=None):
        self.project = project
        self.scale_factors = scale_factors
        self.inv_sigma2 = inv_sigma2
        self.K = K
        self.imu_calib = imu_calib
        self.recent_points: List[int] = []
        # called with (map, kf_id) after a keyframe is culled; the
        # tracker wires this to KeyFrameDatabase.erase (reference
        # KeyFrame::SetBadFlag -> KeyFrameDatabase::erase,
        # src/KeyFrameDatabase.cc:47)
        self.on_kf_removed = None
        # in-flight window BA (run_ba async_apply): applied at the next
        # keyframe, discarded when a loop/merge/IMU-init rewrote poses
        self._pending_ba: Optional[PendingBA] = None
        self._pending_ba_mid = -1
        # deferred triangulation+fuse results (defer_fetch mode): the
        # device programs were dispatched at the keyframe event; the
        # fetch rides on the tracker's next confirmation round trip
        self._pending_tf = None  # (mid, kf_id, tri, fuse)
        # notifier: the tracker uses this to learn when the deferred
        # results became visible (gates its weak-tracking KF trigger)
        self.on_tf_applied = None

    def flush_ba(self, mp: SLAMMap, force: bool = True):
        """Apply the in-flight window BA, if any (and still valid).

        With force=False (polled at keyframe events) a solve still
        running on device is LEFT in flight instead of blocked on —
        the reference's mbAbortBA semantics: a new keyframe must not
        wait for the running local BA (src/Tracking.cc:2770
        InterruptBA); the result applies on the next confirmation
        round trip it rides."""
        p = self._pending_ba
        if p is None:
            return
        if not force:
            try:
                if not p.res.R.is_ready():
                    return
            except AttributeError:  # pragma: no cover — older jax
                pass
        self._pending_ba = None
        if self._pending_ba_mid == mp.mid:
            p.apply(mp)

    def pending_ba_handles(self):
        """Device arrays of the in-flight window BA result, for
        piggybacking on the tracker's confirmation fetch (a separate
        fetch is one more blocking round trip).  [] when nothing pending."""
        if self._pending_ba is None:
            return []
        r = self._pending_ba.res
        return [r.R, r.t, r.points, r.inliers]

    def apply_ba_fetched(self, mp: SLAMMap, vals):
        """Apply the in-flight window BA from already-fetched host
        values (the pending_ba_handles structure)."""
        p = self._pending_ba
        self._pending_ba = None
        if p is not None and self._pending_ba_mid == mp.mid:
            p.apply_fetched(mp, vals)

    def discard_ba(self):
        """Drop the in-flight window BA and deferred triangulation/fuse
        results (map poses were rewritten by a loop correction / merge /
        gravity alignment underneath them).

        Divergence from synchronous mode, by design: the keyframe whose
        triangulation/fuse was in flight keeps a sparser local map at
        the event (the results were computed against pre-correction
        poses and cannot be applied).  The next keyframe's triangulation
        refills the window.  The notifier still fires so the tracker's
        weak-tracking gate re-arms on the same contract as apply_tf."""
        self._pending_ba = None
        self._pending_tf = None
        if self.on_tf_applied is not None:
            self.on_tf_applied()

    def has_pending_tf(self) -> bool:
        """True while deferred triangulation/fuse results are in flight
        (the tracker gates its weak-tracking keyframe trigger on this)."""
        return self._pending_tf is not None

    # ---- deferred triangulation/fuse (fetch rides the next confirm)

    def pending_tf_handles(self):
        """Device arrays of the deferred triangulation+fuse results, for
        piggybacking on another device_get.  [] when nothing pending."""
        if self._pending_tf is None:
            return []
        _, _, tri, fuse = self._pending_tf
        return [[g[-1] for g in tri], [g[-1] for g in fuse]]

    def apply_tf(self, mp: SLAMMap, fetched):
        """Apply deferred triangulation+fuse with already-fetched host
        values (the pending_tf_handles structure)."""
        if self._pending_tf is None:
            return
        mid, kf_id, tri, fuse = self._pending_tf
        self._pending_tf = None
        if mid == mp.mid and kf_id in mp.keyframes:
            self._create_new_points_apply(mp, kf_id, tri, fetched[0])
            self._fuse_apply_all(mp, fuse, fetched[1])
            # window BA dispatched NOW so the problem includes the
            # just-landed points — without this, the fresh unrefined
            # triangulations dominate pose optimization for a whole
            # keyframe interval and the pose walks off (sync mode runs
            # the LBA after the applies for the same reason)
            self._local_ba(mp, kf_id)
        if self.on_tf_applied is not None:
            self.on_tf_applied()

    def flush_tf(self, mp: SLAMMap):
        """Fetch + apply deferred triangulation/fuse, if any."""
        if self._pending_tf is None:
            return
        fetched = pack_fetch(self.pending_tf_handles())
        self.apply_tf(mp, fetched)

    # ----------------------------------------------------------- pipeline

    def process_keyframe(self, mp: SLAMMap, kf_id: int,
                         defer_fetch: bool = False):
        """ProcessNewKeyFrame + culling + CreateNewMapPoints +
        SearchInNeighbors fuse + local BA + KeyFrameCulling
        (reference LocalMapping::Run body, :78-230).

        The triangulation and fuse searches are DISPATCHED together and
        fetched with one combined device_get: JAX dispatch is async, so
        the two (or more, with capacity groups) programs overlap on
        device and the host pays a single round trip.  The fuse
        therefore projects the PRE-triangulation point set — new points
        created this keyframe get fused from the next keyframe instead
        (a one-keyframe delay vs the reference's ordering; duplicates
        are still merged, one keyframe later)."""
        self.flush_tf(mp)
        self.flush_ba(mp, force=False)
        self._assign_parent(mp, kf_id)
        self._cull_map_points(mp)
        tri = self._create_new_points_dispatch(mp, kf_id)
        fuse = self._fuse_dispatch(mp, kf_id)
        if defer_fetch:
            # the fetch rides the tracker's next confirmation round trip
            # (one keyframe-pipeline latency, like the reference's
            # LocalMapping queue); this keyframe event pays only the
            # dispatch enqueues.  The window BA is dispatched by
            # apply_tf when the new points land.
            self._pending_tf = (mp.mid, kf_id, tri, fuse)
        else:
            fetched = pack_fetch([
                [g[-1] for g in tri],
                [g[-1] for g in fuse],
            ])
            self._create_new_points_apply(mp, kf_id, tri, fetched[0])
            self._fuse_apply_all(mp, fuse, fetched[1])
            self._local_ba(mp, kf_id)
        self._cull_keyframes(mp, kf_id)

    def _assign_parent(self, mp: SLAMMap, kf_id: int):
        """Spanning-tree parent: the strongest earlier covisible at
        insertion (reference KeyFrame::UpdateConnections first-connection
        branch, src/KeyFrame.cc ChangeParent region)."""
        kf = mp.keyframes.get(kf_id)
        if kf is None or kf.parent >= 0:
            return
        for nk, _ in mp.covisible_keyframes(kf_id, 1):
            if nk < kf_id:
                kf.parent = nk
                return

    def _cull_map_points(self, mp: SLAMMap):
        """MapPointCulling (reference :341): drop points with found/visible
        ratio < 0.25 or too few observations soon after creation."""
        still = []
        for p in self.recent_points:
            if not mp.mp_valid[p]:
                continue
            vis = max(int(mp.mp_visible[p]), 1)
            ratio = mp.mp_found[p] / vis
            n_obs = mp.n_observations(p)
            age = mp.mp_visible[p]
            if ratio < 0.25 and vis >= 3:
                mp.remove_point(p)
            elif vis >= 4 and n_obs <= 2:
                mp.remove_point(p)
            elif vis >= 6:
                pass  # survived probation
            else:
                still.append(p)
        self.recent_points = still

    def _create_new_points_dispatch(self, mp: SLAMMap, kf_id: int,
                                    n_neighbors: int = 10):
        """CreateNewMapPoints device stage (reference :383): epipolar
        search + DLT triangulation + acceptance checks over the
        covisible neighbours, one vmapped program per neighbour
        capacity group.  Returns [(group kfs, device outputs)] without
        blocking."""
        kf1 = mp.keyframes[kf_id]
        neighbors = [k for k, _ in mp.covisible_keyframes(kf_id, 1)[:n_neighbors]]
        O1 = kf1.center()
        free1 = kf1.valid & (kf1.kp_mp < 0)
        use = []
        for nk in neighbors:
            kf2 = mp.keyframes[nk]
            baseline = np.linalg.norm(kf2.center() - O1)
            med_depth = self._median_depth(mp, kf2)
            if med_depth > 0 and baseline / med_depth >= 0.01:
                use.append(kf2)
        if not use:
            return []
        P1 = (self.K @ np.concatenate([kf1.R, kf1.t[:, None]], 1)).astype(
            np.float32
        )
        out = []
        # neighbour keyframes may have different keypoint capacities
        # (the init extractor runs at 5x): one program per capacity group
        groups = {}
        for k2 in use:
            groups.setdefault(len(k2.valid), []).append(k2)
        for N2, grp in groups.items():
            n_real = len(grp)
            B = _bucket_b(n_real)
            while len(grp) < B:   # pad with a no-match dummy (free2=False)
                grp.append(grp[0])
            desc2 = jnp.stack([k2.feats.desc for k2 in grp])
            oct2 = jnp.stack([k2.feats.octave for k2 in grp])
            xy2 = np.stack([k2.xy_un for k2 in grp])
            free2 = np.stack([k2.valid & (k2.kp_mp < 0) for k2 in grp])
            free2[n_real:] = False
            F12 = np.stack([self._fundamental(kf1, k2) for k2 in grp])
            P2 = np.stack([
                (self.K @ np.concatenate([k2.R, k2.t[:, None]], 1)).astype(
                    np.float32
                )
                for k2 in grp
            ])
            R2 = np.stack([k2.R for k2 in grp])
            t2 = np.stack([k2.t for k2 in grp])
            O2 = np.stack([k2.center() for k2 in grp])

            prog = _triangulation_program(
                tuple(self.scale_factors), tuple(self.inv_sigma2), B, N2
            )
            res = prog(
                kf1.feats.desc, jnp.asarray(kf1.xy_un), kf1.feats.octave,
                jnp.asarray(free1),
                desc2, jnp.asarray(xy2), oct2, jnp.asarray(free2),
                jnp.asarray(F12.astype(np.float32)),
                jnp.asarray(P1), jnp.asarray(P2),
                jnp.asarray(kf1.R), jnp.asarray(kf1.t),
                jnp.asarray(R2), jnp.asarray(t2),
                jnp.asarray(O1.astype(np.float32)),
                jnp.asarray(O2.astype(np.float32)),
                jnp.asarray(np.asarray(
                    [self.K[0, 0], self.K[1, 1], self.K[0, 2],
                     self.K[1, 2]], np.float32,
                )),
            )
            out.append((grp[:n_real], res))
        return out

    def _create_new_points_apply(self, mp: SLAMMap, kf_id: int,
                                 dispatched, fetched):
        """Host side of CreateNewMapPoints: claim keypoints (first
        neighbour wins, matching the reference's sequential order) and
        create the accepted points."""
        kf1 = mp.keyframes.get(kf_id)
        if kf1 is None:
            return
        created = []
        for (grp, _), (m12B, XB, okB) in zip(dispatched, fetched):
            for b, kf2 in enumerate(grp):
                if kf2.kid not in mp.keyframes:
                    continue  # culled while the fetch was deferred
                rows = np.where(okB[b])[0]
                for i1 in rows:
                    i2 = int(m12B[b, i1])
                    if kf1.kp_mp[i1] >= 0 or kf2.kp_mp[i2] >= 0:
                        continue  # claimed by an earlier neighbour
                    mid = mp.add_point(
                        XB[b, i1], kf1.desc[i1], np.zeros(3, np.float32),
                        1.0, kf1.kid,
                    )
                    mp.add_observation(mid, kf1.kid, int(i1))
                    mp.add_observation(mid, kf2.kid, i2)
                    created.append(mid)
                    self.recent_points.append(mid)
        mp.update_point_stats_batch(created)

    def _median_depth(self, mp: SLAMMap, kf) -> float:
        ids = kf.kp_mp[kf.kp_mp >= 0]
        ids = ids[mp.mp_valid[ids]] if len(ids) else ids
        if len(ids) == 0:
            return -1.0
        pc = mp.mp_pos[ids] @ kf.R.T + kf.t
        return float(np.median(pc[:, 2]))

    def _fundamental(self, kf1, kf2) -> np.ndarray:
        """ComputeF12 (reference LocalMapping.cc:1032 region)."""
        R12 = kf1.R @ kf2.R.T
        t12 = -R12 @ kf2.t + kf1.t
        tx = np.array(
            [
                [0, -t12[2], t12[1]],
                [t12[2], 0, -t12[0]],
                [-t12[1], t12[0], 0],
            ],
            np.float32,
        )
        Kinv = np.linalg.inv(self.K)
        return Kinv.T @ tx @ R12 @ Kinv

    def _fuse_dispatch(self, mp: SLAMMap, kf_id: int,
                       n_neighbors: int = 10):
        """SearchInNeighbors device stage (reference LocalMapping.cc:729):
        all B+1 projection searches dispatched as vmapped programs (one
        per target-capacity group) without blocking.  Returns
        [(jobs, device matches)]."""
        kf1 = mp.keyframes[kf_id]
        neighbors = [k for k, _ in mp.covisible_keyframes(kf_id, 1)[:n_neighbors]]
        if not neighbors:
            return []
        M_CAP = 4096
        own = mp.points_seen_by([kf_id])
        jobs = []  # (target_kf_id, pt_ids)
        pts = mp.points_seen_by(neighbors)
        jobs.append((kf_id, pts))
        for nk in neighbors:
            jobs.append((nk, own))
        # per-job filter: drop points already observed by the target
        filt = []
        for tgt, pt_ids in jobs:
            pt_ids = np.asarray(
                [p for p in pt_ids if tgt not in mp.obs.get(int(p), {})],
                np.int32,
            )[:M_CAP]
            if len(pt_ids):
                filt.append((tgt, pt_ids))
        # pad the point axis to the smallest bucket that fits the
        # biggest job: most fuse jobs carry only the current keyframe's
        # few-hundred new points, and a fixed 4096 pad made every job
        # pay ~8x its real search cost
        if filt:
            biggest = max(len(p) for _, p in filt)
            M = next(b for b in (512, 1024, 2048, 4096) if biggest <= b)
        else:
            M = 512
        if not filt:
            return []
        # group by target keyframe capacity (init KFs run at 5x): fewer
        # larger programs mean fewer dispatches and round trips (whether
        # that still beats tight programs on the GPU is not measured)
        by_cap = {}
        for tgt, pt_ids in filt:
            by_cap.setdefault(len(mp.keyframes[tgt].valid), []).append(
                (tgt, pt_ids)
            )
        out = []
        for N, jobs in by_cap.items():
            n_real = len(jobs)
            B = _bucket_b(n_real)
            posB = np.zeros((B, M, 3), np.float32)
            descB = np.zeros((B, M, 32), np.uint8)
            normB = np.zeros((B, M, 3), np.float32)
            maxdB = np.ones((B, M), np.float32)
            valB = np.zeros((B, M), bool)
            R_B = np.tile(np.eye(3, dtype=np.float32), (B, 1, 1))
            t_B = np.zeros((B, 3), np.float32)
            xyB = np.zeros((B, N, 2), np.float32)
            kdescB = [None] * B
            koctB = [None] * B
            kvalidB = np.zeros((B, N), bool)
            for j, (tgt, pt_ids) in enumerate(jobs):
                k = len(pt_ids)
                posB[j, :k] = mp.mp_pos[pt_ids]
                descB[j, :k] = mp.mp_desc[pt_ids]
                normB[j, :k] = mp.mp_normal[pt_ids]
                maxdB[j, :k] = mp.mp_max_dist[pt_ids]
                valB[j, :k] = mp.mp_valid[pt_ids]
                kf = mp.keyframes[tgt]
                R_B[j], t_B[j] = kf.R, kf.t
                xyB[j] = kf.xy_un
                kdescB[j] = kf.feats.desc
                koctB[j] = kf.feats.octave
                kvalidB[j] = kf.valid
            for j in range(n_real, B):
                kdescB[j] = kdescB[0]
                koctB[j] = koctB[0]

            prog = _fuse_program(self.project, tuple(self.scale_factors),
                                 B, M, N)
            matchesB = prog(
                jnp.asarray(posB), jnp.asarray(descB), jnp.asarray(valB),
                jnp.asarray(normB), jnp.asarray(maxdB),
                jnp.asarray(R_B), jnp.asarray(t_B),
                jnp.asarray(xyB), jnp.stack(kdescB), jnp.stack(koctB),
                jnp.asarray(kvalidB),
            )
            out.append((jobs, matchesB))
        return out

    def _fuse_apply_all(self, mp: SLAMMap, dispatched, fetched):
        touched = []
        for (jobs, _), matchesB in zip(dispatched, fetched):
            for j, (tgt, pt_ids) in enumerate(jobs):
                if tgt in mp.keyframes:
                    touched.extend(self._apply_fuse(
                        mp, tgt, pt_ids, np.asarray(matchesB[j]),
                        defer_stats=True,
                    ))
        mp.update_point_stats_batch(touched)

    def _apply_fuse(self, mp: SLAMMap, kf_id: int, pt_ids: np.ndarray,
                    matches: np.ndarray, defer_stats: bool = False):
        """Attach-or-merge the accepted projections (reference
        ORBmatcher::Fuse tail, ORBmatcher.cc:2028 region).  Returns the
        touched point ids; with ``defer_stats`` the caller batches the
        stats refresh across jobs."""
        kf = mp.keyframes[kf_id]
        touched = []
        for row in np.where(matches >= 0)[0]:
            p = int(pt_ids[row])
            if not mp.mp_valid[p]:
                continue  # merged away by an earlier job of this batch
            kp = int(matches[row])
            existing = int(kf.kp_mp[kp])
            if existing >= 0 and mp.mp_valid[existing]:
                # merge: keep the point with more observations
                if mp.n_observations(existing) >= mp.n_observations(p):
                    keep, drop = existing, p
                else:
                    keep, drop = p, existing
                if keep == drop:
                    continue
                for okf, okp in list(mp.obs.get(drop, {}).items()):
                    if okf not in mp.obs.get(keep, {}):
                        mp.obs[keep][okf] = okp
                        mp.keyframes[okf].kp_mp[okp] = keep
                    else:
                        if mp.keyframes[okf].kp_mp[okp] == drop:
                            mp.keyframes[okf].kp_mp[okp] = -1
                mp.obs[drop] = {}
                mp.remove_point(drop)
                touched.append(keep)
            else:
                mp.add_observation(p, kf_id, kp)
                touched.append(p)
        if not defer_stats:
            mp.update_point_stats_batch(touched)
        return touched

    def _cull_keyframes(self, mp: SLAMMap, kf_id: int):
        """KeyFrameCulling (reference :935): a covisible keyframe is
        redundant if >=90% of its map points are observed by >=3 other
        keyframes at the same or finer scale."""
        for cand, _ in mp.covisible_keyframes(kf_id, 1):
            kf = mp.keyframes.get(cand)
            if kf is None or cand <= 1:  # keep the initial pair
                continue
            # Inertial maps: culling must not starve or break the IMU
            # temporal chain (reference KeyFrameCulling inertial branch,
            # LocalMapping.cc:935+): no culling before IMU init, and
            # afterwards only when the merged preintegration gap stays
            # short (<3 s; <0.5 s until the final VIBA2 refinement).
            if self.imu_calib is not None:
                if not mp.imu_initialized:
                    continue
                prev = mp.keyframes.get(kf.prev_kf)
                succ = next((k for k in mp.keyframes.values()
                             if k.prev_kf == cand), None)
                if prev is not None and succ is not None:
                    gap = succ.timestamp - prev.timestamp
                    if gap > (3.0 if mp.imu_ba2 else 0.5):
                        continue
            kp_rows = np.where(kf.kp_mp >= 0)[0]
            if len(kp_rows) < 10:
                continue
            ids = kf.kp_mp[kp_rows]
            ok = mp.mp_valid[ids]
            kp_rows, ids = kp_rows[ok], ids[ok]
            n_pts = len(ids)
            if n_pts == 0:
                continue
            lvls = kf.octave[kp_rows].astype(np.int32)
            lookup = np.full(len(mp.mp_valid), -1, np.int32)
            lookup[ids] = np.arange(n_pts, dtype=np.int32)
            n_better = np.zeros(n_pts, np.int32)
            for okf_id, okf in mp.keyframes.items():
                if okf_id == cand:
                    continue
                orows = np.where(okf.kp_mp >= 0)[0]
                pidx = lookup[okf.kp_mp[orows]]
                keep = pidx >= 0
                orows, pidx = orows[keep], pidx[keep]
                fine = okf.octave[orows] <= lvls[pidx] + 1
                np.add.at(n_better, pidx[fine], 1)
            n_redundant = int((n_better >= 3).sum())
            if n_redundant > 0.9 * n_pts:
                self._remove_keyframe(mp, cand)

    def _remove_keyframe(self, mp: SLAMMap, kf_id: int):
        """SetBadFlag analog: detach all observations and drop the KF."""
        kf = mp.keyframes.get(kf_id)
        if kf is None:
            return
        for kp in np.where(kf.kp_mp >= 0)[0]:
            p = int(kf.kp_mp[kp])
            if p in mp.obs and kf_id in mp.obs[p]:
                mp.erase_observation(p, kf_id)
        # inertial temporal-chain repair (reference KeyFrame::SetBadFlag
        # + Preintegrated::MergePrevious, src/ImuTypes.cc:312): the
        # successor inherits prev_kf and the merged measurement window
        succ = next(
            (k for k in mp.keyframes.values() if k.prev_kf == kf_id), None
        )
        if succ is not None:
            succ.prev_kf = kf.prev_kf
            if self.imu_calib is not None and (
                kf.imu_meas is not None or succ.imu_meas is not None
            ):
                from . import imu_frontend

                succ.imu_meas = imu_frontend.merge_measurements(
                    kf.imu_meas, succ.imu_meas
                )
                bias = (
                    np.concatenate([succ.bg, succ.ba]).astype(np.float32)
                    if succ.bg is not None
                    else np.zeros(6, np.float32)
                )
                if succ.imu_meas is not None:
                    succ.preint = imu_frontend.integrate_raw_host(
                        succ.imu_meas, bias, self.imu_calib
                    )
        # spanning-tree surgery: reparent children to this KF's parent
        # (simplified vs the reference's best-covisible-candidate search
        # in KeyFrame::SetBadFlag — the parent is always a valid
        # covisible ancestor, which preserves tree connectivity)
        for other in mp.keyframes.values():
            if other.parent == kf_id:
                other.parent = kf.parent
        kf.is_bad = True
        # tombstone for trajectory resolution (reference SetBadFlag's
        # mTcp = Tcw * parent.Twc)
        parent = mp.keyframes.get(kf.parent)
        if parent is not None:
            R_cp = (kf.R @ parent.R.T).astype(np.float32)
            t_cp = (kf.t - R_cp @ parent.t).astype(np.float32)
            mp.dead_kfs[kf_id] = (kf.parent, R_cp, t_cp)
        del mp.keyframes[kf_id]
        mp.version += 1
        if self.on_kf_removed is not None:
            self.on_kf_removed(mp, kf_id)

    def _local_ba(self, mp: SLAMMap, kf_id: int):
        """LocalBundleAdjustment window build (reference Optimizer.cc:1698):
        local = covisibles of the new KF; fixed = other KFs observing the
        local points.  Inertial maps with an initialised IMU run
        LocalInertialBA over the temporal window instead (the reference's
        mbInertial branch, src/LocalMapping.cc:149-154)."""
        if self.imu_calib is not None and mp.imu_initialized:
            from . import imu_frontend

            if imu_frontend.local_inertial_ba(
                mp, self.imu_calib, self.project, kf_id,
                n_window=10,
            ):
                return
        local = [kf_id] + [k for k, _ in mp.covisible_keyframes(kf_id, 1)]
        local_set = set(local)
        pt_ids = mp.points_seen_by(local)
        fixed: Set[int] = set()
        for p in pt_ids:
            for k in mp.obs.get(int(p), {}):
                if k not in local_set:
                    fixed.add(k)
        all_ids = local + sorted(fixed)
        # keep the problem bounded (reference uses the covisibility window)
        all_ids = all_ids[:24]
        if len(local) >= len(all_ids):
            fixed_ids = {all_ids[-1]} if len(all_ids) > 2 else set()
        else:
            fixed_ids = set(all_ids) - set(local)
        # reference LBA runs a 5-iteration first phase (Optimizer.cc:1698
        # region); the window is small, so a short PCG budget suffices.
        # Dispatched asynchronously (applied at the next keyframe) like
        # the reference's concurrent mapping thread.
        self._pending_ba = run_ba(
            mp, all_ids, fixed_ids, self.project, self.inv_sigma2,
            n_iters=5, cg_iters=25, async_apply=True,
        )
        self._pending_ba_mid = mp.mid
