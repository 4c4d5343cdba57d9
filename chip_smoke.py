"""Smoke run of the SLAM main path on a GPU, with its checks.

    python chip_smoke.py             # phases a-e on one card
    python chip_smoke.py --cards 4   # the multi-device path on four cards

One card: (a) ORB extraction on the GPU and the CPU of the same process
must agree bitwise; (b) monocular, (c) stereo and RGB-D, (d) monocular-
inertial and (e) loop/merge sessions run through ``System`` on seeded
scenes and must meet the accuracy bounds of the end-to-end tests.  Each
phase prints one line with its checks, its cold (first-call) and warm
seconds, its compile seconds, peak device memory and the card.

``--cards 4``: the sharded solvers (global BA, inertial GBA, pose graph,
keyframe-block place scores) against their single-device counterparts
on a long-session problem, then phase (e) with all four cards visible.
Phase (e) closes its revisit by a map merge, which runs no solve on the
device mesh; its ``mesh_solves`` count says how many did.

The last line of standard output is one JSON object naming the device.
The script exits non-zero, before that line, when JAX finds no GPU or
any check fails.
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import time

import numpy as np

SEED = 0
_COMPILE_S = [0.0]


def require_gpu(devices, count: int = 1):
    """Refuse to run anywhere but on ``count`` GPUs: there is no CPU
    fallback."""
    if not devices or devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU, JAX found {[d.platform for d in devices]}")
    if len(devices) < count:
        raise SystemExit(f"chip_smoke: needs {count} GPUs, found {len(devices)}")


def card_info() -> str:
    """Name and power limit of every card, as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()
    return "; ".join(sorted(set(out)))


def final_line(devices) -> str:
    """The result line: the device as JAX reports it."""
    return json.dumps({"ok": True, "device": {
        "platform": devices[0].platform,
        "kind": devices[0].device_kind,
        "count": len(devices),
    }})


class Phase:
    """Times one phase: cold (first call, compiling) and warm runs, the
    seconds JAX spent compiling, and the device's peak memory."""

    def __init__(self, name: str, card: str):
        self.name, self.card = name, card
        self.checks: dict = {}
        self.cold_s = self.warm_s = None
        self._c0 = _COMPILE_S[0]

    def run(self, fn):
        """Run ``fn`` twice, cold then warm; return the warm result."""
        t0 = time.perf_counter()
        fn()
        self.cold_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = fn()
        self.warm_s = time.perf_counter() - t0
        return out

    def check(self, name: str, value, ok: bool):
        self.checks[name] = (value, bool(ok))

    def report(self, device):
        stats = device.memory_stats() or {}
        peak = stats.get("peak_bytes_in_use")
        checks = ", ".join(f"{k}={_fmt(v)}{'' if ok else ' FAILED'}"
                           for k, (v, ok) in self.checks.items())
        print(f"phase {self.name}: {checks} | cold_s={_fmt(self.cold_s)} "
              f"warm_s={_fmt(self.warm_s)} "
              f"compile_s={_fmt(_COMPILE_S[0] - self._c0)} "
              f"peak_bytes={peak} | {device.device_kind} | card: {self.card}",
              flush=True)
        failed = [k for k, (_, ok) in self.checks.items() if not ok]
        if failed:
            raise SystemExit(f"chip_smoke: phase {self.name} failed {failed}")


def _fmt(v):
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def _count_compile_time():
    import jax

    def on_event(event, duration, **_):
        if event.startswith("/jax/core/compile/"):
            _COMPILE_S[0] += duration

    jax.monitoring.register_event_duration_secs_listener(on_event)


# --------------------------------------------------------------------------
# (a) extraction parity


def extraction_outputs(device, img, cfg, octree="device"):
    """Every intermediate of one frame's extraction on ``device``, as
    numpy: pyramid levels, FAST masks and scores, and the features."""
    import jax
    import jax.numpy as jnp

    from extractorb.frontend import fast as ffast
    from extractorb.frontend.extractor import ORBExtractor
    from extractorb.frontend.pyramid import compute_pyramid

    with jax.default_device(device):
        x = jax.device_put(jnp.asarray(img), device)
        out = {}
        for lvl, b in enumerate(compute_pyramid(x, cfg.n_levels, cfg.scale_factor)):
            keep, score = ffast.detect_keypoints(b, cfg.ini_th_fast, cfg.min_th_fast)
            out[f"pyramid{lvl}"] = b
            out[f"fast_mask{lvl}"] = keep
            out[f"fast_score{lvl}"] = score
        f = ORBExtractor(cfg, octree=octree)(x)
        for k in ("xy", "response", "angle", "octave", "desc", "valid"):
            out[k] = getattr(f, k)
        return jax.device_get(out)


def bitwise_mismatches(a: dict, b: dict) -> dict:
    """Per-array count of differing elements (shape mismatch counts as
    every element)."""
    out = {}
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        out[k] = int(x.size) if x.shape != y.shape else int(
            (x.view(np.uint8) != y.view(np.uint8)).sum())
    return out


def hamming_numpy(d1: np.ndarray, d2: np.ndarray) -> np.ndarray:
    """XOR-popcount distance matrix of packed 256-bit descriptors."""
    pop = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], 1).sum(1).astype(np.uint8)
    return pop[d1[:, None, :] ^ d2[None, :, :]].sum(-1, dtype=np.int32)


def octree_agreement(fd: dict, fh: dict, w=640, h=480):
    """Total-variation distance between the 8x6 occupancy histograms of
    two feature sets (device vs host octree)."""
    def occ(f):
        xy = np.asarray(f["xy"])[np.asarray(f["valid"])]
        gx = np.clip((xy[:, 0] / w * 8).astype(int), 0, 7)
        gy = np.clip((xy[:, 1] / h * 6).astype(int), 0, 5)
        hist = np.zeros((6, 8))
        np.add.at(hist, (gy, gx), 1.0)
        return hist / hist.sum()
    return float(0.5 * np.abs(occ(fd) - occ(fh)).sum())


def phase_extraction(card, gpu, cpu):
    import jax
    import jax.numpy as jnp

    from extractorb.config import ORBConfig
    from extractorb.frontend.extractor import ORBExtractor
    from extractorb.frontend.matcher import hamming_matrix
    from extractorb.sim import scenes

    cfg = ORBConfig()
    frames, _ = scenes.render_sequence(scenes.texture(SEED), n_frames=2)
    ph = Phase("a extraction parity (GPU vs CPU)", card)
    on_gpu = ph.run(lambda: extraction_outputs(gpu, frames[0], cfg))
    on_cpu = extraction_outputs(cpu, frames[0], cfg)
    bad = bitwise_mismatches(on_gpu, on_cpu)
    ph.check("arrays_compared", len(bad), len(bad) == 3 * cfg.n_levels + 6)
    ph.check("mismatched_elements", {k: v for k, v in bad.items() if v} or 0,
             sum(bad.values()) == 0)
    ph.check("features", int(on_gpu["valid"].sum()), on_gpu["valid"].sum() >= cfg.n_features)
    again = extraction_outputs(gpu, frames[0], cfg)
    rerun = sum(bitwise_mismatches(on_gpu, again).values())
    ph.check("gpu_rerun_mismatches", rerun, rerun == 0)

    host_gpu = extraction_outputs(gpu, frames[0], cfg, octree="host")
    host_cpu = extraction_outputs(cpu, frames[0], cfg, octree="host")
    hbad = {k: v for k, v in bitwise_mismatches(host_gpu, host_cpu).items() if v}
    ph.check("host_octree_mismatches", hbad or 0, not hbad)
    # the device octree approximates the host's final-stage splits by
    # design: their 8x6 occupancy histograms differ by ~0.13 in total
    # variation on this scene (CPU), so 0.2 flags a broken distribution
    tv = octree_agreement(on_gpu, host_gpu)
    ph.check("device_vs_host_octree_tv", tv, tv < 0.2)

    second = extraction_outputs(gpu, frames[1], cfg)
    n = cfg.n_features
    d1, d2 = on_gpu["desc"][:n], second["desc"][:n]
    with jax.default_device(gpu):
        hm = np.asarray(hamming_matrix(jnp.asarray(d1), jnp.asarray(d2)))
    ref = hamming_numpy(d1, d2)
    ph.check("hamming_shape", hm.shape, hm.shape == (n, n))
    ph.check("hamming_mismatches", int((hm != ref).sum()), (hm == ref).all())

    # the extractor's own program, so the persistent cache serves it
    ext = ORBExtractor(cfg, octree="device")
    capacity = cfg.n_features + cfg.n_levels * 16
    compiled = jax.jit(functools.partial(ext._extract, capacity=capacity)) \
        .lower(jax.device_put(jnp.asarray(frames[0]), gpu)).compile()
    print(f"  extraction program memory: {compiled.memory_analysis()}")
    ph.report(gpu)


# --------------------------------------------------------------------------
# (b)-(e) sessions through System


def _camera(**kw):
    from extractorb.config import CameraConfig
    from extractorb.sim import scenes

    return CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                        width=scenes.W, height=scenes.H, **kw)


def _sim3_ate(traj, gt_pose_of_ts):
    from extractorb.sim import scenes

    est = scenes.camera_centers([(R, t) for _, R, t in traj])
    gt = scenes.camera_centers([gt_pose_of_ts(ts) for ts, _, _ in traj])
    aligned, s = scenes.umeyama_align(est, gt, return_scale=True)
    return float(np.sqrt(((aligned - gt) ** 2).sum(-1).mean())), float(s), gt


def mono_session(frames, depth: int):
    from extractorb.config import ORBConfig, SLAMConfig, TrackingConfig
    from extractorb.slam.system import System

    s = System(SLAMConfig(orb=ORBConfig(), camera=_camera(),
                          tracking=TrackingConfig(max_frames=6, pipeline_depth=depth)))
    for k, im in enumerate(frames):
        s.track_monocular(im, k / 30.0)
    s.flush()
    return s


def phase_mono(card, gpu, n_frames=40):
    from extractorb.sim import scenes

    frames, poses = scenes.render_sequence(scenes.texture(SEED), n_frames, speed=0.06)
    pose_of = lambda ts: poses[int(round(ts * 30.0))]
    ph = Phase("b monocular", card)
    s = ph.run(lambda: mono_session(frames, depth=8))
    traj = s.tracker.final_trajectory()
    ph.check("frames_tracked", len(s.tracker.trajectory), len(s.tracker.trajectory) == n_frames)
    ate, _, gt = _sim3_ate(traj, pose_of)
    bound = 0.05 * max(float(np.linalg.norm(gt[-1] - gt[0])), 1.0)
    ph.check("ate_m", ate, ate < bound)
    ph.check("ate_bound_m", bound, True)
    ph.check("keyframes", s.n_keyframes(), s.n_keyframes() >= 2)
    # pipelined vs synchronous: same frames, decisions lag by the depth,
    # so the maps may differ; both must meet the bound
    sync = mono_session(frames, depth=0)
    ate0, _, _ = _sim3_ate(sync.tracker.final_trajectory(), pose_of)
    ph.check("ate_synchronous_m", ate0, ate0 < bound)
    ph.check("fused_frames", s.tracker.n_fused_frames, True)
    ph.report(gpu)


def _metric_error(traj, poses):
    from extractorb.sim import scenes

    est = scenes.camera_centers([(R, t) for _, R, t in traj])
    gt = scenes.camera_centers(poses)[: len(est)]
    return float(np.linalg.norm(est - gt, axis=1).max())


def phase_stereo_rgbd(card, gpu, n_frames=30):
    from extractorb.config import ORBConfig, SLAMConfig, TrackingConfig
    from extractorb.sim import scenes
    from extractorb.slam.system import System

    tex = scenes.texture(SEED)
    left, right, poses = scenes.render_stereo_pair(tex, n_frames)
    frames, depths, poses_d = scenes.render_rgbd(tex, n_frames)

    def session(sensor):
        s = System(SLAMConfig(
            orb=ORBConfig(), camera=_camera(bf=scenes.BF, th_depth=40.0),
            tracking=TrackingConfig(max_frames=6, pipeline_depth=8), sensor=sensor))
        for k in range(n_frames):
            if sensor == "stereo":
                s.track_stereo(left[k], right[k], k / 30.0)
            else:
                s.track_rgbd(frames[k], depths[k], k / 30.0)
        s.flush()
        return s

    for sensor, gt in (("stereo", poses), ("rgbd", poses_d)):
        ph = Phase(f"c {sensor}", card)
        s = ph.run(lambda: session(sensor))
        ph.check("fused_frames", s.tracker.n_fused_frames,
                 s.tracker.n_fused_frames >= n_frames - 3)
        err = _metric_error(s.tracker.final_trajectory(), gt)
        ph.check("max_metric_error_m", err, err < 0.15)
        ph.report(gpu)


def phase_vi(card, gpu, n_frames=40, imu_hz=200.0):
    from extractorb.config import IMUConfig, ORBConfig, SLAMConfig, TrackingConfig
    from extractorb.sim import scenes
    from extractorb.slam.system import System
    from extractorb.slam.tracking import TrackState

    frames, _ = scenes.render_vi_sequence(scenes.texture(SEED), n_frames)
    fps = scenes.VI_FPS

    def session():
        s = System(SLAMConfig(
            orb=ORBConfig(), camera=_camera(fps=fps),
            imu=IMUConfig(noise_gyro=1e-4, noise_acc=1e-3, gyro_walk=1e-6,
                          acc_walk=1e-5, frequency=imu_hz),
            tracking=TrackingConfig(max_frames=3, pipeline_depth=3),
            sensor="imu-monocular"))
        states = []
        for k, img in enumerate(frames):
            ts = k / fps
            imu = scenes.vi_imu_window((k - 1) / fps, ts, imu_hz) if k else None
            states.append(s.track_monocular(img, ts, imu=imu))
        s.flush()
        return s, states

    ph = Phase("d monocular-inertial", card)
    s, states = ph.run(session)
    ok_tail = all(st == TrackState.OK for st in states[-4:])
    ph.check("last4_ok", ok_tail, ok_tail)
    ph.check("imu_initialized", s.tracker.atlas.current.imu_initialized,
             s.tracker.atlas.current.imu_initialized)
    ate, scale, _ = _sim3_ate(s.tracker.final_trajectory(), scenes.vi_pose)
    ph.check("ate_m", ate, ate < 0.25)
    ph.check("scale_err", abs(scale - 1.0), abs(scale - 1.0) < 0.35)
    ph.check("vi_fused_frames", s.tracker.n_fused_frames, True)
    ph.report(gpu)


def phase_loop(card, gpu, n_frames=100, label="e loop/merge"):
    import jax
    import jax.numpy as jnp

    from extractorb.config import ORBConfig, SLAMConfig, TrackingConfig
    from extractorb.dist import mesh as dmesh
    from extractorb.frontend.extractor import ORBExtractor
    from extractorb.place.vocab import Vocabulary
    from extractorb.sim import scenes
    from extractorb.slam.system import System

    frames, poses = scenes.render_loop_sequence(
        scenes.texture(SEED + 1, (1024, 4096)), n_frames)
    black = np.zeros_like(frames[0])
    b0, b1 = n_frames // 2 - 3, n_frames // 2 + 7      # 10-frame blackout
    ext = ORBExtractor(ORBConfig(), octree="device")
    descs = []
    for img in frames[::7]:
        f = jax.device_get(ext(jnp.asarray(img)))
        descs.append(f.desc[f.valid])
    vocab = Vocabulary.train(np.concatenate(descs, 0), k=8, L=3, seed=0)

    def session():
        s = System(SLAMConfig(
            orb=ORBConfig(), camera=_camera(),
            tracking=TrackingConfig(max_frames=3, pipeline_depth=3,
                                    time_recently_lost=0.05)), vocab=vocab)
        for k, im in enumerate(frames):
            s.track_monocular(black if b0 <= k < b1 else im, k / 30.0)
        s.flush()
        return s

    # count the solves that went through the device mesh (post-loop GBA,
    # inertial GBA, sharded essential graph): an Atlas merge closes the
    # revisit on this sequence and needs none of them
    mesh_solves = []
    make_mesh = dmesh.make_mesh
    dmesh.make_mesh = lambda *a, **k: mesh_solves.append(1) or make_mesh(*a, **k)
    ph = Phase(label, card)
    try:
        s = ph.run(session)
    finally:
        dmesh.make_mesh = make_mesh
    lc = s.tracker.loop_closer
    ph.check("loops_plus_merges", lc.n_loops + lc.n_merges, lc.n_loops + lc.n_merges >= 1)
    ph.check("gba_applied", lc.n_gba_applied, True)
    ph.check("devices_visible", len(jax.devices()), True)
    ph.check("mesh_solves", len(mesh_solves), True)
    ate, _, _ = _sim3_ate(s.tracker.final_trajectory(),
                          lambda ts: poses[int(round(ts * 30.0))])
    ph.check("ate_m", ate, ate < 0.30)
    ph.report(gpu)


# --------------------------------------------------------------------------
# --cards 4: sharded solvers vs single device


def _spread(x, n: int) -> bool:
    """True when ``x`` is split (not replicated) over ``n`` devices."""
    return len(x.sharding.device_set) == n and not x.sharding.is_fully_replicated


def _max_abs(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - np.asarray(b, np.float64)).max())


def multi_device_checks(devices, card, n_kf=300, n_pts=30000, obs_per_pt=10,
                        n_loops=300, report_device=None):
    """Every sharded solver on a mesh over ``devices`` against its
    single-device counterpart on the same seeded long-session problem.

    Tolerances: the sharded solvers take their float32 sums in another
    order (per-device partial sums, then a psum) and the GPU's scatter-
    adds are atomic, so results agree to float32 rounding amplified by
    the LM/PCG iterations, not bitwise."""
    import jax
    import jax.numpy as jnp

    from extractorb.dist import kf_blocks as kfb
    from extractorb.dist import mesh as dmesh
    from extractorb.dist import sharded_ba as dba
    from extractorb.dist import sharded_pose_graph as dpg
    from extractorb.sim import problems
    from extractorb.solver import inertial as vi
    from extractorb.solver import pose_graph as pg

    n = len(devices)
    mesh = jax.sharding.Mesh(np.asarray(devices), ("shard",))
    mesh1 = jax.sharding.Mesh(np.asarray(devices[:1]), ("shard",))
    dev = report_device or devices[0]

    def timed(fn, ph=None):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())        # compiles
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        warm = time.perf_counter() - t0
        if ph is not None:
            ph.cold_s, ph.warm_s = cold, warm
        return out, warm

    # global BA: landmark-sharded Schur LM, 1 device vs n
    prob, truth = problems.ba_problem(SEED, n_kf, n_pts, obs_per_pt)
    ph = Phase(f"gba schur 1 vs {n} devices", card)
    P = prob.points.shape[0]
    p1, pn = dba.relayout_for_schur(prob, 1), dba.relayout_for_schur(prob, n)
    r1, t1 = timed(lambda: dba.optimize_schur_sharded(mesh1, p1, problems.project_pinhole))
    rn, tn = timed(lambda: dba.optimize_schur_sharded(mesh, pn, problems.project_pinhole), ph)
    ph.check("observations", int(prob.obs_kf.shape[0]), True)
    ph.check("points_spread", _spread(rn.points, n), _spread(rn.points, n))
    ph.check("pose_t_diff_m", _max_abs(rn.t, r1.t), _max_abs(rn.t, r1.t) < 2e-3)
    ph.check("pose_R_diff", _max_abs(rn.R, r1.R), _max_abs(rn.R, r1.R) < 2e-3)
    ph.check("points_diff_m", _max_abs(rn.points[:P], r1.points[:P]),
             _max_abs(rn.points[:P], r1.points[:P]) < 2e-2)
    rel = abs(float(rn.cost) - float(r1.cost)) / max(float(r1.cost), 1e-9)
    ph.check("cost_rel_diff", rel, rel < 1e-2)
    ph.check("t_err_vs_truth_m", _max_abs(r1.t, truth.t), True)
    ph.check("solve_s_1dev", t1, True)
    ph.check(f"solve_s_{n}dev", tn, True)
    ph.report(dev)

    # inertial GBA: visual terms sharded, inertial chain replicated
    vprob, vtruth = problems.vi_problem(SEED, n_kf, n_pts, obs_per_pt)
    ph = Phase(f"vi gba 1 vs {n} devices", card)
    Pv = vprob.points.shape[0]
    P_pad = -(-Pv // n) * n
    pts = np.zeros((P_pad, 3), np.float32)
    pts[:, 2] = 1.0
    pts[:Pv] = np.asarray(vprob.points)
    fmp = np.ones(P_pad, bool)
    fmp[:Pv] = False
    okf, omp, ouv, osig, oval = dba.relayout_point_sharded(
        *(np.asarray(a) for a in (vprob.obs_kf, vprob.obs_mp, vprob.obs_uv,
                                  vprob.inv_sigma2, vprob.obs_valid)), P_pad, n)
    vprob_n = vprob._replace(points=jnp.asarray(pts), obs_kf=jnp.asarray(okf),
                             obs_mp=jnp.asarray(omp), obs_uv=jnp.asarray(ouv),
                             inv_sigma2=jnp.asarray(osig), obs_valid=jnp.asarray(oval),
                             fixed_mp=jnp.asarray(fmp))
    v1, t1 = timed(lambda: vi.optimize_vi_ba(vprob, problems.project_normalized))
    vn, tn = timed(lambda: dba.optimize_vi_sharded(mesh, vprob_n, problems.project_normalized), ph)
    ph.check("points_spread", _spread(vn.points, n), _spread(vn.points, n))
    ph.check("twb_diff_m", _max_abs(vn.twb, v1.twb), _max_abs(vn.twb, v1.twb) < 5e-3)
    ph.check("Rwb_diff", _max_abs(vn.Rwb, v1.Rwb), _max_abs(vn.Rwb, v1.Rwb) < 5e-3)
    ph.check("v_diff_mps", _max_abs(vn.v, v1.v), _max_abs(vn.v, v1.v) < 2e-2)
    ph.check("twb_err_vs_truth_m", _max_abs(vn.twb, vtruth.t), _max_abs(vn.twb, vtruth.t) < 0.05)
    ph.check("solve_s_1dev", t1, True)
    ph.check(f"solve_s_{n}dev", tn, True)
    ph.report(dev)

    # essential graph: edges sharded, vertices replicated; the System's
    # own settings (LoopCloser runs 15 LM iterations, the default)
    gprob, gtruth = problems.pose_graph_problem(SEED, n_kf, n_loops=n_loops)
    ph = Phase(f"pose graph 1 vs {n} devices", card)
    edges_n = jax.device_put(gprob.edge_i, dmesh.shard_leading(mesh))
    gprob_n = gprob._replace(edge_i=edges_n)
    g1, t1 = timed(lambda: pg.optimize_pose_graph(gprob))
    gn, tn = timed(lambda: dpg.optimize_sharded_pose_graph(mesh, gprob_n), ph)
    ph.check("edges", int(np.asarray(gprob.edge_valid).sum()), True)
    ph.check("edges_spread", _spread(edges_n, n), _spread(edges_n, n))
    # the measurements are noise-free, so both must reach truth; what
    # is left is float32 noise of the solve on a 30 m loop (max 4-6e-4 m
    # on one H100), and the two may sit on opposite sides of it
    tol = 2e-3
    ph.check("tolerance", f"{tol} (2x float32 noise of the exact solve)", True)
    ph.check("t_diff_m", _max_abs(gn[1], g1[1]), _max_abs(gn[1], g1[1]) < tol)
    ph.check("R_diff", _max_abs(gn[0], g1[0]), _max_abs(gn[0], g1[0]) < tol)
    ph.check("s_diff", _max_abs(gn[2], g1[2]), _max_abs(gn[2], g1[2]) < tol)
    err0 = float(np.linalg.norm(np.asarray(gprob.t) - gtruth.t, axis=1).max())
    for name, g in (("1dev", g1), (f"{n}dev", gn)):
        err = float(np.linalg.norm(np.asarray(g[1]) - gtruth.t, axis=1).max())
        ph.check(f"t_err_vs_truth_m_{name}", f"{err0:.4g}->{err:.4g}", err < tol)
    ph.check("solve_s_1dev", t1, True)
    ph.check(f"solve_s_{n}dev", tn, True)
    ph.report(dev)

    # keyframe-block place scores and covisibility fetch
    db = problems.place_problem(SEED, n_kf)
    ph = Phase(f"kf blocks on {n} devices", card)
    K = n_kf
    pad = lambda a, fill=0: kfb.pad_to_mesh(a, n, fill)
    hists = kfb.shard_kf_axis(mesh, jnp.asarray(pad(db["hists"])))
    scores, common = kfb.sharded_place_scores(
        mesh, hists, kfb.shard_kf_axis(mesh, jnp.asarray(pad(db["has_word"]))),
        kfb.shard_kf_axis(mesh, jnp.asarray(pad(db["valid"], False))),
        jnp.asarray(db["query"]))
    ref = 1.0 - 0.5 * np.abs(db["hists"] - db["query"][None]).sum(1)
    ref[~db["valid"]] = -np.inf
    got = np.asarray(scores)[:K]
    ph.check("hists_spread", _spread(hists, n), _spread(hists, n))
    finite = np.isfinite(ref)
    ph.check("score_diff", float(np.abs(got[finite] - ref[finite]).max()),
             np.allclose(got[finite], ref[finite], atol=1e-5)
             and (got[~finite] == -np.inf).all())
    ph.check("best_kf", int(np.argmax(got)), int(np.argmax(got)) == db["target"])
    idx = np.array([db["target"], 1, K - 1], np.int32)
    blocks = kfb.all_gather_kf_blocks(
        mesh, kfb.shard_kf_axis(mesh, jnp.asarray(pad(db["desc"]))), jnp.asarray(idx))
    ph.check("gather_exact", True, (np.asarray(blocks) == db["desc"][idx]).all())
    ph.report(dev)


# --------------------------------------------------------------------------


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the multi-device path on four cards")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    require_gpu(devices, args.cards)
    from extractorb.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    card = card_info()
    print(f"jax {jax.__version__}; devices {devices}; compile cache {cache}")
    print(f"card: {card}", flush=True)
    _count_compile_time()
    t0 = time.perf_counter()
    gpu = devices[0]
    if args.cards == 4:
        multi_device_checks(devices[:4], card)
        phase_loop(card, gpu, label="e loop/merge, 4 cards visible")
    else:
        phase_extraction(card, gpu, jax.devices("cpu")[0])
        phase_mono(card, gpu)
        phase_stereo_rgbd(card, gpu)
        phase_vi(card, gpu)
        phase_loop(card, gpu)
    total = time.perf_counter() - t0
    print(f"total_s={total:.6g} compile_s={_COMPILE_S[0]:.6g} "
          f"compile_share={_COMPILE_S[0] / total:.4g} | card: {card}")
    print(final_line(devices[:args.cards]))


if __name__ == "__main__":
    main()
