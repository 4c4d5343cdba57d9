"""Benchmark: frames/s per card for the per-frame hot path
(extract + match + motion-only BA) on 640x480 frames, 1000 keypoints,
plus whole-system cells on seeded scenes (extractorb.sim.scenes).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"device", ...}.  Needs a GPU; there is no CPU fallback.

Methodology: the whole frame step (ORB extraction -> bit-plane Hamming
matching against the previous frame's features -> 4x10 robust pose
optimisation) runs as a lax.scan INSIDE one XLA program, with the input
image varied on-device per iteration, and the result is forced with a
host fetch.  Device time per frame = (T(N) - T(1)) / (N - 1), an
estimate that subtracts dispatch and transfer latency; whether it is
still needed on a local card is an open question.

Baseline: the reference publishes no numbers (BASELINE.md); ORB-SLAM3's
paper-reported ~30 frames/s desktop-CPU tracking is the yardstick, so
vs_baseline = our_fps / 30.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BASELINE_FPS = 30.0
N_LONG = 32


def _timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def main():
    import jax
    import jax.numpy as jnp

    from extractorb.config import ORBConfig
    from extractorb.frontend import matcher as fm
    from extractorb.frontend.extractor import ORBExtractor
    from extractorb.sim import scenes
    from extractorb.solver import pose_opt as spo
    from extractorb.utils.compile_cache import enable_compile_cache

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"bench: needs a GPU, JAX found {devices}")
    enable_compile_cache()
    device = {"platform": devices[0].platform,
              "kind": devices[0].device_kind, "count": len(devices)}

    img = jnp.asarray(scenes.render_sequence(scenes.texture(0), 1)[0][0])

    cfg = ORBConfig(n_features=1000)
    ext = ORBExtractor(cfg, octree="device")

    fx, fy, cx, cy = 500.0, 500.0, 320.0, 240.0

    def project(pc):
        return jnp.stack(
            [fx * pc[0] / pc[2] + cx, fy * pc[1] / pc[2] + cy], -1
        ).reshape(2)

    N = 2048
    rng = np.random.default_rng(1)
    pts = np.stack(
        [rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N), rng.uniform(3, 8, N)],
        -1,
    ).astype(np.float32)
    uvs = np.stack(
        [fx * pts[:, 0] / pts[:, 2] + cx, fy * pts[:, 1] / pts[:, 2] + cy], -1
    ).astype(np.float32)
    pts_j = jnp.asarray(pts)
    uv_j = jnp.asarray(uvs)
    ones = jnp.ones(N, jnp.float32)
    mask = jnp.ones(N, bool)
    eye = jnp.eye(3, dtype=jnp.float32)
    zero3 = jnp.zeros(3, jnp.float32)

    def make_runner(length):
        @jax.jit
        def run(im, prev_feats, seed):
            def frame_step(carry, _):
                prev, acc = carry
                im2 = jnp.roll(im, acc.astype(jnp.int32) % 11, axis=0)
                f = ext(im2)
                matches = fm.search_for_initialization(
                    f.desc, f.xy, f.angle, f.octave, f.valid,
                    prev.desc, prev.xy, prev.angle, prev.octave, prev.valid,
                )
                pose = spo.optimize_pose(
                    eye, zero3, pts_j, uv_j, ones, mask, project
                )
                acc = (
                    acc
                    + jnp.sum((matches >= 0).astype(jnp.float32)) * 1e-6
                    + pose.t[0] * 1e-6
                    + f.response.sum() * 1e-9
                )
                return (f, acc), None

            (f, acc), _ = jax.lax.scan(
                frame_step, (prev_feats, seed), None, length=length
            )
            return acc

        return run

    prev = ext(img)
    runN = make_runner(N_LONG)
    # compile + warm
    float(runN(img, prev, jnp.float32(0.0)))

    # fetch/dispatch overhead estimated with a trivial program
    @jax.jit
    def tiny(seed):
        return seed + 1.0

    float(tiny(jnp.float32(0.0)))
    t_overhead = min(
        _timed(lambda: float(tiny(jnp.float32(s)))) for s in (1.0, 2.0, 3.0)
    )
    tN = min(
        _timed(lambda: float(runN(img, prev, jnp.float32(s))))
        for s in (4.0, 5.0, 6.0)
    )
    per_frame = max((tN - t_overhead) / N_LONG, 1e-9)
    fps = 1.0 / per_frame

    extra = _full_slam_bench()
    extra.update(_stereo_bench())
    extra.update(_vi_bench())
    extra.update(_loop_bench())

    print(
        json.dumps(
            {
                "metric": "frames/s/card (extract+match+pose-BA, 640x480, 1000 kps)",
                "value": round(fps, 2),
                "unit": "frames/s",
                "vs_baseline": round(fps / BASELINE_FPS, 3),
                "device": device,
                **extra,
            }
        )
    )


def _full_slam_bench():
    """End-to-end System.track_monocular wall-clock fps + Sim3-aligned
    ATE against the synthetic sequence's exact ground truth (the
    self-produced accuracy baseline BASELINE.md calls for)."""
    try:
        from extractorb.config import (
            CameraConfig, ORBConfig, SLAMConfig, TrackingConfig,
        )
        from extractorb.sim.scenes import (
            H, W, render_sequence, texture, umeyama_align,
        )
        from extractorb.slam.system import System

        tex = texture(0)

        def run(frames):
            cfg = SLAMConfig(
                orb=ORBConfig(n_features=1000),
                camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                                    width=W, height=H),
                tracking=TrackingConfig(max_frames=6, pipeline_depth=8),
            )
            s = System(cfg)
            t0 = time.perf_counter()
            states = [s.track_monocular(im, k / 30.0)
                      for k, im in enumerate(frames)]
            s.flush()   # settle in-flight pipelined frames (timed)
            dt = time.perf_counter() - t0
            return s, states, dt

        def ate_of(s, poses):
            traj = s.tracker.final_trajectory()
            est = np.array([-R.T @ t for _, R, t in traj])
            gt = np.array([
                -poses[int(round(ts * 30.0))][0].T
                @ poses[int(round(ts * 30.0))][1]
                for ts, _, _ in traj
            ])
            if len(est) < 3:
                return float("nan")
            aligned = umeyama_align(est, gt)
            return float(np.sqrt(((aligned - gt) ** 2).sum(-1).mean()))

        # scenario A: the r1-r3 14-frame sequence (ATE continuity);
        # scenario B: 40 frames at half speed — enough steady-state
        # frames that the fps reflects a long-running session (the
        # reference's ~30 fps CPU yardstick is steady-state tracking)
        frames_a, poses_a = render_sequence(tex, n_frames=14)
        frames_b, poses_b = render_sequence(tex, n_frames=40, speed=0.06)
        run(frames_b)  # compile warmup — B's longer run covers every
        run(frames_a)  # program/bucket shape; A warms its own extras
        # best-of-2; how far one sample varies on a local card is not
        # measured yet
        s_a, states_a, dt_a = run(frames_a)
        s_b, states_b, dt_b = run(frames_b)
        s_a2, _, dt_a2 = run(frames_a)
        s_b2, _, dt_b2 = run(frames_b)
        if dt_a2 < dt_a:
            s_a, dt_a = s_a2, dt_a2
        if dt_b2 < dt_b:
            s_b, dt_b = s_b2, dt_b2

        return {
            "slam_fps": round(len(frames_b) / dt_b, 2),
            "slam_fps_14": round(len(frames_a) / dt_a, 2),
            "ate_synth_m": round(ate_of(s_a, poses_a), 4),
            "ate_synth_40_m": round(ate_of(s_b, poses_b), 4),
            # post-flush committed count (per-call pipelined states are
            # optimistic): only frames that actually tracked land in the
            # trajectory, and gate-failing batches are replayed before
            # flush() returns
            "slam_frames_ok": len(s_b.tracker.trajectory),
            "slam_frames": len(frames_b),
        }
    except Exception as e:  # pragma: no cover — keep the primary metric
        return {"slam_bench_error": str(e)[:200]}


def _stereo_bench():
    """Stereo whole-system fps on the fused/pipelined path (in-program
    right-image extraction + rectified stereo match + 3-dim stereo
    residuals; BASELINE config 5's visual half).  Metric-scale error is
    reported directly (no Sim3 alignment — stereo pins scale)."""
    try:
        from extractorb.config import (
            CameraConfig, ORBConfig, SLAMConfig, TrackingConfig,
        )
        from extractorb.sim.scenes import (
            BF, H, W, render_stereo_pair, texture,
        )
        from extractorb.slam.system import System

        n_frames = 30
        frames_l, frames_r, poses = render_stereo_pair(texture(0), n_frames)

        def run():
            cfg = SLAMConfig(
                orb=ORBConfig(n_features=1000),
                camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                                    width=W, height=H, bf=BF, th_depth=40.0),
                tracking=TrackingConfig(max_frames=6, pipeline_depth=8),
                sensor="stereo",
            )
            s = System(cfg)
            t0 = time.perf_counter()
            for k, (il, ir) in enumerate(zip(frames_l, frames_r)):
                s.track_stereo(il, ir, k / 30.0)
            s.flush()
            return s, time.perf_counter() - t0

        run()
        s, dt = run()
        s2, dt2 = run()     # best-of-2
        if dt2 < dt:
            s, dt = s2, dt2
        traj = s.tracker.final_trajectory()
        est = np.array([-(R.T @ t) for _, R, t in traj])
        gt = np.array([
            -(poses[int(round(ts * 30.0))][0].T
              @ poses[int(round(ts * 30.0))][1])
            for ts, _, _ in traj
        ])
        err = float(np.sqrt(((est - gt) ** 2).sum(-1).mean()))
        return {
            "slam_fps_stereo": round(n_frames / dt, 2),
            "ate_stereo_metric_m": round(err, 4),
        }
    except Exception as e:  # pragma: no cover
        return {"stereo_bench_error": str(e)[:200]}


def _vi_bench():
    """Visual-inertial whole-system fps + metric-scale recovery on the
    synthetic VI sequence (the staged IMU init runs legacy; once
    gravity/scale resolve, frames ride the fused inertial one-program
    path: IMU prediction + in-program joint pose-inertial optimization
    with the marginalization-prior chain)."""
    try:
        from extractorb.config import (
            CameraConfig, IMUConfig, ORBConfig, SLAMConfig, TrackingConfig,
        )
        from extractorb.sim.scenes import (
            H, VI_FPS, W, render_vi_sequence, texture, umeyama_align,
            vi_imu_window, vi_pose,
        )
        from extractorb.slam.system import System

        n_frames = 40
        imu_hz = 200.0
        frames, poses = render_vi_sequence(texture(0), n_frames=n_frames)

        def run():
            cfg = SLAMConfig(
                orb=ORBConfig(n_features=1000),
                camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                                    width=W, height=H, fps=VI_FPS),
                imu=IMUConfig(noise_gyro=1e-4, noise_acc=1e-3,
                              gyro_walk=1e-6, acc_walk=1e-5,
                              frequency=imu_hz),
                tracking=TrackingConfig(max_frames=3, pipeline_depth=3),
                sensor="imu-monocular",
            )
            s = System(cfg)
            t0 = time.perf_counter()
            for k, img in enumerate(frames):
                ts = k / VI_FPS
                imu = (vi_imu_window((k - 1) / VI_FPS, ts, imu_hz)
                       if k else None)
                s.track_monocular(img, ts, imu=imu)
            s.flush()
            return s, time.perf_counter() - t0

        run()
        s, dt = run()
        s2, dt2 = run()     # best-of-2
        if dt2 < dt:
            s, dt = s2, dt2
        traj = s.tracker.final_trajectory()
        est = np.array([-R.T @ t for _, R, t in traj])
        gt = np.array([
            -vi_pose(ts)[0].T @ vi_pose(ts)[1] for ts, _, _ in traj
        ])
        aligned, scale = umeyama_align(est, gt, return_scale=True)
        ate = float(np.sqrt(((aligned - gt) ** 2).sum(-1).mean()))
        return {
            "slam_fps_vi": round(n_frames / dt, 2),
            "ate_vi_m": round(ate, 4),
            "vi_scale_err": round(abs(scale - 1.0), 4),
            "vi_fused_frames": s.tracker.n_fused_frames,
        }
    except Exception as e:  # pragma: no cover
        return {"vi_bench_error": str(e)[:200]}


def _loop_bench():
    """Loop-closure scenario (BASELINE config 4 analog): a 100-frame
    out-and-back sweep with a blackout at the turnaround, driven with a
    trained vocabulary through the full System.  The blackout severs
    tracking into a fresh Atlas map; on the way back, place recognition
    must weld the maps (reference LoopClosing merge path).  Reports the
    post-correction ATE, the number of loop/merge events, and the
    maximum single-frame stall (the latency cost of the loop event —
    correction + weld BA + GBA dispatch all land on one frame)."""
    try:
        import jax.numpy as jnp

        from extractorb.config import (
            CameraConfig, ORBConfig, SLAMConfig, TrackingConfig,
        )
        from extractorb.frontend.extractor import ORBExtractor
        from extractorb.place.vocab import Vocabulary
        from extractorb.sim.scenes import (
            H, W, render_loop_sequence, texture, umeyama_align,
        )
        from extractorb.slam.system import System

        n_frames = 100
        frames, poses = render_loop_sequence(texture(1, (1024, 4096)),
                                             n_frames=n_frames)
        black = np.zeros((H, W), np.uint8)
        b0, b1 = n_frames // 2 - 3, n_frames // 2 + 7  # 10-frame blackout

        ext = ORBExtractor(ORBConfig(n_features=1000), octree="device")
        descs = []
        for img in frames[::7]:
            f = ext(jnp.asarray(img))
            descs.append(np.asarray(f.desc)[np.asarray(f.valid)])
        vocab = Vocabulary.train(np.concatenate(descs, 0), k=8, L=3, seed=0)

        def run():
            cfg = SLAMConfig(
                orb=ORBConfig(n_features=1000),
                camera=CameraConfig(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                                    width=W, height=H),
                tracking=TrackingConfig(max_frames=3, pipeline_depth=3,
                                        time_recently_lost=0.05),
            )
            s = System(cfg, vocab=vocab)
            stalls = []
            for k, im in enumerate(frames):
                if b0 <= k < b1:
                    im = black
                t0 = time.perf_counter()
                s.track_monocular(im, k / 30.0)
                stalls.append(time.perf_counter() - t0)
            s.flush()
            return s, stalls

        run()              # program warmup (incl. merge/weld/GBA paths)
        s, stalls = run()

        traj = s.tracker.final_trajectory()
        est = np.array([-R.T @ t for _, R, t in traj])
        gt = np.array([
            -poses[int(round(ts * 30.0))][0].T
            @ poses[int(round(ts * 30.0))][1]
            for ts, _, _ in traj
        ])
        aligned = umeyama_align(est, gt)
        ate = float(np.sqrt(((aligned - gt) ** 2).sum(-1).mean()))
        lc = s.tracker.loop_closer
        return {
            "ate_loop_m": round(ate, 4),
            "n_loops": lc.n_loops + lc.n_merges,
            "loop_frames_tracked": len(traj),
            "max_frame_stall_ms": round(max(stalls[3:]) * 1000.0, 1),
        }
    except Exception as e:  # pragma: no cover
        return {"loop_bench_error": str(e)[:200]}


if __name__ == "__main__":
    main()
