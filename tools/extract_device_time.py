"""Device time of one frame's ORB extraction, read from a profiler trace.

    python tools/extract_device_time.py [ROOT ...] [--frames N] [--rounds R]

Each ROOT is a checkout (default: this one); the package under it that
holds ``frontend/extractor.py`` is imported, and its device-octree
extractor runs on one seeded 640x480 frame at the package defaults.
With two roots the rounds go A B B A, R times, so two versions are
compared on one card in one process.  Per round, N warm frames are
traced; the device time per frame is the union of the intervals in
which a kernel or a copy ran on the GPU, divided by N, and the wall time
per frame is N back-to-back frames on the host clock, without the
tracer.  Needs a GPU.
"""

from __future__ import annotations

import argparse
import glob
import importlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_package(root: str):
    """The package under ``root`` that holds ``frontend/extractor.py``."""
    hits = sorted(glob.glob(os.path.join(root, "*", "frontend", "extractor.py")))
    if not hits:
        raise SystemExit(f"no package with frontend/extractor.py under {root}")
    name = os.path.basename(os.path.dirname(os.path.dirname(hits[0])))
    mod = sys.modules.get(name)
    if mod is not None:
        if os.path.dirname(os.path.dirname(mod.__file__)) != os.path.abspath(root):
            raise SystemExit(f"package {name} is already imported from another root")
        return mod
    sys.path.insert(0, os.path.abspath(root))
    try:
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


def busy_ns(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s >= end:
            total, end = total + (e - s), e
        elif e > end:
            total, end = total + (e - end), e
    return total


def device_busy_ns(xplane_path: str) -> int:
    """Busy time of the GPU planes of one trace: kernels and copies on
    the stream lines (not the derived "XLA Modules"/"XLA Ops" lines)."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(xplane_path)
    spans, seen = [], []
    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            seen.append(f"{plane.name}/{line.name}")
            if line.name.startswith("Stream"):
                spans += [(e.start_ns, e.start_ns + e.duration_ns) for e in line.events]
    if not spans:
        raise SystemExit(f"no GPU stream events in the trace; lines: {seen}")
    return busy_ns(spans)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="*", default=[ROOT])
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"extract_device_time: needs a GPU, JAX found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]

    sys.path.insert(0, ROOT)
    from extractorb.sim import scenes
    sys.path.pop(0)
    img = jax.device_put(jnp.asarray(scenes.render_sequence(scenes.texture(0), 1)[0][0]), dev)

    extract = {}
    for root in args.roots:
        pkg = load_package(root)
        config = importlib.import_module(pkg.__name__ + ".config")
        extractor = importlib.import_module(pkg.__name__ + ".frontend.extractor")
        fn = extractor.ORBExtractor(config.ORBConfig(), octree="device")
        t0 = time.perf_counter()
        jax.block_until_ready(fn(img))
        print(f"{root}: package {pkg.__name__}, first call {time.perf_counter() - t0:.6g} s",
              flush=True)
        extract[root] = fn

    order = args.roots if len(args.roots) == 1 else \
        [args.roots[0], args.roots[1], args.roots[1], args.roots[0]]
    res = {r: {"device_ms": [], "wall_ms": []} for r in args.roots}
    n = args.frames
    for _ in range(args.rounds):
        for root in order:
            fn = extract[root]
            jax.block_until_ready(fn(img))
            t0 = time.perf_counter()
            outs = [fn(img) for _ in range(n)]
            jax.block_until_ready(outs)
            res[root]["wall_ms"].append((time.perf_counter() - t0) / n * 1e3)
            with tempfile.TemporaryDirectory() as d:
                jax.profiler.start_trace(d)
                jax.block_until_ready([fn(img) for _ in range(n)])
                jax.profiler.stop_trace()
                path = glob.glob(os.path.join(d, "**", "*.xplane.pb"), recursive=True)[0]
                res[root]["device_ms"].append(device_busy_ns(path) / n / 1e6)
    for root, r in res.items():
        r["device_ms_median"] = statistics.median(r["device_ms"])
        r["wall_ms_median"] = statistics.median(r["wall_ms"])
        print(f"{root}: device {r['device_ms_median']:.6g} ms/frame "
              f"(rounds {[f'{v:.6g}' for v in r['device_ms']]}), wall "
              f"{r['wall_ms_median']:.6g} ms/frame | {dev.device_kind} | card: {card}")
    print(json.dumps({"device": {"platform": dev.platform, "kind": dev.device_kind},
                      "card": card, "frames": n, "results": res}))


if __name__ == "__main__":
    main()
