"""Shared plumbing for the demo scripts (reference: the glog-init +
imread prologue every demo main repeats, e.g.
src/orb_extractor/main_orb_extractor.cpp:8-25)."""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from extractorb.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

REFERENCE_PIC = "/root/reference/pic"
LUNA = os.path.join(REFERENCE_PIC, "luna.jpg")
TUM_DIR = os.path.join(REFERENCE_PIC, "TUM", "dataset-corridor2_512_16")

# TUM-VI 512 fisheye calibration hard-coded by the reference demos
# (src/matcher/main_matcher.cpp:95-100)
TUM_KB8 = dict(
    fx=190.97847715128717, fy=190.9733070521226,
    cx=254.93170605935475, cy=256.8974428996504,
    k1=0.0034823894022493434, k2=0.0007150348452162257,
    k3=-0.0020532361418706202, k4=0.00020293673591811182,
)


def imread_gray(path: str) -> np.ndarray:
    import cv2

    img = cv2.imread(path, cv2.IMREAD_GRAYSCALE)
    if img is None:
        raise SystemExit(f"cannot read {path}")
    return img


def default_parser(desc: str, image: str = LUNA) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--image", default=image)
    p.add_argument("--out", default=None, help="write the overlay PNG here")
    p.add_argument(
        "--features", type=int, default=None,
        help="override the keypoint budget (small values compile much "
             "faster; used by the smoke tests)",
    )
    return p


def orb_config(args, default_features: int):
    """ORBConfig honoring the --features fast-mode override."""
    from extractorb.config import ORBConfig

    n = args.features if getattr(args, "features", None) else default_features
    # shrink the padded per-level capacity with the budget: compile time
    # on small smoke runs is dominated by the padded shapes
    cap = 4096 if n >= 1000 else 1024
    return ORBConfig(n_features=n, max_kps_per_level=cap)


class timer:
    def __init__(self, label):
        self.label = label

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *a):
        print(f"{self.label}: {(time.perf_counter() - self.t0) * 1e3:.2f} ms")
