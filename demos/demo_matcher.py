"""Two-frame matcher demo (reference matcher,
src/matcher/main_matcher.cpp): extract two TUM-VI frames,
SearchForInitialization windowed matching, brute-force mutual-best
oracle comparison (the reference's cv::BFMatcher check, :243-250), then
two-view reconstruction (:265-271).

Run: python demos/demo_matcher.py [--img1 P] [--img2 P]
"""

import argparse
import os

import numpy as np

from _common import TUM_DIR, imread_gray, timer


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument(
        "--img1", default=os.path.join(TUM_DIR, "1520616233507152795.png")
    )
    p.add_argument(
        "--img2", default=os.path.join(TUM_DIR, "1520616233657157795.png")
    )
    p.add_argument("--features", type=int, default=None,
                   help="keypoint budget override (fast smoke mode)")
    args = p.parse_args()
    im1 = imread_gray(args.img1)
    im2 = imread_gray(args.img2)

    import jax
    import jax.numpy as jnp

    from _common import orb_config
    from extractorb.frontend import matcher as fm
    from extractorb.frontend.extractor import ORBExtractor
    from extractorb.geometry import two_view

    cfg = orb_config(args, 1500)
    ext = ORBExtractor(cfg, octree="device")
    f1 = ext(jnp.asarray(im1))
    f2 = ext(jnp.asarray(im2))
    n1 = int(np.asarray(f1.valid).sum())
    n2 = int(np.asarray(f2.valid).sum())
    print(f"keypoints: {n1} / {n2}")
    assert n1 > 100 and n2 > 100, "reference gate: >100 kps per frame"

    with timer("SearchForInitialization"):
        matches = np.asarray(
            fm.search_for_initialization(
                f1.desc, f1.xy, f1.angle, f1.octave, f1.valid,
                f2.desc, f2.xy, f2.angle, f2.octave, f2.valid,
            )
        )
    nmatches = int((matches >= 0).sum())
    print(f"SearchForInitialization matches: {nmatches}")

    # brute-force oracle (the reference compares against cv::BFMatcher)
    bf, _ = fm.mutual_best_match(f1.desc, f1.valid, f2.desc, f2.valid)
    print(f"brute-force mutual-best matches: {int((np.asarray(bf) >= 0).sum())}")

    # two-view reconstruction on the matched pairs
    idx1 = np.where(matches >= 0)[0]
    idx2 = matches[idx1]
    cap = 512
    x1 = np.zeros((cap, 2), np.float32)
    x2 = np.zeros((cap, 2), np.float32)
    val = np.zeros(cap, bool)
    k = min(len(idx1), cap)
    x1[:k] = np.asarray(f1.xy)[idx1[:k]]
    x2[:k] = np.asarray(f2.xy)[idx2[:k]]
    val[:k] = True
    # TUM-VI 512 fisheye: treat as approximate pinhole for the demo's
    # H/F model selection (the SLAM pipeline proper uses the KB8 model)
    K = jnp.asarray(
        [[190.978, 0, 254.932], [0, 190.973, 256.897], [0, 0, 1]],
        jnp.float32,
    )
    with timer("ReconstructWithTwoViews"):
        res = two_view.reconstruct(
            jax.random.PRNGKey(0), jnp.asarray(x1), jnp.asarray(x2),
            jnp.asarray(val), K,
        )
    print(
        f"reconstruction: success={bool(res.success)} "
        f"model={'H' if bool(res.used_homography) else 'F'} "
        f"triangulated={int(np.asarray(res.is_triangulated).sum())}"
    )
    if bool(res.success):
        print("R21=\n", np.asarray(res.R21))
        print("t21=", np.asarray(res.t21))


if __name__ == "__main__":
    main()
