"""Quadtree keypoint-distribution demo (reference distribute_oct_tree,
src/oct_tree/main.cpp): pyramid + per-level FAST + DistributeOctTree
balancing, printing keypoint totals per level before/after distribution
and the OpenCV ORB comparison the reference shows (main.cpp:525-537).

Run: python demos/demo_distribute_oct_tree.py [--image PATH]
"""

import numpy as np

from _common import default_parser, imread_gray, timer


def main():
    args = default_parser(__doc__).parse_args()
    img = imread_gray(args.image)

    import jax.numpy as jnp

    from _common import orb_config
    from extractorb.frontend import fast as ffast
    from extractorb.frontend import octree as foct
    from extractorb.frontend import pyramid as fpyr
    from extractorb.frontend.pyramid import EDGE_THRESHOLD

    cfg = orb_config(args, 1000)  # the oct_tree demo's budget
    budgets = cfg.features_per_level

    levels = fpyr.compute_pyramid(
        jnp.asarray(img), cfg.n_levels, cfg.scale_factor
    )
    total = 0
    for lvl, bordered in enumerate(levels):
        with timer(f"level {lvl} FAST+octree"):
            keep, score = ffast.detect_keypoints(
                bordered, cfg.ini_th_fast, cfg.min_th_fast
            )
            xy, resp, valid = ffast.collect_keypoints(
                keep, score, cfg.max_kps_per_level
            )
            h, w = bordered.shape
            H, W = h - 2 * EDGE_THRESHOLD, w - 2 * EDGE_THRESHOLD
            mb = ffast.MIN_BORDER
            sel, depth = foct.distribute_device(
                xy, resp, valid, budgets[lvl], W - 2 * mb, H - 2 * mb, mb, mb
            )
            n_raw = int(np.asarray(valid).sum())
            n_kept = int(np.asarray(valid & sel).sum())
        print(
            f"level {lvl}: candidates={n_raw} -> distributed={n_kept} "
            f"(budget {budgets[lvl]}, quadtree depth {int(depth)})"
        )
        total += min(n_kept, budgets[lvl])
    print(f"total distributed keypoints: {total}")

    try:
        import cv2

        orb = cv2.ORB_create(cfg.n_features)
        print(f"OpenCV ORB oracle: {len(orb.detect(img, None))} keypoints")
    except Exception as e:  # pragma: no cover
        print(f"OpenCV oracle unavailable: {e}")


if __name__ == "__main__":
    main()
