"""Whole-extractor demo (reference `whole_extractor` target,
src/main_whole_orb_extractor.cpp): the ORB extractor driven through the
real per-frame machinery — per-level keypoint budgets, octree
distribution, orientation, descriptors — with per-level statistics and
an OpenCV-ORB oracle comparison like the reference demos print.

Run: python demos/demo_whole_extractor.py [--image P] [--out overlay.png]
"""

import numpy as np

from _common import default_parser, imread_gray, timer


def main():
    args = default_parser(__doc__).parse_args()
    img = imread_gray(args.image)

    import jax.numpy as jnp

    from _common import orb_config
    from extractorb.frontend.extractor import ORBExtractor

    cfg = orb_config(args, 1000)
    ext = ORBExtractor(cfg, octree="host")  # reference-exact distribution
    with timer("extract (host octree)"):
        feats = ext(jnp.asarray(img))

    octave = np.asarray(feats.octave)
    valid = np.asarray(feats.valid)
    print(f"total keypoints: {int(valid.sum())} (budget {cfg.n_features})")
    for lvl in range(cfg.n_levels):
        n_l = int((valid & (octave == lvl)).sum())
        print(f"  level {lvl}: {n_l} kps (budget {ext.budgets[lvl]})")

    desc = np.asarray(feats.desc)[valid]
    print(f"descriptors: {desc.shape[0]} x 256 bits, "
          f"mean bit density {(np.unpackbits(desc, axis=1).mean()):.3f}")

    # OpenCV oracle, like main_whole_orb_extractor's ORB::create check
    try:
        import cv2

        orb = cv2.ORB_create(nfeatures=cfg.n_features)
        kps = orb.detect(img, None)
        print(f"OpenCV ORB oracle: {len(kps)} keypoints")
    except Exception as e:  # pragma: no cover
        print(f"(OpenCV oracle unavailable: {e})")

    if args.out:
        import cv2

        vis = cv2.cvtColor(img, cv2.COLOR_GRAY2BGR)
        for (x, y), ok in zip(np.asarray(feats.xy), valid):
            if ok:
                cv2.circle(vis, (int(x), int(y)), 3, (0, 255, 0), 1)
        cv2.imwrite(args.out, vis)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
