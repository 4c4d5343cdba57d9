"""Full ORB extractor demo (reference ORB_SLAM_Extractor,
src/orb_extractor/main_orb_extractor.cpp): CLAHE with timing, the full
extraction pass (pyramid -> FAST -> octree -> orientation ->
descriptors), per-level keypoint counts, and the OpenCV ORB oracle
comparison the reference prints side by side.

Run: python demos/demo_orb_extractor.py [--image PATH] [--out overlay.png]
"""

import numpy as np

from _common import default_parser, imread_gray, timer


def main():
    args = default_parser(__doc__).parse_args()
    img = imread_gray(args.image)

    import jax.numpy as jnp

    from _common import orb_config
    from extractorb.frontend.extractor import ORBExtractor
    from extractorb.utils.clahe import clahe

    # CLAHE timing (reference main_orb_extractor.cpp:19-25)
    jimg = jnp.asarray(img)
    enhanced = np.asarray(clahe(jimg))  # compile
    with timer("CLAHE (device)"):
        enhanced = np.asarray(clahe(jimg))

    cfg = orb_config(args, 1500)
    ext = ORBExtractor(cfg, octree="device")
    feats = ext(jimg)  # compile
    with timer("ORB extract (device)"):
        feats = ext(jimg)

    valid = np.asarray(feats.valid)
    octv = np.asarray(feats.octave)[valid]
    print(f"keypoints: {int(valid.sum())}")
    for lvl in range(cfg.n_levels):
        print(f"  level {lvl}: {(octv == lvl).sum()}")
    desc = np.asarray(feats.desc)[valid]
    print(f"descriptors: {desc.shape} uint8 ({desc.shape[1] * 8} bits)")

    # OpenCV ORB oracle (reference main_orb_extractor.cpp:75-81)
    try:
        import cv2

        orb = cv2.ORB_create(1500)
        kps = orb.detect(img, None)
        print(f"OpenCV ORB oracle: {len(kps)} keypoints")
    except Exception as e:  # pragma: no cover
        print(f"OpenCV oracle unavailable: {e}")

    if args.out:
        from extractorb.viz import FrameDrawer

        fd = FrameDrawer()
        fd.update(img, np.asarray(feats.xy), valid, state="OK")
        fd.save(args.out)
        print(f"overlay written to {args.out}")


if __name__ == "__main__":
    main()
