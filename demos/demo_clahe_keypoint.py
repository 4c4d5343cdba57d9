"""Extractor on raw vs CLAHE-enhanced image (reference
clahe_img_keypoint, src/clahe/main_show_clahe_keypoint.cpp:19-25):
the reference displays both keypoint sets side by side; here we print
the counts and optionally write both overlays.

Run: python demos/demo_clahe_keypoint.py [--image PATH] [--out prefix]
"""

import numpy as np

from _common import default_parser, imread_gray


def main():
    args = default_parser(__doc__).parse_args()
    img = imread_gray(args.image)

    import jax.numpy as jnp

    from _common import orb_config
    from extractorb.frontend.extractor import ORBExtractor
    from extractorb.utils.clahe import clahe

    cfg = orb_config(args, 1500)
    ext = ORBExtractor(cfg, octree="device")

    enhanced = np.asarray(clahe(jnp.asarray(img)))
    f_raw = ext(jnp.asarray(img))
    f_enh = ext(jnp.asarray(enhanced))
    n_raw = int(np.asarray(f_raw.valid).sum())
    n_enh = int(np.asarray(f_enh.valid).sum())
    print(f"keypoints raw image:   {n_raw}")
    print(f"keypoints CLAHE image: {n_enh}")

    if args.out:
        from extractorb.viz import FrameDrawer

        fd = FrameDrawer()
        fd.update(img, np.asarray(f_raw.xy), np.asarray(f_raw.valid))
        fd.save(f"{args.out}_raw.png")
        fd.update(enhanced, np.asarray(f_enh.xy), np.asarray(f_enh.valid))
        fd.save(f"{args.out}_clahe.png")
        print(f"overlays: {args.out}_raw.png, {args.out}_clahe.png")


if __name__ == "__main__":
    main()
