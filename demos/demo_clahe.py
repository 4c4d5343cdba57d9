"""Bare CLAHE demo (reference clahe, src/clahe/main_clahe.cpp:7-11):
clip limit 3.0, 8x8 tiles, against the OpenCV oracle.

Run: python demos/demo_clahe.py [--image PATH] [--out enhanced.png]
"""

import numpy as np

from _common import default_parser, imread_gray, timer


def main():
    args = default_parser(__doc__).parse_args()
    img = imread_gray(args.image)

    import jax.numpy as jnp

    from extractorb.utils.clahe import clahe

    out = np.asarray(clahe(jnp.asarray(img)))  # compile
    with timer("CLAHE (device)"):
        out = np.asarray(clahe(jnp.asarray(img)))
    print(f"input  mean/std: {img.mean():.1f} / {img.std():.1f}")
    print(f"output mean/std: {out.mean():.1f} / {out.std():.1f}")

    try:
        import cv2

        ref = cv2.createCLAHE(clipLimit=3.0, tileGridSize=(8, 8)).apply(img)
        err = np.abs(ref.astype(int) - out.astype(int))
        print(
            f"vs OpenCV CLAHE: mean |diff| = {err.mean():.2f}, "
            f"max = {err.max()}"
        )
    except Exception as e:  # pragma: no cover
        print(f"OpenCV oracle unavailable: {e}")

    if args.out:
        import imageio.v2 as imageio

        imageio.imwrite(args.out, out)
        print(f"written to {args.out}")


if __name__ == "__main__":
    main()
