"""Frame-construction demo (reference `frame` target, src/main_frame.cpp):
full Frame machinery on a TUM-VI 512 fisheye image with the KB8 camera
and a BoW vocabulary — extract, (no) undistortion for fisheye, 64x48
grid assignment, BoW transform — with the reference's >100-keypoint gate
(main_frame.cpp:106).

Run: python demos/demo_frame.py [--image P] [--vocab P.npz|ORBvoc.txt]
"""

import os

import numpy as np

from _common import TUM_DIR, TUM_KB8, default_parser, imread_gray, timer


def main():
    p = default_parser(__doc__, image=os.path.join(TUM_DIR, "1520616233507152795.png"))
    p.add_argument("--vocab", default=None, help="vocabulary (.npz or ORBvoc.txt)")
    args = p.parse_args()
    img = imread_gray(args.image)

    import jax.numpy as jnp

    from _common import orb_config
    from extractorb.core.camera import KannalaBrandt8
    from extractorb.frontend import grid as fg
    from extractorb.frontend.extractor import ORBExtractor

    cfg = orb_config(args, 1500)
    ext = ORBExtractor(cfg, octree="device")
    with timer("extract"):
        feats = ext(jnp.asarray(img))
    n = int(np.asarray(feats.valid).sum())
    print(f"keypoints: {n}")
    assert n > 100, "reference gate: mvKeys.size() > 100 (main_frame.cpp:106)"

    # KB8 fisheye: keypoints stay raw (reference keeps mvKeysUn == mvKeys)
    cam = KannalaBrandt8(
        jnp.float32(TUM_KB8["fx"]), jnp.float32(TUM_KB8["fy"]),
        jnp.float32(TUM_KB8["cx"]), jnp.float32(TUM_KB8["cy"]),
        jnp.asarray(
            [TUM_KB8["k1"], TUM_KB8["k2"], TUM_KB8["k3"], TUM_KB8["k4"]],
            jnp.float32,
        ),
    )
    xy = np.asarray(feats.xy)
    rays = np.asarray(cam.unproject(jnp.asarray(xy)))
    reproj = np.asarray(cam.project(jnp.asarray(rays)))
    ok = np.asarray(feats.valid)
    err = np.abs(reproj[ok] - xy[ok]).max() if ok.any() else 0.0
    print(f"KB8 project(unproject(kp)) max err: {err:.4f} px")

    h, w = img.shape
    bounds = jnp.asarray([0.0, float(w), 0.0, float(h)], jnp.float32)
    grid, counts = fg.assign_features_to_grid(
        jnp.asarray(xy), bounds, feats.valid
    )
    occ = int((np.asarray(counts) > 0).sum())
    print(f"grid: {occ}/{fg.FRAME_GRID_ROWS * fg.FRAME_GRID_COLS} cells occupied, "
          f"max {int(np.asarray(counts).max())} kps/cell")

    # BoW transform (Frame::ComputeBoW, src/Frame.cc:739-746)
    from extractorb.place.vocab import Vocabulary, load_orbvoc_text

    desc = np.asarray(feats.desc)
    if args.vocab and args.vocab.endswith(".txt"):
        voc = load_orbvoc_text(args.vocab)
    elif args.vocab:
        voc = Vocabulary.load(args.vocab)
    else:
        train = desc[np.asarray(feats.valid)]
        voc = Vocabulary.train(train, k=8, L=2, seed=0)
        print("(trained a small on-the-fly vocabulary; pass --vocab for a real one)")
    bow = voc.bow_vector(desc, np.asarray(feats.valid))
    nz = int((bow > 0).sum())
    print(f"BoW: {nz} active words of {voc.n_words}")


if __name__ == "__main__":
    main()
