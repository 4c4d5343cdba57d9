"""Loop closing routes big essential graphs through the edge-sharded
multi-device pose graph (dist/sharded_pose_graph) — same fixed point as
the single-device path (reference scale story: the essential graph is
built over ALL keyframes, Optimizer.cc:2303)."""

import numpy as np

from extractorb.place.vocab import Vocabulary
from extractorb.slam.loop_closing import LoopCloser, LoopThresholds

from test_loop_closing import build_looped_map, project

TH = LoopThresholds(n_proj_matches=50, n_proj_opt_matches=60, n_proj_rep=60)


def _run(mp, desc, min_edges):
    vocab = Vocabulary.train(desc, k=8, L=3, seed=0)
    lc = LoopCloser(vocab, project, thresholds=TH, async_gba=True)
    lc.sharded_graph_min_edges = min_edges
    for kid in sorted(mp.keyframes.keys()):
        if lc.process_keyframe(mp, kid):
            return lc
    raise AssertionError("loop not detected")


def test_sharded_graph_matches_single_device(rng):
    """The same loop correction through the sharded essential graph
    (threshold 1: every graph sharded over the 8-device mesh) vs the
    single-device path (threshold huge) lands on matching keyframe
    poses."""
    mp_a, _, desc_a = build_looped_map(rng)
    rng2 = np.random.default_rng(0)
    mp_b, _, desc_b = build_looped_map(rng2)

    _run(mp_a, desc_a, min_edges=1)          # sharded
    _run(mp_b, desc_b, min_edges=10 ** 9)    # single-device

    for k in mp_a.keyframes:
        Ca = -mp_a.keyframes[k].R.T @ mp_a.keyframes[k].t
        Cb = -mp_b.keyframes[k].R.T @ mp_b.keyframes[k].t
        np.testing.assert_allclose(Ca, Cb, atol=2e-3)
        np.testing.assert_allclose(
            mp_a.keyframes[k].R, mp_b.keyframes[k].R, atol=2e-3
        )
