"""ORBvoc.txt text-format load path (reference: System.cc:82
loadFromTextFile; format written by DBoW2 TemplatedVocabulary::
saveToTextFile — node lines in id order starting at 1, parent fields
are node ids with the implicit root at id 0)."""

import numpy as np

from extractorb.place.vocab import (
    Vocabulary, load_orbvoc_text, save_orbvoc_text,
)


def _brute_force_words(descs, nodes, k):
    """Oracle: per-descriptor pointer-chase descent over the raw node
    table (the DBoW2 way), returning the winning LEAF NODE id."""

    def ham(a, b):
        return int((np.unpackbits(a) != np.unpackbits(b)).sum())

    children = {}
    for nid, (parent, leaf, d, w) in nodes.items():
        children.setdefault(parent, []).append(nid)
    out = []
    for q in descs:
        cur = 0
        while True:
            ch = children.get(cur)
            if not ch:
                break
            cur = min(ch, key=lambda c: (ham(q, nodes[c][2]), ch.index(c)))
            if nodes[cur][1]:
                break
        out.append(cur)
    return out


def test_round_trip_transform_parity(tmp_path, rng):
    """train -> save_orbvoc_text -> load_orbvoc_text reproduces the
    exact transform (same word for every descriptor) and weights."""
    descs = rng.integers(0, 256, (600, 32), dtype=np.uint8)
    voc = Vocabulary.train(descs, k=4, L=3, seed=0)
    p = tmp_path / "voc.txt"
    save_orbvoc_text(voc, str(p))
    voc2 = load_orbvoc_text(str(p))

    assert voc2.k == voc.k and voc2.L == voc.L
    assert voc2.n_words == voc.n_words

    q = rng.integers(0, 256, (256, 32), dtype=np.uint8)
    w1 = voc.transform_words(q)
    w2 = voc2.transform_words(q)
    # word ids may be renumbered by the BFS; require a consistent
    # bijection AND identical weights through it
    mapping = {}
    for a, b in zip(w1, w2):
        assert mapping.setdefault(int(a), int(b)) == int(b), (a, b)
    inv = {}
    for a, b in mapping.items():
        assert inv.setdefault(b, a) == a
        np.testing.assert_allclose(voc.weights[a], voc2.weights[b],
                                   rtol=1e-6)


def test_exact_dbow2_file_format(tmp_path, rng):
    """A hand-written file in the exact DBoW2 text layout (root id 0
    implicit, parent fields = node ids, leaf flag, 32 byte ints, float
    weight) parses into a tree whose transform matches a brute-force
    pointer-chase descent — including a word that ends ABOVE the last
    level (unbalanced tree, as in the real ORBvoc.txt)."""
    rows = rng.integers(0, 256, (16, 32), dtype=np.uint8)
    # nodes: id -> (parent, is_leaf, desc, weight).  k=2, L=2.
    # node 1 is an EARLY leaf (a word at level 1); node 2 expands into
    # two level-2 words (nodes 3, 4).
    nodes = {
        1: (0, True, rows[0], 1.5),
        2: (0, False, rows[1], 0.0),
        3: (2, True, rows[2], 0.25),
        4: (2, True, rows[3], 2.0),
    }
    lines = ["2 2  0 0"]
    for nid in sorted(nodes):
        parent, leaf, d, w = nodes[nid]
        ds = " ".join(str(int(v)) for v in d)
        lines.append(f"{parent} {int(leaf)} {ds} {w}")
    p = tmp_path / "voc.txt"
    p.write_text("\n".join(lines) + "\n")

    voc = load_orbvoc_text(str(p))
    assert voc.k == 2 and voc.L == 2
    assert voc.n_words == 3

    q = rng.integers(0, 256, (64, 32), dtype=np.uint8)
    got = voc.transform_words(q)
    want_leaf = _brute_force_words(q, nodes, k=2)

    # consistent leaf-node -> word-id mapping with matching weights
    mapping = {}
    for leaf_nid, wid in zip(want_leaf, got):
        assert mapping.setdefault(leaf_nid, int(wid)) == int(wid)
        np.testing.assert_allclose(
            voc.weights[int(wid)], nodes[leaf_nid][3], rtol=1e-6
        )
