"""Vocabulary tree for place recognition.

Replaces the vendored DBoW2 (reference: Thirdparty/DBoW2/DBoW2/
TemplatedVocabulary.h:44, FORB.cpp:81 popcount distance;
Frame::ComputeBoW uses transform() at src/Frame.cc:744).

Design: the tree is stored level-wise as dense arrays — at each of
the L levels a node has up to k children whose 256-bit descriptors live
in one (n_nodes, k, 32) table — so transform() is L batched Hamming
argmins (bit-plane matmuls) instead of a per-descriptor
pointer chase.

Because the reference's ORBvoc.txt is a stripped blob
(.MISSING_LARGE_BLOBS), a vocabulary can be (a) trained from descriptor
samples with binary k-means (bitwise-majority medoids, the binary
analog of DBoW2's k-means++ step) or (b) loaded from a standard
ORBvoc.txt if the user provides one.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def _hamming_np(a, b):
    """(N,32) x (M,32) uint8 -> (N,M) int popcount distances."""
    abits = np.unpackbits(a, axis=1)
    bbits = np.unpackbits(b, axis=1)
    return (abits[:, None, :] != bbits[None, :, :]).sum(-1)


def _majority(descs: np.ndarray) -> np.ndarray:
    """Bitwise-majority centroid of (N,32) uint8 descriptors (the binary
    mean used by DBoW2's kmeans step)."""
    bits = np.unpackbits(descs, axis=1)
    maj = (bits.mean(0) >= 0.5).astype(np.uint8)
    return np.packbits(maj)


@dataclasses.dataclass
class Vocabulary:
    """Level-wise dense vocabulary tree.

    children_desc[l]: (n_nodes_l, k, 32) child descriptors at level l
    children_id[l]:   (n_nodes_l, k) node row in level l+1 (or word id at
                      the last level); -1 for missing children
    weights: (n_words,) idf weights
    """

    k: int
    L: int
    children_desc: list
    children_id: list
    weights: np.ndarray

    @property
    def n_words(self) -> int:
        return len(self.weights)

    # ------------------------------------------------------------- train

    @staticmethod
    def train(
        descs: np.ndarray, k: int = 10, L: int = 4, seed: int = 0,
        iters: int = 8,
    ) -> "Vocabulary":
        rng = np.random.default_rng(seed)

        def kmeans(data):
            if len(data) <= k:
                return data.copy(), np.arange(len(data)) % max(len(data), 1)
            centers = data[rng.choice(len(data), k, replace=False)]
            assign = None
            for _ in range(iters):
                d = _hamming_np(data, centers)
                assign = d.argmin(1)
                new = []
                for c in range(k):
                    m = assign == c
                    if m.any():
                        new.append(_majority(data[m]))
                    else:
                        new.append(data[rng.integers(len(data))])
                centers = np.stack(new)
            return centers, assign

        # recursive construction, level by level
        levels_desc = []
        levels_id = []
        current = [descs]  # clusters to split at this level
        word_count = 0
        for lvl in range(L):
            nd = np.zeros((len(current), k, 32), np.uint8)
            nid = np.full((len(current), k), -1, np.int64)
            next_clusters = []
            for i, data in enumerate(current):
                if len(data) == 0:
                    continue
                centers, assign = kmeans(data)
                for c in range(len(centers)):
                    nd[i, c] = centers[c]
                    if lvl == L - 1:
                        nid[i, c] = word_count
                        word_count += 1
                    else:
                        nid[i, c] = len(next_clusters)
                        next_clusters.append(data[assign == c])
                # fill unused child slots with the first centre (distance
                # ties resolve to the real child)
                for c in range(len(centers), k):
                    nd[i, c] = centers[0]
                    nid[i, c] = nid[i, 0]
            levels_desc.append(nd)
            levels_id.append(nid)
            current = next_clusters

        voc = Vocabulary(k, L, levels_desc, levels_id, np.ones(word_count))
        # idf weights from the training corpus
        words = voc.transform_words(descs)
        counts = np.bincount(words, minlength=word_count) + 1
        voc.weights = np.log(len(descs) / counts)
        voc.weights = np.maximum(voc.weights, 0.0)
        return voc

    # --------------------------------------------------------- transform

    def _device_tables(self):
        if not hasattr(self, "_dev"):
            self._dev = (
                [jnp.asarray(d) for d in self.children_desc],
                [jnp.asarray(i.astype(np.int32)) for i in self.children_id],
            )
        return self._dev

    def transform_words(self, descs: np.ndarray) -> np.ndarray:
        """(N,32) -> (N,) word ids (host convenience wrapper)."""
        return np.asarray(self.transform_words_device(jnp.asarray(descs)))

    def transform_words_device(self, descs: jnp.ndarray) -> jnp.ndarray:
        """Descend the tree: L batched Hamming argmins."""
        dtabs, itabs = self._device_tables()

        bits = _unpack_bits_f(descs)  # (N,256)
        node = jnp.zeros((descs.shape[0],), jnp.int32)
        for lvl in range(self.L):
            cd = dtabs[lvl][node]          # (N,k,32)
            cbits = _unpack_bits_f(cd.reshape(-1, 32)).reshape(
                descs.shape[0], self.k, 256
            )
            # hamming = sum(a) + sum(b) - 2 a.b
            dots = jnp.einsum("nb,nkb->nk", bits, cbits)
            d = bits.sum(1)[:, None] + cbits.sum(2) - 2 * dots
            best = jnp.argmin(d, axis=1)
            node = jnp.take_along_axis(itabs[lvl][node], best[:, None], 1)[:, 0]
        return node  # word ids

    def bow_vector(self, descs: np.ndarray, valid=None) -> np.ndarray:
        """L1-normalised tf-idf histogram (n_words,) float32."""
        words = self.transform_words(descs)
        if valid is not None:
            words = words[np.asarray(valid)]
        hist = np.bincount(words, minlength=self.n_words).astype(np.float32)
        hist *= self.weights.astype(np.float32)
        n = hist.sum()
        return hist / n if n > 0 else hist

    def bow_sparse(self, descs: np.ndarray, valid=None):
        """Sparse L1-normalised tf-idf BoW: (word_ids int32 sorted
        unique, weights float32).  At real ORBvoc scale (k=10, L=6 ~ 1M
        words) a frame touches <=its keypoint count of words, so the
        sparse form is ~1000 entries instead of a 4 MB dense row
        (KeyFrameDatabase uses this; reference DBoW2::BowVector is the
        same sparse map)."""
        words = self.transform_words(descs)
        if valid is not None:
            words = words[np.asarray(valid)]
        ids, counts = np.unique(words, return_counts=True)
        w = counts.astype(np.float32) * self.weights[ids].astype(np.float32)
        n = w.sum()
        if n > 0:
            w /= n
        keep = w > 0
        return ids[keep].astype(np.int32), w[keep]

    # ------------------------------------------------------------ save/load

    def save(self, path: str):
        np.savez_compressed(
            path,
            k=self.k, L=self.L, weights=self.weights,
            **{f"desc{l}": d for l, d in enumerate(self.children_desc)},
            **{f"id{l}": i for l, i in enumerate(self.children_id)},
        )

    @staticmethod
    def load(path: str) -> "Vocabulary":
        z = np.load(path)
        k, L = int(z["k"]), int(z["L"])
        return Vocabulary(
            k, L,
            [z[f"desc{l}"] for l in range(L)],
            [z[f"id{l}"] for l in range(L)],
            z["weights"],
        )


def _unpack_bits_f(desc_u8: jnp.ndarray) -> jnp.ndarray:
    n = desc_u8.shape[0]
    shifts = jnp.arange(8, dtype=jnp.uint8)
    bits = (desc_u8[:, :, None] >> shifts[None, None, :]) & 1
    return bits.reshape(n, 256).astype(jnp.float32)


def load_orbvoc_text(path: str) -> Vocabulary:
    """Parse the standard ORBvoc.txt format (DBoW2 saveToTextFile):
    header 'k L scoring weighting', then ONE NODE PER LINE in node-id
    order starting at node id 1 (the root, id 0, is implicit):
    'parent_id is_leaf d0..d31 weight'.  Parent fields are DBoW2 node
    ids, so the root's children carry parent_id 0 and line i (0-based)
    is node id i+1.  The reference loads this at src/System.cc:82; the
    blob itself is stripped from the mount
    (.MISSING_LARGE_BLOBS).

    The level-wise dense tables require every root->word path to have
    length L; words that end early (unbalanced trees — real ORBvoc.txt
    has them) descend through synthetic passthrough rows whose children
    all repeat the word's descriptor, so the Hamming-argmin descent
    reaches the same word id at the last level.
    """
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        parents = []    # by (node id - 1)
        is_leaf = []
        descs = []
        weights = []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            is_leaf.append(int(parts[1]) != 0)
            descs.append([int(v) for v in parts[2:34]])
            weights.append(float(parts[34]))
    descs = np.asarray(descs, np.uint8)
    weights_arr = np.asarray(weights)

    # node id -> children node ids (ids are 1-based; root is 0)
    children = {}
    for i, p in enumerate(parents):
        children.setdefault(p, []).append(i + 1)

    def leaf(nid):
        return is_leaf[nid - 1] or not children.get(nid)

    levels_desc, levels_id = [], []
    # entries: ("node", nid) expands its children; ("word", nid, wid)
    # is a passthrough for a word that ended above the last level
    current = [("node", 0)]
    word_count = 0
    word_of = {}
    for lvl in range(L):
        nd = np.zeros((len(current), k, 32), np.uint8)
        nid = np.full((len(current), k), -1, np.int64)
        nxt = []
        for row, entry in enumerate(current):
            if entry[0] == "word":
                _, wnid, wid = entry
                nd[row, :] = descs[wnid - 1]
                if lvl == L - 1:
                    nid[row, :] = wid
                else:
                    nid[row, :] = len(nxt)
                    nxt.append(entry)
                continue
            _, fid = entry
            ch = children.get(fid, [])
            for c, cid in enumerate(ch[:k]):
                nd[row, c] = descs[cid - 1]
                if leaf(cid):
                    wid = word_of.get(cid)
                    if wid is None:
                        wid = word_count
                        word_of[cid] = wid
                        word_count += 1
                    if lvl == L - 1:
                        nid[row, c] = wid
                    else:
                        nid[row, c] = len(nxt)
                        nxt.append(("word", cid, wid))
                else:
                    nid[row, c] = len(nxt)
                    nxt.append(("node", cid))
            for c in range(len(ch), k):
                if ch:
                    # pad unused slots with the first child (distance
                    # ties resolve to the real child)
                    nd[row, c] = descs[ch[0] - 1]
                    nid[row, c] = nid[row, 0]
        levels_desc.append(nd)
        levels_id.append(nid)
        current = nxt

    w = np.zeros(word_count)
    for cid, wid in word_of.items():
        w[wid] = weights_arr[cid - 1]
    return Vocabulary(k, L, levels_desc, levels_id, w)


def save_orbvoc_text(voc: Vocabulary, path: str):
    """Write a Vocabulary in the DBoW2 saveToTextFile format (the format
    load_orbvoc_text reads and the reference loads at src/System.cc:82).

    Nodes get DBoW2 ids in breadth-first order (root = 0, ids written
    in order, parent fields reference node ids).  Padded child slots
    (duplicates of child 0) are skipped."""
    lines = []
    next_id = 1
    # queue entries: (level, row, dbow_parent_id)
    queue = [(0, 0, 0)]
    while queue:
        lvl, row, parent = queue.pop(0)
        nd = voc.children_desc[lvl][row]
        nid = voc.children_id[lvl][row]
        for c in range(voc.k):
            if nid[c] < 0 or (c > 0 and nid[c] == nid[0]):
                continue  # missing / padded duplicate slot
            my_id = next_id
            next_id += 1
            d = " ".join(str(int(v)) for v in nd[c])
            if lvl == voc.L - 1:
                wgt = float(voc.weights[int(nid[c])])
                lines.append(f"{parent} 1 {d} {wgt!r}")
            else:
                lines.append(f"{parent} 0 {d} 0.0")
                queue.append((lvl + 1, int(nid[c]), my_id))
    with open(path, "w") as f:
        f.write(f"{voc.k} {voc.L}  0 0\n")
        f.write("\n".join(lines) + "\n")
