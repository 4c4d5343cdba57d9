"""Vocabulary tree + keyframe database tests."""

import cv2
import glob
import numpy as np
import pytest
import jax.numpy as jnp

from extractorb.config import ORBConfig
from extractorb.frontend.extractor import ORBExtractor
from extractorb.place.database import KeyFrameDatabase
from extractorb.place.vocab import Vocabulary, _hamming_np


@pytest.fixture(scope="module")
def frames_desc():
    ext = ORBExtractor(ORBConfig(n_features=500), octree="device")
    paths = sorted(glob.glob("/root/reference/pic/robot/*.jpg"))[:8]
    out = []
    for p in paths:
        img = cv2.imread(p, 0)
        f = ext(jnp.asarray(img))
        v = np.asarray(f.valid)
        out.append(np.asarray(f.desc)[v])
    return out


@pytest.fixture(scope="module")
def vocab(frames_desc):
    descs = np.concatenate(frames_desc[:5], 0)
    return Vocabulary.train(descs, k=8, L=3, seed=0)


def test_vocab_structure(vocab):
    assert vocab.n_words > 100
    assert (vocab.weights >= 0).all()


def test_transform_assigns_nearest_path(vocab, frames_desc):
    d = frames_desc[0][:200]
    words = vocab.transform_words(d)
    assert words.min() >= 0 and words.max() < vocab.n_words
    # identical descriptors get identical words
    words2 = vocab.transform_words(d)
    assert np.array_equal(words, words2)
    # many distinct words used (discriminative)
    assert len(np.unique(words)) > 50


def test_bow_self_similarity(vocab, frames_desc):
    """A frame must score itself higher than a different frame."""
    db = KeyFrameDatabase(vocab, capacity=16)
    for i, d in enumerate(frames_desc):
        db.add(i, d)
    # robot 865..872 sequence then 1847/2195 series: query with a noisy
    # subset of frame 0's descriptors
    q = frames_desc[0][::2]
    res = db.query(q, n_best=3)
    assert res, "no candidates"
    assert res[0][0] == 0, res


def test_db_erase(vocab, frames_desc):
    db = KeyFrameDatabase(vocab, capacity=16)
    for i, d in enumerate(frames_desc[:4]):
        db.add(i, d)
    db.erase(0)
    res = db.query(frames_desc[0], n_best=2)
    assert all(k != 0 for k, _ in res)


def test_db_exclude(vocab, frames_desc):
    db = KeyFrameDatabase(vocab, capacity=16)
    for i, d in enumerate(frames_desc[:4]):
        db.add(i, d)
    res = db.query(frames_desc[0], exclude={0}, n_best=2)
    assert all(k != 0 for k, _ in res)


def test_db_covisibility_group_accumulation(vocab, frames_desc, rng):
    """DetectNBestCandidates group accumulation (reference
    KeyFrameDatabase.cc:612-897): several medium-similarity keyframes in
    one covisibility group must outrank an isolated keyframe whose
    single score is higher, and the group's REPRESENTATIVE (best single
    score inside the group) is returned."""
    query = frames_desc[0]
    n = len(query)
    half = n // 2

    def mixed(frac, seed):
        """descriptor set sharing `frac` of the query's descriptors."""
        r = np.random.default_rng(seed)
        out = query.copy()
        k = int(n * (1 - frac))
        rows = r.choice(n, k, replace=False)
        out[rows] = r.integers(0, 256, (k, 32), np.uint8)
        return out

    db = KeyFrameDatabase(vocab, capacity=16)
    # group A: keyframes 1,2,3 covisible, each ~45% similar
    db.add(1, mixed(0.45, 1))
    db.add(2, mixed(0.50, 2))
    db.add(3, mixed(0.45, 3))
    # isolated keyframe 9: 60% similar (best single score)
    db.add(9, mixed(0.60, 9))
    groups = {1: [2, 3], 2: [1, 3], 3: [1, 2], 9: []}

    flat = db.query(query, n_best=1)
    assert flat[0][0] == 9  # single-score ranking picks the loner

    grouped = db.query(query, n_best=2, covis_fn=lambda k: groups[k])
    # group {1,2,3} accumulates ~1.4 vs the loner's ~0.6
    assert grouped[0][0] == 2, grouped  # representative = best in group
    assert grouped[0][1] > grouped[1][1]
    assert grouped[1][0] == 9

    # reloc mode: only groups within 0.75x of the best accumulated score
    reloc = db.query(query, covis_fn=lambda k: groups[k],
                     rel_score_ratio=0.75)
    assert [k for k, _ in reloc] == [2]


class _BigVocabStub:
    """ORBvoc-scale stand-in (k=10, L=6 ~ 1e6 words): hashes descriptors
    to word ids so the database layer can be exercised at real-vocabulary
    width without training a tree."""

    def __init__(self, n_words=1_000_000):
        self.n_words = n_words
        self.weights = None  # unused: bow_sparse overridden

    def bow_sparse(self, descs, valid=None):
        d = np.asarray(descs)
        if valid is not None:
            d = d[np.asarray(valid)]
        if len(d) == 0:
            return np.zeros(0, np.int32), np.zeros(0, np.float32)
        # stable hash of each 32-byte descriptor into [0, n_words)
        h = (d.astype(np.uint64) * (np.arange(32, dtype=np.uint64) * 2 + 1)
             ).sum(1) % np.uint64(self.n_words)
        ids, counts = np.unique(h.astype(np.int64), return_counts=True)
        w = counts.astype(np.float32)
        w /= w.sum()
        return ids.astype(np.int32), w


def test_db_scale_bounded_memory(rng):
    """At 1M-word vocabulary width, 200 stored keyframes must stay
    sparse (<< 1 MB total vs ~800 MB dense) and the query must still
    rank the true revisit first."""
    vocab = _BigVocabStub()
    db = KeyFrameDatabase(vocab)
    base = rng.integers(0, 256, (500, 32), dtype=np.uint8)
    for i in range(200):
        d = rng.integers(0, 256, (500, 32), dtype=np.uint8)
        db.add(i, d)
    # keyframe 123 re-observes `base` with 30% descriptor noise
    noisy = base.copy()
    rows = rng.choice(500, 150, replace=False)
    noisy[rows] = rng.integers(0, 256, (150, 32), np.uint8)
    db.add(123, noisy)

    assert db.nbytes() < 2_000_000, db.nbytes()  # sparse: ~4KB/KF
    res = db.query(base, n_best=3)
    assert res and res[0][0] == 123, res

    db.erase(123)
    res = db.query(base, n_best=3)
    assert all(k != 123 for k, _ in res)
