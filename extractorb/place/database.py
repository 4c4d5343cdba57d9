"""Keyframe database: BoW place-recognition queries.

Replaces KeyFrameDatabase (reference: src/KeyFrameDatabase.cc:39 add,
:47 erase, :612 DetectNBestCandidates, :783
DetectRelocalizationCandidates).

Design: keyframe BoW vectors are stored SPARSE (per-KF sorted word ids
+ tf-idf weights, concatenated into one CSR arena), like the
reference's DBoW2::BowVector maps — at real ORBvoc scale (k=10, L=6 ~
1M words) a dense row would be ~4 MB/keyframe while the sparse entry is
~8 KB.  A query densifies ONCE into an (n_words,) scratch vector and
scores every stored keyframe with one gather + segment-sum over the
arena: for L1-normalised vectors

    score = 1 - 0.5 * |v - q|_1
          = 0.5 * sum_{shared words} (v_i + q_i - |v_i - q_i|)

so only shared-word entries contribute and the whole-database score is
a single vectorized pass (the DBoW2 inverted-file trick, recast as
array ops instead of per-word list walks).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


class KeyFrameDatabase:
    def __init__(self, vocab, capacity: int = 512):
        self.vocab = vocab
        # kf_id -> (word_ids int32, weights float32)
        self.entries: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        # CSR arena over all entries, rebuilt lazily after changes
        self._dirty = True
        self._cat_words: Optional[np.ndarray] = None   # (nnz,) int32
        self._cat_weights: Optional[np.ndarray] = None  # (nnz,) float32
        self._cat_row: Optional[np.ndarray] = None      # (nnz,) int32 row
        self._row_ids: Optional[np.ndarray] = None      # (K,) int64 kf ids
        # optional device-sharded scoring backend (dist/kf_blocks):
        # dense per-KF histograms sharded over the mesh, scored with one
        # dense pass per shard (SURVEY §5.7's place-retrieval sharding).
        # Dense rows are W floats each, so this backend is for compact
        # vocabularies (n_words <= max_dense_words); the host CSR stays
        # the default at ORBvoc scale (~1M words).
        self._mesh = None
        self._max_dense_words = 1 << 16
        self._rev = 0            # bumped on every mutation
        self._dev_rev = -1       # revision the device arena reflects
        self._dev_hists = None
        self._dev_words = None
        self._dev_valid = None

    def enable_device_backend(self, mesh, max_dense_words: int = 1 << 16):
        """Shard place scoring over the device mesh (exact same scores
        as the host CSR pass; see tests/test_place_sharded.py)."""
        self._mesh = mesh
        self._max_dense_words = max_dense_words
        self._dirty = True

    def _device_arena(self):
        from ..dist import kf_blocks as kfb

        if self._dev_hists is None or self._dev_rev != self._rev:
            self._dev_rev = self._rev
            cw, cwt, crow, row_ids = self._arena()
            K = len(row_ids)
            n_dev = int(np.prod(list(self._mesh.shape.values())))
            W = self.vocab.n_words
            hists = np.zeros((K, W), np.float32)
            hists[crow, cw] = cwt
            has = hists > 0
            valid = np.ones(K, bool)
            hists = kfb.pad_to_mesh(hists, n_dev)
            has = kfb.pad_to_mesh(has, n_dev)
            valid = kfb.pad_to_mesh(valid, n_dev)
            self._dev_hists = kfb.shard_kf_axis(self._mesh, hists)
            self._dev_words = kfb.shard_kf_axis(self._mesh, has)
            self._dev_valid = kfb.shard_kf_axis(self._mesh, valid)
        return self._dev_hists, self._dev_words, self._dev_valid

    def __len__(self) -> int:
        return len(self.entries)

    def nbytes(self) -> int:
        """Resident size of the stored vectors (bounded-memory check)."""
        return sum(w.nbytes + i.nbytes for i, w in self.entries.values())

    def add(self, kf_id: int, descs: np.ndarray, valid=None):
        ids, w = self.vocab.bow_sparse(descs, valid)
        self.entries[kf_id] = (ids, w)
        self._dirty = True
        self._rev += 1

    def rekey(self, old_id: int, new_id: int):
        """Rename an entry in place (used when Atlas maps merge and the
        welded keyframes receive new ids)."""
        e = self.entries.pop(old_id, None)
        if e is not None:
            self.entries[new_id] = e
            self._dirty = True
        self._rev += 1

    def erase(self, kf_id: int):
        """Drop a culled keyframe's entry (reference
        KeyFrameDatabase::erase, src/KeyFrameDatabase.cc:47)."""
        if self.entries.pop(kf_id, None) is not None:
            self._dirty = True
        self._rev += 1

    def _arena(self):
        if self._dirty:
            if self.entries:
                kf_ids = list(self.entries.keys())
                words = [self.entries[k][0] for k in kf_ids]
                weights = [self.entries[k][1] for k in kf_ids]
                lens = np.asarray([len(w) for w in words], np.int64)
                self._cat_words = np.concatenate(words)
                self._cat_weights = np.concatenate(weights)
                self._cat_row = np.repeat(
                    np.arange(len(kf_ids), dtype=np.int32), lens
                )
                self._row_ids = np.asarray(kf_ids, np.int64)
            else:
                self._cat_words = np.zeros(0, np.int32)
                self._cat_weights = np.zeros(0, np.float32)
                self._cat_row = np.zeros(0, np.int32)
                self._row_ids = np.zeros(0, np.int64)
            self._dirty = False
        return self._cat_words, self._cat_weights, self._cat_row, self._row_ids

    def min_score_against(self, keys, descs, valid=None):
        """Minimum L1 BoW score of the query against the given stored
        entries (reference DetectLoopCandidates' minScore loop over the
        current keyframe's covisibles, KeyFrameDatabase.cc:100 caller
        side at LoopClosing).  Returns None when no key is stored."""
        q_ids, q_w = self.vocab.bow_sparse(descs, valid)
        if len(q_ids) == 0:
            return None
        qv = np.zeros(self.vocab.n_words, np.float32)
        qv[q_ids] = q_w
        best = None
        for k in keys:
            e = self.entries.get(k)
            if e is None:
                continue
            ids, w = e
            qg = qv[ids]
            s = float(0.5 * np.sum(w + qg - np.abs(w - qg)))
            best = s if best is None else min(best, s)
        return best

    # --------------------------------------------------------------- query

    def query(
        self,
        descs: np.ndarray,
        valid=None,
        exclude: Optional[set] = None,
        n_best: int = 3,
        min_common_ratio: float = 0.8,
        covis_fn=None,
        rel_score_ratio: Optional[float] = None,
        min_score: Optional[float] = None,
    ) -> List[Tuple[int, float]]:
        """DetectNBestCandidates / DetectRelocalizationCandidates query
        (reference KeyFrameDatabase.cc:612-897): shared-word gate at
        min_common_ratio * max_common_words, then — when `covis_fn`
        provides each stored keyframe's covisibility group — accumulate
        scores over the group and return the best keyframe per group,
        ranked by accumulated score.

        covis_fn: kf_key -> iterable of kf_keys (top covisibles).
        rel_score_ratio: if set (reloc uses 0.75), return ALL groups with
        accScore >= ratio * best accScore instead of the top n_best.
        min_score: score floor (reference DetectLoopCandidates,
        KeyFrameDatabase.cc:100: candidates must beat the WORST score
        the query gets against its own covisibles — anything less
        similar than the query's own neighbourhood is noise).

        Returns [(kf_id, acc_score)] best-first.
        """
        if not self.entries:
            return []
        cw, cwt, crow, row_ids = self._arena()
        K = len(row_ids)

        q_ids, q_w = self.vocab.bow_sparse(descs, valid)
        if len(q_ids) == 0:
            return []
        qv = np.zeros(self.vocab.n_words, np.float32)
        qv[q_ids] = q_w

        if (self._mesh is not None
                and self.vocab.n_words <= self._max_dense_words):
            # device-sharded scoring (dist/kf_blocks): one dense pass per
            # shard over the dense histograms; mathematically identical
            # to the host segment sums below
            from ..dist import kf_blocks as kfb

            hists, has, dvalid = self._device_arena()
            sc, cm = kfb.sharded_place_scores(
                self._mesh, hists, has, dvalid, qv)
            scores = np.asarray(sc)[:K].astype(np.float64)
            common = np.asarray(cm)[:K].astype(np.int64)
        else:
            qg = qv[cw]                    # query weight at each stored word
            shared = qg > 0
            # common-word counts and L1 scores, one segment-sum each
            common = np.zeros(K, np.int64)
            np.add.at(common, crow[shared], 1)
            contrib = 0.5 * (cwt + qg - np.abs(cwt - qg))
            scores = np.zeros(K, np.float64)
            np.add.at(scores, crow, contrib)

        live = np.ones(K, bool)
        if exclude:
            ex = np.isin(row_ids, np.fromiter(exclude, np.int64,
                                              len(exclude)))
            live &= ~ex
        if not live.any():
            return []
        max_common = common[live].max()
        gate = live & (common >= min_common_ratio * max_common) & (common > 0)
        if min_score is not None:
            gate &= scores >= min_score
        if not gate.any():
            return []

        if covis_fn is None:
            idx = np.where(gate)[0]
            order = idx[np.argsort(-scores[idx])][:n_best]
            return [(int(row_ids[i]), float(scores[i])) for i in order]

        # covisibility-group accumulation: every word-sharing keyframe
        # contributes its score to the groups it belongs to; the group's
        # representative is its highest-scoring member
        sharing = live & (common > 0)
        score_of = {
            int(row_ids[r]): float(scores[r]) for r in np.where(sharing)[0]
        }
        groups: List[Tuple[float, int]] = []
        for r in np.where(gate)[0]:
            seed = int(row_ids[r])
            acc = score_of.get(seed, 0.0)
            best_kf, best_s = seed, acc
            for member in list(covis_fn(seed))[:10]:
                s = score_of.get(int(member))
                if s is None:
                    continue  # not word-sharing with the query
                acc += s
                if s > best_s:
                    best_kf, best_s = int(member), s
            groups.append((acc, best_kf))
        if not groups:
            return []
        groups.sort(key=lambda g: -g[0])
        out: List[Tuple[int, float]] = []
        seen: set = set()
        if rel_score_ratio is not None:
            min_acc = rel_score_ratio * groups[0][0]
            for acc, kf in groups:
                if acc < min_acc:
                    break
                if kf not in seen:
                    seen.add(kf)
                    out.append((kf, acc))
        else:
            for acc, kf in groups:
                if kf not in seen:
                    seen.add(kf)
                    out.append((kf, acc))
                if len(out) >= n_best:
                    break
        return out
