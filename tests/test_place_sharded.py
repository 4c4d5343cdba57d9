"""Device-sharded place scoring (dist/kf_blocks wired into
KeyFrameDatabase): exact same candidates as the host CSR pass."""

import numpy as np

from extractorb.dist import mesh as dmesh
from extractorb.place.database import KeyFrameDatabase
from extractorb.place.vocab import Vocabulary


def _make_db(rng, device=False):
    descs = rng.integers(0, 256, (800, 32), dtype=np.uint8)
    vocab = Vocabulary.train(descs, k=6, L=3, seed=0)
    db = KeyFrameDatabase(vocab)
    if device:
        db.enable_device_backend(dmesh.make_mesh(8))
    kfs = []
    for k in range(20):
        d = rng.integers(0, 256, (300, 32), dtype=np.uint8)
        db.add(k, d)
        kfs.append(d)
    return db, kfs


def test_sharded_scores_match_host(rng):
    rng2 = np.random.default_rng(0)
    db_h, kfs = _make_db(rng, device=False)
    db_d, _ = _make_db(rng2, device=True)

    for qi in (0, 7, 13):
        q = kfs[qi]
        got_h = db_h.query(q, n_best=5)
        got_d = db_d.query(q, n_best=5)
        assert [k for k, _ in got_h] == [k for k, _ in got_d]
        for (_, sh), (_, sd) in zip(got_h, got_d):
            np.testing.assert_allclose(sh, sd, rtol=1e-4, atol=1e-5)


def test_sharded_backend_tracks_mutations(rng):
    rng2 = np.random.default_rng(0)
    db_h, kfs = _make_db(rng, device=False)
    db_d, _ = _make_db(rng2, device=True)
    for db in (db_h, db_d):
        db.erase(3)
        db.rekey(7, 99)
    q = kfs[5]
    got_h = db_h.query(q, n_best=8)
    got_d = db_d.query(q, n_best=8)
    assert [k for k, _ in got_h] == [k for k, _ in got_d]
