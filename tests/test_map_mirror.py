"""Incremental MapMirror sync (slam/track_device.py): the device mirror
must equal a from-scratch upload after arbitrary interleavings of point
creation, movement, invalidation, and map switches."""

import numpy as np
import pytest

from extractorb.slam.map import SLAMMap
from extractorb.slam.track_device import MapMirror


def _reference_state(mp, cap):
    pos = np.zeros((cap, 3), np.float32)
    valid = np.zeros((cap,), bool)
    n = mp._next_mp
    pos[: len(mp.mp_pos)] = mp.mp_pos
    valid[:n] = mp.mp_valid[:n]
    return pos, valid


def _check(mirror, mp):
    pos, valid = _reference_state(mp, mirror.cap)
    np.testing.assert_array_equal(np.asarray(mirror.valid), valid)
    np.testing.assert_allclose(np.asarray(mirror.pos), pos, rtol=0, atol=0)


def test_mirror_incremental_updates(rng):
    mp = SLAMMap()
    mp.mid = 7
    ids = [
        mp.add_point(rng.normal(size=3).astype(np.float32),
                     rng.integers(0, 255, 32).astype(np.uint8),
                     np.zeros(3, np.float32), 1.0, -1)
        for _ in range(50)
    ]
    m = MapMirror()
    m.sync(mp)
    _check(m, mp)

    # move a few points + invalidate some (BA apply / culling pattern)
    for p in ids[:10]:
        mp.mp_pos[p] += 0.5
    for p in ids[10:15]:
        mp.mp_valid[p] = False
    mp.version += 1
    m.sync(mp)
    _check(m, mp)

    # append new points (triangulation pattern)
    for _ in range(30):
        mp.add_point(rng.normal(size=3).astype(np.float32),
                     rng.integers(0, 255, 32).astype(np.uint8),
                     np.zeros(3, np.float32), 1.0, -1)
    m.sync(mp)
    _check(m, mp)

    # no-op sync (same version) keeps the same buffers
    pos_before = m.pos
    m.sync(mp)
    assert m.pos is pos_before

    # map switch forces a full re-upload
    mp2 = SLAMMap()
    mp2.mid = 8
    mp2.add_point(np.ones(3, np.float32), np.zeros(32, np.uint8),
                  np.zeros(3, np.float32), 1.0, -1)
    m.sync(mp2)
    _check(m, mp2)

    # and switching back re-mirrors the first map exactly
    m.sync(mp)
    _check(m, mp)


def test_mirror_large_change_falls_back_to_full(rng):
    mp = SLAMMap()
    mp.mid = 1
    for _ in range(64):
        mp.add_point(rng.normal(size=3).astype(np.float32),
                     rng.integers(0, 255, 32).astype(np.uint8),
                     np.zeros(3, np.float32), 1.0, -1)
    m = MapMirror()
    m.sync(mp)
    # rewrite every point: exceeds the incremental threshold path or
    # not, the result must still match
    mp.mp_pos[:64] = rng.normal(size=(64, 3)).astype(np.float32)
    mp.version += 1
    m.sync(mp)
    _check(m, mp)
