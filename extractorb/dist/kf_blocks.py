"""Keyframe-block sharding over the device mesh.

SURVEY.md §5.7's "long-context analog": the keyframe axis (descriptors,
BoW histograms, poses) shards over the mesh; place-recognition scoring
runs shard-locally, and the covisibility-window fetch — the
reference's pointer-chase through GetBestCovisibilityKeyFrames — becomes
an all_gather of the candidate keyframe blocks so any device can match
against them (a collective instead of shared memory).

The reference has no equivalent (single process, SURVEY.md §5.8); these
kernels are what lets the map outgrow one device's memory.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def pad_to_mesh(x: np.ndarray, n_dev: int, fill=0) -> np.ndarray:
    """Pad the leading (keyframe) axis to a multiple of the mesh size."""
    K = x.shape[0]
    Kp = ((K + n_dev - 1) // n_dev) * n_dev
    if Kp == K:
        return x
    pad = np.full((Kp - K,) + x.shape[1:], fill, x.dtype)
    return np.concatenate([x, pad], 0)


def shard_kf_axis(mesh: Mesh, x, axis: str = "shard"):
    return jax.device_put(x, NamedSharding(mesh, P(axis)))


def sharded_place_scores(
    mesh: Mesh,
    hists,       # (K, W) float32, KF axis sharded
    has_word,    # (K, W) bool,    KF axis sharded
    valid,       # (K,) bool,      KF axis sharded
    q_hist,      # (W,) float32, replicated
    axis: str = "shard",
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Place-recognition scoring against every stored keyframe: L1 BoW
    similarity (DBoW2 scoring) + shared-word counts, computed
    shard-locally (one dense pass per shard, no collective — the output
    stays sharded on the KF axis).

    Returns (scores (K,), common_words (K,)); invalid rows score -inf.
    """

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P()),
        out_specs=(P(axis), P(axis)),
        check_vma=False,
    )
    def run(h, w, v, q):
        diff = jnp.abs(h - q[None, :]).sum(1)
        scores = 1.0 - 0.5 * diff
        common = (w & (q > 0)[None, :]).sum(1).astype(jnp.int32)
        scores = jnp.where(v, scores, -jnp.inf)
        return scores, common

    return run(hists, has_word, valid, q_hist)


def all_gather_kf_blocks(
    mesh: Mesh,
    blocks,            # (K, ...) KF-axis sharded array (desc/pose blocks)
    idx,               # (M,) int32 global keyframe indices, replicated
    axis: str = "shard",
):
    """Covisibility-window fetch: gather the blocks of the requested
    keyframes from whatever shard holds them, delivering the result to
    EVERY device (reference: LoopClosing/LocalMapping walking covisible
    KeyFrame pointers; here an all_gather).

    Returns (M, ...) replicated.
    """

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(local, want):
        full = jax.lax.all_gather(local, axis, tiled=True)  # (K, ...)
        return full[want]

    return run(blocks, idx)


def sharded_loop_candidate_match(
    mesh: Mesh,
    kf_desc,     # (K, N, 32) uint8, KF axis sharded
    kf_valid,    # (K, N) bool, KF axis sharded
    q_desc,      # (Nq, 32) uint8, replicated
    q_valid,     # (Nq,) bool, replicated
    axis: str = "shard",
):
    """Distributed descriptor matching of a query keyframe against every
    stored keyframe: each device runs the bit-plane Hamming matcher over its
    KF shard; returns per-KF mutual-best match counts (K,), sharded.

    The host argmaxes the (logically global) count vector to pick loop
    candidates — the distributed analog of SearchByBoW over the whole
    database.
    """
    from ..frontend.matcher import hamming_matrix, TH_LOW

    @functools.partial(
        jax.shard_map, mesh=mesh,
        in_specs=(P(axis), P(axis), P(), P()),
        out_specs=P(axis),
        check_vma=False,
    )
    def run(desc, val, qd, qv):
        def per_kf(d, v):
            dist = hamming_matrix(qd, d)  # (Nq, N)
            INF = jnp.int32(1 << 20)
            dm = jnp.where(qv[:, None] & v[None, :], dist, INF)
            best12 = jnp.argmin(dm, axis=1)
            best21 = jnp.argmin(dm, axis=0)
            mutual = best21[best12] == jnp.arange(dm.shape[0])
            ok = mutual & (jnp.min(dm, axis=1) <= TH_LOW) & qv
            return jnp.sum(ok.astype(jnp.int32))

        return jax.vmap(per_kf)(desc, val)

    return run(kf_desc, kf_valid, q_desc, q_valid)
