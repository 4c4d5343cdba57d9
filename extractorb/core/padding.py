"""Padded/masked array utilities.

The reference uses dynamically sized std::vectors everywhere; this
design replaces them with fixed-capacity arrays + validity masks so every
jitted stage has static shapes (SURVEY.md §7 'hard parts').
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Sentinel used for invalid/padded integer slots.
INVALID = jnp.int32(-1)


def pad_to(x, n, fill=0, axis=0):
    """Pad (or truncate) `x` along `axis` to length `n`."""
    cur = x.shape[axis]
    if cur == n:
        return x
    if cur > n:
        sl = [slice(None)] * x.ndim
        sl[axis] = slice(0, n)
        return x[tuple(sl)]
    pad_width = [(0, 0)] * x.ndim
    pad_width[axis] = (0, n - cur)
    return jnp.pad(x, pad_width, constant_values=fill)


def masked_top_k(scores, mask, k):
    """Top-k of `scores` restricted to `mask`; returns (values, indices,
    valid) where valid marks slots whose index points at a real entry."""
    neg = jnp.finfo(scores.dtype).min
    s = jnp.where(mask, scores, neg)
    vals, idx = jax.lax.top_k(s, k)
    valid = vals > neg
    return vals, idx, valid


def compact_mask(mask, capacity):
    """Return indices of True entries, front-packed into `capacity` slots,
    padded with INVALID; plus the per-slot validity mask.

    Deterministic order (ascending index).  Used to convert a boolean
    detection map into a fixed-size keypoint list.
    """
    n = mask.shape[0]
    order = jnp.cumsum(mask.astype(jnp.int32)) - 1  # slot for each true entry
    slots = jnp.where(mask, order, n + capacity)
    idx_buf = jnp.full((capacity,), INVALID, jnp.int32)
    src = jnp.arange(n, dtype=jnp.int32)
    within = mask & (slots < capacity)
    idx_buf = idx_buf.at[jnp.where(within, slots, capacity - 1)].set(
        jnp.where(within, src, INVALID), mode="drop"
    )
    # "drop" can't drop in-range garbage writes, so route invalid writes to
    # an out-of-range slot instead:
    idx_buf = jnp.full((capacity,), INVALID, jnp.int32).at[
        jnp.where(within, slots, capacity + 1)
    ].set(src, mode="drop")
    valid = idx_buf >= 0
    return idx_buf, valid


def gather_rows(x, idx, fill=0):
    """x[idx] with idx==-1 slots replaced by `fill`."""
    safe = jnp.maximum(idx, 0)
    out = x[safe]
    m = (idx >= 0).reshape(idx.shape + (1,) * (out.ndim - idx.ndim))
    return jnp.where(m, out, fill)
