"""CLAHE preprocessing (contrast-limited adaptive histogram equalisation).

Replaces the reference's cv::createCLAHE(3.0, (8,8)) experiment stage
(src/clahe/main_clahe.cpp:7-11, main_orb_extractor.cpp:19-25, timed as
the 'CLAHE wall-clock' baseline row).

Design: per-tile histograms as one one-hot contraction,
vectorised clip + redistribute, per-tile LUT cdf, and bilinear LUT
interpolation over the pixel grid — one jit, no loops.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnums=(1, 2))
def clahe(img: jnp.ndarray, clip_limit: float = 3.0, tiles: int = 8) -> jnp.ndarray:
    """uint8 (H, W) -> uint8 (H, W).  H and W should be divisible by
    `tiles` (callers can pad; OpenCV pads internally too)."""
    H, W = img.shape
    th, tw = H // tiles, W // tiles
    Hc, Wc = th * tiles, tw * tiles
    x = img[:Hc, :Wc]

    t = x.reshape(tiles, th, tiles, tw).transpose(0, 2, 1, 3).reshape(
        tiles * tiles, th * tw
    )
    # per-tile histogram via one-hot contraction
    onehot = (t[:, :, None] == jnp.arange(256, dtype=img.dtype)[None, None, :])
    hist = jnp.sum(onehot, axis=1).astype(jnp.float32)  # (T,256)

    # clip + redistribute (OpenCV: clipLimit * tileArea / 256, min 1)
    limit = max(1.0, clip_limit * (th * tw) / 256.0)
    clipped = jnp.minimum(hist, limit)
    excess = jnp.sum(hist - clipped, axis=1, keepdims=True)
    clipped = clipped + excess / 256.0

    cdf = jnp.cumsum(clipped, axis=1)
    scale = 255.0 / (th * tw)
    lut = jnp.clip(jnp.rint(cdf * scale), 0, 255)  # (T,256)
    lut = lut.reshape(tiles, tiles, 256)

    # bilinear interpolation between the 4 surrounding tile LUTs
    ys = (jnp.arange(Hc, dtype=jnp.float32) + 0.5) / th - 0.5
    xs = (jnp.arange(Wc, dtype=jnp.float32) + 0.5) / tw - 0.5
    y0 = jnp.clip(jnp.floor(ys), 0, tiles - 1).astype(jnp.int32)
    x0 = jnp.clip(jnp.floor(xs), 0, tiles - 1).astype(jnp.int32)
    y1 = jnp.clip(y0 + 1, 0, tiles - 1)
    x1 = jnp.clip(x0 + 1, 0, tiles - 1)
    wy = jnp.clip(ys - y0, 0.0, 1.0)[:, None]
    wx = jnp.clip(xs - x0, 0.0, 1.0)[None, :]

    px = x.astype(jnp.int32)

    def sample(lut_yx):
        # lut gathered per (tile_y, tile_x) row/col pair applied to pixels
        return lut_yx[px]

    l00 = lut[y0][:, x0][jnp.arange(Hc)[:, None], jnp.arange(Wc)[None, :], px]
    l01 = lut[y0][:, x1][jnp.arange(Hc)[:, None], jnp.arange(Wc)[None, :], px]
    l10 = lut[y1][:, x0][jnp.arange(Hc)[:, None], jnp.arange(Wc)[None, :], px]
    l11 = lut[y1][:, x1][jnp.arange(Hc)[:, None], jnp.arange(Wc)[None, :], px]

    out = (
        (1 - wy) * ((1 - wx) * l00 + wx * l01)
        + wy * ((1 - wx) * l10 + wx * l11)
    )
    out = jnp.clip(jnp.rint(out), 0, 255).astype(jnp.uint8)
    # paste into the original size (edge remainder copied unmodified)
    full = img
    full = full.at[:Hc, :Wc].set(out)
    return full
