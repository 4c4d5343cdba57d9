"""One-array device fetches for multi-leaf payloads.

Every array fetched on its own is a separate blocking device-to-host
transfer, so jax.device_get of a 40-leaf confirmation payload costs ~40
of them.  What that costs on a local GPU, and so whether packing still
pays there, is not measured.

pack_fetch() runs a tiny jitted program that bitcasts/flattens every
leaf into ONE int32 vector on device, fetches that single array (one
round trip), and reslices the host copy back into the original pytree
(exact: f32 leaves are bit-cast, not rounded).

The packing program is cached per (shapes, dtypes) signature, so steady
-state use never retraces.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


_SUPPORTED = {"float32", "int32", "uint8", "bool", "int8", "uint32"}


def _spec_of(tree):
    leaves, treedef = jax.tree_util.tree_flatten(tree)
    spec = tuple((tuple(a.shape), str(a.dtype)) for a in leaves)
    return leaves, treedef, spec


@functools.lru_cache(maxsize=512)
def _pack_prog(spec):
    def pack(*arrs):
        flat = []
        for a, (_, dt) in zip(arrs, spec):
            if dt == "float32":
                v = jax.lax.bitcast_convert_type(a, jnp.int32)
            elif dt in ("bool", "uint8", "int8"):
                v = a.astype(jnp.int32)
            elif dt == "uint32":
                v = jax.lax.bitcast_convert_type(a, jnp.int32)
            else:  # int32
                v = a
            flat.append(v.reshape(-1))
        return jnp.concatenate(flat) if flat else jnp.zeros(0, jnp.int32)

    return jax.jit(pack)


def pack_fetch(tree):
    """device_get a pytree of device arrays with ONE fetched array.

    Returns the same pytree structure with numpy leaves (dtypes
    preserved bit-exactly).  Falls back to plain device_get for dtypes
    outside the supported set.
    """
    leaves, treedef, spec = _spec_of(tree)
    if not leaves:
        return tree
    if any(dt not in _SUPPORTED for _, dt in spec):
        return jax.tree_util.tree_unflatten(
            treedef, jax.device_get(leaves)
        )
    packed = np.asarray(_pack_prog(spec)(*leaves))
    out = []
    ofs = 0
    for shape, dt in spec:
        n = int(np.prod(shape)) if shape else 1
        chunk = packed[ofs:ofs + n]
        ofs += n
        if dt == "float32":
            v = chunk.view(np.float32)
        elif dt == "bool":
            v = chunk.astype(bool)
        elif dt == "uint8":
            v = chunk.astype(np.uint8)
        elif dt == "int8":
            v = chunk.astype(np.int8)
        elif dt == "uint32":
            v = chunk.view(np.uint32)
        else:
            v = chunk
        out.append(v.reshape(shape))
    return jax.tree_util.tree_unflatten(treedef, out)
