"""Quadtree keypoint distribution (DistributeOctTree).

Replaces ORBextractor::DistributeOctTree + ExtractorNode::DivideNode
(reference: src/orb_extractor/ORBextractor.cc:544-771, :486-542): split
the level's bounding box into a quadtree until #leaf-nodes >= N (largest
nodes split first in the final stage), then keep the highest-response
keypoint of every leaf.

Two implementations:

- ``distribute_host``: exact reproduction of the reference's greedy
  algorithm in numpy, used for parity tests and as the default in the
  host-driven pipeline (the input is a few-thousand keypoints; the
  algorithm is inherently sequential/greedy).  Tie-breaking of equal-sized
  nodes in the reference's final stage compares std::list node POINTERS
  (unspecified behaviour); we use stable insertion order, so results can
  differ from a particular reference binary only for exact size ties.

- ``distribute_device``: shape-static jit version for the all-device path.
  The quadtree cell boundaries are data-independent (DivideNode's ceil
  halving depends only on the box), so each keypoint's cell at every
  depth is a static table lookup; the device picks the smallest depth
  with >= N occupied cells and keeps the per-cell argmax response.  This
  matches the reference's leaf set except for the partial final-stage
  splits (documented approximation; spatial distribution is equivalent).
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import jax
import jax.numpy as jnp
import numpy as np


# ------------------------------------------------------------- host exact


class _Node:
    __slots__ = ("ulx", "uly", "brx", "bry", "idx", "no_more")

    def __init__(self, ulx, uly, brx, bry, idx):
        self.ulx, self.uly, self.brx, self.bry = ulx, uly, brx, bry
        self.idx = idx  # np.ndarray of keypoint indices, insertion order
        self.no_more = len(idx) == 1


def _divide(node: _Node, xs, ys) -> List[_Node]:
    half_x = int(np.ceil(np.float32(node.brx - node.ulx) / 2))
    half_y = int(np.ceil(np.float32(node.bry - node.uly) / 2))
    mx, my = node.ulx + half_x, node.uly + half_y
    idx = node.idx
    left = xs[idx] < mx
    top = ys[idx] < my
    return [
        _Node(node.ulx, node.uly, mx, my, idx[left & top]),        # n1
        _Node(mx, node.uly, node.brx, my, idx[~left & top]),       # n2
        _Node(node.ulx, my, mx, node.bry, idx[left & ~top]),       # n3
        _Node(mx, my, node.brx, node.bry, idx[~left & ~top]),      # n4
    ]


def distribute_host(
    xs: np.ndarray,
    ys: np.ndarray,
    responses: np.ndarray,
    min_x: int,
    max_x: int,
    min_y: int,
    max_y: int,
    n_target: int,
    use_native: bool = True,
) -> np.ndarray:
    if use_native:
        from ..native import distribute_octree_native

        out = distribute_octree_native(
            xs, ys, responses, min_x, max_x, min_y, max_y, n_target
        )
        if out is not None:
            return out
    return _distribute_host_py(
        xs, ys, responses, min_x, max_x, min_y, max_y, n_target
    )


def _distribute_host_py(
    xs: np.ndarray,
    ys: np.ndarray,
    responses: np.ndarray,
    min_x: int,
    max_x: int,
    min_y: int,
    max_y: int,
    n_target: int,
) -> np.ndarray:
    """Exact DistributeOctTree; coordinates are ABSOLUTE inner-image
    coords (the reference works on coords relative to minX/minY — we
    shift internally).  Input order must be the reference's insertion
    order; returns indices into the input arrays, one per leaf node, in
    leaf-list order."""
    xs = np.asarray(xs, np.float32) - min_x
    ys = np.asarray(ys, np.float32) - min_y
    w, h = max_x - min_x, max_y - min_y
    n_ini = int(np.floor(w / float(h) + 0.5))  # C++ round()
    n_ini = max(n_ini, 1)
    h_x = np.float32(w) / np.float32(n_ini)

    nodes: List[_Node] = []
    buckets = [[] for _ in range(n_ini)]
    col = np.clip((xs / h_x).astype(np.int64), 0, n_ini - 1)
    for i in range(len(xs)):
        buckets[col[i]].append(i)
    for i in range(n_ini):
        ulx = int(h_x * np.float32(i))
        brx = int(h_x * np.float32(i + 1))
        node = _Node(ulx, 0, brx, h, np.asarray(buckets[i], np.int64))
        if len(node.idx) > 0:
            nodes.append(node)

    finish = False
    while not finish:
        prev_size = len(nodes)
        new_nodes: List[_Node] = []
        to_expand: List[_Node] = []
        for node in nodes:
            if node.no_more:
                new_nodes.append(node)
                continue
            for child in _divide(node, xs, ys):
                if len(child.idx) == 0:
                    continue
                new_nodes.append(child)
                if len(child.idx) > 1:
                    to_expand.append(child)
        nodes = new_nodes
        if len(nodes) >= n_target or len(nodes) == prev_size:
            finish = True
        elif len(nodes) + 3 * len(to_expand) > n_target:
            # final stage: split largest nodes first until >= N
            while not finish:
                prev_size = len(nodes)
                order = sorted(
                    range(len(to_expand)),
                    key=lambda j: len(to_expand[j].idx),
                )
                prev_expand = [to_expand[j] for j in order]
                to_expand = []
                for node in reversed(prev_expand):
                    nodes.remove(node)
                    for child in _divide(node, xs, ys):
                        if len(child.idx) == 0:
                            continue
                        nodes.append(child)
                        if len(child.idx) > 1:
                            to_expand.append(child)
                    if len(nodes) >= n_target:
                        break
                if len(nodes) >= n_target or len(nodes) == prev_size:
                    finish = True

    out = []
    for node in nodes:
        r = responses[node.idx]
        out.append(node.idx[int(np.argmax(r))])  # argmax keeps first max
    return np.asarray(out, np.int64)


# ----------------------------------------------------------- device approx


def _cuts_for_depth(w: int, h: int, d_max: int):
    """Static x/y cell left-edges per depth, following DivideNode's ceil
    halving.  Returns lists of np arrays indexed by depth."""
    n_ini = max(int(np.floor(w / float(h) + 0.5)), 1)
    h_x = np.float32(w) / np.float32(n_ini)
    x_edges = [
        np.asarray([int(h_x * np.float32(i)) for i in range(n_ini)] + [w])
    ]
    y_edges = [np.asarray([0, h])]

    def split(edges):
        out = []
        for a, b in zip(edges[:-1], edges[1:]):
            half = int(np.ceil(np.float32(b - a) / 2))
            mid = a + half
            out.append(a)
            if mid < b and mid > a:
                out.append(mid)
        out.append(edges[-1])
        return np.asarray(sorted(set(out)))

    for _ in range(d_max):
        x_edges.append(split(x_edges[-1]))
        y_edges.append(split(y_edges[-1]))
    return x_edges, y_edges


@functools.partial(jax.jit, static_argnums=(3, 4, 5, 6, 7))
def distribute_device(
    xy: jnp.ndarray,
    resp: jnp.ndarray,
    valid: jnp.ndarray,
    n_target: int,
    width: int,
    height: int,
    min_x: int,
    min_y: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Jit quadtree distribution.  xy: (K, 2) absolute inner coords.

    Returns (keep_mask (K,), depth_used ()).  Keeps the argmax-response
    keypoint of every occupied cell at the smallest depth whose occupied
    cell count reaches n_target (or the deepest table).

    Cost: exactly TWO K-element sorts (sorts dominate this op).
    Sort 1 keys on a quadtree PATH code (top-level x cell, then one
    (by, bx) child-bit pair per depth): every depth-d cell is a PREFIX of
    the code, so one sorted array yields the occupied-cell count at ALL
    depths as prefix-transition counts.  Sort 2 is a stable sort by the
    packed (cell_at_selected_depth << 8 | 255-resp) key whose group
    leaders are the per-cell argmax; a scatter restores input order.
    """
    d_max = 7
    x_edges, y_edges = _cuts_for_depth(width, height, d_max)
    K = xy.shape[0]
    x = xy[:, 0] - min_x
    y = xy[:, 1] - min_y

    def cell_index(coord, edges_np):
        # interval index via broadcast compare (tables are tiny; avoids
        # gathers)
        inner = jnp.asarray(edges_np[1:-1], jnp.int32)
        return jnp.sum(
            (coord[:, None] >= inner[None, :]).astype(jnp.int32), axis=1
        )

    # Per-depth cell ids in ORIGINAL keypoint order (compare-based, cheap)
    cells_per_depth = []
    SENT = jnp.int32(2**30)
    for d in range(d_max + 1):
        cx = cell_index(x, x_edges[d])
        cy = cell_index(y, y_edges[d])
        n_cx = len(x_edges[d]) - 1
        n_cy = len(y_edges[d]) - 1
        assert n_cx * n_cy < (1 << 22), "cell id must fit packed int32 key"
        cells_per_depth.append(
            jnp.where(valid, cy * n_cx + cx, SENT).astype(jnp.int32)
        )

    # Quadtree path code per keypoint: child bit per axis per depth,
    # derived from static per-axis tables over FINE interval indices.
    def axis_path_bits(edges_list):
        fine = edges_list[d_max]
        code = np.zeros(len(fine) - 1, np.int64)
        for d in range(1, d_max + 1):
            idx_d = np.searchsorted(edges_list[d][1:-1], fine[:-1], "right")
            idx_p = np.searchsorted(edges_list[d - 1][1:-1], fine[:-1], "right")
            start = np.full(len(edges_list[d - 1]) - 1, 1 << 30, np.int64)
            np.minimum.at(start, idx_p, idx_d)
            child = idx_d - start[idx_p]
            assert child.min() >= 0 and child.max() <= 1
            code = (code << 1) | child
        top = np.searchsorted(edges_list[0][1:-1], fine[:-1], "right")
        return code.astype(np.int32), top.astype(np.int32)

    bx_tab, topx_tab = axis_path_bits(x_edges)
    by_tab, _ = axis_path_bits(y_edges)
    cx_f = cell_index(x, x_edges[d_max])
    cy_f = cell_index(y, y_edges[d_max])
    kx = jnp.asarray(bx_tab)[cx_f]
    ky = jnp.asarray(by_tab)[cy_f]
    topx = jnp.asarray(topx_tab)[cx_f]
    morton = jnp.zeros_like(kx)
    for i in range(d_max):  # interleave (by, bx) per depth
        morton |= (((kx >> i) & 1) | (((ky >> i) & 1) << 1)) << (2 * i)
    path = jnp.where(valid, (topx << (2 * d_max)) | morton, SENT)

    p1 = jnp.sort(path)
    counts = []
    for d in range(d_max + 1):
        shift = 2 * (d_max - d)
        pre = p1 >> shift
        pre = jnp.where(p1 < SENT, pre, SENT)
        head = jnp.concatenate([jnp.ones((1,), bool), pre[1:] != pre[:-1]])
        counts.append(jnp.sum((head & (pre < SENT)).astype(jnp.int32)))

    counts = jnp.stack(counts)  # (d_max+1,)
    reached = counts >= n_target
    depth = jnp.where(jnp.any(reached), jnp.argmax(reached), d_max)

    cell = jnp.select(
        [depth == d for d in range(d_max + 1)], cells_per_depth
    ).astype(jnp.int32)
    # per-cell argmax response, earliest-index tiebreak (reference keeps
    # the first max in node insertion order): ONE stable sort by the
    # packed key (cell asc, resp desc); stability keeps index order among
    # exact ties.  resp is a FAST score in [0, 255].
    idx = jnp.arange(K, dtype=jnp.int32)
    packed = jnp.where(
        cell < SENT,
        cell * jnp.int32(256) + (jnp.int32(255) - resp),
        SENT,
    )
    p_s, i_s = jax.lax.sort((packed, idx), num_keys=1, is_stable=True)
    leader = jnp.concatenate(
        [jnp.ones((1,), bool), (p_s[1:] >> 8) != (p_s[:-1] >> 8)]
    )
    leader &= p_s < SENT
    keep = jnp.zeros((K,), bool).at[i_s].set(leader, mode="drop")
    keep &= valid
    return keep, depth
