"""Median-split BVH builder (host side).

Parity reference: ``Assets/Services/BVH/BVHBuilder.cs``:

* node bounds encapsulate all three vertices of every triangle (:107-119);
* leaf when count <= 4 (MAX_TRIANGLES_PER_LEAF, :58,:125) or when the
  partition degenerates (:142-145);
* split on the longest axis at the AABB center (:130-136);
* quicksort-style in-place index partition on triangle centroids (:160-183);
* BFS flatten so children are contiguous and right = leftOrFirst + 1
  (:189-238); triangles reordered to match leaf order (:214-215).

Output is SoA numpy, from which :mod:`cosig_tpu_torch.accel.clusters`
derives the flat cluster structure the kernels walk.

The port's copy of :mod:`cosig_tpu.accel.bvh`. :func:`build_bvh` runs
the C++ builder of :mod:`cosig_tpu_torch.native` where it builds and
loads, else the Python builder (``_build_python``); both give the same
nodes and order bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np

from cosig_tpu_torch.scene.tessellate import TriangleSoA

F32 = np.float32

MAX_TRIANGLES_PER_LEAF = 4


@dataclass
class BVH:
    """Flattened BVH. Internal nodes: count == 0, left_or_first = left child
    (right child = left + 1). Leaves: count > 0, left_or_first = first
    triangle in the reordered soup."""

    node_min: np.ndarray  # [N, 3] f32
    node_max: np.ndarray  # [N, 3] f32
    left_or_first: np.ndarray  # [N] i32
    count: np.ndarray  # [N] i32
    triangles: TriangleSoA  # reordered to match leaf references
    order: np.ndarray  # [T] i32: original index of each reordered triangle

    @property
    def num_nodes(self) -> int:
        return int(self.node_min.shape[0])

    def depth(self) -> int:
        """Max tree depth (root = 1)."""
        depth, stack = 0, [(0, 1)]
        while stack:
            node, d = stack.pop()
            depth = max(depth, d)
            if self.count[node] == 0 and self.num_nodes > 1:
                left = int(self.left_or_first[node])
                stack += [(left, d + 1), (left + 1, d + 1)]
        return depth


class _Node:
    __slots__ = ("bmin", "bmax", "left", "right", "start", "count")

    def __init__(self):
        self.left = self.right = None
        self.start = self.count = 0


def build_bvh(tris: TriangleSoA, max_leaf: int = MAX_TRIANGLES_PER_LEAF,
              use_native: str = "auto") -> BVH:
    """Build the flattened BVH; algorithmic twin of BVHBuilder.Build (:76-95).

    ``use_native``: ``"auto"`` runs the C++ builder and falls back to the
    Python one if the native library cannot be built or loaded (the
    loader logs that once); ``"native"`` raises
    :class:`cosig_tpu_torch.native.loader.NativeError` instead;
    ``"python"`` runs the Python builder. An empty soup gets the Python
    builder's one empty leaf in every mode."""
    from cosig_tpu_torch.native import bvh_native, loader

    def native():  # the C++ builder takes no empty soup
        return bvh_native.build(tris, max_leaf) if tris.count else _build_python(tris, max_leaf)

    return loader.dispatch(use_native, native, lambda: _build_python(tris, max_leaf))


def _build_python(tris: TriangleSoA, max_leaf: int) -> BVH:
    t = tris.count
    if t == 0:
        return BVH(
            node_min=np.zeros((1, 3), F32),
            node_max=np.zeros((1, 3), F32),
            left_or_first=np.zeros((1,), np.int32),
            count=np.zeros((1,), np.int32),
            triangles=tris,
            order=np.zeros((0,), np.int32),
        )

    centers = tris.centers
    # Vectorized per-triangle bounds for fast range reductions.
    tri_min = np.minimum(np.minimum(tris.v0, tris.v1), tris.v2)
    tri_max = np.maximum(np.maximum(tris.v0, tris.v1), tris.v2)
    indices = np.arange(t, dtype=np.int64)

    def build(start: int, count: int) -> _Node:
        node = _Node()
        sel = indices[start : start + count]
        node.bmin = tri_min[sel].min(axis=0)
        node.bmax = tri_max[sel].max(axis=0)
        node.start = start
        node.count = count
        if count <= max_leaf:
            return node

        size = node.bmax - node.bmin
        axis = 0
        if size[1] > size[0]:
            axis = 1
        if size[2] > size[axis]:
            axis = 2
        pivot = (node.bmin[axis] + node.bmax[axis]) * F32(0.5)

        # In-place two-pointer partition on centroids (:160-183). The
        # vectorized stable split below yields the same *set* on each side;
        # the reference's swap order differs, but leaf contents (sets) and
        # the tree shape are identical because only membership matters to
        # BuildRecursive's ranges.
        c = centers[sel, axis]
        left_mask = c < pivot
        mid = start + int(left_mask.sum())
        if mid == start or mid == start + count:
            # Robustness beyond the reference (which bails to a leaf,
            # :142-145): an oversized triangle can stretch the node bounds
            # so that every *centroid* sits on one side of the bounds
            # center. Retry splitting at the centroid-extent median before
            # giving up — otherwise scenes with large ground planes
            # degenerate to thousand-triangle leaves.
            node_centers = centers[sel]
            cmin = node_centers.min(axis=0)
            cmax = node_centers.max(axis=0)
            cext = cmax - cmin
            axis = int(np.argmax(cext))
            pivot = (cmin[axis] + cmax[axis]) * F32(0.5)
            c = node_centers[:, axis]
            left_mask = c < pivot
            mid = start + int(left_mask.sum())
            if mid == start or mid == start + count:
                return node  # all centroids coincide -> leaf
        indices[start : start + count] = np.concatenate(
            [sel[left_mask], sel[~left_mask]]
        )

        node.left = build(start, mid - start)
        node.right = build(mid, start + count - mid)
        node.count = 0
        return node

    import sys

    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 10000))
    try:
        root = build(0, t)
    finally:
        sys.setrecursionlimit(old_limit)

    # BFS flatten (:189-238).
    node_min: List[np.ndarray] = []
    node_max: List[np.ndarray] = []
    lof: List[int] = []
    cnt: List[int] = []
    order: List[int] = []

    queue = [root]
    # Pre-allocate slots breadth-first: process queue while appending children.
    slots = [0]
    node_min.append(None)  # type: ignore
    node_max.append(None)  # type: ignore
    lof.append(0)
    cnt.append(0)
    qi = 0
    while qi < len(queue):
        n = queue[qi]
        idx = slots[qi]
        qi += 1
        node_min[idx] = n.bmin
        node_max[idx] = n.bmax
        if n.count > 0:  # leaf
            cnt[idx] = n.count
            lof[idx] = len(order)
            order.extend(indices[n.start : n.start + n.count].tolist())
        else:
            left_idx = len(node_min)
            for _ in range(2):
                node_min.append(None)  # type: ignore
                node_max.append(None)  # type: ignore
                lof.append(0)
                cnt.append(0)
            cnt[idx] = 0
            lof[idx] = left_idx
            queue.append(n.left)
            slots.append(left_idx)
            queue.append(n.right)
            slots.append(left_idx + 1)

    order_arr = np.asarray(order, dtype=np.int32)
    return BVH(
        node_min=np.stack(node_min).astype(F32),
        node_max=np.stack(node_max).astype(F32),
        left_or_first=np.asarray(lof, dtype=np.int32),
        count=np.asarray(cnt, dtype=np.int32),
        triangles=tris.take(order_arr),
        order=order_arr,
    )


def validate_bvh(bvh: BVH, tris: TriangleSoA) -> None:
    """Raise ``ValueError`` unless the BVH's structural invariants hold
    (cosig_tpu/accel/bvh.py:224-246, with its tolerances): every triangle
    exactly once, every node's box ordered, each inner node's children
    contiguous, in range and inside it, each leaf's triangles in range and
    inside its box."""
    t = tris.count
    n = bvh.num_nodes
    if not np.array_equal(np.sort(bvh.order), np.arange(t)):
        raise ValueError("the triangle order is not a permutation of the soup")
    if not (bvh.node_min <= bvh.node_max + 1e-6).all():
        raise ValueError("a node's box has min above max")
    inner = (bvh.count == 0) & (t > 0)
    nodes = np.nonzero(inner)[0]
    left = bvh.left_or_first[inner].astype(np.int64)
    if ((left <= 0) | (left + 1 >= n)).any():
        raise ValueError("an inner node's children lie outside the node array")
    for child in (left, left + 1):
        if not ((bvh.node_min[nodes] <= bvh.node_min[child] + 1e-5).all()
                and (bvh.node_max[child] <= bvh.node_max[nodes] + 1e-5).all()):
            raise ValueError("a child's box is not inside its parent's")
    leaves = np.nonzero(~inner)[0]
    first = bvh.left_or_first[leaves].astype(np.int64)
    count = bvh.count[leaves].astype(np.int64)
    if ((first < 0) | (count < 0) | (first + count > t)).any():
        raise ValueError("a leaf's triangles lie outside the soup")
    node = np.repeat(leaves, count)
    tri = np.concatenate([np.arange(f, f + c) for f, c in zip(first, count)] or [[]]).astype(
        np.int64)
    tt = bvh.triangles
    v = np.stack([tt.v0[tri], tt.v1[tri], tt.v2[tri]])  # [3, m, 3]
    if not ((v.min(axis=0) >= bvh.node_min[node] - 1e-4).all()
            and (v.max(axis=0) <= bvh.node_max[node] + 1e-4).all()):
        raise ValueError("a leaf's triangle is not inside its box")
