"""Median-split BVH builder (host side).

Parity reference: ``Assets/Services/BVH/BVHBuilder.cs``:

* node bounds encapsulate all three vertices of every triangle (:107-119);
* leaf when count <= 4 (MAX_TRIANGLES_PER_LEAF, :58,:125) or when the
  partition degenerates (:142-145);
* split on the longest axis at the AABB center (:130-136);
* quicksort-style in-place index partition on triangle centroids (:160-183);
* BFS flatten so children are contiguous and right = leftOrFirst + 1
  (:189-238); triangles reordered to match leaf order (:214-215).

Output is SoA numpy. A frozen copy of the port's Python builder
(``accel/bvh.py``), which the benchmark does not import, and below it the
benchmark's own walk that counts the work the roofline is measured
against (:class:`WorkCount`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from benchmark.reference.intersect import INF, intersect_aabb, ray_triangle
from benchmark.reference.tessellate import TriangleSoA

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


def build_bvh(tris: TriangleSoA, max_leaf: int = MAX_TRIANGLES_PER_LEAF) -> BVH:
    """Build the flattened BVH; algorithmic twin of BVHBuilder.Build (:76-95)."""
    return _build_python(tris, max_leaf)


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


STACK = 64  # entries of a ray's stack; build_bvh's depth is checked against it
CHECK_EVERY = 16  # walk steps between reads of the loop condition (a host sync)


class WorkCount:
    """The box tests and triangle tests that the median-split BVH of
    :func:`build_bvh` (at most 4 triangles a leaf, the upstream
    ``BVHBuilder.cs`` rule) needs for the rays it is given.

    Called as the tracer's ``count(o, d, t_max)`` hook, it keeps the rays;
    :meth:`run` then walks them all at once, closest-hit rays in one walk
    and shadow rays in another. The walk is the upstream ``TraverseBVH``
    (``BVHRayTracing.compute:225-267``): pop a node, test its box (a node
    entered no nearer than the best hit so far is skipped), scan a leaf's
    triangles, or test both children's boxes and push them near-first. A
    closest-hit ray (``t_max`` None) walks until its stack is empty; a
    shadow ray stops at its first hit nearer than ``t_max``, the distance
    to the light, and never enters a box beyond it. The counts depend on
    the rays and the scene alone, not on how the program walks its own
    structure."""

    def __init__(self, tris: TriangleSoA, device):
        bvh = build_bvh(tris)
        if bvh.depth() + 1 > STACK:
            raise ValueError(f"BVH depth {bvh.depth()} exceeds the walk's stack of {STACK}")
        rt = bvh.triangles

        def put(a, dtype=torch.float32):
            return torch.as_tensor(np.asarray(a), device=device).to(dtype)

        def pad(a):  # max_leaf never-hit rows, so a leaf slice stays in bounds
            return put(np.pad(np.asarray(a, F32), ((0, MAX_TRIANGLES_PER_LEAF), (0, 0))))

        self.node_min, self.node_max = put(bvh.node_min), put(bvh.node_max)
        self.left_or_first = put(bvh.left_or_first, torch.int64)
        self.count = put(bvh.count, torch.int64)
        self.v0, self.v1, self.v2 = pad(rt.v0), pad(rt.v1), pad(rt.v2)
        self.n_tris = int(tris.count)
        self.closest, self.shadow = [], []

    def __call__(self, o, d, t_max: Optional[torch.Tensor]) -> None:
        if t_max is None:
            self.closest.append((o.float(), d.float()))
        else:
            self.shadow.append((o.float(), d.float(), t_max.float()))

    def run(self) -> dict:
        """Walk every ray given so far -> {"rays", "box_tests", "tri_tests"}."""
        out = {"rays": 0, "box_tests": 0, "tri_tests": 0}
        for rays, any_hit in ((self.closest, False), (self.shadow, True)):
            if not rays:
                continue
            cols = [torch.cat(c) for c in zip(*rays)]
            box, tri = self._walk(cols[0], cols[1], cols[2] if any_hit else None)
            out["rays"] += int(cols[0].shape[0])
            out["box_tests"] += box
            out["tri_tests"] += tri
        return out

    def _walk(self, o, d, t_max) -> tuple:
        n = o.shape[0]
        if n == 0 or self.n_tris == 0:
            return 0, 0
        dev = o.device
        ml = MAX_TRIANGLES_PER_LEAF
        n_nodes = int(self.count.shape[0])
        last_slice = int(self.v0.shape[0]) - ml
        inv = torch.reciprocal(d)
        rows = torch.arange(n, device=dev)
        lanes = torch.arange(ml, device=dev)
        sp = torch.ones(n, dtype=torch.int64, device=dev)
        stack = torch.zeros((n, STACK), dtype=torch.int64, device=dev)
        bt = (torch.full((n,), INF, dtype=torch.float32, device=dev) if t_max is None
              else t_max.clone())
        box = torch.zeros((), dtype=torch.int64, device=dev)
        tri_tests = torch.zeros((), dtype=torch.int64, device=dev)

        def slab(node):
            return intersect_aabb(o, inv, self.node_min[node], self.node_max[node])

        it = 0
        while True:
            if it % CHECK_EVERY == 0 and not bool((sp > 0).any()):
                break
            it += 1
            running = sp > 0
            top = (sp - 1).clamp_min(0)
            node = stack[rows, top]
            box += running.sum()
            active = running & (slab(node) < bt)
            cnt = self.count[node]
            lof = self.left_or_first[node]

            is_leaf = active & (cnt > 0)
            tri_tests += torch.where(is_leaf, cnt, 0).sum()
            tri = lof.clamp(0, last_slice)[:, None] + lanes
            _, t, _, _ = ray_triangle(o[:, None, :], d[:, None, :], self.v0[tri], self.v1[tri],
                                      self.v2[tri])
            t = torch.where(is_leaf[:, None] & (lanes < cnt[:, None]), t, INF)
            tmin = t.min(dim=1).values
            better = tmin < bt
            bt = torch.where(better, tmin, bt)

            is_inner = active & (cnt == 0)
            box += 2 * is_inner.sum()
            left = lof.clamp(0, n_nodes - 2)
            near = torch.where(slab(left) <= slab(left + 1), left, left + 1)
            far = left + (left + 1) - near
            sp1 = (top + 1).clamp_max(STACK - 1)
            stack.scatter_(1, top[:, None], torch.where(is_inner, far, stack[rows, top])[:, None])
            stack.scatter_(1, sp1[:, None], torch.where(is_inner, near, stack[rows, sp1])[:, None])
            sp = torch.where(running, top + torch.where(is_inner, 2, 0), sp)
            if t_max is not None:  # a shadow ray is done at its first occluder
                sp = torch.where(better, 0, sp)
        return int(box), int(tri_tests)
