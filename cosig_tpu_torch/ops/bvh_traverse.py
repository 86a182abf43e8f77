"""The oracle path's accelerated closest hit: a per-ray BVH stack walk.

Counterpart of :mod:`cosig_tpu.ops.bvh_traverse` (``bvh_traverse.py:36-223``).
The reference's ``TraverseBVH`` (``BVHRayTracing.compute:225-267``) pops
nodes from a per-ray stack, skips a node entered no nearer than the best
hit so far (``:245-246``) and scans the triangles of a leaf. The JAX
package runs it as a vmapped ``while_loop``; here it is one loop over all
rays of a batch, with a [N, 48] stack tensor, masks for the rays whose
stack is not empty, for leaves and for inner nodes, and ``scatter`` for
the pushes. A ray whose stack is empty changes nothing, so the loop
condition is read every :data:`CHECK_EVERY` iterations (each read is a
host sync on the card).

As in the JAX package: children go on the stack near-first (the nearer
entry distance on top), a leaf is scanned ``max_leaf`` triangles wide
from its first triangle (the soup is padded by ``max_leaf`` never-hit
rows), and the slab test keeps its NaN case — a zero direction component
with the origin exactly on a node plane gives 0 * inf = NaN and culls the
node. The walk resolves equal-t ties by visit order, not soup order, so
it is not bit-equal to :func:`cosig_tpu_torch.ops.intersect.closest_hit_brute`
on ties.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cosig_tpu_torch.accel.bvh import build_bvh
from cosig_tpu_torch.ops import trace_xla
from cosig_tpu_torch.ops.intersect import INF, Hit, _hit_record, _miss, intersect_aabb, ray_triangle

STACK = 48  # >= 2x any sane median-split depth; checked at build time
CHECK_EVERY = 16  # walk iterations between reads of the loop condition
# Pixels per walk. The walk's temporaries are a few [N, 48] and [N, 4]
# tensors, so a tile far larger than the brute-force scan's 8192 stays
# small, and each walk loops until its slowest ray is done: one 256 x 256
# frame of large_mesh's camera rays walks 256 iterations as one tile and
# 768 as eight.
PIXEL_TILE = 65536


@dataclass(frozen=True)
class BVHDevice:
    """Flattened BVH and the leaf-ordered triangle soup on one device.

    Inner nodes have count 0 and children ``left_or_first`` and
    ``left_or_first + 1``; a leaf's ``left_or_first`` is its first
    triangle. The triangle tensors are padded by ``max_leaf`` all-zero
    (never-hit) rows so a fixed-width leaf slice stays in bounds."""

    node_min: torch.Tensor  # [n, 3] f32
    node_max: torch.Tensor  # [n, 3] f32
    left_or_first: torch.Tensor  # [n] int64
    count: torch.Tensor  # [n] int64
    v0: torch.Tensor  # [Tp, 3] f32
    v1: torch.Tensor
    v2: torch.Tensor
    n0: torch.Tensor
    n1: torch.Tensor
    n2: torch.Tensor
    mat: torch.Tensor  # [Tp] int64
    max_leaf: int


def build_bvh_device(tris, max_leaf: int = 4, device="cpu") -> BVHDevice:
    """Build the reference-spec BVH on the host and put the walk's tensors
    on ``device``."""
    bvh = build_bvh(tris, max_leaf=max_leaf)
    rt = bvh.triangles
    depth = bvh.depth()
    if depth + 1 > STACK:
        raise ValueError(f"BVH depth {depth} exceeds the walk's stack of {STACK}")

    def put(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    def pad(a):
        return put(np.pad(np.asarray(a, np.float32), ((0, max_leaf), (0, 0))))

    return BVHDevice(
        node_min=put(bvh.node_min), node_max=put(bvh.node_max),
        left_or_first=put(bvh.left_or_first, torch.int64), count=put(bvh.count, torch.int64),
        v0=pad(rt.v0), v1=pad(rt.v1), v2=pad(rt.v2),
        n0=pad(rt.n0), n1=pad(rt.n1), n2=pad(rt.n2),
        mat=put(np.pad(np.asarray(rt.material), (0, max_leaf)), torch.int64),
        max_leaf=max_leaf,
    )


def _slab(bd: BVHDevice, node, o, inv):
    """Entry distance of rays [N] into nodes ``node`` [N], INF on a miss,
    NaN where a 0 * inf product meets the compare (``:125-139``)."""
    return intersect_aabb(o, inv, bd.node_min[node], bd.node_max[node])


def closest_hit_bvh(bd: BVHDevice, scene, o, d) -> Hit:
    """Closest hit of rays [N, 3] by the BVH walk. ``scene`` is unused (the
    geometry is in ``bd``); it keeps ``closest_hit_brute``'s signature."""
    del scene
    n = o.shape[0]
    dev = o.device
    ml = bd.max_leaf
    n_nodes = int(bd.count.shape[0])
    last_slice = int(bd.v0.shape[0]) - ml
    if last_slice == 0:  # no triangles: the root is an empty leaf-less node
        return _miss(n, dev)
    inv = torch.reciprocal(d)
    rows = torch.arange(n, device=dev)
    lanes = torch.arange(ml, device=dev)

    sp = torch.ones(n, dtype=torch.int64, device=dev)
    stack = torch.zeros((n, STACK), dtype=torch.int64, device=dev)
    bt = torch.full((n,), INF, dtype=torch.float32, device=dev)
    bi = torch.full((n,), -1, dtype=torch.int64, device=dev)
    bu = torch.zeros(n, dtype=torch.float32, device=dev)
    bv = torch.zeros(n, dtype=torch.float32, device=dev)

    it = 0
    while True:
        if it % CHECK_EVERY == 0 and not bool((sp > 0).any()):
            break
        it += 1
        running = sp > 0
        top = (sp - 1).clamp_min(0)
        node = stack[rows, top]
        # Pop-time early-out: skip a subtree entered no nearer than the
        # best hit so far (compute:245-246).
        active = running & (_slab(bd, node, o, inv) < bt)
        cnt = bd.count[node]
        lof = bd.left_or_first[node]

        # Leaf: a max_leaf-wide masked scan from its first triangle (the
        # start clamped into the padded soup, as dynamic_slice does).
        is_leaf = active & (cnt > 0)
        tri = lof.clamp(0, last_slice)[:, None] + lanes
        _, t, u, v = ray_triangle(o[:, None, :], d[:, None, :], bd.v0[tri], bd.v1[tri], bd.v2[tri])
        t = torch.where(is_leaf[:, None] & (lanes < cnt[:, None]), t, INF)
        jj = torch.argmin(t, dim=1)
        tmin = t[rows, jj]
        better = tmin < bt
        bt = torch.where(better, tmin, bt)
        bi = torch.where(better, lof + jj, bi)
        bu = torch.where(better, u[rows, jj], bu)
        bv = torch.where(better, v[rows, jj], bv)

        # Inner node: push the far child, then the near one on top.
        is_inner = active & (cnt == 0)
        left = lof.clamp(0, n_nodes - 2)
        near = torch.where(_slab(bd, left, o, inv) <= _slab(bd, left + 1, o, inv), left, left + 1)
        far = left + (left + 1) - near
        sp1 = (top + 1).clamp_max(STACK - 1)
        stack.scatter_(1, top[:, None], torch.where(is_inner, far, stack[rows, top])[:, None])
        stack.scatter_(1, sp1[:, None], torch.where(is_inner, near, stack[rows, sp1])[:, None])
        sp = torch.where(running, top + torch.where(is_inner, 2, 0), sp)

    return _hit_record(o, d, bt, bi, bu, bv, bd.n0, bd.n1, bd.n2, bd.mat)


def render_bvh(scene, bvh_dev: BVHDevice, params, cfg, pixel_tile: int = PIXEL_TILE,
               with_rays: bool = False):
    """The oracle path with the BVH walk as its closest hit
    (``render_jit_bvh``, ``bvh_traverse.py:210-223``)."""

    def ch(s, o, d):
        return closest_hit_bvh(bvh_dev, s, o, d)

    return trace_xla.render_image(scene, params, cfg, closest_hit=ch, pixel_tile=pixel_tile,
                                  with_rays=with_rays)
