"""ctypes binding of the C++ BVH builder (``src/bvh.cc``)."""

from __future__ import annotations

import ctypes
import functools

import numpy as np

from cosig_tpu_torch.native import loader

_FP = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_IP = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


@functools.lru_cache(maxsize=1)
def _fn():
    fn = loader.load().cosig_build_bvh
    fn.restype = ctypes.c_int
    # v0, v1, v2, centers, n, max_leaf, node_min, node_max, left_or_first, count, order
    fn.argtypes = [_FP, _FP, _FP, _FP, ctypes.c_int, ctypes.c_int, _FP, _FP, _IP, _IP, _IP]
    return fn


def build(tris, max_leaf: int):
    """The BVH of ``tris`` (at least one triangle) -> the same
    :class:`cosig_tpu_torch.accel.bvh.BVH` as the Python builder's. Raises
    :class:`loader.NativeError` if the library is unavailable or refuses
    the input."""
    from cosig_tpu_torch.accel.bvh import BVH

    n = tris.count
    if n <= 0 or max_leaf <= 0:
        raise ValueError(f"the native builder needs triangles and max_leaf > 0, got {n}, {max_leaf}")
    v0, v1, v2, centers = (np.ascontiguousarray(a, np.float32).reshape(n, 3)
                           for a in (tris.v0, tris.v1, tris.v2, tris.centers))
    cap = 2 * n  # a binary tree over n leaves' ranges has < 2n nodes
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    lof = np.empty((cap,), np.int32)
    cnt = np.empty((cap,), np.int32)
    order = np.empty((n,), np.int32)
    n_nodes = _fn()(v0, v1, v2, centers, n, max_leaf, node_min, node_max, lof, cnt, order)
    if n_nodes <= 0:
        raise loader.NativeError(f"cosig_build_bvh failed ({n_nodes}) on {n} triangles")
    return BVH(
        node_min=node_min[:n_nodes].copy(),
        node_max=node_max[:n_nodes].copy(),
        left_or_first=lof[:n_nodes].copy(),
        count=cnt[:n_nodes].copy(),
        triangles=tris.take(order),
        order=order,
    )
