"""Per-triangle Plücker constants, host side (numpy float32).

Counterpart of :func:`cosig_tpu.ops.intersect.plucker_constants_host`
(``intersect.py:60-102``). For a ray (o, d) with moment w = o x d, the
signed edge volume of edge P->Q is V(P,Q) = d . (P x Q) + w . (Q - P),
linear in (d, w). The ray pierces the triangle iff V(B,C), V(C,A), V(A,B)
share a sign; u = V(C,A)/S, v = V(A,B)/S, S = d . n and
t = (n.A - n.o) / S — the reference's Möller-Trumbore test and epsilons
(BVHRayTracing.compute:153-179).

The manual-xyz cross products fix the canonical component order; the
kernels' pair test and the JAX package use constants built in exactly
this order, so the cluster geometry is bit-identical across packages.
"""

from __future__ import annotations

import numpy as np


def plucker_constants_host(v0, v1, v2, dtype=np.float32):
    """Returns a dict of [T, ...] arrays: n (3), n_dot_a (1), and the d- and
    w-coefficients (3 each) of VA, VB, VC."""
    a = np.asarray(v0, dtype)
    b = np.asarray(v1, dtype)
    c = np.asarray(v2, dtype)

    def cross(p, q):
        return np.stack(
            [
                p[:, 1] * q[:, 2] - p[:, 2] * q[:, 1],
                p[:, 2] * q[:, 0] - p[:, 0] * q[:, 2],
                p[:, 0] * q[:, 1] - p[:, 1] * q[:, 0],
            ],
            axis=1,
        ).astype(dtype)

    n = cross((b - a).astype(dtype), (c - a).astype(dtype))
    return {
        "n": n,
        "n_dot_a": np.sum(n * a, axis=1, dtype=dtype),
        "va_d": cross(b, c),
        "va_w": (c - b).astype(dtype),
        "vb_d": cross(c, a),
        "vb_w": (a - c).astype(dtype),
        "vc_d": cross(a, b),
        "vc_w": (b - a).astype(dtype),
    }
