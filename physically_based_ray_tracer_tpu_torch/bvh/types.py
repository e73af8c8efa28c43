"""The classic 2-wide BVH layout; counterpart of ``physically_based_ray_tracer_tpu/bvh/types.py``.

An Aila/Laine-style node stores BOTH children's AABBs, so one row read per
traversal step serves both slab tests. The wave engine
(``ops/traverse_packet.py``) walks it; the dense-BVH engines do not.

Child/leaf encoding in ``nodes_child[n, 0..1]`` (int32):
    c >= 0  -> internal node index
    c <  0  -> leaf: m = -(c+1); first = m >> LEAF_COUNT_BITS;
               count = m & LEAF_COUNT_MASK
A count of 0 encodes an empty slot (used to pad a root-leaf BVH).

The numpy helpers (``woop_from_tris``, ``sah_cost``) are copies of the JAX
package's; ``BVHArrays`` holds torch tensors and moves with ``.to(device)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from physically_based_ray_tracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve

# 7 bits of leaf count: the wave engine wants fat leaves (16-64 triangles),
# each leaf visit one dense (tile x leaf) intersection batch
LEAF_COUNT_BITS = 7
LEAF_COUNT_MASK = (1 << LEAF_COUNT_BITS) - 1


def encode_leaf(first: int, count: int) -> int:
    assert 0 <= count <= LEAF_COUNT_MASK
    return -((first << LEAF_COUNT_BITS | count) + 1)


def decode_leaf(c):
    m = -(c + 1)
    return m >> LEAF_COUNT_BITS, m & LEAF_COUNT_MASK


@dataclasses.dataclass(frozen=True)
class BVHArrays:
    """Flattened BVH + leaf-contiguous triangle rows, on one device.

    A leaf's triangles are contiguous (padded to ``leaf_size`` rows), so a
    leaf visit reads one (K, 9) block; ``prim_index`` maps a slot back to
    the scene's triangle id (-1 for padding)."""

    nodes_box: torch.Tensor    # (N, 12) f32: c0min, c0max, c1min, c1max
    nodes_child: torch.Tensor  # (N, 2) i32: child codes (module docstring)
    tris: torch.Tensor         # (P, 9) f32: v0, e1, e2 (padding rows are 0)
    prim_index: torch.Tensor   # (P,) i32
    # per-slot Woop unit-triangle transform, row j = [M[0,:], c[0], M[1,:],
    # c[1], M[2,:], c[2]] with M = inv([e1 e2 n]), c = -M v0 (the
    # dense="woop" leaf test, ops/traverse_packet.woop_dense)
    tris_woop: torch.Tensor    # (P, 12) f32 (zero rows reject)

    @property
    def n_nodes(self) -> int:
        return self.nodes_box.shape[0]

    @property
    def n_prims(self) -> int:
        return self.tris.shape[0]

    @staticmethod
    def from_numpy(nodes_box, nodes_child, tris, prim_index, tris_woop=None,
                   device=DEFAULT_DEVICE) -> "BVHArrays":
        """Tables from numpy arrays; ``tris_woop`` is computed from ``tris``
        unless given (the JAX package's own, carried over as it is)."""
        device = resolve(device)
        if tris_woop is None:
            tris_woop = woop_from_tris(tris)

        def t(x, dtype):
            return torch.from_numpy(np.array(x, dtype=dtype)).to(device)
        return BVHArrays(nodes_box=t(nodes_box, np.float32),
                         nodes_child=t(nodes_child, np.int32),
                         tris=t(tris, np.float32),
                         prim_index=t(prim_index, np.int32),
                         tris_woop=t(tris_woop, np.float32))

    def to(self, device) -> "BVHArrays":
        return BVHArrays(*(getattr(self, f.name).to(device)
                           for f in dataclasses.fields(self)))


def woop_from_tris(tris: np.ndarray) -> np.ndarray:
    """Per-slot Woop transform (P, 12) from packed (v0, e1, e2) rows.

    M = inv([e1 e2 n]) with n = e1 x e2; c = -M v0. A point p = v0 + u e1 +
    v e2 maps to (u, v, 0), and the ray parameter t is preserved, so the
    leaf test reduces to t = -o'_z / d'_z, u = o'_x + t d'_x, v = o'_y +
    t d'_y (Woop et al. 2013 unit-triangle intersection). Degenerate /
    padded rows get M = 0, which yields d'_z = 0 and auto-rejects.
    """
    tris = np.asarray(tris, np.float64)
    v0, e1, e2 = tris[:, 0:3], tris[:, 3:6], tris[:, 6:9]
    n = np.cross(e1, e2)
    A = np.stack([e1, e2, n], axis=-1)               # columns [e1 e2 n]
    det = np.linalg.det(A)
    ok = np.abs(det) > 1e-18
    A_safe = np.where(ok[:, None, None], A, np.eye(3)[None])
    M = np.where(ok[:, None, None], np.linalg.inv(A_safe), 0.0)
    c = -np.einsum("pij,pj->pi", M, v0)
    out = np.concatenate([M[:, 0, :], c[:, 0:1],
                          M[:, 1, :], c[:, 1:2],
                          M[:, 2, :], c[:, 2:3]], axis=1)
    return np.ascontiguousarray(out, np.float32)


def sah_cost(nodes_box: np.ndarray, nodes_child: np.ndarray,
             c_trav: float = 1.0, c_int: float = 1.0) -> float:
    """Diagnostic SAH cost (the analogue of BVH::SAHCost, tiny_bvh.h:1532)."""
    def area(box):
        e = np.maximum(box[3:6] - box[0:3], 0.0)
        return 2.0 * (e[0] * e[1] + e[1] * e[2] + e[2] * e[0])

    root = np.asarray(nodes_box[0])
    root_min = np.minimum(root[0:3], root[6:9])
    root_max = np.maximum(root[3:6], root[9:12])
    root_area = area(np.concatenate([root_min, root_max]))
    if root_area <= 0:
        return 0.0
    cost = 0.0
    for n in range(nodes_box.shape[0]):
        for side in range(2):
            c = int(nodes_child[n, side])
            box = nodes_box[n, side * 6:(side + 1) * 6]
            a = area(box)
            if c >= 0:
                cost += c_trav * a
            else:
                _, count = decode_leaf(c)
                cost += c_int * a * count
    return cost / root_area
