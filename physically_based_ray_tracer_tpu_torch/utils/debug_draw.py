"""Headless debug draw: wireframe overlays on rendered images; counterpart
of ``physically_based_ray_tracer_tpu/utils/debug_draw.py``.

Lines are rasterised on the host (numpy) straight into a captured image:
``project_points`` inverts the primary-ray construction (the port's
``camera_basis``), ``draw_aabbs`` draws box wireframes, ``bvh_level_boxes``
gives the child boxes of one level of a classic 2-wide BVH. The drawing
code is the JAX package's line for line.
"""

from __future__ import annotations

import numpy as np

from physically_based_ray_tracer_tpu_torch.scene.camera import Camera, camera_basis

_EDGES = [(0, 1), (1, 3), (3, 2), (2, 0),
          (4, 5), (5, 7), (7, 6), (6, 4),
          (0, 4), (1, 5), (2, 6), (3, 7)]


def project_points(cam: Camera, pts: np.ndarray, width: int, height: int):
    """World points -> (x, y, in_front) pixel coords under the pinhole
    screen-plane model (inverse of primary_rays' construction)."""
    basis = camera_basis(cam, aspect=width / height)
    ahead = basis.ahead.cpu().numpy()
    right = basis.right.cpu().numpy()
    up = basis.up.cpu().numpy()
    pos = cam.pos.cpu().numpy()
    rel = pts - pos
    z = rel @ ahead
    in_front = z > 1e-6
    # scale onto the screen plane at distance 2
    s = 2.0 / np.where(in_front, z, 1.0)
    px = rel @ right * s
    py = rel @ up * s
    aspect = width / height
    u = (px + aspect) / (2.0 * aspect)
    v = (1.0 - py) / 2.0
    return u * width, v * height, in_front


def draw_line(img: np.ndarray, x0, y0, x1, y1, color):
    """Clip + rasterize one line segment into img (H, W, 3) in place."""
    h, w = img.shape[:2]
    n = int(max(abs(x1 - x0), abs(y1 - y0), 1)) * 2
    ts = np.linspace(0.0, 1.0, n)
    xs = np.rint(x0 + (x1 - x0) * ts).astype(np.int64)
    ys = np.rint(y0 + (y1 - y0) * ts).astype(np.int64)
    keep = (xs >= 0) & (xs < w) & (ys >= 0) & (ys < h)
    img[ys[keep], xs[keep]] = color


def draw_aabbs(img: np.ndarray, cam: Camera, lo: np.ndarray, hi: np.ndarray,
               color=(0.1, 1.0, 0.1)) -> np.ndarray:
    """Overlay AABB wireframes; lo/hi (N, 3). Returns img (modified copy)."""
    img = np.array(img, copy=True)
    h, w = img.shape[:2]
    color = np.asarray(color, img.dtype)
    for b in range(lo.shape[0]):
        corners = np.array([[x, y, z]
                            for x in (lo[b, 0], hi[b, 0])
                            for y in (lo[b, 1], hi[b, 1])
                            for z in (lo[b, 2], hi[b, 2])], np.float32)
        xs, ys, front = project_points(cam, corners, w, h)
        for a, c in _EDGES:
            if front[a] and front[c]:
                draw_line(img, xs[a], ys[a], xs[c], ys[c], color)
    return img


def bvh_level_boxes(nodes_box: np.ndarray, nodes_child: np.ndarray, level: int):
    """Child AABBs of all nodes at ``level`` (root = 0) of a 2-wide BVH --
    what to pass to draw_aabbs to see the BVH. Returns (lo (N, 3), hi (N, 3))."""
    nodes_box = np.asarray(nodes_box)
    nodes_child = np.asarray(nodes_child)
    cur = [0]
    for _ in range(level):
        nxt = []
        for n in cur:
            for side in range(2):
                c = int(nodes_child[n, side])
                if c >= 0:
                    nxt.append(c)
        if not nxt:
            break
        cur = nxt
    lo = np.concatenate([nodes_box[cur][:, [0, 1, 2]],
                         nodes_box[cur][:, [6, 7, 8]]])
    hi = np.concatenate([nodes_box[cur][:, [3, 4, 5]],
                         nodes_box[cur][:, [9, 10, 11]]])
    return lo, hi
