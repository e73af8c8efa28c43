"""Vector/matrix helpers; counterpart of ``physically_based_ray_tracer_tpu/utils/math.py``.

Torch helpers broadcast over ``(..., 3)`` tensors; quaternions are ``(..., 4)``
in ``(x, y, z, w)`` order. The 4x4 transform helpers are host-side numpy, as
in the JAX package, because they feed the scene builders. ``constant`` hands
out the small constant vectors of the shading code, made once per device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def constant(values, like: torch.Tensor) -> torch.Tensor:
    """``values`` as a tensor of ``like``'s dtype on its device, made on the
    first call and shared by every later one, so read-only: a copy from the
    host cannot be recorded into a CUDA graph, a tensor already there is
    read in place."""
    return _constant(tuple(values), like.dtype, like.device)


@functools.cache
def _constant(values: tuple, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype, device=device)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product over the trailing axis, keepdims dropped."""
    return torch.sum(a * b, dim=-1)


def dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.sum(a * b, dim=-1, keepdim=True)


def length(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v, dim=-1))


def normalize(v: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Safe normalize: v/|v| with a tiny clamp against /0 (zero stays zero)."""
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    inv = 1.0 / torch.sqrt(torch.clamp(n2, min=eps))
    return v * torch.where(n2 > 0, inv, torch.zeros_like(inv))


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def lerp(a, b, t):
    return a + (b - a) * t


def saturate(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, 0.0, 1.0)


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror direction: d - 2*(d.n)*n (d points toward the surface)."""
    return d - 2.0 * dot3(d, n) * n


def refract(d: torch.Tensor, n: torch.Tensor, eta: float) -> torch.Tensor:
    """Snell refraction with the reference's sign convention; zeros on TIR."""
    cosi = torch.clamp(dot3(d, n), -1.0, 1.0)
    entering = cosi <= 0.0
    eta_ratio = torch.where(entering, 1.0 / eta, eta)
    cos_theta = torch.abs(cosi)
    k = 1.0 - eta_ratio * eta_ratio * (1.0 - cos_theta * cos_theta)
    k_safe = torch.where(k > 0.0, k, torch.ones_like(k))
    refr = eta_ratio * (d - n * cos_theta) - n * torch.sqrt(k_safe)
    return torch.where(k <= 0.0, torch.zeros_like(d), refr)


def quat_rotation_to_z(v: torch.Tensor) -> torch.Tensor:
    """Quaternion taking unit vector ``v`` to +Z."""
    q = torch.stack([v[..., 1], -v[..., 0], torch.zeros_like(v[..., 0]),
                     1.0 + v[..., 2]], dim=-1)
    qn = normalize(q)
    flip = v[..., 2:3] < -0.99999
    identity_flip = constant([1.0, 0.0, 0.0, 0.0], v).expand(qn.shape)
    return torch.where(flip, identity_flip, qn)


def quat_invert(q: torch.Tensor) -> torch.Tensor:
    return q * constant([-1.0, -1.0, -1.0, 1.0], q)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    axis = q[..., :3]
    w = q[..., 3:4]
    return (2.0 * dot3(axis, v) * axis
            + (w * w - dot3(axis, axis)) * v
            + 2.0 * w * cross(axis, v))


# ---------------------------------------------------------------------------
# Host-side numpy transforms (scene building)
# ---------------------------------------------------------------------------

def quat_from_euler(euler_xyz) -> np.ndarray:
    """GLM-convention quaternion from Euler angles in radians."""
    rx, ry, rz = [np.asarray(e, dtype=np.float64) for e in euler_xyz]
    cx, sx = np.cos(rx * 0.5), np.sin(rx * 0.5)
    cy, sy = np.cos(ry * 0.5), np.sin(ry * 0.5)
    cz, sz = np.cos(rz * 0.5), np.sin(rz * 0.5)
    w = cx * cy * cz + sx * sy * sz
    x = sx * cy * cz - cx * sy * sz
    y = cx * sy * cz + sx * cy * sz
    z = cx * cy * sz - sx * sy * cz
    return np.stack([x, y, z, w], axis=-1)


def quat_to_matrix(q) -> np.ndarray:
    """3x3 rotation matrix from quaternion (x, y, z, w)."""
    q = np.asarray(q, dtype=np.float64)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    m = np.empty(q.shape[:-1] + (3, 3), dtype=np.float64)
    m[..., 0, 0] = 1 - 2 * (y * y + z * z)
    m[..., 0, 1] = 2 * (x * y - w * z)
    m[..., 0, 2] = 2 * (x * z + w * y)
    m[..., 1, 0] = 2 * (x * y + w * z)
    m[..., 1, 1] = 1 - 2 * (x * x + z * z)
    m[..., 1, 2] = 2 * (y * z - w * x)
    m[..., 2, 0] = 2 * (x * z - w * y)
    m[..., 2, 1] = 2 * (y * z + w * x)
    m[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return m


def compose_trs(position, rotation_euler, scale) -> np.ndarray:
    """T * R(quat-from-euler) * S as a 4x4; points transform as M @ [p, 1]."""
    t = np.eye(4)
    t[:3, 3] = np.asarray(position, dtype=np.float64)
    r = np.eye(4)
    r[:3, :3] = quat_to_matrix(quat_from_euler(np.asarray(rotation_euler, dtype=np.float64)))
    s = np.diag(list(np.asarray(scale, dtype=np.float64)) + [1.0])
    return (t @ r @ s).astype(np.float32)


def transform_points(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply 4x4 to (N,3) points."""
    return pts @ np.asarray(m[:3, :3]).T + np.asarray(m[:3, 3])


def inverse_transpose_3x3(m: np.ndarray) -> np.ndarray:
    """Normal matrix: inverse-transpose of the upper 3x3."""
    return np.linalg.inv(np.asarray(m[:3, :3], dtype=np.float64)).T.astype(np.float32)


def srgb_to_linear(c: torch.Tensor) -> torch.Tensor:
    """Exact piecewise sRGB EOTF."""
    return torch.where(c <= 0.04045, c / 12.92,
                       torch.pow((c + 0.055) / 1.055, 2.4))
