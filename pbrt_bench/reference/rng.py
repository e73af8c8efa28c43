"""Counter-based RNG of the renderer, copied: every random number is a pure
function of ``(key, pixel_id, sample, bounce, purpose)``.

The per-stream seed is a Threefry-2x32 fold of the integer key (computed on
the host in Python ints); the per-lane PCG + Wang hashes run in int64,
masked to 32 bits after every step.
"""

from __future__ import annotations

import enum

import torch

_M32 = 0xFFFFFFFF


class Purpose(enum.IntEnum):
    AA_JITTER = 0
    LIGHT_TYPE = 1
    LIGHT_SELECT = 2
    LOBE_SELECT = 3
    BRDF_SAMPLE = 4
    AREA_LIGHT = 5
    DIELECTRIC = 6
    PIXEL_OFFSET = 7


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: tuple[int, int], count: tuple[int, int]) -> tuple[int, int]:
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011)."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rots = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0 = (count[0] + ks[0]) & _M32
    x1 = (count[1] + ks[1]) & _M32
    for i in range(5):
        for r in rots[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def stream_seed(key: int, sample: int, bounce: int, purpose: int) -> int:
    k = (0, int(key) & _M32)
    for d in (sample, bounce, int(purpose)):
        k = threefry2x32(k, (0, int(d) & _M32))
    hi, lo = threefry2x32(k, (0, 0))
    return hi ^ lo


def _pcg_hash(x: torch.Tensor) -> torch.Tensor:
    state = (x * 747796405 + 2891336453) & _M32
    word = (((state >> ((state >> 28) + 4)) ^ state) * 277803737) & _M32
    return (word >> 22) ^ word


def _wang_hash(x: torch.Tensor) -> torch.Tensor:
    x = (x ^ 61) ^ (x >> 16)
    x = (x * 9) & _M32
    x = x ^ (x >> 4)
    x = (x * 0x27D4EB2D) & _M32
    return x ^ (x >> 15)


def uniform1(key: int, pixel_id: torch.Tensor, sample: int, bounce: int,
             purpose: int, dtype=torch.float32) -> torch.Tensor:
    """One U[0,1) per lane (24-bit precision), cast to ``dtype``."""
    seed = stream_seed(key, sample, bounce, purpose)
    h = _pcg_hash((pixel_id.to(torch.int64) & _M32) ^ seed)
    h = _wang_hash((h + seed) & _M32)
    return ((h >> 8).to(torch.float32) * (1.0 / (1 << 24))).to(dtype)


def uniform2(key: int, pixel_id: torch.Tensor, sample: int, bounce: int,
             purpose: int, dtype=torch.float32) -> torch.Tensor:
    u1 = uniform1(key, pixel_id, sample, bounce, int(purpose) * 2 + 101, dtype)
    u2 = uniform1(key, pixel_id, sample, bounce, int(purpose) * 2 + 102, dtype)
    return torch.stack([u1, u2], dim=-1)
