"""Counter-based RNG, bit-identical to ``physically_based_ray_tracer_tpu/utils/rng.py``.

Every random number is a pure function of ``(key, pixel_id, sample, bounce,
purpose)``. The per-stream seed is one scalar per ``(sample, bounce,
purpose)``, so it is computed here on the host in pure Python: a
Threefry-2x32 reproduction of ``jax.random.key`` / ``fold_in`` / ``bits``
(with JAX's default ``jax_threefry_partitionable=True``). Only the per-lane
PCG + Wang hashes run in torch.

``key`` is the integer seed that ``jax.random.key(key)`` would take, or a
``SeedTable``: the stream seeds of one frame held on the device, for a CUDA
graph that must not bake them in as constants (``render/graph.py``). Both
give the same bits. Torch has no full uint32 arithmetic, so the per-lane
hashes run in int64 and mask to 32 bits after every step: the low 32 bits of
a wrapped int64 product are exact because every product here stays below
2^62.
"""

from __future__ import annotations

import enum

import torch

_M32 = 0xFFFFFFFF


class Purpose(enum.IntEnum):
    """Stream selector: which decision in the integrator consumes the sample."""

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
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), as in jax.random."""
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


def make_key(seed: int) -> tuple[int, int]:
    """Key words of ``jax.random.key(seed)`` for a 32-bit seed."""
    return (0, int(seed) & _M32)


def fold_in(key: tuple[int, int], data: int) -> tuple[int, int]:
    return threefry2x32(key, (0, int(data) & _M32))


def stream_seed(key: int, sample: int, bounce: int, purpose: int) -> int:
    """Scalar uint32 seed for one logical random stream (a Python int)."""
    k = make_key(key)
    for d in (sample, bounce, int(purpose)):
        k = fold_in(k, d)
    return _final(k)


def _final(k: tuple[int, int]) -> int:
    hi, lo = threefry2x32(k, (0, 0))
    return hi ^ lo


class SeedTable:
    """The stream seeds of one frame on ``device``, for code recorded once
    and replayed every frame (a CUDA graph): passed where a ``key`` goes,
    ``seed(sample, bounce, purpose)`` hands out a 0-d int64 view of one slot
    of a device table (the same view for the same stream) and remembers the
    stream; ``fill(key, base)`` writes each remembered stream's
    ``stream_seed(key, base + sample, bounce, purpose)`` with one copy from
    host memory (pinned on a CUDA device), queued on the current stream.
    ``sample`` is thus the offset inside the frame. A stream first drawn
    after the last ``fill`` holds 0 until the next. The table holds
    ``capacity`` streams."""

    def __init__(self, capacity: int, device):
        device = torch.device(device)
        self.table = torch.zeros((capacity,), dtype=torch.int64, device=device)
        self._host = torch.zeros((capacity,), dtype=torch.int64,
                                 pin_memory=device.type == "cuda")
        self.streams: dict[tuple[int, int, int], int] = {}
        self._copied = None

    def seed(self, sample: int, bounce: int, purpose: int) -> torch.Tensor:
        stream = (sample, bounce, int(purpose))
        slot = self.streams.get(stream)
        if slot is None:
            slot = len(self.streams)
            if slot == self.table.shape[0]:
                raise ValueError(f"SeedTable: more than {slot} streams")
            self.streams[stream] = slot
        return self.table[slot]

    def fill(self, key: int, base: int) -> None:
        """Every remembered stream's seed at ``key`` and in-frame sample
        ``base + sample``; the fold-ins shared by streams are done once."""
        if self._copied is not None:
            self._copied.synchronize()      # the last copy has read the host buffer
        host = self._host.numpy()
        by_sample: dict[int, tuple[int, int]] = {}
        by_bounce: dict[tuple[int, int], tuple[int, int]] = {}
        for (sample, bounce, purpose), slot in self.streams.items():
            k = by_bounce.get((sample, bounce))
            if k is None:
                ks = by_sample.get(sample)
                if ks is None:
                    ks = by_sample[sample] = fold_in(make_key(key), base + sample)
                k = by_bounce[(sample, bounce)] = fold_in(ks, bounce)
            host[slot] = _final(fold_in(k, purpose))
        self.table.copy_(self._host, non_blocking=True)
        if self.table.is_cuda:
            self._copied = torch.cuda.Event()
            self._copied.record()


def _seed(key, sample: int, bounce: int, purpose: int):
    """A stream's seed: a Python int from an integer key, a device scalar
    from a ``SeedTable``."""
    if isinstance(key, SeedTable):
        return key.seed(sample, bounce, purpose)
    return stream_seed(key, sample, bounce, purpose)


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


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """uint32 (held in int64) -> float32 in [0, 1) with 24-bit precision."""
    return (bits >> 8).to(torch.float32) * (1.0 / (1 << 24))


def uniform1(key, pixel_id: torch.Tensor, sample: int, bounce: int,
             purpose: int) -> torch.Tensor:
    """One U[0,1) per lane, a pure function of (key, pixel_id, ids)."""
    seed = _seed(key, sample, bounce, purpose)
    h = _pcg_hash((pixel_id.to(torch.int64) & _M32) ^ seed)
    h = _wang_hash((h + seed) & _M32)
    return _bits_to_unit(h)


def uniform2(key, pixel_id: torch.Tensor, sample: int, bounce: int,
             purpose: int) -> torch.Tensor:
    """Two independent U[0,1) per lane, shape ``pixel_id.shape + (2,)``."""
    u1 = uniform1(key, pixel_id, sample, bounce, int(purpose) * 2 + 101)
    u2 = uniform1(key, pixel_id, sample, bounce, int(purpose) * 2 + 102)
    return torch.stack([u1, u2], dim=-1)
