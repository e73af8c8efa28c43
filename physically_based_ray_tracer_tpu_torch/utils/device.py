"""The port's default device: the CUDA card.

Every entry point that allocates (``Renderer``, the scene builders,
``Camera.make``, ``LightSet.make``, ``DenseBVH.from_numpy``, ``BVHArrays.from_numpy``,
``FilmState.zeros``) takes ``device=DEFAULT_DEVICE`` and runs on the card
unless the caller passes ``device="cpu"``. There is no fallback: asking for
the card where there is none raises.
"""

from __future__ import annotations

import torch

DEFAULT_DEVICE = "cuda"


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; a RuntimeError if it is a CUDA
    device and PyTorch sees none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} (the port's default) was asked for, but "
            "PyTorch sees no CUDA device; pass device='cpu' to run on the CPU")
    return dev
