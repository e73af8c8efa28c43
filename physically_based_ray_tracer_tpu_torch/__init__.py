"""PyTorch + CUDA port of the physically-based path tracer.

This package mirrors ``physically_based_ray_tracer_tpu`` module by module and
runs on an NVIDIA GPU: plain tensor code is PyTorch, and the traversal
kernels are hand-written CUDA (``csrc/traverse_bf16.cu`` for the default bf16
engine, ``csrc/traverse_f32.cu`` for the exact f32 one,
``csrc/traverse_rows.cu`` for the row-parallel exact one, ``csrc/wave_scan.cu``
and ``csrc/leaf_mt.cu`` for the wave engine), built at first use. It
imports nothing of JAX and nothing of the JAX package, so it runs where JAX
is not installed; its render configuration and the reference constants
(``config.py``) are a copy that the tests pin to the JAX package's.

Entry point: ``render.renderer.Renderer(scene, camera, cfg, device=...)`` with
``cfg.traversal == "pallas"`` and ``cfg.leaf_precision`` "bf16" (the default;
``ops/trace_bf16.py``) or "f32" (``ops/trace.py``), or with
``cfg.traversal == "pallas_rows"`` (``ops/trace_rows.py``), or with
``cfg.traversal`` "wave" or "packet" (``ops/traverse_packet.py``) or
"lane" (``ops/traverse.py``), the three on a scene built with its classic
BVH, ``legacy_bvh=True``. Every entry point
that allocates runs on the CUDA card unless the caller passes
``device="cpu"`` (``utils/device.py``); without a card the default raises.
"""

from physically_based_ray_tracer_tpu_torch.config import (
    BVH_FAR, EPSILON, MIN_DIELECTRICS_F0, NDF, P_DIRECTIONAL, P_POINT, P_SPOT,
    POINTLIGHTS, BRDFConfig, DiffuseModel, RenderConfig, RenderMode,
    SpecularModel)

__all__ = [
    "BVH_FAR", "EPSILON", "MIN_DIELECTRICS_F0", "P_DIRECTIONAL", "P_POINT",
    "P_SPOT", "POINTLIGHTS", "BRDFConfig", "DiffuseModel", "NDF",
    "RenderConfig", "RenderMode", "SpecularModel",
]
