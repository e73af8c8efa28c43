"""PyTorch + CUDA port of the physically-based path tracer.

This package mirrors ``physically_based_ray_tracer_tpu`` module by module and
runs on an NVIDIA GPU: plain tensor code is PyTorch, and the traversal kernel
is hand-written CUDA (``csrc/traverse_f32.cu``), built at first use. It
imports nothing of JAX and nothing of the JAX package, so it runs where JAX
is not installed; its render configuration and the reference constants
(``config.py``) are a copy that the tests pin to the JAX package's.

Entry point: ``render.renderer.Renderer(scene, camera, cfg, device=...)`` with
``cfg.leaf_precision == "f32"`` and ``cfg.traversal == "pallas"`` (the exact
traversal engine; see ``ops/trace.py``).
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
