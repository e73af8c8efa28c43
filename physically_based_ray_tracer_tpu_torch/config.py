"""Render configuration; counterpart of ``physically_based_ray_tracer_tpu/config.py``.

The same enums, constants and frozen dataclasses, field for field and
default for default (``tests/test_torch_port.py`` pins them to the JAX
package's), carried over so that the port imports nothing of the JAX
package. Every field is kept, including those of engines the port does not
have: ``render.integrator.check_supported`` refuses each unported value by
name rather than the port silently ignoring it.
"""

from __future__ import annotations

import dataclasses
import enum


class RenderMode(enum.IntEnum):
    """AOV selector (only BRDF, the shaded image, is ported)."""

    BRDF = 0
    BASECOLOR = 1
    GEOMETRYNORMAL = 2
    SHADINGNORMAL = 3
    METAL = 4
    ROUGHNESS = 5
    EMMISIVE = 6
    DEPTH = 7
    PRIMID = 8


class NDF(enum.IntEnum):
    """Microfacet normal distribution."""

    GGX = 1
    BECKMANN = 2


class DiffuseModel(enum.IntEnum):
    NONE = 0
    LAMBERTIAN = 1
    OREN_NAYAR = 2
    DISNEY = 3
    FROSTBITE = 4


class SpecularModel(enum.IntEnum):
    NONE = 0
    MICROFACET = 1
    PHONG = 2


EPSILON = 0.01               # ray-offset epsilon
MIN_DIELECTRICS_F0 = 0.4     # reference quirk: 0.4, not the usual 0.04
POINTLIGHTS = 4              # point-light slots of a LightSet
BVH_FAR = 1e30               # "miss" sentinel distance

# Stochastic NEE light-type selection probabilities.
P_POINT = 0.3
P_DIRECTIONAL = 0.5
P_SPOT = 0.2


@dataclasses.dataclass(frozen=True)
class BRDFConfig:
    """Static BRDF model selection."""

    ndf: NDF = NDF.GGX
    specular: SpecularModel = SpecularModel.MICROFACET
    diffuse: DiffuseModel = DiffuseModel.LAMBERTIAN
    use_vndf_sampling: bool = True
    use_spherical_caps_vndf: bool = False
    use_height_correlated_g2: bool = True
    use_optimized_g2: bool = True
    use_reflectance_parameter: bool = False
    combine_brdfs_with_fresnel: bool = True


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Runtime render flags. The port carries ``traversal="pallas"`` with
    both engines (``leaf_precision="bf16"``, the default, and ``"f32"``),
    ``"pallas_rows"``, ``"wave"`` (``dense`` "mt" or "woop"), ``"packet"``
    and ``"lane"``, and refuses the values it does not carry; see
    ``render.integrator.check_supported``."""

    width: int = 1280
    height: int = 720
    bounces: int = 2
    rendering_mode: RenderMode = RenderMode.BRDF
    lighted: bool = True
    gamma_corrected: bool = True
    normal_mapped: bool = True
    skybox: bool = True
    antialias: bool = True            # 2 jittered rays/pixel
    post_processed: bool = False
    post_preset: int = 2
    stochastic_lights: bool = True    # NEE light-type lottery
    accumulate: bool = True
    samples_per_pixel: int = 1
    brdf: BRDFConfig = dataclasses.field(default_factory=BRDFConfig)
    exact_point_falloff: bool = False  # 1/d^2 instead of the reference's 1/d
    exact_shadow_tmax: bool = False    # point-shadow tmax dist, not dist^2
    one_shadow_ray: bool = False       # one picked point light x NP
    depth_keyed_accum: bool = True
    chunk_pixels: int = 65536          # wavefront chunk: bounds live memory
    shade_tile: int = 0
    traversal: str = "pallas"
    leaf_precision: str = "bf16"
    sort_rays: bool = True             # octant+Morton sort of bounce/shadow rays
    packet_tile: int = 128
    dense: str = "mt"
    wave_shrink: int = 8
    pixel_order: str = "morton"        # "morton" | "scanline"
    reshard_axis: str | None = None
    reshard_ndev: int = 0
    reshard_block: int = 1024
    max_stack_depth: int = 48
    leaf_size: int = 16
    dtype: str = "float32"

    @property
    def n_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)
