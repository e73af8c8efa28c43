"""Per-pixel debugger; counterpart of ``physically_based_ray_tracer_tpu/render/debugger.py``.

``trace_pixel`` re-traces one pixel's primary path through the integrator
itself with its debug tap on (``trace_paths(collect_debug=True)``) and
returns one printable record per bounce; ``format_trace`` prints them;
``pixel_grid`` renders the block of pixels around it. The command line's
``--debug-pixel X Y`` prints both.
"""

from __future__ import annotations

import numpy as np
import torch

from physically_based_ray_tracer_tpu_torch.config import RenderConfig
from physically_based_ray_tracer_tpu_torch.render.integrator import (render_sample,
                                                                     trace_paths)
from physically_based_ray_tracer_tpu_torch.scene.camera import Camera, primary_rays
from physically_based_ray_tracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve


def trace_pixel(scene, cam: Camera, cfg: RenderConfig, x: int, y: int,
                key: int = 0, sample: int = 0, device=DEFAULT_DEVICE) -> list[dict]:
    """Trace pixel (x, y)'s primary ray (at the integer pixel coordinates,
    no AA jitter) on ``device``; returns one dict per bounce with its hit,
    material and lighting state (numpy values), up to the first bounce
    that missed with its path dead, then ``{"radiance": (3,)}``. ``key``
    is the integer seed (``jax.random.key(key)`` in the JAX package)."""
    device = resolve(device)
    scene, cam = scene.to(device), cam.to(device)
    pixel_id = torch.tensor([y * cfg.width + x], dtype=torch.int32, device=device)
    xs = torch.tensor([float(x)], device=device)
    ys = torch.tensor([float(y)], device=device)
    o, d = primary_rays(cam, xs, ys, cfg.width, cfg.height, panini=cfg.post_processed)
    radiance, _, dbg = trace_paths(scene, cfg, o, d, pixel_id, key, sample,
                                   collect_debug=True)
    host = {k: v.cpu().numpy() for k, v in dbg.items()}
    out = []
    for b in range(cfg.bounces):
        rec = {k: v[b, 0] for k, v in host.items()}
        rec["bounce"] = b
        out.append(rec)
        if not rec["alive_out"] and rec["hit_prim"] < 0:
            break
    out.append({"radiance": radiance.cpu().numpy()[0]})
    return out


def format_trace(records: list[dict]) -> str:
    """trace_pixel's records as text, one block per bounce."""
    lines = []
    for r in records:
        if "radiance" in r:
            lines.append(f"final radiance = {r['radiance']}")
            continue
        b = r["bounce"]
        if r["hit_prim"] < 0:
            lines.append(f"[bounce {b}] MISS  o={r['ray_o']} d={r['ray_d']}")
            continue
        lines.append(
            f"[bounce {b}] prim={int(r['hit_prim'])} inst={int(r['hit_inst'])}"
            f" t={r['hit_t']:.5f} uv=({r['hit_u']:.3f},{r['hit_v']:.3f})\n"
            f"    point={r['point']} shad_n={r['shad_n']}\n"
            f"    base={r['base_color']} metal={r['metalness']:.3f}"
            f" rough={r['roughness']:.3f}"
            f" dielectric={bool(r['is_dielectric'])}\n"
            f"    vertex_radiance={r['vertex_radiance']}"
            f" lobe={'SPEC' if r['picked_specular'] else 'DIFF'}"
            f" next_dir={r['next_dir']} alive={bool(r['alive_out'])}")
    return "\n".join(lines)


def pixel_grid(scene, cam: Camera, cfg: RenderConfig, x: int, y: int,
               radius: int = 3, key: int = 0, sample: int = 0,
               device=DEFAULT_DEVICE) -> np.ndarray:
    """Render the (2*radius)^2 pixel block centred on (x, y) on ``device``
    (``render_sample``, AA as ``cfg`` says). Returns (2r, 2r, 3) colours."""
    device = resolve(device)
    xs = np.clip(np.arange(x - radius, x + radius), 0, cfg.width - 1)
    ys = np.clip(np.arange(y - radius, y + radius), 0, cfg.height - 1)
    gx, gy = np.meshgrid(xs, ys)
    ids = torch.from_numpy((gy * cfg.width + gx).reshape(-1).astype(np.int32)).to(device)
    color, _ = render_sample(scene.to(device), cam.to(device), cfg, key, sample, ids)
    return color.cpu().numpy().reshape(2 * radius, 2 * radius, 3)
