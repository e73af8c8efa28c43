"""Headless edit session; counterpart of ``physically_based_ray_tracer_tpu/session.py``.

The reference editor's live-edit loop without a window: every edit changes
the live scene and rewrites the JSON file behind it, and on-disk JSON edits
are folded back into the live scene.

  * ``edit_object`` moves / rotates / scales an instance: ``rebuild_scene``
    (the TLAS head and the moved instance's shading slices) and the
    GameObject JSON written back;
  * ``edit_light`` / ``edit_camera``: the live LightSet or Camera (on the
    scene's device) and their JSON written back;
  * ``render`` / ``capture``: the render side of the loop;
  * ``watch_once``: JSON files changed on disk (by an external editor) are
    read back into the live scene, so ``while True: session.watch_once();
    session.capture()`` is a whole headless editor loop.

Driven by the command line's ``--session`` (a stdin command loop).
"""

from __future__ import annotations

import dataclasses
import os

import torch

from physically_based_ray_tracer_tpu_torch.config import RenderConfig
from physically_based_ray_tracer_tpu_torch.render.renderer import Renderer
from physically_based_ray_tracer_tpu_torch.scene.camera import Camera
from physically_based_ray_tracer_tpu_torch.scene.loader import load_reference_scene
from physically_based_ray_tracer_tpu_torch.scene.scene import rebuild_scene
from physically_based_ray_tracer_tpu_torch.scene.serialization import (
    load_camera_json, load_gameobject_json, load_scene_dir, save_camera_json,
    save_gameobject_json, save_light_json)
from physically_based_ray_tracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve

_LIGHT_DIRS = {"point": "pointlights", "directional": "directionallights",
               "spot": "spotlights"}
_LIGHT_FIELDS = ("point_pos", "point_color", "point_active", "dir_pos", "dir_color",
                 "spot_pos", "spot_color", "spot_rot", "area_pos", "area_color",
                 "area_u", "area_v")


class EditSession:
    """Live edit-render session over a reference-format asset tree, on
    ``device`` (the CUDA card unless the caller passes ``device="cpu"``).
    ``load_kw`` goes to ``load_reference_scene`` (``model_paths``,
    ``include_point_lights``, ``load_sky``)."""

    def __init__(self, assets_root: str, scene_name: str = "scene1",
                 cfg: RenderConfig | None = None, device=DEFAULT_DEVICE, **load_kw):
        self.device = resolve(device)
        self.assets_root = assets_root
        self.scene_dir = os.path.join(assets_root, scene_name)
        scene, cam, depth, handle = load_reference_scene(
            assets_root, scene_name, return_handle=True, device=self.device, **load_kw)
        self.handle = handle
        self._include_point_lights = load_kw.get("include_point_lights", True)
        self.cfg = cfg or RenderConfig(
            width=256, height=256, bounces=2,
            max_stack_depth=max(depth + 2, 32), skybox=False)
        self.renderer = Renderer(scene, cam, self.cfg, device=self.device)
        self._mtimes = self._scan_mtimes()

    # -- paths -------------------------------------------------------------
    def _object_path(self, name: str) -> str:
        return os.path.join(self.scene_dir, f"{name}.json")

    def _light_path(self, kind: str, index: int) -> str:
        # the .json files in sorted order, as the loader reads them, so a
        # stray file in the directory cannot shift the index
        d = os.path.join(self.scene_dir, _LIGHT_DIRS[kind])
        files = (sorted(f for f in os.listdir(d) if f.endswith(".json"))
                 if os.path.isdir(d) else [])
        if index < len(files):
            return os.path.join(d, files[index])
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"{kind}{index}.json")

    def _camera_path(self) -> str:
        return os.path.join(self.assets_root, "prefabs/camera.json")

    def _rebuild(self, instances):
        self.renderer.scene = rebuild_scene(self.renderer.scene, self.handle, instances,
                                            device=self.device)

    # -- edits (live state + JSON write-back) ------------------------------
    def edit_object(self, name: str, position=None, rotation=None, scale=None):
        """Transform edit: TLAS / shading refresh + GameObject JSON rewrite."""
        insts = list(self.handle.instances)
        idx = next(i for i, it in enumerate(insts) if it.name == name)
        it = insts[idx]
        insts[idx] = dataclasses.replace(
            it,
            position=tuple(position) if position is not None else it.position,
            rotation=tuple(rotation) if rotation is not None else it.rotation,
            scale=tuple(scale) if scale is not None else it.scale)
        self._rebuild(insts)
        save_gameobject_json(self._object_path(name), insts[idx])
        self.renderer.reset_accumulation()

    def edit_light(self, kind: str, index: int, position=None, color=None,
                   rotation=None):
        """Light edit (``kind`` point / directional / spot): a new LightSet on
        the scene's device + the light's JSON rewritten."""
        L = self.renderer.scene.lights
        arrays = {k: getattr(L, k).cpu().numpy().copy() for k in _LIGHT_FIELDS}
        pre = {"point": "point", "directional": "dir", "spot": "spot"}[kind]
        if position is not None:
            arrays[f"{pre}_pos"][index] = position
        if color is not None:
            arrays[f"{pre}_color"][index] = color
        if rotation is not None and kind == "spot":
            arrays["spot_rot"][index] = rotation
        lights = dataclasses.replace(
            L, **{k: torch.from_numpy(v).to(self.device) for k, v in arrays.items()})
        self.renderer.scene = dataclasses.replace(self.renderer.scene, lights=lights)
        save_light_json(self._light_path(kind, index),
                        arrays[f"{pre}_pos"][index],
                        arrays[f"{pre}_color"][index],
                        arrays["spot_rot"][index] if kind == "spot"
                        else (0.0, 0.0, 0.0))
        self.renderer.reset_accumulation()

    def edit_camera(self, pos=None, target=None):
        """Fly-cam edit + camera.json rewrite (fov and distortion go back to
        their defaults, as in the JAX package)."""
        cam = self.renderer.camera
        new = Camera.make(pos=pos if pos is not None else cam.pos.cpu().numpy(),
                          target=(target if target is not None
                                  else cam.target.cpu().numpy()),
                          device=self.device)
        self.renderer.camera = new
        save_camera_json(self._camera_path(), new)
        self.renderer.reset_accumulation()

    # -- render ------------------------------------------------------------
    def render(self, samples: int = 1):
        return self.renderer.render(samples=samples)

    def capture(self, path: str | None = None) -> str:
        return self.renderer.capture(path)

    # -- external-edit watcher (disk -> live state) ------------------------
    def _scan_mtimes(self):
        out = {}
        for f in sorted(os.listdir(self.scene_dir)):
            p = os.path.join(self.scene_dir, f)
            if f.endswith(".json") and os.path.isfile(p):
                out[p] = os.path.getmtime(p)
        for sub in _LIGHT_DIRS.values():
            d = os.path.join(self.scene_dir, sub)
            if os.path.isdir(d):
                for f in sorted(os.listdir(d)):
                    if f.endswith(".json"):
                        p = os.path.join(d, f)
                        out[p] = os.path.getmtime(p)
        cp = self._camera_path()
        if os.path.exists(cp):
            out[cp] = os.path.getmtime(cp)
        return out

    def watch_once(self) -> list[str]:
        """Fold the scene JSONs changed on disk since the last scan into the
        live scene. Returns the changed files (empty: nothing to do)."""
        now = self._scan_mtimes()
        changed = [p for p, t in now.items() if self._mtimes.get(p) != t]
        self._mtimes = now
        if not changed:
            return []
        insts = list(self.handle.instances)
        reload_objects = reload_lights = False
        light_dirs = {os.path.join(self.scene_dir, s) for s in _LIGHT_DIRS.values()}
        for p in changed:
            if p == self._camera_path():
                self.renderer.camera = load_camera_json(p, device=self.device)
                continue
            if os.path.dirname(p) in light_dirs:
                reload_lights = True
                continue
            name = os.path.splitext(os.path.basename(p))[0]
            for i, it in enumerate(insts):
                if it.name == name:
                    insts[i] = load_gameobject_json(p)
                    reload_objects = True
        if reload_lights:
            _, lights = load_scene_dir(self.scene_dir,
                                       include_point_lights=self._include_point_lights,
                                       device=self.device)
            self.renderer.scene = dataclasses.replace(self.renderer.scene,
                                                      lights=lights.pad_points(4))
        if reload_objects:
            self._rebuild(insts)
        self.renderer.reset_accumulation()
        return changed
