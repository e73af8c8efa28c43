"""Moving frames: the reference game's tick loop. One player in a closed
loop of ``Renderer.tick(key=seed, instances=poses)`` calls: each tick
advances game time by ``1 / ticks_per_s``, moves every instance of the
moving model to its pose at that tick (the program re-bakes them and
refreshes the TLAS inside the tick), renders into the film, whose pixels
restart their running mean only where their primary-hit distance moved,
and fetches the frame to the host.

The poses are traffic data, closed-form in the tick index and drawn from
the seed (``Motion``). Set-up builds the scene at tick 0's poses through
``build_scene_instanced`` (the handle is kept for the renderer) and warms
up with tick 1, a moving tick. Each window iteration is the next tick.

The check: for the warm-up tick and the window's last tick, the reference
bakes that tick's instances from scratch (no refresh, no TLAS), renders a
sample of the film's slots drawn from the seed (the same slots each tick)
at the tick's key and sample, applies the film's step to the film before
the tick, and compares the film after it and the image the tick
returned, slot by slot, as the frames driver does.

The sound readings that set the cell's limit come from
``python3 -m pbrt_bench.control --workload game-bf16-moving --seeds ...``
(with ``--control``: the reference in bfloat16 in the program's place);
the faults' readings from ``pbrt_bench/tests/test_moving.py``.
"""

from __future__ import annotations

import inspect

import numpy as np

from pbrt_bench import port
from pbrt_bench.drivers import frames
from pbrt_bench.reference import geometry, integrator

UNIT = "frame"
MOTION_STREAM = 0x6D6F7665      # the motion's own stream of the seed's generator


class Motion:
    """Seeded closed-form trajectories of the instances of model
    ``spec["model"]`` (the others stay as configured).

    Horizontal: a straight line at a speed drawn from ``spec["speed"]``
    (m/s) in a direction drawn from the seed, reflected at
    |x|, |z| = ``spec["bound"]``. Each axis moves on a lattice of
    2 * bound / n steps, one step a tick (n drawn from the velocity), so
    a reflection falls on a tick and every tick moves an instance by the
    full horizontal step. Vertical: a ballistic bounce on the floor under
    ``spec["gravity"]`` with its apex drawn from ``spec["apex"]`` (m) and a
    phase drawn from the seed, above the configured rest height. Spin: the
    configured Euler angles plus a seeded unit axis times a rate drawn
    from ``spec["spin"]`` (rad/s) times the game time."""

    def __init__(self, instances: list[dict], spec: dict, seed: int):
        rng = np.random.default_rng([seed & 0xFFFFFFFF, seed >> 32, MOTION_STREAM])
        self.instances = instances
        self.moving = [i for i, x in enumerate(instances) if x["model"] == spec["model"]]
        self.tps = float(spec["ticks_per_s"])
        self.bound = float(spec["bound"])
        self.g = float(spec["gravity"])
        m = len(self.moving)
        speed = rng.uniform(*spec["speed"], size=m) / self.tps        # m a tick
        theta = rng.uniform(0.0, 2.0 * np.pi, size=m)
        u = np.stack([speed * np.cos(theta), speed * np.sin(theta)], -1)     # (m, 2): x, z
        self.n = np.maximum(1, np.rint(2.0 * self.bound / np.maximum(np.abs(u), 1e-9))
                            ).astype(np.int64)
        self.sign = np.where(u < 0, -1, 1).astype(np.int64)
        start = np.array([[instances[i]["position"][0], instances[i]["position"][2]]
                          for i in self.moving], np.float64)
        self.j0 = np.clip(np.rint((start + self.bound) / (2.0 * self.bound) * self.n), 0,
                          self.n).astype(np.int64)
        apex = rng.uniform(*spec["apex"], size=m)
        self.v0 = np.sqrt(2.0 * self.g * apex)
        self.period = 2.0 * self.v0 / self.g
        self.phase = rng.uniform(0.0, 1.0, size=m) * self.period
        axis = rng.normal(size=(m, 3))
        self.spin = (axis / np.linalg.norm(axis, axis=1, keepdims=True)
                     * rng.uniform(*spec["spin"], size=(m, 1)))

    def poses(self, k: int) -> list[dict]:
        """Every instance at tick ``k`` (the scene inputs' form: model,
        position, rotation, scale)."""
        p = self.j0 + self.sign * k
        m = np.mod(p, 2 * self.n)
        idx = np.where(m <= self.n, m, 2 * self.n - m)
        xz = -self.bound + idx * (2.0 * self.bound / self.n)
        t = k / self.tps
        s = np.mod(t + self.phase, self.period)
        out = [dict(x) for x in self.instances]
        for j, i in enumerate(self.moving):
            rest = self.instances[i]
            y = rest["position"][1] + self.v0[j] * s[j] - 0.5 * self.g * s[j] ** 2
            out[i]["position"] = [float(xz[j, 0]), float(y), float(xz[j, 1])]
            out[i]["rotation"] = [float(r + w * t) for r, w in zip(rest["rotation"],
                                                                  self.spin[j])]
        return out


def port_instances(mods, poses: list[dict]) -> list:
    sc = mods["scene.scene"]
    return [sc.Instance(i["model"], position=tuple(i["position"]),
                        rotation=tuple(i["rotation"]), scale=tuple(i["scale"]))
            for i in poses]


def build_scene(mods, inputs: dict, poses: list[dict], build: dict, device):
    """(SceneData, InstancedScene handle, Camera) on ``device``, built by
    the port's ``build_scene_instanced`` at ``poses``, without the classic
    BVH (no dense engine reads it)."""
    sc = mods["scene.scene"]
    models = [sc.MeshModel(corners=m["corners"], normals=m["normals"], uvs=m["uvs"],
                           face_normals=m["face_normals"], base_color=tuple(m["base_color"]),
                           metalness=m["metalness"], roughness=m["roughness"],
                           emissive=tuple(m["emissive"]), transmissivness=m["transmissivness"],
                           reflectance=m["reflectance"], opacity=m["opacity"])
              for m in inputs["models"]]
    lights = {k: (v if len(v) else None) for k, v in inputs["lights"].items()}
    light_set = mods["scene.lights"].LightSet.make(**lights, device=device)
    scene, handle, _ = sc.build_scene_instanced(models, port_instances(mods, poses), light_set,
                                                legacy_bvh=False, device=device, **build)
    cam = mods["scene.camera"].Camera.make(pos=inputs["camera"]["pos"],
                                           target=inputs["camera"]["target"], device=device)
    return scene, handle, cam


class Driver:
    unit = UNIT

    def __init__(self, ctx):
        self.ctx = ctx
        self.mods = port.load()
        renderer = self.mods["render.renderer"].Renderer
        if "instances" not in inspect.signature(renderer.tick).parameters:
            raise SystemExit("the program under test cannot move instances inside a tick "
                             "(Renderer.tick has no instances argument)")
        t = ctx.traffic
        self.cfg = port.render_config(self.mods, ctx.cfg, dict(t["engine"], **ctx.engine))
        self.key = ctx.seed
        self.motion = Motion(ctx.inputs["instances"], t["motion"], ctx.seed)

    def setup(self):
        scene, handle, cam = build_scene(self.mods, self.ctx.inputs, self.motion.poses(0),
                                         self.ctx.cfg["build"], self.ctx.device)
        self.renderer = self.mods["render.renderer"].Renderer(scene, cam, self.cfg,
                                                              device=self.ctx.device,
                                                              handle=handle)
        self.k = 0
        self.iterate()
        self.ticks = [self.last]

    def poses(self, k: int) -> list:
        return port_instances(self.mods, self.motion.poses(k))

    def iterate(self):
        """The next tick; keeps its index, sample, the films before and
        after it (the renderer replaces its film, never writes it) and the
        image."""
        self.k += 1
        r = self.renderer
        before, sample = r.film, r.sample
        img = r.tick(self.key, instances=self.poses(self.k))
        self.last = (self.k, sample, before, r.film, img)

    def release(self):
        """Drop the program's scene; keep the films the check reads."""
        self.ticks.append(self.last)
        del self.renderer

    def check(self, counts: integrator.QueryCount):
        """The compared number with its limit: ``pixels_off``, the share of
        checked film slots that differ from the reference."""
        ctx = self.ctx
        off, total = compare_ticks(ctx.inputs, ctx.cfg["render"], ctx.seed, self.motion,
                                   self.ticks, ctx.traffic["check"]["slots"], ctx.device, counts)
        return {"pixels_off": (off / total, self.ctx.limits["pixels_off"])}


def compare_ticks(inputs: dict, render: dict, seed: int, motion: Motion, ticks, n_slots: int,
                  dev, counts=None):
    """(slots off, slots checked) over ``ticks`` (per tick: index, sample,
    film before, film after, returned image): the frames driver's check of
    each tick against the reference baked from scratch at that tick's
    poses on ``dev``."""
    off = total = 0
    for k, *tick in ticks:
        ref_scene = geometry.bake(dict(inputs, instances=motion.poses(k)), dev)
        o, t = frames.compare_ticks(ref_scene, render, seed, [tuple(tick)], n_slots, counts)
        off, total = off + o, total + t
    return off, total
