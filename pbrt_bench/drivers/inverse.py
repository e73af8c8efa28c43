"""Inverse-rendering steps: a closed loop of the port's train step
(``diff/inverse.py::make_train_step`` with ``diff/grad.py::adam``) on
batches of pixels drawn from the seed.

Set-up builds the scene on the card, takes the target (the reference's
render of the configuration's own parameters at key 0, sample 0, over the
whole frame; made once and cached under ``.cache/`` in the benchmark's
folder), perturbs the parameters as the traffic file says, builds one
optimiser and one train step, and runs the first ``warm_steps`` steps with
it: their losses, the optimiser's state after the first and the parameters
after the last are kept. The window runs the following steps on the same
objects. Step k draws its pixels without replacement from a generator on
the card seeded with the seed, and renders sample k at key seed.

The check: the reference runs the same first steps from the same start
(same batches, key, samples, target) and compares each step's loss, the
first gradient per leaf (the port's from Adam's first moment after one
step), and each leaf's change over the steps.
"""

from __future__ import annotations

import hashlib
import os
from pathlib import Path

import numpy as np
import torch

from pbrt_bench import port
from pbrt_bench.reference import geometry, integrator
from pbrt_bench.reference import inverse as ref_inverse

UNIT = "step"
ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / ".cache"
TARGET_CHUNK = 65536


def true_params(inputs: dict) -> dict:
    """The configuration's own values of every parameter group (numpy)."""
    models, lights = inputs["models"], inputs["lights"]
    inst = inputs["instances"]
    return {"base_color": np.array([m["base_color"] for m in models], np.float32),
            "roughness": np.array([m["roughness"] for m in models], np.float32),
            "metalness": np.array([m["metalness"] for m in models], np.float32),
            "emissive": np.array([m["emissive"] for m in models], np.float32),
            "point_color": lights["point_color"].astype(np.float32),
            "dir_color": lights["dir_color"].astype(np.float32),
            "instance_trs": {k: np.array([i[k] for i in inst], np.float32)
                             for k in ("position", "rotation", "scale")},
            "camera_pos": np.array(inputs["camera"]["pos"], np.float32),
            "camera_target": np.array(inputs["camera"]["target"], np.float32)}


def perturb(true: dict, spec: dict) -> dict:
    """The start of the fit: per group ``x * scale + add``, clamped to
    ``clamp`` where given (the traffic file's ``start``)."""
    def one(x, s):
        y = x * np.float32(s.get("scale", 1.0)) + np.asarray(s.get("add", 0.0), np.float32)
        if "clamp" in s:
            y = np.clip(y, *s["clamp"])
        return y.astype(np.float32)
    out = {}
    for k, x in true.items():
        if isinstance(x, dict):
            out[k] = {kk: one(xx, spec[k][kk]) for kk, xx in x.items()}
        else:
            out[k] = one(x, spec[k])
    return out


def target_image(ctx) -> torch.Tensor:
    """(n_pixels, 3) float32 on the card: the reference's frame at the true
    parameters, key 0, sample 0, in raster order. Cached by a hash of the
    configuration and the reference's sources."""
    render = ctx.cfg["render"]
    h = hashlib.sha256(repr(sorted(render.items())).encode())
    h.update((ROOT / "configs" / f"{ctx.cfg['name']}.json").read_bytes())
    for src in sorted((ROOT / "reference").glob("*.py")):
        h.update(src.read_bytes())
    path = CACHE / f"target-{ctx.cfg['name']}-{h.hexdigest()[:16]}.npy"
    if path.is_file():
        return torch.from_numpy(np.load(path)).to(ctx.device)
    scene = geometry.bake(ctx.inputs, ctx.device)
    n = render["width"] * render["height"]
    ids = torch.arange(n, device=ctx.device)
    with torch.no_grad():
        img = torch.cat([integrator.render_sample(scene, ids[i:i + TARGET_CHUNK], 0, 0,
                                                  render["width"], render["height"],
                                                  render["bounces"])[0]
                         for i in range(0, n, TARGET_CHUNK)])
    CACHE.mkdir(exist_ok=True)
    tmp = path.with_suffix(".tmp.npy")
    np.save(tmp, img.cpu().numpy())
    os.replace(tmp, path)
    return img


class Driver:
    unit = UNIT

    def __init__(self, ctx):
        self.ctx = ctx
        self.mods = port.load()
        t = ctx.traffic
        self.cfg = port.render_config(self.mods, ctx.cfg, dict(t["engine"], **ctx.engine))
        self.key = ctx.seed
        self.batch = t["batch_pixels"]
        self.lr = t["lr"]
        self.start = perturb(true_params(ctx.inputs), t["start"])
        self.n_pixels = self.cfg.width * self.cfg.height
        self.k = 0

    def _ids(self):
        return torch.randperm(self.n_pixels, generator=self.gen,
                              device=self.ctx.device)[:self.batch].to(torch.int32)

    def setup(self):
        g = self.mods["diff.grad"]
        dev = self.ctx.device
        self.target = target_image(self.ctx)
        scene, cam, instances = port.build_scene(self.mods, self.ctx.inputs,
                                                 self.ctx.cfg["build"], dev)
        base_inv = g.trs_params_from_instances(instances, device=dev)["base_inv"]
        start = dict(self.start, instance_trs=dict(self.start["instance_trs"]))
        self.params = g.params_from_numpy(start, device=dev)
        self.params["instance_trs"]["base_inv"] = base_inv
        self.opt = g.adam(self.params, self.lr)
        self.step = self.mods["diff.inverse"].make_train_step(scene, cam, self.cfg, self.opt)
        self.gen = torch.Generator(device=dev)
        self.gen.manual_seed(self.ctx.seed)
        names = [".".join(p) for p, _ in g.param_items(self.params)
                 if p[-1] not in g.CONSTANT_KEYS]
        leaves = g.trainable(self.params)
        before = {n: v.detach().clone() for n, v in zip(names, leaves)}
        self.losses, self.batches = [], []
        for k in range(self.ctx.traffic["warm_steps"]):
            self.batches.append(self._ids())
            self.iterate()
            if k == 0:
                # Adam's first moment after one step is (1 - beta1) g; a
                # leaf the optimiser holds no moment for took no step
                self.first_grad = {
                    n: self.opt.state.get(v, {}).get("exp_avg", torch.zeros_like(v))
                    .detach().clone() / (1.0 - g.ADAM_BETAS[0])
                    for n, v in zip(names, leaves)}
        self.change = {n: v.detach().clone() - before[n] for n, v in zip(names, leaves)}

    def iterate(self):
        ids = self.batches[self.k] if self.k < len(self.batches) else self._ids()
        loss = self.step(self.params, self.key, self.k, ids, self.target[ids.long()])
        self.losses.append(float(loss))
        self.k += 1

    def release(self):
        del self.step, self.opt, self.params

    def check(self, counts):
        """The compared numbers of ``compare_steps``, each with its limit."""
        got = dict(losses=self.losses[:len(self.batches)], first_grad=self.first_grad,
                   change=self.change)
        ref = reference_steps(self.ctx, self.start, self.batches, self.target)
        return compare_steps(got, ref, self.ctx.limits)


def reference_steps(ctx, start, batches, target, dtype=torch.float32) -> dict:
    render = ctx.cfg["render"]
    scene = geometry.bake(ctx.inputs, ctx.device, dtype)
    base_inv = ref_inverse.base_inverse(ctx.inputs["instances"])
    losses, grad, before, after = ref_inverse.run_steps(
        scene, start, base_inv, [b.long() for b in batches], target, ctx.seed,
        ctx.traffic["lr"], render["width"], render["height"], render["bounces"])
    return dict(losses=losses, first_grad={k: v.float() for k, v in grad.items()},
                change={k: after[k].float() - before[k].float() for k in after})


def leaf_gaps(got: dict, ref: dict) -> tuple[dict, dict]:
    """Per leaf, the gap of the first gradient's norm and (leaves whose
    reference gradient is at least 1e-3 of the median leaf's) of the change's
    norm, each against the larger of the leaf's reference norm and the
    median leaf's."""
    gn = {k: float(v.norm()) for k, v in ref["first_grad"].items()}
    med_g = float(np.median(list(gn.values())))
    grad = {k: abs(float(got["first_grad"][k].norm()) - gn[k]) / max(gn[k], med_g)
            for k in gn}
    cn = {k: float(ref["change"][k].norm()) for k in gn if gn[k] >= 1e-3 * med_g}
    med_c = float(np.median(list(cn.values())))
    change = {k: abs(float(got["change"][k].norm()) - cn[k]) / max(cn[k], med_c) for k in cn}
    return grad, change


def compare_steps(got: dict, ref: dict, limits: dict) -> dict:
    """``loss_gap``: the widest relative gap of a step's loss; ``grad_gap``
    and ``change_gap``: the median leaf's gap (``leaf_gaps``). The widest
    leaf's gaps swing from seed to seed with the bf16 engine's forked paths
    (PERF.md), the median leaf's hold."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
    grad, change = leaf_gaps(got, ref)
    return {"loss_gap": (loss_gap, limits["loss_gap"]),
            "grad_gap": (float(np.median(list(grad.values()))), limits["grad_gap"]),
            "change_gap": (float(np.median(list(change.values()))), limits["change_gap"])}
