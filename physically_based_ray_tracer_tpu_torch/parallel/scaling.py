"""Scaling-efficiency harness; counterpart of
``physically_based_ray_tracer_tpu/parallel/scaling.py``.

``measure_scaling`` times the same total frame on 1, 2, ... ranks and
reports the efficiency against linear scaling; ``measure_work_invariance``
times, in one process, the unsharded cost of the pixel subset one of n
ranks would own. Ranks that share one card (gloo ranks on one GPU, or the
CPU) contend for it, so their times measure the harness, not the
scaling; one rank per card gives the real table (parallel/README.md).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

from physically_based_ray_tracer_tpu_torch.config import RenderConfig
from physically_based_ray_tracer_tpu_torch.parallel.mesh import make_mesh
from physically_based_ray_tracer_tpu_torch.parallel.shard import shard_rows, sharded_frame
from physically_based_ray_tracer_tpu_torch.render.film import FilmState
from physically_based_ray_tracer_tpu_torch.render.renderer import frame_fn
from physically_based_ray_tracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve
from physically_based_ray_tracer_tpu_torch.utils.timer import ray_count


def measure_scaling(scene, cam, cfg: RenderConfig, device_counts=None, iters: int = 3,
                    key: int = 0, device=DEFAULT_DEVICE, backend: str | None = None):
    """Runs on every rank of an initialised process group (``scene`` and
    ``cam`` replicated on each). For each count n it builds a mesh over
    ranks 0..n-1 (``make_mesh``; every rank takes part in the group's
    creation), those ranks render the frame sharded, and the others wait at
    a barrier. Returns, on rank 0, [{'devices': n, 'ms': t, 'mrays_per_s':
    r, 'efficiency': e}] (e = rays/s(n) / (n * rays/s(1))); None on the
    other ranks. A timed frame ends when the sum of every rank's image has
    reached rank 0 (one all_reduce), as the JAX harness fetches a sum of
    the sharded output."""
    resolve(device)
    world = dist.get_world_size()
    if device_counts is None:
        device_counts = [d for d in (1, 2, 4, 8, 16, 32) if d <= world]
    n_pix = cfg.n_pixels
    rays = ray_count(cfg, n_pix, n_point_lights=int(scene.lights.n_point))

    results = []
    base_rate = None
    for nd in device_counts:
        assert n_pix % nd == 0, f"{n_pix} pixels not divisible by {nd} devices"
        mesh = make_mesh(nd, axis=f"scaling{nd}", device=device, backend=backend)
        if mesh is not None:
            step = sharded_frame(mesh, cfg, axis=mesh.axis)
            ids = shard_rows(mesh, torch.arange(n_pix, dtype=torch.int32))
            film = FilmState.zeros(ids.shape[0], device=mesh.device)

            def sync(out):
                return float(mesh.psum(out[1].sum()))

            sync(step(scene, cam, film, key, 0, ids))
            times = []
            for i in range(iters):
                t0 = time.perf_counter()
                sync(step(scene, cam, film, key, i + 1, ids))
                times.append(time.perf_counter() - t0)
            t = sorted(times)[len(times) // 2]
            rate = rays / t / 1e6
            if base_rate is None:
                base_rate = rate
            results.append({"devices": nd, "ms": t * 1e3, "mrays_per_s": rate,
                            "efficiency": rate / (nd * base_rate)})
            mesh.close()
        dist.barrier()
    return results if dist.get_rank() == 0 else None


def measure_work_invariance(scene, cam, cfg: RenderConfig, divisors=(1, 2, 4, 8),
                            iters: int = 3, key: int = 0):
    """Contention-free scaling evidence, in one process: the UNSHARDED cost
    of exactly the pixel subset each of n ranks would own (a STRIDED 1/n
    subset, a load-balanced shard's work). If cost(B/n) ~= cost(B)/n
    (normalized ratio ~= 1), the per-rank work is invariant under sharding;
    the forward frame has no collective, so the sharded frame's efficiency
    is this invariance times (1 - launch skew).

    Returns [{'divisor': n, 'ms': t, 'normalized_cost': cost_n/(cost_1/n)}],
    each ``ms`` the median of ``iters`` frames after a warm-up, each frame
    ending in a device sync (a host fetch of its sum)."""
    n_pix = cfg.n_pixels
    dev = scene.tri_v0.device
    results = []
    base = None
    for nd in divisors:
        assert n_pix % nd == 0
        ids = torch.arange(0, n_pix, nd, dtype=torch.int32, device=dev)
        film = FilmState.zeros(n_pix // nd, device=dev)

        def run(sample):
            return float(frame_fn(scene, cam, film, key, sample, ids, cfg=cfg)[1].sum())

        run(0)
        times = []
        for i in range(iters):
            t0 = time.perf_counter()
            run(i + 1)
            times.append(time.perf_counter() - t0)
        t = sorted(times)[len(times) // 2]
        if base is None:
            base = t
        results.append({"divisor": nd, "ms": t * 1e3, "normalized_cost": t / (base / nd)})
    return results
