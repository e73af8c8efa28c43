"""Dry run of the parallel path on N ranks; the port's counterpart of
``__graft_entry__.py::dryrun_multichip``.

    python -m physically_based_ray_tracer_tpu_torch.dryrun --ranks N [--cpu]

The same four steps on the same tiny scene (a UV sphere and a floor, point,
directional and spot lights; 16 x 2N pixels, 2 bounces, no AA), on one mesh:

1. the sharded frame (film and pixels sharded, scene replicated);
2. the same frame with per-bounce ring resharding, within 2e-6 of 1;
3. instance-partitioned tracing (``max(N, 3)`` sphere instances dealt over
   the ranks), equal to the trace of the union scene;
4. one sharded train step (forward, backward, the gradients averaged
   across the ranks), its loss finite.

With ``--cpu`` it spawns N gloo ranks on the CPU. On the card one rank is
an NCCL group in this process, and N > 1 ranks are gloo processes that
share the card (one card takes one NCCL rank); the kernels are built here
before the ranks start. Exit 0 when every rank passed every step.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from physically_based_ray_tracer_tpu_torch.config import RenderConfig
from physically_based_ray_tracer_tpu_torch.diff.grad import adam, clone_params
from physically_based_ray_tracer_tpu_torch.diff.inverse import make_sharded_train_step
from physically_based_ray_tracer_tpu_torch.bvh.dense import build_dense_tlas
from physically_based_ray_tracer_tpu_torch.ops import trace
from physically_based_ray_tracer_tpu_torch.parallel.mesh import make_mesh, spawn_ranks
from physically_based_ray_tracer_tpu_torch.parallel.object_partition import (
    partition_instances, partitioned_closest)
from physically_based_ray_tracer_tpu_torch.parallel.shard import (replicate, shard_rows,
                                                                 sharded_frame)
from physically_based_ray_tracer_tpu_torch.render.film import FilmState
from physically_based_ray_tracer_tpu_torch.scene.camera import Camera
from physically_based_ray_tracer_tpu_torch.scene.lights import LightSet
from physically_based_ray_tracer_tpu_torch.scene.procedural import make_quad, make_sphere
from physically_based_ray_tracer_tpu_torch.scene.scene import Instance, MeshModel, build_scene


def tiny_scene(device):
    """``__graft_entry__.py::_tiny_scene`` on ``device``."""
    sphere = MeshModel.from_fat(make_sphere(radius=1.0, lat=8, lon=12),
                                base_color=(0.8, 0.3, 0.2), roughness=0.4)
    floor = MeshModel.from_fat(
        make_quad([-5, -1, -5], [5, -1, -5], [5, -1, 5], [-5, -1, 5]),
        base_color=(0.6, 0.6, 0.6), roughness=0.8)
    lights = LightSet.make(
        point_pos=[[2, 3, 2]], point_color=[[20, 20, 20]],
        dir_pos=[[5, 8, 3]], dir_color=[[1.5, 1.4, 1.2]],
        spot_pos=[[0, 4, 0]], spot_color=[[8, 8, 8]], spot_rot=[[0, -1, 0]],
        device=device).pad_points(4)
    scene, _depth = build_scene([sphere, floor], [Instance(0), Instance(1)], lights,
                                device=device)
    return scene, Camera.make(pos=(0, 1, 4), target=(0, 0, 0), device=device)


def run_rank(rank: int, n: int, device: str, backend: str | None) -> float:
    """The four steps on this rank; returns the train step's loss."""
    mesh = make_mesh(n, device=device, backend=backend)
    dev = mesh.device
    cfg = RenderConfig(width=16, height=n * 2, bounces=2, antialias=False,
                       skybox=False, max_stack_depth=24)
    scene, cam = replicate(mesh, tiny_scene(dev))
    n_pix = cfg.n_pixels
    ids = shard_rows(mesh, torch.arange(n_pix, dtype=torch.int32))
    film = FilmState.zeros(ids.shape[0], device=dev)

    # 1) sharded forward frame
    _, avg = sharded_frame(mesh, cfg)(scene, cam, film, 0, 0, ids)
    assert avg.shape == (n_pix // n, 3) and bool(torch.isfinite(avg).all())

    # 2) the same frame with ring resharding inside the bounce loop
    step_r = sharded_frame(mesh, cfg, reshard_block=max(n_pix // n // 2, 8))
    _, avg_r = step_r(scene, cam, film, 0, 0, ids)
    assert torch.allclose(avg_r, avg, atol=2e-6, rtol=0), \
        "resharded frame diverged from the plain sharded frame"

    # 3) instance-partitioned tracing equals the union-scene trace
    sph = make_sphere(radius=0.7, lat=8, lon=12)[0].reshape(-1, 3, 3).astype(np.float32)
    tfs = []
    for i in range(max(n, 3)):
        t = np.eye(4, dtype=np.float32)
        t[0, 3] = 2.0 * (i % 4) - 3.0
        t[2, 3] = 2.0 * (i // 4)
        tfs.append(t)
    inst_mesh = np.zeros(len(tfs), np.int64)
    ps = partition_instances([sph], inst_mesh, np.stack(tfs), n_shards=n)
    obj = make_mesh(n, axis="obj", device=device, backend=backend)
    B = 1024
    o = torch.tensor([[0.0, 0.5, 8.0]], device=dev).expand(B, 3).contiguous()
    dirs = np.random.RandomState(0).randn(B, 3).astype(np.float32)
    dirs[:, 2] = -np.abs(dirs[:, 2]) - 1.0
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    d = torch.from_numpy(dirs).to(dev)
    got = partitioned_closest(ps, obj, o, d, sort=False)
    gdb, _, _ = build_dense_tlas([sph], inst_mesh, np.stack(tfs), leaf_target=16,
                                 shape=True)
    ref = trace.intersect_closest_dense(gdb.to(dev), o, d)
    assert torch.equal(got.prim, ref.prim), "partitioned trace diverged from the union trace"

    # 4) sharded train step (forward + backward + gradient all-reduce)
    params = clone_params({"base_color": scene.mat_base, "roughness": scene.mat_rough,
                           "point_color": scene.lights.point_color})
    train = make_sharded_train_step(mesh, scene, cam, cfg, adam(params, 1e-2))
    loss = float(train(params, 0, 0, ids, torch.zeros((ids.shape[0], 3), device=dev)))
    assert np.isfinite(loss)
    obj.close()
    mesh.close()
    return loss


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    args = ap.parse_args(argv)
    n = args.ranks
    if args.cpu:
        losses = spawn_ranks(run_rank, n, args=(n, "cpu", "gloo"), backend="gloo")
    elif n == 1:
        losses = [run_rank(0, 1, "cuda", "nccl")]
    else:
        from physically_based_ray_tracer_tpu_torch.ops import _build
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun on the card: PyTorch sees no CUDA device "
                               "(pass --cpu for gloo ranks on the CPU)")
        _build.build_all()
        losses = spawn_ranks(run_rank, n, args=(n, "cuda", "gloo"), backend="gloo")
    print(f"dryrun({n} ranks, {'cpu' if args.cpu else 'cuda'}): sharded, resharded and "
          f"partitioned frames ok, train loss per rank {losses}")
    return 0 if len(set(losses)) == 1 else 1


if __name__ == "__main__":
    sys.exit(main())
