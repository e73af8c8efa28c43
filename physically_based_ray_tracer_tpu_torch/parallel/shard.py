"""Tile-sharded rendering over a mesh; counterpart of
``physically_based_ray_tracer_tpu/parallel/shard.py``.

The flat pixel array is split over the mesh's ranks in contiguous blocks
(the blocks ``P(axis)`` gives the JAX shards) and the scene is replicated
on every rank. The per-pixel RNG depends only on global pixel ids and
kernel B1 traces each ray alone, so the f32 frame is bit-identical for
every rank count. The bf16 engine (kernel B2, like the JAX kernel it
reproduces) breaks an exact bf16 tie inside a leaf group by the ray's lane,
its co-sorted position mod 128 in the batch, so its frame follows the
batches: another chunking or sharding can give such a ray the other
triangle (ROADMAP §C). Tested on the CPU in tests/test_torch_parallel.py.

No collective runs in the forward frame (the film stays sharded) unless
ring resharding is on (``reshard_block > 0``: ``resharding.py``, inside the
bounce loop). Gradient reductions in ``diff/`` run over the same group.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from physically_based_ray_tracer_tpu_torch.config import RenderConfig
from physically_based_ray_tracer_tpu_torch.parallel.mesh import Mesh
from physically_based_ray_tracer_tpu_torch.render.film import FilmState
from physically_based_ray_tracer_tpu_torch.render.renderer import frame_fn


def pad_to_devices(n: int, n_devices: int) -> int:
    """Pixels padded so the flat array divides evenly across devices."""
    return ((n + n_devices - 1) // n_devices) * n_devices


def shard_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's contiguous block of ``x``'s leading axis, on its device
    (``tile_sharding``'s block). The axis must divide by the mesh size
    (``pad_to_devices``)."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not divide over {mesh.size} ranks "
                         "(pad with pad_to_devices)")
    k = n // mesh.size
    return x[mesh.rank * k:(mesh.rank + 1) * k].to(mesh.device)


def gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's block stitched back together in rank order (the
    inverse of ``shard_rows``), on every rank."""
    blocks = mesh.all_gather(x)
    return blocks.reshape((-1,) + tuple(x.shape[1:]))


def sharded_frame(mesh: Mesh, cfg: RenderConfig, axis: str = "tiles",
                  reshard_block: int = 0):
    """The frame function of one rank.

    Returns ``step(scene, cam, film, key, sample, pixel_ids) -> (film',
    avg)``, where ``film``, ``pixel_ids`` and the outputs are this rank's
    block (``shard_film``, ``shard_rows``) and the scene and camera are
    replicated (``replicate``); it calls ``render/renderer.py::frame_fn``
    as the JAX package's shard_map does.

    ``reshard_block > 0`` turns on per-bounce ring ray donation
    (``resharding.py``): each bounce moves up to that many surplus live
    rays to the ring neighbour and their results back. A lane's result
    depends on its ray and pixel id, not on the rank that traces it, so the
    image is unchanged (up to the bf16 engine's exact ties, which follow
    the batch). Every rank
    must then hold the same number of pixels, so that each runs the same
    chunks and bounces and takes part in every collective: the step checks
    it on every rank (one all_gather) and raises on all of them."""
    if axis != mesh.axis:
        raise ValueError(f"sharded_frame(axis={axis!r}) on a mesh of axis {mesh.axis!r}")
    if reshard_block > 0:
        cfg = cfg.replace(reshard_axis=axis, reshard_ndev=mesh.size,
                          reshard_block=reshard_block)

    def step(scene, cam, film, key, sample, pixel_ids):
        if reshard_block > 0 and mesh.size > 1:
            counts = mesh.all_gather(torch.tensor([pixel_ids.shape[0]])).tolist()
            if len(set(c[0] for c in counts)) != 1:
                raise ValueError(f"resharded frame: pixels per rank {counts} differ "
                                 "(pad with pad_to_devices)")
        return frame_fn(scene, cam, film, key, sample, pixel_ids, cfg=cfg)

    return step


def shard_film(mesh: Mesh, film: FilmState, axis: str = "tiles") -> FilmState:
    """This rank's block of every film array."""
    if axis != mesh.axis:
        raise ValueError(f"shard_film(axis={axis!r}) on a mesh of axis {mesh.axis!r}")
    return FilmState(*(shard_rows(mesh, x) for x in film))


def _map_tensors(fn, tree):
    """``tree`` with every tensor ``x`` replaced by ``fn(x)``: dataclasses,
    named tuples, tuples, lists and dicts are walked, anything else is
    kept."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: _map_tensors(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree) if f.init})
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_tensors(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_map_tensors(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {k: _map_tensors(fn, v) for k, v in tree.items()}
    return tree


def replicate(mesh: Mesh, tree):
    """``tree`` (a scene, camera, light set, parameter dict: dataclasses,
    named tuples and containers of tensors) on this rank's device, every
    tensor broadcast from rank 0: each rank ends up with rank 0's values,
    as the JAX package's replicated ``device_put`` gives every device the
    same array. The ranks must have built trees of the same structure,
    shapes and dtypes: one all_gather of a digest of them runs first, and
    a difference raises on every rank."""
    leaves = []
    _map_tensors(lambda x: leaves.append(x) or x, tree)
    h = hashlib.sha256(repr([(tuple(x.shape), str(x.dtype)) for x in leaves]).encode())
    digest = torch.from_numpy(np.frombuffer(h.digest()[:8], np.int64).copy())
    digests = mesh.all_gather(digest).reshape(-1).tolist()
    if len(set(digests)) != 1:
        raise RuntimeError("replicate: the ranks hold trees of different structure, "
                           "shapes or dtypes")
    return _map_tensors(lambda x: mesh.broadcast(x, src=0), tree)
