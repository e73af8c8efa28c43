"""Rank workers of the port's parallel tests (tests/test_torch_parallel.py,
test_torch_resharding.py, test_torch_object_partition.py,
test_torch_sharded_train.py, test_torch_profiling.py).

``parallel.mesh.spawn_ranks`` runs these module-level functions in spawned
gloo processes on the CPU, one per rank. This module imports no JAX and
nothing of the JAX package, so a child imports only PyTorch and the port:
the parent builds the scenes with the JAX package, carries them over
(tests/torch_port.py) and passes them in. Each worker returns host values
(tensors come back as numpy arrays)."""

import torch

from physically_based_ray_tracer_tpu_torch.diff.grad import (adam, clone_params,
                                                             make_loss_fn, param_items)
from physically_based_ray_tracer_tpu_torch.diff.inverse import make_sharded_train_step
from physically_based_ray_tracer_tpu_torch.parallel.mesh import make_mesh
from physically_based_ray_tracer_tpu_torch.parallel.object_partition import (
    partitioned_any, partitioned_closest, table_bytes)
from physically_based_ray_tracer_tpu_torch.parallel import resharding
from physically_based_ray_tracer_tpu_torch.parallel.resharding import (ring_donate,
                                                                      ring_restore)
from physically_based_ray_tracer_tpu_torch.parallel.scaling import measure_scaling
from physically_based_ray_tracer_tpu_torch.parallel.shard import (gather_rows, replicate,
                                                                 shard_film, shard_rows,
                                                                 sharded_frame)
from physically_based_ray_tracer_tpu_torch.render.film import FilmState


def frames(rank, n, scene, cam, cfg, key, blocks):
    """The sharded frame of this rank's pixel block for each reshard block
    of ``blocks`` (0: no resharding): {block: {avg, accum, gathered}}, the
    last the whole image stitched by ``gather_rows``."""
    mesh = make_mesh(n, device="cpu")
    ids = shard_rows(mesh, torch.arange(cfg.n_pixels, dtype=torch.int32))
    film = shard_film(mesh, FilmState.zeros(cfg.n_pixels, device="cpu"))
    out = {}
    for block in blocks:
        film2, avg = sharded_frame(mesh, cfg, reshard_block=block)(scene, cam, film, key,
                                                                   0, ids)
        out[block] = dict(avg=avg, accum=film2.accum, gathered=gather_rows(mesh, avg))
    return out


def replicas(rank, n, cam):
    """``replicate`` of a tree whose values differ by rank (rank 0's must
    arrive everywhere), and of trees whose shapes differ by rank (every
    rank must raise)."""
    mesh = make_mesh(n, device="cpu")
    tree = {"x": torch.full((3,), float(rank)), "cam": cam,
            "pair": (torch.tensor([rank], dtype=torch.int64),
                     torch.full((2,), rank, dtype=torch.bfloat16))}
    got = replicate(mesh, tree)
    try:
        replicate(mesh, {"x": torch.zeros(rank + 1)})
        raised = False
    except RuntimeError:
        raised = True
    return dict(x=got["x"], pos=got["cam"].pos, pair0=got["pair"][0],
                pair1=got["pair"][1].float(), raised=raised)


def _stub(rays, live):
    """Stand-in for the traversal: a per-lane pure function."""
    r = torch.sum(rays * rays, dim=1) + 0.5
    return torch.where(live, r, torch.zeros_like(r))


def donations(rank, n, states, block):
    """For each (payload, live) of ``states`` (global arrays; this rank
    takes its block): one ``ring_donate``'s outputs, the traced round trip,
    a two-round round trip and the donated counts of the two rounds (as
    bounces 0 and 1)."""
    mesh = make_mesh(n, device="cpu")
    out = []
    for payload, live in states:
        resharding.reset_counts()
        p, lv = shard_rows(mesh, payload), shard_rows(mesh, live)
        rays2, live2, meta = ring_donate({"p": p}, lv, mesh, block)
        back = ring_restore({"r": _stub(rays2["p"], live2)}, meta, mesh)["r"]
        r3, l3, m2 = ring_donate(rays2, live2, mesh, block, bounce=1)
        res = ring_restore({"r": _stub(r3["p"], l3)}, m2, mesh)
        twice = ring_restore(res, meta, mesh)["r"]
        out.append(dict(rays2=rays2["p"], live2=live2, perm=meta.perm,
                        donated_src=meta.donated_src, donated_valid=meta.donated_valid,
                        recv_valid=meta.recv_valid, roundtrip=back, twice=twice,
                        want=_stub(p, lv), donated=dict(resharding.DONATED),
                        donated2=int(m2.donated_valid.sum())))
    return out


def partitioned(rank, n, cases):
    """For each (PartitionedScene, o, d, tmax) of ``cases``: the
    partitioned closest hit (unsorted and sorted), occlusion at ``tmax``
    and at tmax 0, and this rank's table bytes."""
    mesh = make_mesh(n, axis="obj", device="cpu")
    out = []
    for ps, o, d, tmax in cases:
        h = partitioned_closest(ps, mesh, o, d, sort=False)
        hs = partitioned_closest(ps, mesh, o, d, sort=True)
        out.append(dict(t=h.t, u=h.u, v=h.v, prim=h.prim, inst=h.inst,
                        sorted_t=hs.t, sorted_prim=hs.prim,
                        occ=partitioned_any(ps, mesh, o, d, tmax, sort=False),
                        occ_sorted=partitioned_any(ps, mesh, o, d, tmax, sort=True),
                        occ0=partitioned_any(ps, mesh, o, d, torch.zeros_like(tmax),
                                             sort=False),
                        bytes=table_bytes(ps.local(rank, mesh.device)[0])))
    return out


def train(rank, n, scene, cam, cfg, params0, target, steps, lr):
    """``steps`` sharded Adam steps from ``params0`` (replicated from rank
    0) on this rank's pixel block, key 0, sample = step: the losses, the
    first step's averaged gradients, the parameters after the first step
    and after the last; and the gradient of ``make_loss_fn(axis_name)`` at
    ``params0`` with its loss."""
    mesh = make_mesh(n, device="cpu")
    ids = shard_rows(mesh, torch.arange(cfg.n_pixels, dtype=torch.int32))
    tgt = shard_rows(mesh, target)
    params = clone_params(replicate(mesh, params0))
    loss_fn = make_loss_fn(scene, cam, cfg, tgt, ids, axis_name="tiles")
    loss = loss_fn(params, 0, 0)
    loss.backward()
    leaf_grad = {"/".join(p): v.grad.clone() for p, v in param_items(params)}
    params = clone_params(params)
    step = make_sharded_train_step(mesh, scene, cam, cfg, adam(params, lr))
    losses, grads, first = [], None, None
    for i in range(steps):
        losses.append(float(step(params, 0, i, ids, tgt)))
        if i == 0:
            grads = {"/".join(p): v.grad.clone() for p, v in param_items(params)}
            first = {"/".join(p): v.detach().clone() for p, v in param_items(params)}
    last = {"/".join(p): v.detach().clone() for p, v in param_items(params)}
    return dict(losses=losses, grads=grads, first=first, last=last,
                loss_fn_value=float(loss.detach()), loss_fn_grad=leaf_grad)


def scaling(rank, n, scene, cam, cfg, counts):
    """``measure_scaling`` on every rank (rank 0's rows, None elsewhere)."""
    return measure_scaling(scene, cam, cfg, device_counts=counts, iters=1, device="cpu")
