"""Process groups and their collectives; counterpart of
``physically_based_ray_tracer_tpu/parallel/mesh.py``.

A JAX mesh axis is a ``torch.distributed`` process group here, one rank per
device. ``shard_map`` over the axis becomes "each rank runs the local
function on its contiguous block of the leading axis": the block that
``P(axis)`` gives shard r, so the blocks are the same. The collectives of
the JAX code are methods of ``Mesh``:

    JAX                    Mesh
    psum / pmin / pmax     psum / pmin / pmax (all_reduce SUM / MIN / MAX)
    pmean                  pmean (all_reduce SUM, divided by the size)
    all_gather             all_gather (stacked on a new leading axis)
    ppermute ring shift    shift (batch_isend_irecv: one isend to
                           (r + off) % n and one irecv from (r - off) % n)
    axis_index             Mesh.rank

``tile_sharding`` and ``replicated_sharding`` have no torch object to
return: this rank's block is ``shard_rows(mesh, x)`` and the blocks
stitched back together are ``gather_rows(mesh, x)`` (``shard.py``), and a
replicated tree is ``shard.replicate``'s.

``RenderConfig`` carries only the axis name (``reshard_axis``), so a
``Mesh`` registers itself under its name and the integrator finds it with
``lookup``. A name with no live group raises: nothing renders unsharded in
its place.

Backends: NCCL on the card, gloo on the CPU. NCCL takes one rank per card,
so several ranks that share one card run gloo (``backend="gloo"``). Gloo
does not send CUDA tensors: under gloo on the card each collective copies
its tensor to host memory, runs there and copies the result back
(``Mesh._copy``). Tracing and shading stay on the card.

``spawn_ranks`` runs a function in N spawned processes on this host, each a
rank of one process group; ``distribute_init`` joins a group started by
another launcher (one process per card, e.g. ``torchrun``).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import socket
import time
import traceback

import torch
import torch.distributed as dist

from physically_based_ray_tracer_tpu_torch.utils.device import DEFAULT_DEVICE, resolve

# live meshes by axis name (RenderConfig.reshard_axis names one)
_MESHES: dict = {}
_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}


@dataclasses.dataclass
class Mesh:
    """One mesh axis: a process group with one rank per device.

    ``group`` is the process group (ranks 0..size-1 of the default group,
    in order, so a rank in the group is its global rank); ``device`` is this
    rank's device. ``owns_init``: this mesh started the (one-rank) process
    group and ``close`` ends it."""

    group: object
    axis: str
    size: int
    rank: int
    device: torch.device
    backend: str
    owns_init: bool = False

    def _copy(self, x: torch.Tensor) -> torch.Tensor:
        """A fresh contiguous copy of ``x`` where the collective runs: the
        host under gloo (also for a rank on the card: gloo sends no CUDA
        tensors), this rank's card under NCCL."""
        wire = "cpu" if self.backend == "gloo" else self.device
        return x.detach().to(wire, copy=True).contiguous()

    @staticmethod
    def _bytes(x: torch.Tensor) -> torch.Tensor:
        """Contiguous ``x`` as bytes: data movement takes any dtype (bool and
        bfloat16 included) as a byte buffer."""
        return x.reshape(-1).view(torch.uint8)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """All-reduce of ``x`` (``op`` "sum", "min" or "max") into a new
        tensor on ``x``'s device; ``x`` is not written."""
        if x.dtype == torch.bool:
            raise TypeError("all_reduce of a bool tensor: cast it to an integer type")
        buf = self._copy(x)
        dist.all_reduce(buf, op=_OPS[op], group=self.group)
        return buf.to(x.device)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self.all_reduce(x, "sum")

    def pmin(self, x: torch.Tensor) -> torch.Tensor:
        return self.all_reduce(x, "min")

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        return self.all_reduce(x, "max")

    def pmean(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the group divided by its size (``lax.pmean``)."""
        return self.all_reduce(x, "sum") / self.size

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """(size, *x.shape): every rank's ``x``, in rank order."""
        buf = self._copy(x)
        outs = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather([self._bytes(o) for o in outs], self._bytes(buf), group=self.group)
        return torch.stack(outs).to(x.device)

    def shift(self, xs: list, offset: int) -> list:
        """Ring shift (``ppermute`` with pairs (i, (i + offset) % n)): each
        tensor of ``xs`` goes to rank (rank + offset) % n and the result is
        rank (rank - offset) % n's, for every tensor in one
        ``batch_isend_irecv``. Every rank's tensors must have the same
        shapes and dtypes."""
        n = self.size
        if n == 1 or offset % n == 0:
            return [x.clone() for x in xs]
        send = [self._copy(x) for x in xs]
        recv = [torch.empty_like(b) for b in send]
        ops = []
        for s, r in zip(send, recv):
            ops.append(dist.P2POp(dist.isend, self._bytes(s), (self.rank + offset) % n,
                                  self.group))
            ops.append(dist.P2POp(dist.irecv, self._bytes(r), (self.rank - offset) % n,
                                  self.group))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return [r.to(x.device) for r, x in zip(recv, xs)]

    def broadcast(self, x: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``x`` on every rank, as a new tensor on this rank's
        device; ``x`` is not written."""
        buf = self._copy(x)
        dist.broadcast(self._bytes(buf), src=src, group=self.group)
        return buf.to(self.device)

    def close(self) -> None:
        """Unregister the axis name; end the process group if this mesh
        started it."""
        if _MESHES.get(self.axis) is self:
            del _MESHES[self.axis]
        if self.owns_init and dist.is_initialized():
            dist.destroy_process_group()


def make_mesh(n_devices: int | None = None, axis: str = "tiles", device=DEFAULT_DEVICE,
              backend: str | None = None) -> Mesh | None:
    """A mesh over ranks 0..n_devices-1 of the process group (all of them
    by default), registered under ``axis``. Every rank of the process group
    must call it (``new_group`` is collective); a rank outside the first
    ``n_devices`` gets None.

    ``device``: "cuda" (the default) is this rank's card, ``LOCAL_RANK``
    (or the rank) modulo the cards present; no card raises. ``backend``:
    NCCL on the card and gloo on the CPU unless named. With no process
    group and ``n_devices`` 1 or None, a one-rank group is started in this
    process (``Mesh.close`` ends it); more ranks need one started first
    (``distribute_init``, ``spawn_ranks`` or ``torchrun``)."""
    dev = resolve(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    owns = False
    if not dist.is_initialized():
        if n_devices not in (None, 1):
            raise RuntimeError(
                f"make_mesh(n_devices={n_devices}): no process group; start one "
                "rank per device first (distribute_init, spawn_ranks or torchrun)")
        # a one-rank group needs no network: an in-process store, and NCCL's
        # bootstrap socket on the loopback interface
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
        owns = True
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if not 1 <= n <= world:
        raise ValueError(f"make_mesh(n_devices={n}) in a process group of {world}")
    if n == world and dist.get_backend() == backend:
        group = dist.group.WORLD
    else:
        group = dist.new_group(list(range(n)), backend=backend)
    rank = dist.get_rank()
    if rank >= n:
        return None
    if dev.type == "cuda" and dev.index is None:
        local = int(os.environ.get("LOCAL_RANK", rank))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = Mesh(group=group, axis=axis, size=n, rank=rank, device=dev, backend=backend,
                owns_init=owns)
    _MESHES[axis] = mesh
    return mesh


def lookup(axis: str) -> Mesh:
    """The live mesh registered under ``axis`` (``make_mesh``); a
    RuntimeError if there is none."""
    mesh = _MESHES.get(axis)
    if mesh is None or not dist.is_initialized():
        raise RuntimeError(
            f"reshard_axis={axis!r} names no live process group: build one with "
            f"parallel.mesh.make_mesh(axis={axis!r}) on every rank (a resharded "
            "frame is never rendered unsharded)")
    return mesh


def distribute_init(coordinator: str | None = None, num_processes: int | None = None,
                    process_id: int | None = None, backend: str = "nccl") -> None:
    """Join a process group of ``num_processes`` ranks whose rank 0 listens
    at ``coordinator`` ("host:port"), as this rank ``process_id``. A no-op
    for one process, as in the JAX package. A failed join raises."""
    if num_processes and num_processes > 1:
        dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                                world_size=num_processes, rank=process_id)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _to_host(x):
    """Tensors of a rank's result as numpy arrays (dicts, lists and tuples
    walked), so the result crosses the process boundary by value."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    if isinstance(x, dict):
        return {k: _to_host(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)) and not hasattr(x, "_fields"):
        return type(x)(_to_host(v) for v in x)
    return x


def _rank_main(rank, n, port, backend, env, fn, args, results):
    os.environ.update(env)
    torch.set_num_threads(1)
    try:
        distribute_init(f"127.0.0.1:{port}", n, rank, backend)
        out = _to_host(fn(rank, *args))
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, n_ranks: int, args: tuple = (), backend: str = "gloo",
                timeout: float = 600.0) -> list:
    """Run ``fn(rank, *args)`` in ``n_ranks`` spawned processes on this
    host, each a rank of one process group (``backend``, rendezvous over
    127.0.0.1); returns every rank's result in rank order, its tensors as
    numpy arrays. ``fn`` builds its meshes itself (``make_mesh``) and must
    be importable by name (a module-level function). Each child runs one
    PyTorch thread (ranks share the host's cores).

    Nothing falls back: a rank that raises, a child that exits non-zero and
    a run longer than ``timeout`` seconds raise a RuntimeError after every
    child is stopped."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    # one host: the loopback interface carries gloo's and NCCL's sockets
    env = {k: "lo" for k in ("GLOO_SOCKET_IFNAME", "NCCL_SOCKET_IFNAME")
           if k not in os.environ}
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, n_ranks, port, backend, env, fn, args, results))
             for r in range(n_ranks)]
    for p in procs:
        p.start()
    out, errors = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(out) + len(errors) < n_ranks:
            try:
                rank, ok, value = results.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in out]
                if dead:
                    raise RuntimeError(f"rank(s) {dead} exited with "
                                       f"{[procs[r].exitcode for r in dead]}"
                                       + "".join(f"\n{e}" for e in errors))
                if time.monotonic() > deadline:
                    raise RuntimeError(f"spawn_ranks: {n_ranks} ranks did not finish in "
                                       f"{timeout:.0f} s; finished: {sorted(out)}")
                continue
            if not ok:
                errors.append(f"rank {rank} raised:\n{value}")
                # the other ranks may wait in a collective for it forever
                break
            out[rank] = value
        if errors:
            raise RuntimeError("\n".join(errors))
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"spawn_ranks: exit codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [out[r] for r in range(n_ranks)]

