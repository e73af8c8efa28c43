"""One chunk of a frame recorded once as a CUDA graph and replayed for every
chunk of every later frame (``Renderer.tick``).

Every chunk of a frame has one shape (``render_chunked`` edge-pads the
last), so one recording of the chunk's body serves the whole frame. The
body is the eager path's own (``renderer._render_spp``): the integrator's
full-width chunk reads nothing on the host (``render/integrator.py``);
what varies from chunk to chunk and frame to frame lives in device tensors
at fixed addresses, which the recording reads:

* the chunk's pixel ids, copied in before each replay, and its colour and
  primary t, copied out after it;
* the frame's stream seeds (``rng.SeedTable``), filled once a frame by one
  copy from host memory;
* copies of the scene's and the camera's tensors. A later scene or camera
  of the same layout (every tensor's shape, strides, dtype and device, and
  every other field, equal) is copied into them, tensor by tensor, where
  its tensor is not the one copied last (the game loop's refreshed scene
  shares its BLAS tables with the last one); nothing of the caller's
  objects is written. The copies are by identity: a tensor written in
  place (the package writes none) is not seen.

``graph_path`` is the rule that decides where a tick takes this path. The
recording is made with the program's spans and counters paused
(``profiling.paused``), after one pass of the body run as it is on a side
stream (the warm-up torch's capture needs, which also names the frame's
random streams). ``LAUNCHES`` of the dense engines count a replay's kernels
as launches, and the recording's own none (``RecordedLaunches``; the train
step's recording, ``diff/inverse.py``, counts so too).
"""

from __future__ import annotations

import dataclasses

import torch

from physically_based_ray_tracer_tpu_torch.config import RenderConfig, RenderMode
from physically_based_ray_tracer_tpu_torch.ops import take_rows, trace, trace_bf16
from physically_based_ray_tracer_tpu_torch.render.integrator import resharded
from physically_based_ray_tracer_tpu_torch.utils import profiling, rng

# the launch counters a recording's kernels bump: the dense engines' per
# mode (trace.py: B1, trace_bf16.py: B2) and the row gather's backward
# (take_rows.py: its launches and the rows they reduced, module globals)
_COUNTERS = ((trace.LAUNCHES, ("closest", "any")), (trace_bf16.LAUNCHES, ("closest", "any")),
             (vars(take_rows), ("LAUNCHES", "ROWS")))


def _read_counters() -> list[int]:
    return [held[k] for held, keys in _COUNTERS for k in keys]


def _write_counters(values: list[int]) -> None:
    it = iter(values)
    for held, keys in _COUNTERS:
        for k in keys:
            held[k] = next(it)


class RecordedLaunches:
    """The launches counted while a recording is made, where none of its
    kernels runs: made before the recording, ``take_back()`` after it
    restores the counters, and ``credit()`` adds the recording's counts
    again at each replay."""

    def __init__(self):
        self.before = _read_counters()
        self.added = [0] * len(self.before)

    def take_back(self) -> None:
        self.added = [n - b for n, b in zip(_read_counters(), self.before)]
        _write_counters(self.before)

    def credit(self) -> None:
        _write_counters([n + a for n, a in zip(_read_counters(), self.added)])


def graph_path(cfg: RenderConfig, device) -> bool:
    """Whether a tick of ``cfg`` on ``device`` replays a recorded chunk: on
    a CUDA device, for the shaded image, on the dense engines B1 and B2
    (``traversal="pallas"``), whose wrappers read nothing on the host, with
    no ring resharding (it reads the ranks' live counts on the host) and no
    shade tiles (each slice keeps its two host gates). The AOV views and the
    other engines have no recording. Every other tick runs the same body
    eagerly; so does the debug tap, which never goes through a tick
    (``render/debugger.py``)."""
    return (torch.device(device).type == "cuda" and cfg.rendering_mode == RenderMode.BRDF
            and cfg.traversal == "pallas" and not resharded(cfg) and cfg.shade_tile == 0)


def _leaves(obj, path=()):
    """(path, value) of every field of a dataclass tree (a scene, a camera)."""
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            yield from _leaves(getattr(obj, f.name), path + (f.name,))
    else:
        yield path, obj


def _layout(obj) -> tuple:
    """What a recording fixes of a scene or camera: each tensor's path,
    shape, strides, dtype and device, every other field's value, but a
    dense table's ``stack_need``, which the launches only hold to the
    kernels' stack (``ChunkGraph.accepts``)."""
    out = []
    for path, x in _leaves(obj):
        if isinstance(x, torch.Tensor):
            out.append((path, tuple(x.shape), x.stride(), x.dtype, x.device))
        elif path[-1] != "stack_need":
            out.append((path, x))
    return tuple(out)


def _mirror(obj):
    """``obj`` with every tensor a new one of the same layout and values."""
    if isinstance(obj, torch.Tensor):
        return torch.empty_like(obj).copy_(obj)
    if dataclasses.is_dataclass(obj):
        return dataclasses.replace(obj, **{f.name: _mirror(getattr(obj, f.name))
                                           for f in dataclasses.fields(obj)})
    return obj


def _tensors(obj) -> list[torch.Tensor]:
    return [x for _, x in _leaves(obj) if isinstance(x, torch.Tensor)]


def _stack_cap() -> int:
    """The traversal stack that kernels B1 and B2 hold."""
    from physically_based_ray_tracer_tpu_torch.ops import _build

    return min(_build.load("traverse_f32").pbrt_trace_stack_cap(),
               _build.load("traverse_bf16").pbrt_trace_bf16_stack_cap())


class ChunkGraph:
    """``body(scene, camera, cfg, seeds, 0, ids)`` (``_render_spp``) over
    one chunk of ``chunk`` pixel ids, recorded by ``capture`` and run by
    ``run`` for each chunk of ``ids`` (the frame's pixel ids, edge-padded
    to ``n_chunks * chunk``; the first ``n_pixels`` are the frame's).
    Without a recording (on the CPU, where there is no CUDA graph), ``run``
    runs the body as it is, chunk by chunk."""

    def __init__(self, body, scene, camera, cfg: RenderConfig, ids: torch.Tensor,
                 n_chunks: int, chunk: int, n_pixels: int, device):
        self.body, self.cfg, self.device = body, cfg, torch.device(device)
        self.n_chunks, self.n_pixels = n_chunks, n_pixels
        self.padded = ids
        self.ids = ids[:chunk].clone()
        self.scene, self.camera = _mirror(scene), _mirror(camera)
        self._inputs = (_tensors(self.scene), _tensors(self.camera))
        self._layouts = (_layout(scene), _layout(camera))
        self._sources = (_tensors(scene), _tensors(camera))
        self._objects = (scene, camera)
        self.spp = max(1, cfg.samples_per_pixel)
        # per in-frame sample and bounce, at most every purpose as itself
        # and as a uniform2 pair
        self.seeds = rng.SeedTable(self.spp * max(1, cfg.bounces) * 3 * len(rng.Purpose),
                                   self.device)
        self.graph = None
        self.out = None
        self.launches = RecordedLaunches()
        self.stack_cap = None

    def _body(self):
        return self.body(self.scene, self.camera, self.cfg, self.seeds, 0, self.ids)

    def capture(self) -> None:
        """One pass of the body as it is (which names the frame's random
        streams), then, on a CUDA device, the recording; the program's spans
        and counters are paused throughout."""
        with profiling.paused(), torch.no_grad():
            if self.device.type != "cuda":
                self._body()
                return
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                self._body()
            main.wait_stream(side)
            self.launches = RecordedLaunches()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                self.out = self._body()
            self.launches.take_back()
            self.graph = graph
            self.stack_cap = _stack_cap()

    def accepts(self, scene, camera, cfg: RenderConfig) -> bool:
        """Whether ``scene`` and ``camera`` can be copied into the
        recording's inputs for ``cfg``: the same configuration and layouts,
        and a dense table whose stack the kernels hold."""
        if cfg != self.cfg:
            return False
        if self._holds(scene, camera):
            return True
        if (_layout(scene), _layout(camera)) != self._layouts:
            return False
        need = getattr(scene.dense, "stack_need", 0)
        return self.stack_cap is None or need <= self.stack_cap

    def _holds(self, scene, camera) -> bool:
        """``scene`` and ``camera`` are the objects copied in last."""
        return scene is self._objects[0] and camera is self._objects[1]

    def refresh(self, scene, camera) -> int:
        """Copy each tensor of ``scene`` and ``camera`` that is not the one
        copied last into the recording's copy (device to device, queued);
        returns how many were copied."""
        if self._holds(scene, camera):
            return 0
        copied = 0
        sources = (_tensors(scene), _tensors(camera))
        for new, old, mine in zip(sources, self._sources, self._inputs):
            for x, was, dst in zip(new, old, mine):
                if x is not was:
                    dst.copy_(x)
                    copied += 1
        # held, so that a tensor compared by identity next time is never a
        # new one at a freed one's address
        self._sources, self._objects = sources, (scene, camera)
        return copied

    def run(self, key: int, sample: int):
        """The frame's (color (B, 3), primary t (B,)) at ``key`` and
        ``sample``: the frame's seeds filled, then per chunk its ids copied
        in, one replay (or one pass of the body), its outputs copied out."""
        self.seeds.fill(key, sample * self.spp)
        n = self.ids.shape[0]
        color = t = None
        for c in range(self.n_chunks):
            self.ids.copy_(self.padded[c * n:(c + 1) * n])
            if self.graph is None:
                out = self._body()
            else:
                self.graph.replay()
                self.launches.credit()
                out = self.out
            if color is None:
                color = out[0].new_empty((self.padded.shape[0],) + out[0].shape[1:])
                t = out[1].new_empty((self.padded.shape[0],))
            color[c * n:(c + 1) * n].copy_(out[0])
            t[c * n:(c + 1) * n].copy_(out[1])
        return color[:self.n_pixels], t[:self.n_pixels]
