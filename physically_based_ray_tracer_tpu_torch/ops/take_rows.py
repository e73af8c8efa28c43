"""The row gather with clamped indices (``jnp.take(table, idx, axis=0,
mode="clip")``) and its deterministic backward.

``take_rows(table, idx)`` is ``table[idx.clamp(0, P - 1)]``. Where a
gradient can flow (``torch.is_grad_enabled()`` and ``table.requires_grad``)
it records an autograd node of its own: the forward is the same gather
(``index_select`` on the clamped indices, so the values are the same bits)
and the backward is ``segment_sum``, the sum of the cotangent's rows per
table row. The backward is differentiable once: a second derivative
through it raises. Otherwise it is the plain indexing, with no node, so
the frames (whose tables need no gradient) run the same operations as
before.

``segment_sum`` sorts the indices stably and dispatches on the tensors'
device: CUDA tensors launch the hand-written kernel ``csrc/take_rows.cu``
(a segmented sum over fixed tiles of the sorted positions, two passes, no
atomics, so two calls give the same bits; built at first use by
``ops/_build.py``; counted in ``LAUNCHES``) or raise; CPU tensors run the
plain version, ``zeros(P, C).index_add_(0, idx, grad)`` (counted in
``PLAIN_CALLS``). There is no fallback between the two. ``ROWS`` counts the
gathered rows both versions reduced.

PyTorch's own backward of the indexing (``index_put_`` with accumulate)
walks all duplicates of one row in one warp; the main path's gathers clamp
every missed and dead lane to row 0, so that walk, not the bytes, was the
inverse step's time.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

LAUNCHES = 0       # kernel launches (backward calls on CUDA tensors)
PLAIN_CALLS = 0    # backward calls on CPU tensors
ROWS = 0           # gathered rows reduced by the backward, both versions


def backward_calls() -> tuple[int, int]:
    """(backward calls, rows reduced) so far, kernel and plain version."""
    return LAUNCHES + PLAIN_CALLS, ROWS


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx.clamp(0, P - 1)]``, (*idx.shape, *table.shape[1:]); its
    backward is ``segment_sum`` where a gradient can flow to ``table``."""
    P = table.shape[0]
    if not (torch.is_grad_enabled() and table.requires_grad):
        return table[idx.clamp(0, P - 1)]
    flat = idx.reshape(-1).clamp(0, P - 1)
    return _TakeRows.apply(table, flat).reshape(*idx.shape, *table.shape[1:])


class _TakeRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, flat):
        ctx.save_for_backward(flat)
        ctx.table_shape = table.shape
        return table.index_select(0, flat)

    @staticmethod
    @once_differentiable                # the kernel's output carries no graph
    def backward(ctx, grad):
        (flat,) = ctx.saved_tensors
        shape = ctx.table_shape
        g = segment_sum(grad.reshape(flat.shape[0], -1), flat, shape[0])
        return g.reshape(shape), None


def plain_segment_sum(grad: torch.Tensor, idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The plain version: (n_rows, C), row p the sum of ``grad``'s rows b
    with idx[b] == p, in ascending b."""
    return torch.zeros((n_rows, grad.shape[1]), dtype=grad.dtype,
                       device=grad.device).index_add_(0, idx, grad)


def segment_sum(grad: torch.Tensor, idx: torch.Tensor, n_rows: int) -> torch.Tensor:
    """(n_rows, C): row p the sum of ``grad``'s (N, C) rows b with idx[b] ==
    p; ``idx`` (N,) integer in [0, n_rows). Rows never gathered are zero."""
    global LAUNCHES, PLAIN_CALLS, ROWS
    if grad.dim() != 2 or idx.shape != (grad.shape[0],):
        raise ValueError(f"grad {tuple(grad.shape)} and idx {tuple(idx.shape)}: want (N, C) "
                         "and (N,)")
    if idx.device != grad.device:
        raise ValueError(f"idx is on {idx.device}, grad on {grad.device}")
    if grad.device.type == "cuda":
        out = _launch(grad, idx, n_rows)
        LAUNCHES += 1
    elif grad.device.type == "cpu":
        out = plain_segment_sum(grad, idx, n_rows)
        PLAIN_CALLS += 1
    else:
        raise ValueError(f"no take_rows kernel for device {grad.device}")
    ROWS += grad.shape[0]
    return out


def _launch(grad, idx, n_rows):
    if grad.dtype != torch.float32:
        raise TypeError(f"take_rows kernel: grad must be float32, got {grad.dtype}")
    if not 0 < n_rows < 2 ** 31 or grad.shape[0] >= 2 ** 31:
        raise ValueError(f"take_rows kernel: {grad.shape[0]} rows into {n_rows}: outside "
                         "int32")
    keys, perm = torch.sort(idx.to(torch.int32), stable=True)
    return reduce_sorted(grad.contiguous(), keys, perm, n_rows)


def reduce_sorted(grad, keys, perm, n_rows):
    """The kernel's two passes (and the zeroed table they write into) on
    indices already sorted: ``keys`` (N,) int32 ascending, ``perm`` (N,)
    int64 the stable sort's permutation; grad (N, C) float32 contiguous."""
    from physically_based_ray_tracer_tpu_torch.ops import _build

    N, C = grad.shape
    out = torch.zeros((n_rows, C), dtype=torch.float32, device=grad.device)
    lib = _build.load("take_rows")
    tile = lib.pbrt_take_rows_tile()
    partials = torch.empty((-(-N // tile), 2, C), dtype=torch.float32, device=grad.device)
    stream = torch.cuda.current_stream(grad.device).cuda_stream
    err = lib.pbrt_take_rows_backward(grad.data_ptr(), keys.data_ptr(), perm.data_ptr(),
                                      out.data_ptr(), partials.data_ptr(), N, C, stream)
    if err != 0:
        raise RuntimeError("take_rows launch failed: "
                           + lib.pbrt_take_rows_error_string(err).decode())
    return out
