"""Cross-rank ray resharding: ring donation of surplus live rays;
counterpart of ``physically_based_ray_tracer_tpu/parallel/resharding.py``.

Deep bounces kill rays unevenly across ranks (a rank whose pixels look at
the sky idles while its neighbour still traces), so the live counts
diverge with depth. The exchange is a fixed-capacity donation block, as in
the JAX package:

  1. each rank packs its live rays first (stable argsort of the dead mask);
  2. a rank with more than the mean (rounded up) live count donates up to
     ``block`` surplus rays to its ring neighbour (``Mesh.shift`` by +1),
     dead-marking the donated lanes locally;
  3. every rank traces its local (N) and received (block) lanes in one
     batch;
  4. the donated lanes' results ride the reverse shift (-1) home and are
     written back into their origin lanes.

One round moves work one neighbour along; rounds compose (donate again on
the first round's lanes). The lane counts are host integers (one
all_gather of the counts), so the mean and the neighbour's deficit are
integer-exact. The rays are a dict of (N, ...) tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from physically_based_ray_tracer_tpu_torch.parallel.mesh import Mesh

# the rays this rank moved to the next rank, summed per bounce over the calls
# (trace_paths calls ring_donate once a bounce, chunk after chunk)
DONATED: dict[int, int] = {}


def reset_counts() -> None:
    DONATED.clear()


class DonationMeta(NamedTuple):
    """Bookkeeping to route donated results home."""

    perm: torch.Tensor           # (N,) live-first packing permutation
    donated_src: torch.Tensor    # (B,) original lane of each donated slot
    donated_valid: torch.Tensor  # (B,) bool: the slot carries a ray
    recv_valid: torch.Tensor     # (B,) bool: the received slot carries a ray


def ring_donate(rays: dict, live: torch.Tensor, mesh: Mesh, block: int, *,
                bounce: int = 0) -> tuple[dict, torch.Tensor, DonationMeta]:
    """Donate up to ``block`` surplus live rays to the next rank.

    rays: dict of (N, ...) tensors; live: (N,) bool. Returns (rays2,
    live2, meta), where rays2's tensors are (N + block, ...): the local
    lanes packed live-first (the donated ones dead-marked) and then the
    received block. The donated count is added to ``DONATED[bounce]``."""
    N = live.shape[0]
    assert 0 < block <= N
    dev = live.device
    n = mesh.size

    # live-first packing (stable: keeps the Morton order within each class)
    perm = torch.argsort((~live).to(torch.int8), stable=True)
    packed = {k: x[perm] for k, x in rays.items()}
    count = int(live.sum())

    counts = mesh.all_gather(torch.tensor([count], dtype=torch.int64)).reshape(-1).tolist()
    target = -(-sum(counts) // n)                    # ceil mean
    surplus = max(count - target, 0)
    deficit_next = max(target - counts[(mesh.rank + 1) % n], 0)
    s = min(surplus, deficit_next, block)
    DONATED[bounce] = DONATED.get(bounce, 0) + s

    # donated slots = the LAST s live lanes of the packed order
    slot = torch.arange(block, dtype=torch.int64, device=dev)
    valid = slot < s
    idx = torch.clamp(count - s + slot, 0, N - 1)
    donated = [packed[k][idx] for k in rays]
    donated_src = perm[idx]

    *recv, recv_valid = mesh.shift(donated + [valid], +1)
    recv_rays = dict(zip(rays, recv))

    # dead-mark donated lanes locally so nothing is traced twice
    still_live = torch.arange(N, device=dev) < (count - s)
    live2 = torch.cat([live[perm] & still_live, recv_valid])
    rays2 = {k: torch.cat([packed[k], recv_rays[k]]) for k in rays}
    meta = DonationMeta(perm=perm, donated_src=donated_src, donated_valid=valid,
                        recv_valid=recv_valid)
    return rays2, live2, meta


def ring_restore(results: dict, meta: DonationMeta, mesh: Mesh) -> dict:
    """Merge (N + block, ...) results back to the origin-lane order (N, ...).

    The trailing block rides the reverse shift home and overwrites the
    donated lanes; local lanes are unpacked through ``meta.perm``."""
    b = meta.donated_valid.shape[0]
    back = dict(zip(results, mesh.shift([x[-b:] for x in results.values()], -1)))
    inv = torch.argsort(meta.perm)
    src = meta.donated_src[meta.donated_valid]

    def merge(k):
        out = results[k][:-b][inv]
        # an invalid slot is dropped (JAX's mode="drop")
        out[src] = back[k][meta.donated_valid]
        return out

    return {k: merge(k) for k in results}
