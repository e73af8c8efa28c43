"""The port's ring resharding (``parallel/resharding.py``) on 8 gloo ranks on
the CPU, held to the JAX package's on its 8 virtual devices.

tests/test_resharding.py's states (``_mk_state``: 64 rays a rank, rank c
live on a share 1 - c/8 of its lanes, block 16): each rank's ``rays2``,
``live2`` and ``DonationMeta`` equal the JAX device's of the same index bit
for bit; the round trip through a per-lane stub is the identity, also over
two composed rounds; donation conserves the live count, reduces the
imbalance and moves at most a block. The frame with ring donation inside
the bounce loop (``TINY``, the skewed camera whose top 30 rows see only
sky) equals the unresharded frame (tests/test_resharding.py's atol 2e-6,
rtol 1e-5) and the JAX package's resharded frame (rtol 2e-4, atol 2e-5,
tests/test_torch_render.py's port-vs-JAX tolerance). A rank whose whole
wavefront is dead keeps joining every bounce's collectives: the run would
hang otherwise, and ``spawn_ranks``'s own timeout fails it."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from physically_based_ray_tracer_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from physically_based_ray_tracer_tpu.parallel.resharding import ring_donate as jdonate  # noqa: E402
from physically_based_ray_tracer_tpu.parallel.shard import sharded_frame as jsharded  # noqa: E402
from physically_based_ray_tracer_tpu.render.film import FilmState as JFilmState  # noqa: E402
from physically_based_ray_tracer_tpu.scene.camera import Camera as JCamera  # noqa: E402
from physically_based_ray_tracer_tpu_torch.parallel.mesh import spawn_ranks  # noqa: E402
from tests import torch_ranks  # noqa: E402
from tests.scenes import TINY, sphere_scene  # noqa: E402
from tests.test_resharding import BLOCK, N_LOCAL, NDEV, _mk_state  # noqa: E402
from tests.torch_port import port_camera, port_config, port_scene  # noqa: E402

SEEDS = {"roundtrip": 0, "imbalance": 4, "block_cap": 9, "two_rounds": 2}
META = ("perm", "donated_src", "donated_valid", "recv_valid")


def _jax_donation(payload, live):
    def local(payload, live):
        rays2, live2, meta = jdonate(payload, live, "tiles", NDEV, BLOCK)
        return (rays2, live2) + tuple(getattr(meta, k) for k in META)

    f = jax.jit(shard_map(local, mesh=jmake_mesh(NDEV), in_specs=(P("tiles"), P("tiles")),
                          out_specs=P("tiles"), check_vma=False))
    return [np.split(np.asarray(x), NDEV) for x in f(payload, live)]


@pytest.fixture(scope="module")
def donations():
    states = {k: _mk_state(seed) for k, seed in SEEDS.items()}
    out = spawn_ranks(torch_ranks.donations, NDEV, timeout=300, args=(
        NDEV, [(torch.from_numpy(np.array(p)), torch.from_numpy(np.array(lv)))
               for p, lv in states.values()], BLOCK))
    return {k: ([o[i] for o in out], states[k]) for i, k in enumerate(SEEDS)}


@pytest.mark.parametrize("which", list(SEEDS))
def test_ring_donate_matches_jax_per_rank(donations, which):
    ranks, (payload, live) = donations[which]
    want = _jax_donation(payload, live)
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["rays2"], want[0][r])
        np.testing.assert_array_equal(got["live2"], want[1][r])
        for k, w in zip(META, want[2:]):
            np.testing.assert_array_equal(got[k], w[r], err_msg=f"rank {r} {k}")


def test_donation_roundtrip_identity(donations):
    for which in ("roundtrip", "two_rounds"):
        for got in donations[which][0]:
            np.testing.assert_array_equal(got["roundtrip"], got["want"])
            np.testing.assert_array_equal(got["twice"], got["want"])


def test_donation_reduces_imbalance_and_respects_block_cap(donations):
    ranks, (_, live) = donations["imbalance"]
    before = np.asarray(live).reshape(NDEV, N_LOCAL).sum(axis=1)
    after = np.array([g["live2"].sum() for g in ranks])
    assert after.sum() == before.sum()
    assert after.max() <= before.max()
    assert int(after.std() * 100) < int(before.std() * 100)
    for got in donations["block_cap"][0]:
        assert got["donated_valid"].sum() <= BLOCK
    # the per-bounce record counts each round's donated rays
    for which in SEEDS:
        for got in donations[which][0]:
            assert got["donated"] == {0: int(got["donated_valid"].sum()),
                                      1: got["donated2"]}


@pytest.fixture(scope="module")
def skewed():
    jscene, _ = sphere_scene()
    jcam = JCamera.make(pos=(0, 1, 4), target=(0, 3.5, -2))
    return jscene, jcam, port_scene(jscene), port_camera(jcam)


def test_resharded_frame_matches_unresharded_and_jax(skewed):
    jscene, jcam, scene, cam = skewed
    n = TINY.n_pixels
    _, jax_avg = jsharded(jmake_mesh(NDEV), TINY, reshard_block=64)(
        jscene, jcam, JFilmState.zeros(n), jax.random.key(0), 0,
        jnp.arange(n, dtype=jnp.int32))
    out = spawn_ranks(torch_ranks.frames, NDEV, timeout=300,
                      args=(NDEV, scene, cam, port_config(TINY), 0, [0, 64]))
    base = np.concatenate([o[0]["avg"] for o in out])
    resh = np.concatenate([o[64]["avg"] for o in out])
    assert base.mean() > 1e-4
    np.testing.assert_allclose(resh, base, atol=2e-6, rtol=1e-5)
    np.testing.assert_allclose(resh, np.asarray(jax_avg), rtol=2e-4, atol=2e-5)


def test_dead_rank_joins_every_bounce(skewed):
    """Two ranks, 3 bounces: rank 0's pixels (rows 0-15) all see sky, so its
    wavefront is dead from bounce 1 on while rank 1's is not."""
    *_, scene, cam = skewed
    cfg = port_config(TINY).replace(bounces=3)
    out = spawn_ranks(torch_ranks.frames, 2, timeout=120,
                      args=(2, scene, cam, cfg, 0, [0, 64]))
    assert (out[0][0]["accum"] == out[0][0]["accum"][:1]).all()   # sky only
    for o in out:
        np.testing.assert_allclose(o[64]["avg"], o[0]["avg"], atol=2e-6, rtol=1e-5)
