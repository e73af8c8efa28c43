"""The port's sharded frame (``parallel/shard.py``) on gloo ranks on the CPU.

tests/test_parallel.py's two checks, on the port: the frame sharded over
1, 2 and 8 ranks (``TINY``, ``sphere_scene``, key 3) equals the port's
unsharded frame bit for bit (every pixel's RNG streams hang on its global
id, and no ray of this frame meets an exact bf16 tie, where the bf16
engine would follow its batch: ROADMAP §C), and the JAX package's frame sharded over
its 8 virtual devices at rtol 2e-4, atol 2e-5 on every pixel (the two
integrators differ by a few ulps of sqrt / pow / sin / cos, as
tests/test_torch_render.py states; this frame's largest difference is
~1.8e-5). The ranks are spawned processes (``spawn_ranks``, gloo), each with
one PyTorch thread; the workers are in tests/torch_ranks.py."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from physically_based_ray_tracer_tpu.parallel.mesh import make_mesh as jmake_mesh  # noqa: E402
from physically_based_ray_tracer_tpu.parallel.shard import sharded_frame as jsharded  # noqa: E402
from physically_based_ray_tracer_tpu.render.film import FilmState as JFilmState  # noqa: E402
from physically_based_ray_tracer_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from physically_based_ray_tracer_tpu_torch.parallel.shard import (gather_rows,  # noqa: E402
                                                                 pad_to_devices, shard_film,
                                                                 shard_rows)
from physically_based_ray_tracer_tpu_torch.render.film import FilmState  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render.renderer import Renderer, frame_fn  # noqa: E402
from tests import torch_ranks  # noqa: E402
from tests.scenes import TINY, sphere_scene  # noqa: E402
from tests.torch_port import port_camera, port_config, port_scene  # noqa: E402

KEY = 3
RTOL, ATOL = 2e-4, 2e-5


@pytest.fixture(scope="module")
def setup():
    jscene, jcam = sphere_scene()
    n = TINY.n_pixels
    _, jax_avg = jsharded(jmake_mesh(8), TINY)(
        jscene, jcam, JFilmState.zeros(n), jax.random.key(KEY), 0,
        jnp.arange(n, dtype=jnp.int32))
    scene, cam, cfg = port_scene(jscene), port_camera(jcam), port_config(TINY)
    film, avg = frame_fn(scene, cam, FilmState.zeros(n, device="cpu"), KEY, 0,
                         torch.arange(n, dtype=torch.int32), cfg=cfg)
    return scene, cam, cfg, np.asarray(jax_avg), avg.numpy(), film.accum.numpy()


@pytest.mark.parametrize("ranks", [1, 2, 8])
def test_sharded_frame_matches_unsharded_and_jax(setup, ranks):
    scene, cam, cfg, jax_avg, avg, accum = setup
    out = tmesh.spawn_ranks(torch_ranks.frames, ranks,
                            args=(ranks, scene, cam, cfg, KEY, [0]), timeout=300)
    got = np.concatenate([o[0]["avg"] for o in out])
    np.testing.assert_array_equal(got, avg)
    np.testing.assert_array_equal(np.concatenate([o[0]["accum"] for o in out]), accum)
    for o in out:            # gather_rows stitches the same image on every rank
        np.testing.assert_array_equal(o[0]["gathered"], avg)
    assert avg.mean() > 1e-3
    np.testing.assert_allclose(got, jax_avg, rtol=RTOL, atol=ATOL)


def test_replicate_broadcasts_rank0_and_checks_shapes(setup):
    _, cam, *_ = setup
    out = tmesh.spawn_ranks(torch_ranks.replicas, 2, args=(2, cam), timeout=120)
    for o in out:
        np.testing.assert_array_equal(o["x"], np.zeros(3, np.float32))
        np.testing.assert_array_equal(o["pos"], cam.pos.numpy())
        assert o["pair0"].tolist() == [0] and o["pair1"].tolist() == [0.0, 0.0]
        assert o["raised"]


def test_pad_to_devices_and_shard_helpers(setup):
    assert [pad_to_devices(n, 8) for n in (1, 8, 9, 1000)] == [8, 8, 16, 1000]
    assert pad_to_devices(921600, 3) == 921600
    mesh = tmesh.make_mesh(1, device="cpu")
    try:
        x = torch.arange(12.0).reshape(6, 2)
        assert torch.equal(shard_rows(mesh, x), x)
        assert torch.equal(gather_rows(mesh, x), x)
        film = FilmState.zeros(6, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(shard_film(mesh, film), film))
        assert tmesh.lookup("tiles") is mesh
        assert mesh.psum(torch.tensor([2.0])).tolist() == [2.0]
        assert mesh.all_gather(torch.tensor([5])).tolist() == [[5]]
    finally:
        mesh.close()
    with pytest.raises(RuntimeError, match="no live process group"):
        tmesh.lookup("tiles")


def test_reshard_axis_without_a_live_group_raises(setup):
    scene, cam, cfg, *_ = setup
    rcfg = cfg.replace(reshard_axis="nowhere", reshard_ndev=2)
    ids = torch.arange(8, dtype=torch.int32)
    with pytest.raises(RuntimeError, match="'nowhere' names no live process group"):
        frame_fn(scene, cam, FilmState.zeros(8, device="cpu"), 0, 0, ids, cfg=rcfg)
    with pytest.raises(RuntimeError, match="no live process group"):
        Renderer(scene, cam, rcfg, device="cpu")
    with pytest.raises(RuntimeError, match="no process group"):
        tmesh.make_mesh(2, device="cpu")
