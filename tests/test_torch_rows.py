"""The row-parallel engine (``traversal="pallas_rows"``): the port's
``ops/trace_rows.py`` (its plain version, as the CPU runs it) vs the JAX
package's ``ops/pallas_rows.py`` in interpret mode, on a one- and a two-level
table; the slice (``render_sample``) vs the JAX package's with the same
config and key; ``Renderer`` with this engine; the wrappers' checks.

Tolerances are those of tests/test_torch_trace.py: t within rtol=1e-5, prim
and instance equal except where a float64 brute force sees a t-tie,
occlusion exactly equal; images as tests/test_torch_render.py::_agree.
Each JAX function is jitted once per test, so its interpreted kernel is
traced once for the three tmax regimes."""

import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from physically_based_ray_tracer_tpu.ops import pallas_rows as jrows  # noqa: E402
from physically_based_ray_tracer_tpu.render.integrator import render_sample as jrender  # noqa: E402
from physically_based_ray_tracer_tpu_torch.ops import trace, trace_bf16, trace_rows  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render.integrator import render_sample as trender  # noqa: E402
from physically_based_ray_tracer_tpu_torch.render.renderer import Renderer  # noqa: E402
from tests.test_torch_render import _agree  # noqa: E402
from tests.test_torch_trace import TABLES, _check_closest, _port, _rays, _ties  # noqa: E402
from tests.torch_port import (SLICE_CFG, instanced_scene, port_camera,  # noqa: E402
                              port_config, port_scene)

ROWS_CFG = SLICE_CFG.replace(traversal="pallas_rows")
N_RAYS = 700


def _reset():
    for m in (trace, trace_bf16, trace_rows):
        m.reset_counts()


def _jit(fn):
    return jax.jit(functools.partial(fn, interpret=True))


@pytest.mark.parametrize("level", sorted(TABLES))
@pytest.mark.parametrize("sort", [False, True])
def test_rows_closest_vs_pallas_rows(level, sort):
    jd, tri = TABLES[level]()
    o, d = _rays(N_RAYS, seed=11)
    jfn = jrows.sorted_rows_closest if sort else jrows.rows_closest_dense
    tfn = trace_rows.sorted_rows_closest if sort else trace_rows.rows_closest_dense
    want = _jit(jfn)(jd, jnp.asarray(o), jnp.asarray(d))
    _reset()
    got = tfn(_port(jd), torch.from_numpy(o), torch.from_numpy(d))
    assert trace_rows.PLAIN_CALLS["closest"] == 1 and trace.PLAIN_CALLS["closest"] == 0
    assert (got.prim >= 0).float().mean() > 0.3
    _check_closest(got, want, _ties(tri, o, d))


@pytest.mark.parametrize("level", sorted(TABLES))
@pytest.mark.parametrize("sort", [False, True])
def test_rows_any_vs_pallas_rows(level, sort):
    """Three tmax regimes: beyond the hit (x1.5), before it (x0.5), zero."""
    jd, _ = TABLES[level]()
    o, d = _rays(N_RAYS, seed=12)
    td = _port(jd)
    full = trace_rows.rows_closest_dense(td, torch.from_numpy(o), torch.from_numpy(d))
    t = full.t.numpy()
    jfn = _jit(jrows.sorted_rows_any if sort else jrows.rows_any_dense)
    tfn = trace_rows.sorted_rows_any if sort else trace_rows.rows_any_dense
    for scale in (1.5, 0.5, 0.0):
        tmax = np.where(t < 1e29, t * scale, 50.0 * scale).astype(np.float32)
        want = np.asarray(jfn(jd, jnp.asarray(o), jnp.asarray(d), jnp.asarray(tmax)))
        got = tfn(td, torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tmax))
        np.testing.assert_array_equal(got.numpy(), want)
        if scale == 1.5:
            assert got.float().mean() > 0.3
        if scale == 0.0:
            assert not got.any()


def test_slice_matches_jax():
    """render_sample with traversal="pallas_rows" on the two-level scene,
    port (plain version on the CPU) vs the JAX package (its row kernel in
    interpret mode), same key. Only this engine's plain version runs."""
    jscene, jcam = instanced_scene()
    ids = np.arange(ROWS_CFG.n_pixels, dtype=np.int32)
    want_c, want_t = jrender(jscene, jcam, ROWS_CFG, jax.random.key(0), 0,
                             jnp.asarray(ids))
    scene = port_scene(jscene)
    assert scene.dense.two_level
    _reset()
    got_c, got_t = trender(scene, port_camera(jcam), port_config(ROWS_CFG), 0, 0,
                           torch.from_numpy(ids))
    assert trace_rows.PLAIN_CALLS["closest"] > 0 and trace_rows.PLAIN_CALLS["any"] > 0
    assert sum(trace.PLAIN_CALLS.values()) == 0
    assert sum(trace_bf16.PLAIN_CALLS.values()) == 0
    want_c = np.asarray(want_c)
    assert want_c.mean() > 1e-3
    _agree(got_c.numpy(), want_c)
    hit = np.asarray(want_t) < 1e29
    np.testing.assert_array_equal(got_t.numpy() < 1e29, hit)
    np.testing.assert_allclose(got_t.numpy()[hit], np.asarray(want_t)[hit], rtol=1e-5)


@pytest.mark.parametrize("leaf_precision", ["bf16", "f32"])
def test_renderer_rows_engine(leaf_precision):
    """Renderer(device="cpu") with pallas_rows ticks and accumulates; a
    leaf_precision of "bf16" still runs the row engine, as in the JAX
    package, and its image equals the f32 setting's."""
    jscene, jcam = instanced_scene()
    scene, cam = port_scene(jscene), port_camera(jcam)
    cfg = port_config(ROWS_CFG).replace(accumulate=True, leaf_precision=leaf_precision)
    r = Renderer(scene, cam, cfg, device="cpu")
    _reset()
    img0 = r.tick(0)
    img1 = r.tick(0)
    assert img1.shape == (16, 16, 3) and np.isfinite(img1).all()
    assert r.sample == 2 and float(r.film.spp.min()) >= 1.0
    assert not np.array_equal(img0, img1)          # a second sample moved it
    assert trace_rows.PLAIN_CALLS["closest"] > 0 and trace_rows.PLAIN_CALLS["any"] > 0
    assert sum(trace.PLAIN_CALLS.values()) == 0
    assert sum(trace_bf16.PLAIN_CALLS.values()) == 0
    ref = Renderer(scene, cam, cfg.replace(leaf_precision="f32"), device="cpu")
    np.testing.assert_array_equal(ref.tick(0), img0)


def test_wrapper_checks():
    """The wrappers refuse a table deeper than the kernel's stack, rays on
    mismatched devices or of the wrong dtype or shape; the step bound is the
    TPU row kernel's."""
    jd, _ = TABLES["two-level"]()
    td = _port(jd)
    o, d = (torch.from_numpy(x) for x in _rays(64, seed=13))
    tm = torch.ones(64)
    assert trace_rows.max_steps(td) == 16 * td.n_nodes * (td.n_instances + 1) + 256
    one = _port(TABLES["one-level"]()[0])
    assert trace_rows.max_steps(one) == 16 * one.n_nodes + 256
    deep = dataclasses.replace(td, stack_need=trace_rows.STACK_CAP + 1)
    with pytest.raises(ValueError, match="stack"):
        trace_rows.rows_closest_dense(deep, o, d)
    with pytest.raises(ValueError, match="stack"):
        trace_rows.sorted_rows_any(deep, o, d, tm)
    with pytest.raises(TypeError):
        trace_rows.rows_any_dense(td, o.double(), d, tm)
    with pytest.raises(ValueError):
        trace_rows.rows_any_dense(td, o, d, torch.ones(63))
    with pytest.raises(ValueError, match="is on"):
        trace_rows.rows_any_dense(td, o, d.to("meta"), tm)
    _reset()
    trace_rows.rows_any_dense(td, o, d, tm)
    assert trace_rows.PLAIN_CALLS == {"closest": 0, "any": 1}
    assert trace_rows.LAUNCHES == {"closest": 0, "any": 0}


@pytest.mark.cuda
def test_rows_kernel_vs_plain_on_gpu():
    """Kernel B3 vs its plain version and vs B1 on one- and two-level tables
    (runs where a GPU is present)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from physically_based_ray_tracer_tpu_torch.ops import _build
    assert _build.load("traverse_rows").pbrt_trace_rows_stack_cap() == trace_rows.STACK_CAP
    dev = torch.device("cuda")
    for level in sorted(TABLES):
        jd, _ = TABLES[level]()
        td = _port(jd).to(dev)
        o, d = (torch.from_numpy(x).to(dev) for x in _rays(4096, seed=14))
        tm = torch.full((4096,), 1e30, device=dev)
        *raw, t2 = trace_rows.plain_traverse_rows(td, o, d, tm, closest=True)
        want = trace.to_hit(td, *raw)
        hit = trace_rows.sorted_rows_closest(td, o, d, tm)
        b1 = trace.sorted_closest_dense(td, o, d, tm)
        found = want.prim >= 0
        assert torch.equal(hit.prim >= 0, found)
        assert torch.equal(hit.t, want.t) and torch.equal(hit.t, b1.t)
        tie = t2 <= raw[0] * (1 + 1e-6)
        assert bool(((hit.prim == want.prim) & (hit.inst == want.inst) | tie).all())
        tmax = torch.where(found, want.t * 0.75, torch.full_like(want.t, 50.0))
        occ = trace_rows.sorted_rows_any(td, o, d, tmax)
        assert torch.equal(occ, trace_rows.plain_traverse_rows(td, o, d, tmax, closest=False))
        assert torch.equal(occ, trace.sorted_any_dense(td, o, d, tmax))
        assert trace_rows.truncated_rays(dev) == 0
