"""The row-parallel engine (``traversal="pallas_rows"``): the port's
``ops/trace_rows.py`` (its plain version, as the CPU runs it) vs the JAX
package's ``ops/pallas_rows.py`` in interpret mode, on a one- and a two-level
table; the slice (``render_sample``) vs the JAX package's with the same
config and key; ``Renderer`` with this engine; the wrappers' checks; the
launch arguments kernel B3 gets (through a stand-in for its library, which
no CPU host builds); the order-preserving key of its nearer-child vote.

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


class _StandInLib:
    """Stands in for kernel B3's loaded library: records each entry point's
    arguments and reports success."""

    def __init__(self, stack_cap=trace_rows.STACK_CAP):
        self.cap, self.calls = stack_cap, {}

    def pbrt_trace_rows_stack_cap(self):
        return self.cap

    def __getattr__(self, name):
        if not name.startswith("pbrt_"):
            raise AttributeError(name)

        def entry(*args):
            self.calls[name] = args
            return 0
        return entry


@pytest.fixture
def stand_in(monkeypatch):
    from physically_based_ray_tracer_tpu_torch.ops import _build

    lib = _StandInLib()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": 7})())
    return lib


@pytest.mark.parametrize("level", sorted(TABLES))
def test_launch_args_name_leaf_rec(stand_in, level):
    """Both modes' launches and the counting launch pass B1's leaf records
    (``leaf_rec`` and its records per group), never the ``groups`` rows;
    the counting launch asks for four counters (B1's three and warps
    split)."""
    td = _port(TABLES[level]()[0])
    o, d = (torch.from_numpy(x) for x in _rays(64, seed=15))
    tm = torch.full((64,), 50.0)
    _reset()
    trace_rows._launch(td, o, d, tm, closest=True)
    trace_rows._launch(td, o, d, tm, closest=False)
    work = trace_rows.count_work(td, o, d, tm, closest=True)
    assert trace_rows.LAUNCHES == {"closest": 1, "any": 1}
    assert set(stand_in.calls) == {"pbrt_trace_closest_rows", "pbrt_trace_any_rows",
                                   "pbrt_trace_count_rows"}
    stride = td.leaf_rec.shape[0] // td.n_groups
    for name, args in stand_in.calls.items():
        assert args[:5] == (td.nodes16.data_ptr(), td.leaf_rec.data_ptr(), stride,
                            td.inst16.data_ptr(), int(td.two_level)), name
        assert args[8:10] == (64, trace_rows.max_steps(td)), name
        assert td.groups.data_ptr() not in args, name
        assert args[-1] == 7, name
    assert set(work) == {"node_steps", "tri_tests", "leaf_visits", "split_warps", "ops"}
    counters = stand_in.calls["pbrt_trace_count_rows"][-2]
    assert counters != 0 and trace_rows.WORK_KEYS[-1] == "split_warps"


def test_launch_refuses_tables(stand_in):
    """A launch still refuses a table deeper than the built kernel's stack,
    misaligned leaf records, and (counting) leaf records of another type;
    nothing reaches the library."""
    td = _port(TABLES["two-level"]()[0])
    o, d = (torch.from_numpy(x) for x in _rays(64, seed=16))
    tm = torch.full((64,), 50.0)
    stand_in.cap = td.stack_need - 1
    with pytest.raises(ValueError, match="stack"):
        trace_rows._launch(td, o, d, tm, closest=True)
    stand_in.cap = trace_rows.STACK_CAP
    rec = td.leaf_rec
    shifted = torch.empty(rec.numel() + 1)[1:].view(rec.shape)
    shifted.copy_(rec)
    with pytest.raises(ValueError, match="16-byte"):
        trace_rows._launch(dataclasses.replace(td, leaf_rec=shifted), o, d, tm, closest=False)
    with pytest.raises(ValueError, match="leaf_rec"):
        trace_rows.count_work(dataclasses.replace(td, leaf_rec=rec.double()), o, d, tm, True)
    assert stand_in.calls == {}


@pytest.mark.parametrize("where", ["-inf", "zero", "+inf"])
def test_order_keys_keep_float_order(where):
    """The plain order key over runs of consecutive non-NaN floats (from
    -inf, around -0.0 / +0.0 through the subnormals, up to +inf), checked
    in chunks as chip_smoke.py checks the kernel's over all of them: keys
    compare as the floats do, -0.0 and +0.0 one key."""
    n = 1 << 16
    start = {"-inf": 0, "zero": trace_rows._NEG_FLOATS - n // 2,
             "+inf": trace_rows.ORDERED_FLOATS - n}[where]
    r = trace_rows.order_key_mismatches("cpu", start, n, chunk=5000)
    assert r == dict(pairs=n - 1, order_mismatch=0, plain_mismatch=0)
    x = torch.tensor([-np.inf, -3e38, -1.0, -1e-45, -0.0, 0.0, 1e-45, 1.0, 1e30, np.inf])
    k = trace_rows.plain_order_keys(x)
    assert (k[1:] >= k[:-1]).all() and int((k[1:] == k[:-1]).sum()) == 1
    assert int(k[4]) == int(k[5]) == 0
    assert torch.equal(trace_rows.ordered_floats(trace_rows._NEG_FLOATS - 1, 2, "cpu")
                       .view(torch.int32), torch.tensor([-2**31, 0], dtype=torch.int32))
    with pytest.raises(ValueError):
        trace_rows.order_keys(x.double())


def test_rows_split_sources():
    """``time_kernels.py --rows-split`` builds B3 from copies of its source
    that differ from it only in the split test: the kept source first, the
    kept test at other counts, the count of lanes that hit a child, never."""
    import difflib

    import time_kernels
    from physically_based_ray_tracer_tpu_torch.ops import _build

    src = _build.SOURCES["traverse_rows"].read_text()
    srcs = time_kernels.rows_split_sources(src)
    kept, *others = srcs
    assert srcs[kept] == src and kept.startswith("off-step>=")
    assert set(srcs) == ({f"off-step>={n}" for n in time_kernels.ROWS_OFF_STEP} | {kept}
                         | {f"lanes<{n}" for n in time_kernels.ROWS_LANES} | {"never"})
    for label in others:
        changed = [ln for ln in difflib.unified_diff(src.splitlines(), srcs[label].splitlines(),
                                                     lineterm="", n=0)
                   if ln[:1] in "+-" and ln[:3] not in ("+++", "---")]
        added = [ln for ln in changed if ln.startswith("+")]
        if label.startswith("off-step"):
            assert added == [f"+constexpr int SPLIT_LANES = {label[10:]};"], label
        elif label == "never":
            assert added == ["+      if (false) {"], label
        else:
            assert added == [f"+      if ((take0 | take1) && __popc(take0 | take1) < "
                             f"{label[6:]}) {{"], label
            assert any("__ballot_sync" in ln for ln in changed if ln.startswith("-")), label
    with pytest.raises(SystemExit):
        time_kernels.rows_split_sources(src.replace("SPLIT_LANES) {", "SPLIT_LANES)  {"))


def _gpu_sets(td, n, dev, seed):
    """Three ray sets on ``td``'s scene, as chip_smoke.py's are made:
    camera-like rays from one point, rays between random points of a
    sphere (bounce-like), and shadow rays from those rays' hits towards one
    point with tmax at it, one in five of them 0."""
    gen = np.random.default_rng(seed)
    eye = np.array([0.3, 0.5, 7.0], np.float32)
    d = gen.normal(size=(n, 3)).astype(np.float32) * 0.6 - eye
    primary = (np.broadcast_to(eye, (n, 3)).copy(), d / np.linalg.norm(d, axis=1, keepdims=True))
    bounce = _rays(n, seed)
    sets = {k: tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in v)
            for k, v in (("primary", primary), ("bounce", bounce))}
    for k in sets:
        o, d = sets[k]
        sets[k] = (o, d, torch.full((n,), 1e30, device=dev))
    o, d, tm = sets["bounce"]
    t = trace.sorted_closest_dense(td, o, d, tm).t
    p = o + d * torch.where(t < 1e29, t, torch.full_like(t, 3.0))[:, None]
    lvec = torch.tensor([2.0, 6.0, 1.0], device=dev) - p
    dist = lvec.norm(dim=1)
    ld = lvec / dist[:, None]
    zero = torch.from_numpy(gen.uniform(0, 1, n) < 0.2).to(dev)
    sets["shadow"] = ((p + ld * 1e-4).contiguous(), ld.contiguous(),
                      torch.where(zero, torch.zeros_like(dist), dist - 1e-4))
    return sets


@pytest.mark.cuda
def test_rows_kernel_vs_plain_on_gpu():
    """Kernel B3 vs its plain version and vs B1 on one- and two-level tables
    and three ray sets (runs where a GPU is present): t bit-equal to B1's
    where both hit, prim and instance equal to the plain version's except on
    t-ties, occlusion equal to both, no truncated ray; the order key on the
    card equals the plain one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    from physically_based_ray_tracer_tpu_torch.ops import _build
    assert _build.load("traverse_rows").pbrt_trace_rows_stack_cap() == trace_rows.STACK_CAP
    dev = torch.device("cuda")
    for level in sorted(TABLES):
        jd, _ = TABLES[level]()
        td = _port(jd).to(dev)
        for sname, (o, d, tm) in _gpu_sets(td, 4096, dev, seed=14).items():
            *raw, t2 = trace_rows.plain_traverse_rows(td, o, d, tm, closest=True)
            want = trace.to_hit(td, *raw)
            hit = trace_rows.sorted_rows_closest(td, o, d, tm)
            b1 = trace.sorted_closest_dense(td, o, d, tm)
            found = want.prim >= 0
            assert torch.equal(hit.prim >= 0, found), sname
            assert torch.equal(hit.t, want.t) and torch.equal(hit.t, b1.t), sname
            tie = t2 <= raw[0] * (1 + 1e-6)
            assert bool(((hit.prim == want.prim) & (hit.inst == want.inst) | tie).all()), sname
            for tmax in (tm, torch.where(found, want.t * 0.75, torch.full_like(want.t, 50.0))):
                occ = trace_rows.sorted_rows_any(td, o, d, tmax)
                assert torch.equal(occ, trace_rows.plain_traverse_rows(td, o, d, tmax,
                                                                       closest=False)), sname
                assert torch.equal(occ, trace.sorted_any_dense(td, o, d, tmax)), sname
        assert trace_rows.truncated_rays(dev) == 0
    r = trace_rows.order_key_mismatches(dev, trace_rows._NEG_FLOATS - (1 << 20), 1 << 21)
    assert r["order_mismatch"] == 0 and r["plain_mismatch"] == 0
