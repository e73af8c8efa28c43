"""The row gather ``ops/take_rows.py::take_rows`` and its backward.

On the CPU: the forward is bit-equal to ``arr[idx.clamp(0, P - 1)]`` for
any index (negative and past the end included), with or without a node;
no node is made where no gradient can flow; the backward (the plain
version, ``index_add_``) passes ``gradcheck`` in float64 and puts zeros on
rows never gathered, also when every lane falls on row 0; the bench
scene's inverse problem (the benchmark's start, a 256-pixel batch of the
1280x720 frame, the exact f32 engine) gets the gradient of the indexing it
replaces, element by element within rtol 1e-6 (in one thread, where the
indexing's CPU backward adds each row's terms in the order index_add_
does); a second derivative through the backward raises; a train step's
``pbrt.backward`` span counts the backward calls and their rows.

Where a GPU is present (``cuda``-marked), the kernel ``csrc/take_rows.cu``
at the main path's shapes: within float32's reordering bound of a float64
``index_add_``, bitwise equal from call to call, one launch per backward
call. The bound: the kernel adds a run in chunks of TILE rows and then the
chunks' partials, so an element's sum is a tree of additions at most
TILE + tiles + 1 deep and its error at most that times 2**-24 times the sum
of its terms' magnitudes. Inputs are
made with numpy from a seed. No JAX here."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from physically_based_ray_tracer_tpu_torch.config import RenderConfig
from physically_based_ray_tracer_tpu_torch.diff import grad as dgrad
from physically_based_ray_tracer_tpu_torch.diff.inverse import make_train_step
from physically_based_ray_tracer_tpu_torch.ops import take_rows as tr
from physically_based_ray_tracer_tpu_torch.render import integrator
from physically_based_ray_tracer_tpu_torch.scene import material
from physically_based_ray_tracer_tpu_torch.scene.presets import build_bench_scene, sphere_demo
from physically_based_ray_tracer_tpu_torch.utils import profiling

TILE = 128          # csrc/take_rows.cu's TILE (pbrt_take_rows_tile on the card)
# (rows gathered, columns, table rows, share of the indices on row 0): the
# inverse step's hit gather (4 a step), its per-prim material gather
# (packed_tables) and the re-bake's corner-normal gather
MAIN_SHAPES = [(131072, 51, 36866, 0.98), (36866, 23, 10, 0.0), (110598, 9, 10, 0.0)]
BENCH_CFG = RenderConfig(width=1280, height=720, bounces=4, antialias=True, skybox=False,
                         one_shadow_ray=True, chunk_pixels=65536, leaf_precision="f32")
BENCH_PIXELS = 256


def _old_take(arr, idx):
    """The indexing take_rows replaces."""
    return arr[idx.clamp(0, arr.shape[0] - 1)]


def _indices(n, rows, row0, seed):
    gen = np.random.default_rng(seed)
    idx = gen.integers(0, rows, size=n)
    idx[gen.uniform(size=n) < row0] = 0
    return torch.from_numpy(idx)


def _reorder_bound(g64_abs_sum, n):
    return (TILE + -(-n // TILE) + 1) * 2.0 ** -24 * g64_abs_sum


@pytest.mark.parametrize("table_shape, idx", [
    ((7, 3), [0, -3, 9, 2, 2, 6, 0, 7, -1]),
    ((5,), [4, 5, -2, 0, 0, 3]),
    ((4, 3, 3), [[0, 1], [9, -9], [3, 3]]),
    ((6, 2), [[-1, 2, 8], [5, 5, 0]]),
])
@pytest.mark.parametrize("needs_grad", [False, True])
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
def test_forward_is_the_clamped_indexing(table_shape, idx, needs_grad, dtype):
    table = torch.randn(table_shape, generator=torch.Generator().manual_seed(1))
    table.requires_grad_(needs_grad)
    i = torch.tensor(idx, dtype=dtype)
    got = tr.take_rows(table, i)
    want = _old_take(table.detach(), i)
    assert got.shape == want.shape and torch.equal(got.detach(), want)
    assert (got.grad_fn is not None) == needs_grad


@pytest.mark.parametrize("table_shape, n, seed", [((7, 3), 20, 0), ((5,), 9, 1),
                                                   ((4, 3, 3), 12, 2), ((1, 4), 6, 3)])
def test_gradcheck_float64(table_shape, n, seed):
    gen = np.random.default_rng(seed)
    table = torch.from_numpy(gen.normal(size=table_shape)).requires_grad_(True)
    idx = torch.from_numpy(gen.integers(-3, table_shape[0] + 3, size=n))
    calls = tr.PLAIN_CALLS
    assert torch.autograd.gradcheck(lambda t: tr.take_rows(t, idx), (table,))
    assert tr.PLAIN_CALLS > calls


@pytest.mark.parametrize("row0", [1.0, 0.98])
def test_skewed_indices_and_rows_never_gathered(row0):
    P, C, N = 40, 5, 3000
    idx = _indices(N, 20, row0, seed=7)      # rows 20..39 never gathered
    g = torch.from_numpy(np.random.default_rng(8).normal(size=(N, C)).astype(np.float32))
    table = torch.zeros(P, C, requires_grad=True)
    rows0 = tr.ROWS
    tr.take_rows(table, idx).backward(g)
    want = torch.zeros(P, C, dtype=torch.float64).index_add_(0, idx, g.double())
    assert tr.ROWS - rows0 == N
    assert torch.all(table.grad[20:] == 0)
    if row0 == 1.0:
        assert torch.all(table.grad[1:] == 0)
    assert torch.all((table.grad.double() - want).abs()
                     <= _reorder_bound(torch.zeros(P, C, dtype=torch.float64)
                                       .index_add_(0, idx, g.double().abs()), N))


def test_no_node_without_a_gradient():
    table = torch.randn(6, 4)
    idx = torch.tensor([0, 7, -1, 3])
    calls = tr.backward_calls()
    plain = tr.take_rows(table, idx)
    assert plain.grad_fn is None and torch.equal(plain, _old_take(table, idx))
    table.requires_grad_(True)
    with torch.no_grad():
        off = tr.take_rows(table, idx)
    assert off.grad_fn is None and torch.equal(off, _old_take(table.detach(), idx))
    assert tr.backward_calls() == calls


@pytest.mark.parametrize("idx", [[1, 0, 1, 5], [0, 0, -2]])
def test_second_derivative_raises(idx):
    """The backward is differentiable once: a second derivative through it
    raises where a silent zero would be wrong (x -> sum((x[idx] * x[idx])**2)
    has a nonzero Hessian through the gather's backward)."""
    table = torch.tensor([[1.0, 2.0], [3.0, -1.0]], requires_grad=True)
    rows = tr.take_rows(table, torch.tensor(idx))
    (g,) = torch.autograd.grad(((rows * rows) ** 2).sum(), table, create_graph=True)
    assert g.requires_grad
    with pytest.raises(RuntimeError, match="differentiate twice"):
        g.sum().backward()


def test_segment_sum_refuses_bad_shapes():
    g = torch.ones(4, 2)
    with pytest.raises(ValueError, match="want"):
        tr.segment_sum(g, torch.zeros(3, dtype=torch.int64), 5)
    with pytest.raises(ValueError, match="want"):
        tr.segment_sum(g[:, 0], torch.zeros(4, dtype=torch.int64), 5)


@pytest.fixture(scope="module")
def bench_problem():
    """The benchmark's inverse problem on the CPU: the bench scene, its
    start (chip_smoke.py::_bench_grad_problem's perturbation), 256 pixels."""
    scene, cam, _, handle = build_bench_scene(flatten="auto", return_handle=True,
                                              device="cpu")
    trs = dgrad.trs_params_from_instances(handle.instances, device="cpu")
    shift = lambda v, dx: v + torch.tensor(dx, dtype=torch.float32)
    start = {"base_color": torch.clamp(scene.mat_base * 0.8 + 0.1, 0.0, 1.0),
             "roughness": torch.clamp(scene.mat_rough + 0.1, 0.05, 1.0),
             "metalness": torch.clamp(scene.mat_metal + 0.05, 0.0, 1.0),
             "emissive": scene.mat_emissive + 0.02,
             "point_color": scene.lights.point_color * 0.8,
             "dir_color": scene.lights.dir_color * 1.2,
             "instance_trs": {"position": trs["position"] + 0.01,
                              "rotation": trs["rotation"] + 0.01,
                              "scale": trs["scale"] * 1.005, "base_inv": trs["base_inv"]},
             "camera_pos": shift(cam.pos, [0.02, 0.01, 0.0]),
             "camera_target": shift(cam.target, [0.01, 0.0, 0.0])}
    ids = np.random.default_rng(3).choice(BENCH_CFG.n_pixels, BENCH_PIXELS, replace=False)
    return scene, cam, start, torch.from_numpy(ids.astype(np.int32))


def _bench_grads(problem):
    scene, cam, start, ids = problem
    params = dgrad.clone_params(start)
    s, c = dgrad.apply_params(scene, cam, params)
    torch.mean(dgrad.render_color(s, c, BENCH_CFG, 5, 0, ids) ** 2).backward()
    return {".".join(p): v.grad for p, v in dgrad.param_items(params) if v.grad is not None}


def test_bench_gradient_matches_the_indexing_backward(bench_problem, monkeypatch):
    # one thread: the indexing's CPU backward then adds each row's terms in
    # ascending order, as index_add_ does (with more threads it splits them)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        calls, rows = tr.backward_calls()
        new = _bench_grads(bench_problem)
        calls2, rows2 = tr.backward_calls()
        for mod in (material, dgrad, integrator):
            monkeypatch.setattr(mod, "take_rows", _old_take)
        old = _bench_grads(bench_problem)
    finally:
        torch.set_num_threads(threads)
    # the re-bake's 4 gathers, packed_tables' material gather, and the hit
    # gather of each of the 4 bounces
    assert calls2 - calls == 9 and rows2 - rows > 4 * 2 * BENCH_PIXELS
    assert tr.backward_calls() == (calls2, rows2)
    assert set(new) == set(old) and len(new) == 11
    for k, g in old.items():
        assert float(g.norm()) > 0, k
        torch.testing.assert_close(new[k], g, rtol=1e-6, atol=0.0, msg=k)


def test_backward_span_counts_the_gathers():
    scene, cam = sphere_demo(device="cpu")
    cfg = RenderConfig(width=8, height=6, bounces=2, antialias=True, skybox=False,
                       one_shadow_ray=True, max_stack_depth=24, leaf_precision="f32")
    params = dgrad.clone_params({"base_color": scene.mat_base,
                                 "point_color": scene.lights.point_color})
    step = make_train_step(scene, cam, cfg, dgrad.adam(params, 0.01))
    ids = torch.arange(cfg.n_pixels, dtype=torch.int32)
    target = torch.full((cfg.n_pixels, 3), 0.5)
    profiling.reset()
    step(params, 0, 0, ids, target)                  # off: nothing recorded
    assert profiling.spans() == []
    calls, rows = tr.backward_calls()
    with profile(activities=[ProfilerActivity.CPU]):
        step(params, 0, 1, ids, target)
    calls2, rows2 = tr.backward_calls()
    bwd = [r for r in profiling.spans() if r["name"] == "pbrt.backward"]
    profiling.reset()
    assert len(bwd) == 1 and calls2 > calls
    assert bwd[0]["attrs"] == {"take_rows": calls2 - calls, "take_rows_rows": rows2 - rows}


def test_take_rows_routes_the_differentiable_gathers():
    """apply_params' translation gather goes through take_rows (the
    re-bake's four gathers: the bench test above counts them)."""
    scene, cam = sphere_demo(device="cpu")
    n_inst = int(scene.prim_inst.max()) + 1
    params = dgrad.clone_params({"translation": torch.zeros(n_inst, 3)})
    calls = tr.backward_calls()[0]
    s, _ = dgrad.apply_params(scene, cam, params)
    s.tri_v0.sum().backward()
    assert tr.backward_calls()[0] == calls + 1
    counts = torch.bincount(scene.prim_inst.long(), minlength=n_inst).float()
    assert torch.equal(params["translation"].grad, counts[:, None].expand(n_inst, 3))


# --- on the card --------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n, c, rows, row0", MAIN_SHAPES)
def test_kernel_at_the_main_path_shapes(n, c, rows, row0):
    dev = _card()
    idx = _indices(n, rows, row0, seed=n + c)
    g = torch.from_numpy(np.random.default_rng(c).normal(size=(n, c)).astype(np.float32))
    want = torch.zeros(rows, c, dtype=torch.float64).index_add_(0, idx, g.double())
    bound = _reorder_bound(torch.zeros(rows, c, dtype=torch.float64)
                           .index_add_(0, idx, g.double().abs()), n)
    gd, idd = g.to(dev), idx.to(dev)
    a = tr.segment_sum(gd, idd, rows)
    b = tr.segment_sum(gd, idd, rows)
    torch.cuda.synchronize()
    assert torch.equal(a, b)
    err = (a.cpu().double() - want).abs()
    assert torch.all(err <= bound), float((err - bound).max())
    assert torch.all(a.cpu()[want == 0] == 0)
    # through autograd: one launch per backward call
    table = torch.zeros(rows, c, device=dev, requires_grad=True)
    launches = tr.LAUNCHES
    tr.take_rows(table, idd).backward(gd)
    torch.cuda.synchronize()
    assert tr.LAUNCHES == launches + 1
    assert torch.equal(table.grad, a)


@pytest.mark.cuda
def test_kernel_forward_and_plain_agree_on_the_card():
    dev = _card()
    idx = _indices(5000, 300, 0.5, seed=11) - 7          # negatives too
    table = torch.randn(300, 6, generator=torch.Generator().manual_seed(2))
    g = torch.randn(5000, 6, generator=torch.Generator().manual_seed(3))
    td = table.to(dev).requires_grad_(True)
    out = tr.take_rows(td, idx.to(dev))
    assert torch.equal(out.detach().cpu(), _old_take(table, idx))
    out.backward(g.to(dev))
    tc = table.clone().requires_grad_(True)
    tr.take_rows(tc, idx).backward(g)
    n = idx.shape[0]
    bound = _reorder_bound(torch.zeros(300, 6, dtype=torch.float64).index_add_(
        0, idx.clamp(0, 299), g.double().abs()), n)
    assert torch.all((td.grad.cpu().double() - tc.grad.double()).abs() <= 2 * bound)
