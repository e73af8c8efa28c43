#!/usr/bin/env python3
"""Times kernels B1, B2 and B3 of two checkouts of the port on one GPU, in
turns; B3's split thresholds; the fused wave level's block shapes; and the
row gather's backward on the inverse step.

    python3 time_kernels.py --compare OTHER_ROOT     # OTHER, this, this, OTHER
    python3 time_kernels.py [--root ROOT] --out FILE.json
    python3 time_kernels.py --rows-split             # kept, others, others reversed, kept
    python3 time_kernels.py --wave-blocks            # 1024, 512, 512, 1024
    python3 time_kernels.py --take-rows [--out FILE.json]

``--compare`` unpacks nothing itself: OTHER_ROOT is another checkout of the
repository (e.g. the parent commit, from ``git archive``). It runs one
process per turn, in the order other, this, this, other, each on the same
card, and prints per kernel, set and mode both checkouts' median times,
bounds (each over the tables its own kernel reads), shares of bound and the
counted work; it fails if the two checkouts count different work for B1 or
B2 on the same rays (node steps, triangle or band tests, leaf visits). B3's
counted work is its schedule's, which a redesign may change: it is printed
for both checkouts, with the warps that split where the checkout counts
them; its bound is B1's work on the same rays, as in ``chip_smoke.py``.
Each turn's JSON goes to ``--out-dir`` (default
``build/time_kernels/``). Frame times in turns: ``profile_torch_frame.py``
run in each checkout.

One turn (``--out``) imports the package from ROOT (default: this
checkout), builds its kernels, and on the bench scene's two-level table
(``build_bench_scene(flatten="auto")``) and ``chip_smoke.py``'s three
131,072-ray sets (primary, bounce, shadow; co-sorted as the main path sorts
them) times each of B1, B2 and B3 in closest and any mode, and B1 as the bf16
engine's retest of the lanes B2 leaves uncertain (also with the L2 flushed
before each run, as the frame finds it): the median of ``--runs``
CUDA-event runs after a warm-up, each behind a ~1 ms device sleep, so that
only device time counts. It counts the work of each launch with the
kernel's counting instantiation and computes the bound as ``chip_smoke.py``
does, with that checkout's ``chip_smoke.py``. Imports nothing of JAX.

``--rows-split`` builds ``csrc/traverse_rows.cu`` once per split test
(``rows_split_sources``: each from a copy of the source with its
``SPLIT_LANES`` constant, or its whole split test, replaced; the checkout
keeps one test and no switch): the kept test, walking lanes off the warp's
step, at the counts of ``ROWS_OFF_STEP``; the count of lanes whose ray hits
a child, split below each of ``ROWS_LANES`` (33: at the first node step any
lane's ray enters); never. It prints
each build's registers, stack frame and spills, and times each on the
three co-sorted 131,072-ray sets in both modes, in turns (the kept build,
the others, the others reversed, the kept build), beside B1 on the same
rays, with each build's counted work and warps split. It fails if any
build's t or occlusion differs from the kept build's.

``--wave-blocks`` builds ``csrc/wave_level.cu`` once per block shape of
``WAVE_BLOCKS`` (its ``THREADS`` constant replaced in a copy of the source;
the checkout keeps one shape and no switch), prints each build's registers
and spills, and times each on the levels of the wave engine's sorted calls
over the first 122,880 rays of ``chip_smoke.py``'s sets (bounce closest,
shadow any: the sets its kernels line reports), in turns: per call the sum
of the medians of ``--runs`` CUDA-event runs of each level, each from a
fresh copy of the level's entry state. It fails if a shape's results
differ from the kept shape's. Then, for the kept shape, each level's device
microseconds a wave beside those of the same level run with
``node_steps=0`` for as many waves (no scan step and no leaf: the fixed cost
of a wave).

``--take-rows`` records each call of the row gather's backward
(``ops/take_rows.py``) in one step of the inverse cell's problem and times
each call's kernel against the plain version and PyTorch's
``index_put_(accumulate=True)``; see ``take_rows_timing``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WAVE_BLOCKS = (1024, 512)    # the kept block shape first
# B3's split tests tried by --rows-split: walking lanes off the warp's step
# (the kept test's counts), lanes whose ray hits a child (split below), never
ROWS_OFF_STEP = (1, 2, 4, 8)
ROWS_LANES = (4, 8, 16, 24, 33)
ROWS_SPLIT_CONST = r"constexpr int SPLIT_LANES = (\d+);"
# the kept split test, from the lanes' own vote to the if that splits
ROWS_SPLIT_TEST = r"const unsigned off_step =[^{]*?SPLIT_LANES\) \{"
WAVE_CALLS = (("bounce", "closest"), ("shadow", "any"))
L2_FLUSH_BYTES = 128 << 20  # written before each cold run: more than the 50 MB L2
# --take-rows: whole steps timed a turn
TAKE_ROWS_STEPS = 5


def _event_ms(fn):
    """Device time of fn's launches: the card first sleeps ~1 ms, so that the
    host queues the events and the launch (the wrapper's checks and
    allocations) before the card reaches them."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(2_000_000)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def _median_ms(*fns, runs, flush=None):
    """Median CUDA-event time of each of ``fns`` over ``runs`` rounds, after
    a warm-up; the functions take turns within each round. ``flush``: a
    tensor written before each run (untimed), so that the run finds the
    tables out of L2, as the frame's retest does."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for _ in range(runs):
        for t, fn in zip(times, fns):
            if flush is not None:
                flush.add_(1)
            t.append(_event_ms(fn))
    return [statistics.median(t) for t in times]


def turn(root, runs, out_path):
    sys.path.insert(0, os.path.abspath(root))
    sys.path.insert(1, HERE)
    import torch
    import chip_smoke
    from physically_based_ray_tracer_tpu_torch import RenderConfig
    from physically_based_ray_tracer_tpu_torch.ops import _build, trace, trace_bf16, trace_rows
    from physically_based_ray_tracer_tpu_torch.scene.presets import build_bench_scene

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device")
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    scene, cam, _ = build_bench_scene(flatten="auto", device=dev)
    cfg = RenderConfig(width=1280, height=720, bounces=4, antialias=True,
                       skybox=False, one_shadow_ray=True, chunk_pixels=65536)
    sets = chip_smoke._ray_sets(scene, cam, cfg, dev)
    dbvh = scene.dense
    flush = torch.zeros((L2_FLUSH_BYTES // 4,), dtype=torch.float32, device=dev)
    res = dict(root=os.path.abspath(root), card=chip_smoke._smi(), build_s=build_s,
               kernels={})
    for sname, (o, d, tm) in sets.items():
        _, o_s, d_s, tm_s = trace._cosort_rays(dbvh, o, d, tm)
        for mode in ("closest", "any"):
            closest = mode == "closest"
            kern = {"f32": (lambda: trace._traverse(dbvh, o_s, d_s, tm_s, closest),
                            trace.count_work),
                    "bf16": (lambda: trace_bf16._call_bf16(dbvh, o_s, d_s, tm_s, closest),
                             trace_bf16.count_work),
                    "rows": (lambda: trace_rows._traverse(dbvh, o_s, d_s, tm_s, closest),
                             trace_rows.count_work)}
            for eng, (fn, count) in kern.items():
                ms, = _median_ms(fn, runs=runs)
                work = count(dbvh, o_s, d_s, tm_s, closest)
                # B3 computes B1's function: its bound is B1's work
                need = res["kernels"][f"f32 {sname} {mode}"]["work"] if eng == "rows" else work
                b_ms, b_by, nbytes = chip_smoke._bound(eng, mode, dbvh, o.shape[0],
                                                       need["ops"])
                res["kernels"][f"{eng} {sname} {mode}"] = dict(
                    ms=ms, bound_ms=b_ms, bound_by=b_by, share=b_ms / ms, work=work)
            if not closest:
                # B1 as the bf16 engine's retest: the lanes B2 leaves
                # uncertain, t_max 0 elsewhere, in sorted order (as
                # trace_bf16._resolve_uncertain launches it)
                cert, unc = trace_bf16._call_bf16(dbvh, o_s, d_s, tm_s, False)
                tm_r = torch.where(unc & ~cert, tm_s, torch.zeros_like(tm_s))
                retest = lambda: trace._traverse(dbvh, o_s, d_s, tm_r, False)
                ms, = _median_ms(retest, runs=runs)
                cold, = _median_ms(retest, runs=runs, flush=flush)
                res["kernels"][f"f32 {sname} retest"] = dict(
                    ms=ms, cold_ms=cold, lanes=int((unc & ~cert).sum()),
                    work=trace.count_work(dbvh, o_s, d_s, tm_r, False))
    res["truncated"] = (trace.truncated_rays(dev) + trace_bf16.truncated_rays(dev)
                        + trace_rows.truncated_rays(dev))
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)


def compare(other, runs, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    order = (("other", other), ("this", HERE), ("this", HERE), ("other", other))
    got = []
    for i, (who, root) in enumerate(order):
        path = os.path.join(out_dir, f"turn{i}_{who}.json")
        cmd = [sys.executable, os.path.abspath(__file__), "--root", root, "--runs",
               str(runs), "--out", path]
        print(f"== turn {i}: {who} ({root})", flush=True)
        subprocess.run(cmd, check=True, stdout=subprocess.DEVNULL)
        with open(path) as f:
            got.append((who, json.load(f)))
    card = got[0][1]["card"]
    print(f"card: {card}")
    bad = []
    for name in got[0][1]["kernels"]:
        row = {who: [r["kernels"][name] for w, r in got if w == who] for who in ("other", "this")}
        o_ms = [k["ms"] for k in row["other"]]
        t_ms = [k["ms"] for k in row["this"]]
        wo, wt = row["other"][0]["work"], row["this"][0]["work"]
        counts = lambda w: {k: v for k, v in w.items() if k != "ops"}
        if not name.startswith("rows") and counts(wo) != counts(wt):
            bad.append(f"{name}: counted work differs: {wo} vs {wt}")
        b = row["this"][0]
        if "bound_ms" not in b:       # the retest: timed, no bound reported
            o_c = [k["cold_ms"] for k in row["other"] if "cold_ms" in k]
            t_c = [k["cold_ms"] for k in row["this"]]
            cold = (f"; L2 flushed first: other {' / '.join(f'{x:.4f}' for x in o_c)} ms, "
                    f"this {' / '.join(f'{x:.4f}' for x in t_c)} ms" if o_c else "")
            print(f"{name:20s} other {o_ms[0]:.4f} / {o_ms[1]:.4f} ms, this {t_ms[0]:.4f} / "
                  f"{t_ms[1]:.4f} ms, this / other "
                  f"{statistics.mean(t_ms) / statistics.mean(o_ms):.3f}{cold}; {b['lanes']} "
                  f"uncertain lanes; work {json.dumps({k: v for k, v in wt.items() if k != 'ops'})}"
                  f" [{card}]")
            continue
        # each checkout's bound counts the tables its own kernel reads
        o_b = row["other"][0]
        print(f"{name:20s} other {o_ms[0]:.4f} / {o_ms[1]:.4f} ms, this {t_ms[0]:.4f} / "
              f"{t_ms[1]:.4f} ms, this / other {statistics.mean(t_ms) / statistics.mean(o_ms):.3f}; "
              f"bound other {o_b['bound_ms']:.5f} ms ({o_b['bound_by']}), this "
              f"{b['bound_ms']:.5f} ms ({b['bound_by']}); share other "
              f"{100 * o_b['bound_ms'] / statistics.mean(o_ms):.2f}% this "
              f"{100 * b['bound_ms'] / statistics.mean(t_ms):.2f}%; work "
              + (f"other {json.dumps(counts(wo))} this " if counts(wo) != counts(wt) else "")
              + f"{json.dumps(counts(wt))} [{card}]")
    if any(r["truncated"] for _, r in got):
        bad.append("truncated rays")
    if bad:
        raise SystemExit("time_kernels: " + "; ".join(bad))
    print(json.dumps({"ok": True, "card": card}))


def rows_split_sources(src: str) -> dict:
    """{label: source} of ``--rows-split``'s builds of ``traverse_rows.cu``
    source ``src``, the kept test first (``src`` itself)."""
    found = re.findall(ROWS_SPLIT_CONST, src)
    if len(found) != 1 or len(re.findall(ROWS_SPLIT_TEST, src)) != 1:
        raise SystemExit("time_kernels: the split test not found once in traverse_rows.cu")
    sources = {f"off-step>={found[0]}": src}
    for n in ROWS_OFF_STEP:
        sources.setdefault(f"off-step>={n}", re.sub(
            ROWS_SPLIT_CONST, f"constexpr int SPLIT_LANES = {n};", src))
    for n in ROWS_LANES:
        test = f"if ((take0 | take1) && __popc(take0 | take1) < {n}) {{"
        sources[f"lanes<{n}"] = re.sub(ROWS_SPLIT_TEST, lambda m, t=test: t, src)
    sources["never"] = re.sub(ROWS_SPLIT_TEST, lambda m: "if (false) {", src)
    return sources


def rows_split(runs):
    import ctypes
    import tempfile
    from pathlib import Path

    import torch
    sys.path.insert(0, HERE)
    import chip_smoke
    from physically_based_ray_tracer_tpu_torch import RenderConfig
    from physically_based_ray_tracer_tpu_torch.ops import _build, trace, trace_rows
    from physically_based_ray_tracer_tpu_torch.scene.presets import build_bench_scene

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device")
    dev = torch.device("cuda", 0)
    card = chip_smoke._smi()
    _build.build_all()
    sources = rows_split_sources(_build.SOURCES["traverse_rows"].read_text())
    variants = tuple(sources)
    kept = variants[0]
    tmp = Path(tempfile.mkdtemp(dir=_build.BUILD_DIR))
    procs = {}
    for i, v in enumerate(variants):
        cu = tmp / f"traverse_rows_{i}.cu"
        cu.write_text(sources[v])
        procs[v] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
             str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for i, (v, proc) in enumerate(procs.items()):
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on the {v} copy of traverse_rows.cu:\n{log}")
        use = [(u["registers"], u["stack_bytes"], u["spill_bytes"])
               for u in chip_smoke._ptxas_usage(log).values()]
        print(f"traverse_rows {v}: registers, stack frame, spill bytes per kernel {use} "
              f"[{card}]", flush=True)
        libs[v] = _build.bind(ctypes.CDLL(str(tmp / f"traverse_rows_{i}.so")),
                              "traverse_rows")

    scene, cam, _ = build_bench_scene(flatten="auto", device=dev)
    cfg = RenderConfig(width=1280, height=720, bounces=4, antialias=True,
                       skybox=False, one_shadow_ray=True, chunk_pixels=65536)
    dbvh = scene.dense
    calls = {}
    for sname, (o, d, tm) in chip_smoke._ray_sets(scene, cam, cfg, dev).items():
        _, o_s, d_s, tm_s = trace._cosort_rays(dbvh, o, d, tm)
        for mode in ("closest", "any"):
            calls[(sname, mode)] = (o_s, d_s, tm_s, mode == "closest")
    names = (*variants, "B1")
    times = {(v, c): [] for v in names for c in calls}
    want, work, bad = {}, {}, []
    for v in (*variants, *reversed(variants)):
        _build._LIBS["traverse_rows"] = libs[v]
        for c, (o_s, d_s, tm_s, closest) in calls.items():
            fn = lambda: trace_rows._traverse(dbvh, o_s, d_s, tm_s, closest)
            b1 = lambda: trace._traverse(dbvh, o_s, d_s, tm_s, closest)
            ms, b1_ms = _median_ms(fn, b1, runs=runs)
            times[(v, c)].append(ms)
            times[("B1", c)].append(b1_ms)
            out = fn()
            got = out[0] if closest else out          # t, or occlusion
            if c not in want:
                want[c] = got
            elif not torch.equal(got, want[c]):
                bad.append(f"{v} {c}: {'t' if closest else 'occlusion'} differs from "
                           f"{kept}'s")
            if (v, c) not in work:
                work[(v, c)] = trace_rows.count_work(dbvh, o_s, d_s, tm_s, closest)
    need = {c: trace.count_work(dbvh, *calls[c]) for c in calls}
    for c in calls:
        b1 = statistics.mean(times[("B1", c)])
        for v in names:
            ms = statistics.mean(times[(v, c)])
            line = (f"rows {c[0]:7s} {c[1]:7s} {v:12s} "
                    f"{' / '.join(f'{x:.4f}' for x in times[(v, c)])} ms, / B1 {ms / b1:.3f}")
            if v != "B1":
                w = work[(v, c)]
                line += (f"; work {w['ops']['f32'] / need[c]['ops']['f32']:.2f}x B1's ops, "
                         f"{w['split_warps']} warps split")
            print(f"{line} [{card}]", flush=True)
    _build._LIBS.pop("traverse_rows")
    if trace_rows.truncated_rays(dev) + trace.truncated_rays(dev):
        bad.append("truncated rays")
    if bad:
        raise SystemExit("time_kernels: " + "; ".join(bad))
    print(json.dumps({"ok": True, "card": card, "kept": kept}))


def wave_blocks(runs):
    import ctypes
    import tempfile
    from pathlib import Path

    import torch
    sys.path.insert(0, HERE)
    import chip_smoke
    from physically_based_ray_tracer_tpu_torch import RenderConfig
    from physically_based_ray_tracer_tpu_torch.ops import _build, wave_level
    from physically_based_ray_tracer_tpu_torch.scene.presets import build_bench_scene

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device")
    dev = torch.device("cuda", 0)
    card = chip_smoke._smi()
    _build.build_all()
    src = _build.SOURCES["wave_level"].read_text()
    kept = f"constexpr int THREADS = {WAVE_BLOCKS[0]};"
    if src.count(kept) != 1:
        raise SystemExit(f"time_kernels: {kept!r} not found once in wave_level.cu")
    libs = {}
    tmp = tempfile.mkdtemp(dir=_build.BUILD_DIR)
    for threads in WAVE_BLOCKS:
        cu = Path(tmp) / f"wave_level_{threads}.cu"
        cu.write_text(src.replace(kept, f"constexpr int THREADS = {threads};"))
        so = Path(tmp) / f"wave_level_{threads}.so"
        p = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
                            "-o", str(so), str(cu)], capture_output=True, text=True)
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed on {cu.name}:\n{p.stdout}{p.stderr}")
        use = chip_smoke._ptxas_usage(p.stdout + p.stderr)
        print(f"wave_level THREADS={threads}: {json.dumps(use)} [{card}]", flush=True)
        libs[threads] = _build.bind(ctypes.CDLL(str(so)), "wave_level")
        if libs[threads].pbrt_wave_level_threads() != threads:
            raise SystemExit(f"the {threads}-thread build reports another shape")

    scene2, cam, _ = build_bench_scene(flatten="auto", device=dev)
    bvh = build_bench_scene(legacy_bvh=True, device=dev)[0].bvh
    cfg = RenderConfig(width=1280, height=720, bounces=4, antialias=True,
                       skybox=False, one_shadow_ray=True, chunk_pixels=65536)
    sets = chip_smoke._ray_sets(scene2, cam, cfg, dev)
    levels = {}
    real = wave_level.run_level

    def record(bvh_, st, **kw):
        levels[call].append(({k: v.clone() for k, v in st.items()}, kw))
        return real(bvh_, st, **kw)

    results = {}
    wave_level.run_level = record
    try:
        for call in WAVE_CALLS:
            sname, mode = call
            levels[call] = []
            o, d, tm = (x[:chip_smoke.WAVE_RAYS] for x in sets[sname])
            results[call] = chip_smoke._wave_calls(bvh, o, d, tm, mode)
    finally:
        wave_level.run_level = real
    times = {(t, c): [] for t in WAVE_BLOCKS for c in WAVE_CALLS}
    bad = []
    for threads in (*WAVE_BLOCKS, *reversed(WAVE_BLOCKS)):
        _build._LIBS["wave_level"] = libs[threads]
        for call in WAVE_CALLS:
            ms = 0.0
            for st0, kw in levels[call]:
                fresh = lambda: [{k: v.clone() for k, v in st0.items()}]
                ms += chip_smoke._time_ms(lambda s: wave_level.run_level(bvh, s, **kw),
                                          runs=runs, setup=fresh, ahead=True)
            times[(threads, call)].append(ms)
            got = chip_smoke._wave_calls(bvh, *(x[:chip_smoke.WAVE_RAYS]
                                                for x in sets[call[0]]), call[1])
            want = results[call]
            same = all(torch.equal(a, b) for a, b in zip(
                got if call[1] == "closest" else [got], want if call[1] == "closest" else [want]))
            if not same:
                bad.append(f"THREADS={threads} {call}: results differ")
    for call in WAVE_CALLS:
        line = ", ".join(f"THREADS={t}: {' / '.join(f'{x:.4f}' for x in times[(t, call)])} ms"
                         for t in WAVE_BLOCKS)
        print(f"wave_level {call[0]} {call[1]}, {len(levels[call])} levels: {line}; "
              f"{WAVE_BLOCKS[1]} / {WAVE_BLOCKS[0]} "
              f"{statistics.mean(times[(WAVE_BLOCKS[1], call)]) / statistics.mean(times[(WAVE_BLOCKS[0], call)]):.3f}"
              f" [{card}]", flush=True)
    # the fixed cost of a wave, kept shape: each level again with
    # node_steps=0 (no scan step and no leaf: the barriers, reductions and
    # the exit test alone) for as many waves as it ran
    _build._LIBS["wave_level"] = libs[WAVE_BLOCKS[0]]
    for call in WAVE_CALLS:
        for st0, kw in levels[call]:
            fresh = lambda: [{k: v.clone() for k, v in st0.items()}]
            wave_level.collect_waves()
            n0 = wave_level.WAVES[call[1]]
            wave_level.run_level(bvh, *fresh(), **kw)
            waves = wave_level.collect_waves()[call[1]] - n0
            full = chip_smoke._time_ms(lambda s: wave_level.run_level(bvh, s, **kw),
                                       runs=runs, setup=fresh, ahead=True)
            bare = chip_smoke._time_ms(lambda s: wave_level.run_level(
                bvh, s, **dict(kw, node_steps=0), max_waves=waves), runs=runs, setup=fresh,
                ahead=True)
            print(f"wave_level {call[0]} {call[1]} level of {st0['cur'].shape[0]} tiles, "
                  f"{waves} waves: {full * 1e3 / waves:.2f} us a wave, with node_steps=0 "
                  f"{bare * 1e3 / waves:.2f} us a wave [{card}]", flush=True)
    _build._LIBS.pop("wave_level")
    if bad:
        raise SystemExit("time_kernels: " + "; ".join(bad))
    print(json.dumps({"ok": True, "card": card}))


def take_rows_timing(runs, out_path):
    """``--take-rows``: the row gather's backward (``ops/take_rows.py``) on
    the inverse cell's step: the bench problem of ``chip_smoke.py``
    (``_bench_grad_problem``, the exact f32 engine) on 65,536 pixels drawn
    as the benchmark draws them. Records every backward call of the step
    (rows, columns, table rows, the longest run of one row and the row it
    falls on, the lanes on row 0 and on the floor's rows), then per call the
    median device time of the kernel's two passes (with the table's
    zeroing), of the whole call (with the sort), of the plain version
    (``index_add_``) and of PyTorch's own call
    (``index_put_(accumulate=True)``), the byte bound and the kernel's
    error against the latter. Checks that two backwards of the step give the
    same bits, that the loss is bit-equal to the one through the indexing
    take_rows replaced, and times whole steps both ways in turns (new, old,
    old, new)."""
    sys.path.insert(0, HERE)
    import torch
    import chip_smoke
    from physically_based_ray_tracer_tpu_torch import RenderConfig
    from physically_based_ray_tracer_tpu_torch.diff import grad as dgrad
    from physically_based_ray_tracer_tpu_torch.diff.inverse import make_train_step
    from physically_based_ray_tracer_tpu_torch.ops import _build
    from physically_based_ray_tracer_tpu_torch.ops import take_rows as tr
    from physically_based_ray_tracer_tpu_torch.render import integrator
    from physically_based_ray_tracer_tpu_torch.scene import material

    if not torch.cuda.is_available():
        raise SystemExit("time_kernels: no CUDA device")
    dev = torch.device("cuda", 0)
    card = chip_smoke._smi()
    # built afresh, so that nvcc's log holds ptxas's lines on the kernels
    _build.library_path("take_rows").unlink(missing_ok=True)
    _build.build_all()
    _build.load("take_rows")
    usage = chip_smoke._ptxas_usage(_build.BUILD_INFO["take_rows"]["log"])
    print(f"take_rows kernels (registers, stack frame, spill bytes): {json.dumps(usage)}",
          flush=True)
    cfg = RenderConfig(width=1280, height=720, bounces=4, antialias=True, skybox=False,
                       one_shadow_ray=True, chunk_pixels=65536, leaf_precision="f32")
    scene, cam, target, start, _ = chip_smoke._bench_grad_problem(dev, cfg)
    seed = chip_smoke.STEP_SEED
    ids, tgt = chip_smoke._step_pixels(cfg, target, seed, chip_smoke.STEP_PIXELS)
    old_take = lambda t, i: t[i.clamp(0, t.shape[0] - 1)]
    mods = (material, dgrad, integrator)
    grads = lambda record=False: chip_smoke._gather_step(scene, cam, cfg, start, ids, tgt,
                                                         seed, record)
    loss1, g1, calls = grads(record=True)
    launches = tr.LAUNCHES
    loss2, g2, _ = grads()
    n_launch = tr.LAUNCHES - launches
    for m in mods:
        m.take_rows = old_take
    try:
        loss0, g0, _ = grads()
    finally:
        for m in mods:
            m.take_rows = tr.take_rows
    same = all(torch.equal(g1[k], g2[k]) for k in g1) and torch.equal(loss1, loss2)
    rel = {k: float((g1[k] - g0[k]).norm() / g0[k].norm()) for k in g0}
    res = dict(card=card, ptxas=usage, seed=seed, batch=chip_smoke.STEP_PIXELS,
               backward_calls=n_launch, bitwise_repeat=same,
               loss=float(loss1), loss_equal_to_indexing=bool(torch.equal(loss1, loss0)),
               grad_rel_to_indexing=rel, calls=[])
    print(f"step's backward: {n_launch} take_rows launches; two backwards bit-equal: {same}; "
          f"loss {float(loss1)!r} bit-equal to the indexing's {float(loss0)!r}: "
          f"{res['loss_equal_to_indexing']}; ||g - g_indexing|| / ||g_indexing|| per leaf "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in rel.items()})} [{card}]", flush=True)
    floor = (scene.prim_inst == scene.prim_inst.max()).nonzero()[:, 0]
    for grad, idx, n_rows in calls:
        n, c = grad.shape
        keys, perm = torch.sort(idx.to(torch.int32), stable=True)
        rows, counts = torch.unique_consecutive(keys, return_counts=True)
        at = int(counts.argmax())
        call = dict(n=n, c=c, rows=n_rows, distinct=int(rows.numel()),
                    longest_run=int(counts[at]), longest_row=int(rows[at]),
                    on_row0=int((idx == 0).sum()))
        if n_rows == scene.prim_inst.shape[0]:
            call["on_floor"] = int(torch.isin(idx, floor).sum())
            call["floor_rows"] = floor.tolist()
        lib_call = lambda: torch.zeros((n_rows, c), device=dev).index_put_(
            (idx.long(),), grad, accumulate=True)
        ms = _median_ms(lambda: tr.reduce_sorted(grad, keys, perm, n_rows),
                        lambda: tr.segment_sum(grad, idx, n_rows),
                        lambda: tr.plain_segment_sum(grad, idx, n_rows), lib_call, runs=runs)
        nbytes = n * c * 4 + n * (4 + 8) + n_rows * c * 4
        want = lib_call().double()
        got = tr.segment_sum(grad, idx, n_rows).double()
        call.update(kernel_ms=ms[0], call_ms=ms[1], plain_ms=ms[2], library_ms=ms[3],
                    bytes=nbytes, bound_ms=nbytes / chip_smoke.PEAK_BYTES * 1e3,
                    share=nbytes / chip_smoke.PEAK_BYTES * 1e3 / ms[0],
                    rel_err_vs_library=float((got - want).norm()
                                             / want.norm().clamp_min(1e-30)))
        res["calls"].append(call)
        print(f"take_rows {n} x {c} from {n_rows}: longest run {call['longest_run']} on row "
              f"{call['longest_row']} ({call['distinct']} rows; {call['on_row0']} on row 0"
              + (f", {call['on_floor']} on the floor {call['floor_rows']}"
                 if "on_floor" in call else "")
              + f"); kernel {ms[0]:.4f} ms, with the sort {ms[1]:.4f}, plain {ms[2]:.4f}, "
              f"index_put_ {ms[3]:.4f}; bound {call['bound_ms']:.5f} ms "
              f"({call['share'] * 100:.2f}%) [{card}]", flush=True)

    def step_ms(old):
        if old:
            for m in mods:
                m.take_rows = old_take
        try:
            params = dgrad.clone_params(start)
            step = make_train_step(scene, cam, cfg, dgrad.adam(params, 0.02))
            times = []
            for k in range(2 + TAKE_ROWS_STEPS):
                t0 = time.perf_counter()
                float(step(params, seed, k, ids, tgt))
                times.append((time.perf_counter() - t0) * 1e3)
            return statistics.median(times[2:])
        finally:
            for m in mods:
                m.take_rows = tr.take_rows

    turns = [("take_rows", step_ms(False)), ("indexing", step_ms(True)),
             ("indexing", step_ms(True)), ("take_rows", step_ms(False))]
    res["step_ms_turns"] = turns
    print(f"step ms (median of {TAKE_ROWS_STEPS} after 2, new / old / old / new): "
          f"{json.dumps(turns)} [{card}]", flush=True)
    if out_path:
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(res, f, indent=1)
    ok = same and res["loss_equal_to_indexing"] and all(
        c["rel_err_vs_library"] < 1e-5 for c in res["calls"])
    print(json.dumps({"ok": ok, "card": card}))
    if not ok:
        raise SystemExit("time_kernels: take_rows is not bit-stable or differs from index_put_")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--compare", metavar="OTHER_ROOT")
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--runs", type=int, default=20)
    ap.add_argument("--out")
    ap.add_argument("--out-dir", default=os.path.join(HERE, "build", "time_kernels"))
    ap.add_argument("--wave-blocks", action="store_true")
    ap.add_argument("--rows-split", action="store_true")
    ap.add_argument("--take-rows", action="store_true")
    a = ap.parse_args()
    if a.take_rows:
        take_rows_timing(a.runs, a.out)
    elif a.rows_split:
        rows_split(a.runs)
    elif a.wave_blocks:
        wave_blocks(a.runs)
    elif a.compare:
        compare(a.compare, a.runs, a.out_dir)
    elif a.out:
        turn(a.root, a.runs, a.out)
    else:
        ap.error("give --compare OTHER_ROOT, --out FILE, --rows-split, --wave-blocks or "
                 "--take-rows")


if __name__ == "__main__":
    main()
