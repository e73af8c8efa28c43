#!/usr/bin/env python3
"""GPU smoke run of the PyTorch + CUDA port (``physically_based_ray_tracer_tpu_torch``).

Run from the repository root on a machine with one CUDA GPU:

    python3 chip_smoke.py

It imports nothing of JAX and nothing of the JAX package. It builds the
port's seven kernel sources, ``csrc/traverse_f32.cu`` (B1, the exact f32
engine), ``csrc/traverse_bf16.cu`` (B2, the bf16 engine, the ``RenderConfig``
default), ``csrc/traverse_rows.cu`` (B3, the row-parallel exact engine,
``traversal="pallas_rows"``), ``csrc/leaf_mt.cu`` (B4, the wave engine's
dense leaf phase), ``csrc/wave_scan.cu`` (the wave engine's node scan, a
port-only kernel), ``csrc/wave_level.cu`` (port-only: one launch per
cascade level running the scan, B4's function and the tile update in a
loop on the card; the wave engine's ``dense="mt"`` path) and
``csrc/take_rows.cu`` (port-only: the backward of the row gather of the
differentiable path, ``ops/take_rows.py``), with one ``nvcc`` each,
started together (into ``build/torch_kernels/``), then:

1. probe: prints the toolchain, the card (nvidia-smi name, power limit) and
   the kernel build times and ptxas logs, and again, per kernel function of
   B1, B2, B3, the fused level and take_rows, ptxas's lines on its
   registers, stack frame (local memory) and spill bytes (demangled by
   ``c++filt`` where the host has it); the fused level's four instantiations must use <= 64
   registers and spill nothing, and B3's (four, and its order-key kernel)
   must spill nothing;
1b. the exhaustive check of B2's packed bf16x2 operations
   (``trace_bf16.packed_op_mismatches``): the sweep's mul, add, sub, min, max
   and abs helpers over all 2^32 bf16 operand pairs against f32 arithmetic
   rounded to bf16, gated at 0 mismatches for every operation; and of B3's
   order key (``trace_rows.order_key_mismatches``), the integer image its
   nearer-child vote takes the minimum of: the kernel's keys of every
   float32 that is not a NaN, in chunks, against torch's float comparison
   of each pair of neighbours in float order (-0.0 == +0.0) and against the
   plain key, gated at 0 mismatches;
2. B1 and B3 vs their plain version (one function, computed once per table
   and set): on the benchmark scene (two-level, as flatten="auto" builds it,
   and flattened to one level) and three 131,072-ray sets (primary rays of
   an AA-doubled chunk of pixels drawn over the whole frame, bounce-like
   rays from surface points, shadow rays with finite tmax, ~20% of them 0),
   each kernel through the main path's sorted wrappers: equal found masks,
   t within 1e-6 relative, equal prim/instance except where the plain
   version sees a t-tie, equal occlusion masks, no truncated ray; and B3 vs
   B1: t bit-equal wherever both found a hit, equal occlusion (prim and
   instance differ from B1's only on t-ties: held against the plain
   version). Prints the tie counts;
3. B2 vs its plain version on the same tables and rays, both run on the
   main path's co-sorted rays (the sort wrappers' order, which sets the
   sweep lanes): equal found masks, winner keys, instances and decoded prims,
   and bit-equal t where the keys agree, outside the near-tie lanes (another
   group's best, or tmax, within 2^-6 relative after the later of the
   winner's t and its group's box entry: there the order groups are visited
   in may pick another winner); equal certain / needs-retest / final
   occlusion masks outside the near-tmax lanes (an accept whose t or group
   box entry lies within 2^-6 below tmax or beyond it); the sorted wrappers
   return exactly the
   kernel's decoded result; no truncated ray. Prints the near-tie and
   near-tmax counts;
4. B2 vs B1 on the same rays, the reference's own precision contract:
   occlusion mismatch < 0.5% on every set; found-mask mismatch < 0.5% and the
   same prim on > 97% of rays that both hit on the primary rays, the ray
   class the contract was written for (on the bounce and shadow sets the
   JAX engine itself gives 1.5% and 0.4% found mismatch: printed, not gated);
5. times: median of CUDA-event runs, 10 of each kernel (after a warm-up,
   each behind a ~1 ms device sleep so that the wrapper's host time is not
   counted) and 2 of each plain version, on the co-sorted 131,072-ray sets:
   B1 and B3 side by side on
   both tables, B2 on the two-level one; plain versions on the two-level
   table (B3's, the same function as B1's, on the two sets the kernels line
   reports);
5b. bound inputs: the counting instantiation of each kernel (a template
   flag; the main path's instantiation is untouched) counts node steps,
   triangle tests and leaf visits once per set; with each module's
   operations per unit (UNIT_OPS) and the bytes each launch must move, they
   give each kernel's bound (the larger of the operations over the card's
   peaks, f32 at 67 TFLOP/s and bf16 at 133.8 TFLOP/s outside the tensor
   cores, and bytes / 3.35 TB/s; the bytes count the tables each kernel
   reads). B3's bound is the work of its function, B1's count on the same
   rays; the work its schedule does (the shared phase's node steps once per
   lane of the warp, every lane's own tests) and the warps that split are
   printed for every set and mode and reported beside it for the kernels
   line's sets (``schedule_bound_ms``, ``split_warps``). B1's and B2's
   counted node steps, triangle tests or
   band candidates and leaf visits must equal those of the walk that took
   one step per iteration (``STEP_WALK_WORK``): batching leaf visits keeps
   every ray's nodes and leaves;
6. the main path with the default configuration (bf16 engine): ``Renderer``
   on the benchmark frame (1280x720, 4 bounces, AA, NEE with one shadow ray):
   one warm-up and 3 timed ``tick``s with the counts set to 0 just before:
   B2 closest and any launched, plain versions never called, a finite image;
7. the main path with ``leaf_precision="f32"``: one warm-up and one timed
   tick, B1 closest and any launched, plain versions never called; the bf16
   frame vs the f32 frame (their first ticks, same key) within the JAX
   package's contract (MSE < 2e-3, < 3% of pixels off by > 0.05);
8. the main path with ``traversal="pallas_rows"``: one warm-up and one
   timed tick, B3 closest and any launched, B1 and B2 never, plain versions
   never called, no truncation, a finite image; its first tick vs the f32
   engine's (same key): >= 99.9% of pixels allclose at rtol 2e-4, atol
   2e-5 (only paths forked by a t-tie may differ);
9. GPU vs CPU: a chunk of pixels drawn over the frame rendered on the GPU
   (kernels) and on the CPU (plain versions) with the same key, per engine:
   4096 pixels with the f32 engine (>= 99% of pixels allclose at rtol 2e-4,
   atol 2e-5) and 1536 with the bf16 engine (>= 98%; its plain version is
   ~2.5x slower on the CPU);
10. the wave engine (``traversal="wave"``, on the bench scene's classic BVH,
   built with ``legacy_bvh=True``): (a) one full engine call per set and
   mode (the sorted wrappers on the first 122,880 rays of each set: one AA
   chunk of the frame, 960 tiles of 128 at level 0 of the cascade and 120
   at level 1) with every level run one wave a launch (``max_waves=1``):
   each wave of the fused level bit-equal to the plain wave on the same
   state, and B4 and the node-scan kernel vs their plain versions on that
   wave's inputs (the scan's cur, sp, stack, nleaf, leafbuf and active
   equal, B4's t, u, v, prim bit-equal and its occlusion equal); then the
   same call with whole levels, each bit-equal to ``plain_run_level`` with
   as many waves; the fused level timed (CUDA events) over each call's
   levels, its bound from the scan's and B4's ``count_work`` summed over the
   call's waves, its plain version on the heaviest call of each mode; B4 and
   the scan timed on the call's wave with the most triangle tests, with that
   wave's bound; the fused level's other paths (tiles that do not fit at
   once, a node table too large for shared memory) against the plain level
   over 1 and 30 waves; (b) one sorted call per mode under
   ``torch.cuda.set_sync_debug_mode("error")``: no host sync, one fused
   launch per level, no standalone B4 or scan launch; (c) the whole wave
   engine vs B1 on the three 131,072-ray sets: found and occlusion mismatch
   each <= 0.01%, the same prim on >= 99.95% of the rays both hit, waves,
   levels and fused launches per call printed; (d) the main path with
   ``traversal="wave"``: one warm-up and 3 timed ticks, the fused level
   launched once per cascade level in both modes, B4, the scan, B1-B3 and
   every plain version never, no truncated push, a finite image, >= 99.99%
   of pixels allclose (rtol 2e-4, atol 2e-5) to the f32 frame of the same
   key;
11. the command-line render path (after 10, before 9), at 1280x720:
   (a) the bench scene under the repo's sky fixture
   (``tests/golden/sky_32x16.hdr``), ``skybox=True``, ``post_processed``
   with preset 1 (Panini of its fov / distortion, grading, vignette,
   aberration -1) and ``samples_per_pixel=2``: one warm-up and one timed
   tick, B2 closest and any launched, plain versions never, a finite image;
   the same first tick without the sky differs on > 90% of the pixels whose
   primary ray missed; ``capture`` writes a non-empty file (its format
   printed: PNG, or PPM where PIL is absent); (b) the eight AOV views, one
   tick each (B2 closest only, no plain version, finite), and B2's unsorted
   exact-refine pass (``render_aov``'s) vs its plain version on the
   primary rays of a chunk's worth of pixels drawn over the frame (more
   than a quarter of them hit): equal keys, instances and refined hits
   outside near-tie lanes, the wrapper equal to the kernel's decoded
   result;
   (c) ``shade_tile=4096`` with the f32 engine: one tick, >= 99.99% of
   pixels allclose (rtol 2e-4, atol 2e-5) to phase 7's first f32 tick (the
   count of differing pixels printed, 0 expected: B1 is exact per ray),
   its time beside phase 7's; (d) ``python -m
   physically_based_ray_tracer_tpu_torch.cli --demo cornell --width 1280
   --height 720 --spp 2 --post --out build/cli_cornell.png``: exit 0 and
   the file written. Every frame time is printed with the card's name and
   power limit;
12. the dynamic-scene path (after 11, before 9), on the bench frame in its
   two-level layout (``build_bench_scene(flatten=False,
   return_handle=True)``): (a) 8 frames in which the nine spheres orbit
   the origin (``animate.orbit``, radius DYN_ORBIT) over the still floor:
   each frame ``rebuild_scene`` (host clock, device sync) and a
   from-scratch ``build_scene_instanced`` of the same instances (timed the
   same way), then a ``tick``: the refreshed tables equal the fresh
   build's byte for byte (every dense tensor, the derived tables and stack
   need, the shading arrays), the BLAS-side tensors are the objects the
   first table had; on frames DYN_IMAGE_FRAMES the frame equals the fresh
   build's frame bit for bit, and the previous frame's scene, rendered
   again, equals its own frame;
   B2 launched in both modes, no plain version called; the same motion on
   the ``legacy_bvh=True`` build for 2 frames (the classic tree rebuilt on
   the host, timed; every other table equal to a fresh build's, the
   classic tree's node count, topology and largest box difference printed)
   and one wave-engine frame >= 99.99% allclose (rtol 2e-4, atol 2e-5) to
   the fresh build's; (b) on frame 7's
   tables, a primary and a bounce-like set of 131,072 rays: B1 and B3 vs
   their plain version, B3 vs B1, B2 vs its plain version (phases 2-3's
   comparators); (c) every vertex of the flattened bench scene moved by a
   smooth seeded field of amplitude REFIT_AMP: ``refit_dense``'s
   ``leaf_rec`` and ``groups_bf2`` equal the tables ``__post_init__``
   builds from its groups (and differ from the unrefit ones), B1 and B2 =
   their plain versions on the refit table (primary and bounce sets), B1 =
   brute force over the deformed triangles (found, t within 1e-6
   relative, prim outside t-ties) on the primary set; ``refit_bvh`` of the
   classic tree: the fused level = ``plain_run_level`` on every level of
   one bounce call per mode, the wave engine vs B1 on the refit tables
   within phase 10's bounds; (d) an asset tree written under ``build/``
   (a glTF sphere, two GameObjects, lights, camera): ``EditSession`` at
   1280x720 (``edit_object``, ``render``, ``capture``, an external JSON
   edit folded in by ``watch_once``) gives the tables and the frame (bit
   for bit) of a fresh ``load_reference_scene`` of the edited tree; the
   command line's ``--session`` (commands on stdin), ``--debug-pixel 640
   360`` and ``--draw-bvh 3`` (on ``--demo cornell``), run side by side,
   exit 0; ``trace_pixel``'s final radiance on frame 7's tables =
   ``render_sample``'s for that pixel (no AA, the frame's brightest) bit
   for bit, and not black. Prints the median refresh, full-build and
   frame ms with the card's name and power limit, each kernel's launches
   over the phase (B1, B2, B3 and the fused level must launch), and the
   phase's seconds;
13. the differentiable path (after 9): (a) the bench frame's gradient
   (``diff/grad.py``): the L2 loss of the 1280x720 frame (4 bounces, AA,
   one shadow ray, the default bf16 engine, key 0, sample 0) against its
   own image at the scene's parameters, taken at perturbed albedo,
   roughness, metalness, emission, point and directional light colours,
   TRS of the 10 instances and camera position and target, with each of
   ``render_chunked``'s chunks' backward run before the next chunk's
   forward (``_frame_grad``; each chunk's squared error is summed over the
   frame's element count, so the gradients sum to the frame's): one
   warm-up and 2 timed runs, forward and backward ms, peak memory and the
   two runs' gradient difference printed; B2 closest and any and B1's
   retest launched, no plain version called, the row gather's backward
   kernel (``take_rows``) launched, every group's gradient finite and
   nonzero; then once with ``leaf_precision="f32"`` (B1 alone),
   the bf16-vs-f32 gradient difference per group printed, not gated; (b)
   1,024 pixels drawn over the frame (phase 9's draw), f32 engine: the
   gradient on the card (B1) and on the CPU (plain) within
   ``DIFF_CARD_VS_CPU`` (1e-2) of the CPU's norm per group; (c)
   tests/test_grad.py's finite-difference checks on the card (albedo,
   roughness, light intensity, emission, the TRS bake, rotation about an
   offset pivot, the look-at chain) at the test's scene, size and
   tolerances, through B1; (d) ``inverse_material.run()`` at its defaults
   (64x64, 200 steps, bf16): the last loss below 20% of the first,
   recovered and true albedo, roughness and point colour printed, ms per
   step; (e) the same problem trained to step ``DIFF_CKPT_STEP`` (100),
   checkpointed (``diff/checkpoint.py``, under ``build/``), trained 10
   steps on, then loaded into fresh parameters and a fresh optimiser and
   trained the same 10 steps: losses within ``DIFF_RESUME_RTOL`` (1e-5)
   relative; (d)'s losses beside them printed; (f) one backward of the
   inverse cell's step on the bench problem (65,536 pixels, f32 engine):
   one take_rows launch per row-gather backward call, and each call's
   cotangent reduced by the kernel twice (bit-equal) and by the plain
   version in float64 on the CPU, within float32's reordering bound
   element by element (``_take_rows_gate``); the heaviest call's kernel,
   plain-version and ``index_put_(accumulate=True)`` times and byte bound
   go to the kernels line. Prints each kernel's
   launches over the phase (B1 and B2 must launch in both modes) and the
   phase's seconds;
15. the classic-BVH path (after 13): (a) the torch engines over the bench
   scene's classic BVH (``legacy_bvh=True``, 16 triangles a leaf, depth
   15) on the three ray sets, as the integrator calls them (the lane engine
   unsorted and sorted, the packet engine sorted; closest and any): each
   against B1 on the two-level table within phase 10c's bounds, lane =
   packet (t bit-equal in practice, gated at 1e-6 relative, wherever brute
   force over the world triangles sees no t-tie; equal found masks and
   occlusion), the lane engine's sorted and unsorted calls equal, the
   engines' CUDA-graph step blocks bit-equal to the same steps run op by
   op (the lane engine on the three sets, the packet engine on the primary
   set's first PACKET_EAGER_RAYS rays), no overflow push (stack depth 48);
   each call's ms and steps printed; (b) the bench frame with
   ``traversal="lane"``, one tick (phase 10d's key), and with
   ``"packet"`` over every PACKET_STRIDE-th (4th) pixel of the Morton order
   (``frame_fn`` on 230,400 pixels, ~55 s where the whole frame took ~3.5
   minutes): >= 99.99% of pixels allclose (rtol 2e-4, atol 2e-5) to the
   same pixels of phase 10d's wave frame, no kernel launched (B1-B4, the
   scan, the fused level), no plain version called, a finite image; wall
   ms, steps and peak memory printed; (c) hq dense tables
   (``build_dense(hq=True)`` of the flattened bench triangles,
   ``build_dense_tlas(hq=True)`` of the two-level scene, the scene's leaf
   target and shaping): host build ms beside the binned builds' (which
   must equal the scene's tables); on both hq tables and the primary and
   bounce sets B1 and B3 = their plain version, B3 vs B1, B2 = its plain
   version outside near-tie lanes (phases 2-3's comparators); B1 = brute
   force on the primary set (found, t within 1e-6 relative, prim outside
   t-ties); B1 and B2 timed on each hq table beside the standard one
   (CUDA events behind the ~1 ms sleep, with their bounds from the
   counting instantiations); one f32 frame on the hq two-level tables >=
   99.9% allclose to phase 7's f32 frame; (d) the sort modes
   (``trace.SORT_MODES``) on the two-level table and the three sets: B1's
   results bit-equal under all three, B3's t and occlusion too and its
   prims outside t-ties; B2 = its plain version on the same sorted order
   under each mode besides the default on SORT_B2_SETS. Prints each
   kernel's launches over the phase (B1, B2 and B3 must launch) and the
   phase's seconds;
16. the parallel path (after 15; ``parallel/``, the sharded train step,
   ``utils/profiling.py``), on the bench frame (bf16 unless named): (a) a
   one-rank NCCL mesh in this process: NCCL's all_reduce and all_gather on
   CUDA tensors; ``sharded_frame``'s frame bit-equal to the unsharded
   frame (same key and sample); ``make_sharded_train_step``'s step on
   phase 13b's 1,024 pixels of phase 13a's gradient problem: loss and
   parameters bit-equal to ``make_train_step``'s; (b-d) PAR_RANKS (2) gloo
   ranks spawned on the card (``spawn_ranks``; they share it, so each
   collective stages through host memory; the kernels were built in phase
   1 and are only loaded there; a rank that fails fails the phase): (b) the
   sharded frame, bf16 and f32, and both again with ``reshard_block=4096``,
   stitched by ``gather_rows``: the f32 frame bit-equal to the unsharded
   one and the resharded f32 frame within atol 2e-6, rtol 1e-5 of it; the
   bf16 frame bit-equal to each rank's block rendered here (B2 breaks
   exact bf16 ties by the ray's lane in its batch, as the JAX kernel does,
   so the bf16 frame follows the batches: its difference from the
   unsharded frame is printed) and the resharded bf16 frame: at most
   PAR_BF16_RESHARD_DIFFER (0.05%) of its pixels differ from the
   unresharded frame, and within the bf16 contract of phase 7 (MSE < 2e-3,
   < 3% of pixels off by > 0.05);
   rays donated per bounce printed (some must move); (c)
   ``partition_instances`` of the bench scene's 10 instances over the 2
   ranks (5 each), ``partitioned_closest`` / ``partitioned_any`` on the
   three ray sets: found and occlusion equal to the unpartitioned
   two-level B1 trace, prims equal outside the plain version's t-ties, t
   within 1e-6 relative, the same result on both ranks; each rank's table
   bytes against the union's printed (not larger); (d)
   ``make_sharded_train_step`` on PAR_TRAIN_PIXELS (65,536) pixels drawn
   over the frame of phase 13a's gradient problem: the averaged gradient
   within PAR_GRAD_RTOL (1e-4) of one rank's gradient on the same pixels
   (the mean of the two blocks' gradients, each block traced here as its
   own batch, as in (b)), relative per group, its gap to the gradient of
   all the pixels as one batch printed, and both ranks' parameters
   bit-equal after the step; (e) ``measure_work_invariance`` of the bench frame at divisors 1,
   2 and 4 (3 timed frames each), and ``utils/profiling.trace`` of one
   frame under ``annotate("frame")``: the exported Chrome trace names the
   ``frame`` span and B2's kernel function. Prints each sub-phase's
   seconds, each kernel's launches over the phase summed over the ranks
   (B1 and B2 must launch) and the phase's seconds;
17. the main path's parity gates (after 16): (a) the converged mean:
   the fixture ``CONV_FIXTURE`` (``tests/golden/bench_converged_160x90_48spp.npz``,
   written by ``tests/torch_converged_fixture.py``: the JAX package's
   f32 and bf16 renders of the bench scene at 160x90, 4 bounces, AA, one
   shadow ray, ``max_stack_depth=max(depth + 2, 32)``, the last of 48
   ``Renderer.tick``s at seed 0, experiments/bf16_precision.py's
   config), loaded with numpy, its config equal to this phase's
   (``converged_fields``, which the fixture's generator also renders); the
   port's ``build_bench_scene`` rendered with that config on the card,
   48 ticks each, in one chunk (14,400 pixels: the JAX run's batches), f32
   and bf16 at seed 0 and f32 at seed 1; experiments/bf16_precision.py's
   statistics (mean, p99, p999 and max abs, MSE, pixels over 1%) of each
   port image against JAX f32, of port bf16 against JAX bf16 and of the
   fixture's pair, each with its ratios to the f32-vs-f32' noise floor
   ``CONV_FLOOR`` (docs/BF16_PRECISION_r05.json; ``image_stats``, which
   the generator also records), and the five worst
   pixels of port f32 and bf16 against JAX f32 printed; gates: G1
   MSE(port f32, JAX f32) <= ``CONV_JAX_BF16_VS_F32_MSE`` (1.97e-5, the
   JAX package's own bf16-vs-f32 MSE, the same file), G2 MSE(port bf16,
   JAX f32) <= twice that, with its mean, p99 and p999 abs below the
   floor's, G3 MSE(port f32 seed 1, JAX f32 seed 0) within
   ``CONV_FLOOR_BAND`` (0.8-1.25) of the floor's MSE (1.3756e-3); B1 and
   B2 launched in both modes, no plain version called; each render's ms
   a tick printed; (b) the ``BRDFConfig`` matrix and the oracle scenes,
   card (kernels) vs CPU (plain versions), same key, each >=
   ``PARITY_CLOSE`` (99%) of pixels allclose at rtol 2e-4, atol 2e-5:
   ``parity_scenes``' builds of tests/test_parity_stochastic.py's scene
   (rough, glass and mirror spheres, an emissive floor, point, spot and
   directional lights) and tests/test_parity.py's (a sphere over a floor,
   one directional light); one tick of the stochastic scene under the
   default ``BRDFConfig`` and each of ``brdf_matrix()``'s 13 settings
   (``parity_configs()["matrix"]``: 24x24, 3 bounces, AA off, f32); the
   directional config's image and its BASECOLOR view (bf16);
   ``trace_paths`` of the stochastic scene's 16x16 primary rays, 3
   bounces, key 7; B1 and B2 launched in both modes. CPU tests pin the
   scenes, configs and matrix to the JAX tests' (``tests/test_torch_oracle.py``,
   ``tests/test_torch_brdf_images.py``) and ``CONV_*`` to the fixture and
   the docs file (``tests/test_torch_converged.py``). Prints each
   sub-phase's seconds and the phase's;
18. the recorded frame chunk (``render/graph.py``), after 7: on the bench
   frame at 1280x720 and on the game's 480x270 tick with the nine spheres
   orbiting (``Renderer.tick(key, instances)``), both bf16, the
   two-level layout, ``GRAPH_TICKS`` ticks of a Renderer whose ticks
   replay the recorded chunk against as many of one held to the eager
   path, the same body (``graph_path`` refused): every film (accum, spp, dist) and
   image bit-equal, the last replayed tick recorded under
   ``torch.profiler`` (card and host) with the same result and its
   ``pbrt.tick`` span counting one replay a chunk, no capture, and copied
   scene tensors on the moving tick; B2 closest launches counted for the
   replays (one a chunk and bounce); each path's median tick time printed
   beside the other's with the card;
14. prints the kernels' JSON line (each kernel's launches over phase 12
   under ``dynamic_path_launches``, over phase 13 under
   ``diff_path_launches``, over phase 15 under ``classic_path_launches``,
   over phase 16, summed over the ranks, under
   ``parallel_path_launches``, over phase 17a under
   ``converged_path_launches``), the card line and, last, ``{"ok": true,
   "device": {...}}``.

Every phase prints its wall time. Any failed phase raises, and the script
exits non-zero without that line.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

N_RAYS = 131072
PKG = "physically_based_ray_tracer_tpu_torch"
KERNELS = {
    "traverse_f32": (f"{PKG}/csrc/traverse_f32.cu",
                     "physically_based_ray_tracer_tpu/ops/pallas_trace.py:102"),
    "traverse_bf16": (f"{PKG}/csrc/traverse_bf16.cu",
                      "physically_based_ray_tracer_tpu/ops/pallas_bf16.py:175"),
    "traverse_rows": (f"{PKG}/csrc/traverse_rows.cu",
                      "physically_based_ray_tracer_tpu/ops/pallas_rows.py:54"),
    "leaf_mt": (f"{PKG}/csrc/leaf_mt.cu",
                "physically_based_ray_tracer_tpu/ops/pallas_mt.py:30"),
    # port-only: replaces XLA code (a lax.scan), not a TPU kernel
    "wave_scan": (f"{PKG}/csrc/wave_scan.cu",
                  "physically_based_ray_tracer_tpu/ops/traverse_packet.py:381"),
    # port-only: one launch per cascade level for _wave_run's lax.while_loop
    # (the scan, B4 and the tile update), not a TPU kernel
    "wave_level": (f"{PKG}/csrc/wave_level.cu",
                   "physically_based_ray_tracer_tpu/ops/traverse_packet.py:479"),
    # port-only: the backward of the row gather (the JAX gather transposes
    # to an XLA scatter-add; no TPU kernel)
    "take_rows": (f"{PKG}/csrc/take_rows.cu", None),
}
T_RTOL = 1e-6
PLAIN_RUNS = 2          # timed runs of each plain version (each ~1-2 s)
ROWS_FRAME_CLOSE = 0.999
# the card's peaks for the bound, 700 W: f32 outside the tensor cores and
# device memory (NVIDIA H100 SXM data sheet); bf16 outside the tensor cores
# (NVIDIA H100 architecture whitepaper, SXM5; B2's per-lane arithmetic cannot
# use the tensor cores' 989 TFLOP/s). Both run on the same FMA units, so a
# kernel's operation time is the sum over types. The operations per unit of
# counted work are each module's UNIT_OPS, next to the kernel's counting entry.
PEAK_OPS = {"f32": 67e12, "bf16": 133.8e12}
PEAK_BYTES = 3.35e12
# bytes per ray each launch must move: o, d, tmax in; outputs by engine, mode
RAY_IN_BYTES = 28
OUT_BYTES = {("f32", "closest"): 20, ("f32", "any"): 1, ("rows", "closest"): 20,
             ("rows", "any"): 1, ("bf16", "closest"): 12, ("bf16", "any"): 2}
# B1's and B2's counted work on the three sets, two-level table, as the walk
# that took one node step or leaf visit per iteration counted it (the
# counting instantiations of the kernels before leaf visits were batched, on
# the same seeded rays): (engine, set, mode) -> (node steps, triangle tests
# or band candidates, leaf visits)
STEP_WALK_WORK = {
    ("f32", "primary", "closest"): (1157076, 1285320, 123442),
    ("f32", "bounce", "closest"): (3364702, 7041788, 481553),
    ("f32", "shadow", "closest"): (2354557, 4322120, 294822),
    ("f32", "primary", "any"): (1022595, 853349, 114310),
    ("f32", "bounce", "any"): (3141114, 5513820, 448237),
    ("f32", "shadow", "any"): (2279343, 3584765, 279099),
    ("bf16", "primary", "closest"): (1157875, 1290982, 123800),
    ("bf16", "bounce", "closest"): (3367470, 7048204, 482071),
    ("bf16", "shadow", "closest"): (2351720, 4311352, 294069),
    ("bf16", "primary", "any"): (336506, 269591, 88335),
    ("bf16", "bounce", "any"): (1910862, 3164995, 299472),
    ("bf16", "shadow", "any"): (2271740, 3661327, 276379)}
# the lines of nvcc's ptxas log that name a kernel function and give its
# registers, stack frame and spills
PTXAS_KEYS = ("Compiling entry function", "stack frame", "Used")
BF16_CHUNK = 1536
F32_CHUNK = 4096
WAVE_RAYS = 122880      # one AA chunk of the bench frame: 960 tiles of 128
# the wave engine vs B1 and vs the f32 frame: what the card showed (0 found /
# occlusion mismatch, >= 99.992% same prim, 100% of pixels allclose) with
# room for t-ties between the two trees
WAVE_FRAME_CLOSE = 0.9999
WAVE_VS_B1 = 1e-4       # the most found / occlusion mismatch vs B1
WAVE_SAME_PRIM = 0.9995
# the command-line path: the sky fixture, and the shade_tile frame's share
# of pixels allclose to the full-width f32 frame (B1 is exact per ray, so 0
# differ is expected)
SKY_FIXTURE = os.path.join("tests", "golden", "sky_32x16.hdr")
SHADE_TILE_CLOSE = 0.9999
# the dynamic-scene path (phase 12): frames; the frames whose image is also
# held to the fresh build's and whose previous scene is rendered again (the
# tables are held to the fresh build's on every frame); the radius of the
# nine spheres' orbit about the origin (2.3 apart on the circle: unit spheres
# do not overlap); the seeded deformation's amplitude (1% of a sphere's
# radius); rays per chunk of the brute-force check; the BLAS-side tensors a
# refresh keeps
DYN_FRAMES = 8
DYN_IMAGE_FRAMES = (1, DYN_FRAMES - 1)
DYN_ORBIT = 3.3
REFIT_AMP = 0.01
BRUTE_RAYS = 1024
MODULE_OF = {"f32": "trace", "bf16": "trace_bf16", "rows": "trace_rows"}
# the recorded frame chunk (phase 18): ticks of each path, the last one
# replayed under the profiler
GRAPH_TICKS = 4
# the differentiable path (phase 13): pixels of the card-vs-CPU gradient
# (phase 9's draw); its gate, ||g_card - g_cpu|| <= 1e-2 ||g_cpu|| per group
# (phase 9 lets <= 1% of pixels fork on t-ties, and the card's backward sums
# in another order); the inverse-rendering step checkpointed and the steps
# resumed after it; the resumed losses' largest relative difference
DIFF_PIXELS = 1024
DIFF_CARD_VS_CPU = 1e-2
DIFF_CKPT_STEP = 100
DIFF_RESUME_STEPS = 10
DIFF_RESUME_RTOL = 1e-5
# phase 13f: one step of the inverse cell's problem (its batch, a seed of
# its size), the row gather's backward held to float64
STEP_SEED = 2147483901
STEP_PIXELS = 65536
SHARED_TABLES = ("groups", "groups_bf", "glo", "pids_c", "prim_base", "leaf_rec",
                 "groups_bf2")
# the classic-BVH path (phase 15): the torch engines over the classic BVH;
# the rays on which the packet engine's CUDA-graph blocks are held to its
# op-by-op steps (each op-by-op step costs ~100 launches); the hq f32
# frame's share of pixels allclose to the f32 frame (only t-tie forks may
# differ); the sets on which B2 is held to its plain version under each
# sort mode besides the default (phase 3 covers octant_major); the packet
# frame renders every PACKET_STRIDE-th pixel of the Morton order
CLASSIC_ENGINES = ("lane", "packet")
PACKET_EAGER_RAYS = 4096
HQ_FRAME_CLOSE = 0.999
SORT_B2_SETS = ("bounce",)
PACKET_STRIDE = 4
# the parallel path (phase 16): gloo ranks spawned on the card (they share
# it); the ring donation block; the pixels (drawn over the frame, seed 2) of
# the two-rank train step and its gate, the averaged gradient within 1e-4 of
# one rank's on the same pixels, relative per group; the resharded frame's
# tolerance (tests/test_resharding.py's); the most pixels of the resharded
# bf16 frame that may differ from the unresharded one, as a share of the
# frame (donation moves rays into the neighbour's batch, where B2 may break
# an exact bf16 tie the other way: the card showed 116 of 921,600 pixels,
# 0.013%, and 171 between two chunkings of the unsharded frame);
# measure_work_invariance's divisors
PAR_RANKS = 2
PAR_RESHARD_BLOCK = 4096
PAR_TRAIN_PIXELS = 65536
PAR_GRAD_RTOL = 1e-4
PAR_RESHARD_TOL = dict(atol=2e-6, rtol=1e-5)
PAR_BF16_RESHARD_DIFFER = 5e-4
PAR_DIVISORS = (1, 2, 4)
# the main path's parity gates (phase 17). 17a: the fixture of the JAX
# package's converged renders (tests/torch_converged_fixture.py: the bench
# scene at 160x90, 4 bounces, AA, one shadow ray, 48 ticks, seed 0, f32 and
# bf16) and experiments/bf16_precision.py's statistics of that config
# (docs/BF16_PRECISION_r05.json, taken on the CPU): the JAX engines'
# bf16-vs-f32 MSE, which bounds the port's f32 against JAX's f32 (G1) and
# twice which bounds the port's bf16 against JAX's f32 (G2), and the
# f32-vs-f32' noise floor of two disjoint streams (seeds 0 and 1), whose mean,
# p99 and p999 abs bound G2's and whose MSE the port's seed-1 render must
# reach within CONV_FLOOR_BAND (G3)
CONV_FIXTURE = os.path.join("tests", "golden", "bench_converged_160x90_48spp.npz")
CONV_WIDTH, CONV_HEIGHT, CONV_SPP = 160, 90, 48
CONV_JAX_BF16_VS_F32_MSE = 1.97e-5
CONV_FLOOR = {"mean_abs": 0.010844, "p99_abs": 0.18326, "p999_abs": 0.34321,
              "max_abs": 0.5329, "mse": 0.0013756, "pixels_over_1pct": 0.17924}
CONV_FLOOR_BAND = (0.8, 1.25)
# 17b: tests/test_torch_brdf_images.py's config (on tests/test_parity_stochastic.py's
# scene, under the default BRDFConfig and each setting of brdf_matrix()),
# tests/test_parity.py's directional config and tests/test_parity_stochastic.py's
# paths (16x16, 3 bounces, key 7), card vs CPU at phase 9's tolerance
MATRIX_SIZE, MATRIX_BOUNCES = 24, 3
STOCH_SIZE, STOCH_BOUNCES, STOCH_KEY = 16, 3, 7
PARITY_CLOSE = 0.99


def _smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


class _Phase:
    """Prints a phase's wall time when it ends."""

    def __init__(self, name):
        self.name = name

    def __enter__(self):
        print(f"== {self.name}", flush=True)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        print(f"== {self.name}: {time.perf_counter() - self.t0:.1f} s"
              + (" (failed)" if exc[0] else ""), flush=True)
        return False


def _ray_sets(scene, cam, cfg, dev, seed=0):
    """Three (o, d, tmax) sets of N_RAYS rays on ``dev``."""
    import torch
    from physically_based_ray_tracer_tpu_torch import EPSILON
    from physically_based_ray_tracer_tpu_torch.scene.camera import primary_rays
    from physically_based_ray_tracer_tpu_torch.utils import rng
    from physically_based_ray_tracer_tpu_torch.utils.rng import Purpose

    far = torch.full((N_RAYS,), 1e30, dtype=torch.float32, device=dev)
    gen = np.random.default_rng(seed)
    # primary: an AA-doubled chunk of N_RAYS/2 pixels drawn over the whole
    # frame (sky, floor and spheres), in the main path's Morton order
    ids = torch.from_numpy(_frame_pixels(cfg, N_RAYS // 2, gen)).to(dev)
    xs = torch.remainder(ids, cfg.width).float()
    ys = torch.div(ids, cfg.width, rounding_mode="floor").float()
    j = rng.uniform2(0, ids, 0, 0, Purpose.AA_JITTER)
    o1, d1 = primary_rays(cam, xs, ys, cfg.width, cfg.height)
    o2, d2 = primary_rays(cam, xs + j[:, 0], ys + j[:, 1], cfg.width, cfg.height)
    primary = (torch.cat([o1, o2]).contiguous(), torch.cat([d1, d2]).contiguous(), far)

    P = scene.n_prims

    def surface_points():
        prim = torch.from_numpy(gen.integers(0, P, N_RAYS)).to(dev)
        uv = gen.uniform(0, 1, (N_RAYS, 2))
        flip = uv.sum(1) > 1
        uv[flip] = 1 - uv[flip]
        uv = torch.from_numpy(uv.astype(np.float32)).to(dev)
        p = (scene.tri_v0[prim] + uv[:, :1] * scene.tri_e1[prim]
             + uv[:, 1:] * scene.tri_e2[prim])
        return p, scene.face_normal[prim]

    p, n = surface_points()
    d = torch.nn.functional.normalize(
        torch.from_numpy(gen.normal(size=(N_RAYS, 3)).astype(np.float32)).to(dev), dim=1)
    d = torch.where((d * n).sum(1, keepdim=True) < 0, -d, d)
    bounce = ((p + d * EPSILON).contiguous(), d.contiguous(), far)

    p, n = surface_points()
    L = scene.lights
    targets = torch.cat([L.point_pos, L.dir_pos, L.spot_pos])
    tgt = targets[torch.from_numpy(gen.integers(0, targets.shape[0], N_RAYS)).to(dev)]
    lvec = tgt - p
    dist = lvec.norm(dim=1)
    d = lvec / dist[:, None]
    tmax = torch.where(torch.from_numpy(gen.uniform(0, 1, N_RAYS) < 0.2).to(dev),
                       torch.zeros_like(dist), dist - EPSILON)
    shadow = ((p + d * EPSILON).contiguous(), d.contiguous(), tmax.contiguous())
    return {"primary": primary, "bounce": bounce, "shadow": shadow}


def _frame_pixels(cfg, n, gen) -> np.ndarray:
    """``n`` distinct pixel ids of the frame, in Morton order."""
    from physically_based_ray_tracer_tpu_torch.render.renderer import morton_pixel_order
    order = morton_pixel_order(cfg.width, cfg.height)
    pick = np.sort(gen.choice(order.shape[0], n, replace=False))
    return order[pick]


def _plain_hit(dbvh, o, d, tm):
    """B1's plain version mapped like the kernel wrapper, plus its tie mask."""
    from physically_based_ray_tracer_tpu_torch.ops import trace
    *raw, t2 = trace.plain_traverse(dbvh, o, d, tm, closest=True)
    hit = trace.to_hit(dbvh, *raw)
    found = hit.prim >= 0
    tie = found & (t2 <= raw[0] * (1 + T_RTOL))
    return found, hit.t, hit.prim, hit.inst, tie


def _plain_ref(dbvh, o, d, tm):
    """B1's plain version (B3's too: the same function), once per table and
    set: found, t, prim, inst, t-tie mask, occlusion."""
    from physically_based_ray_tracer_tpu_torch.ops import trace
    found_p, t_p, prim_p, inst_p, tie = _plain_hit(dbvh, o, d, tm)
    occ_p = trace.plain_traverse(dbvh, o, d, tm, closest=False)
    return found_p, t_p, prim_p, inst_p, tie, occ_p


def _compare_exact(label, name, hit, occ_k, ref, report):
    """An exact kernel's results (through the main path's sorted wrappers)
    vs the plain version's."""
    import torch
    found_p, t_p, prim_p, inst_p, tie, occ_p = ref
    torch.cuda.synchronize()
    found_k = hit.prim >= 0
    both = found_k & found_p
    rel = ((hit.t - t_p).abs() / t_p.abs().clamp(min=1e-30))[both]
    same = both & ~tie
    r = dict(
        found=int(found_p.sum()), found_mismatch=int((found_k != found_p).sum()),
        ties=int(tie.sum()),
        t_max_rel=float(rel.max()) if rel.numel() else 0.0,
        t_max_abs=float((hit.t - t_p).abs()[same].max()) if same.any() else 0.0,
        prim_mismatch=int(((hit.prim != prim_p) & same).sum()),
        inst_mismatch=int(((hit.inst != inst_p) & same).sum()),
        occluded=int(occ_p.sum()), occ_mismatch=int((occ_k != occ_p).sum()))
    print(f"  {label} {name}: {json.dumps(r)}", flush=True)
    report.append(r)
    _check(r["found_mismatch"] == 0, f"{label} {name}: found masks differ")
    _check(r["t_max_rel"] <= T_RTOL, f"{label} {name}: t differs by {r['t_max_rel']}")
    _check(r["prim_mismatch"] == 0 and r["inst_mismatch"] == 0,
           f"{label} {name}: prim/inst differ outside t-ties")
    _check(r["occ_mismatch"] == 0, f"{label} {name}: occlusion masks differ")


def _rows_vs_f32(name, h3, occ3, h1, occ1):
    """B3 vs B1 on the same rays: t bit-equal where both found a hit, equal
    occlusion (prims may differ on t-ties only: checked against the plain
    version)."""
    both = (h3.prim >= 0) & (h1.prim >= 0)
    r = dict(t_not_bit_equal=int(((h3.t != h1.t) & both).sum()),
             prim_differs_on_ties=int(((h3.prim != h1.prim) & both).sum()),
             occ_mismatch=int((occ3 != occ1).sum()))
    print(f"  B3 vs B1 {name}: {json.dumps(r)}", flush=True)
    _check(r["t_not_bit_equal"] == 0, f"{name}: B3 t not bit-equal to B1's")
    _check(r["occ_mismatch"] == 0, f"{name}: B3 occlusion differs from B1's")


def _compare_bf16(name, dbvh, o, d, tm, report, sort_mode="octant_major"):
    """B2 vs its plain version on the co-sorted rays (the sweep lanes the
    main path gives them; ``sort_mode``: morton_key's mode), and the sorted
    wrappers vs the kernel's own decoded result."""
    import torch
    from physically_based_ray_tracer_tpu_torch.ops import trace, trace_bf16 as tb
    perm, o_s, d_s, tm_s = trace._cosort_rays(dbvh, o, d, tm, sort_mode)
    # closest
    t_k, gk_k, i_k = tb._call_bf16(dbvh, o_s, d_s, tm_s, closest=True)
    t_p, gk_p, i_p, near = tb.plain_traverse_bf16(dbvh, o_s, d_s, tm_s, True)
    hk = tb._decode_fast(dbvh, t_k, gk_k, i_k)
    hp = tb._decode_fast(dbvh, t_p, gk_p, i_p)
    wrapped = tb.sorted_closest_bf16(dbvh, o, d, tm, sort_mode=sort_mode, refine="fast")
    unsorted = [trace._unsort(perm, x) for x in hk]
    same_key = (gk_k == gk_p) & (i_k == i_p)
    found_k, found_p = gk_k >= 0, gk_p >= 0
    # any
    cert_k, unc_k = tb._call_bf16(dbvh, o_s, d_s, tm_s, closest=False)
    cert_p, unc_p, near_tm = tb.plain_traverse_bf16(dbvh, o_s, d_s, tm_s, False)
    need_k, need_p = unc_k & ~cert_k, unc_p & ~cert_p
    occ_k = tb.sorted_any_bf16(dbvh, o, d, tm, sort_mode=sort_mode)
    exact = trace.plain_traverse(dbvh, o_s, d_s, torch.where(need_p, tm_s, 0.0), False)
    occ_p = trace._unsort(perm, cert_p | (need_p & exact))
    near_tm_u = trace._unsort(perm, near_tm)
    torch.cuda.synchronize()
    out = ~near
    r = dict(
        found=int(found_p.sum()), found_mismatch=int(((found_k != found_p) & out).sum()),
        found_mismatch_near=int(((found_k != found_p) & near).sum()),
        near_tie=int(near.sum()),
        key_mismatch=int((~same_key & out).sum()),
        key_mismatch_near=int((~same_key & near).sum()),
        prim_mismatch=int(((hk.prim != hp.prim) & out).sum()),
        t_max_abs=float((t_k - t_p).abs()[same_key].max()) if same_key.any() else 0.0,
        wrapper_mismatch=int(sum(int((a != b).sum()) for a, b in zip(wrapped, unsorted))),
        certain=int(cert_p.sum()), need_retest=int(need_p.sum()),
        near_tmax=int(near_tm.sum()),
        cert_mismatch=int(((cert_k != cert_p) & ~near_tm).sum()),
        need_mismatch=int(((need_k != need_p) & ~near_tm).sum()),
        occ_mismatch=int(((occ_k != occ_p) & ~near_tm_u).sum()),
        occ_mismatch_near=int(((occ_k != occ_p) & near_tm_u).sum()))
    print(f"  B2 {name}: {json.dumps(r)}", flush=True)
    report.append(r)
    bad = ((found_k != found_p) | ~same_key) & out
    bad = torch.nonzero(bad | ((need_k != need_p) & ~near_tm)).flatten()[:8]
    for i in bad.tolist():
        print(f"    lane {i}: kernel t {float(t_k[i])!r} gk {int(gk_k[i])} inst "
              f"{int(i_k[i])}; plain t {float(t_p[i])!r} gk {int(gk_p[i])} inst "
              f"{int(i_p[i])}; tmax {float(tm_s[i])!r}; o {o_s[i].tolist()} d "
              f"{d_s[i].tolist()}", flush=True)
    _check(r["found_mismatch"] == 0, f"{name}: B2 found masks differ outside "
           "near-tie lanes")
    _check(r["key_mismatch"] == 0 and r["prim_mismatch"] == 0,
           f"{name}: B2 winner keys / prims differ outside near-tie lanes")
    _check(r["t_max_abs"] == 0.0, f"{name}: B2 t differs where the keys agree")
    _check(r["wrapper_mismatch"] == 0, f"{name}: sorted_closest_bf16 differs "
           "from the kernel's decoded result")
    _check(r["cert_mismatch"] == 0 and r["need_mismatch"] == 0
           and r["occ_mismatch"] == 0,
           f"{name}: B2 occlusion masks differ outside near-tmax lanes")


def _contract_bf16_vs_f32(name, dbvh, o, d, tm, report, closest_gate):
    """The JAX package's precision contract of the bf16 engine against the
    exact f32 one (tests/test_pallas_bf16.py). Its closest-hit half holds for
    the ray class it was written for, camera rays (``closest_gate``); rays
    leaving a surface lose more hits in bf16 (the JAX engine gives the same
    rates on these sets), so there it is printed, not gated."""
    import torch
    from physically_based_ray_tracer_tpu_torch.ops import trace, trace_bf16 as tb
    h16 = tb.sorted_closest_bf16(dbvh, o, d, tm)
    h32 = trace.sorted_closest_dense(dbvh, o, d, tm)
    occ16 = tb.sorted_any_bf16(dbvh, o, d, tm)
    occ32 = trace.sorted_any_dense(dbvh, o, d, tm)
    torch.cuda.synchronize()
    f16, f32 = h16.prim >= 0, h32.prim >= 0
    both = f16 & f32
    r = dict(found_mismatch=float((f16 != f32).float().mean()),
             same_prim=float(((h16.prim == h32.prim) & both).sum() / both.sum().clamp(min=1)),
             occ_mismatch=float((occ16 != occ32).float().mean()))
    print(f"  B2 vs B1 {name}: {json.dumps(r)}", flush=True)
    report.append(r)
    if closest_gate:
        _check(r["found_mismatch"] < 0.005, f"{name}: bf16 vs f32 found mismatch")
        _check(r["same_prim"] > 0.97, f"{name}: bf16 vs f32 prim agreement")
    _check(r["occ_mismatch"] < 0.005, f"{name}: bf16 vs f32 occlusion mismatch")


def _time_ms(fn, runs=10, warmup=True, setup=None, ahead=False):
    """Median over ``runs`` of one call timed by CUDA events, after a warm-up
    (plain versions compile nothing and need none). ``setup()`` makes the
    call's arguments outside the timed span (fresh copies of state a kernel
    updates in place). ``ahead``: the card first sleeps ~1 ms, so that the
    host queues the events and the launch before the card reaches them and
    a kernel of a few microseconds is timed without its wrapper's host time."""
    import torch
    if warmup:
        fn(*(setup() if setup else ()))
    times = []
    for _ in range(runs):
        args = setup() if setup else ()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        if ahead:
            torch.cuda._sleep(2_000_000)
        a.record()
        fn(*args)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _bound(eng, mode, dbvh, n_rays, ops):
    """(bound ms, "operations" or "bytes", bytes) of one launch of engine
    ``eng``: the larger of the operations ``ops`` (by type) over PEAK_OPS and
    the bytes it must move (each ray input read once, each output written
    once, each table the kernel reads read once: B1 its leaf records, B2
    its band pairs and group boxes, B3 B1's leaf records) over PEAK_BYTES."""
    leaf = {"f32": (dbvh.leaf_rec,), "bf16": (dbvh.groups_bf2, dbvh.glo),
            "rows": (dbvh.leaf_rec,)}[eng]
    tables = (dbvh.nodes16, *leaf, dbvh.inst16)
    nbytes = (n_rays * (RAY_IN_BYTES + OUT_BYTES[(eng, mode)])
              + sum(t.numel() * t.element_size() for t in tables))
    t_ops = sum(n / PEAK_OPS[kind] for kind, n in ops.items())
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes",
            nbytes)


def _frame(renderer, ticks, counters):
    """Warm-up tick (its image kept) + ``ticks`` timed ticks, with the launch
    and plain-call counts set to 0 just before and read just after."""
    import torch
    for c in counters:
        c.reset_counts()
    t0 = time.perf_counter()
    first = renderer.tick(0)
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    ms = []
    img = first
    for _ in range(ticks):
        t0 = time.perf_counter()
        img = renderer.tick(0)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = {c.__name__.rsplit(".", 1)[1]: (dict(c.LAUNCHES), dict(c.PLAIN_CALLS))
              for c in counters}
    return first, img, warm, ms, counts


def _bits(x):
    """A tensor's bits for exact comparison (floats as int32)."""
    import torch
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _ptxas_usage(log):
    """{kernel function: registers, stack frame and spill bytes} from nvcc's
    ``-Xptxas -v`` log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = m.group(1)
            out[name] = dict(registers=None, stack_bytes=None, spill_bytes=None)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out[name].update(stack_bytes=int(m.group(1)),
                             spill_bytes=int(m.group(2)) + int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[name]["registers"] = int(m.group(1))
    return out


class _LevelCheck:
    """Entered around one wave-engine call: ``wave_level.run_level``, which
    the engine calls once per cascade level, is replaced by a checking one.

    ``per_wave``: each level runs one wave a launch (``max_waves=1``, the
    level's test read on the host), and every wave's state is held
    bit-equal against the plain wave on the same input state
    (``plain_node_scan`` -> plain B4 -> ``_tile_update``); the standalone
    scan kernel and B4 are held against their plain versions on that wave's
    own inputs (the scan's cur, sp, stack, nleaf, leafbuf, active equal,
    B4's t, u, v, prim bit-equal or its occlusion equal). It sums the
    scan's and B4's ``count_work`` over the waves (the bound) and keeps the
    wave with the most triangle tests for timing. Otherwise each whole level
    (one launch) is held against ``plain_run_level`` from the same state:
    state bit-equal, as many waves; each level's entry state is kept for
    timing."""

    def __init__(self, mode, per_wave):
        self.mode, self.per_wave = mode, per_wave
        self.r = dict(levels=0, waves=0, level1_waves=0, wave_mismatch=0, scan_mismatch=0,
                      b4_mismatch=0, level_mismatch=0, level_wave_mismatch=0,
                      t_max_abs=0.0, tri_tests=0)
        self.work = dict(ops=0, bytes=0)
        self.heavy = None
        self.levels = []

    def __enter__(self):
        from physically_based_ray_tracer_tpu_torch.ops import wave_level
        self.wl, self.real = wave_level, wave_level.run_level
        wave_level.run_level = self.one_wave_at_a_time if self.per_wave else self.whole
        return self

    def __exit__(self, *exc):
        self.wl.run_level = self.real
        return False

    def _mismatch(self, got, want):
        return sum(int((_bits(got[k]) != _bits(want[k])).sum())
                   for k in self.wl.LEVEL_KEYS[self.mode])

    def one_wave_at_a_time(self, bvh, st, *, closest, node_steps, leaf_cap, leaf_size,
                           min_active, max_waves=None, dense="mt"):
        from physically_based_ray_tracer_tpu_torch.ops import leaf_mt, wave_scan
        self.r["levels"] += 1
        while int(st["active"].sum()) > min_active:
            st0 = {k: v.clone() for k, v in st.items()}
            self.real(bvh, st, closest=closest, node_steps=node_steps, leaf_cap=leaf_cap,
                      leaf_size=leaf_size, min_active=min_active, max_waves=1, dense=dense)
            # the plain wave, and the standalone scan kernel on its input
            scan = wave_scan.plain_node_scan(bvh, st0, node_steps, leaf_cap)
            cur, sp, stack, nleaf, leafbuf, active = scan
            scan_in = dict(st0, **{k: st0[k].clone() for k in wave_scan.STATE_KEYS})
            got = wave_scan.node_scan(bvh, scan_in, node_steps, leaf_cap)
            self.r["scan_mismatch"] += sum(int((a != b).sum()) for a, b in zip(got, scan))
            plain = dict(st0, cur=cur, sp=sp, stack=stack, active=active)
            rays = (st0["o_t"], st0["d_t"], st0["tmax"])
            keys = ("t", "u", "v", "prim") if closest else ("occ",)
            state0 = [st0[k] for k in keys]
            kern = [x.clone() for x in state0]
            if closest:
                want = leaf_mt.plain_leaf_intersect(*rays, *state0, leafbuf, nleaf, bvh.tris,
                                                    leaf_size)
                leaf_mt.leaf_intersect(*rays, *kern, leafbuf, nleaf, bvh.tris,
                                       leaf_size=leaf_size)
                self.r["t_max_abs"] = max(self.r["t_max_abs"],
                                          float((kern[0] - want[0]).abs().max()),
                                          float((st["t"] - want[0]).abs().max()))
            else:
                want = (leaf_mt.plain_leaf_any(*rays, *state0, leafbuf, nleaf, bvh.tris,
                                               leaf_size),)
                leaf_mt.leaf_any(*rays, *kern, leafbuf, nleaf, bvh.tris, leaf_size=leaf_size)
            self.r["b4_mismatch"] += sum(int((_bits(a) != _bits(b)).sum())
                                         for a, b in zip(kern, want))
            plain.update(zip(keys, want))
            plain = self.wl._tile_update(plain, closest=closest)
            self.r["wave_mismatch"] += self._mismatch(st, plain)
            # the bound's work, and the heaviest wave
            T, W = st0["tmax"].shape
            sw = wave_scan.count_work(bvh, st0, node_steps, leaf_cap)
            bw = leaf_mt.count_work(leafbuf, nleaf, W, leaf_size, self.mode)
            self.work["ops"] += sw["ops"]["f32"] + bw["ops"]["f32"]
            self.work["bytes"] += sw["bytes"] + bw["bytes"]
            self.r["tri_tests"] += bw["tri_tests"]
            self.r["level1_waves"] += int(self.r["levels"] > 1)
            if self.heavy is None or bw["tri_tests"] > self.heavy["tests"]:
                self.heavy = dict(tests=bw["tri_tests"], scan_in=st0, rays=rays,
                                  leafbuf=leafbuf.clone(), nleaf=nleaf.clone(),
                                  state0=[x.clone() for x in state0], tris=bvh.tris,
                                  leaf_size=leaf_size, wave=self.r["waves"], tiles=T,
                                  node_steps=node_steps, leaf_cap=leaf_cap)
            self.r["waves"] += 1
        return st

    def whole(self, bvh, st, *, closest, node_steps, leaf_cap, leaf_size, min_active,
              max_waves=None, dense="mt"):
        kw = dict(closest=closest, node_steps=node_steps, leaf_cap=leaf_cap,
                  leaf_size=leaf_size, min_active=min_active)
        st0 = {k: v.clone() for k, v in st.items()}
        n0 = self.wl.collect_waves()[self.mode]
        self.real(bvh, st, dense=dense, **kw)
        n_kernel = self.wl.collect_waves()[self.mode] - n0
        want = self.wl.plain_run_level(bvh, st0, **kw)
        n_plain = self.wl.collect_waves()[self.mode] - n0 - n_kernel
        self.r["level_mismatch"] += self._mismatch(st, want)
        self.r["level_wave_mismatch"] += int(n_kernel != n_plain)
        if closest:
            self.r["t_max_abs"] = max(self.r["t_max_abs"],
                                      float((st["t"] - want["t"]).abs().max()))
        self.r["levels"] += 1
        self.r["waves"] += n_kernel
        self.levels.append(dict(state=st0, kw=kw, waves=n_kernel))
        return st


def _wave_calls(bvh, o, d, tm, mode):
    """One sorted wave-engine call (the main path's wrappers)."""
    from physically_based_ray_tracer_tpu_torch.ops import traverse_packet as tp
    if mode == "closest":
        return tp.sorted_closest(tp.intersect_closest_wave, bvh, o, d, tm)
    return tp.sorted_any(tp.intersect_any_wave, bvh, o, d, tm)


def _wave_level_checks(bvh, sets, card):
    """The fused level kernel, B4 and the scan kernel vs their plain versions
    on one full engine call per set and mode (the sorted wrappers on the
    first WAVE_RAYS rays of the set: one AA chunk of the frame, 960 tiles at
    level 0 of the cascade, 120 at level 1): every wave (``_LevelCheck``
    per wave), then every whole level. Then times on each call: the fused
    kernel over the call's levels (its bound from the summed work of the
    scan and B4 over the call's waves; its plain version on the heaviest
    call of each mode), B4 and the scan kernel on the call's wave with the
    most triangle tests, with that wave's bound. Returns {(kernel, set,
    mode): dict}."""
    import torch
    from physically_based_ray_tracer_tpu_torch.ops import leaf_mt, wave_level, wave_scan
    from physically_based_ray_tracer_tpu_torch.ops import traverse_packet as tp
    out, checked = {}, {}
    level1 = 0
    for sname, (o, d, tm) in sets.items():
        o, d, tm = o[:WAVE_RAYS], d[:WAVE_RAYS], tm[:WAVE_RAYS]
        for mode in ("closest", "any"):
            tp.reset_counts()
            with _LevelCheck(mode, per_wave=True) as chk:
                res_wave = _wave_calls(bvh, o, d, tm, mode)
            r = chk.r
            waves_run = tp.collect_waves()[mode]
            launches = wave_level.LAUNCHES[mode]
            with _LevelCheck(mode, per_wave=False) as lv:
                res_level = _wave_calls(bvh, o, d, tm, mode)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in zip(
                res_wave if mode == "closest" else [res_wave],
                res_level if mode == "closest" else [res_level]))
            r.update(level_mismatch=lv.r["level_mismatch"],
                     level_wave_mismatch=lv.r["level_wave_mismatch"],
                     level_waves=lv.r["waves"], results_equal=same)
            print(f"  wave {sname} {mode}, every wave and every level: {json.dumps(r)}",
                  flush=True)
            _check(r["waves"] == waves_run == launches > 0,
                   f"wave {sname} {mode}: a max_waves=1 launch did not run one wave")
            _check(r["wave_mismatch"] == 0, f"wave {sname} {mode}: wave_level != plain wave")
            _check(r["scan_mismatch"] == 0, f"wave {sname} {mode}: scan kernel != plain")
            _check(r["b4_mismatch"] == 0, f"wave {sname} {mode}: B4 != plain")
            _check(r["level_mismatch"] == 0 and r["level_wave_mismatch"] == 0,
                   f"wave {sname} {mode}: a level differs from plain_run_level")
            _check(lv.r["waves"] == r["waves"] and lv.r["levels"] == r["levels"] and same,
                   f"wave {sname} {mode}: levels and waves one at a time differ")
            _check(wave_scan.truncated_pushes(o.device) == 0, "scan stack overflow")
            level1 += r["level1_waves"]
            checked[(sname, mode)] = (chk, lv)
    _check(level1 > 0, "no level-1 wave was checked")

    heaviest = {mode: max((s for s, m in checked if m == mode),
                          key=lambda s: checked[(s, mode)][0].r["tri_tests"])
                for mode in ("closest", "any")}
    for (sname, mode), (chk, lv) in checked.items():
        closest = mode == "closest"
        r = chk.r
        # the fused kernel over the call's levels
        per_level, plain_ms = [], 0.0
        for level in lv.levels:
            fresh = lambda lev=level: [{k: v.clone() for k, v in lev["state"].items()}]
            per_level.append(_time_ms(lambda s, lev=level: wave_level.run_level(
                bvh, s, **lev["kw"]), runs=20, setup=fresh, ahead=True))
            if heaviest[mode] == sname:
                plain_ms += _time_ms(lambda s, lev=level: wave_level.plain_run_level(
                    bvh, s, **lev["kw"]), runs=PLAIN_RUNS, warmup=False, setup=fresh)
        level_ms = sum(per_level)
        # each level's tiles, waves and device microseconds a wave
        per_level = [(lev["state"]["cur"].shape[0], lev["waves"], ms_ * 1e3 / max(lev["waves"], 1))
                     for lev, ms_ in zip(lv.levels, per_level)]
        t_ops = chk.work["ops"] / PEAK_OPS["f32"]
        t_bytes = chk.work["bytes"] / PEAK_BYTES
        b_ms = max(t_ops, t_bytes) * 1e3
        out[("wave_level", sname, mode)] = dict(
            ms=level_ms, plain_ms=plain_ms if heaviest[mode] == sname else None,
            bound_ms=b_ms, bound_by="operations" if t_ops >= t_bytes else "bytes",
            max_abs_err=r["t_max_abs"] if closest else float(r["wave_mismatch"] > 0),
            waves=r["waves"], ms_per_wave=level_ms / r["waves"], levels=len(lv.levels),
            tiles_waves_us_per_level=per_level, heaviest=heaviest[mode] == sname)
        print(f"time wave_level {mode:7s} {sname:7s} one engine call, {len(lv.levels)} "
              f"levels, {r['waves']} waves: kernel {level_ms:.4f} ms "
              f"({level_ms / r['waves'] * 1e3:.3f} us a wave), "
              + (f"plain {plain_ms:.1f} ms, " if heaviest[mode] == sname else "")
              + f"bound {b_ms:.6f} ms ({out[('wave_level', sname, mode)]['bound_by']}: "
              f"ops {chk.work['ops']}, bytes {chk.work['bytes']}), bound / kernel "
              f"{100 * b_ms / level_ms:.2f}%; per level (tiles, waves, us a wave) "
              f"{per_level}; launch {wave_level.LAST_LAUNCH} [{card}]",
              flush=True)

        # B4 and the scan kernel on the heaviest wave
        h = chk.heavy
        rays, lb, nl, tris, K = h["rays"], h["leafbuf"], h["nleaf"], h["tris"], h["leaf_size"]
        T, W = rays[2].shape
        fresh = lambda: [x.clone() for x in h["state0"]]
        if closest:
            k_fn = lambda *s: leaf_mt.leaf_intersect(*rays, *s, lb, nl, tris, leaf_size=K)
            p_fn = lambda *s: leaf_mt.plain_leaf_intersect(*rays, *s, lb, nl, tris, K)
        else:
            k_fn = lambda *s: leaf_mt.leaf_any(*rays, *s, lb, nl, tris, leaf_size=K)
            p_fn = lambda *s: leaf_mt.plain_leaf_any(*rays, *s, lb, nl, tris, K)
        b4_work = leaf_mt.count_work(lb, nl, W, K, mode)
        ns, lc = h["node_steps"], h["leaf_cap"]
        scan_work = wave_scan.count_work(bvh, h["scan_in"], ns, lc)
        scan_fresh = lambda: [dict(h["scan_in"], **{k: h["scan_in"][k].clone()
                                                    for k in wave_scan.STATE_KEYS})]
        for name, fn, pfn, setup, work, err in (
                ("leaf_mt", k_fn, p_fn, fresh, b4_work,
                 r["t_max_abs"] if closest else float(r["b4_mismatch"] > 0)),
                ("wave_scan", lambda s: wave_scan.node_scan(bvh, s, ns, lc),
                 lambda s: wave_scan.plain_node_scan(bvh, s, ns, lc), scan_fresh,
                 scan_work, float(r["scan_mismatch"] > 0))):
            k_ms = _time_ms(fn, runs=20, setup=setup, ahead=True)
            p_ms = _time_ms(pfn, runs=PLAIN_RUNS, warmup=False, setup=setup)
            t_ops = work["ops"]["f32"] / PEAK_OPS["f32"]
            t_bytes = work["bytes"] / PEAK_BYTES
            b_ms = max(t_ops, t_bytes) * 1e3
            out[(name, sname, mode)] = dict(
                ms=k_ms, plain_ms=p_ms, bound_ms=b_ms,
                bound_by="operations" if t_ops >= t_bytes else "bytes", max_abs_err=err)
            print(f"time {name} {mode:7s} {sname:7s} wave {h['wave']} of {T} tiles: "
                  f"kernel {k_ms:.5f} ms, plain {p_ms:.3f} ms, bound {b_ms:.6f} ms "
                  f"({out[(name, sname, mode)]['bound_by']}: {json.dumps(work)}), "
                  f"bound / kernel {100 * b_ms / k_ms:.2f}% [{card}]", flush=True)
    return out


def _wave_level_paths(scene, bvh, sets):
    """The fused level's paths the main path does not take, against the
    plain level (one wave, then 30): tiles that do not all fit at once (the
    bounce and shadow sets together, 2,048 tiles > 132 blocks x 8, so each
    wave loops over them with their state in device memory), and a node
    table too large for shared memory (the bench triangles' classic BVH with
    4 triangles a leaf, read through the read-only path). State bit-equal."""
    import torch
    from physically_based_ray_tracer_tpu_torch.bvh.builder import build_bvh
    from physically_based_ray_tracer_tpu_torch.ops import wave_level
    from physically_based_ray_tracer_tpu_torch.ops import traverse_packet as tp
    o, d, tm = (torch.cat([a, b]) for a, b in zip(sets["bounce"], sets["shadow"]))
    tri = torch.stack([scene.tri_v0, scene.tri_v0 + scene.tri_e1,
                       scene.tri_v0 + scene.tri_e2], 1).cpu().numpy()
    small_leaves = build_bvh(tri, leaf_size=4).to(o.device)
    for name, tree, K, n, smem in ((f"{o.shape[0] // 128} tiles", bvh, 16, o.shape[0], True),
                                   (f"{small_leaves.n_nodes}-node table", small_leaves, 4,
                                    WAVE_RAYS, False)):
        lo, hi = tp._scene_bounds(tree)
        perm = tp.morton_order(o[:n], d[:n], lo, hi)
        to, td, (ttm,), _, _ = tp._pad_tiles(o[:n][perm], d[:n][perm], [tm[:n][perm]], 128)
        for closest in (True, False):
            st = tp._wave_state(to, td, ttm, 48, closest)
            kw = dict(closest=closest, node_steps=8, leaf_cap=4, leaf_size=K, min_active=0)
            for max_waves in (1, 30):
                want = wave_level.plain_run_level(tree, st, max_waves=max_waves, **kw)
                got = {k: v.clone() for k, v in st.items()}
                wave_level.run_level(tree, got, max_waves=max_waves, **kw)
                torch.cuda.synchronize()
                bad = [k for k in wave_level.LEVEL_KEYS["closest" if closest else "any"]
                       if not torch.equal(_bits(got[k]), _bits(want[k]))]
                print(f"  fused level, {name}, closest={closest}, {max_waves} waves: launch "
                      f"{wave_level.LAST_LAUNCH}, state differs in {bad}", flush=True)
                _check(not bad, f"fused level, {name}: state differs from plain_run_level")
                _check(wave_level.LAST_LAUNCH["smem_nodes"] == smem,
                       f"fused level, {name}: node table placement")


def _wave_sync_free(bvh, sets):
    """One sorted wave-engine call per mode (bounce rays) under
    ``torch.cuda.set_sync_debug_mode("error")``: it must not synchronise,
    and it launches the fused kernel once per cascade level and nothing
    else of the wave engine."""
    import torch
    from physically_based_ray_tracer_tpu_torch.ops import leaf_mt, wave_level, wave_scan
    from physically_based_ray_tracer_tpu_torch.ops import traverse_packet as tp
    o, d, tm = sets["bounce"]
    for mode in ("closest", "any"):
        _wave_calls(bvh, o, d, tm, mode)   # warm-up: loads the library, makes the counters
        torch.cuda.synchronize()
        for m in (tp, leaf_mt, wave_scan):
            m.reset_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            _wave_calls(bvh, o, d, tm, mode)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        launched = dict(wave_level.LAUNCHES)
        print(f"  wave engine {mode} under sync debug mode 'error': no sync; levels "
              f"{tp.LEVELS[mode]}, fused launches {launched}, B4 {leaf_mt.LAUNCHES}, scan "
              f"{wave_scan.LAUNCHES}", flush=True)
        _check(launched[mode] == tp.LEVELS[mode] > 0 and sum(launched.values())
               == launched[mode], f"wave {mode}: not one fused launch per level")
        _check(sum(leaf_mt.LAUNCHES.values()) + wave_scan.LAUNCHES["scan"] == 0,
               f"wave {mode}: a standalone wave kernel ran")


def _wave_vs_b1(scene_w, dbvh, sets, card):
    """The whole wave engine (through its sorted wrappers) vs B1 on the same
    rays; prints the rates, levels, fused launches and waves of each call.
    Returns the fused launches per mode (each call resets the counts)."""
    import torch
    from physically_based_ray_tracer_tpu_torch.ops import trace, wave_level, wave_scan
    from physically_based_ray_tracer_tpu_torch.ops import traverse_packet as tp
    bvh = scene_w.bvh
    total = {"closest": 0, "any": 0}
    for sname, (o, d, tm) in sets.items():
        calls = {}
        for mode in ("closest", "any"):
            tp.reset_counts()
            t0 = time.perf_counter()
            res = _wave_calls(bvh, o, d, tm, mode)
            torch.cuda.synchronize()
            calls[mode] = (res, (time.perf_counter() - t0) * 1e3, tp.collect_waves()[mode],
                           tp.LEVELS[mode], wave_level.LAUNCHES[mode])
        hw, occ_w = calls["closest"][0], calls["any"][0]
        h1 = trace.sorted_closest_dense(dbvh, o, d, tm)
        occ1 = trace.sorted_any_dense(dbvh, o, d, tm)
        fw, f1 = hw.prim >= 0, h1.prim >= 0
        both = fw & f1
        r = dict(found_mismatch=float((fw != f1).float().mean()),
                 same_prim=float(((hw.prim == h1.prim) & both).sum() / both.sum().clamp(min=1)),
                 t_max_rel=float(((hw.t - h1.t).abs() / h1.t.abs())[both].max()),
                 occ_mismatch=float((occ_w != occ1).float().mean()))
        print(f"  wave vs B1 {sname}: {json.dumps(r)}", flush=True)
        for mode, (_, ms, waves, levels, fused) in calls.items():
            print(f"  wave engine {mode:7s} {sname:7s} {N_RAYS} rays: {ms:.2f} ms host "
                  f"clock, {waves} waves, {levels} levels, {fused} fused launches [{card}]",
                  flush=True)
            _check(fused == levels > 0, f"{sname} {mode}: not one fused launch per level")
        _check(r["found_mismatch"] <= WAVE_VS_B1, f"{sname}: wave vs B1 found mismatch")
        _check(r["same_prim"] >= WAVE_SAME_PRIM, f"{sname}: wave vs B1 prim agreement")
        _check(r["occ_mismatch"] <= WAVE_VS_B1, f"{sname}: wave vs B1 occlusion mismatch")
        _check(wave_scan.truncated_pushes(o.device) == 0, "wave engine stack overflow")
        for mode, call in calls.items():
            total[mode] += call[4]
    return total


def _chunk_gpu_vs_cpu(renderer, cfg, n, frac, what):
    """render_sample of ``n`` pixels on the GPU (kernels) and on the CPU
    (plain versions), same key; >= ``frac`` of pixels allclose."""
    import torch
    from physically_based_ray_tracer_tpu_torch.render.integrator import render_sample
    dev = renderer.device
    ids = torch.from_numpy(_frame_pixels(cfg, n, np.random.default_rng(1))).to(dev)
    c_gpu, _ = render_sample(renderer.scene, renderer.camera, cfg, 0, 0, ids)
    t0 = time.perf_counter()
    c_cpu, _ = render_sample(renderer.scene.to("cpu"), renderer.camera.to("cpu"), cfg,
                             0, 0, ids.cpu())
    close = np.isclose(c_gpu.cpu().numpy(), c_cpu.numpy(), rtol=2e-4,
                       atol=2e-5).all(axis=1)
    print(f"{n}-pixel chunk, {what}, kernels (GPU) vs plain (CPU, "
          f"{time.perf_counter() - t0:.1f} s): {close.mean() * 100:.3f}% pixels "
          f"allclose, mean abs diff {float((c_gpu.cpu() - c_cpu).abs().mean()):.3e}",
          flush=True)
    _check(close.mean() >= frac, f"{what}: kernel and plain chunk images disagree")


def _b2_unsorted_vs_plain(dbvh, o, d):
    """B2 on unsorted rays with the exact refine (render_aov's closest-hit
    pass) vs its plain version on the same lanes: equal found masks, keys,
    instances and refined hit records outside the near-tie lanes, and the
    wrapper equal to the kernel's decoded result on every lane."""
    import torch
    from physically_based_ray_tracer_tpu_torch.ops import trace_bf16 as tb
    tm = tb._far(o)
    t_k, gk_k, i_k = tb._call_bf16(dbvh, o, d, tm, closest=True)
    t_p, gk_p, i_p, near = tb.plain_traverse_bf16(dbvh, o, d, tm, True)
    hk = tb._decode_refine(dbvh, o, d, tm, t_k, gk_k, i_k)
    hp = tb._decode_refine(dbvh, o, d, tm, t_p, gk_p, i_p)
    wrapped = tb.intersect_closest_bf16(dbvh, o, d, refine="exact")
    torch.cuda.synchronize()
    out = ~near
    r = dict(rays=int(o.shape[0]), found=int((gk_p >= 0).sum()), near_tie=int(near.sum()),
             key_mismatch=int((((gk_k != gk_p) | (i_k != i_p)) & out).sum()),
             hit_mismatch=int(sum(int(((_bits(a) != _bits(b)) & out).sum())
                                  for a, b in zip(hk, hp))),
             wrapper_mismatch=int(sum(int((_bits(a) != _bits(b)).sum())
                                      for a, b in zip(wrapped, hk))))
    print(f"  B2 unsorted, refine='exact' (render_aov's pass): {json.dumps(r)}", flush=True)
    _check(r["found"] > r["rays"] // 4, "B2 unsorted check: too few rays hit")
    _check(r["key_mismatch"] == 0 and r["hit_mismatch"] == 0,
           "B2 unsorted exact-refine hits differ from the plain version outside near lanes")
    _check(r["wrapper_mismatch"] == 0,
           "intersect_closest_bf16(refine='exact') differs from the kernel's decoded result")


def _cli_path(scene2, cam, cfg, dev, card, first32, ms32, engines):
    """Phase 11: the command-line render path on the bench frame. Returns
    the frame times it printed."""
    import dataclasses
    import torch
    from physically_based_ray_tracer_tpu_torch.config import RenderMode
    from physically_based_ray_tracer_tpu_torch.ops import trace_bf16
    from physically_based_ray_tracer_tpu_torch.ops.tonemap import POST_PRESETS
    from physically_based_ray_tracer_tpu_torch.render.renderer import Renderer
    from physically_based_ray_tracer_tpu_torch.scene.camera import primary_rays
    from physically_based_ray_tracer_tpu_torch.utils.image import read_hdr

    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "build")
    os.makedirs(out_dir, exist_ok=True)
    report = {}

    # (a) the bench scene under the repo's sky fixture, Panini + post preset
    # 1, two in-frame samples; the same frame without the sky
    sky = torch.from_numpy(read_hdr(os.path.join(root, SKY_FIXTURE))).to(dev)
    scene_sky = dataclasses.replace(scene2, sky=sky)
    pp = POST_PRESETS[1]
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=dev)
    cam_p = dataclasses.replace(cam, fov=f32(pp["fov"]), distortion=f32(pp["distortion"]))
    cfg_a = cfg.replace(skybox=True, post_processed=True, post_preset=1,
                        samples_per_pixel=2)
    r_a = Renderer(scene_sky, cam_p, cfg_a, device=dev)
    first_a, img, warm, ms, counts = _frame(r_a, 1, engines)
    launches = counts["trace_bf16"][0]
    plain = sum(sum(c[1].values()) for c in counts.values())
    print(f"frame 1280x720 4 bounces AA bf16, sky + Panini + post preset 1, spp 2: warm-up "
          f"{warm:.2f} s, {ms[0]:.2f} ms; B2 launches {launches}, B1 launches "
          f"{counts['trace'][0]}, plain-version calls {plain} [{card}]", flush=True)
    report["sky_post_spp2_ms"] = ms[0]
    _check(launches["closest"] > 0 and launches["any"] > 0,
           "the sky/post/spp frame did not launch both B2 modes")
    _check(plain == 0, "the sky/post/spp frame called a plain version")
    _check(img.shape == (720, 1280, 3) and bool(np.isfinite(img).all()),
           "sky/post/spp image not finite or of the wrong shape")
    dist = np.empty(cfg.n_pixels, np.float32)
    dist[r_a._pixel_ids_np] = r_a.film.dist.cpu().numpy()
    miss = dist.reshape(720, 1280) >= 1e29
    r_dark = Renderer(scene_sky, cam_p, cfg_a.replace(skybox=False), device=dev)
    t0 = time.perf_counter()
    dark = r_dark.tick(0)
    torch.cuda.synchronize()
    differ = (first_a != dark).any(axis=-1)
    share = float(differ[miss].mean()) if miss.any() else 0.0
    print(f"sky vs no sky (first ticks, same key): {int(miss.sum())} pixels miss, "
          f"{share * 100:.3f}% of them differ; no-sky frame "
          f"{(time.perf_counter() - t0) * 1e3:.2f} ms [{card}]", flush=True)
    _check(miss.sum() > 0 and share > 0.9, "the sky does not show on missed pixels")
    path = r_a.capture(os.path.join(out_dir, "smoke_capture.png"))
    with open(path, "rb") as f:
        head = f.read(8)
    fmt = "png" if head.startswith(b"\x89PNG") else "ppm (PIL absent)"
    size = os.path.getsize(path)
    print(f"capture: {path}, {size} bytes, format {fmt}", flush=True)
    _check(size > 0, "capture wrote an empty file")

    # (b) every AOV view on the bench frame, one tick each; B2's unsorted
    # exact-refine pass vs its plain version on a chunk of frame-wide rays
    aov_ms = {}
    for mode in RenderMode:
        if mode == RenderMode.BRDF:
            continue
        r = Renderer(scene2, cam, cfg.replace(rendering_mode=mode), device=dev)
        for c in engines:
            c.reset_counts()
        t0 = time.perf_counter()
        img = r.tick(0)
        torch.cuda.synchronize()
        aov_ms[mode.name] = (time.perf_counter() - t0) * 1e3
        la, pl = dict(trace_bf16.LAUNCHES), sum(sum(c.PLAIN_CALLS.values()) for c in engines)
        _check(la["closest"] > 0 and la["any"] == 0 and pl == 0,
               f"AOV {mode.name}: B2 closest only, no plain version ({la}, plain {pl})")
        _check(img.shape == (720, 1280, 3) and bool(np.isfinite(img).all()),
               f"AOV {mode.name} image not finite")
    print(f"AOV frames 1280x720 (one tick each, ms): {json.dumps(aov_ms)} [{card}]",
          flush=True)
    report["aov_ms"] = aov_ms
    # a chunk's worth of pixels drawn over the whole frame (the first Morton
    # chunk is all sky), in the main path's Morton order
    n_chunks = -(-cfg.n_pixels // cfg.chunk_pixels)
    ids = torch.from_numpy(_frame_pixels(cfg, -(-cfg.n_pixels // n_chunks),
                                         np.random.default_rng(2))).to(dev)
    o, d = primary_rays(cam, torch.remainder(ids, cfg.width).float(),
                        torch.div(ids, cfg.width, rounding_mode="floor").float(),
                        cfg.width, cfg.height)
    _b2_unsorted_vs_plain(scene2.dense, o.contiguous(), d.contiguous())

    # (c) the sub-tile shading gates (shade_tile=4096) on the f32 frame
    cfg_c = cfg.replace(leaf_precision="f32", shade_tile=4096)
    r_c = Renderer(scene2, cam, cfg_c, device=dev)
    first_c, _, _, ms_c, counts_c = _frame(r_c, 1, engines)
    close = np.isclose(first_c, first32, rtol=2e-4, atol=2e-5).all(axis=-1)
    print(f"shade_tile=4096 f32 frame: {ms_c[0]:.2f} ms against shade_tile=0 "
          f"{ms32:.2f} ms ({ms_c[0] / ms32:.2f}x); {int((~close).sum())} pixels differ "
          f"from the shade_tile=0 frame ({close.mean() * 100:.4f}% allclose); B1 launches "
          f"{counts_c['trace'][0]} [{card}]", flush=True)
    report["shade_tile_4096_ms"] = ms_c[0]
    _check(close.mean() >= SHADE_TILE_CLOSE, "shade_tile=4096 frame vs shade_tile=0 frame")

    # (d) the command line as a user runs it
    out = os.path.join(out_dir, "cli_cornell.png")
    if os.path.exists(out):
        os.remove(out)
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", f"{PKG}.cli", "--demo", "cornell",
                          "--width", "1280", "--height", "720", "--spp", "2", "--post",
                          "--out", out], cwd=root, capture_output=True, text=True,
                         timeout=600)
    print(f"cli ({time.perf_counter() - t0:.1f} s, exit {res.returncode}):\n"
          f"{res.stderr.strip()}\n{res.stdout.strip()} [{card}]", flush=True)
    _check(res.returncode == 0, "the command line failed")
    _check(os.path.exists(out) and os.path.getsize(out) > 0, "the command line wrote no file")
    return report


def _differ(a, b):
    """The fields of two scenes whose tables are not the same bytes: every
    tensor of the dense table (its derived tables too) and its stack need,
    the shading arrays and the lights."""
    import torch

    def same(x, y):
        if x is None or y is None:
            return x is None and y is None
        return (x.dtype == y.dtype and x.shape == y.shape and torch.equal(
            x.contiguous().view(-1).view(torch.uint8), y.contiguous().view(-1).view(torch.uint8)))
    out = [f"dense.{k}" for k, v in vars(a.dense).items()
           if isinstance(v, torch.Tensor) and not same(v, getattr(b.dense, k))]
    if a.dense.stack_need != b.dense.stack_need:
        out.append("dense.stack_need")
    out += [k for k, v in vars(a).items()
            if isinstance(v, torch.Tensor) and not same(v, getattr(b, k))]
    return out + [f"lights.{k}" for k, v in vars(a.lights).items()
                  if not same(v, getattr(b.lights, k))]


def _brute_closest(o, d, tri):
    """Closest hit of every ray over a triangle list (prim order), by the
    plain version's Möller-Trumbore (``trace._mt``, the kernel's operations)
    on the card: (t, prim, t-tie mask)."""
    import torch
    from physically_based_ray_tracer_tpu_torch.ops import trace
    tri = torch.from_numpy(np.ascontiguousarray(tri, np.float32)).to(o.device)
    v0 = tri[:, 0]
    edges = (v0, tri[:, 1] - v0, tri[:, 2] - v0)
    ts, prims, ties = [], [], []
    for r0 in range(0, o.shape[0], BRUTE_RAYS):
        oc, dc = o[r0:r0 + BRUTE_RAYS], d[r0:r0 + BRUTE_RAYS]
        tt, _, _, ok = trace._mt(tuple(oc[:, k, None] for k in range(3)),
                                 tuple(dc[:, k, None] for k in range(3)), edges)
        tt = torch.where(ok, tt, torch.full_like(tt, 1e30))
        t1, j1 = tt.min(dim=1)
        tt.scatter_(1, j1[:, None], 1e30)
        t2 = tt.min(dim=1).values
        ts.append(t1)
        prims.append(torch.where(t1 < 1e30, j1.to(torch.int32), -1))
        ties.append((t1 < 1e30) & (t2 <= t1 * (1 + T_RTOL)))
    return torch.cat(ts), torch.cat(prims), torch.cat(ties)


def _write_assets(root):
    """A small reference-format asset tree: a UV sphere as a glTF at the
    default model path, two GameObjects of it (rotation 0, so the JSON round
    trip is exact), point, directional and spot lights, and the camera."""
    import base64
    from physically_based_ray_tracer_tpu_torch.scene.camera import Camera
    from physically_based_ray_tracer_tpu_torch.scene.procedural import make_sphere
    from physically_based_ray_tracer_tpu_torch.scene.scene import Instance
    from physically_based_ray_tracer_tpu_torch.scene.serialization import (
        save_camera_json, save_gameobject_json, save_light_json)
    corners, normals, uvs, _ = make_sphere(radius=0.8, lat=32, lon=64)
    blobs = [np.ascontiguousarray(x, np.float32).tobytes() for x in (corners, normals, uvs)]
    offs = np.cumsum([0] + [len(b) for b in blobs])
    data = b"".join(blobs)
    n = corners.shape[0]
    doc = {"asset": {"version": "2.0"},
           "buffers": [{"uri": "data:application/octet-stream;base64,"
                               + base64.b64encode(data).decode(), "byteLength": len(data)}],
           "bufferViews": [{"buffer": 0, "byteOffset": int(offs[i]),
                            "byteLength": len(blobs[i])} for i in range(3)],
           "accessors": [{"bufferView": i, "componentType": 5126, "count": n, "type": t}
                         for i, t in enumerate(("VEC3", "VEC3", "VEC2"))],
           "materials": [{"pbrMetallicRoughness": {"baseColorFactor": [0.7, 0.5, 0.3, 1],
                                                   "metallicFactor": 0.3,
                                                   "roughnessFactor": 0.6}}],
           "meshes": [{"primitives": [{"attributes": {"POSITION": 0, "NORMAL": 1,
                                                      "TEXCOORD_0": 2}, "material": 0}]}]}
    model = os.path.join(root, "prefabs", "models", "SciFiHelmet", "SciFiHelmet.gltf")
    os.makedirs(os.path.dirname(model), exist_ok=True)
    with open(model, "w") as f:
        json.dump(doc, f)
    scene = os.path.join(root, "scene1")
    for sub in ("pointlights", "directionallights", "spotlights"):
        os.makedirs(os.path.join(scene, sub), exist_ok=True)
    save_gameobject_json(os.path.join(scene, "BallA.json"), Instance(0, position=(-0.9, 0, 0)))
    save_gameobject_json(os.path.join(scene, "BallB.json"), Instance(0, position=(0.9, 0.2, -0.5)))
    save_light_json(os.path.join(scene, "pointlights", "p0.json"), (2, 3, 2), (20, 20, 20))
    save_light_json(os.path.join(scene, "directionallights", "d0.json"), (5, 8, 3),
                    (1.5, 1.4, 1.2))
    save_light_json(os.path.join(scene, "spotlights", "s0.json"), (0, 4, 0), (8, 8, 8),
                    (0, -1, 0))
    save_camera_json(os.path.join(root, "prefabs", "camera.json"),
                     Camera.make((0.0, 1.0, 4.0), (0.0, 0.0, 0.0), device="cpu"))


def _dynamic_path(dev, card, cfg, engines, scene1, scene_w, sets):
    """Phase 12: the dynamic-scene path on the bench frame. Returns the
    phase's report (times, and each module's launches over the phase)."""
    import types
    import torch
    from physically_based_ray_tracer_tpu_torch.animate import orbit
    from physically_based_ray_tracer_tpu_torch.bvh.dense import _band_pairs, _leaf_records
    from physically_based_ray_tracer_tpu_torch.bvh.refit import refit_bvh, refit_dense
    from physically_based_ray_tracer_tpu_torch.ops import trace, trace_rows, wave_level
    from physically_based_ray_tracer_tpu_torch.render.debugger import format_trace, trace_pixel
    from physically_based_ray_tracer_tpu_torch.render.integrator import render_sample
    from physically_based_ray_tracer_tpu_torch.render.renderer import Renderer
    from physically_based_ray_tracer_tpu_torch.scene.loader import load_reference_scene
    from physically_based_ray_tracer_tpu_torch.scene.presets import build_bench_scene
    from physically_based_ray_tracer_tpu_torch.scene.scene import (Instance,
                                                                   build_scene_instanced,
                                                                   rebuild_scene, world_tris)
    from physically_based_ray_tracer_tpu_torch.scene.serialization import save_gameobject_json
    from physically_based_ray_tracer_tpu_torch.session import EditSession

    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "build")
    os.makedirs(out_dir, exist_ok=True)
    report = {}
    for c in engines:
        c.reset_counts()
    phase_counts = {}

    def add_counts():
        for c in engines:
            key = c.__name__.rsplit(".", 1)[1]
            acc = phase_counts.setdefault(key, {})
            for k, v in c.LAUNCHES.items():
                acc[k] = acc.get(k, 0) + v
            c.reset_counts()

    # (a) eight frames of the nine spheres on an orbit, the floor still:
    # rebuild_scene vs a from-scratch build of the same instances
    scene, cam, _, handle = build_bench_scene(flatten=False, return_handle=True, device=dev)
    _check(scene.dense.two_level and handle.tlas_meta is not None,
           "the dynamic path's bench scene is not two-level")
    models, lights = handle.models, scene.lights
    shared = {k: getattr(scene.dense, k) for k in SHARED_TABLES}
    r = Renderer(scene, cam, cfg, device=dev)
    refresh_ms, full_ms, frame_ms = [], [], []
    prev = prev_img = None
    for c in engines:
        c.reset_counts()
    for f in range(DYN_FRAMES):
        insts = orbit(2 * np.pi * f / DYN_FRAMES, n=9, radius=DYN_ORBIT) + [Instance(1)]
        t0 = time.perf_counter()
        new = rebuild_scene(r.scene, handle, insts, device=dev)
        torch.cuda.synchronize()
        refresh_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        fresh, _, _ = build_scene_instanced(models, insts, lights, legacy_bvh=False,
                                            flatten=False, device=dev)
        torch.cuda.synchronize()
        full_ms.append((time.perf_counter() - t0) * 1e3)
        differ = _differ(new, fresh)
        kept = [k for k, v in shared.items() if getattr(new.dense, k) is not v]
        r.scene = new
        r.reset_accumulation()
        t0 = time.perf_counter()
        img = r.tick(0)
        torch.cuda.synchronize()
        frame_ms.append((time.perf_counter() - t0) * 1e3)
        n_fresh = n_prev = moved = None
        if f in DYN_IMAGE_FRAMES:
            img_fresh = Renderer(fresh, cam, cfg, device=dev).tick(0)
            n_fresh = int((img != img_fresh).any(axis=-1).sum())
            n_prev = int((Renderer(prev, cam, cfg, device=dev).tick(0) != prev_img)
                         .any(axis=-1).sum())
        if prev is not None:
            moved = int((img != prev_img).any(axis=-1).sum())
        print(f"  frame {f}: rebuild_scene {refresh_ms[-1]:.2f} ms, build_scene_instanced "
              f"{full_ms[-1]:.2f} ms, tick {frame_ms[-1]:.2f} ms; stack need "
              f"{new.dense.stack_need}; tables differing from the fresh build {differ}; "
              f"BLAS-side tensors not shared {kept}; pixels differing from the fresh "
              f"build's frame {n_fresh}, the previous scene's frame rendered again vs its "
              f"own {n_prev}; pixels changed since the last frame {moved} [{card}]",
              flush=True)
        _check(not differ, f"frame {f}: refreshed tables differ from a fresh build: {differ}")
        _check(not kept, f"frame {f}: the refresh did not keep the BLAS-side tensors {kept}")
        _check(n_fresh in (None, 0),
               f"frame {f}: {n_fresh} pixels differ from the fresh build's frame")
        _check(n_prev in (None, 0), f"frame {f}: the previous scene renders differently now")
        _check(moved is None or moved > 0, f"frame {f}: nothing moved")
        _check(img.shape == (720, 1280, 3) and bool(np.isfinite(img).all()),
               f"frame {f}: image not finite or of the wrong shape")
        prev, prev_img = new, img
    counts = {c.__name__.rsplit(".", 1)[1]: (dict(c.LAUNCHES), dict(c.PLAIN_CALLS))
              for c in engines}
    plain = sum(sum(v[1].values()) for v in counts.values())
    print(f"animate ({DYN_FRAMES} frames, one tick each, two more on frames "
          f"{DYN_IMAGE_FRAMES}): launches "
          f"{json.dumps({k: v[0] for k, v in counts.items()})}, plain-version calls {plain}",
          flush=True)
    _check(counts["trace_bf16"][0]["closest"] > 0 and counts["trace_bf16"][0]["any"] > 0,
           "the animate frames did not launch both B2 modes")
    _check(plain == 0, "the animate frames called a plain version")
    add_counts()
    # the same motion with the classic BVH (legacy_bvh=True): rebuild_scene
    # rebuilds the wave engine's tree on the host every frame; a wave-engine
    # frame on it equals the fresh build's
    scene_l, _, _, handle_l = build_bench_scene(flatten=False, legacy_bvh=True,
                                                return_handle=True, device=dev)
    cfg_w = cfg.replace(traversal="wave")
    r_w = Renderer(scene_l, cam, cfg_w, device=dev)
    legacy_ms = []
    for f in range(2):
        insts = orbit(2 * np.pi * f / DYN_FRAMES, n=9, radius=DYN_ORBIT) + [Instance(1)]
        t0 = time.perf_counter()
        r_w.scene = rebuild_scene(r_w.scene, handle_l, insts, device=dev)
        torch.cuda.synchronize()
        legacy_ms.append((time.perf_counter() - t0) * 1e3)
        fresh_l, _, _ = build_scene_instanced(models, insts, lights, legacy_bvh=True,
                                              flatten=False, device=dev)
        differ = _differ(r_w.scene, fresh_l)
        _check(not differ, f"legacy_bvh frame {f}: tables differ from a fresh build: {differ}")
        # the classic tree is rebuilt from v0 + e1, v0 + e2 summed in f32 (as
        # the JAX package rebuilds it), not from the model's corners, so its
        # boxes may differ from a fresh build's by an ulp: printed
        a, b = r_w.scene.bvh, fresh_l.bvh
        same_shape = a.nodes_box.shape == b.nodes_box.shape
        print(f"  legacy_bvh frame {f}: classic tree {a.n_nodes} nodes (fresh build "
              f"{b.n_nodes}); topology equal "
              f"{same_shape and torch.equal(a.nodes_child, b.nodes_child)}, max box "
              f"difference {float((a.nodes_box - b.nodes_box).abs().max()) if same_shape else None}",
              flush=True)
    r_w.reset_accumulation()
    img_w = r_w.tick(0)
    img_wf = Renderer(fresh_l, cam, cfg_w, device=dev).tick(0)
    n_w = int((img_w != img_wf).any(axis=-1).sum())
    close = np.isclose(img_w, img_wf, rtol=2e-4, atol=2e-5).all(axis=-1)
    print(f"legacy_bvh=True: rebuild_scene (classic tree rebuilt on the host) {legacy_ms} ms; "
          f"wave frame {r_w.stats.frame_ms:.2f} ms, {n_w} pixels not bit-equal to the fresh "
          f"build's wave frame, {close.mean() * 100:.4f}% allclose [{card}]", flush=True)
    _check(close.mean() >= WAVE_FRAME_CLOSE,
           "legacy_bvh: the wave frame differs from the fresh build's")
    report["legacy_rebuild_ms"] = legacy_ms
    med = {k: statistics.median(v) for k, v in
           (("rebuild_scene_ms", refresh_ms), ("build_scene_instanced_ms", full_ms),
            ("frame_ms", frame_ms))}
    report.update(med, refresh_ms=refresh_ms, full_ms=full_ms, frame_ms_list=frame_ms)
    print(f"dynamic-scene path, bench frame 1280x720 4 bounces AA bf16, two-level, "
          f"{DYN_FRAMES} frames: rebuild_scene median {med['rebuild_scene_ms']:.3f} ms "
          f"{refresh_ms}; from-scratch build_scene_instanced median "
          f"{med['build_scene_instanced_ms']:.3f} ms {full_ms}; frame (tick) median "
          f"{med['frame_ms']:.3f} ms {frame_ms} [{card}]", flush=True)

    # (b) B1, B2, B3 vs their plain versions on frame 7's refreshed tables
    dbvh = r.scene.dense
    rsets = _ray_sets(r.scene, cam, cfg, dev, seed=7)
    rep = []
    for sname in ("primary", "bounce"):
        o, d, tm = rsets[sname]
        ref = _plain_ref(dbvh, o, d, tm)
        h1 = trace.sorted_closest_dense(dbvh, o, d, tm)
        occ1 = trace.sorted_any_dense(dbvh, o, d, tm)
        _compare_exact("B1", f"refreshed/{sname}", h1, occ1, ref, rep)
        h3 = trace_rows.sorted_rows_closest(dbvh, o, d, tm)
        occ3 = trace_rows.sorted_rows_any(dbvh, o, d, tm)
        _compare_exact("B3", f"refreshed/{sname}", h3, occ3, ref, rep)
        _rows_vs_f32(f"refreshed/{sname}", h3, occ3, h1, occ1)
        _compare_bf16(f"refreshed/{sname}", dbvh, o, d, tm, rep)
    add_counts()

    # (c) refit: the flattened bench table and the classic tree, every
    # vertex moved by a smooth seeded field (shared corners move together)
    tri = world_tris(scene1.tri_v0, scene1.tri_e1, scene1.tri_e2)
    _check(np.array_equal(tri, world_tris(scene_w.tri_v0, scene_w.tri_e1, scene_w.tri_e2)),
           "flattened and classic scenes differ")
    gen = np.random.default_rng(12)
    w, ph = gen.normal(size=(3, 3)) * 2.0, gen.uniform(0, 2 * np.pi, 3)
    pts = tri.reshape(-1, 3).astype(np.float64)
    tri2 = (pts + REFIT_AMP * np.sin(pts @ w + ph)).astype(np.float32).reshape(tri.shape)
    t0 = time.perf_counter()
    re = refit_dense(scene1.dense, tri2)
    torch.cuda.synchronize()
    refit_ms = (time.perf_counter() - t0) * 1e3
    bits = lambda x: x.view(torch.int16)
    derived = dict(
        leaf_rec_rebuilt=bool(torch.equal(re.leaf_rec, _leaf_records(re.groups))),
        groups_bf2_rebuilt=bool(torch.equal(bits(re.groups_bf2),
                                            bits(_band_pairs(re.groups_bf)))),
        leaf_rec_changed=not torch.equal(re.leaf_rec, scene1.dense.leaf_rec),
        groups_bf2_changed=not torch.equal(bits(re.groups_bf2), bits(scene1.dense.groups_bf2)))
    print(f"refit_dense ({scene1.n_prims} triangles moved by up to {REFIT_AMP}): "
          f"{refit_ms:.2f} ms, stack need {re.stack_need}; derived tables {derived} [{card}]",
          flush=True)
    _check(all(derived.values()), f"the refit's derived tables are stale: {derived}")
    for sname in ("primary", "bounce"):
        o, d, tm = sets[sname]
        ref = _plain_ref(re, o, d, tm)
        h1 = trace.sorted_closest_dense(re, o, d, tm)
        occ1 = trace.sorted_any_dense(re, o, d, tm)
        _compare_exact("B1", f"refit/{sname}", h1, occ1, ref, rep)
        _compare_bf16(f"refit/{sname}", re, o, d, tm, rep)
        if sname == "primary":
            t_b, p_b, tie = _brute_closest(o, d, tri2)
            f1, fb = h1.prim >= 0, p_b >= 0
            both = f1 & fb
            r_b = dict(found=int(fb.sum()), found_mismatch=int((f1 != fb).sum()),
                       t_max_rel=float(((h1.t - t_b).abs() / t_b.abs())[both].max()),
                       prim_mismatch=int(((h1.prim != p_b) & both & ~tie).sum()),
                       ties=int(tie.sum()))
            print(f"  B1 vs brute force over the deformed triangles, primary: "
                  f"{json.dumps(r_b)}", flush=True)
            _check(r_b["found"] > N_RAYS // 4 and r_b["found_mismatch"] == 0
                   and r_b["t_max_rel"] <= T_RTOL and r_b["prim_mismatch"] == 0,
                   "B1 on the refit table differs from brute force")
    t0 = time.perf_counter()
    bvh2 = refit_bvh(scene_w.bvh, tri2)
    torch.cuda.synchronize()
    refit_bvh_ms = (time.perf_counter() - t0) * 1e3
    o, d, tm = (x[:WAVE_RAYS] for x in sets["bounce"])
    for mode in ("closest", "any"):
        with _LevelCheck(mode, per_wave=False) as lv:
            _wave_calls(bvh2, o, d, tm, mode)
        torch.cuda.synchronize()
        print(f"  fused level vs plain_run_level on the refit classic BVH, bounce {mode}, "
              f"every level: {json.dumps(lv.r)}", flush=True)
        _check(lv.r["levels"] > 0 and lv.r["level_mismatch"] == 0
               and lv.r["level_wave_mismatch"] == 0,
               f"refit classic BVH, {mode}: the fused level differs from plain_run_level")
    add_counts()      # _wave_vs_b1 resets the wave engine's counts per call
    fused = _wave_vs_b1(types.SimpleNamespace(bvh=bvh2), re,
                        {k: sets[k] for k in ("primary", "bounce")}, card)
    for mode, n in fused.items():
        phase_counts["wave_level"][mode] += n
    wave_level.reset_counts()     # the last call's launches are in ``fused``
    print(f"refit_bvh ({scene_w.bvh.n_nodes} nodes): {refit_bvh_ms:.2f} ms [{card}]",
          flush=True)
    report.update(refit_dense_ms=refit_ms, refit_bvh_ms=refit_bvh_ms)
    add_counts()

    # (d) the edit session, the command line's last three flags, the debugger
    assets = os.path.join(out_dir, "smoke_assets")
    shutil.rmtree(assets, ignore_errors=True)
    _write_assets(assets)
    t0 = time.perf_counter()
    sess = EditSession(assets, cfg=cfg, device=dev)
    sess.edit_object("BallA", position=(0.6, 0.1, -0.2))
    sess.render()
    cap = sess.capture(os.path.join(out_dir, "smoke_session.png"))
    ball_b = os.path.join(assets, "scene1", "BallB.json")
    save_gameobject_json(ball_b, Instance(0, position=(-0.3, 0.4, 0.6)))
    t_m = os.path.getmtime(ball_b) + 2
    os.utime(ball_b, (t_m, t_m))
    changed = sess.watch_once()
    img_s = sess.render()
    scene_f, cam_f, _ = load_reference_scene(assets, device=dev)
    img_f = Renderer(scene_f, cam_f, cfg, device=dev).tick(0)
    differ = _differ(sess.renderer.scene, scene_f)
    n_px = int((img_s != img_f).any(axis=-1).sum())
    print(f"EditSession 1280x720: edit_object, render, capture ({os.path.getsize(cap)} bytes), "
          f"watch_once changed {[os.path.relpath(p, assets) for p in changed]}; tables "
          f"differing from a fresh load_reference_scene {differ}, pixels differing from its "
          f"frame {n_px} ({time.perf_counter() - t0:.1f} s) [{card}]", flush=True)
    _check(ball_b in changed and not differ and n_px == 0,
           "the session's scene or frame differs from a fresh load of the edited tree")
    add_counts()

    procs = {}
    tools = {
        "session": (["--session", "--assets", assets, "--width", "1280", "--height", "720"],
                    f"move BallA 0.2 0.0 0.1\nrender\ncapture "
                    f"{os.path.join(out_dir, 'smoke_cli_session.png')}\nquit\n"),
        "debug-pixel": (["--demo", "cornell", "--debug-pixel", "640", "360"], None),
        "draw-bvh": (["--demo", "cornell", "--draw-bvh", "3", "--spp", "1", "--out",
                      os.path.join(out_dir, "smoke_cli_bvh.png")], None)}
    t0 = time.perf_counter()
    for name, (args, _) in tools.items():
        procs[name] = subprocess.Popen([sys.executable, "-m", f"{PKG}.cli", *args], cwd=root,
                                       stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                                       stderr=subprocess.PIPE, text=True)
    for name, (args, stdin) in tools.items():
        out, err = procs[name].communicate(stdin, timeout=600)
        rc = procs[name].returncode
        tail = "\n".join(out.strip().splitlines()[:24])
        print(f"cli {name} (exit {rc}, {time.perf_counter() - t0:.1f} s since the start):\n"
              f"{err.strip()}\n{tail} [{card}]", flush=True)
        _check(rc == 0, f"the command line's {name} failed")
        want = {"session": "wrote", "debug-pixel": "final radiance",
                "draw-bvh": "overlay"}[name]
        _check(want in out and "error:" not in err, f"the command line's {name}: no result")

    # the brightest pixel of frame 7 (a lit sphere), traced without AA
    cfg_np = cfg.replace(antialias=False)
    y, x = np.unravel_index(int(np.argmax(prev_img.sum(axis=-1))), prev_img.shape[:2])
    recs = trace_pixel(r.scene, cam, cfg_np, int(x), int(y), device=dev)
    ids = torch.tensor([y * cfg.width + x], dtype=torch.int32, device=dev)
    col, _ = render_sample(r.scene, cam, cfg_np, 0, 0, ids)
    want = col.cpu().numpy()[0]
    print(f"trace_pixel ({x}, {y}) on frame 7's tables:\n{format_trace(recs)}\n"
          f"render_sample of pixel {int(ids[0])}: {want.tolist()}", flush=True)
    _check(np.array_equal(recs[-1]["radiance"], want) and want.sum() > 0,
           "trace_pixel's radiance differs from render_sample's (or is black)")
    add_counts()
    report["launches"] = phase_counts
    print(f"dynamic-scene path launches (phase total): {json.dumps(phase_counts)}", flush=True)
    _check(phase_counts["trace"]["closest"] > 0 and phase_counts["trace"]["any"] > 0
           and phase_counts["trace_rows"]["closest"] > 0
           and phase_counts["wave_level"]["closest"] > 0
           and phase_counts["wave_level"]["any"] > 0,
           "the dynamic path did not launch B1, B3 and the fused level")
    return report


def _grad_groups(params) -> dict:
    """{group name: gradient} of a parameter dict (instance_trs by member);
    a leaf without a gradient counts as zeros."""
    import torch
    from physically_based_ray_tracer_tpu_torch.diff.grad import param_items
    return {"/".join(p): (v.grad.detach().clone() if v.grad is not None
                          else torch.zeros_like(v))
            for p, v in param_items(params) if v.requires_grad}


def _bench_grad_problem(dev, cfg):
    """The bench frame's gradient problem: (scene, camera, target, start,
    chunk). The target is the frame at the scene's own parameters (key 0,
    sample 0); the start perturbs every group but the area lights' (the
    bench scene has none): albedo, roughness, metalness, emission, point and
    directional light colours, the TRS of the 10 instances and the camera's
    position and target. ``chunk`` is render_chunked's chunk size."""
    import torch
    from physically_based_ray_tracer_tpu_torch.diff.grad import (apply_params,
                                                                 clone_params,
                                                                 render_color,
                                                                 trs_params_from_instances)
    from physically_based_ray_tracer_tpu_torch.scene.presets import build_bench_scene
    scene, cam, _, handle = build_bench_scene(flatten="auto", return_handle=True, device=dev)
    n_chunks = -(-cfg.n_pixels // cfg.chunk_pixels)
    chunk = -(-cfg.n_pixels // n_chunks)
    trs = trs_params_from_instances(handle.instances, device=dev)
    true = {"base_color": scene.mat_base, "roughness": scene.mat_rough,
            "metalness": scene.mat_metal, "emissive": scene.mat_emissive,
            "point_color": scene.lights.point_color, "dir_color": scene.lights.dir_color,
            "instance_trs": trs, "camera_pos": cam.pos, "camera_target": cam.target}
    with torch.no_grad():
        s, c = apply_params(scene, cam, true)
        ids = torch.arange(cfg.n_pixels, dtype=torch.int32, device=dev)
        target = torch.cat([render_color(s, c, cfg, 0, 0, ids[i:i + chunk])
                            for i in range(0, cfg.n_pixels, chunk)])
    shift = lambda v, dx: v + torch.tensor(dx, dtype=torch.float32, device=dev)
    wrong = clone_params({
        "base_color": torch.clamp(scene.mat_base * 0.8 + 0.1, 0.0, 1.0),
        "roughness": torch.clamp(scene.mat_rough + 0.1, 0.05, 1.0),
        "metalness": torch.clamp(scene.mat_metal + 0.05, 0.0, 1.0),
        "emissive": scene.mat_emissive + 0.02,
        "point_color": scene.lights.point_color * 0.8,
        "dir_color": scene.lights.dir_color * 1.2,
        "instance_trs": {"position": trs["position"] + 0.01,
                         "rotation": trs["rotation"] + 0.01,
                         "scale": trs["scale"] * 1.005, "base_inv": trs["base_inv"]},
        "camera_pos": shift(cam.pos, [0.02, 0.01, 0.0]),
        "camera_target": shift(cam.target, [0.01, 0.0, 0.0])})
    return scene, cam, target, wrong, chunk


def _frame_grad(scene, cam, cfg, params, target, chunk):
    """The L2 loss over every pixel of the frame and its gradient, chunk by
    chunk: each chunk's loss is its squared error summed over the frame's
    element count, so the summed gradients are the whole frame's mean. Each
    chunk's backward runs before the next chunk's forward. Returns (grads,
    loss, forward ms, backward ms), each phase ending in a device sync."""
    import torch
    from physically_based_ray_tracer_tpu_torch.diff.grad import (apply_params, render_color,
                                                                 trainable)
    n = cfg.n_pixels
    ids_all = torch.arange(n, dtype=torch.int32, device=target.device)
    for v in trainable(params):
        v.grad = None
    fwd = bwd = 0.0
    total = 0.0
    for c0 in range(0, n, chunk):
        ids = ids_all[c0:c0 + chunk]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s, c = apply_params(scene, cam, params)
        color = render_color(s, c, cfg, 0, 0, ids)
        loss = torch.sum((color - target[c0:c0 + chunk]) ** 2) / (3 * n)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if loss.requires_grad:        # else no lane of the chunk hit anything
            loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        fwd += t1 - t0
        bwd += t2 - t1
        total += float(loss.detach())
    return _grad_groups(params), total, fwd * 1e3, bwd * 1e3


def _rel(a, b) -> float:
    """||a - b|| / ||b||."""
    return float((a - b).norm() / b.norm().clamp(min=1e-30))


def _fd_grad_sphere(dev):
    """tests/test_grad.py's scene and config on ``dev``: (scene, camera,
    render_mean(params))."""
    import torch
    from physically_based_ray_tracer_tpu_torch import RenderConfig
    from physically_based_ray_tracer_tpu_torch.diff.grad import apply_params, render_color
    from physically_based_ray_tracer_tpu_torch.scene.camera import Camera
    from physically_based_ray_tracer_tpu_torch.scene.lights import LightSet
    from physically_based_ray_tracer_tpu_torch.scene.procedural import make_sphere
    from physically_based_ray_tracer_tpu_torch.scene.scene import Instance, MeshModel, build_scene
    cfg = RenderConfig(width=12, height=12, bounces=1, antialias=False, skybox=False,
                       max_stack_depth=24, gamma_corrected=False, leaf_precision="f32")
    sphere = MeshModel.from_fat(make_sphere(radius=1.0, lat=10, lon=12),
                                base_color=(0.8, 0.3, 0.2), roughness=0.5)
    lights = LightSet.make(point_pos=[[2, 3, 2]], point_color=[[15, 15, 15]],
                           device=dev).pad_points(4)
    scene, _ = build_scene([sphere], [Instance(0)], lights, device=dev)
    cam = Camera.make(pos=(0, 0.5, 3.5), target=(0, 0, 0), device=dev)
    ids = torch.arange(cfg.n_pixels, dtype=torch.int32, device=dev)

    def render_mean(params):
        s, c = apply_params(scene, cam, params)
        return torch.mean(render_color(s, c, cfg, 0, 0, ids))

    return scene, cam, render_mean


def _fd_checks(dev):
    """tests/test_grad.py's finite-difference checks on the card (B1, the
    f32 engine), at the test's scene, sizes and tolerances. Returns
    {check: largest |analytic - FD| over the compared elements}."""
    import torch
    from physically_based_ray_tracer_tpu_torch.diff.grad import (apply_params,
                                                                 grad_check_fd,
                                                                 trs_params_from_instances)
    from physically_based_ray_tracer_tpu_torch.scene.scene import Instance
    scene, cam, render_mean = _fd_grad_sphere(dev)
    out = {}

    def value(f, x):
        with torch.no_grad():
            return float(f(torch.tensor(x, dtype=torch.float32, device=dev)))

    def grad(f, x):
        xg = x.detach().clone().requires_grad_(True)
        return torch.autograd.grad(f(xg), xg)[0].cpu().numpy().astype(np.float64)

    # _fd_check: every element, compared where either side exceeds 1e-7
    for name, group, x0, eps, rtol in (
            ("albedo", "base_color", scene.mat_base, 1e-2, 0.08),
            ("roughness", "roughness", scene.mat_rough, 1e-2, 0.15),
            ("light intensity", "point_color", scene.lights.point_color, 1e-1, 0.08),
            ("emissive", "emissive", scene.mat_emissive + 0.5, 1e-2, 0.08)):
        g, fd, _ = grad_check_fd(lambda x: render_mean({group: x}), x0, eps=eps)
        mask = (np.abs(g) > 1e-7) | (np.abs(fd) > 1e-7)
        _check(mask.any(), f"FD {name}: gradient identically zero")
        np.testing.assert_allclose(g[mask], fd[mask], rtol=rtol, atol=1e-5,
                                   err_msg=f"FD {name} on the card")
        out[name] = float(np.abs(g[mask] - fd[mask]).max())
    # the TRS bake, at the bake level (rtol 2e-2, atol 5e-2)
    trs0 = trs_params_from_instances(
        [Instance(0, position=(0.2, -0.1, 0.3), rotation=(0.3, 0.5, -0.2),
                  scale=(1.2, 0.8, 1.1))], device=dev)
    rng = np.random.RandomState(0)
    w_v0 = torch.tensor(rng.randn(*scene.tri_v0.shape), dtype=torch.float32, device=dev)
    w_fn = torch.tensor(rng.randn(*scene.face_normal.shape), dtype=torch.float32, device=dev)
    names = ("position", "rotation", "scale")
    for a, name in enumerate(names):
        def f(x, a=a):
            g = {**trs0, names[a]: x}
            s, _ = apply_params(scene, cam, {"instance_trs": g})
            return (torch.sum(w_v0 * s.tri_v0) + torch.sum(w_fn * s.face_normal)
                    + torch.sum(s.tri_e1) + torch.sum(s.tri_e2))
        g, fd, _ = grad_check_fd(f, trs0[name], eps=1e-3)
        np.testing.assert_allclose(g, fd, rtol=2e-2, atol=5e-2,
                                   err_msg=f"FD TRS bake {name} on the card")
        out[f"TRS bake {name}"] = float(np.abs(g - fd).max())
    # rotation about an offset pivot: finite; where FD is smooth and live,
    # nonzero, sign-consistent and within its scale
    trs1 = trs_params_from_instances([Instance(0, position=(0.35, 0.1, 0.0))], device=dev)
    f = lambda rot: render_mean({"instance_trs": {**trs1, "rotation": rot}})
    g = grad(f, trs1["rotation"])[0]
    x = trs1["rotation"].cpu().numpy().astype(np.float64)

    def fd_at(eps):
        fd = np.zeros(3)
        for i in range(3):
            d = np.zeros_like(x)
            d[0, i] = eps
            fd[i] = (value(f, x + d) - value(f, x - d)) / (2 * eps)
        return fd

    fd1, fd2 = fd_at(5e-3), fd_at(2.5e-3)
    _check(np.isfinite(g).all(), "FD rotation: gradient not finite")
    smooth = np.abs(fd1 - fd2) < 0.5 * np.maximum(np.abs(fd1), np.abs(fd2)) + 1e-4
    mask = smooth & (np.abs(fd1) > 5e-4)
    _check(smooth.any(), "FD rotation: every component straddles a visibility flip")
    if mask.any():
        _check((np.abs(g[mask]) > 1e-5).any(), "FD rotation: gradient dead where FD is live")
        _check(((np.sign(g[mask]) == np.sign(fd1[mask])) | (np.abs(g[mask]) < 1e-4)).all(),
               f"FD rotation: gradient fights FD: {g[mask]} {fd1[mask]}")
        _check((np.abs(g[mask]) <= np.abs(fd1[mask]) * 2.5 + 3e-3).all(),
               f"FD rotation: gradient exceeds FD scale: {g[mask]} {fd1[mask]}")
    out["rotation (components compared)"] = int(mask.sum())
    # the look-at chain: camera position and target (rtol 0.4, atol 3e-3
    # where |FD| > 1e-3)
    for group, x0 in (("camera_pos", cam.pos), ("camera_target", cam.target)):
        f = lambda x, group=group: render_mean({group: x})
        g = grad(f, x0)
        _check(np.isfinite(g).all(), f"FD {group}: gradient not finite")
        xn = x0.cpu().numpy().astype(np.float64)
        fd = np.zeros(3)
        for i in range(3):
            d = np.zeros_like(xn)
            d[i] = 2e-3
            fd[i] = (value(f, xn + d) - value(f, xn - d)) / 4e-3
        mask = np.abs(fd) > 1e-3
        if mask.any():
            np.testing.assert_allclose(g[mask], fd[mask], rtol=0.4, atol=3e-3,
                                       err_msg=f"FD {group} on the card")
        out[group] = float(np.abs(g[mask] - fd[mask]).max()) if mask.any() else 0.0
    return out


def _step_pixels(cfg, target, seed, n):
    """The inverse cell's draw of one step: ``n`` of the frame's pixels
    without replacement from ``seed`` (int32 ids) and their target colours."""
    import torch
    gen = torch.Generator(device=target.device)
    gen.manual_seed(seed)
    ids = torch.randperm(cfg.n_pixels, generator=gen, device=target.device)[:n]
    return ids.to(torch.int32), target[ids]


def _gather_step(scene, cam, cfg, start, ids, tgt, key, record=False):
    """One forward and backward of the inverse cell's loss (the mean squared
    error over ``ids``) from a fresh copy of ``start``: (loss, {leaf: grad},
    calls). Where ``record``, ``calls`` holds every call of the row gather's
    backward (``ops/take_rows.py::segment_sum``) as (cotangent, indices,
    table rows); else it is empty."""
    import torch
    from physically_based_ray_tracer_tpu_torch.diff import grad as dgrad
    from physically_based_ray_tracer_tpu_torch.ops import take_rows as tr

    calls = []
    segment_sum = tr.segment_sum

    def recording(grad, idx, n_rows):
        calls.append((grad.detach().clone(), idx.clone(), n_rows))
        return segment_sum(grad, idx, n_rows)

    if record:
        tr.segment_sum = recording          # _TakeRows.backward finds it by name
    try:
        params = dgrad.clone_params(start)
        s, c = dgrad.apply_params(scene, cam, params)
        loss = torch.mean((dgrad.render_color(s, c, cfg, key, 0, ids) - tgt) ** 2)
        loss.backward()
    finally:
        tr.segment_sum = segment_sum
    grads = {".".join(p): v.grad.clone() for p, v in dgrad.param_items(params)
             if v.grad is not None}
    return loss.detach(), grads, calls


def _take_rows_gate(scene, cam, cfg, target, start, card):
    """Phase 13f: every call of the row gather's backward in one backward of
    the inverse cell's step (``STEP_PIXELS`` pixels drawn from
    ``STEP_SEED``), one kernel launch each; per call the kernel twice on the
    same cotangent (bit-equal) against the plain version in float64 on the
    CPU, element by element within float32's reordering bound (the tests'
    bound: an element's sum is a tree of additions at most TILE + tiles + 1
    deep, so its error is at most that times 2**-24 times the sum of its
    terms' magnitudes). The heaviest call is timed with the card queued
    ahead (no wrapper host time): the kernel's two passes with the table's
    zeroing, the call with its sort, the plain version (``index_add_``) and
    PyTorch's own ``index_put_(accumulate=True)`` on the card, beside its
    byte bound. Returns the kernels line's entry."""
    import torch
    from physically_based_ray_tracer_tpu_torch.ops import _build
    from physically_based_ray_tracer_tpu_torch.ops import take_rows as tr

    ids, tgt = _step_pixels(cfg, target, STEP_SEED, STEP_PIXELS)
    launches = tr.LAUNCHES
    _, _, calls = _gather_step(scene, cam, cfg, start, ids, tgt, STEP_SEED, record=True)
    torch.cuda.synchronize()
    n_launch = tr.LAUNCHES - launches
    print(f"inverse step ({STEP_PIXELS} pixels, f32 engine): {len(calls)} take_rows "
          f"backward calls, {n_launch} kernel launches", flush=True)
    _check(len(calls) > 0 and n_launch == len(calls),
           "the inverse step's row gathers did not launch one take_rows kernel a call")
    tile = _build.load("take_rows").pbrt_take_rows_tile()
    max_abs, worst = 0.0, 0.0
    for grad, idx, rows in calls:
        n, c = grad.shape
        a = tr.segment_sum(grad, idx, rows)
        b = tr.segment_sum(grad, idx, rows)
        g64, i64 = grad.double().cpu(), idx.long().cpu()
        want = tr.plain_segment_sum(g64, i64, rows)
        bound = ((tile + -(-n // tile) + 1) * 2.0 ** -24
                 * tr.plain_segment_sum(g64.abs(), i64, rows))
        err = (a.cpu().double() - want).abs()
        over = float((err - bound).max())
        ratio = float((err / bound.clamp_min(1e-300)).max())
        max_abs, worst = max(max_abs, float(err.max())), max(worst, ratio)
        print(f"  take_rows {n} x {c} from {rows}: largest |kernel - float64| "
              f"{float(err.max()):.3e}, largest error / bound {ratio:.3e}", flush=True)
        _check(torch.equal(a, b), f"take_rows {n} x {c}: two calls differ")
        _check(over <= 0.0, f"take_rows {n} x {c} from {rows}: {over:.3e} past float32's "
               "reordering bound of the float64 sum")
    grad, idx, rows = max(calls, key=lambda t: t[0].numel())
    n, c = grad.shape
    keys, perm = torch.sort(idx.to(torch.int32), stable=True)
    ms = [_time_ms(fn, runs=20, ahead=True) for fn in (
        lambda: tr.reduce_sorted(grad, keys, perm, rows),
        lambda: tr.segment_sum(grad, idx, rows),
        lambda: tr.plain_segment_sum(grad, idx.long(), rows),
        lambda: torch.zeros((rows, c), device=grad.device).index_put_(
            (idx.long(),), grad, accumulate=True))]
    nbytes = n * c * 4 + n * (4 + 8) + rows * c * 4      # cotangent, keys, perm, table
    bound_ms = nbytes / PEAK_BYTES * 1e3
    print(f"take_rows {n} x {c} from {rows}: kernel {ms[0]:.4f} ms (with the sort "
          f"{ms[1]:.4f}), plain {ms[2]:.4f}, index_put_ {ms[3]:.4f}; bound {bound_ms:.5f} ms "
          f"({bound_ms / ms[0] * 100:.2f}%) [{card}]", flush=True)
    return {"shape": [n, c, rows], "step_launches": n_launch, "max_abs_err": max_abs,
            "err_over_bound": worst, "ms": ms[0], "call_ms": ms[1], "plain_ms": ms[2],
            "library_ms": ms[3], "bound_ms": bound_ms, "bound_by": "bytes"}


def _diff_path(dev, card, cfg, engines):
    """Phase 13: the differentiable path. Returns the phase's report (times,
    memory, and each module's launches over the phase)."""
    import torch
    from physically_based_ray_tracer_tpu_torch import inverse_material
    from physically_based_ray_tracer_tpu_torch.diff.checkpoint import (load_checkpoint,
                                                                       save_checkpoint)
    from physically_based_ray_tracer_tpu_torch.diff.grad import (adam, apply_params,
                                                                 clone_params, map_params,
                                                                 render_color, trainable)
    from physically_based_ray_tracer_tpu_torch.diff.inverse import make_train_step
    from physically_based_ray_tracer_tpu_torch.ops import take_rows

    root = os.path.dirname(os.path.abspath(__file__))
    report = {}
    phase_counts = {}
    for c in engines:
        c.reset_counts()

    def add_counts():
        for c in engines:
            acc = phase_counts.setdefault(c.__name__.rsplit(".", 1)[1], {})
            for k, v in c.LAUNCHES.items():
                acc[k] = acc.get(k, 0) + v
            c.reset_counts()

    # (a) the bench frame's gradient at full width, chunked as render_chunked
    scene, cam, target, wrong, chunk = _bench_grad_problem(dev, cfg)
    n_chunks = -(-cfg.n_pixels // chunk)
    add_counts()
    gathers = take_rows.LAUNCHES
    runs = []
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(3):                 # one warm-up and 2 timed
        runs.append(_frame_grad(scene, cam, cfg, wrong, target, chunk))
    peak = torch.cuda.max_memory_allocated(dev)
    counts = {c.__name__.rsplit(".", 1)[1]: (dict(c.LAUNCHES), dict(c.PLAIN_CALLS))
              for c in engines}
    plain = sum(sum(v[1].values()) for v in counts.values())
    add_counts()
    g16, loss16 = runs[2][0], runs[2][1]
    fwd = [r[2] for r in runs[1:]]
    bwd = [r[3] for r in runs[1:]]
    print(f"frame gradient 1280x720 4 bounces AA bf16, {n_chunks} chunks of {chunk} "
          f"pixels: loss {loss16:.6e}; forward {fwd[0]:.2f} / {fwd[1]:.2f} ms, backward "
          f"{bwd[0]:.2f} / {bwd[1]:.2f} ms (warm-up {runs[0][2]:.2f} + {runs[0][3]:.2f} ms); "
          f"peak memory {peak / 2**30:.3f} GiB [{card}]", flush=True)
    print("frame gradient, timed run 2 vs run 1, ||g2 - g1|| / ||g1|| per group: "
          + json.dumps({k: float(f"{_rel(g16[k], runs[1][0][k]):.3e}") for k in g16}),
          flush=True)
    print(f"frame gradient (3 runs): B2 launches {counts['trace_bf16'][0]}, B1 launches "
          f"{counts['trace'][0]} (retests), plain-version calls {plain}", flush=True)
    _check(counts["trace_bf16"][0]["closest"] > 0 and counts["trace_bf16"][0]["any"] > 0,
           "the gradient's bf16 frame did not launch both B2 modes")
    _check(counts["trace"][0]["any"] > 0, "the gradient's bf16 frame launched no B1 retest")
    _check(plain == 0, "the gradient's frame called a plain version")
    print(f"frame gradient (3 runs): take_rows kernel launches {take_rows.LAUNCHES - gathers}",
          flush=True)
    _check(take_rows.LAUNCHES > gathers, "the gradient's frame launched no take_rows kernel")
    for k, g in g16.items():
        print(f"  grad {k}: norm {float(g.norm()):.6e}, finite {bool(torch.isfinite(g).all())}",
              flush=True)
        _check(bool(torch.isfinite(g).all()) and float(g.norm()) > 0,
               f"frame gradient of {k} not finite or zero")
    report.update(grad_forward_ms=fwd, grad_backward_ms=bwd, grad_peak_bytes=peak)
    cfg32 = cfg.replace(leaf_precision="f32")
    torch.cuda.reset_peak_memory_stats(dev)
    g32, loss32, f32_fwd, f32_bwd = _frame_grad(scene, cam, cfg32, wrong, target, chunk)
    peak32 = torch.cuda.max_memory_allocated(dev)
    counts32 = {c.__name__.rsplit(".", 1)[1]: dict(c.LAUNCHES) for c in engines}
    add_counts()
    _check(counts32["trace"]["closest"] > 0 and sum(counts32["trace_bf16"].values()) == 0,
           "the f32 gradient frame did not run on B1 alone")
    print(f"frame gradient f32: loss {loss32:.6e}; forward {f32_fwd:.2f} ms, backward "
          f"{f32_bwd:.2f} ms, peak memory {peak32 / 2**30:.3f} GiB [{card}]", flush=True)
    print("bf16 vs f32 frame gradient, ||g16 - g32|| / ||g32|| per group (printed, not "
          "gated): " + json.dumps({k: round(_rel(g16[k], g32[k]), 6) for k in g16}),
          flush=True)

    # (b) the card vs the CPU on 1,024 pixels drawn over the frame, f32 engine
    ids = torch.from_numpy(_frame_pixels(cfg, DIFF_PIXELS, np.random.default_rng(1))).to(dev)

    def pixel_grad(sc, cm, params, ids_, tgt):
        for v in trainable(params):
            v.grad = None
        s, c = apply_params(sc, cm, params)
        torch.mean((render_color(s, c, cfg32, 0, 0, ids_) - tgt) ** 2).backward()
        return _grad_groups(params)

    g_card = pixel_grad(scene, cam, wrong, ids, target[ids.long()])
    add_counts()
    t0 = time.perf_counter()
    g_cpu = pixel_grad(scene.to("cpu"), cam.to("cpu"),
                       clone_params(map_params(wrong, lambda k, x: x.detach().cpu())),
                       ids.cpu(), target[ids.long()].cpu())
    rel = {k: _rel(g_card[k].cpu(), g_cpu[k]) for k in g_cpu}
    print(f"{DIFF_PIXELS}-pixel gradient, f32 engine, card (B1) vs CPU (plain, "
          f"{time.perf_counter() - t0:.1f} s): ||g_card - g_cpu|| / ||g_cpu|| per group "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in rel.items()})}", flush=True)
    for k, v in rel.items():
        _check(v <= DIFF_CARD_VS_CPU, f"card vs CPU gradient of {k}: {v:.3e}")
    report["card_vs_cpu"] = rel

    # (c) tests/test_grad.py's finite-difference checks on the card
    t0 = time.perf_counter()
    fd = _fd_checks(dev)
    print(f"FD checks on the card (B1), tests/test_grad.py's tolerances, "
          f"{time.perf_counter() - t0:.1f} s: largest |grad - FD| {json.dumps(fd)}",
          flush=True)
    add_counts()

    # (d) inverse rendering at the entry's defaults: 64x64, 200 steps, bf16
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    demo, params, losses = inverse_material.run(device=dev, verbose=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_steps = len(losses)
    host = lambda x: np.round(x.detach().cpu().numpy(), 3).tolist()
    print(f"inverse_material (64x64, {n_steps} steps, bf16): loss {losses[0]:.6f} -> "
          f"{losses[-1]:.6f} ({losses[-1] / losses[0] * 100:.2f}% of the first); "
          f"{wall:.2f} s with the scene build and target, "
          f"{wall / n_steps * 1e3:.2f} ms/step [{card}]", flush=True)
    print(f"  recovered albedo {host(params['base_color'])} true {host(demo.mat_base)}; "
          f"roughness {host(params['roughness'])} true {host(demo.mat_rough)}; point colour "
          f"{host(params['point_color'][0])} true {host(demo.lights.point_color[0])}",
          flush=True)
    _check(losses[-1] < losses[0] * 0.2, "inverse rendering: loss not below 20% of the first")
    report["inverse_ms_per_step"] = wall / n_steps * 1e3
    add_counts()

    # (e) checkpoint at step DIFF_CKPT_STEP, resumed into fresh parameters and
    # a fresh optimiser for DIFF_RESUME_STEPS steps
    scene_d, cam_d, cfg_d, ids_d, target_d, start = inverse_material.problem(device=dev)

    def train(params, opt, n):
        step = make_train_step(scene_d, cam_d, cfg_d, opt)
        return [float(step(params, 0, 0, ids_d, target_d)) for _ in range(n)]

    params = clone_params(start)
    opt = adam(params, inverse_material.LR)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    first = train(params, opt, DIFF_CKPT_STEP)
    ms_step = (time.perf_counter() - t0) / DIFF_CKPT_STEP * 1e3
    path = save_checkpoint(os.path.join(root, "build", "diff_checkpoint"), params, opt,
                           DIFF_CKPT_STEP)
    straight = train(params, opt, DIFF_RESUME_STEPS)
    fresh = clone_params(start)
    loaded, state, at = load_checkpoint(path, fresh, adam(fresh, inverse_material.LR))
    opt2 = adam(loaded, inverse_material.LR)
    opt2.load_state_dict(state)
    resumed = train(loaded, opt2, DIFF_RESUME_STEPS)
    rel = lambda a, b: max(abs(x - y) / abs(y) for x, y in zip(a, b))
    gap = rel(resumed, straight)
    print(f"checkpoint at step {at} ({os.path.relpath(path, root)}), {DIFF_RESUME_STEPS} "
          f"steps resumed vs uninterrupted: largest relative loss difference {gap:.3e}; "
          f"this run vs (d)'s: steps 1-{DIFF_CKPT_STEP} {rel(first, losses):.3e}, "
          f"resumed {rel(resumed, losses[DIFF_CKPT_STEP:]):.3e}; "
          f"{ms_step:.2f} ms/step [{card}]", flush=True)
    _check(at == DIFF_CKPT_STEP and gap <= DIFF_RESUME_RTOL,
           f"checkpoint resume: losses {resumed} vs {straight}")
    report["train_ms_per_step"] = ms_step
    add_counts()
    report["take_rows_launches"] = take_rows.LAUNCHES - gathers

    # (f) the row gather's backward on the inverse cell's step, against
    # float64
    report["take_rows"] = _take_rows_gate(scene, cam, cfg32, target, wrong, card)
    add_counts()
    report["launches"] = phase_counts
    print(f"differentiable path launches (phase total): {json.dumps(phase_counts)}",
          flush=True)
    _check(phase_counts["trace"]["closest"] > 0 and phase_counts["trace"]["any"] > 0
           and phase_counts["trace_bf16"]["closest"] > 0
           and phase_counts["trace_bf16"]["any"] > 0,
           "the differentiable path did not launch B1 and B2 in both modes")
    return report

def _classic_calls(bvh, o, d, tm, cfg):
    """Phase 15's engine calls on one set, as the integrator makes them (the
    lane engine unsorted, as the JAX dispatch runs it, and sorted too; the
    packet engine sorted): {(engine, sorted, mode): call}."""
    from physically_based_ray_tracer_tpu_torch.ops import traverse as tr
    from physically_based_ray_tracer_tpu_torch.ops import traverse_packet as tp
    lane = dict(stack_depth=cfg.max_stack_depth, leaf_size=cfg.leaf_size)
    packet = dict(lane, tile=cfg.packet_tile)
    return {
        ("lane", False, "closest"): lambda: tr.intersect_closest(bvh, o, d, tm, **lane),
        ("lane", False, "any"): lambda: tr.intersect_any(bvh, o, d, tm, **lane),
        ("lane", True, "closest"): lambda: tp.sorted_closest(tr.intersect_closest, bvh, o, d,
                                                             tm, **lane),
        ("lane", True, "any"): lambda: tp.sorted_any(tr.intersect_any, bvh, o, d, tm, **lane),
        ("packet", True, "closest"): lambda: tp.sorted_closest(tp.intersect_closest_packet,
                                                               bvh, o, d, tm, **packet),
        ("packet", True, "any"): lambda: tp.sorted_any(tp.intersect_any_packet, bvh, o, d,
                                                       tm, **packet)}


def _classic_engines_vs_b1(scene_w, dbvh, sets, cfg, card):
    """Phase 15a: the lane and packet engines on the classic BVH against each
    other (t where brute force sees no t-tie, occlusion) and against B1 on
    the dense table (phase 10c's bounds); each call's ms and steps."""
    import torch
    from physically_based_ray_tracer_tpu_torch.ops import trace, traverse
    from physically_based_ray_tracer_tpu_torch.ops import traverse_packet as tp
    from physically_based_ray_tracer_tpu_torch.scene.scene import world_tris
    bvh = scene_w.bvh
    tri = world_tris(scene_w.tri_v0, scene_w.tri_e1, scene_w.tri_e2)
    dev = bvh.tris.device
    out = {}
    for sname, (o, d, tm) in sets.items():
        _, _, tie = _brute_closest(o, d, tri)
        h1 = trace.sorted_closest_dense(dbvh, o, d, tm)
        occ1 = trace.sorted_any_dense(dbvh, o, d, tm)
        res = {}
        for (engine, srt, mode), call in _classic_calls(bvh, o, d, tm, cfg).items():
            steps = traverse.STEPS if engine == "lane" else tp.PACKET_STEPS
            before = steps[mode]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r = call()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            res[(engine, srt, mode)] = r
            n = steps[mode] - before
            out[(engine, srt, mode, sname)] = (ms, n)
            label = f"{engine} {'sorted' if srt else 'unsorted':8s} {mode:7s} {sname:7s}"
            if mode == "closest":
                fw, f1 = r.prim >= 0, h1.prim >= 0
                both = fw & f1
                rep = dict(found_mismatch=float((fw != f1).float().mean()),
                           same_prim=float(((r.prim == h1.prim) & both).sum()
                                           / both.sum().clamp(min=1)),
                           t_max_rel=float(((r.t - h1.t).abs() / h1.t.abs())[both].max()))
                ok = (rep["found_mismatch"] <= WAVE_VS_B1 and rep["same_prim"] >= WAVE_SAME_PRIM)
            else:
                rep = dict(occ_mismatch=float((r != occ1).float().mean()))
                ok = rep["occ_mismatch"] <= WAVE_VS_B1
            print(f"  {label} {N_RAYS} rays: {ms:.2f} ms host clock, {n} steps; vs B1 "
                  f"{json.dumps(rep)} [{card}]", flush=True)
            _check(ok, f"{label}: the engine vs B1 outside phase 10c's bounds")
        # lane = packet: t where brute force sees no t-tie, found, occlusion
        lane_h, packet_h = res[("lane", True, "closest")], res[("packet", True, "closest")]
        fl, fp = lane_h.prim >= 0, packet_h.prim >= 0
        both = fl & fp & ~tie
        rel = ((lane_h.t - packet_h.t).abs() / packet_h.t.abs())[both]
        r = dict(found_mismatch=int(((fl != fp) & ~tie).sum()),
                 t_max_rel=float(rel.max()) if rel.numel() else 0.0,
                 prim_mismatch=int(((lane_h.prim != packet_h.prim) & both).sum()),
                 occ_mismatch=int((res[("lane", True, "any")] != res[("packet", True, "any")])
                                  .sum()),
                 unsorted_vs_sorted=int(sum(int((a != b).sum()) for a, b in zip(
                     res[("lane", False, "closest")], lane_h)))
                 + int((res[("lane", False, "any")] != res[("lane", True, "any")]).sum()),
                 ties=int(tie.sum()))
        print(f"  lane vs packet {sname}: {json.dumps(r)}", flush=True)
        _check(r["found_mismatch"] == 0 and r["t_max_rel"] <= T_RTOL,
               f"{sname}: lane and packet differ in t outside t-ties")
        _check(r["occ_mismatch"] == 0, f"{sname}: lane and packet occlusion differ")
        _check(r["unsorted_vs_sorted"] == 0, f"{sname}: the lane engine's sorted and "
               "unsorted calls differ")
    # the step blocks as CUDA graphs (the engines' default on the card) vs
    # run op by op: the lane engine on the three sets, the packet engine on
    # the primary set's first PACKET_EAGER_RAYS rays (Morton-ordered, so its
    # tiles finish within a few hundred steps)
    graphs = []
    for sname, (o, d, tm) in sets.items():
        n = N_RAYS if sname != "primary" else PACKET_EAGER_RAYS
        for key, call in _classic_calls(bvh, o[:n], d[:n], tm[:n], cfg).items():
            if key[1] is False or (key[0] == "packet" and sname != "primary"):
                continue
            runs = []
            for use in (True, False):
                traverse.CUDA_GRAPHS = use
                r = call()
                runs.append([r] if isinstance(r, torch.Tensor) else list(r))
            traverse.CUDA_GRAPHS = True
            differ = sum(int((_bits(a) != _bits(b)).sum()) for a, b in zip(*runs))
            graphs.append(differ)
            print(f"  {key[0]} {key[2]} {sname} ({n} rays): CUDA-graph blocks vs op by op, "
                  f"{differ} elements differ", flush=True)
    _check(not any(graphs), "the CUDA-graph step blocks differ from the op-by-op steps")
    pushes = traverse.overflow_pushes(dev)
    print(f"  stack overflow pushes (lane + packet, stack depth {cfg.max_stack_depth}, "
          f"tree depth 15): {pushes}", flush=True)
    _check(pushes == 0, "the classic engines overflowed their stack")
    return out


def _classic_path(dev, card, cfg, engines, scene1, scene2, handle2, scene_w, cam, sets,
                  first_wave, first32):
    """Phase 15: the classic-BVH path: (a) the lane and packet engines vs each
    other and vs B1; (b) the bench frame with each; (c) hq dense tables
    (SBVH builds): builds timed against the binned ones, B1-B3 against their
    plain versions and B1 against brute force, B1 and B2 timed beside the
    standard tables with their bounds, an f32 frame on the hq two-level
    tables; (d) the sort modes. Returns the phase's report (times and each
    module's launches over the phase)."""
    import dataclasses
    import torch
    from physically_based_ray_tracer_tpu_torch.bvh import native
    from physically_based_ray_tracer_tpu_torch.bvh.dense import build_dense, build_dense_tlas
    from physically_based_ray_tracer_tpu_torch.ops import trace, trace_bf16, trace_rows, traverse
    from physically_based_ray_tracer_tpu_torch.ops import traverse_packet as tp
    from physically_based_ray_tracer_tpu_torch.render.film import FilmState
    from physically_based_ray_tracer_tpu_torch.render.renderer import (Renderer, frame_fn,
                                                                       morton_pixel_order)
    from physically_based_ray_tracer_tpu_torch.scene.scene import _bake_world

    report = {}
    phase_counts = {}
    for c in engines:
        c.reset_counts()

    def add_counts():
        for c in engines:
            acc = phase_counts.setdefault(c.__name__.rsplit(".", 1)[1], {})
            for k, v in c.LAUNCHES.items():
                acc[k] = acc.get(k, 0) + v
            c.reset_counts()

    # (a) the engines against each other and B1
    t0 = time.perf_counter()
    report["calls"] = _classic_engines_vs_b1(scene_w, scene2.dense, sets, cfg, card)
    add_counts()
    print(f"15a: {time.perf_counter() - t0:.1f} s", flush=True)

    # (b) the bench frame with each engine, one tick, phase 10d's key; the
    # packet engine over every PACKET_STRIDE-th pixel of the Morton order,
    # held to the same pixels of the wave frame (a lane's result depends on
    # its ray and pixel id alone)
    order = morton_pixel_order(cfg.width, cfg.height)
    for engine in CLASSIC_ENGINES:
        t0 = time.perf_counter()
        ecfg = cfg.replace(traversal=engine)
        steps = traverse.STEPS if engine == "lane" else tp.PACKET_STEPS
        traverse.reset_counts()
        tp.reset_counts()
        torch.cuda.reset_peak_memory_stats(dev)
        if engine == "packet":
            ids = order[::PACKET_STRIDE]
            for c in engines:
                c.reset_counts()
            t1 = time.perf_counter()
            _, avg = frame_fn(scene_w, cam, FilmState.zeros(ids.shape[0], device=dev), 0, 0,
                              torch.from_numpy(ids).to(dev), cfg=ecfg)
            first = np.clip(avg.cpu().numpy(), 0.0, 1.0)
            warm = time.perf_counter() - t1
            counts = {c.__name__.rsplit(".", 1)[1]: (dict(c.LAUNCHES), dict(c.PLAIN_CALLS))
                      for c in engines}
            ref = first_wave.reshape(-1, 3)[ids]
            what = f"{ids.shape[0]} pixels (every {PACKET_STRIDE}th of the Morton order)"
        else:
            first, _, warm, _, counts = _frame(Renderer(scene_w, cam, ecfg, device=dev), 0,
                                               engines)
            ref = first_wave
            what = "one tick"
        report[f"{engine}_frame_ms"] = warm * 1e3
        close = np.isclose(first, ref, rtol=2e-4, atol=2e-5).all(axis=-1)
        print(f"frame 1280x720 4 bounces AA {engine}: {warm * 1e3:.2f} ms ({what}), steps "
              f"{dict(steps)}, peak memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB [{card}]", flush=True)
        print(f"  vs the wave frame (same key, same pixels): {close.mean() * 100:.4f}% pixels "
              f"allclose ({int((~close).sum())} differ), max abs diff "
              f"{float(np.abs(first - ref).max()):.3e}", flush=True)
        launched = {k: v[0] for k, v in counts.items()}
        plain = sum(sum(v[1].values()) for v in counts.values())
        print(f"  {engine} frame: launches {json.dumps(launched)}, plain-version calls {plain}",
              flush=True)
        _check(all(sum(v.values()) == 0 for v in launched.values()),
               f"the {engine} frame launched a kernel")
        _check(plain == 0, f"the {engine} frame called a plain version")
        _check(steps["closest"] > 0 and steps["any"] > 0, f"the {engine} frame ran no step")
        _check(first.shape == ref.shape and bool(np.isfinite(first).all()),
               f"{engine} image not finite or of the wrong shape")
        _check(close.mean() >= WAVE_FRAME_CLOSE, f"the {engine} frame vs the wave frame")
        _check(traverse.overflow_pushes(dev) == 0, f"the {engine} frame overflowed its stack")
        add_counts()
        print(f"15b {engine}: {time.perf_counter() - t0:.1f} s", flush=True)

    # (c) hq dense tables: the builds, the kernels on them, an f32 frame
    t0 = time.perf_counter()
    t1 = time.perf_counter()
    native.get_sbvh_lib()
    print(f"SBVH builder library: {time.perf_counter() - t1:.2f} s (g++ or reuse)", flush=True)
    tri = _bake_world(handle2.models, handle2.instances)["tri"]
    mesh_tris = [m.corners.reshape(-1, 3, 3).astype(np.float32) for m in handle2.models]
    inst_mesh = np.array([i.model for i in handle2.instances], np.int64)
    transforms = np.stack([i.transform for i in handle2.instances]).astype(np.float32)
    kw = dict(leaf_target=handle2.dense_leaf_target, shape=handle2.dense_shape)
    builds = {}
    for name, fn in (
            ("one-level hq", lambda: build_dense(tri, hq=True, **kw)[0]),
            ("one-level binned", lambda: build_dense(tri, **kw)[0]),
            ("two-level hq", lambda: build_dense_tlas(mesh_tris, inst_mesh, transforms,
                                                      hq=True, **kw)[0]),
            ("two-level binned", lambda: build_dense_tlas(mesh_tris, inst_mesh, transforms,
                                                          **kw)[0])):
        t1 = time.perf_counter()
        table = fn()
        ms = (time.perf_counter() - t1) * 1e3
        builds[name] = table
        report[f"build_ms {name}"] = ms
        print(f"build {name}: {ms:.2f} ms host clock, {table.n_nodes} nodes, "
              f"{table.n_groups} groups, {int((table.pids_c >= 0).sum())} triangle "
              f"references, stack need {table.stack_need} [{card}]", flush=True)
    for level, std in (("one-level", scene1.dense), ("two-level", scene2.dense)):
        _check(torch.equal(builds[f"{level} binned"].nodes16, std.nodes16.cpu()),
               f"{level}: the binned build differs from the scene's table")
    hq = {"one-level": builds["one-level hq"].to(dev),
          "two-level": builds["two-level hq"].to(dev)}
    std = {"one-level": scene1.dense, "two-level": scene2.dense}
    rep_hq = []
    for tname, dbvh in hq.items():
        for sname in ("primary", "bounce"):
            o, d, tm = sets[sname]
            name = f"hq {tname}/{sname}"
            ref = _plain_ref(dbvh, o, d, tm)
            h1 = trace.sorted_closest_dense(dbvh, o, d, tm)
            occ1 = trace.sorted_any_dense(dbvh, o, d, tm)
            _compare_exact("B1", name, h1, occ1, ref, rep_hq)
            h3 = trace_rows.sorted_rows_closest(dbvh, o, d, tm)
            occ3 = trace_rows.sorted_rows_any(dbvh, o, d, tm)
            _compare_exact("B3", name, h3, occ3, ref, rep_hq)
            _rows_vs_f32(name, h3, occ3, h1, occ1)
            _compare_bf16(name, dbvh, o, d, tm, rep_hq)
        # B1 against brute force over the world triangles, primary set
        o, d, tm = sets["primary"]
        t_b, p_b, tie_b = _brute_closest(o, d, tri)
        h1 = trace.sorted_closest_dense(dbvh, o, d, tm)
        f1, fb = h1.prim >= 0, p_b >= 0
        both = f1 & fb
        r = dict(found_mismatch=int((f1 != fb).sum()),
                 t_max_rel=float(((h1.t - t_b).abs() / t_b.abs())[both].max()),
                 prim_mismatch=int(((h1.prim != p_b) & both & ~tie_b).sum()),
                 ties=int(tie_b.sum()))
        print(f"  B1 vs brute force hq {tname}/primary: {json.dumps(r)}", flush=True)
        _check(r["found_mismatch"] == 0 and r["prim_mismatch"] == 0,
               f"hq {tname}: B1's hits differ from brute force")
        # the two-level walk intersects in object space (the ray moved by the
        # instance's inverse transform), so its t rounds otherwise than the
        # world-space brute force: there t is held to the plain version above
        _check(tname == "two-level" or r["t_max_rel"] <= T_RTOL,
               f"hq {tname}: B1's t differs from brute force")
    for m in (trace, trace_rows, trace_bf16):
        _check(m.truncated_rays(dev) == 0, f"{m.__name__}: rays truncated on an hq table")
    add_counts()
    # B1 and B2 timed on the hq tables beside the standard ones, with bounds
    hq_times = {}
    counters = {"f32": (trace.count_work, lambda db, o, d, tm, c: trace._traverse(
        db, o, d, tm, c)), "bf16": (trace_bf16.count_work, lambda db, o, d, tm, c:
                                    trace_bf16._call_bf16(db, o, d, tm, c))}
    for tname in ("one-level", "two-level"):
        for sname in ("primary", "bounce"):
            o, d, tm = sets[sname]
            for kind, dbvh in (("hq", hq[tname]), ("std", std[tname])):
                _, o_s, d_s, tm_s = trace._cosort_rays(dbvh, o, d, tm)
                for mode in ("closest", "any"):
                    closest = mode == "closest"
                    for eng, (count, launch) in counters.items():
                        k_ms = _time_ms(lambda: launch(dbvh, o_s, d_s, tm_s, closest),
                                        ahead=True)
                        w = count(dbvh, o_s, d_s, tm_s, closest)
                        b_ms, b_by, _ = _bound(eng, mode, dbvh, N_RAYS, w["ops"])
                        hq_times[(eng, tname, sname, mode, kind)] = (k_ms, b_ms, b_by)
            for eng in counters:
                for mode in ("closest", "any"):
                    a = hq_times[(eng, tname, sname, mode, "hq")]
                    b = hq_times[(eng, tname, sname, mode, "std")]
                    print(f"time {eng:4s} {mode:7s} {sname:7s} {tname}: hq kernel {a[0]:.4f} "
                          f"ms (bound {a[1]:.5f} ms, {a[2]}), standard {b[0]:.4f} ms (bound "
                          f"{b[1]:.5f} ms, {b[2]}), hq / standard {a[0] / b[0]:.3f} [{card}]",
                          flush=True)
    report["hq_times"] = hq_times
    add_counts()
    # an f32 frame on the hq two-level tables vs phase 7's f32 frame
    cfg32 = cfg.replace(leaf_precision="f32")
    r_hq = Renderer(dataclasses.replace(scene2, dense=hq["two-level"]), cam, cfg32, device=dev)
    first_hq, _, warm, _, counts = _frame(r_hq, 0, engines)
    close = np.isclose(first_hq, first32, rtol=2e-4, atol=2e-5).all(axis=-1)
    print(f"frame 1280x720 4 bounces AA f32 on the hq two-level tables: {warm * 1e3:.2f} ms "
          f"(one tick); vs phase 7's f32 frame: {close.mean() * 100:.4f}% pixels allclose "
          f"({int((~close).sum())} differ) [{card}]", flush=True)
    _check(counts["trace"][0]["closest"] > 0 and counts["trace"][0]["any"] > 0,
           "the hq f32 frame did not launch B1")
    _check(sum(sum(v[1].values()) for v in counts.values()) == 0,
           "the hq f32 frame called a plain version")
    _check(bool(np.isfinite(first_hq).all()), "hq f32 image not finite")
    _check(close.mean() >= HQ_FRAME_CLOSE, "the hq f32 frame vs the f32 frame")
    add_counts()
    print(f"15c: {time.perf_counter() - t0:.1f} s", flush=True)

    # (d) the sort modes on the main path's two-level table
    t0 = time.perf_counter()
    dbvh = scene2.dense
    rep_sort = []
    for sname, (o, d, tm) in sets.items():
        *_, tie = _plain_hit(dbvh, o, d, tm)
        base = {}
        for mode in trace.SORT_MODES:
            h1 = trace.sorted_closest_dense(dbvh, o, d, tm, sort_mode=mode)
            occ1 = trace.sorted_any_dense(dbvh, o, d, tm, sort_mode=mode)
            h3 = trace_rows.sorted_rows_closest(dbvh, o, d, tm, sort_mode=mode)
            occ3 = trace_rows.sorted_rows_any(dbvh, o, d, tm, sort_mode=mode)
            if not base:
                base = dict(h1=h1, occ1=occ1, h3=h3, occ3=occ3)
                continue
            r = dict(b1_bits=sum(int((_bits(a) != _bits(b)).sum())
                                 for a, b in zip(h1, base["h1"]))
                     + int((occ1 != base["occ1"]).sum()),
                     b3_t_bits=int((_bits(h3.t) != _bits(base["h3"].t)).sum()),
                     b3_prim_outside_ties=int(((h3.prim != base["h3"].prim) & ~tie).sum()),
                     b3_prim_on_ties=int(((h3.prim != base["h3"].prim) & tie).sum()),
                     b3_occ=int((occ3 != base["occ3"]).sum()))
            print(f"  sort {mode} vs octant_major {sname}: {json.dumps(r)}", flush=True)
            _check(r["b1_bits"] == 0, f"{sname} {mode}: B1 differs under the sort mode")
            _check(r["b3_t_bits"] == 0 and r["b3_prim_outside_ties"] == 0 and r["b3_occ"] == 0,
                   f"{sname} {mode}: B3 differs under the sort mode")
            if sname in SORT_B2_SETS:
                _compare_bf16(f"sort {mode} {sname}", dbvh, o, d, tm, rep_sort, sort_mode=mode)
    add_counts()
    print(f"15d: {time.perf_counter() - t0:.1f} s", flush=True)
    report["launches"] = phase_counts
    print(f"classic-BVH path launches (phase total): {json.dumps(phase_counts)}", flush=True)
    _check(phase_counts["trace"]["closest"] > 0 and phase_counts["trace_bf16"]["closest"] > 0
           and phase_counts["trace_rows"]["closest"] > 0,
           "the classic path did not launch B1, B2 and B3")
    return report


def _launch_counts(engines) -> dict:
    return {c.__name__.rsplit(".", 1)[1]: dict(c.LAUNCHES) for c in engines}


def _parallel_rank(rank, n, cfg, sets, parts, train_ids, params0, target):
    """Phase 16b-d on one of ``n`` gloo ranks that share the card (run by
    ``spawn_ranks``): (b) the sharded bench frame, bf16 and f32, and the bf16
    frame with ring resharding, each stitched by ``gather_rows`` (returned by
    rank 0), with the rays each bounce donated; (c) the partitioned closest
    hit and occlusion of the three ray sets, and this rank's table bytes;
    (d) one sharded train step on this rank's block of ``train_ids``: the
    averaged gradients and the parameters after it. Also each kernel's
    launches on this rank and each sub-phase's seconds."""
    import torch
    from physically_based_ray_tracer_tpu_torch.diff.grad import (adam, clone_params,
                                                                 param_items)
    from physically_based_ray_tracer_tpu_torch.diff.inverse import make_sharded_train_step
    from physically_based_ray_tracer_tpu_torch.ops import (leaf_mt, trace, trace_bf16,
                                                          trace_rows, wave_level, wave_scan)
    from physically_based_ray_tracer_tpu_torch.parallel import resharding
    from physically_based_ray_tracer_tpu_torch.parallel.mesh import make_mesh
    from physically_based_ray_tracer_tpu_torch.parallel.object_partition import (
        partition_instances, partitioned_any, partitioned_closest, table_bytes)
    from physically_based_ray_tracer_tpu_torch.parallel.shard import (gather_rows, replicate,
                                                                     shard_rows, sharded_frame)
    from physically_based_ray_tracer_tpu_torch.render.film import FilmState
    from physically_based_ray_tracer_tpu_torch.render.renderer import morton_pixel_order
    from physically_based_ray_tracer_tpu_torch.scene.presets import build_bench_scene

    engines = (trace, trace_bf16, trace_rows, leaf_mt, wave_scan, wave_level)
    for c in engines:
        c.reset_counts()
    out, sec = {}, {}
    t0 = time.perf_counter()
    mesh = make_mesh(n, backend="gloo")
    dev = mesh.device
    scene, cam, _ = build_bench_scene(flatten="auto", device=dev)
    scene, cam = replicate(mesh, (scene, cam))
    ids = shard_rows(mesh, torch.from_numpy(morton_pixel_order(cfg.width, cfg.height)))
    film = FilmState.zeros(ids.shape[0], device=dev)
    cfg32 = cfg.replace(leaf_precision="f32")
    for name, c, block in (("bf16", cfg, 0), ("f32", cfg32, 0),
                           ("bf16_reshard", cfg, PAR_RESHARD_BLOCK),
                           ("f32_reshard", cfg32, PAR_RESHARD_BLOCK)):
        resharding.reset_counts()
        avg = gather_rows(mesh, sharded_frame(mesh, c, reshard_block=block)(
            scene, cam, film, 0, 0, ids)[1])
        if rank == 0:
            out[name] = avg
        out[f"{name}_donated"] = [resharding.DONATED.get(b, 0) for b in range(cfg.bounces)]
    torch.cuda.synchronize()
    sec["16b"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ps = partition_instances(*parts, n_shards=n)
    obj = make_mesh(n, axis="obj", backend="gloo")
    for sname, (o, d, tm) in sets.items():
        o, d, tm = o.to(dev), d.to(dev), tm.to(dev)
        h = partitioned_closest(ps, obj, o, d, tm)
        out[f"{sname}_hit"] = (h.t, h.prim, h.inst)
        out[f"{sname}_occ"] = partitioned_any(ps, obj, o, d, tm)
    out["table_bytes"] = table_bytes(ps.local(rank, dev)[0])
    torch.cuda.synchronize()
    sec["16c"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    params = clone_params(replicate(mesh, params0))
    step = make_sharded_train_step(mesh, scene, cam, cfg, adam(params, 1e-2))
    out["loss"] = float(step(params, 0, 0, shard_rows(mesh, train_ids),
                             shard_rows(mesh, target)))
    out["grads"] = {"/".join(p): v.grad for p, v in param_items(params) if v.requires_grad}
    out["params"] = {"/".join(p): v.detach() for p, v in param_items(params)}
    torch.cuda.synchronize()
    sec["16d"] = time.perf_counter() - t0
    out["launches"] = _launch_counts(engines)
    out["seconds"] = sec
    obj.close()
    mesh.close()
    return out


def _parallel_path(dev, card, cfg, engines, scene2, cam, handle2, sets):
    """Phase 16: the parallel path. (a) a one-rank NCCL mesh in this
    process: the sharded bench frame and train step bit-equal to the
    unsharded ones; (b-d) ``PAR_RANKS`` gloo ranks spawned on the card
    (``_parallel_rank``): sharded and resharded frames, partitioned
    tracing, the sharded train step; (e) ``measure_work_invariance`` and a
    ``utils/profiling.trace`` of one frame. Returns the phase's report
    (each module's launches over the phase, summed over the ranks)."""
    import torch
    from physically_based_ray_tracer_tpu_torch.diff.grad import (adam, apply_params,
                                                                 clone_params, map_params,
                                                                 param_items, render_color)
    from physically_based_ray_tracer_tpu_torch.diff.inverse import (make_sharded_train_step,
                                                                    make_train_step)
    from physically_based_ray_tracer_tpu_torch.ops import trace
    from physically_based_ray_tracer_tpu_torch.parallel.mesh import make_mesh, spawn_ranks
    from physically_based_ray_tracer_tpu_torch.parallel.object_partition import table_bytes
    from physically_based_ray_tracer_tpu_torch.parallel.scaling import measure_work_invariance
    from physically_based_ray_tracer_tpu_torch.parallel.shard import shard_rows, sharded_frame
    from physically_based_ray_tracer_tpu_torch.render.film import FilmState
    from physically_based_ray_tracer_tpu_torch.render.renderer import (frame_fn,
                                                                       morton_pixel_order)
    from physically_based_ray_tracer_tpu_torch.utils.profiling import TRACE_FILE, annotate, trace as ptrace

    root = os.path.dirname(os.path.abspath(__file__))
    phase_counts = {}
    for c in engines:
        c.reset_counts()

    def add_counts(counts):
        for mod, launches in counts.items():
            acc = phase_counts.setdefault(mod, {})
            for k, v in launches.items():
                acc[k] = acc.get(k, 0) + v

    def parent_counts():
        add_counts(_launch_counts(engines))
        for c in engines:
            c.reset_counts()

    n = cfg.n_pixels
    order = torch.from_numpy(morton_pixel_order(cfg.width, cfg.height)).to(dev)

    def frame(c, step=None, ids=order):
        fn = step or (lambda *a: frame_fn(*a, cfg=c))
        return fn(scene2, cam, FilmState.zeros(ids.shape[0], device=dev), 0, 0, ids)[1]

    # (a) one NCCL rank in this process: bit-equal to the unsharded frame
    # and train step
    t0 = time.perf_counter()
    ref16 = frame(cfg)
    ref32 = frame(cfg.replace(leaf_precision="f32"))
    mesh = make_mesh(1, device=dev)
    _check(mesh.backend == "nccl" and mesh.size == 1, f"the one-rank mesh: {mesh}")
    one = torch.ones(4, device=dev)
    _check(torch.equal(mesh.psum(one), one) and torch.equal(mesh.all_gather(one)[0], one),
           "NCCL collectives on a one-rank group")
    avg = frame(cfg, sharded_frame(mesh, cfg), shard_rows(mesh, order))
    differ = int((avg != ref16).any(dim=1).sum())
    print(f"16a sharded bf16 frame, one NCCL rank, vs unsharded (same key, sample): "
          f"{differ} pixels differ [{card}]", flush=True)
    _check(differ == 0, "16a: the one-rank sharded frame differs from the unsharded frame")
    gscene, gcam, target, wrong, _ = _bench_grad_problem(dev, cfg)
    pid = torch.from_numpy(_frame_pixels(cfg, DIFF_PIXELS, np.random.default_rng(1))).to(dev)
    stepped = []
    for make in (lambda opt: make_train_step(gscene, gcam, cfg, opt),
                 lambda opt: make_sharded_train_step(mesh, gscene, gcam, cfg, opt)):
        p = clone_params(wrong)
        loss = float(make(adam(p, 1e-2))(p, 0, 0, pid, target[pid.long()]))
        stepped.append((loss, [v.detach().clone() for _, v in param_items(p)]))
    same = stepped[0][0] == stepped[1][0] and all(
        torch.equal(a, b) for a, b in zip(stepped[0][1], stepped[1][1]))
    print(f"16a sharded train step, one NCCL rank, {DIFF_PIXELS} pixels: loss "
          f"{stepped[1][0]:.6e}, loss and parameters bit-equal to make_train_step: {same}",
          flush=True)
    _check(same, "16a: the one-rank sharded train step differs from make_train_step")
    mesh.close()
    parent_counts()
    sec = {"16a": time.perf_counter() - t0}

    # (b-d) gloo ranks spawned on the card
    t0 = time.perf_counter()
    cpu_sets = {k: tuple(x.cpu() for x in v) for k, v in sets.items()}
    parts = ([m.corners.reshape(-1, 3, 3).astype(np.float32) for m in handle2.models],
             np.array([i.model for i in handle2.instances], np.int64),
             np.stack([i.transform for i in handle2.instances]).astype(np.float32))
    train_ids = torch.from_numpy(_frame_pixels(cfg, PAR_TRAIN_PIXELS,
                                               np.random.default_rng(2)))
    p0 = map_params(wrong, lambda k, x: x.detach().cpu())
    tgt = target[train_ids.to(dev).long()].cpu()
    out = spawn_ranks(_parallel_rank, PAR_RANKS, backend="gloo", timeout=600, args=(
        PAR_RANKS, cfg, cpu_sets, parts, train_ids, p0, tgt))
    spawn_s = time.perf_counter() - t0
    for o in out:
        add_counts(o["launches"])
    for k in ("16b", "16c", "16d"):
        sec[k] = out[0]["seconds"][k]
    sec["16b-d spawned"] = spawn_s

    # (b) frames. B1 traces each ray alone, so the f32 frames are held bit
    # for bit to the unsharded frame, and within PAR_RESHARD_TOL when
    # resharded. B2 breaks an exact bf16 tie inside a leaf group by the
    # ray's lane (its co-sorted position mod 128, the JAX kernel's rule), so
    # its frame depends on the batches (ROADMAP §C): the sharded bf16 frame
    # is held bit for bit to each rank's block rendered here (the same
    # batches), and its difference from the unsharded frame is printed; the
    # resharded bf16 frame (donation changes the batches) may differ from
    # the unresharded one in PAR_BF16_RESHARD_DIFFER of its pixels, within
    # the bf16 engine's frame contract (phase 7's)
    ref16_blocks = torch.cat([frame(cfg, ids=b) for b in order.chunk(PAR_RANKS)])
    results = {}
    for name, ref, what in (("bf16", ref16_blocks, "each rank's block rendered here"),
                            ("f32", ref32, "the unsharded frame"),
                            ("bf16_reshard", ref16_blocks, "the unresharded frame"),
                            ("f32_reshard", ref32, "the unresharded frame")):
        got = torch.from_numpy(out[0][name]).to(dev)
        differ = int((got != ref).any(dim=1).sum())
        donated = [o[f"{name}_donated"] for o in out]
        a, b = got.clamp(0, 1), ref.clamp(0, 1)
        results[name] = dict(
            differ=differ, close=bool(torch.allclose(got, ref, **PAR_RESHARD_TOL)),
            mse=float(((a - b) ** 2).mean()),
            off=float(((a - b).abs().amax(dim=1) > 0.05).float().mean()), donated=donated)
        print(f"16b {name} frame on {PAR_RANKS} gloo ranks, stitched, vs {what}: {differ} "
              f"pixels differ, max abs diff {float((got - ref).abs().max()):.3e}; rays donated "
              f"per bounce by each rank {donated} [{card}]", flush=True)
    got16 = torch.from_numpy(out[0]["bf16"]).to(dev)
    n_chunks = -(-n // cfg.chunk_pixels)
    print(f"16b bf16 frame on {PAR_RANKS} gloo ranks vs the unsharded frame ({n_chunks} "
          f"chunks): {int((got16 != ref16).any(dim=1).sum())} pixels differ "
          f"(B2's exact bf16 ties follow the batch), max abs diff "
          f"{float((got16 - ref16).abs().max()):.3e}", flush=True)
    r = results
    _check(r["bf16"]["differ"] == 0 and r["f32"]["differ"] == 0,
           "16b: a sharded frame differs from the unsharded one")
    _check(r["f32_reshard"]["close"], "16b: the resharded f32 frame vs the unresharded one")
    _check(r["bf16_reshard"]["differ"] <= PAR_BF16_RESHARD_DIFFER * n
           and r["bf16_reshard"]["mse"] < 2e-3 and r["bf16_reshard"]["off"] < 0.03,
           "16b: the resharded bf16 frame vs the unresharded one")
    _check(all(sum(map(sum, r[k]["donated"])) > 0 for k in ("bf16_reshard", "f32_reshard")),
           "16b: resharding donated no ray")

    # (c) partitioned tracing vs the unpartitioned two-level B1 trace
    union_bytes = table_bytes(scene2.dense)
    print(f"16c table bytes per rank {[o['table_bytes'] for o in out]} vs the union's "
          f"{union_bytes} [{card}]", flush=True)
    _check(all(o["table_bytes"] <= union_bytes for o in out), "16c: a shard is larger")
    for sname, (o_, d_, tm) in sets.items():
        h = trace.sorted_closest_dense(scene2.dense, o_, d_, tm)
        occ = trace.sorted_any_dense(scene2.dense, o_, d_, tm)
        *_, tie = _plain_hit(scene2.dense, o_, d_, tm)
        t, prim, inst = (torch.from_numpy(x).to(dev) for x in out[0][f"{sname}_hit"])
        pocc = torch.from_numpy(out[0][f"{sname}_occ"]).to(dev)
        found, pfound = h.prim >= 0, prim >= 0
        both = found & pfound
        r = dict(found_mismatch=int((found != pfound).sum()),
                 occ_mismatch=int((occ != pocc).sum()),
                 prim_mismatch=int(((prim != h.prim) & both & ~tie).sum()),
                 ties=int(tie.sum()),
                 t_max_rel=float(((t - h.t).abs() / h.t.abs())[both].max()),
                 ranks_agree=all(all(np.array_equal(a, b) for a, b in
                                     zip(o[f"{sname}_hit"], out[0][f"{sname}_hit"]))
                                 and np.array_equal(o[f"{sname}_occ"], out[0][f"{sname}_occ"])
                                 for o in out))
        print(f"16c partitioned vs two-level B1, {sname}: {json.dumps(r)}", flush=True)
        _check(r["found_mismatch"] == 0 and r["occ_mismatch"] == 0 and r["prim_mismatch"] == 0
               and r["t_max_rel"] <= T_RTOL and r["ranks_agree"],
               f"16c: the partitioned trace differs from the union trace on {sname}")
    parent_counts()

    # (d) the averaged gradient vs one rank's on the same pixels: the mean
    # of the gradients of the ranks' blocks, each traced as its own batch
    # here (the gate: B2's exact ties follow the batch, as in (b)), and the
    # gradient of all the pixels traced as one batch (printed)
    def grads(ids, tg):
        p = clone_params(wrong)
        s_, c_ = apply_params(gscene, gcam, p)
        torch.mean((render_color(s_, c_, cfg, 0, 0, ids) - tg) ** 2).backward()
        return {"/".join(k): v.grad if v.grad is not None else torch.zeros_like(v)
                for k, v in param_items(p) if v.requires_grad}

    ids_d, tgt_d = train_ids.to(dev), tgt.to(dev)
    blocks = [grads(i, t) for i, t in zip(ids_d.chunk(PAR_RANKS), tgt_d.chunk(PAR_RANKS))]
    whole = grads(ids_d, tgt_d)
    got = {k: torch.from_numpy(v).to(dev) for k, v in out[0]["grads"].items()}
    gaps = {k: _rel(got[k], sum(b[k] for b in blocks) / PAR_RANKS) for k in whole}
    gaps_whole = {k: _rel(got[k], whole[k]) for k in whole}
    equal = all(np.array_equal(out[0]["params"][k], o["params"][k])
                for o in out for k in out[0]["params"])
    print(f"16d sharded train step on {PAR_RANKS} gloo ranks, {PAR_TRAIN_PIXELS} pixels: "
          f"losses {[o['loss'] for o in out]}; averaged gradient vs one rank's (the mean of "
          f"the blocks' gradients), ||g - g1|| / ||g1|| per group {json.dumps(gaps)}; vs the "
          f"gradient of the pixels as one batch {json.dumps(gaps_whole)}; parameters "
          f"bit-equal across ranks: {equal} [{card}]", flush=True)
    _check(all(v <= PAR_GRAD_RTOL for v in gaps.values()),
           "16d: the averaged gradient differs from one rank's")
    _check(equal, "16d: the ranks' parameters differ after the step")
    parent_counts()

    # (e) work invariance; a profiled frame
    t0 = time.perf_counter()
    rows = measure_work_invariance(scene2, cam, cfg, divisors=PAR_DIVISORS, iters=3)
    print(f"16e measure_work_invariance (bf16 bench frame, strided subsets): "
          f"{json.dumps(rows)} [{card}]", flush=True)
    log_dir = os.path.join(root, "build", "torch_trace")
    with ptrace(log_dir):
        with annotate("frame"):
            frame(cfg)
            torch.cuda.synchronize()
    with open(os.path.join(log_dir, TRACE_FILE)) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    b2 = any("traverse_bf16_kernel" in nm for nm in names)
    print(f"16e trace: {len(names)} event names, 'frame' span {'frame' in names}, B2's "
          f"kernel (traverse_bf16_kernel) {b2}", flush=True)
    _check("frame" in names and b2, "16e: the trace lacks the frame span or B2's kernel")
    parent_counts()
    sec["16e"] = time.perf_counter() - t0
    print(f"parallel path seconds by sub-phase: {json.dumps(sec)}", flush=True)
    print(f"parallel path launches (phase total, summed over the ranks): "
          f"{json.dumps(phase_counts)}", flush=True)
    _check(phase_counts["trace"]["closest"] > 0 and phase_counts["trace_bf16"]["closest"] > 0,
           "the parallel path did not launch B1 and B2")
    return {"launches": phase_counts, "seconds": sec}


def brdf_matrix() -> list:
    """tests/test_torch_shading.py's BRDF_MATRIX in the port's types (the
    13 settings besides the default; tests/test_torch_brdf_images.py pins
    the two lists equal)."""
    from physically_based_ray_tracer_tpu_torch.config import NDF, DiffuseModel, SpecularModel
    return [dict(ndf=NDF.BECKMANN, use_optimized_g2=False),
            dict(use_vndf_sampling=False),
            dict(use_spherical_caps_vndf=True),
            dict(use_height_correlated_g2=False),
            dict(use_optimized_g2=False),
            dict(use_reflectance_parameter=True),
            dict(combine_brdfs_with_fresnel=False),
            dict(specular=SpecularModel.PHONG),
            dict(specular=SpecularModel.NONE),
            dict(diffuse=DiffuseModel.NONE),
            dict(diffuse=DiffuseModel.OREN_NAYAR),
            dict(diffuse=DiffuseModel.DISNEY),
            dict(diffuse=DiffuseModel.FROSTBITE)]


def parity_configs() -> dict:
    """Phase 17b's RenderConfigs: ``matrix``, tests/test_torch_brdf_images.py's
    (f32 engine, AA off), ``directional``, tests/test_parity.py's (one path
    vertex, directional NEE without the lottery, the default bf16 engine),
    and ``stochastic``, tests/test_parity_stochastic.py's paths."""
    from physically_based_ray_tracer_tpu_torch import RenderConfig
    return {"matrix": RenderConfig(width=MATRIX_SIZE, height=MATRIX_SIZE,
                                   bounces=MATRIX_BOUNCES, antialias=False, skybox=False,
                                   traversal="pallas", leaf_precision="f32",
                                   one_shadow_ray=True, max_stack_depth=24),
            "directional": RenderConfig(width=24, height=24, bounces=1, antialias=False,
                                        skybox=False, stochastic_lights=False,
                                        max_stack_depth=24),
            "stochastic": RenderConfig(width=STOCH_SIZE, height=STOCH_SIZE,
                                       bounces=STOCH_BOUNCES, antialias=False, skybox=False,
                                       stochastic_lights=True, one_shadow_ray=True,
                                       max_stack_depth=24)}


def parity_scenes(device) -> dict:
    """The port's builds of tests/test_parity.py's scene (``directional``: a
    sphere over a floor, one directional light) and tests/test_parity_stochastic.py's
    (``stochastic``: a rough, a glass and a mirror sphere over an emissive
    floor, two point lights, a directional and a spot light), each (scene,
    camera) on ``device``; tests/test_torch_oracle.py pins their tables to
    the JAX builds byte for byte."""
    from physically_based_ray_tracer_tpu_torch.scene.camera import Camera
    from physically_based_ray_tracer_tpu_torch.scene.lights import LightSet
    from physically_based_ray_tracer_tpu_torch.scene.procedural import make_quad, make_sphere
    from physically_based_ray_tracer_tpu_torch.scene.scene import (Instance, MeshModel,
                                                                   build_scene)
    sphere = MeshModel.from_fat(make_sphere(radius=1.0, lat=10, lon=14),
                                base_color=(0.8, 0.3, 0.2), roughness=0.5, metalness=0.2)
    floor = MeshModel.from_fat(
        make_quad([-5, -1.2, -5], [-5, -1.2, 5], [5, -1.2, 5], [5, -1.2, -5]),
        base_color=(0.5, 0.6, 0.7), roughness=0.9)
    lights = LightSet.make(dir_pos=[[4, 6, 3]], dir_color=[[2.0, 1.9, 1.7]], device=device)
    directional, _ = build_scene([sphere, floor], [Instance(0), Instance(1)], lights,
                                 device=device)
    sphere = MeshModel.from_fat(make_sphere(radius=1.0, lat=8, lon=12),
                                base_color=(0.8, 0.3, 0.2), roughness=0.5, metalness=0.2)
    glass = MeshModel.from_fat(make_sphere(radius=0.5, lat=8, lon=12),
                               base_color=(0.9, 0.9, 0.9), roughness=0.1,
                               transmissivness=1.0)
    mirror = MeshModel.from_fat(make_sphere(radius=0.5, lat=8, lon=12),
                                base_color=(0.9, 0.9, 0.9), roughness=0.0, metalness=1.0)
    floor = MeshModel.from_fat(
        make_quad([-6, -1.2, -6], [-6, -1.2, 6], [6, -1.2, 6], [6, -1.2, -6]),
        base_color=(0.5, 0.6, 0.7), roughness=0.9, emissive=(0.01, 0.01, 0.01))
    lights = LightSet.make(
        point_pos=[[2.0, 3.0, 2.0], [-2.0, 2.0, 1.0]],
        point_color=[[6.0, 5.0, 4.0], [3.0, 3.0, 5.0]],
        dir_pos=[[4.0, 6.0, 3.0]], dir_color=[[1.5, 1.4, 1.2]],
        spot_pos=[[0.0, 4.0, 0.0]], spot_color=[[8.0, 8.0, 8.0]],
        spot_rot=[[0.0, -1.0, 0.0]], device=device)
    insts = [Instance(0), Instance(1, position=(-1.4, -0.6, 0.9)),
             Instance(2, position=(1.5, -0.5, 0.7)), Instance(3)]
    stochastic, _ = build_scene([sphere, glass, mirror, floor], insts, lights,
                                device=device)
    return {"directional": (directional, Camera.make(pos=(0.0, 0.8, 3.5),
                                                     target=(0.0, 0.0, 0.0), device=device)),
            "stochastic": (stochastic, Camera.make(pos=(0.0, 1.0, 4.0),
                                                   target=(0.0, 0.0, 0.0), device=device))}


def converged_fields(depth: int) -> dict:
    """The RenderConfig fields of phase 17a's renders (the fixture's too:
    tests/torch_converged_fixture.py renders them with JAX), for a scene
    whose classic BVH has depth ``depth``: experiments/bf16_precision.py's
    config."""
    return dict(width=CONV_WIDTH, height=CONV_HEIGHT, bounces=4, antialias=True,
                skybox=False, max_stack_depth=max(depth + 2, 32), one_shadow_ray=True)


def image_stats(a, b) -> dict:
    """experiments/bf16_precision.py's statistics of two images, unrounded."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = np.abs(a - b)
    return dict(mean_abs=float(d.mean()), p99_abs=float(np.quantile(d, 0.99)),
                p999_abs=float(np.quantile(d, 0.999)), max_abs=float(d.max()),
                mse=float(((a - b) ** 2).mean()),
                pixels_over_1pct=float((d.max(-1) > 0.01).mean()))


def _converged_path(dev, card, engines) -> dict:
    """Phase 17a: the fixture's config rendered on the card, f32 and bf16 at
    seed 0 and f32 at seed 1, 48 ticks each in one chunk; gates G1-G3.
    Returns each kernel's launches over the phase."""
    import torch
    from physically_based_ray_tracer_tpu_torch import RenderConfig
    from physically_based_ray_tracer_tpu_torch.render.renderer import Renderer
    from physically_based_ray_tracer_tpu_torch.scene.presets import build_bench_scene

    fx = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), CONV_FIXTURE))
    fields = json.loads(str(fx["config"]))
    scene, cam, depth = build_bench_scene(device=dev)
    cfg = RenderConfig(**converged_fields(depth))
    _check(converged_fields(depth) == fields
           and int(fx["spp"]) == CONV_SPP and int(fx["seed"]) == 0
           and list(fx["resolution"]) == [CONV_WIDTH, CONV_HEIGHT],
           f"the fixture's config {fields} is not this phase's")
    # one chunk: the port's batches are the JAX run's
    _check(cfg.n_pixels <= cfg.chunk_pixels, "the converged frame takes more than one chunk")
    print(f"fixture {CONV_FIXTURE}: JAX {fx['jax_version']}, config {json.dumps(fields)}",
          flush=True)
    jax_f32, jax_bf16 = fx["f32"], fx["bf16"]
    for c in engines:
        c.reset_counts()
    imgs, ms = {}, {}
    for tag, lp, seed in (("f32", "f32", 0), ("bf16", "bf16", 0), ("f32_seed1", "f32", 1)):
        r = Renderer(scene, cam, cfg.replace(leaf_precision=lp), device=dev)
        t0 = time.perf_counter()
        for _ in range(CONV_SPP):
            img = r.tick(seed)
        torch.cuda.synchronize()
        ms[tag] = (time.perf_counter() - t0) * 1e3 / CONV_SPP
        _check(img.shape == jax_f32.shape and bool(np.isfinite(img).all()),
               f"converged {tag} image not finite or of the wrong shape")
        imgs[tag] = img
        print(f"converged {tag} (seed {seed}): {CONV_SPP} ticks, {ms[tag]:.2f} ms a tick, "
              f"image mean {float(img.mean()):.6f} [{card}]", flush=True)
    launches = _launch_counts(engines)
    plain = {c.__name__.rsplit(".", 1)[1]: dict(c.PLAIN_CALLS) for c in engines}
    stats = {"port_f32_vs_jax_f32": image_stats(imgs["f32"], jax_f32),
             "port_bf16_vs_jax_f32": image_stats(imgs["bf16"], jax_f32),
             "port_bf16_vs_jax_bf16": image_stats(imgs["bf16"], jax_bf16),
             "port_f32_seed1_vs_jax_f32": image_stats(imgs["f32_seed1"], jax_f32),
             "jax_bf16_vs_jax_f32": image_stats(jax_bf16, jax_f32)}
    for name, s in stats.items():
        ratio = {k: s[k] / CONV_FLOOR[k] for k in s}
        print(f"converged {name}: {json.dumps(s)}; / noise floor {json.dumps(ratio)}",
              flush=True)
    for tag in ("f32", "bf16"):
        d = np.abs(imgs[tag] - jax_f32).max(axis=-1).ravel()
        worst = [(int(i // CONV_WIDTH), int(i % CONV_WIDTH), float(d[i]))
                 for i in np.argsort(d)[::-1][:5]]
        print(f"converged port_{tag}_vs_jax_f32: worst pixels (y, x, max abs) {worst}",
              flush=True)
    print(f"converged path: launches {json.dumps(launches)}, plain-version calls "
          f"{json.dumps(plain)}", flush=True)
    _check(all(launches[m]["closest"] > 0 and launches[m]["any"] > 0
               for m in ("trace", "trace_bf16")), "the converged path did not launch B1 and B2")
    _check(not any(sum(p.values()) for p in plain.values()),
           "the converged path called a plain version")
    g1 = stats["port_f32_vs_jax_f32"]
    g2 = stats["port_bf16_vs_jax_f32"]
    g3 = stats["port_f32_seed1_vs_jax_f32"]["mse"] / CONV_FLOOR["mse"]
    _check(g1["mse"] <= CONV_JAX_BF16_VS_F32_MSE,
           f"G1: MSE(port f32, JAX f32) {g1['mse']:.4e} > {CONV_JAX_BF16_VS_F32_MSE}")
    _check(g2["mse"] <= 2 * CONV_JAX_BF16_VS_F32_MSE,
           f"G2: MSE(port bf16, JAX f32) {g2['mse']:.4e} > {2 * CONV_JAX_BF16_VS_F32_MSE}")
    _check(all(g2[k] < CONV_FLOOR[k] for k in ("mean_abs", "p99_abs", "p999_abs")),
           "G2: port bf16 vs JAX f32 not below the noise floor's mean, p99, p999 abs")
    _check(CONV_FLOOR_BAND[0] <= g3 <= CONV_FLOOR_BAND[1],
           f"G3: MSE(port f32 seed 1, JAX f32 seed 0) is {g3:.4f} x the noise floor")
    print(f"G1 {g1['mse']:.6e} <= {CONV_JAX_BF16_VS_F32_MSE}; G2 {g2['mse']:.6e} <= "
          f"{2 * CONV_JAX_BF16_VS_F32_MSE}; G3 {g3:.4f} x floor in {CONV_FLOOR_BAND}",
          flush=True)
    return launches


def _parity_on_card(dev, card, engines) -> None:
    """Phase 17b: the BRDFConfig matrix's images and the oracle scenes' on
    the card (kernels) and on the CPU (plain versions), same key."""
    import torch
    from physically_based_ray_tracer_tpu_torch import BRDFConfig, RenderMode
    from physically_based_ray_tracer_tpu_torch.render.integrator import trace_paths
    from physically_based_ray_tracer_tpu_torch.render.renderer import Renderer
    from physically_based_ray_tracer_tpu_torch.scene.camera import primary_rays

    scenes, cfgs = parity_scenes("cpu"), parity_configs()

    def agree(label, got, want):
        close = np.isclose(got, want, rtol=2e-4, atol=2e-5).all(axis=-1)
        print(f"{label}: card vs CPU {close.mean() * 100:.3f}% pixels allclose "
              f"({int((~close).sum())} differ), mean abs diff "
              f"{float(np.abs(got - want).mean()):.3e}", flush=True)
        _check(close.mean() >= PARITY_CLOSE, f"{label}: card and CPU images disagree")

    def both(scene, cam, cfg):
        return [Renderer(scene, cam, cfg, device=d).tick(0) for d in (dev, "cpu")]

    for c in engines:
        c.reset_counts()
    scene, cam = scenes["stochastic"]
    for kw in [{}] + brdf_matrix():
        got, want = both(scene, cam, cfgs["matrix"].replace(brdf=BRDFConfig(**kw)))
        name = "-".join(f"{k}={getattr(v, 'name', v)}" for k, v in kw.items()) or "default"
        agree(f"BRDFConfig {name}", got, want)
    scene, cam = scenes["directional"]
    for mode in (RenderMode.BRDF, RenderMode.BASECOLOR):
        cfg = cfgs["directional"].replace(rendering_mode=mode,
                                          gamma_corrected=mode == RenderMode.BRDF)
        agree(f"directional {mode.name}", *both(scene, cam, cfg))
    scene, cam = scenes["stochastic"]
    cfg = cfgs["stochastic"]
    rad = []
    for d in (dev, "cpu"):
        ids = torch.arange(STOCH_SIZE * STOCH_SIZE, dtype=torch.int32, device=d)
        sc, cm = scene.to(d), cam.to(d)
        o, dr = primary_rays(cm, (ids % STOCH_SIZE).float(), (ids // STOCH_SIZE).float(),
                             STOCH_SIZE, STOCH_SIZE)
        rad.append(trace_paths(sc, cfg, o, dr, ids, STOCH_KEY, 0)[0].cpu().numpy())
    agree("stochastic paths", *rad)
    launches = _launch_counts(engines)
    print(f"matrix and oracle scenes: launches {json.dumps(launches)}", flush=True)
    _check(all(launches[m]["closest"] > 0 and launches[m]["any"] > 0
               for m in ("trace", "trace_bf16")), "phase 17b did not launch B1 and B2")


def _graph_path(dev, card, cfg) -> dict:
    """Phase 18: replayed ticks against eager ticks, bit for bit (module
    docstring). Returns each path's median tick ms per frame."""
    import contextlib
    from unittest import mock

    import torch
    from physically_based_ray_tracer_tpu_torch.animate import orbit
    from physically_based_ray_tracer_tpu_torch.ops import trace_bf16
    from physically_based_ray_tracer_tpu_torch.render import renderer as renderer_mod
    from physically_based_ray_tracer_tpu_torch.render.renderer import Renderer, _chunks
    from physically_based_ray_tracer_tpu_torch.scene.presets import build_bench_scene
    from physically_based_ray_tracer_tpu_torch.scene.scene import Instance
    from physically_based_ray_tracer_tpu_torch.utils import profiling

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    report = {}
    for name, (w, h), moving in (("bench 1280x720", (1280, 720), False),
                                 ("game 480x270 moving", (480, 270), True)):
        c = cfg.replace(width=w, height=h)

        def ticks(replayed):
            scene, cam, _, handle = build_bench_scene(flatten=False, return_handle=True,
                                                      device=dev)
            with contextlib.ExitStack() as stack:
                if not replayed:
                    stack.enter_context(mock.patch.object(renderer_mod, "graph_path",
                                                          lambda cfg, device: False))
                r = Renderer(scene, cam, c, device=dev, handle=handle)
                out, ms, tick = [], [], None
                for k in range(1, GRAPH_TICKS + 1):
                    poses = orbit(0.05 * k, n=9, radius=DYN_ORBIT) + [Instance(1)] \
                        if moving else None
                    traced = replayed and k == GRAPH_TICKS
                    launched = trace_bf16.LAUNCHES["closest"]
                    profiling.reset()
                    t0 = time.perf_counter()
                    with (torch.profiler.profile(activities=acts) if traced
                          else contextlib.nullcontext()):
                        img = r.tick(0, instances=poses)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    if traced:
                        tick = [x for x in profiling.spans() if x["name"] == "pbrt.tick"][-1]
                    out.append((img, r.film, trace_bf16.LAUNCHES["closest"] - launched))
            return r, out, ms, tick

        _, eager, ms_e, _ = ticks(False)
        r, replay, ms_r, tick = ticks(True)
        n_chunks = _chunks(r._pixel_ids, c.chunk_pixels)[1]
        same = [bool(np.array_equal(a[0], b[0]))
                and all(torch.equal(_bits(x), _bits(y)) for x, y in zip(a[1], b[1]))
                for a, b in zip(eager, replay)]
        attrs = {k: tick["attrs"].get(k) for k in ("chunks", "replays", "captures",
                                                    "refreshed")}
        print(f"recorded chunk, {name}: ticks bit-equal to eager {same}; eager ms "
              f"{[round(x, 2) for x in ms_e]}, replayed ms {[round(x, 2) for x in ms_r]} "
              f"(the first records); median of the later ticks eager "
              f"{statistics.median(ms_e[1:]):.2f}, replayed {statistics.median(ms_r[1:]):.2f}"
              f" ms; traced tick {attrs}; B2 closest launches a replayed tick "
              f"{[x[2] for x in replay]} [{card}]", flush=True)
        _check(all(same), f"{name}: a replayed tick differs from the eager tick")
        _check(r._graph is not None and r._graph.graph is not None,
               f"{name}: the tick did not record a CUDA graph")
        _check(attrs["chunks"] == n_chunks and attrs["replays"] == n_chunks
               and attrs["captures"] == 0 and (attrs["refreshed"] > 0) == moving,
               f"{name}: the traced tick's span counts {attrs}")
        _check(all(x[2] == n_chunks * c.bounces for x in replay[1:]),
               f"{name}: B2 closest launches of a replayed tick")
        report[name] = {"eager_ms": statistics.median(ms_e[1:]),
                        "replayed_ms": statistics.median(ms_r[1:])}
    return report


def main() -> int:
    import torch

    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    from physically_based_ray_tracer_tpu_torch import RenderConfig
    from physically_based_ray_tracer_tpu_torch.ops import (_build, leaf_mt, trace, trace_bf16,
                                                          trace_rows, wave_level, wave_scan)
    from physically_based_ray_tracer_tpu_torch.ops import traverse_packet
    from physically_based_ray_tracer_tpu_torch.render.renderer import Renderer
    from physically_based_ray_tracer_tpu_torch.scene.presets import build_bench_scene

    reference = [m for m in sys.modules if m.split(".")[0]
                 in ("jax", "jaxlib", "physically_based_ray_tracer_tpu")]
    _check(not reference, f"the port imported {reference}")
    dev = torch.device("cuda", 0)
    card = _smi()
    print(f"card: {card}", flush=True)
    engines = (trace, trace_bf16, trace_rows, leaf_mt, wave_scan, wave_level)

    # 1. build
    with _Phase("build"):
        _build.build_all()
        for name in _build.SOURCES:
            _build.load(name)
            info = _build.BUILD_INFO[name]
            print(f"{name}: {info['seconds']:.2f} s ({info['path']})\n{info['log']}",
                  flush=True)
        _check(_build.load("traverse_rows").pbrt_trace_rows_stack_cap()
               == trace_rows.STACK_CAP, "B3's stack cap differs from trace_rows.STACK_CAP")
        _check(_build.load("wave_level").pbrt_wave_level_threads() == wave_level.THREADS,
               "the fused level's block differs from wave_level.THREADS")
        # B1's, B2's, B3's, the fused level's and take_rows' registers, stack
        # frame (local memory) and spills per kernel function: ptxas's own lines,
        # demangled where c++filt exists
        for name in ("traverse_f32", "traverse_bf16", "traverse_rows", "wave_level",
                     "take_rows"):
            lines = "\n".join(ln for ln in _build.BUILD_INFO[name]["log"].splitlines()
                              if any(k in ln for k in PTXAS_KEYS))
            if shutil.which("c++filt"):
                lines = subprocess.run(["c++filt"], input=lines, capture_output=True,
                                       text=True, check=True, timeout=60).stdout
            print(f"ptxas {name}:\n{lines}", flush=True)
        level_use = _ptxas_usage(_build.BUILD_INFO["wave_level"]["log"])
        print(f"wave_level kernels (registers, stack frame, spill bytes): "
              f"{json.dumps(level_use)}", flush=True)
        # (a library reused from an earlier build has no log to read)
        _check(len(level_use) == 4 or not level_use, "wave_level: four instantiations")
        _check(all(u["spill_bytes"] == 0 and u["registers"] <= 64
                   for u in level_use.values()),
               "wave_level: ptxas reports spills or more than 64 registers")
        rows_use = _ptxas_usage(_build.BUILD_INFO["traverse_rows"]["log"])
        print(f"traverse_rows kernels (registers, stack frame, spill bytes): "
              f"{json.dumps(rows_use)}", flush=True)
        _check(len(rows_use) == 5 or not rows_use,
               "traverse_rows: four kernel instantiations and the order-key kernel")
        _check(all(u["spill_bytes"] == 0 for u in rows_use.values()),
               "traverse_rows: ptxas reports spills")

    # 1b. the packed bf16x2 operations of B2's sweep, over all operand pairs
    with _Phase("bf16x2 exhaustive check"):
        t0 = time.perf_counter()
        mism = trace_bf16.packed_op_mismatches(dev)
        torch.cuda.synchronize()
        print(f"bf16x2 ops vs f32-then-round over all 2^32 operand pairs: mismatches "
              f"{json.dumps(mism)} ({time.perf_counter() - t0:.2f} s) [{card}]", flush=True)
        _check(set(mism) == set(trace_bf16.PACKED_OPS) and not any(mism.values()),
               f"B2's packed bf16x2 operations differ from the f32 emulation: {mism}")
    with _Phase("B3 order key, every float32"):
        t0 = time.perf_counter()
        keys = trace_rows.order_key_mismatches(dev)
        print(f"B3 order key vs float order over every non-NaN float32: {json.dumps(keys)} "
              f"({time.perf_counter() - t0:.2f} s) [{card}]", flush=True)
        _check(keys["pairs"] == trace_rows.ORDERED_FLOATS - 1
               and keys["order_mismatch"] == 0 and keys["plain_mismatch"] == 0,
               f"B3's order key does not keep the float order: {keys}")

    cfg = RenderConfig(width=1280, height=720, bounces=4, antialias=True,
                       skybox=False, one_shadow_ray=True, chunk_pixels=65536)
    _check(cfg.leaf_precision == "bf16", "the default engine is bf16")
    with _Phase("scenes"):
        scene2, cam, _, handle2 = build_bench_scene(flatten="auto", return_handle=True,
                                                    device=dev)
        scene1, _, _ = build_bench_scene(flatten=True, device=dev)
        print(f"two-level {scene2.dense.n_nodes} nodes / {scene2.dense.n_groups} "
              f"groups / {scene2.dense.n_instances} instances (stack need "
              f"{scene2.dense.stack_need}); one-level {scene1.dense.n_nodes} nodes / "
              f"{scene1.dense.n_groups} groups (stack need {scene1.dense.stack_need})",
              flush=True)
        _check(scene2.dense.two_level and not scene1.dense.two_level,
               "flatten='auto' must keep the bench scene two-level")
        t0 = time.perf_counter()
        scene_w, _, depth_w = build_bench_scene(legacy_bvh=True, device=dev)
        print(f"classic BVH (legacy_bvh=True): {scene_w.bvh.n_nodes} nodes, "
              f"{scene_w.bvh.n_prims} triangle slots, scene depth {depth_w}, built in "
              f"{time.perf_counter() - t0:.1f} s (g++ included)", flush=True)
        _check(scene2.bvh is None and scene_w.bvh is not None, "classic BVH only when asked")
        sets = _ray_sets(scene2, cam, cfg, dev)
    tables = (("two-level", scene2), ("one-level", scene1))

    # 2-4. kernels vs plain versions, B3 vs B1, bf16 vs f32
    rep_f32, rep_rows, rep_bf16, rep_contract = [], [], [], []
    with _Phase("B1 and B3 vs plain, B3 vs B1"):
        for tname, sc in tables:
            for sname, (o, d, tm) in sets.items():
                name, dbvh = f"{tname}/{sname}", sc.dense
                ref = _plain_ref(dbvh, o, d, tm)
                h1 = trace.sorted_closest_dense(dbvh, o, d, tm)
                occ1 = trace.sorted_any_dense(dbvh, o, d, tm)
                _compare_exact("B1", name, h1, occ1, ref, rep_f32)
                h3 = trace_rows.sorted_rows_closest(dbvh, o, d, tm)
                occ3 = trace_rows.sorted_rows_any(dbvh, o, d, tm)
                _compare_exact("B3", name, h3, occ3, ref, rep_rows)
                _rows_vs_f32(name, h3, occ3, h1, occ1)
        trunc1, trunc3 = trace.truncated_rays(dev), trace_rows.truncated_rays(dev)
        print(f"truncated rays: B1 {trunc1}, B3 {trunc3}; t-ties (plain version) "
              f"{[r['ties'] for r in rep_rows]}", flush=True)
        _check(trunc1 == 0, "B1 truncated rays")
        _check(trunc3 == 0, f"{trunc3} rays hit B3's step bound or stack cap")
    with _Phase("B2 vs plain"):
        for tname, sc in tables:
            for sname, (o, d, tm) in sets.items():
                _compare_bf16(f"{tname}/{sname}", sc.dense, o, d, tm, rep_bf16)
        trunc = trace_bf16.truncated_rays(dev)
        print(f"B2 truncated rays: {trunc}", flush=True)
        _check(trunc == 0, f"{trunc} rays hit B2's step bound or stack cap")
    with _Phase("B2 vs B1 (precision contract)"):
        for tname, sc in tables:
            for sname, (o, d, tm) in sets.items():
                _contract_bf16_vs_f32(f"{tname}/{sname}", sc.dense, o, d, tm,
                                      rep_contract, sname == "primary")

    # 5. times at the main path's shapes, on co-sorted rays; 5b. bound inputs
    times, work, bounds, schedule = {}, {}, {}, {}
    report_sets = {"closest": "bounce", "any": "shadow"}   # the kernels line's
    with _Phase("times"):
        for sname, (o, d, tm) in sets.items():
            for tname, sc in tables:
                dbvh = sc.dense
                _, o_s, d_s, tm_s = trace._cosort_rays(dbvh, o, d, tm)
                for mode in ("closest", "any"):
                    closest = mode == "closest"
                    runs = [("f32", lambda: trace._traverse(dbvh, o_s, d_s, tm_s, closest),
                             lambda: trace.plain_traverse(dbvh, o_s, d_s, tm_s, closest)),
                            ("rows", lambda: trace_rows._traverse(dbvh, o_s, d_s, tm_s, closest),
                             lambda: trace_rows.plain_traverse_rows(dbvh, o_s, d_s, tm_s,
                                                                    closest))]
                    if tname == "two-level":
                        runs.append(("bf16",
                                     lambda: trace_bf16._call_bf16(dbvh, o_s, d_s, tm_s, closest),
                                     lambda: trace_bf16.plain_traverse_bf16(
                                         dbvh, o_s, d_s, tm_s, closest)))
                    k_ms = {}
                    for eng, kfn, pfn in runs:
                        k_ms[eng] = _time_ms(kfn, ahead=True)
                        line = (f"time {eng:4s} {mode:7s} {sname:7s} {N_RAYS} rays, "
                                f"{tname}: kernel {k_ms[eng]:.4f} ms")
                        # B3's plain version is B1's function: timed on the
                        # kernels line's sets only
                        if tname == "two-level" and (eng != "rows"
                                                     or report_sets[mode] == sname):
                            p_ms = _time_ms(pfn, runs=PLAIN_RUNS, warmup=False)
                            times[(eng, sname, mode)] = (k_ms[eng], p_ms)
                            line += f", plain {p_ms:.2f} ms"
                        elif tname == "two-level":
                            times[(eng, sname, mode)] = (k_ms[eng], None)
                        print(f"{line} [{card}]", flush=True)
                    print(f"B3/B1 {mode:7s} {sname:7s} {tname}: "
                          f"{k_ms['rows'] / k_ms['f32']:.3f}", flush=True)
    with _Phase("bound inputs (counting instantiations)"):
        dbvh = scene2.dense
        counters = {"f32": trace.count_work, "rows": trace_rows.count_work,
                    "bf16": trace_bf16.count_work}
        for sname, (o, d, tm) in sets.items():
            _, o_s, d_s, tm_s = trace._cosort_rays(dbvh, o, d, tm)
            for mode in ("closest", "any"):
                for eng, count in counters.items():
                    w = count(dbvh, o_s, d_s, tm_s, mode == "closest")
                    work[(eng, sname, mode)] = w
                    # B3 computes B1's function: its bound is the work B1
                    # needs on these rays; the work its schedule does and
                    # the warps that split are printed and reported beside it
                    need = work[("f32", sname, mode)] if eng == "rows" else w
                    b_ms, b_by, nbytes = _bound(eng, mode, dbvh, N_RAYS, need["ops"])
                    bounds[(eng, sname, mode)] = (b_ms, b_by)
                    k_ms = times[(eng, sname, mode)][0]
                    whose = "B1 " if eng == "rows" else ""
                    line = (f"bound {eng:4s} {mode:7s} {sname:7s} two-level: "
                            f"{whose}{json.dumps(need)}, {nbytes:.4g} bytes -> "
                            f"{b_ms:.5f} ms ({b_by}); kernel {k_ms:.4f} ms, bound / kernel "
                            f"{100 * b_ms / k_ms:.2f}%")
                    if eng == "rows":
                        u_ms = _bound(eng, mode, dbvh, N_RAYS, w["ops"])[0]
                        schedule[(sname, mode)] = (u_ms, w["split_warps"])
                        line += (f"; its schedule's work {json.dumps(w)} -> {u_ms:.5f} ms, "
                                 f"{w['ops']['f32'] / need['ops']['f32']:.2f}x B1's ops, "
                                 f"{w['split_warps']} of {-(-N_RAYS // 32)} warps split")
                    ref = STEP_WALK_WORK.get((eng, sname, mode))
                    if ref is not None:
                        got = (w["node_steps"], w["tri_tests"], w["leaf_visits"])
                        line += f"; one-step walk's work {list(ref)}"
                        _check(got == ref, f"{eng} {mode} {sname}: counted work {got} "
                               f"differs from the one-step walk's {ref} (the walk must "
                               f"not change a ray's work)")
                    print(f"{line} [{card}]", flush=True)
        _check(all(trunc == 0 for trunc in (trace.truncated_rays(dev),
                                             trace_rows.truncated_rays(dev),
                                             trace_bf16.truncated_rays(dev))),
               "rays truncated by a counting launch")

    # 10a-b. the wave engine's kernels vs plain, no sync, the wave engine vs B1
    with _Phase("wave: fused level, B4 and scan kernel vs plain, times"):
        wave_k = _wave_level_checks(scene_w.bvh, sets, card)
    with _Phase("wave: the fused level's other paths"):
        _wave_level_paths(scene2, scene_w.bvh, sets)
    with _Phase("wave: no host sync"):
        _wave_sync_free(scene_w.bvh, sets)
    with _Phase("wave engine vs B1"):
        _wave_vs_b1(scene_w, scene2.dense, sets, card)

    # 6. the main path, default configuration (bf16 engine)
    with _Phase("main path, bf16 (default config)"):
        r16 = Renderer(scene2, cam, cfg, device=dev)
        first16, img, warm, ms, counts = _frame(r16, 3, engines)
        launches16 = counts["trace_bf16"][0]
        plain16 = sum(sum(c[1].values()) for c in counts.values())
        print(f"frame 1280x720 4 bounces AA bf16: warm-up {warm:.2f} s, median "
              f"{statistics.median(ms):.2f} ms over {ms} [{card}]", flush=True)
        print(f"main path (4 frames): B2 launches {launches16}, B1 launches "
              f"{counts['trace'][0]} (uncertain-lane retests), plain-version calls "
              f"{plain16}", flush=True)
        _check(launches16["closest"] > 0 and launches16["any"] > 0,
               "the bf16 main path did not launch both B2 modes")
        _check(plain16 == 0, "the bf16 main path called a plain version")
        _check(sum(counts["trace_rows"][0].values()) == 0, "the bf16 path launched B3")
        _check(sum(counts["leaf_mt"][0].values()) + counts["wave_scan"][0]["scan"]
               + sum(counts["wave_level"][0].values()) == 0,
               "the bf16 path launched a wave kernel")
        _check(img.shape == (720, 1280, 3) and bool(np.isfinite(img).all()),
               "bf16 image not finite or of the wrong shape")
        print(f"image finite, mean {float(img.mean()):.6f}", flush=True)
        _check(trace_bf16.truncated_rays(dev) == 0 and trace.truncated_rays(dev) == 0,
               "rays truncated on the bf16 main path")

    # 7. the main path with the f32 engine, and bf16 vs f32 frames
    with _Phase("main path, f32"):
        cfg32 = cfg.replace(leaf_precision="f32")
        r32 = Renderer(scene2, cam, cfg32, device=dev)
        first32, img, warm, ms, counts = _frame(r32, 1, engines)
        launches32 = counts["trace"][0]
        plain32 = sum(sum(c[1].values()) for c in counts.values())
        ms32 = ms[0]
        print(f"frame 1280x720 4 bounces AA f32: warm-up {warm:.2f} s, "
              f"{ms[0]:.2f} ms [{card}]", flush=True)
        print(f"main path (2 frames): B1 launches {launches32}, B2 launches "
              f"{counts['trace_bf16'][0]}, plain-version calls {plain32}", flush=True)
        _check(launches32["closest"] > 0 and launches32["any"] > 0,
               "the f32 main path did not launch both B1 modes")
        _check(sum(counts["trace_bf16"][0].values()) == 0, "the f32 path launched B2")
        _check(sum(counts["trace_rows"][0].values()) == 0, "the f32 path launched B3")
        _check(plain32 == 0, "the f32 main path called a plain version")
        _check(img.shape == (720, 1280, 3) and bool(np.isfinite(img).all()),
               "f32 image not finite or of the wrong shape")
        _check(trace.truncated_rays(dev) == 0, "rays truncated on the f32 main path")
        diff = np.abs(first16 - first32).max(axis=-1)
        mse = float(np.mean((first16 - first32) ** 2))
        off = float((diff > 0.05).mean())
        print(f"bf16 vs f32 frame (first ticks, same key): MSE {mse:.3e}, "
              f"{off * 100:.3f}% pixels off by > 0.05", flush=True)
        _check(mse < 2e-3 and off < 0.03, "bf16 frame vs f32 frame contract")

    # 18. the recorded frame chunk against the eager path
    with _Phase("recorded frame chunk"):
        graph_ms = _graph_path(dev, card, cfg)

    # 8. the main path with the row-parallel engine (B3), vs the f32 frame
    with _Phase("main path, pallas_rows"):
        cfg_rows = cfg.replace(traversal="pallas_rows")
        r_rows = Renderer(scene2, cam, cfg_rows, device=dev)
        first_rows, img, warm, ms, counts = _frame(r_rows, 1, engines)
        launches_rows = counts["trace_rows"][0]
        plain_rows = sum(sum(c[1].values()) for c in counts.values())
        print(f"frame 1280x720 4 bounces AA pallas_rows: warm-up {warm:.2f} s, "
              f"{ms[0]:.2f} ms [{card}]", flush=True)
        print(f"main path (2 frames): B3 launches {launches_rows}, B1 launches "
              f"{counts['trace'][0]}, B2 launches {counts['trace_bf16'][0]}, "
              f"plain-version calls {plain_rows}", flush=True)
        _check(launches_rows["closest"] > 0 and launches_rows["any"] > 0,
               "the pallas_rows main path did not launch both B3 modes")
        _check(sum(counts["trace"][0].values()) == 0
               and sum(counts["trace_bf16"][0].values()) == 0,
               "the pallas_rows main path launched B1 or B2")
        _check(plain_rows == 0, "the pallas_rows main path called a plain version")
        _check(trace_rows.truncated_rays(dev) == 0, "rays truncated on the rows main path")
        _check(img.shape == (720, 1280, 3) and bool(np.isfinite(img).all()),
               "pallas_rows image not finite or of the wrong shape")
        close = np.isclose(first_rows, first32, rtol=2e-4, atol=2e-5).all(axis=-1)
        print(f"pallas_rows vs f32 frame (first ticks, same key): {close.mean() * 100:.4f}% "
              f"pixels allclose ({int((~close).sum())} differ), max abs diff "
              f"{float(np.abs(first_rows - first32).max()):.3e}", flush=True)
        _check(close.mean() >= ROWS_FRAME_CLOSE, "pallas_rows frame vs f32 frame")

    # 10c. the main path with the wave engine, vs the f32 frame
    with _Phase("main path, wave"):
        cfg_wave = cfg.replace(traversal="wave")
        _check((cfg_wave.dense, cfg_wave.packet_tile, cfg_wave.wave_shrink,
                cfg_wave.max_stack_depth, cfg_wave.leaf_size, cfg_wave.sort_rays)
               == ("mt", 128, 8, 48, 16, True), "the wave config's defaults")
        r_wave = Renderer(scene_w, cam, cfg_wave, device=dev)
        traverse_packet.reset_counts()
        first_wave, img, warm, ms, counts = _frame(r_wave, 3, engines)
        waves = traverse_packet.collect_waves()
        levels = dict(traverse_packet.LEVELS)
        launches_level = counts["wave_level"][0]
        launches_b4, launches_scan = counts["leaf_mt"][0], counts["wave_scan"][0]
        plain_wave = sum(sum(c[1].values()) for c in counts.values())
        others = {k: counts[k][0] for k in ("trace", "trace_bf16", "trace_rows")}
        print(f"frame 1280x720 4 bounces AA wave: warm-up {warm:.2f} s, median "
              f"{statistics.median(ms):.2f} ms over {ms} [{card}]", flush=True)
        print(f"main path (4 frames): waves {waves}, levels {levels}, wave_level launches "
              f"{launches_level}, B4 launches {launches_b4}, scan launches {launches_scan}, "
              f"B1-B3 launches {others}, plain-version calls {plain_wave}", flush=True)
        _check(launches_level["closest"] > 0 and launches_level["any"] > 0,
               "the wave main path did not launch the fused level in both modes")
        _check(launches_level == levels, "the wave main path: not one fused launch per level")
        _check(waves["closest"] > 0 and waves["any"] > 0, "the wave main path ran no wave")
        _check(sum(launches_b4.values()) + launches_scan["scan"] == 0,
               "the wave main path launched the standalone B4 or scan kernel")
        _check(all(sum(v.values()) == 0 for v in others.values()),
               "the wave main path launched B1, B2 or B3")
        _check(plain_wave == 0, "the wave main path called a plain version")
        _check(wave_scan.truncated_pushes(dev) == 0, "stack overflow on the wave main path")
        _check(img.shape == (720, 1280, 3) and bool(np.isfinite(img).all()),
               "wave image not finite or of the wrong shape")
        close = np.isclose(first_wave, first32, rtol=2e-4, atol=2e-5).all(axis=-1)
        print(f"wave vs f32 frame (first ticks, same key): {close.mean() * 100:.4f}% "
              f"pixels allclose ({int((~close).sum())} differ), max abs diff "
              f"{float(np.abs(first_wave - first32).max()):.3e}", flush=True)
        _check(close.mean() >= WAVE_FRAME_CLOSE, "wave frame vs f32 frame")

    # 11. the command-line render path: sky, Panini + post, spp, AOVs,
    # sub-tile gates, the CLI itself
    with _Phase("command-line render path"):
        _cli_path(scene2, cam, cfg, dev, card, first32, ms32, engines)

    # 12. the dynamic-scene path: animate, kernels on refreshed tables,
    # refit, the edit session and the command line's last three flags
    with _Phase("dynamic-scene path") as ph:
        dyn = _dynamic_path(dev, card, cfg, engines, scene1, scene_w, sets)
    print(f"dynamic-scene path: {time.perf_counter() - ph.t0:.1f} s [{card}]", flush=True)

    # 9. GPU vs CPU chunks
    with _Phase("GPU vs CPU chunks"):
        _chunk_gpu_vs_cpu(r32, cfg32, F32_CHUNK, 0.99, "f32 engine")
        _chunk_gpu_vs_cpu(r16, cfg, BF16_CHUNK, 0.98, "bf16 engine")

    # 13. the differentiable path: the bench frame's gradient, card vs CPU,
    # FD checks, inverse rendering, checkpoint resume
    with _Phase("differentiable path") as ph:
        diff = _diff_path(dev, card, cfg, engines)
    print(f"differentiable path: {time.perf_counter() - ph.t0:.1f} s [{card}]", flush=True)

    # 15. the classic-BVH path: the lane and packet engines, hq dense
    # tables, the sort modes
    with _Phase("classic-BVH path") as ph:
        classic = _classic_path(dev, card, cfg, engines, scene1, scene2, handle2, scene_w,
                                cam, sets, first_wave, first32)
    print(f"classic-BVH path: {time.perf_counter() - ph.t0:.1f} s [{card}]", flush=True)

    # 16. the parallel path: one NCCL rank here, gloo ranks spawned on the
    # card, partitioned tracing, the sharded train step, profiling
    with _Phase("parallel path") as ph:
        par = _parallel_path(dev, card, cfg, engines, scene2, cam, handle2, sets)
    print(f"parallel path: {time.perf_counter() - ph.t0:.1f} s [{card}]", flush=True)

    # 17. the main path's parity gates: the converged bench image against
    # the JAX package's stored renders; the BRDFConfig matrix and the
    # oracle scenes, card vs CPU
    with _Phase("parity gates") as ph:
        with _Phase("converged mean"):
            conv = _converged_path(dev, card, engines)
        with _Phase("BRDFConfig matrix and oracle scenes, card vs CPU"):
            _parity_on_card(dev, card, engines)
    print(f"parity gates: {time.perf_counter() - ph.t0:.1f} s [{card}]", flush=True)

    # 14. result lines
    def err(eng, mode):
        if eng == "bf16":
            rep = rep_bf16
        else:
            rep = rep_f32 if eng == "f32" else rep_rows
        if mode == "closest":
            return max(r["t_max_abs"] for r in rep)
        return float(any(r["occ_mismatch"] for r in rep))

    def dyn_launches(module, mode):
        """The kernel's launches over phase 12 (the dynamic-scene path)."""
        return dyn["launches"].get(module, {}).get(mode, 0)

    def diff_launches(module, mode):
        """The kernel's launches over phase 13 (the differentiable path)."""
        return diff["launches"].get(module, {}).get(mode, 0)

    def classic_launches(module, mode):
        """The kernel's launches over phase 15 (the classic-BVH path)."""
        return classic["launches"].get(module, {}).get(mode, 0)

    def parallel_launches(module, mode):
        """The kernel's launches over phase 16 (the parallel path), summed
        over the ranks."""
        return par["launches"].get(module, {}).get(mode, 0)

    def converged_launches(module, mode):
        """The kernel's launches over phase 17a (the converged renders)."""
        return conv.get(module, {}).get(mode, 0)

    kernels = []
    for eng, launches in (("f32", launches32), ("bf16", launches16),
                          ("rows", launches_rows)):
        src, replaces = KERNELS[f"traverse_{eng}"]
        for mode, sname in report_sets.items():
            k_ms, p_ms = times[(eng, sname, mode)]
            b_ms, b_by = bounds[(eng, sname, mode)]
            # no single PyTorch call computes a BVH traversal
            kernels.append({"name": f"traverse_{eng}_{mode}", "route": "cuda",
                            "source": src, "replaces": replaces,
                            "launches": launches[mode], "max_abs_err": err(eng, mode),
                            "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
                            "bound_by": b_by, "library_ms": None,
                            "dynamic_path_launches": dyn_launches(MODULE_OF[eng], mode),
                            "diff_path_launches": diff_launches(MODULE_OF[eng], mode),
                            "classic_path_launches": classic_launches(MODULE_OF[eng], mode),
                            "parallel_path_launches": parallel_launches(MODULE_OF[eng], mode),
                            "converged_path_launches": converged_launches(MODULE_OF[eng],
                                                                          mode)})
            if eng == "rows":
                # diagnostic: the bound of the work B3's schedule does, and
                # the warps that left the shared walk
                kernels[-1]["schedule_bound_ms"], kernels[-1]["split_warps"] = \
                    schedule[(sname, mode)]
    # B4 and the scan kernel, timed on the heaviest checked wave of the sets
    # the other kernels report (the scan on the closest-hit run); the wave
    # main path now runs them inside the fused level, so their launches
    # there are 0
    for name, mode, launches in (("leaf_mt", "closest", launches_b4["closest"]),
                                 ("leaf_mt", "any", launches_b4["any"]),
                                 ("wave_scan", "closest", launches_scan["scan"])):
        src, replaces = KERNELS[name]
        w = wave_k[(name, report_sets[mode], mode)]
        entry = {"name": f"{name}_{mode}" if name == "leaf_mt" else name, "route": "cuda",
                 "source": src, "replaces": replaces, "launches": launches, **w,
                 "library_ms": None, "main_path": "inside wave_level",
                 "dynamic_path_launches": dyn_launches(name, "scan" if name == "wave_scan"
                                                       else mode),
                 "diff_path_launches": diff_launches(name, "scan" if name == "wave_scan"
                                                     else mode),
                 "classic_path_launches": classic_launches(name, "scan" if name == "wave_scan"
                                                           else mode),
                 "parallel_path_launches": parallel_launches(name, "scan" if name == "wave_scan"
                                                             else mode),
                 "converged_path_launches": converged_launches(name, "scan"
                                                               if name == "wave_scan" else mode)}
        if name == "wave_scan":
            entry["port_only"] = True      # replaces XLA code, not a TPU kernel
        kernels.append(entry)
    # the fused level, timed over the levels of each mode's heaviest call
    src, replaces = KERNELS["wave_level"]
    for mode in ("closest", "any"):
        (sname, w), = [(s_, v) for (k, s_, m), v in wave_k.items()
                       if k == "wave_level" and m == mode and v["heaviest"]]
        kernels.append({"name": f"wave_level_{mode}", "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches_level[mode],
                        **{k: v for k, v in w.items() if k != "heaviest"}, "set": sname,
                        "library_ms": None, "port_only": True,
                        "dynamic_path_launches": dyn_launches("wave_level", mode),
                        "diff_path_launches": diff_launches("wave_level", mode),
                        "classic_path_launches": classic_launches("wave_level", mode),
                        "parallel_path_launches": parallel_launches("wave_level", mode),
                        "converged_path_launches": converged_launches("wave_level", mode),
                        "registers": max((u["registers"] for u in level_use.values()),
                                         default=None),
                        "spill_bytes": sum(u["spill_bytes"] for u in level_use.values())
                        if level_use else None})
    # the row gather's backward (port-only), timed on the inverse step's
    # heaviest call (phase 13f); it runs on the differentiable path alone
    src, replaces = KERNELS["take_rows"]
    take_use = _ptxas_usage(_build.BUILD_INFO["take_rows"]["log"])
    kernels.append({"name": "take_rows", "route": "cuda", "source": src,
                    "replaces": replaces, "port_only": True,
                    "launches": diff["take_rows"]["step_launches"],
                    **{k: v for k, v in diff["take_rows"].items() if k != "step_launches"},
                    "library": "index_put_(accumulate=True)",
                    "diff_path_launches": diff["take_rows_launches"],
                    "registers": max((u["registers"] for u in take_use.values()),
                                     default=None),
                    "spill_bytes": sum(u["spill_bytes"] for u in take_use.values())
                    if take_use else None})
    print(f"chip_smoke total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"recorded_chunk_ms": graph_ms}), flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
