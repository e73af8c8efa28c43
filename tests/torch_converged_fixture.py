"""Render the converged-mean fixture of the port's parity gates with JAX.

The fixture is ``experiments/bf16_precision.py``'s renders, stored as images
so that the port can be held to them on the card without JAX: the bench
scene (``bench.py::build_bench_scene``), 160x90, 4 bounces, antialiasing,
one shadow ray, 48 ticks of ``Renderer.tick(jax.random.key(seed))`` and the
last returned image, once on the f32 engine and once on the bf16 engine,
both at seed 0. ``chip_smoke.py`` phase 17a renders the same config with
the port (f32 and bf16 at seed 0, f32 at seed 1 for the noise floor) and
compares; the size, the config and the statistics are that script's
(``CONV_*``, ``converged_fields``, ``image_stats``).
``tests/test_torch_converged.py`` checks the file.

Run from the repository root (CPU, ~18 min, JAX needed):

    python -m tests.torch_converged_fixture [--out PATH]

It writes ``tests/golden/bench_converged_160x90_48spp.npz`` with the two
images (float32, 90x160x3), the seed, spp, resolution, the config's fields
as JSON, the JAX version and the pair's statistics, and prints them beside
``docs/BF16_PRECISION_r05.json``'s.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

FIXTURE = os.path.join(ROOT, chip_smoke.CONV_FIXTURE)
SEED = 0


def render(leaf_precision, seed=SEED, spp=chip_smoke.CONV_SPP):
    """The JAX package's converged render of the bench scene; returns the
    last tick's image and the config's fields."""
    import jax

    from bench import build_bench_scene
    from physically_based_ray_tracer_tpu.config import RenderConfig
    from physically_based_ray_tracer_tpu.render.renderer import Renderer

    scene, cam, depth = build_bench_scene()
    fields = chip_smoke.converged_fields(depth)
    r = Renderer(scene, cam, RenderConfig(**fields, leaf_precision=leaf_precision))
    img = None
    for _ in range(spp):
        img = r.tick(jax.random.key(seed))
    return np.asarray(img, np.float32), fields


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=FIXTURE)
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    imgs, fields = {}, None
    for lp in ("f32", "bf16"):
        t0 = time.time()
        imgs[lp], fields = render(lp)
        print(lp, "done", round(time.time() - t0, 1), "s", flush=True)
    pair = chip_smoke.image_stats(imgs["bf16"], imgs["f32"])
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    np.savez_compressed(
        args.out, f32=imgs["f32"], bf16=imgs["bf16"],
        seed=np.int64(SEED), spp=np.int64(chip_smoke.CONV_SPP),
        resolution=np.array([chip_smoke.CONV_WIDTH, chip_smoke.CONV_HEIGHT], np.int64),
        config=np.array(json.dumps(fields, sort_keys=True)),
        jax_version=np.array(jax.__version__),
        bf16_vs_f32=np.array(json.dumps(pair, sort_keys=True)))
    with open(os.path.join(ROOT, "docs", "BF16_PRECISION_r05.json")) as fh:
        ref = json.load(fh)["bf16_vs_f32"]
    print(json.dumps(dict(fixture=os.path.relpath(args.out, ROOT),
                          jax_version=jax.__version__, config=fields,
                          bf16_vs_f32=pair, docs_bf16_vs_f32=ref,
                          rel_mse=pair["mse"] / ref["mse"] - 1.0,
                          rel_mean_abs=pair["mean_abs"] / ref["mean_abs"] - 1.0),
                     indent=1))


if __name__ == "__main__":
    main()
