"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card skipped, the rest of a run driven on the CPU at
a tiny size, against the cells' own limits. One case per fault a cell can
have: a step that returns its state unchanged, half of the batch left out
(the mean taken over the rest), an answer altered where it is produced.
(The exchange between chips is no fault of a one-chip cell.)"""

from __future__ import annotations

import pytest
import torch

from pbrt_bench.tests.bench_fixtures import target_cache, tiny_run  # noqa: F401 (fixture)

FILM = "physically_based_ray_tracer_tpu_torch.render.film"
RENDERER = "physically_based_ray_tracer_tpu_torch.render.renderer"
GRAD = "physically_based_ray_tracer_tpu_torch.diff.grad"
INVERSE = "physically_based_ray_tracer_tpu_torch.diff.inverse"


def _film_unchanged(monkeypatch):
    import importlib
    film = importlib.import_module(FILM)
    real = film.update

    def update(f, color, primary_t, cfg, depth_keyed=None):
        _, avg = real(f, color, primary_t, cfg, depth_keyed)
        return f, avg
    monkeypatch.setattr(film, "update", update)


def _frame_half_batch(monkeypatch):
    import importlib
    r = importlib.import_module(RENDERER)
    real = r.render_chunked

    def render_chunked(scene, cam, cfg, key, sample, pixel_ids):
        h = pixel_ids.shape[0] // 2
        color, t = real(scene, cam, cfg, key, sample, pixel_ids[:h])
        return torch.cat([color, color[:pixel_ids.shape[0] - h]]), torch.cat(
            [t, t[:pixel_ids.shape[0] - h]])
    monkeypatch.setattr(r, "render_chunked", render_chunked)


def _frame_altered(monkeypatch):
    import importlib
    r = importlib.import_module(RENDERER)
    real = r.render_chunked

    def render_chunked(*args):
        color, t = real(*args)
        return color * 1.01, t
    monkeypatch.setattr(r, "render_chunked", render_chunked)


@pytest.mark.parametrize("cell", ["bench-bf16-frames", "cornell-bf16-frames",
                                  "bench-f32-frames"])
@pytest.mark.parametrize("fault", [_film_unchanged, _frame_half_batch, _frame_altered],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
def test_frame_fault_caught(cell, fault, monkeypatch):
    fault(monkeypatch)
    _, checks, _ = tiny_run(cell, 16, 9)
    off, limit = checks["pixels_off"]
    assert off > limit


def _step_unchanged(monkeypatch):
    import importlib
    grad = importlib.import_module(GRAD)
    real = grad.adam

    def adam(params, lr):
        opt = real(params, lr)
        opt.step = lambda closure=None: None
        return opt
    monkeypatch.setattr(grad, "adam", adam)


def _step_half_batch(monkeypatch):
    import importlib
    inv = importlib.import_module(INVERSE)
    real = inv.render_color

    def render_color(scene, cam, cfg, key, sample, pixel_ids):
        h = pixel_ids.shape[0] // 2
        color = real(scene, cam, cfg, key, sample, pixel_ids[:h])
        return torch.cat([color, color])[:pixel_ids.shape[0]]
    monkeypatch.setattr(inv, "render_color", render_color)


def _step_altered(monkeypatch):
    import importlib
    inv = importlib.import_module(INVERSE)
    real = inv.render_color
    monkeypatch.setattr(inv, "render_color", lambda *a: real(*a) * 1.01)


@pytest.mark.parametrize("fault", [_step_unchanged, _step_half_batch, _step_altered],
                         ids=["state_unchanged", "half_batch", "answer_altered"])
def test_step_fault_caught(fault, monkeypatch, target_cache):
    fault(monkeypatch)
    _, checks, _ = tiny_run("bench-inverse-steps", 16, 9, batch_pixels=64)
    assert any(v > lim for v, lim in checks.values()), checks
