"""The port's camera (Panini projection, skydome sampling) and
post-processing pass against the JAX package's, plus the JAX package's own
camera and tonemap tests replayed on the port.

Inputs come from numpy seeds. Tolerances: elementwise functions agree to
rtol 1e-5 / atol 1e-6 (the same float32 operations; sin, cos, atan2, acos
and pow may differ by an ulp or two between XLA:CPU and PyTorch); the
Panini directions, unit vectors, to atol 1e-5 (its sin = sqrt(1 - cos^2)
cancels near the image centre and turns an ulp of cos into ~1e-6 of a
small component); the bilinear sky lookup to atol 1e-5 relative to the
sky's largest radiance (an ulp of u or v moves the weights); index-only
functions (aberration, grading) agree exactly."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from physically_based_ray_tracer_tpu.ops import tonemap as jtonemap  # noqa: E402
from physically_based_ray_tracer_tpu.scene import camera as jcamera  # noqa: E402
from physically_based_ray_tracer_tpu.utils import image as jimage  # noqa: E402
from physically_based_ray_tracer_tpu_torch.ops import tonemap  # noqa: E402
from physically_based_ray_tracer_tpu_torch.scene.camera import (  # noqa: E402
    Camera, camera_basis, panini_projection, primary_rays, sample_skybox)
from physically_based_ray_tracer_tpu_torch.utils.image import read_hdr, write_hdr  # noqa: E402
from tests.torch_port import SKY_FIXTURE, port_camera  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
PANINI_ATOL = 1e-5


def _cam(**kw):
    return Camera.make(device="cpu", **kw)


@pytest.mark.parametrize("fov,distortion", [(40.0, 40.0), (90.0, 2.0), (60.0, 0.5)])
def test_panini_projection_matches_jax(fov, distortion):
    ndc = np.random.default_rng(0).uniform(-1, 1, (4096, 2)).astype(np.float32)
    fov_rad = np.float32(fov * (jcamera.PI / 180.0))
    want = np.asarray(jcamera.panini_projection(jnp.asarray(ndc), jnp.float32(fov_rad),
                                                jnp.float32(distortion)))
    got = panini_projection(torch.from_numpy(ndc), torch.tensor(fov_rad),
                            torch.tensor(np.float32(distortion))).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=PANINI_ATOL)


@pytest.mark.parametrize("panini", [False, True])
def test_primary_rays_match_jax(panini):
    gen = np.random.default_rng(1)
    xs = gen.uniform(0, 64, 4096).astype(np.float32)
    ys = gen.uniform(0, 36, 4096).astype(np.float32)
    jcam = jcamera.Camera.make(pos=(0.3, 1.5, 4.0), target=(0, 0.2, 0), fov=90.0,
                               distortion=2.0)
    jo, jd = jcamera.primary_rays(jcam, jnp.asarray(xs), jnp.asarray(ys), 64, 36,
                                  panini=panini)
    o, d = primary_rays(port_camera(jcam), torch.from_numpy(xs), torch.from_numpy(ys),
                        64, 36, panini=panini)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=RTOL, atol=PANINI_ATOL)


def test_sky_fixture_reads_as_in_jax():
    np.testing.assert_array_equal(read_hdr(SKY_FIXTURE), jimage.read_hdr(SKY_FIXTURE))


def test_sample_skybox_matches_jax():
    """4096 random unit directions on the repo's sky fixture, the poles and
    the seam (u wraps at atan2 = +-pi) included."""
    sky = read_hdr(SKY_FIXTURE)
    d = np.random.default_rng(2).normal(size=(4096, 3)).astype(np.float32)
    d[:4] = [[0, 1, 0], [0, -1, 0], [-1, 0, 0], [-1, 0, -1e-7]]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = np.asarray(jcamera.sample_skybox(jnp.asarray(sky), jnp.asarray(d)))
    got = sample_skybox(torch.from_numpy(sky), torch.from_numpy(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-5 * float(sky.max()))


def test_hdr_write_read_roundtrip(tmp_path):
    """write_hdr then read_hdr, as the JAX package's pair does it."""
    img = np.random.default_rng(3).uniform(0, 50, (5, 9, 3)).astype(np.float32)
    p = str(tmp_path / "sky.hdr")
    write_hdr(p, img)
    jimage.write_hdr(str(tmp_path / "jsky.hdr"), img)
    assert open(p, "rb").read() == open(tmp_path / "jsky.hdr", "rb").read()
    np.testing.assert_array_equal(read_hdr(p), jimage.read_hdr(p))


# --- tests/test_camera.py, replayed on the port ------------------------------

def test_center_ray_points_ahead():
    cam = _cam(pos=(1, 2, 3), target=(1, 2, 0))
    o, d = primary_rays(cam, torch.tensor([64.0]), torch.tensor([36.0]), 128, 72)
    np.testing.assert_allclose(o.numpy()[0], [1, 2, 3], rtol=1e-6)
    np.testing.assert_allclose(d.numpy()[0], [0, 0, -1], atol=1e-5)


def test_corner_rays_match_reference_plane():
    cam = _cam(pos=(0, 0, 0), target=(0, 0, -1))
    basis = camera_basis(cam, aspect=2.0)
    _, d = primary_rays(cam, torch.tensor([0.0]), torch.tensor([0.0]), 128, 64)
    want = basis.top_left.numpy() / np.linalg.norm(basis.top_left.numpy())
    np.testing.assert_allclose(d.numpy()[0], want, atol=1e-6)


def test_rays_normalized():
    cam = _cam(pos=(0, 1, 4), target=(0, 0, 0))
    xs = torch.from_numpy(np.random.default_rng(0).uniform(0, 128, 100).astype(np.float32))
    ys = torch.from_numpy(np.random.default_rng(1).uniform(0, 72, 100).astype(np.float32))
    _, d = primary_rays(cam, xs, ys, 128, 72)
    np.testing.assert_allclose(np.linalg.norm(d.numpy(), axis=1), 1.0, atol=1e-5)


def test_panini_center_is_forward():
    d = panini_projection(torch.tensor([[0.0, 0.0]]), np.pi / 4, 2.0).numpy()
    np.testing.assert_allclose(d[0], [0, 0, 1], atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(d, axis=-1), 1.0, atol=1e-5)


def test_panini_rays_normalized_and_finite():
    cam = _cam(pos=(0, 0, 0), target=(0, 0, -1))
    xs = torch.linspace(0, 127, 16)
    ys = torch.linspace(0, 71, 16)
    _, d = primary_rays(cam, xs, ys, 128, 72, panini=True)
    d = d.numpy()
    assert np.isfinite(d).all()
    np.testing.assert_allclose(np.linalg.norm(d, axis=1), 1.0, atol=1e-4)


def test_skybox_constant():
    sky = torch.full((8, 16, 3), 0.7)
    d = torch.tensor([[0, 1, 0], [0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=torch.float32)
    np.testing.assert_allclose(sample_skybox(sky, d).numpy(), 0.7, rtol=1e-5)


def test_skybox_gradient_vertical():
    h, w = 16, 32
    grad = (np.linspace(0, 1, h, dtype=np.float32)[:, None, None]
            * np.ones((1, w, 3), np.float32))
    sky = torch.from_numpy(grad)
    up = float(sample_skybox(sky, torch.tensor([[0.14, 0.99, 0.0]]))[0, 0])
    down = float(sample_skybox(sky, torch.tensor([[0.14, -0.99, 0.0]]))[0, 0])
    assert up < 0.2 and down > 0.6


def test_hdr_reader_roundtrip(tmp_path):
    h, w = 4, 8
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.random.default_rng(0).integers(10, 255, (h, w, 3))
    rgbe[..., 3] = 128
    path = tmp_path / "t.hdr"
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())
    img = read_hdr(str(path))
    assert img.shape == (h, w, 3)
    np.testing.assert_allclose(img, rgbe[..., :3].astype(np.float32) * 2.0 ** -8, rtol=1e-6)


# --- ops/tonemap.py against the JAX package's --------------------------------

def _img(seed=4, shape=(36, 64, 3)):
    return np.random.default_rng(seed).uniform(0, 1.5, shape).astype(np.float32)


@pytest.mark.parametrize("intensity", [-3, -1, 0, 2])
def test_chromatic_aberration_matches_jax(intensity):
    img = _img()
    want = np.asarray(jtonemap.chromatic_aberration(jnp.asarray(img), intensity))
    got = tonemap.chromatic_aberration(torch.from_numpy(img), intensity).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("intensity,radius", [(20.0, 0.3), (5.5, 0.8)])
def test_vignette_matches_jax(intensity, radius):
    img = _img()
    want = np.asarray(jtonemap.vignette(jnp.asarray(img), intensity, radius))
    got = tonemap.vignette(torch.from_numpy(img), intensity, radius).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_color_grade_and_aces_match_jax():
    img = _img()
    np.testing.assert_array_equal(
        tonemap.color_grade(torch.from_numpy(img), (1.0, 1.0, 1.2)).numpy(),
        np.asarray(jtonemap.color_grade(jnp.asarray(img), (1.0, 1.0, 1.2))))
    x = np.linspace(0, 10, 300, dtype=np.float32).reshape(100, 1, 3)
    np.testing.assert_allclose(tonemap.aces(torch.from_numpy(x)).numpy(),
                               np.asarray(jtonemap.aces(jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("preset", [1, 2])
def test_post_process_preset_matches_jax(preset):
    assert tonemap.POST_PRESETS == jtonemap.POST_PRESETS
    pp = tonemap.POST_PRESETS[preset]
    kw = dict(aberration_intensity=pp["aberration_intensity"],
              vignette_intensity=pp["vignette_intensity"],
              vignette_radius=pp["vignette_radius"], grading=pp["grading"])
    img = _img()
    want = np.asarray(jtonemap.post_process(jnp.asarray(img), **kw))
    got = tonemap.post_process(torch.from_numpy(img), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


# --- tests/test_tonemap.py, replayed on the port -----------------------------

def test_aberration_zero_is_identity():
    img = torch.from_numpy(np.random.default_rng(0).uniform(0, 1, (8, 8, 3)).astype(np.float32))
    np.testing.assert_array_equal(tonemap.chromatic_aberration(img, 0).numpy(), img.numpy())


def test_aberration_shifts_red_blue_only():
    img = np.zeros((4, 8, 3), np.float32)
    img[:, 4] = [1.0, 1.0, 1.0]
    out = tonemap.chromatic_aberration(torch.from_numpy(img), 2).numpy()
    np.testing.assert_array_equal(out[:, :, 1], img[:, :, 1])
    assert np.isclose(out[0, 4, 0], 0.75)
    assert np.isclose(out[0, 2, 0], 0.25)


def test_vignette_darkens_corners_more_than_center():
    out = tonemap.vignette(torch.ones((16, 16, 3)), 20.0, 0.3).numpy()
    assert out[8, 8, 0] > out[0, 0, 0]
    assert out[0, 0, 0] >= 0.0


def test_color_grade():
    out = tonemap.color_grade(torch.ones((2, 2, 3)), (1.0, 0.5, 2.0)).numpy()
    np.testing.assert_allclose(out[0, 0], [1.0, 0.5, 2.0])


def test_aces_range():
    x = torch.linspace(0, 10, 50)[:, None] * torch.ones((1, 3))
    y = tonemap.aces(x).numpy()
    assert (y >= 0).all() and (y <= 1.0).all()
    assert y[-1, 0] > 0.95


def test_full_chain_shapes():
    out = tonemap.post_process(torch.ones((8, 8, 3)), aberration_intensity=1)
    assert out.shape == (8, 8, 3)
    assert np.isfinite(out.numpy()).all()
