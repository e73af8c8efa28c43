"""Port RNG vs the JAX package's utils/rng.py: bit-identical streams."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from physically_based_ray_tracer_tpu.utils import rng as jrng  # noqa: E402
from physically_based_ray_tracer_tpu_torch.utils import rng as trng  # noqa: E402


@pytest.mark.parametrize("key,sample,bounce,purpose", [
    (0, 0, 0, 0), (0, 1, 2, 3), (7, 5, 3, 101), (12345, 17, 0, 112),
    (2**31 - 1, 1000, 7, 6)])
def test_stream_seed_matches_threefry(key, sample, bounce, purpose):
    want = int(jrng.stream_seed(jax.random.key(key), sample, bounce, purpose))
    assert trng.stream_seed(key, sample, bounce, purpose) == want


@pytest.mark.parametrize("sample,bounce", [(0, 0), (3, 1), (11, 3)])
def test_uniform_bit_identical(sample, bounce):
    """Every Purpose, pixel ids up to 2 * n_pixels (the AA-doubled batch of
    the 1280x720 frame): exact equality of the float32 bits."""
    n_pixels = 1280 * 720
    gen = np.random.default_rng(sample * 10 + bounce)
    ids = np.concatenate([np.arange(64), gen.integers(0, 2 * n_pixels, 4096),
                          [2 * n_pixels - 1]]).astype(np.int32)
    key = jax.random.key(5)
    assert ([(p.name, p.value) for p in trng.Purpose]
            == [(p.name, p.value) for p in jrng.Purpose])
    for purpose in trng.Purpose:
        want1 = np.asarray(jrng.uniform1(key, jnp.asarray(ids), sample, bounce, purpose))
        got1 = trng.uniform1(5, torch.from_numpy(ids), sample, bounce, purpose).numpy()
        assert got1.dtype == np.float32
        np.testing.assert_array_equal(got1.view(np.uint32), want1.view(np.uint32))
        want2 = np.asarray(jrng.uniform2(key, jnp.asarray(ids), sample, bounce, purpose))
        got2 = trng.uniform2(5, torch.from_numpy(ids), sample, bounce, purpose).numpy()
        np.testing.assert_array_equal(got2.view(np.uint32), want2.view(np.uint32))
