"""ops/gather.py: the clipped gather the device kernels share must equal
NumPy's ``x[clip(idx)]`` on every dtype and index shape they use."""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")

from tbz.ops import gather as G  # noqa: E402


@pytest.mark.parametrize("dtype", [np.int32, np.uint32, np.uint8])
@pytest.mark.parametrize("n", [16, 100, 1 << 15])
def test_take1d_matches_native(dtype, n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, 200, n).astype(dtype)
    idx = rng.integers(-5, n + 5, 4096).astype(np.int32)  # incl. OOB
    got = np.asarray(G.take(jnp.asarray(x), jnp.asarray(idx)))
    assert np.array_equal(got, x[np.clip(idx, 0, n - 1)])
    assert got.dtype == x.dtype


def test_take1d_2d_index_shape():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 1 << 20, 1 << 12).astype(np.int32)
    idx = rng.integers(-3, (1 << 12) + 3, (64, 33)).astype(np.int32)
    got = np.asarray(G.take(jnp.asarray(x), jnp.asarray(idx)))
    assert got.shape == (64, 33)
    assert np.array_equal(got, x[np.clip(idx, 0, x.shape[0] - 1)])


def test_take_rows_clipped():
    """2D x: whole rows, clipped on axis 0 (the width-8 field rows of
    the resolvers)."""
    rng = np.random.default_rng(1)
    x = rng.integers(0, 1 << 30, (100, 8)).astype(np.int32)
    idx = rng.integers(-4, 104, 777).astype(np.int32)
    got = np.asarray(G.take(jnp.asarray(x), jnp.asarray(idx)))
    assert np.array_equal(got, x[np.clip(idx, 0, 99)])
