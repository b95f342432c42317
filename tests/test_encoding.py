"""Positional encoding golden tests (SURVEY.md §4 item 1; reference layout
at /root/reference/nerf/encoding.py:15-20: [x, sin(2^j x), cos(2^j x)]
interleaved per frequency, no pi factor, identity included)."""

import numpy as np
import jax.numpy as jnp

from nerf_jax.models.encoding import encoded_dim, positional_encoding


def reference_encoding_numpy(x: np.ndarray, L: int) -> np.ndarray:
    out = [x]
    for j in range(L):
        out.append(np.sin(2.0**j * x))
        out.append(np.cos(2.0**j * x))
    return np.concatenate(out, axis=-1)


def test_matches_reference_layout():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(17, 3)).astype(np.float32)
    for L in (1, 4, 10):
        got = np.asarray(positional_encoding(jnp.asarray(x), L))
        want = reference_encoding_numpy(x, L)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_dims():
    assert encoded_dim(3, 10) == 63
    assert encoded_dim(3, 4) == 27
    x = jnp.ones((5, 3))
    assert positional_encoding(x, 10).shape == (5, 63)
    assert positional_encoding(x, 0).shape == (5, 3)


def test_identity_block_first():
    x = jnp.asarray(np.random.default_rng(1).normal(size=(4, 3)).astype(np.float32))
    enc = positional_encoding(x, 6)
    np.testing.assert_array_equal(np.asarray(enc[:, :3]), np.asarray(x))


def test_batched_leading_dims():
    x = jnp.ones((2, 5, 3))
    assert positional_encoding(x, 4).shape == (2, 5, 27)
