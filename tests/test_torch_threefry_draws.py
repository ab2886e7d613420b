"""The draws the generic learners add to ``core/threefry.py``, held against
``jax.random`` on numpy-seeded keys: ``uniform`` with a range, ``normal``,
``gumbel`` and ``categorical``, and ``permutation`` at the learner's sizes
(``n_steps * B`` = 2,048 at the CPU gate's size, 131,072 at the card's).

Tolerances: ranged ``uniform``, ``categorical`` and ``permutation`` exact.
``normal`` within 3 ulps, with at most 2% of the values differing: the
port writes XLA's ``erf_inv`` polynomial out (each multiply-add fused as
XLA's on the CPU), but ``log1p`` is ATen's, which differs from XLA's in
the last bits. ``gumbel`` within 4 float32 ulps of max(1, |value|): its
two ``log``s are ATen's, 1 ulp from XLA's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_torch.core import threefry
from torch_threads import one_torch_thread  # noqa: F401

N_KEYS = 128


def _keys(seed, n=N_KEYS):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(n, 2), dtype=np.uint64).astype(
        np.uint32
    )


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _ulps(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("lo,hi", [
    (0.0, 1.0), (-1.0, 1.0), (-3.5, 2.25), (0.1, 0.7), (5.0, 1e4),
    (float(np.finfo(np.float32).tiny), 1.0),
    (float(np.nextafter(np.float32(-1), np.float32(0))), 1.0),
])
def test_ranged_uniform_bit_equal(lo, hi):
    K = _keys(1)
    want = jax.vmap(
        lambda k: jax.random.uniform(k, (64,), minval=lo, maxval=hi))(K)
    got = threefry.uniform(_t(K), (64,), lo, hi).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.asarray(want).view(np.uint32),
                                  got.view(np.uint32))
    assert (got >= np.float32(lo)).all()


def test_normal_within_three_ulps():
    K = _keys(2)
    want = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (512,)))(K))
    got = threefry.normal(_t(K), (512,)).numpy()
    ulps = _ulps(want, got)
    assert ulps.max() <= 3, ulps.max()
    assert (ulps > 0).mean() <= 0.02, (ulps > 0).mean()
    # The tails (|x| > 3, erf_inv's second branch) are drawn too.
    assert (np.abs(want) > 3).any()


def test_normal_of_one_key_and_a_shape():
    k = _keys(3, 1)[0]
    want = np.asarray(jax.random.normal(jnp.asarray(k), (48, 17)))
    got = threefry.normal(_t(k), (48, 17)).numpy()
    assert got.shape == (48, 17)
    assert _ulps(want, got).max() <= 3


def test_gumbel_within_four_ulps():
    K = _keys(4)
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (256,)))(K))
    got = threefry.gumbel(_t(K), (256,)).numpy()
    spacing = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert (np.abs(want - got) <= 4 * spacing).all()


def test_categorical_per_key_and_of_one_key():
    K = _keys(5)
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(N_KEYS, 100, 5)).astype(np.float32)
    want = jax.vmap(jax.random.categorical)(K, logits)
    got = threefry.categorical(_t(K), torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(want), got.numpy())
    # One key over a batch of rows, as the learners draw a step's actions.
    want = jax.random.categorical(jnp.asarray(K[0]), logits[0])
    got = threefry.categorical(_t(K[0]), torch.from_numpy(logits[0]))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


def test_categorical_first_index_on_a_tie():
    logits = np.full((64, 4), -1e30, np.float32)
    logits[:, 1] = logits[:, 2] = 0.0
    k = _keys(6, 1)[0]
    want = jax.random.categorical(jnp.asarray(k), logits)
    got = threefry.categorical(_t(k), torch.from_numpy(logits))
    np.testing.assert_array_equal(np.asarray(want), got.numpy())


@pytest.mark.parametrize("n", [2048, 131072])
def test_permutation_at_the_learners_sizes(n):
    K = _keys(7, 2)
    for k in K:
        want = np.asarray(jax.random.permutation(jnp.asarray(k), n))
        got = threefry.permutation(_t(k), n)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(want, got.numpy())
