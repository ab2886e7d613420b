"""The port's threefry key chain (``core/threefry.py``) bit-equal to
``jax.random`` on numpy-seeded keys: ``PRNGKey``, ``split``, ``fold_in``,
``random_bits``, ``uniform``, ``bernoulli``, ``randint`` and
``permutation``, each held against ``jax.vmap`` of the JAX function.
Tolerance 0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_torch.core import threefry

N_KEYS = 64


def _keys(seed, n=N_KEYS):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 2**32, size=(n, 2), dtype=np.uint64).astype(
        np.uint32
    )


def _t(a):
    return torch.from_numpy(np.asarray(a).astype(np.int64))


def _assert_same(jax_out, port_out):
    a = np.asarray(jax_out)
    b = port_out.numpy()
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype == np.float32:
        assert b.dtype == np.float32
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    else:
        np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64))


def test_partitionable_threefry_is_on():
    # The port reproduces the partitionable key chain; a change of JAX's
    # default would change every draw of the JAX package's generic path.
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", [0, 1, 7, 2**31 - 1, 2**31 + 5, -1, 2**40])
def test_prng_key(seed):
    _assert_same(jax.random.PRNGKey(seed), threefry.PRNGKey(seed))


@pytest.mark.parametrize("num", [2, 3, 17, (2, 3), 1025])
def test_split(num):
    K = _keys(1)
    _assert_same(jax.vmap(lambda k: jax.random.split(k, num))(K),
                 threefry.split(_t(K), num))


def test_split_of_one_key_and_of_a_key_grid():
    K = _keys(2, 12)
    _assert_same(jax.random.split(K[0], 5), threefry.split(_t(K[0]), 5))
    grid = K.reshape(3, 4, 2)
    _assert_same(
        jax.vmap(jax.vmap(lambda k: jax.random.split(k, 2)))(grid),
        threefry.split(_t(grid), 2),
    )


def test_fold_in_per_lane_and_scalar_data():
    K = _keys(3)
    rng = np.random.default_rng(3)
    data = rng.integers(0, 2**32, size=N_KEYS, dtype=np.uint64).astype(
        np.uint32
    )
    _assert_same(jax.vmap(jax.random.fold_in)(K, data),
                 threefry.fold_in(_t(K), _t(data)))
    for d in (0, 1, 1000, 2**32 - 1):
        _assert_same(jax.vmap(lambda k: jax.random.fold_in(k, d))(K),
                     threefry.fold_in(_t(K), d))


@pytest.mark.parametrize("shape", [(), (5,), (2, 17, 17)])
def test_random_bits(shape):
    from jax._src import prng as jprng

    K = _keys(4)
    jb = jax.vmap(
        lambda k: jprng.threefry_random_bits(k, 32, shape)
    )(K)
    _assert_same(jb, threefry.random_bits(_t(K), shape))


@pytest.mark.parametrize("shape", [(), (5,), (2, 17, 17)])
@pytest.mark.parametrize("seed", [5, 50, 500])
def test_uniform(shape, seed):
    # [0, 1), the only bounds the ported envs draw with.
    K = _keys(seed)
    _assert_same(jax.vmap(lambda k: jax.random.uniform(k, shape))(K),
                 threefry.uniform(_t(K), shape))


@pytest.mark.parametrize("shape", [(), (4,)])
@pytest.mark.parametrize("p", [0.5, 0.3, 0.0, 1.0])
def test_bernoulli(shape, p):
    # The default 'low' mode: uniform(key, shape) < p in float32.
    K = _keys(9, 4096)
    _assert_same(jax.vmap(lambda k: jax.random.bernoulli(k, p, shape))(K),
                 threefry.bernoulli(_t(K), p, shape))


def test_bernoulli_with_a_tensor_p():
    K = _keys(10)
    p = np.random.default_rng(10).random((N_KEYS, 3)).astype(np.float32)
    _assert_same(jax.vmap(lambda k, q: jax.random.bernoulli(k, q))(K, p),
                 threefry.bernoulli(_t(K), torch.from_numpy(p), (3,)))


@pytest.mark.parametrize("shape", [(), (7,), (2, 17, 17)])
@pytest.mark.parametrize("lo,hi", [
    (0, 5), (1, 5), (0, 10), (-3, 4), (-100, -7), (5, 5), (7, 3),
    (0, 2**20 + 3), (-2**31, 2**31 - 1),
])
def test_randint(shape, lo, hi):
    K = _keys(6)
    _assert_same(
        jax.vmap(lambda k: jax.random.randint(k, shape, lo, hi,
                                              dtype=jnp.int32))(K),
        threefry.randint(_t(K), shape, lo, hi),
    )


def test_randint_batched_shape_from_one_key():
    # ``ma_rollout``'s default policy: one key, a [B, n] draw.
    K = _keys(7, 3)
    for k in K:
        _assert_same(jax.random.randint(k, (33, 2), 0, 5, dtype=jnp.int32),
                     threefry.randint(_t(k), (33, 2), 0, 5))


@pytest.mark.parametrize("n", [1, 2, 3, 4, 300, 2000])
def test_permutation(n):
    # n = 2000 takes two sort rounds (ceil(3 ln n / ln(2**32 - 1)) = 2).
    K = _keys(8)
    _assert_same(jax.vmap(lambda k: jax.random.permutation(k, n))(K),
                 threefry.permutation(_t(K), n))
