"""The port's counter-based PRF against the JAX package's, word for word.

Inputs are uint32 grids made with numpy from a seed (edge values included)
and handed to both packages; words and uniforms must be bit-identical
(tolerance 0). The distribution checks mirror ``tests/test_prng.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ai_safety_gridworlds_torch.ops import prng as tprng
from ai_safety_gridworlds_tpu.ops import prng as jprng

EDGES = np.array(
    [0, 1, 2, 0x7FFF_FFFF, 0x8000_0000, 0xFFFF_FFFE, 0xFFFF_FFFF], np.uint32
)


def _grid(seed, n=4096):
    rng = np.random.default_rng(seed)
    cols = []
    for _ in range(4):
        g = rng.integers(0, 2**32, size=n, dtype=np.uint32)
        g[: len(EDGES)] = rng.permutation(EDGES)
        cols.append(g)
    return cols


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_words_bit_identical_to_jax(seed):
    kh, kl, ctr, idx = _grid(seed)
    want = np.asarray(jprng.hash_u32(kh, kl, ctr, idx))
    got = tprng.hash_u32(*(torch.from_numpy(a) for a in (kh, kl, ctr, idx)))
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tprng.uniform01(got).numpy(), np.asarray(jprng.uniform01(want))
    )


def test_edge_value_cross_product_bit_identical():
    """Every combination of uint32 edge values in all four arguments."""
    grids = np.meshgrid(EDGES, EDGES, EDGES, EDGES, indexing="ij")
    args = [g.ravel() for g in grids]
    want = np.asarray(jprng.hash_u32(*args))
    got = tprng.hash_u32(*(torch.from_numpy(a) for a in args)).numpy()
    np.testing.assert_array_equal(got, want)


def test_broadcast_grid_as_in_the_step():
    """Keys and counter per lane [1, B], index per cell [HW, 1]: the shape
    of a sub-step's fire draw."""
    rng = np.random.default_rng(5)
    B, HW = 64, 289
    key = rng.integers(0, 2**32, size=(2, B), dtype=np.uint32)
    ctr = rng.integers(0, 2**32, size=(1, B), dtype=np.uint32)
    idx = np.arange(HW, dtype=np.uint32).reshape(HW, 1)
    want = np.asarray(jprng.uniform(key[0:1], key[1:2], ctr, idx))
    tkey = torch.from_numpy(key)
    got = tprng.uniform(
        tkey[0:1], tkey[1:2], torch.from_numpy(ctr),
        torch.arange(HW, dtype=torch.int32).view(HW, 1),
    )
    assert got.shape == (HW, B) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_derive_keys_equal():
    for seed, batch in ((0, 7), (3, 256), (12345, 1000)):
        np.testing.assert_array_equal(
            tprng.derive_keys(seed, batch), jprng.derive_keys(seed, batch)
        )


def test_prf_words_cpu_takes_the_plain_version():
    kh, kl, ctr, idx = (torch.from_numpy(a) for a in _grid(9, 512))
    before = tprng.prf_words.launches
    words, u = tprng.prf_words(kh, kl, ctr, idx)
    assert tprng.prf_words.launches == before  # no kernel on the CPU
    assert torch.equal(words.to(torch.int64),
                       tprng.hash_u32(kh, kl, ctr, idx).to(torch.int64))
    assert torch.equal(u, tprng.uniform01(words))


def test_prf_words_rejects_bad_inputs():
    a = torch.zeros(8, dtype=torch.uint32)
    with pytest.raises(TypeError):
        tprng.prf_words(a, a, a, torch.zeros(8, dtype=torch.int64))
    with pytest.raises(ValueError):
        tprng.prf_words(a, a, a, torch.zeros(4, dtype=torch.uint32))


# ------------------------------------------- mirrors of tests/test_prng.py


def _uniforms(n, key_hi=0x1234, key_lo=0x5678, site=0):
    idx = torch.arange(n, dtype=torch.int64).view(n, 1)
    return tprng.uniform(key_hi, key_lo, site, idx).numpy().ravel()


def test_uniform_range_and_moments():
    u = _uniforms(1 << 16)
    assert (u >= 0).all() and (u < 1).all()
    assert abs(u.mean() - 0.5) < 0.01
    assert abs(u.var() - 1.0 / 12.0) < 0.01


def test_chi_square_uniformity():
    u = _uniforms(1 << 16, site=3)
    counts, _ = np.histogram(u, bins=64, range=(0, 1))
    expected = len(u) / 64
    chi2 = ((counts - expected) ** 2 / expected).sum()
    assert chi2 < 103.4, chi2  # 63 dof, 99.9th percentile


def test_site_and_key_decorrelation():
    a = _uniforms(1 << 14, site=0)
    b = _uniforms(1 << 14, site=1)
    c = _uniforms(1 << 14, key_lo=0x5679, site=0)
    assert abs(np.corrcoef(a, b)[0, 1]) < 0.03
    assert abs(np.corrcoef(a, c)[0, 1]) < 0.03
    assert not np.array_equal(a, b)


def test_counter_stream_no_repeats():
    ctr = torch.arange(4096, dtype=torch.int64).view(-1, 1)
    vals = tprng.hash_u32(7, 11, ctr, 0).to(torch.int64).numpy().ravel()
    assert len(np.unique(vals)) == len(vals)
    # The same stream through the JAX package.
    want = np.asarray(jprng.hash_u32(
        jnp.uint32(7), jnp.uint32(11),
        jnp.arange(4096, dtype=jnp.uint32).reshape(-1, 1), jnp.uint32(0),
    )).ravel()
    np.testing.assert_array_equal(vals, want)
