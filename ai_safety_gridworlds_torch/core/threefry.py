"""JAX's threefry key chain in PyTorch, bit for bit.

The JAX package's generic path draws with ``jax.random`` (threefry-2x32
with ``jax_threefry_partitionable`` on, JAX's default since 0.5). The port
reproduces the same key chain so that a port rollout equals a JAX rollout
from the same seed: ``PRNGKey``, ``split``, ``fold_in``, ``random_bits``,
``uniform``, ``bernoulli``, ``randint``, ``permutation`` and ``choice``,
each on a batch of keys.

A key is a ``[..., 2]`` int64 tensor holding two uint32 words (PyTorch's
``uint32`` lacks the shifts and the wrapping adds the hash needs); every
function takes a batch of keys with any leading shape and draws for each
key independently, as ``jax.vmap`` of the JAX function would. Every
intermediate stays below 2**33, so int64 never overflows.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_M = 0xFFFF_FFFF
_I64 = torch.int64
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD1_1BDA


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 block cipher (20 rounds) on uint32 words held in
    int64 tensors that broadcast together; returns the two output words.

    Only ``x1`` must stay below 2**32 where it is shifted right: it is
    masked after each round's xor but the fourth of each group, which the
    key injection's mask serves. ``x0`` gathers carries above bit 31
    (below 2**38 over the 20 rounds), which addition mod 2**32 ignores,
    and is masked at the end. The rotation is a right shift and one add
    with the left shift as its multiplier (``x1 << r`` and
    ``x1 >> (32 - r)`` share no bit). Every intermediate stays below
    2**62."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0 = x1 + ks[0]
    x1 = (x2 + ks[1]) & _M
    for i in range(5):
        for j, r in enumerate(_ROTATIONS[i % 2]):
            x0 = x0 + x1
            # The rotation: the two halves' bits are disjoint, so their OR
            # is one add, with the left shift as its multiplier.
            x1 = torch.add(x1 >> (32 - r), x1, alpha=1 << r) ^ x0
            if j < 3:  # the key injection below masks the fourth
                x1 = x1 & _M
        x0 = x0 + ks[(i + 1) % 3]
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M
    return x0 & _M, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 32-bit JAX: ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & _M], dtype=_I64, device=device)


# The flat index of each (shape, device), made once: an arange each call
# would be launches the host pays on every step.
_iotas: dict = {}


def _iota_2x32(shape, device):
    """The row-major flat index of ``shape`` as (high, low) uint32 words;
    the high word is 0 (no draw here reaches 2**32 elements)."""
    key = (shape, str(device))
    lo = _iotas.get(key)
    if lo is None:
        n = math.prod(shape)
        if n > _M:
            raise ValueError(f"a draw of {n} elements")
        lo = _iotas[key] = torch.arange(n, dtype=_I64,
                                        device=device).reshape(shape)
    return 0, lo


def _words(keys: torch.Tensor, shape):
    """Both threefry output words of each key over the iota of ``shape``:
    ``[*keys.shape[:-1], *shape]`` each."""
    shape = tuple(shape)
    lead = keys.shape[:-1]
    view = lead + (1,) * len(shape)
    k1 = keys[..., 0].reshape(view)
    k2 = keys[..., 1].reshape(view)
    hi, lo = _iota_2x32(shape, keys.device)
    return threefry2x32(k1, k2, hi, lo)


def split(keys: torch.Tensor, num=2) -> torch.Tensor:
    """``jax.random.split`` of each key: ``[..., 2]`` -> ``[..., *num, 2]``."""
    shape = (num,) if isinstance(num, int) else tuple(num)
    b1, b2 = _words(keys, shape)
    return torch.stack([b1, b2], dim=-1)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` of each key with its own ``data`` (an int or
    a tensor that broadcasts to ``keys.shape[:-1]``, taken mod 2**32)."""
    if isinstance(data, torch.Tensor):
        data = data.to(device=keys.device, dtype=_I64) & _M
    else:
        data = int(data) & _M
    b1, b2 = threefry2x32(keys[..., 0], keys[..., 1], 0, data)
    return torch.stack(torch.broadcast_tensors(b1, b2), dim=-1)


def random_bits(keys: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element: ``[*keys.shape[:-1], *shape]`` uint32
    values in int64 (the partitionable form: the two words XORed)."""
    b1, b2 = _words(keys, shape)
    return b1 ^ b2


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as XLA on the CPU contracts a
    float32 multiply-add: the product of two float32 values is exact in
    float64, so only the sum rounds there before the cast."""
    return (a.double() * b + c).float()


def uniform(keys: torch.Tensor, shape=(), minval=0.0, maxval=1.0
            ) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` for each
    key: the mantissa trick on [0, 1), then ``max(minval, u * (maxval -
    minval) + minval)`` with the bounds and their span rounded to float32
    first, as JAX does (``minval``/``maxval`` are Python numbers), the
    multiply-add fused as XLA's."""
    bits = random_bits(keys, shape)
    fbits = ((bits >> 9) | 0x3F80_0000).to(torch.int32)
    u = fbits.view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return u  # u * 1 + 0 is u, and no u is below 0
    lo, hi = np.float32(minval), np.float32(maxval)
    span = float(hi - lo)
    # A span of 1 leaves the product exact: the fused and the plain sum
    # are one rounding of the same value.
    r = u + float(lo) if span == 1.0 else _fma(u, span, float(lo))
    return torch.clamp(r, min=float(lo))


# XLA's float32 ErfInv (Giles' single-precision approximation, the
# constants of ``xla/hlo/builder/lib/math.cc::ErfInv32``): a degree-8
# polynomial in w - 2.5 for w = -log1p(-x * x) < 5, else in sqrt(w) - 3.
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
                 -4.39150654e-06, 0.00021858087, -0.00125372503,
                 -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322,
                 -0.00367342844, 0.00573950773, -0.0076224613,
                 0.00943887047, 1.00167406, 2.83297682)
_SQRT2 = float(np.float32(np.sqrt(2.0)))
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_TINY = float(np.finfo(np.float32).tiny)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` written out in PyTorch ops (ATen's
    ``erfinv`` is another approximation), each polynomial step one fused
    multiply-add as XLA's on the CPU. ``log1p`` is ATen's, which differs
    from XLA's in the last bits: the result within 3 ulps (the tests)."""
    w = -torch.log1p(-(x * x))
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)

    def coeff(i):
        # Python floats, rounded to float32 where they meet ``w``.
        return torch.where(small, _ERFINV_SMALL[i], _ERFINV_LARGE[i])

    p, wd = coeff(0), w.double()
    for i in range(1, len(_ERFINV_SMALL)):
        p = _fma(p, wd, coeff(i).double())
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32 for each key:
    ``sqrt(2) * erf_inv(u)`` with ``u`` uniform on [nextafter(-1, 0), 1)
    (JAX's ``_normal_real``)."""
    return _SQRT2 * erf_inv(uniform(keys, shape, _NORMAL_LO, 1.0))


def gumbel(keys: torch.Tensor, shape=()) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in its default ``'low'`` mode:
    ``-log(-log(u))`` with ``u`` uniform on [tiny, 1)."""
    return -torch.log(-torch.log(uniform(keys, shape, _TINY, 1.0)))


def categorical(keys: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits)`` over the last axis for each
    key (``logits`` is ``[*keys.shape[:-1], ..., A]``; one key draws the
    whole rest): the argmax of ``gumbel + logits``, the first on a tie;
    int32."""
    shape = logits.shape[keys.dim() - 1:]
    return torch.argmax(gumbel(keys, shape) + logits, dim=-1).to(torch.int32)


def bernoulli(keys: torch.Tensor, p=0.5, shape=()) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` in its default ``'low'``
    mode for each key: ``uniform(key, shape) < p`` with ``p`` float32 (a
    float, or a tensor that broadcasts to the output); bool."""
    if isinstance(p, torch.Tensor):
        p = p.to(device=keys.device, dtype=torch.float32)
    # A Python float compares in float32 with a float32 tensor.
    return uniform(keys, shape) < p


def randint(keys: torch.Tensor, shape, minval, maxval) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, int32)`` for each
    key; ``minval`` and ``maxval`` are ints in the int32 range or tensors
    that broadcast to the output."""
    # Both halves' bits in one pass over the two split keys.
    bits = random_bits(split(keys, 2), shape)
    higher, lower = bits.unbind(dim=keys.dim() - 1)
    if isinstance(minval, torch.Tensor) or isinstance(maxval, torch.Tensor):
        lo = torch.as_tensor(minval, dtype=_I64, device=keys.device)
        hi = torch.as_tensor(maxval, dtype=_I64, device=keys.device)
        span = (hi - lo) & _M
        span = torch.where(hi <= lo, torch.ones_like(span), span)
    else:
        lo, hi = int(minval), int(maxval)
        span = 1 if hi <= lo else (hi - lo) & _M
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & _M) % span
    if isinstance(span, int) and span <= 1 << 16:
        # No uint32 sum can wrap, nor can lo + offset (< maxval) leave the
        # int32 range: the same values with fewer ops.
        offset = ((higher % span) * multiplier + lower % span) % span
        return (offset + lo).to(torch.int32)
    offset = (((higher % span) * multiplier) & _M) + (lower % span)
    offset = (offset & _M) % span
    out = (lo + offset) & _M
    return torch.where(out >= 1 << 31, out - (1 << 32), out).to(torch.int32)


def permutation(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)`` for each key: ``[..., n]`` int32,
    rounds of a stable sort by fresh 32-bit words, as JAX's ``_shuffle``."""
    rounds = math.ceil(3 * math.log(max(1, n)) / math.log(_M))
    x = torch.arange(n, dtype=torch.int32, device=keys.device).expand(
        keys.shape[:-1] + (n,)
    )
    for _ in range(rounds):
        k = split(keys, 2)
        keys, sub = k[..., 0, :], k[..., 1, :]
        order = torch.sort(random_bits(sub, (n,)), dim=-1, stable=True).indices
        x = x.gather(-1, order)
    return x.contiguous()


# XLA on the CPU rewrites a cumulative sum longer than this into tiles of
# this many elements (its ``ReduceWindowRewriter``): a running sum within
# each tile, the tiles' totals summed the same way, then added on.
_SCAN_TILE = 16


def cumsum_tiled(p: torch.Tensor) -> torch.Tensor:
    """The running sums of ``p`` over its last axis, float32 add by float32
    add in the order XLA's CPU pipeline adds ``jnp.cumsum``: in index order
    within tiles of 16, each tile then offset by the running sum of the
    tiles before it (recursively), so the sums equal JAX's bit for bit.
    ``torch.cumsum`` adds in another order, and on the card in a parallel
    scan whose rounding is not the CPU's; these adds round the same on
    both."""
    n = p.shape[-1]
    if n <= _SCAN_TILE:
        sums = [p[..., 0]]
        for i in range(1, n):
            sums.append(sums[-1] + p[..., i])
        return torch.stack(sums, dim=-1)
    k = -(-n // _SCAN_TILE)
    x = torch.nn.functional.pad(p, (0, k * _SCAN_TILE - n))
    inner = cumsum_tiled(x.reshape(p.shape[:-1] + (k, _SCAN_TILE)))
    before = cumsum_tiled(inner[..., -1])[..., :-1]
    offset = torch.nn.functional.pad(before, (1, 0))
    out = inner + offset[..., None]
    return out.reshape(p.shape[:-1] + (k * _SCAN_TILE,))[..., :n]


def _choice_r(keys, p, shape):
    """``choice``'s running sums of ``p`` and its uniform point ``r`` on
    (0, total] for each draw: ``total * (1 - uniform)``."""
    p = p.to(device=keys.device, dtype=torch.float32)
    lead = keys.shape[:-1]
    if p.shape[:-1] != lead:
        p = p.expand(lead + p.shape[-1:])
    p_cuml = cumsum_tiled(p)
    u = uniform(keys, shape)
    total = p_cuml[..., -1].reshape(lead + (1,) * len(shape))
    return p_cuml.reshape(lead + (1,) * len(shape) + p.shape[-1:]), \
        total * (1.0 - u)


def choice(keys: torch.Tensor, a, shape=(), replace: bool = True,
           p=None) -> torch.Tensor:
    """``jax.random.choice(key, a, shape, replace, p)`` for each key.

    ``a`` is an int ``n`` (draws from ``arange(n)``, int32) or a 1-D tensor
    (its entries, in its dtype), the same for every key; ``p`` is ``None``
    or float32 weights ``[..., n]`` (the same for every key, or one row per
    key). The draws are ``[*keys.shape[:-1], *shape]``. JAX's branches:
    without ``p``, ``randint`` (with replacement) or the head of a
    ``permutation`` (without); with ``p`` and replacement, the first index
    whose running sum of ``p`` reaches ``total * (1 - uniform)``
    (``searchsorted``, left side), the sums from :func:`cumsum_tiled`.
    All-zero weights draw index 0. ``p`` without replacement (JAX's
    Gumbel top-k) is not ported: no module of the port draws so."""
    shape = tuple(shape)
    table = None
    if isinstance(a, torch.Tensor) and a.dim() > 0:
        table = a.to(keys.device)
        n = table.shape[0]
    else:
        n = int(a)
    n_draws = math.prod(shape)
    if n <= 0:
        raise ValueError("a must be greater than 0 unless no samples are "
                         "taken")
    if not replace and n_draws > n:
        raise ValueError(
            f"Cannot take a larger sample (size {n_draws}) than population "
            f"(size {n}) when 'replace=False'")
    if p is None:
        if replace:
            ind = randint(keys, shape, 0, n)
        else:
            ind = permutation(keys, n)[..., :n_draws].reshape(
                keys.shape[:-1] + shape)
    else:
        if not replace:
            raise NotImplementedError(
                "choice(p=..., replace=False) (JAX's Gumbel top-k) is not "
                "ported; ROADMAP.md lists it as still to come")
        if p.shape[-1] != n:
            raise ValueError(
                "p must be None or a 1D vector with the same size as "
                f"a.shape[axis]. p has shape {tuple(p.shape)} and "
                f"a.shape[axis] is {n}.")
        p_cuml, r = _choice_r(keys, p, shape)
        ind = (p_cuml < r[..., None]).sum(dim=-1, dtype=torch.int32)
    return ind if table is None else table[ind.long()]


def choice_gap(keys: torch.Tensor, p: torch.Tensor, shape=()) -> torch.Tensor:
    """For :func:`choice` with ``p`` and replacement on the same inputs: how
    near each draw's point ``r`` came to a running sum of ``p``, in ulps of
    the total (float64, ``inf`` where every weight is 0, which draws index
    0 whatever the sums' rounding). A draw whose gap is a few ulps would
    pick the neighbouring index under sums rounded in another order (an
    XLA whose pipeline tiles ``cumsum`` otherwise than
    :func:`cumsum_tiled`); a larger gap picks the same."""
    p_cuml, r = _choice_r(keys, p, shape)
    gap = (p_cuml.double() - r.double()[..., None]).abs().amin(dim=-1)
    total = p_cuml[..., -1]
    ulp = (torch.nextafter(total, torch.full_like(total, math.inf))
           - total).double()
    return torch.where(total > 0, gap / ulp, math.inf)
