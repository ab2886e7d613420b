"""Counter-based PRF for the fused environment kernels.

Port of ``ai_safety_gridworlds_tpu/ops/prng.py``: ``bits = f(key, counter,
index)``, two chained murmur3 finalizers over the counter and index mixed
with the 64-bit per-lane key. The words are bit-identical to the JAX
package's, so the port and the reference draw the same random numbers from
the same packed state.

PyTorch on the CPU has ``uint32`` ``*`` and ``^`` but no ``>>``, so the
plain version computes in int64 holding values below 2**32; each product by
a 32-bit constant is split into 16-bit halves so that no int64 product
overflows. The CUDA kernels use the same hash from ``csrc/prng.cuh``.

:func:`prf_words` is the wrapper of the CUDA kernel ``csrc/prf_words.cu``
(``hash_u32`` + ``uniform01`` over a grid): it launches the kernel for CUDA
tensors and takes the plain version for CPU tensors.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

_MASK = 0xFFFF_FFFF
_M1 = 0x85EB_CA6B
_M2 = 0xC2B2_AE35
_C1 = 0x9E37_79B9  # golden-ratio increment
_C2 = 0x7FEB_352D


def _u32(x, like=None) -> torch.Tensor:
    """A tensor or int as int64 holding its uint32 value."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK
    device = like.device if isinstance(like, torch.Tensor) else None
    return torch.tensor(int(x) & _MASK, dtype=torch.int64, device=device)


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``a * c mod 2**32`` for int64 ``a`` in [0, 2**32) and a 32-bit
    constant ``c``, with every intermediate below 2**49."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 32-bit finalizer on int64 tensors holding uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def _hash64(key_hi, key_lo, ctr, idx) -> torch.Tensor:
    like = next(
        (v for v in (key_hi, key_lo, ctr, idx) if isinstance(v, torch.Tensor)),
        None,
    )
    h = _mul32(_u32(ctr, like), _C1) ^ _mul32(_u32(idx, like), _C2)
    h = fmix32(h ^ _u32(key_lo, like))
    return fmix32(h ^ _u32(key_hi, like))


def hash_u32(key_hi, key_lo, ctr, idx) -> torch.Tensor:
    """Random uint32 word ``f(key, ctr, idx)``; all arguments broadcast."""
    return _hash64(key_hi, key_lo, ctr, idx).to(torch.uint32)


def uniform01(bits: torch.Tensor) -> torch.Tensor:
    """[0, 1) float32 from uint32 bits (the top 24 bits)."""
    top = _u32(bits) >> 8
    return top.to(torch.float32) * (1.0 / 16777216.0)


def uniform(key_hi, key_lo, ctr, idx) -> torch.Tensor:
    return uniform01(_hash64(key_hi, key_lo, ctr, idx))


def derive_keys(seed: int, batch: int) -> np.ndarray:
    """Per-environment (hi, lo) key pairs for a batch, derived on the host
    exactly as the JAX package does. Returns uint32 [2, batch]."""
    rng = np.random.Generator(np.random.PCG64(seed))
    return rng.integers(0, 2**32, size=(2, batch), dtype=np.uint32)


# ------------------------------------------------------------ CUDA kernel


@functools.cache
def _prf_lib():
    from ai_safety_gridworlds_torch.ops import _cuda

    lib = _cuda.load("prf_words")
    ptr = ctypes.c_void_p
    lib.prf_words.argtypes = [ptr] * 6 + [ctypes.c_longlong, ptr]
    lib.prf_words.restype = ctypes.c_int
    return lib


def prf_words(key_hi, key_lo, ctr, idx):
    """``(hash_u32, uniform01)`` over a grid of uint32 tensors of one shape.

    Launches the kernel ``csrc/prf_words.cu`` (K2) when the tensors lie on
    a CUDA device, and computes the plain version when they lie on the CPU.
    Returns ``(words uint32, uniforms float32)`` of the inputs' shape.
    """
    args = (key_hi, key_lo, ctr, idx)
    shape, device = key_hi.shape, key_hi.device
    for a in args:
        if not isinstance(a, torch.Tensor) or a.dtype != torch.uint32:
            raise TypeError("prf_words takes uint32 tensors")
        if a.shape != shape or a.device != device:
            raise ValueError("prf_words inputs must share shape and device")
    if device.type == "cpu":
        words = hash_u32(*args)
        return words, uniform01(words)
    if device.type != "cuda":
        raise NotImplementedError(f"prf_words has no kernel for {device}")
    if not all(a.is_contiguous() for a in args):
        raise ValueError("prf_words takes contiguous tensors")
    words = torch.empty(shape, dtype=torch.uint32, device=device)
    u = torch.empty(shape, dtype=torch.float32, device=device)
    from ai_safety_gridworlds_torch.ops import _cuda

    lib = _prf_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.prf_words(
            *(a.data_ptr() for a in args), words.data_ptr(), u.data_ptr(),
            words.numel(), stream,
        )
    prf_words.launches += 1
    _cuda.check(lib, err, "prf_words launch")
    return words, u


prf_words.launches = 0
