"""JAX's default random numbers, bit for bit, in PyTorch.

The JAX package's comfort-noise generator (``ops/plc.py``) draws
``jax.random.normal`` from a threefry2x32 key that it splits every tick.
This module recomputes the same bits, so the port's PLC output and its
carried key match the JAX package's exactly, on the CPU and on the card:

* a key is a host (CPU) int64 tensor ``[2]`` holding the two uint32
  words that ``jax.random.key_data`` shows (``key(0)`` is ``[0, 0]``).
  ``split`` runs on those two words in Python integers: a tick's key
  split costs no device launch;
* the bits of ``normal`` follow JAX's partitionable threefry
  (``jax_threefry_partitionable``, the default since JAX 0.5): element
  ``i`` of a draw hashes the 64-bit counter ``i`` as two words, on the
  device the draw is made on;
* ``normal`` maps 23 of the 32 bits to a uniform in (-1, 1) and applies
  XLA's float32 ``erf_inv`` polynomial, so values agree to the ulp of
  ``log1p`` on each side.

uint32 arithmetic on tensors runs in int64 masked to 32 bits, because
PyTorch on the CPU has no uint32 add or shift.
"""
from __future__ import annotations

import math

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def key(seed: int) -> torch.Tensor:
    """``jax.random.key(seed)`` for a seed in [0, 2**32): words (0, seed)."""
    return torch.tensor([0, seed & _M32], dtype=torch.int64)


def threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32 (20 rounds) of the counter words (x0, x1) under the
    key words (k0, k1); x0 and x1 are Python ints or int64 tensors of
    uint32 values."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & _M32
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _words(k: torch.Tensor):
    k0, k1 = k.tolist()
    return k0, k1


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(k, num)`` as host key data [num, 2]."""
    k0, k1 = _words(k)
    return torch.tensor([threefry2x32(k0, k1, i >> 32, i & _M32) for i in range(num)],
                        dtype=torch.int64)


def bits32(k: torch.Tensor, shape, device="cpu") -> torch.Tensor:
    """``jax.random.bits(k, shape)`` on ``device`` (uint32 values in int64)."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device)
    b0, b1 = threefry2x32(*_words(k), idx >> 32, idx & _M32)
    return (b0 ^ b1).reshape(shape)


# XLA's float32 erf_inv (Giles' single-precision approximation)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for a, b in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, a, b) + p * w
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def normal(k: torch.Tensor, shape, device="cpu") -> torch.Tensor:
    """``jax.random.normal(k, shape, float32)`` on ``device``."""
    bits = bits32(k, shape, device)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # uniform on [lo, 1), lo the float32 after -1; maxval - minval is 2.0
    # in float32
    u = torch.clamp(f * 2.0 + _LO, min=_LO)
    return _SQRT2 * erf_inv(u)


_LO = -(1.0 - 2.0 ** -24)
_SQRT2 = float(torch.tensor(math.sqrt(2), dtype=torch.float32))
