"""The counter-based threefry2x32 stream of ``jax.random``, in integer
torch ops.

The JAX package draws every shot and every mid-circuit outcome from
``jax.random.uniform(jax.random.fold_in(jax.random.PRNGKey(seed), site))``
with the default ``threefry2x32`` implementation and
``jax_threefry_partitionable`` on. This module computes the same 32-bit
words and the same float32 uniforms bit for bit, so that one seed gives
one shot table in both packages and on every device:

- :func:`key` is ``PRNGKey(seed)``: the seed's two 32-bit words (high,
  low). A seed is taken modulo 2^32, as numpy's ``uint32`` cast takes it
  (the JAX package binds its seed slots as ``uint32``), so the high word
  is 0;
- :func:`fold_in` is ``fold_in(key, data)``: the key hashed with the
  counter pair (0, data);
- :func:`random_bits` is the partitionable ``random_bits``: counter i is
  the pair (i >> 32, i & 0xFFFFFFFF) and its word the xor of the hash's
  two outputs;
- :func:`uniform` is ``uniform``'s float32 branch: the word's top 23 bits
  as the mantissa of a float in [1, 2), minus 1.

Every word is an int64 tensor holding a value in [0, 2^32) (``torch.uint32``
lacks most of the arithmetic): sums are masked back to 32 bits, and no
product or shift leaves the int64 range. Nothing here reads the host or a
``torch.Generator``, so the ops run the same on the CPU, on the card,
inside a CUDA-graph capture and under ``torch.func.vmap`` (a seed that is a
batched 0-d tensor gives each lane its own stream).
"""

from __future__ import annotations

import torch

__all__ = ["key", "fold_in", "threefry2x32", "random_bits", "uniform"]

_MASK = 0xFFFFFFFF
#: the threefry2x32 rotation schedule and key-schedule parity constant
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _word(x, device=None) -> torch.Tensor:
    """``x`` (an int or an integer tensor) as an int64 tensor in [0, 2^32):
    negative values wrap as numpy's ``uint32`` cast wraps them."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK
    return torch.full((), int(x) & _MASK, dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor) -> tuple:
    """The Threefry-2x32 hash (20 rounds) of the counter pairs (x1, x2)
    under the key (k1, k2): jax's ``_threefry2x32_lowering``. All four
    are int64 words; the outputs broadcast over their shapes."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x[0], x[1]


def key(seed, device=None) -> tuple:
    """``jax.random.PRNGKey(seed)`` as its two words (high, low); ``seed``
    is an int or an integer tensor (a lifted seed slot), taken modulo
    2^32."""
    lo = _word(seed, device)
    return torch.zeros_like(lo), lo


def fold_in(k: tuple, data) -> tuple:
    """``jax.random.fold_in(k, data)``: the key hashed with the counter
    pair (0, data mod 2^32)."""
    k1, k2 = k
    d = _word(data, k2.device)
    return threefry2x32(k1, k2, torch.zeros_like(d), d)


def random_bits(k: tuple, shape) -> torch.Tensor:
    """``jax.random.bits(k, shape, uint32)`` under the partitionable
    threefry: counter i (row-major over ``shape``) hashed as the pair
    (0, i), its word the xor of the two outputs. int64 in [0, 2^32)."""
    k1, k2 = k
    shape = tuple(int(s) for s in shape)
    count = 1
    for s in shape:
        count *= s
    if count >= 1 << 32:
        raise ValueError(f"random_bits: {count} words exceed one 32-bit counter word")
    lo = torch.arange(count, dtype=torch.int64, device=k2.device).reshape(shape)
    hi = torch.zeros_like(lo)
    # a batched key (one stream a lane) broadcasts over the counters
    b1, b2 = threefry2x32(k1.reshape(k1.shape + (1,) * len(shape)),
                          k2.reshape(k2.shape + (1,) * len(shape)), hi, lo)
    return b1 ^ b2


def uniform(k: tuple, shape=()) -> torch.Tensor:
    """``jax.random.uniform(k, shape, jnp.float32)``: the word's top 23
    bits m as m * 2^-23, which is exactly the float (1.m) - 1 that jax
    bit-casts and subtracts."""
    m = random_bits(k, shape) >> 9
    return m.to(torch.float32) * (2.0 ** -23)
