"""threefry2x32 key streams, bit for bit those of ``jax.random``.

The general engine's link-layer faults draw from the key every system
carries (``SimState.rng_key``): ``PRNGKey``/``fold_in`` seed it
(``hpa2_tpu/ops/state.py:263-264, 382``), the step splits it once a
cycle and draws ``uniform`` samples from the split keys
(``hpa2_tpu/ops/step.py:1110-1137, 1417``), and a fast-forward replays
the splits of the cycles it skips (l.1841).  This module reproduces
jax's default implementation (``threefry2x32``) in the mode the
installed jax runs, ``jax_threefry_partitionable=True``: a key of shape
``[..., 2]`` hashes the flat counter of every element of the requested
shape, as a 64-bit count split into a high and a low word, and a 32-bit
sample is the XOR of the two output words.

Keys are held as int32 tensors with the bits of jax's uint32 words
(torch's uint32 has few ops).  The arithmetic runs in int64 on values
in ``[0, 2**32)``, masked after every add and rotation, so the adds
wrap as uint32 and ``>>`` is a logical shift; int64 never overflows
there (the widest intermediate is a word shifted left by 29 bits).
Every function takes a leading batch of keys: ``split`` and ``uniform``
draw for each key of ``[..., 2]`` independently.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns (or any int) -> int64 in [0, 2**32)."""
    return x.to(torch.int64) & _MASK


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 in [0, 2**32) -> int32 with the same bits."""
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 block cipher (20 rounds) on int64 words in
    ``[0, 2**32)``, broadcasting keys against counters; returns the
    two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x = [(x1 + ks[0]) & _MASK, (x2 + ks[1]) & _MASK]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _MASK
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _MASK
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _MASK
    return x[0], x[1]


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as an int32 ``[2]`` tensor: the high
    word is ``seed >> 32`` (0 for every 32-bit seed, as jax computes it
    without 64-bit mode), the low word ``seed & 0xFFFFFFFF``."""
    seed = int(seed)
    if not -2**31 <= seed < 2**32:
        raise ValueError(f"PRNG seed {seed} is not a 32-bit integer")
    hi = 0
    lo = seed & _MASK
    return _i32(torch.tensor([hi, lo], dtype=torch.int64, device=device))


def _bits(key: torch.Tensor, shape: Sequence[int]):
    """The two threefry output words for every element of ``shape``
    under each key of ``key`` ``[..., 2]``: ``[..., *shape]`` each."""
    count = 1
    for s in shape:
        count *= int(s)
    ctr = torch.arange(count, dtype=torch.int64, device=key.device)
    lead = key.shape[:-1]
    k = _u32(key).reshape(lead + (1,) * len(shape) + (2,))
    hi = (ctr >> 32).reshape(tuple(shape))
    lo = (ctr & _MASK).reshape(tuple(shape))
    return threefry2x32(k[..., 0], k[..., 1], hi, lo)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` for each key: ``[..., num, 2]``."""
    b1, b2 = _bits(key, (num,))
    return _i32(torch.stack([b1, b2], dim=-1))


def split_last(key: torch.Tensor, num: int) -> torch.Tensor:
    """``jax.random.split(key, num)[num - 1]`` for each key ``[..., 2]``
    (the carried key of a step), without the other ``num - 1``."""
    k = _u32(key)
    b1, b2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(k[..., 0]),
                          torch.full_like(k[..., 0], num - 1))
    return _i32(torch.stack([b1, b2], dim=-1))


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the key hashed with the counter
    ``(0, data)``; ``data`` (an int or an integer tensor) broadcasts
    against the keys' leading axes."""
    k = _u32(key)
    d = torch.as_tensor(data, device=key.device).to(torch.int64) & _MASK
    b1, b2 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(d), d)
    return _i32(torch.stack([b1, b2], dim=-1))


def random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element (jax's partitionable mode: the XOR of
    the two output words), int64 in ``[0, 2**32)``, ``[..., *shape]``."""
    b1, b2 = _bits(key, shape)
    return b1 ^ b2


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` for
    each key: the top 23 random bits as the mantissa of a float32 in
    [1, 2), minus 1, scaled and shifted in float32, and floored at
    ``minval``."""
    bits = random_bits(key, shape)
    mant = (bits >> 9) | 0x3F800000
    one = _i32(mant).view(torch.float32) - 1.0
    # float32 bounds as Python floats (exact in float32, and no host
    # copy, so a CUDA graph can capture the draw)
    lo = float(np.float32(minval))
    span = float(np.float32(maxval) - np.float32(minval))
    return torch.clamp(one * span + lo, min=lo)
