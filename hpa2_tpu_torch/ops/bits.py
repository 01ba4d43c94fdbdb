"""Multi-word sharer-bitmask primitives, the port of
``hpa2_tpu/ops/bits.py``.

Sharer sets are ``[..., W]`` words (W = ceil(num_procs / 32)) held as
int32 tensors with the bits of the JAX package's uint32 words: torch's
uint32 has few ops.  Equality tests against zero are exact on those bit
patterns; anything that reads a word as a number (popcount, the lowest
set bit) first widens it to int64 in ``[0, 2**32)``, where ``>>`` is a
logical shift and bit 31 orders correctly.  torch has no population
count, so :func:`popcount` is the SWAR bit trick and :func:`find_owner`
counts the bits below the lowest set bit.
"""

from __future__ import annotations

import torch

WORD_BITS = 32
_MASK = 0xFFFFFFFF


def u32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 in [0, 2**32)."""
    return x.to(torch.int64) & _MASK


def i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding 32-bit patterns (as unsigned or signed values) ->
    int32 with the same low 32 bits."""
    x = x & _MASK
    return torch.where(x >= 2**31, x - 2**32, x).to(torch.int32)


def words_i32(values) -> torch.Tensor:
    """Python ints or an unsigned numpy array of 32-bit words -> an
    int32 tensor of the same bits (for trace-time constants)."""
    t = torch.as_tensor(values).to(torch.int64)
    return i32(t)


def bit_mask(proc: torch.Tensor, words: int) -> torch.Tensor:
    """One-hot sharer mask for node id(s) ``proc`` ([...] int) ->
    [..., W] int32.  Negative ids give an all-zero mask."""
    proc = proc.to(torch.int64)
    word_idx = torch.arange(words, dtype=torch.int64, device=proc.device)
    target = torch.div(proc, WORD_BITS, rounding_mode="floor")[..., None]
    shift = torch.remainder(proc, WORD_BITS)[..., None]
    valid = (proc[..., None] >= 0) & (word_idx == target)
    return i32(torch.where(valid, torch.ones_like(shift) << shift,
                           torch.zeros_like(shift)))


def test_bit(mask: torch.Tensor, proc: torch.Tensor) -> torch.Tensor:
    """mask [..., W], proc int [...] -> bool [...]."""
    return ((mask & bit_mask(proc, mask.shape[-1])) != 0).any(dim=-1)


def _popcount64(x: torch.Tensor) -> torch.Tensor:
    """Set bits of int64 words in [0, 2**32) (SWAR)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _MASK) >> 24


def popcount(mask: torch.Tensor) -> torch.Tensor:
    """mask [..., W] -> int32 [...]: number of sharers."""
    return _popcount64(u32(mask)).sum(dim=-1).to(torch.int32)


def find_owner(mask: torch.Tensor) -> torch.Tensor:
    """Lowest set bit index [..., W] -> int32 [...] (-1 if empty);
    the reference's findOwner (assignment.c:98-105)."""
    x = u32(mask)
    lsb = x & (-x)
    ctz = _popcount64((lsb - 1) & _MASK)
    word_idx = torch.arange(mask.shape[-1], dtype=torch.int64,
                            device=mask.device)
    big = 1 << 30
    cand = torch.where(x != 0, word_idx * WORD_BITS + ctz,
                       torch.full_like(ctz, big))
    low = cand.min(dim=-1).values
    return torch.where(low >= big, torch.full_like(low, -1),
                       low).to(torch.int32)


def to_int(mask) -> int:
    """[W] words (int32 bit patterns or unsigned) -> Python int."""
    out = 0
    for w, word in enumerate(mask):
        out |= (int(word) & _MASK) << (WORD_BITS * w)
    return out
