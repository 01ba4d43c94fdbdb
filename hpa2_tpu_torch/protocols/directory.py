"""Directory sharer-set format variants.

The directory keeps an exact internal bitvector in every format — the
format governs only what the home *believes* when composing an
invalidation fan-out (the REPLY_ID sharer mask).  That is where real
limited-pointer / coarse-vector directories lose precision, and the
protocol absorbs the resulting spurious INVs through the existing
stale-INV drop rows:

* ``full``       — exact bitvector (the reference's 1-byte bitVector,
                   generalized to arbitrary width).
* ``limited:K``  — up to K precise pointers; a fan-out over more than K
                   sharers overflows to broadcast (all nodes minus the
                   requester) and bumps ``n_dir_overflow``.
* ``coarse:G``   — one presence bit per G-node group; a fan-out INVs
                   every member of every group containing a sharer.

Formats apply identically in the spec engine (``dir_mask_int``) and the
JAX kernels (via ``group_mask_words`` constants + popcount) so the
backends stay differentially comparable.

The port's copy of ``hpa2_tpu/protocols/directory.py`` (l.1-106): the
directory sharer-set formats, kept line for line because the port
imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from hpa2_tpu_torch.models.protocol import bit, count_sharers

DIRECTORY_FORMATS = ("full", "limited", "coarse")


def parse_format(fmt: str, num_procs: int) -> Tuple[str, Optional[int]]:
    """Parse/validate a ``Config.directory_format`` string.

    Returns ``(kind, param)``: ``("full", None)``, ``("limited", K)``
    or ``("coarse", G)``.  Raises ``ValueError`` with a loud message on
    an unknown format or a parameter incompatible with ``num_procs``.
    """
    if fmt == "full":
        return ("full", None)
    for kind in ("limited", "coarse"):
        if fmt == kind or fmt.startswith(kind + ":"):
            raw = fmt[len(kind) + 1:] if ":" in fmt else ""
            try:
                param = int(raw)
            except ValueError:
                raise ValueError(
                    f"directory_format {fmt!r}: expected {kind}:<int>")
            if kind == "limited" and not 1 <= param < num_procs:
                raise ValueError(
                    f"directory_format {fmt!r}: pointer count must be in "
                    f"[1, num_procs) = [1, {num_procs}); a limited "
                    f"directory with >= num_procs pointers is just full")
            if kind == "coarse" and not 2 <= param < num_procs:
                raise ValueError(
                    f"directory_format {fmt!r}: group size must be in "
                    f"[2, num_procs) = [2, {num_procs}); groups of 1 are "
                    f"full precision, one all-node group is broadcast")
            return (kind, param)
    raise ValueError(
        f"unknown directory_format {fmt!r}; expected one of "
        f"'full', 'limited:<K>', 'coarse:<G>'")


def dir_mask_int(
    kind: str,
    param: Optional[int],
    sharers: int,
    requester: int,
    num_procs: int,
) -> Tuple[int, bool]:
    """Spec-engine fan-out mask: (mask, overflowed).

    ``sharers`` is the exact internal bitvector; the result is the set
    the home actually invalidates (requester always excluded).
    """
    base = sharers & ~bit(requester)
    if kind == "full":
        return base, False
    if kind == "limited":
        if count_sharers(base) > param:
            all_mask = (1 << num_procs) - 1
            return all_mask & ~bit(requester), True
        return base, False
    # coarse: spread every set bit over its G-aligned group
    out = 0
    for g0 in range(0, num_procs, param):
        gm = ((1 << min(param, num_procs - g0)) - 1) << g0
        if base & gm:
            out |= gm
    return out & ~bit(requester), False


def group_mask_words(
    param: int, num_procs: int, words: int, word_bits: int,
) -> np.ndarray:
    """[n_groups, words] int32 group-member masks for the JAX coarse
    transform (trace-time constants)."""
    n_groups = (num_procs + param - 1) // param
    out = np.zeros((n_groups, words), dtype=np.int32)
    for g in range(n_groups):
        for p in range(g * param, min((g + 1) * param, num_procs)):
            out[g, p // word_bits] |= 1 << (p % word_bits)
    return out
