"""Core protocol data model: states, message types, message/instruction records.

Mirrors the reference's data model (assignment.c:15-81) with two
deliberate departures:

* ``MsgType.UPGRADE_NOTIFY`` is a distinct message type for the
  home -> last-remaining-sharer "your SHARED copy is now EXCLUSIVE"
  notification.  The reference overloads ``EVICT_SHARED`` for this and
  disambiguates by receiver==home (assignment.c:498-539), which
  misfires when the home node is itself a sharer and livelocks
  (SURVEY.md §6.3).  The shipped fixtures show the cleanly-resolved
  outcome, so the distinct type is the default semantics;
  ``Semantics.overloaded_evict_shared_notify`` restores HEAD behavior.
* ``MsgType.NACK`` exists for the robust intervention policy
  (``Semantics.intervention_miss_policy == "nack"``): an owner that
  receives a WRITEBACK_INT/WRITEBACK_INV for a line it no longer holds
  answers NACK instead of silently dropping it (the reference drops,
  assignment.c:265-270, leaving the requester waiting forever).

Enum *values* of the shared members match the reference enums
(assignment.c:17-34) so array-encoded state is directly comparable
across all backends and the dump formatter can index state names by
value.

The port's copy of ``hpa2_tpu/models/protocol.py`` (l.1-161), kept line
for line because the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import enum


class CacheState(enum.IntEnum):
    """Cache-line states.

    The first four are the MESI states with reference enum values
    (assignment.c:17).  The protocol-variant states append after them
    so MESI-encoded arrays stay bit-identical: ``OWNED`` is MOESI's
    dirty-shared responder, ``FORWARD`` is MESIF's clean designated
    responder.
    """

    MODIFIED = 0
    EXCLUSIVE = 1
    SHARED = 2
    INVALID = 3
    OWNED = 4    # MOESI only: dirty, shared, answers reads
    FORWARD = 5  # MESIF only: clean, shared, answers reads


class DirState(enum.IntEnum):
    """Directory entry states (assignment.c:18, README.md:20-23).

    ``SO`` appends after the reference values: MOESI's "shared with a
    dirty owner" state, whose owner is tracked in the separate
    dir-owner pointer plane.
    """

    EM = 0  # exactly one cache holds the block (clean or dirty)
    S = 1   # one or more caches hold it shared
    U = 2   # no cache holds it
    SO = 3  # MOESI only: shared, one OWNED cache holds the dirty copy


class MsgType(enum.IntEnum):
    """Coherence transactions (assignment.c:20-34) + rebuild extensions."""

    READ_REQUEST = 0
    WRITE_REQUEST = 1
    REPLY_RD = 2
    REPLY_WR = 3
    REPLY_ID = 4
    INV = 5
    UPGRADE = 6
    WRITEBACK_INV = 7
    WRITEBACK_INT = 8
    FLUSH = 9
    FLUSH_INVACK = 10
    EVICT_SHARED = 11
    EVICT_MODIFIED = 12
    # --- rebuild extensions (not in the reference enum) ---
    UPGRADE_NOTIFY = 13  # home -> surviving sharer: S line becomes E
    NACK = 14            # stale-intervention bounce (robust mode only)


#: Sentinel for an empty cache line.  The reference uses byte 0xFF
#: (assignment.c:785-787); the rebuild uses -1 so it can never collide
#: with a valid address at any scale.  The dump formatter renders it as
#: 0xFF for parity.
INVALID_ADDR = -1

#: "no second receiver" sentinel (assignment.c: secondReceiver = -1).
NO_PROC = -1


@dataclasses.dataclass
class Message:
    """One coherence message (assignment.c:53-61).

    ``sharers`` unifies the reference's overloaded ``bitVector`` field:
    for REPLY_RD it carries the exclusivity flag (2 = exclusive, 0 =
    shared — assignment.c:201/207/245), for REPLY_ID the sharer set to
    invalidate (assignment.c:306, 397).  It is an int bitmask of
    arbitrary width, so node count is not capped at 8.
    """

    type: MsgType
    sender: int
    address: int
    value: int = 0
    sharers: int = 0
    second_receiver: int = NO_PROC
    # Delivery cycle assigned by the interconnect model at acceptance
    # (hpa2_tpu/interconnect/): the receiver handles this message only
    # once ``cycle >= deliver_at``.  0 (the ideal topology) means
    # "next cycle", today's behavior.
    deliver_at: int = 0

    def copy(self) -> "Message":
        return dataclasses.replace(self)


#: REPLY_RD exclusivity flag values (assignment.c:201, 207, 245).
#: REPLY_RD_FORWARD is the MESIF extension: fill the line in FORWARD
#: state (clean designated responder); never emitted by MESI/MOESI.
REPLY_RD_EXCLUSIVE = 2
REPLY_RD_SHARED = 0
REPLY_RD_FORWARD = 1


@dataclasses.dataclass(frozen=True)
class Instr:
    """One trace instruction: RD addr / WR addr value (README.md:55-68)."""

    op: str  # 'R' or 'W'
    address: int
    value: int = 0

    def __post_init__(self) -> None:
        if self.op not in ("R", "W"):
            raise ValueError(f"bad instruction op {self.op!r}")


def bit(proc: int) -> int:
    return 1 << proc


def is_bit_set(mask: int, proc: int) -> bool:
    """assignment.c:94-96."""
    return bool((mask >> proc) & 1)


def find_owner(mask: int) -> int:
    """Lowest set bit, -1 if empty (assignment.c:98-105)."""
    if mask == 0:
        return -1
    return (mask & -mask).bit_length() - 1


def count_sharers(mask: int) -> int:
    """Popcount (assignment.c:107-115)."""
    return bin(mask).count("1")
