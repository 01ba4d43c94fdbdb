"""Runtime configuration of one simulated DSM system.

Field names and defaults are those of ``hpa2_tpu.config``, so one
keyword dictionary builds the same configuration for either package.
Only what the streamed fast path reads (or refuses on) is kept: the
geometry, the protocol semantics, and enough of the interconnect,
protocol and directory-format choices to refuse what this engine does
not implement; and the serving plane's failure plan
(``hpa2_tpu/config.py:129-228``, ``SystemConfig.failures`` at l.351),
whose ``sever`` events the wire frontend honours.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

#: the registered interconnect topologies (``ideal`` = next-cycle
#: delivery, the only one the fast path implements)
TOPOLOGIES = ("ideal", "mesh2d", "torus2d", "hierarchical")


@dataclasses.dataclass(frozen=True)
class Semantics:
    """Protocol-semantics switches; the default is fixture semantics
    (the reference's shipped dumps), ``robust()`` adds the NACK fix for
    stale interventions that random traffic needs."""

    # write memory as soon as a WRITE_REQUEST reaches its home
    eager_write_request_memory: bool = False
    # FLUSH_INVACK fills the requester with the flushed old value
    flush_invack_fills_old_value: bool = False
    # overload EVICT_SHARED as the upgrade notification (not supported
    # by the fast path)
    overloaded_evict_shared_notify: bool = False
    # "drop" | "nack": what an owner does with a stale intervention
    intervention_miss_policy: str = "drop"

    def robust(self) -> "Semantics":
        """Fixture semantics + the at-scale soundness fixes."""
        return dataclasses.replace(self, intervention_miss_policy="nack")


#: Failure kinds a :class:`FailurePlan` can schedule.  All fire above
#: the link layer.  The port's wire frontend honours ``sever``; the
#: other three are read by the recovery supervisor, which the port does
#: not have yet:
#:   kill    the whole backend engine dies at the given serving
#:           interval (supervisor migrates to the next target);
#:   hang    a node shard stops quiescing at the interval — the
#:           exchange never drains, so detection is via the watchdog /
#:           StallDiagnostic path rather than an error return;
#:   poison  one resident lane block is marked bad at the interval
#:           (supervisor evacuates its lanes onto a fresh session of
#:           the same backend);
#:   sever   the framed wire connection is cut mid-frame once the
#:           global admission seq reaches the event's ``at`` (the
#:           frontend sends a torn ACK header and hard-closes).
FAILURE_KINDS = ("kill", "hang", "poison", "sever")


@dataclasses.dataclass(frozen=True)
class FailureEvent:
    """One scheduled failure: ``kind`` at serving interval (or, for
    ``sever``, admission seq) ``at``, aimed at ``target`` (a shard /
    lane-block / connection index; 0 when there is only one thing to
    break)."""

    kind: str
    at: int
    target: int = 0

    def __post_init__(self) -> None:
        if self.kind not in FAILURE_KINDS:
            raise ValueError(
                f"unknown failure kind {self.kind!r}; expected one of "
                f"{FAILURE_KINDS}"
            )
        if self.at < 0:
            raise ValueError(f"failure 'at' must be >= 0, got {self.at}")

    def spec(self) -> str:
        base = f"{self.kind}@{self.at}"
        return f"{base}:{self.target}" if self.target else base


@dataclasses.dataclass(frozen=True)
class FailurePlan:
    """A deterministic, seeded failure schedule for the serving plane.

    Pure data: which failures fire, and when — no RNG and no clocks at
    runtime (the same purity rule the interconnect lint enforces).
    ``seed`` only feeds *derived* deterministic choices (e.g. the wire
    client's jittered backoff), never a runtime entropy source.

    Grammar (``FailurePlan.parse``)::

        kill@K [ ; hang@K[:SHARD] ; poison@K[:BLOCK] ; sever@SEQ[:CONN] ]

    i.e. semicolon-separated ``kind@at[:target]`` events.  ``at`` is a
    serving interval index for kill/hang/poison and a global admission
    sequence number for sever.
    """

    events: Tuple[FailureEvent, ...] = ()
    seed: int = 0

    @classmethod
    def parse(cls, spec: str, seed: int = 0) -> "FailurePlan":
        events = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            kind, sep, rest = part.partition("@")
            if not sep:
                raise ValueError(
                    f"bad failure event {part!r}; expected "
                    "kind@at[:target]"
                )
            at, _, target = rest.partition(":")
            try:
                events.append(
                    FailureEvent(
                        kind.strip(), int(at), int(target) if target else 0
                    )
                )
            except ValueError as e:
                raise ValueError(
                    f"bad failure event {part!r}: {e}"
                ) from None
        return cls(tuple(events), seed=seed)

    def spec(self) -> str:
        """Inverse of :meth:`parse` (round-trips through checkpoints)."""
        return ";".join(e.spec() for e in self.events)

    @property
    def enabled(self) -> bool:
        return bool(self.events)

    def of_kind(self, *kinds: str) -> Tuple[FailureEvent, ...]:
        return tuple(e for e in self.events if e.kind in kinds)


@dataclasses.dataclass(frozen=True)
class InterconnectConfig:
    """The interconnect topology; anything but ``ideal`` gives messages
    a delivery delay, which the fast path does not model."""

    topology: str = "ideal"

    def __post_init__(self) -> None:
        if self.topology not in TOPOLOGIES:
            raise ValueError(
                f"unknown topology {self.topology!r}; "
                f"registered: {TOPOLOGIES}"
            )

    @property
    def enabled(self) -> bool:
        return self.topology != "ideal"


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    """Dimensions of one simulated system (reference geometry: 4 nodes,
    4-line direct-mapped cache, 16 memory blocks per node, 256-deep
    mailboxes, 32-instruction trace cap).  ``home = addr // mem_size``,
    ``block = addr % mem_size``, ``cache index = addr % cache_size``."""

    num_procs: int = 4
    cache_size: int = 4
    mem_size: int = 16
    msg_buffer_size: int = 256
    max_instr_num: int = 32  # per-core trace cap; 0 = uncapped
    messages_per_cycle: int = 1
    semantics: Semantics = dataclasses.field(default_factory=Semantics)
    interconnect: InterconnectConfig = dataclasses.field(
        default_factory=InterconnectConfig
    )
    protocol: str = "mesi"
    directory_format: str = "full"
    # the serving plane's failure schedule; the kernels never read it
    failures: Optional[FailurePlan] = None

    def __post_init__(self) -> None:
        if self.num_procs < 1:
            raise ValueError("num_procs must be >= 1")
        if self.cache_size < 1 or self.mem_size < 1:
            raise ValueError("cache and memory must be non-empty")
        if self.msg_buffer_size < 4:
            raise ValueError("msg_buffer_size too small")
        if self.messages_per_cycle < 1:
            raise ValueError("messages_per_cycle must be >= 1")
        if self.protocol not in ("mesi", "moesi", "mesif"):
            raise ValueError(
                f"unknown protocol {self.protocol!r}; expected one of "
                f"'mesi', 'moesi', 'mesif'")
        fmt = self.directory_format
        if fmt != "full":
            kind, _, raw = fmt.partition(":")
            if kind not in ("limited", "coarse") \
                    or not raw.lstrip("-").isdigit():
                raise ValueError(
                    f"unknown directory_format {fmt!r}; expected one of "
                    f"'full', 'limited:<K>', 'coarse:<G>'")
            lo = 1 if kind == "limited" else 2
            if not lo <= int(raw) < self.num_procs:
                raise ValueError(
                    f"directory_format {fmt!r} is incompatible with "
                    f"num_procs={self.num_procs}: the parameter must be "
                    f"in [{lo}, num_procs)")

    @property
    def num_addresses(self) -> int:
        return self.num_procs * self.mem_size

    def make_addr(self, home: int, block: int) -> int:
        return home * self.mem_size + block

    @property
    def sharer_words(self) -> int:
        """32-bit words of the sharer mask (wide dump format)."""
        return (self.num_procs + 31) // 32

    @property
    def parity_compatible(self) -> bool:
        """True when dumps use the reference's exact text format."""
        return (
            self.mem_size == 16
            and self.num_procs <= 8
            and self.num_addresses <= 0xFF
        )

