"""Runtime configuration of one simulated DSM system.

Field names and defaults are those of ``hpa2_tpu.config``, so one
keyword dictionary builds the same configuration for either package:
the geometry, the protocol semantics, the interconnect (topology, link
costs and the seeded link-layer ``FaultModel``,
``hpa2_tpu/config.py:75-140, 230-276``), cycle elision
(``SystemConfig.elide``, l.312), the node-sharding exchange choice
(``exchange_mode``/``exchange_inner``, validated here; only node
sharding reads them, which the port does not have yet), the protocol
and directory-format choices, and the serving plane's failure plan
(``hpa2_tpu/config.py:129-228``, ``SystemConfig.failures`` at l.351),
whose ``sever`` events the wire frontend honours.  The fast path
(``ops/cuda_engine.py``) refuses a non-ideal topology and reads no
``fault``; the general engine (``ops/engine.py``) runs them all.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from hpa2_tpu_torch.interconnect.topology import TOPOLOGIES


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

    def head_quirks(self) -> "Semantics":
        """The reference HEAD's behaviour, for differential study only
        (``hpa2_tpu/config.py:59-67``): all three quirks on and stale
        interventions dropped, as HEAD does."""
        return dataclasses.replace(
            self,
            eager_write_request_memory=True,
            flush_invack_fills_old_value=True,
            overloaded_evict_shared_notify=True,
            intervention_miss_policy="drop",
        )

    def robust(self) -> "Semantics":
        """Fixture semantics + the at-scale soundness fixes."""
        return dataclasses.replace(self, intervention_miss_policy="nack")


@dataclasses.dataclass(frozen=True)
class FaultModel:
    """Seeded fault injection for the interconnect.

    Faults are injected, and masked, at the link layer inside the
    delivery boundary: every message a receiver accepts in a cycle must
    fully cross the wire before the cycle commits, by bounded in-cycle
    retransmission (up to ``max_retries`` rounds), duplicate filtering
    and reorder reassembly.  The protocol above therefore sees the
    fault-free schedule and the dumps stay byte-identical to the golden
    run.  A message that exhausts its retry budget defers to the
    sender's outbox and retries next cycle; at 100% drop it never
    crosses, progress stops and the watchdog fires.

    ``edge_sender``/``edge_receiver`` restrict injection to one directed
    edge (-1 = wildcard).
    """

    drop: float = 0.0       # P(one transmission attempt is lost)
    duplicate: float = 0.0  # P(delivered copy arrives twice)
    reorder: float = 0.0    # P(delivered copy arrives out of order)
    delay: float = 0.0      # P(delivered copy is delayed in-flight)
    seed: int = 0
    max_retries: int = 64   # in-cycle retransmission budget per message
    edge_sender: int = -1   # -1 = any sender
    edge_receiver: int = -1  # -1 = any receiver

    def __post_init__(self) -> None:
        for name in ("drop", "duplicate", "reorder", "delay"):
            v = getattr(self, name)
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"fault {name} rate {v} outside [0, 1]")
        if self.max_retries < 1:
            raise ValueError("fault max_retries must be >= 1")

    @property
    def enabled(self) -> bool:
        return (
            self.drop > 0.0
            or self.duplicate > 0.0
            or self.reorder > 0.0
            or self.delay > 0.0
        )

    def applies(self, sender: int, receiver: int) -> bool:
        """Does this model inject on the (sender -> receiver) edge?"""
        return (self.edge_sender in (-1, sender)) and (
            self.edge_receiver in (-1, receiver)
        )


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
    """The interconnect as one subsystem: topology + faults.

    ``ideal`` delivers every message next cycle (the only topology the
    fast path implements); the others give every message a
    deterministic delivery delay from per-edge base latency plus
    per-cycle link contention at ``link_bandwidth`` messages per link
    per cycle.  ``multicast`` ships one INV fan-out payload per shared
    link; ``combining`` merges same-address READ_REQUESTs in-network.
    Both need a non-ideal topology.  ``fault`` is the seeded link-layer
    fault injection.
    """

    topology: str = "ideal"
    hop_latency: int = 1
    link_bandwidth: int = 1
    multicast: bool = False
    combining: bool = False
    fault: FaultModel = dataclasses.field(default_factory=FaultModel)

    def __post_init__(self) -> None:
        if self.topology not in TOPOLOGIES:
            raise ValueError(
                f"unknown topology {self.topology!r}; "
                f"registered: {TOPOLOGIES}"
            )
        if self.hop_latency < 1:
            raise ValueError("hop_latency must be >= 1")
        if self.link_bandwidth < 1:
            raise ValueError("link_bandwidth must be >= 1")
        if self.topology == "ideal" and (self.multicast or self.combining):
            raise ValueError(
                "multicast/combining need a non-ideal topology "
                "(the ideal interconnect has no links to share)"
            )

    @property
    def enabled(self) -> bool:
        """True when messages carry a topology-derived delivery delay."""
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
    # event-driven cycle elision in the general engine: a pure
    # performance knob (dumps, cycle counts and stats are identical
    # either way); False is the lockstep escape hatch
    elide: bool = True
    # node-sharding exchange transport ("a2a", "butterfly", "hier",
    # "pairwise") and the "hier" inner-tier size (0 = auto); only node
    # sharding reads them
    exchange_mode: str = "a2a"
    exchange_inner: int = 0
    protocol: str = "mesi"
    directory_format: str = "full"
    # the serving plane's failure schedule; the kernels never read it
    failures: Optional[FailurePlan] = None
    # deprecated alias for ``interconnect.fault``; after construction it
    # always mirrors ``interconnect.fault``
    fault: Optional[FaultModel] = None

    def __post_init__(self) -> None:
        if self.num_procs < 1:
            raise ValueError("num_procs must be >= 1")
        if self.cache_size < 1 or self.mem_size < 1:
            raise ValueError("cache and memory must be non-empty")
        if self.msg_buffer_size < 4:
            raise ValueError("msg_buffer_size too small")
        if self.messages_per_cycle < 1:
            raise ValueError("messages_per_cycle must be >= 1")
        if self.exchange_mode not in (
            "pairwise", "a2a", "butterfly", "hier"
        ):
            raise ValueError(
                f"unknown exchange_mode {self.exchange_mode!r}; expected"
                f" one of 'pairwise', 'a2a', 'butterfly', 'hier'")
        if self.exchange_inner < 0:
            raise ValueError("exchange_inner must be >= 0 (0 = auto)")
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
        # fold the deprecated fault alias into the interconnect config
        # (object.__setattr__: the dataclass is frozen) so eq/hash see
        # one representation whichever path set the fault
        ic = self.interconnect
        if self.fault is not None and self.fault != ic.fault:
            default = FaultModel()
            if ic.fault == default:
                ic = dataclasses.replace(ic, fault=self.fault)
                object.__setattr__(self, "interconnect", ic)
            elif self.fault != default:
                raise ValueError(
                    "conflicting fault models: Config.fault (deprecated"
                    " alias) and Config.interconnect.fault are both set"
                    " and differ; set interconnect.fault only"
                )
        object.__setattr__(self, "fault", ic.fault)

    @property
    def num_addresses(self) -> int:
        return self.num_procs * self.mem_size

    def home_of(self, addr: int) -> int:
        return addr // self.mem_size

    def block_of(self, addr: int) -> int:
        return addr % self.mem_size

    def cache_index_of(self, addr: int) -> int:
        return addr % self.cache_size

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

