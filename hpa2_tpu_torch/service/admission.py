"""Multi-tenant admission: who gets in, in what order, and when to
push back.  The port's own copy of ``hpa2_tpu/service/admission.py``
(l.1-255).

Two halves:

- :class:`TenantTable` — the static tenant configuration (weights for
  the fair-drr scheduler policy, parsed from the CLI's
  ``--tenant-weights name:w,name:w`` spec).
- :class:`AdmissionLedger` — the thread-safe meeting point between the
  wire frontend's per-connection reader threads and the serving
  loop's single-threaded poll.  ``try_submit`` either assigns the
  global admission sequence number (the ACK ``seq``) or rejects
  *loudly* (credit exhaustion, duplicate id, malformed record — every
  rejection carries a reason; nothing is silently dropped).
  ``take_wave`` drains pending submissions **in seq order** — one
  admission wave per scheduler interval — so the order jobs enter the
  :class:`~hpa2_tpu_torch.ops.schedule.LaneScheduler` is fixed by the ack
  transcript, not by reader-thread timing.

Deadline classes map service-level names onto the scheduler's
deadline-in-intervals unit so clients don't need to know interval
granularity: ``interactive`` (8), ``standard`` (32), ``batch`` (no
deadline).  An explicit ``deadline`` field on a record always wins.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterator, List, Optional, Tuple

DEADLINE_CLASSES: Dict[str, int] = {
    "interactive": 8,
    "standard": 32,
    "batch": -1,
}


def resolve_deadline(record: dict) -> int:
    """The deadline (in scheduling intervals, -1 = none) a job record
    asks for: explicit ``deadline`` wins, else its ``class`` name."""
    if "deadline" in record:
        return int(record["deadline"])
    cls = record.get("class")
    if cls is None:
        return -1
    try:
        return DEADLINE_CLASSES[cls]
    except KeyError:
        raise ValueError(
            f"unknown deadline class {cls!r}; expected one of "
            f"{sorted(DEADLINE_CLASSES)}"
        ) from None


@dataclasses.dataclass(frozen=True)
class TenantTable:
    """Per-tenant fair-share weights (default tenant weighs 1.0)."""

    weights: Dict[str, float] = dataclasses.field(default_factory=dict)

    @classmethod
    def parse(cls, spec: str) -> "TenantTable":
        """Parse the CLI spec ``"alice:4,bob:1"`` (weight > 0)."""
        weights: Dict[str, float] = {}
        for part in spec.split(","):
            part = part.strip()
            if not part:
                continue
            name, sep, w = part.partition(":")
            if not sep or not name:
                raise ValueError(
                    f"bad tenant weight {part!r}; expected name:weight"
                )
            try:
                weight = float(w)
            except ValueError:
                raise ValueError(
                    f"bad tenant weight {part!r}; expected name:weight"
                ) from None
            if weight <= 0:
                raise ValueError(
                    f"tenant {name!r} weight must be > 0, got {weight}"
                )
            weights[name] = weight
        return cls(weights)

    def weight_of(self, name: str) -> float:
        return self.weights.get(name, 1.0)

    def __bool__(self) -> bool:
        return bool(self.weights)


class AdmissionReject(Exception):
    """A submission the ledger refused — the message is the NACK
    reason sent back on the wire."""


class AdmissionShed(AdmissionReject):
    """A submission dropped by graceful degradation: the ledger is over
    its shed threshold and the job is batch-class (no deadline), so it
    is shed first to protect deadline traffic.  The NACK carries
    ``"shed": true`` — the client may safely resubmit later."""


@dataclasses.dataclass
class _Pending:
    seq: int
    conn: int
    record: dict


class AdmissionLedger:
    """Thread-safe pending-submission ledger with per-connection
    admission credits.

    Reader threads call :meth:`try_submit`; the serving loop's poll
    calls :meth:`take_wave`.  Credits bound how far a connection may
    run ahead of admission: each accepted SUBMIT consumes one, each
    job drained by ``take_wave`` returns one to its connection (the
    frontend turns those into CREDIT frames).

    ``shed_threshold > 0`` arms graceful degradation: once the pending
    queue reaches the threshold, batch-class submissions (resolved
    deadline -1) are shed with :class:`AdmissionShed` — deadline
    traffic keeps admitting until credits push back.  ``shed_jobs``
    counts them for the occupancy model.

    Connection keys are opaque hashables: the framed frontend keys the
    ledger by *session* id so admissions survive a TCP reconnect
    (:meth:`transfer` re-points a balance when a resumed session
    changes key), and :meth:`ack_of` replays the original ack of a job
    this ledger already admitted — the idempotent-SUBMIT half of
    session resume."""

    def __init__(self, credits: int = 64, shed_threshold: int = 0):
        if credits <= 0:
            raise ValueError(f"credits must be > 0, got {credits}")
        if shed_threshold < 0:
            raise ValueError(
                f"shed_threshold must be >= 0, got {shed_threshold}")
        self.credits = int(credits)
        self.shed_threshold = int(shed_threshold)
        self.shed_jobs = 0
        self._lock = threading.Lock()
        self._seq = 0
        self._pending: List[_Pending] = []
        self._seen_ids: set = set()
        self._acks: Dict[str, Tuple[int, int]] = {}
        self._conn_credits: Dict = {}

    # -- connection lifecycle -----------------------------------------

    def register(self, conn) -> int:
        """A new connection: returns its starting credit budget."""
        with self._lock:
            self._conn_credits[conn] = self.credits
            return self.credits

    def forget(self, conn) -> None:
        with self._lock:
            self._conn_credits.pop(conn, None)

    def balance(self, conn) -> int:
        """The connection's current credit balance (0 if unknown)."""
        with self._lock:
            return self._conn_credits.get(conn, 0)

    def transfer(self, old, new) -> int:
        """Re-point a credit balance (and pending entries) from key
        ``old`` to key ``new`` — a session resuming under a different
        ledger key keeps its admission state.  Returns the balance."""
        with self._lock:
            bal = self._conn_credits.pop(old, self.credits)
            self._conn_credits[new] = bal
            for p in self._pending:
                if p.conn == old:
                    p.conn = new
            return bal

    # -- the submit side (reader threads) ------------------------------

    def try_submit(self, conn, record: dict) -> Tuple[int, int]:
        """Admit one record: returns ``(seq, queue_pos)`` or raises
        :class:`AdmissionReject` with the NACK reason."""
        job_id = record.get("id")
        if not job_id:
            raise AdmissionReject("job record needs an 'id'")
        if ("traces" in record) == ("workload" in record):
            raise AdmissionReject(
                f"job {job_id!r} needs exactly one of 'traces'/'workload'"
            )
        try:
            deadline = resolve_deadline(record)
        except ValueError as e:
            raise AdmissionReject(str(e)) from None
        with self._lock:
            left = self._conn_credits.get(conn, 0)
            if left <= 0:
                raise AdmissionReject(
                    "backpressure: no admission credits "
                    "(wait for CREDIT)"
                )
            if job_id in self._seen_ids:
                raise AdmissionReject(f"duplicate job id {job_id!r}")
            if (self.shed_threshold
                    and len(self._pending) >= self.shed_threshold
                    and deadline < 0):
                self.shed_jobs += 1
                raise AdmissionShed(
                    f"overload: shedding batch-class job {job_id!r} "
                    f"({len(self._pending)} pending >= "
                    f"{self.shed_threshold} threshold)"
                )
            self._conn_credits[conn] = left - 1
            self._seen_ids.add(job_id)
            seq = self._seq
            self._seq += 1
            self._pending.append(_Pending(seq, conn, record))
            self._acks[str(job_id)] = (seq, len(self._pending) - 1)
            return seq, len(self._pending) - 1

    def ack_of(self, job_id: str) -> Optional[Tuple[int, int]]:
        """The ``(seq, queue_pos)`` this ledger originally acked for an
        already-admitted job id, or None — lets the frontend replay an
        ack for an idempotent resubmit instead of NACKing it."""
        with self._lock:
            return self._acks.get(str(job_id))

    # -- the drain side (the serving loop's poll) ----------------------

    def take_wave(
        self, limit: Optional[int] = None
    ) -> Tuple[List[_Pending], Dict[int, int]]:
        """Drain up to ``limit`` pending submissions in seq order.
        Returns ``(wave, credits_back)`` — credits_back maps each
        connection to how many credits it regained."""
        with self._lock:
            if limit is None or limit >= len(self._pending):
                wave, self._pending = self._pending, []
            else:
                wave = self._pending[:limit]
                self._pending = self._pending[limit:]
            back: Dict[int, int] = {}
            for p in wave:
                if p.conn in self._conn_credits:
                    self._conn_credits[p.conn] += 1
                    back[p.conn] = back.get(p.conn, 0) + 1
            return wave, back

    @property
    def pending(self) -> int:
        with self._lock:
            return len(self._pending)
