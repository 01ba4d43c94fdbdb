"""Failure injection above the link layer: the port's own copy of
``hpa2_tpu/service/failover.py``.

The general engine's :class:`~hpa2_tpu_torch.config.FaultModel` perturbs
*messages* (drop/duplicate/reorder inside the interconnect); this
module injects *infrastructure* failures into a live serving run — the
kind a production stack must survive, not merely detect:

- ``kill@k``   — the backend engine dies at serving interval ``k``
  (process loss: the device state is gone, only checkpoints survive);
- ``hang@k[:t]`` — node shard ``t`` stops making progress at interval
  ``k``: the exchange never quiesces, so nothing fails loudly until
  the supervisor's *watchdog* notices N barriers with no completions
  and raises with a :class:`StallDiagnostic`-style postmortem;
- ``poison@k[:s]`` — lane block corruption detected at interval ``k``:
  the resident session can no longer be trusted, in-flight jobs must
  evacuate to a fresh session;
- ``sever@seq`` — the wire frontend cuts a client connection mid-frame
  at global ack ``seq`` (handled in
  :class:`~hpa2_tpu_torch.service.frontend.WireJobSource`, not here).

Everything is driven by the deterministic, seeded
:class:`~hpa2_tpu_torch.config.FailurePlan` — no RNG and no clocks at
runtime, so a chaos run is exactly reproducible from its config.
:class:`FailureInjector` turns the plan into the serving loops'
``interval_hook``: at each interval barrier it raises
:class:`InjectedFailure` for any event that has come due.  Each event
fires **once** per injector — the supervisor reuses one injector
across recovery attempts, so a kill at interval 3 does not re-kill the
migrated-to session when *its* interval counter passes 3.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from hpa2_tpu_torch.config import FailureEvent, FailurePlan


class InjectedFailure(Exception):
    """A planned infrastructure failure fired at an interval barrier.
    Carries the :class:`FailureEvent` and the barrier it fired at so
    the recovery supervisor can decide migrate-vs-evacuate and log a
    structured record."""

    def __init__(self, event: FailureEvent, interval: int,
                 diagnostic: Optional[object] = None):
        self.event = event
        self.interval = interval
        self.diagnostic = diagnostic   # StallDiagnostic for hangs
        msg = (f"injected {event.kind} at interval {interval} "
               f"(planned {event.spec()})")
        if diagnostic is not None:
            msg = f"{msg}\n{diagnostic}"
        super().__init__(msg)


def recovery_record(event: str, **fields) -> Dict:
    """One structured recovery-event record (the observability unit
    flowing through ``ServingStats`` and the bench artifact): a dict
    with a stable ``"event"`` discriminator first, JSON-able values
    only."""
    rec = {"event": str(event)}
    for k, v in fields.items():
        rec[k] = v if isinstance(v, (int, float, str, bool, list,
                                     dict, type(None))) else str(v)
    return rec


class FailureInjector:
    """The serving loops' ``interval_hook`` for one failure plan.

    ``kill`` and ``poison`` events raise the moment their barrier is
    reached.  A ``hang`` first puts the injector into a hung phase —
    the target shard has silently stopped — and only raises after
    ``detect_after`` further barriers with no harvest progress, the
    deterministic analog of a watchdog timeout; the raise carries a
    stall postmortem gathered from the still-live session when the
    backend can produce one.
    """

    def __init__(self, plan: FailurePlan, *, detect_after: int = 2):
        self.plan = plan
        self.detect_after = int(detect_after)
        self._due: List[FailureEvent] = sorted(
            plan.of_kind("kill", "hang", "poison"),
            key=lambda ev: (ev.at, ev.kind),
        )
        self._fired: set = set()
        self._hang: Optional[FailureEvent] = None
        self._hang_at = 0

    @property
    def pending(self) -> int:
        """Events not yet fired (sever events excluded — the wire
        frontend owns those)."""
        return len(self._due) + (1 if self._hang is not None else 0)

    def _diagnose_hang(self, ev: FailureEvent, driver):
        """Best-effort stall postmortem through the backend's own
        diagnostic path (``session.stall_of``: the jax session gathers
        a row; the fast path's session has no mid-flight readback)."""
        sess = getattr(driver, "session", None)
        stall_of = getattr(sess, "stall_of", None)
        if stall_of is None:
            return None
        try:
            import numpy as np

            rows = getattr(driver, "row_sys", None)
            live = np.nonzero(np.asarray(rows) >= 0)[0] if rows is not None else []
            idx = int(live[0]) if len(live) else 0
            return stall_of(
                idx,
                f"injected shard hang (node shard {ev.target}): "
                f"exchange never quiesced; watchdog fired after "
                f"{self.detect_after} barriers with no progress",
            )
        except (IndexError, KeyError, ValueError):
            # no row to diagnose; a device error is not caught here: it
            # is a crash, never a failure to migrate away from
            return None

    def hook(self, k: int, driver) -> None:
        """The ``interval_hook``: raise any failure due at barrier
        ``k``.  ``driver`` is the live serving session driver."""
        if self._hang is not None and k >= self._hang_at + self.detect_after:
            ev, self._hang = self._hang, None
            raise InjectedFailure(ev, k, self._diagnose_hang(ev, driver))
        while self._due and self._due[0].at <= k:
            ev = self._due.pop(0)
            key = ev.spec()
            if key in self._fired:
                continue
            self._fired.add(key)
            if ev.kind == "hang":
                # the shard goes silent now; the watchdog raises later
                if self._hang is None:
                    self._hang, self._hang_at = ev, k
                continue
            raise InjectedFailure(ev, k)


@dataclasses.dataclass
class RecoveryLog:
    """Accumulates structured recovery events + the counters that ride
    checkpoint metadata (schema v2) and the serving artifact."""

    failures_detected: int = 0
    checkpoints: int = 0
    migrations: int = 0
    evacuations: int = 0
    lanes_resumed: int = 0
    jobs_replayed: int = 0
    shed_jobs: int = 0
    retries: int = 0
    events: List[Dict] = dataclasses.field(default_factory=list)

    def record(self, event: str, **fields) -> Dict:
        rec = recovery_record(event, **fields)
        self.events.append(rec)
        return rec

    def counters(self) -> Dict[str, int]:
        """The schema-v2 checkpoint counter quartet."""
        return {
            "migrations": self.migrations,
            "evacuations": self.evacuations,
            "shed_jobs": self.shed_jobs,
            "retries": self.retries,
        }

    def as_dict(self) -> Dict:
        out = {
            "failures_detected": self.failures_detected,
            "checkpoints": self.checkpoints,
            "migrations": self.migrations,
            "evacuations": self.evacuations,
            "lanes_resumed": self.lanes_resumed,
            "jobs_replayed": self.jobs_replayed,
            "shed_jobs": self.shed_jobs,
            "retries": self.retries,
        }
        if self.events:
            out["events"] = list(self.events)
        return out
