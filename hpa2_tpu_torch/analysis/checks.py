"""Static whole-table checks over the declarative transition table.

Five check families, each returning ``Finding`` records:

* **completeness** — every (role, state, event) cell of
  ``CASE_UNIVERSE`` is tiled exactly: each guard-case has a row or an
  ``Unreachable`` declaration carrying a reason.  This is the static
  form of the reference's own bug class — silently unhandled
  (state, msg) pairs (SURVEY.md §6.3) — caught before any trace runs.
* **determinism** — no guard-case is claimed twice, no row names a
  case outside its cell's universe, and no row contradicts an
  ``Unreachable`` declaration.
* **no-silent-drop** — a row with zero observable effect must carry a
  ``drop`` citation; a citation that names a ``Semantics`` policy must
  reference a real attribute; conversely a row with effects must not
  carry one.
* **state-product** — every transition's cache x directory product
  stays legal: U directories have empty sharer sets, EM/S non-empty
  updates, cache next-states come from the event's legal set, fills
  clear the waiting flag.
* **reply-guarantee** — every request row has a response path: a
  REPLY_* straight back, or a forwarded intervention whose owner-side
  rows all either FLUSH (home + requester) or NACK back to a home row
  that re-serves.  A policy-cited drop breaks the chain *visibly*
  (warning, not error — it is the documented hang of the drop policy).

The port's copy of ``hpa2_tpu/analysis/checks.py`` (l.1-365): the static
table checks ``planes_for`` gates on, kept line for line because the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from hpa2_tpu_torch.config import Semantics
from hpa2_tpu_torch.analysis.table import (
    MSG_EVENTS,
    REQUEST_EVENTS,
    REPLY_TYPES,
    Row,
    TransitionTable,
)

VALID_MSG_TYPES = set(MSG_EVENTS)
VALID_TARGETS = {
    "requester", "owner", "home", "second", "survivor", "sharers",
    "victim_home", "tracked_owner",
}
VALID_SHARER_UPDATES = {
    "", "same", "empty", "requester", "+requester", "-sender", "second",
    "+second",
}
VALID_OWNER_UPDATES = {
    "", "same", "none", "requester", "second", "owner", "drop_sender",
}
VALID_VALUE_SRC = {"", "msg", "pending", "instr", "placeholder"}

#: legal next cache states per event (same-state no-ops always legal)
LEGAL_CACHE_NEXT: Dict[str, Tuple[str, ...]] = {
    "REPLY_RD": ("E", "S"),
    "FLUSH": ("S",),
    "REPLY_WR": ("M",),
    "FLUSH_INVACK": ("M",),
    "REPLY_ID": ("M",),
    "INV": ("I",),
    "WRITEBACK_INT": ("S",),
    "WRITEBACK_INV": ("I",),
    "UPGRADE_NOTIFY": ("E",),
    "EVICT_SHARED": ("E",),
    "INSTR_R": ("I",),
    "INSTR_W": ("M", "I"),
}

#: protocol deltas on top of the MESI legal-next sets
_LEGAL_CACHE_NEXT_DELTA: Dict[str, Dict[str, Tuple[str, ...]]] = {
    "moesi": {
        "WRITEBACK_INT": ("O",),        # owner keeps the line as OWNED
        "UPGRADE_NOTIFY": ("E", "M"),   # O promotes to M, S to E
    },
    "mesif": {
        "REPLY_RD": ("E", "F"),         # fwdf flag fills FORWARD
        "FLUSH": ("F",),                # cache-to-cache fill becomes F
    },
}


def legal_cache_next(protocol: str) -> Dict[str, Tuple[str, ...]]:
    """The per-event legal next-cache-state sets for one protocol."""
    return {**LEGAL_CACHE_NEXT, **_LEGAL_CACHE_NEXT_DELTA.get(protocol, {})}


@dataclasses.dataclass(frozen=True)
class Finding:
    check: str      # which check family fired
    severity: str   # 'error' | 'warning'
    where: str      # cell / row key rendered for humans
    message: str

    def __str__(self) -> str:
        return f"[{self.severity}] {self.check}: {self.where}: {self.message}"


def _where(role: str, state: str, event: str, case: str = "") -> str:
    s = f"{role}/{state}/{event}"
    return f"{s}/{case}" if case else s


# ---------------------------------------------------------------------------


def check_completeness(table: TransitionTable) -> List[Finding]:
    out: List[Finding] = []
    claimed = {r.key for r in table.rows}
    for (role, event), per_state in table.universe.items():
        for state, cases in per_state.items():
            for case in cases:
                if (role, state, event, case) in claimed:
                    continue
                if table.is_unreachable(role, state, event, case):
                    continue
                out.append(Finding(
                    "completeness", "error", _where(role, state, event, case),
                    "guard-case neither handled by a row nor declared "
                    "unreachable — a message in this state would be "
                    "silently ignored"))
    for u in table.unreachable:
        if not u.reason.strip():
            out.append(Finding(
                "completeness", "error",
                _where(u.role, u.state, u.event, u.case),
                "unreachable declaration carries no reason"))
        if (u.role, u.event) not in table.universe:
            out.append(Finding(
                "completeness", "error",
                _where(u.role, u.state, u.event, u.case),
                "unreachable declaration names an unknown event"))
    return out


def check_determinism(table: TransitionTable) -> List[Finding]:
    out: List[Finding] = []
    seen: Dict[Tuple[str, str, str, str], Row] = {}
    for r in table.rows:
        if r.key in seen:
            out.append(Finding(
                "determinism", "error", _where(*r.key),
                "guard-case claimed by two rows — the transition is "
                "ambiguous"))
        seen[r.key] = r
        universe = table.universe.get((r.role, r.event))
        if universe is None or r.state not in universe:
            out.append(Finding(
                "determinism", "error", _where(*r.key),
                "row names a state/event outside the case universe"))
        elif r.case not in universe[r.state]:
            out.append(Finding(
                "determinism", "error", _where(*r.key),
                f"case {r.case!r} is not in the cell's universe "
                f"{universe[r.state]}"))
        if table.is_unreachable(*r.key):
            out.append(Finding(
                "determinism", "error", _where(*r.key),
                "row contradicts an unreachable declaration for the "
                "same cell"))
    return out


def check_no_silent_drop(table: TransitionTable) -> List[Finding]:
    out: List[Finding] = []
    sem_fields = {f.name for f in dataclasses.fields(Semantics)}
    for r in table.rows:
        if r.event.startswith("INSTR_"):
            # an instruction is never dropped: a zero-traffic row is a
            # hit that retires locally, not a discarded message
            continue
        if r.is_noop and not r.drop.strip():
            out.append(Finding(
                "no-silent-drop", "error", _where(*r.key),
                "row has zero observable effect but no drop citation — "
                "silent drops must say why (policy or idempotence)"))
        if r.drop and not r.is_noop:
            out.append(Finding(
                "no-silent-drop", "error", _where(*r.key),
                "row carries a drop citation but has observable effects"))
        if "Semantics." in r.drop:
            attr = r.drop.split("Semantics.", 1)[1].split()[0].split("=")[0]
            attr = attr.strip(".,;:()\"'")
            if attr not in sem_fields:
                out.append(Finding(
                    "no-silent-drop", "error", _where(*r.key),
                    f"drop cites unknown Semantics attribute {attr!r}"))
    return out


def check_state_product(table: TransitionTable) -> List[Finding]:
    out: List[Finding] = []
    for r in table.rows:
        if r.owner not in VALID_OWNER_UPDATES:
            out.append(Finding(
                "state-product", "error", _where(*r.key),
                f"unknown owner-pointer update {r.owner!r}"))
        if r.role == "cache" and r.owner not in ("", "same"):
            out.append(Finding(
                "state-product", "error", _where(*r.key),
                "only home rows may update the owner pointer"))
        if table.protocol == "mesi" and r.owner != "":
            out.append(Finding(
                "state-product", "error", _where(*r.key),
                "MESI has no owner pointer; the row must leave it alone"))
        if r.role == "home":
            if r.sharers not in VALID_SHARER_UPDATES:
                out.append(Finding(
                    "state-product", "error", _where(*r.key),
                    f"unknown sharer update {r.sharers!r}"))
                continue
            nxt, upd = r.next_state, r.sharers
            if nxt == "U" and upd not in ("", "empty", "same"):
                out.append(Finding(
                    "state-product", "error", _where(*r.key),
                    f"directory U must have an empty sharer set, got "
                    f"update {upd!r}"))
            if nxt == "U" and upd == "same" and r.state != "U":
                out.append(Finding(
                    "state-product", "error", _where(*r.key),
                    "transition into U must clear the sharer set"))
            if nxt in ("EM", "S", "SO") and upd == "empty":
                out.append(Finding(
                    "state-product", "error", _where(*r.key),
                    f"directory {nxt} requires a non-empty sharer set"))
            if nxt == "EM" and upd in ("+requester", "+second", "-sender"):
                # EM = exactly one holder: additive/subtractive updates
                # cannot guarantee a singleton — except -sender leaving
                # exactly one, which the two_sharers / one_left cases
                # encode.
                if r.case not in ("two_sharers", "one_left"):
                    out.append(Finding(
                        "state-product", "error", _where(*r.key),
                        f"directory EM requires a singleton sharer set; "
                        f"update {upd!r} cannot guarantee that"))
            if nxt == "SO" and r.owner in ("none",):
                out.append(Finding(
                    "state-product", "error", _where(*r.key),
                    "directory SO requires a live owner pointer"))
            if nxt == "U" and r.owner not in ("", "none", "same"):
                out.append(Finding(
                    "state-product", "error", _where(*r.key),
                    "directory U cannot track an owner"))
        else:
            if r.value_src not in VALID_VALUE_SRC:
                out.append(Finding(
                    "state-product", "error", _where(*r.key),
                    f"unknown value source {r.value_src!r}"))
            legal = legal_cache_next(table.protocol).get(r.event)
            if legal is not None and r.next_state != r.state \
                    and r.next_state not in legal:
                out.append(Finding(
                    "state-product", "error", _where(*r.key),
                    f"illegal next cache state {r.next_state} for "
                    f"{r.event} (legal: {legal} or unchanged)"))
            if r.event in REPLY_TYPES and not r.drop \
                    and not r.clears_waiting:
                out.append(Finding(
                    "state-product", "error", _where(*r.key),
                    "a handled reply must clear the waiting flag or the "
                    "requester hangs"))
            if r.value_src in ("msg", "pending") and r.next_state == "I":
                out.append(Finding(
                    "state-product", "error", _where(*r.key),
                    "a data fill cannot leave the line INVALID"))
        for e in r.emits:
            if e.type not in VALID_MSG_TYPES:
                out.append(Finding(
                    "state-product", "error", _where(*r.key),
                    f"emission names unknown message type {e.type!r}"))
            if e.to not in VALID_TARGETS:
                out.append(Finding(
                    "state-product", "error", _where(*r.key),
                    f"emission names unknown target class {e.to!r}"))
    return out


def check_reply_guarantee(table: TransitionTable) -> List[Finding]:
    out: List[Finding] = []

    def intervention_closes(wb_event: str) -> List[Finding]:
        """Do the owner-side rows of a forwarded intervention always
        answer someone?"""
        local: List[Finding] = []
        for r in table.rows:
            if r.role != "cache" or r.event != wb_event:
                continue
            if table.is_unreachable(*r.key):
                continue
            flushes = any(e.type in ("FLUSH", "FLUSH_INVACK")
                          for e in r.emits)
            nacks = any(e.type == "NACK" and e.to == "home"
                        for e in r.emits)
            if flushes or nacks:
                continue
            if r.drop and "Semantics." in r.drop:
                local.append(Finding(
                    "reply-guarantee", "warning", _where(*r.key),
                    f"response chain for {wb_event} ends in a "
                    f"policy-cited drop — the requester hangs (the "
                    f"documented cost of {r.drop})"))
            else:
                local.append(Finding(
                    "reply-guarantee", "error", _where(*r.key),
                    f"owner-side {wb_event} row neither flushes nor "
                    f"NACKs: the requester can never be answered"))
        return local

    def nack_closes() -> List[Finding]:
        local: List[Finding] = []
        rows = [r for r in table.rows
                if r.role == "home" and r.event == "NACK"]
        for r in rows:
            if not any(e.type in ("REPLY_RD", "REPLY_WR")
                       and e.to == "second" for e in r.emits):
                local.append(Finding(
                    "reply-guarantee", "error", _where(*r.key),
                    "home NACK row does not re-serve the stalled "
                    "requester (msg.second_receiver)"))
        return local

    chained = set()
    for r in table.rows:
        if r.role != "home" or r.event not in REQUEST_EVENTS:
            continue
        replies = any(e.type in REPLY_TYPES and e.to == "requester"
                      for e in r.emits)
        forwards = [e.type for e in r.emits
                    if e.type in ("WRITEBACK_INT", "WRITEBACK_INV")
                    and e.to in ("owner", "tracked_owner")]
        if replies:
            continue
        if forwards:
            for wb in forwards:
                if wb not in chained:
                    chained.add(wb)
                    out.extend(intervention_closes(wb))
            continue
        out.append(Finding(
            "reply-guarantee", "error", _where(*r.key),
            f"request row neither replies to the requester nor forwards "
            f"an intervention — {r.event} would hang its sender"))
    if any(r.event == "NACK" and r.role == "home" for r in table.rows):
        out.extend(nack_closes())
    return out


ALL_CHECKS = (
    check_completeness,
    check_determinism,
    check_no_silent_drop,
    check_state_product,
    check_reply_guarantee,
)


def run_static_checks(table: TransitionTable) -> List[Finding]:
    """Run every check family; errors first, then warnings."""
    findings: List[Finding] = []
    for chk in ALL_CHECKS:
        findings.extend(chk(table))
    findings.sort(key=lambda f: (f.severity != "error", f.check, f.where))
    return findings
