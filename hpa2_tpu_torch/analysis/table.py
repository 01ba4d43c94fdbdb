"""The declarative protocol transition table.

One ``Row`` per (role, current-state, event, guard-case) describes the
complete observable effect of handling one message or issuing one
instruction: next state, symbolic sharer-set update, emissions, memory
write, waiting-flag changes.  ``build_table(semantics)`` materializes
the table for one ``Semantics`` variant — policy switches change row
content, never the case universe, so every variant is checked against
the same exhaustive grid (``CASE_UNIVERSE``).

Two roles partition the protocol:

* ``home``  — the directory FSM (state = ``DirState`` name) reacting to
  messages addressed to the block's home node.
* ``cache`` — the cache-line FSM (state = ``CacheState`` name) reacting
  to replies/interventions/notifications and to the two instruction
  events ``INSTR_R`` / ``INSTR_W``.

A message that touches both (e.g. FLUSH when the requester *is* the
home) composes the two roles' rows — the handlers apply the directory
part and the cache part independently, so the table stays a product of
the two FSMs.

Symbolic vocabulary (resolved to concrete values by
``analysis.extract`` when diffing against backends):

* sharers update: ``same  empty  requester  +requester  -sender
  second  +second``
* emission target: ``requester  owner  home  second  survivor
  sharers  victim_home`` (``sharers`` fans out one copy per set bit,
  excluding the emitting node)
* payload value source: ``mem  line  instr`` (line = the cache line's
  value *before* the transition)
* line fill source (``value_src``): ``msg  pending  instr
  placeholder`` (placeholder = the miss-path invalid fill, value 0)

Guard-cases within a cell are named, mutually exclusive, and must
exactly tile the cell's entry in ``CASE_UNIVERSE`` (or be absorbed by
an ``Unreachable`` declaration carrying a reason) — that is the
completeness check's whole job.

The port's copy of ``hpa2_tpu/analysis/table.py`` (l.1-1376): the
declarative transition tables of MESI, MOESI and MESIF, kept line for
line because the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from hpa2_tpu_torch.config import Semantics

HOME_STATES: Tuple[str, ...] = ("U", "S", "EM")
CACHE_STATES: Tuple[str, ...] = ("M", "E", "S", "I")

#: protocol variants shipped as tables (hpa2_tpu/protocols lowers them
#: into the int-indexed planes the kernels execute)
PROTOCOLS: Tuple[str, ...] = ("mesi", "moesi", "mesif")

#: per-protocol state vocabularies.  MOESI adds the dirty-shared OWNED
#: line state and the SO ("shared, dirty owner") directory state; MESIF
#: adds the clean FORWARD line state (the designated cache-to-cache
#: responder) with the forwarder tracked in the home's owner pointer.
PROTOCOL_CACHE_STATES: Dict[str, Tuple[str, ...]] = {
    "mesi": CACHE_STATES,
    "moesi": ("M", "E", "S", "I", "O"),
    "mesif": ("M", "E", "S", "I", "F"),
}
PROTOCOL_HOME_STATES: Dict[str, Tuple[str, ...]] = {
    "mesi": HOME_STATES,
    "moesi": ("U", "S", "EM", "SO"),
    "mesif": HOME_STATES,
}

#: all message events + the two instruction events
MSG_EVENTS: Tuple[str, ...] = (
    "READ_REQUEST", "WRITE_REQUEST", "REPLY_RD", "REPLY_WR", "REPLY_ID",
    "INV", "UPGRADE", "WRITEBACK_INV", "WRITEBACK_INT", "FLUSH",
    "FLUSH_INVACK", "EVICT_SHARED", "EVICT_MODIFIED", "UPGRADE_NOTIFY",
    "NACK",
)
INSTR_EVENTS: Tuple[str, ...] = ("INSTR_R", "INSTR_W")

REQUEST_EVENTS: Tuple[str, ...] = ("READ_REQUEST", "WRITE_REQUEST", "UPGRADE")
REPLY_TYPES: Tuple[str, ...] = ("REPLY_RD", "REPLY_WR", "REPLY_ID")


@dataclasses.dataclass(frozen=True)
class Emit:
    """One emission: message ``type`` sent to the ``to`` target class.

    ``to`` adds ``tracked_owner`` (the directory's owner/forwarder
    pointer) beyond the MESI target classes; ``sharers`` adds the
    ``fwdf`` REPLY_RD flag (fill the line in FORWARD state, MESIF).
    """

    type: str
    to: str
    value: str = ""    # ''|'mem'|'line'|'instr' — payload value source
    sharers: str = ""  # ''|'excl'|'shared'|'fwdf'|'others'|'none'|'rd'|'wr'
    second: str = ""   # ''|'requester'|'fwd' (fwd = copy msg.second)


@dataclasses.dataclass(frozen=True)
class Row:
    role: str          # 'home' | 'cache'
    state: str         # DirState name | CacheState letter
    event: str         # MsgType name | 'INSTR_R' | 'INSTR_W'
    case: str          # guard-case name, unique within the cell
    next_state: str
    emits: Tuple[Emit, ...] = ()
    sharers: str = ""        # home rows: symbolic sharer-set update
    writes_memory: bool = False
    value_src: str = ""      # cache rows: line fill source
    clears_waiting: bool = False
    sets_waiting: bool = False
    drop: str = ""           # non-empty iff the row is a no-op; cites why
    note: str = ""
    # home rows: symbolic owner/forwarder-pointer update.  '' leaves the
    # pointer untouched (every MESI row); 'none' clears it; 'requester' /
    # 'second' point it at the request's originator; 'owner' points it at
    # find_owner(sharers) before the update; 'same' is an explicit keep;
    # 'drop_sender' clears it iff it currently names the sender.
    owner: str = ""

    @property
    def is_noop(self) -> bool:
        return (
            self.next_state == self.state
            and not self.emits
            and self.sharers in ("", "same")
            and not self.writes_memory
            and self.value_src == ""
            and not self.clears_waiting
            and not self.sets_waiting
            and self.owner in ("", "same")
        )

    @property
    def key(self) -> Tuple[str, str, str, str]:
        return (self.role, self.state, self.event, self.case)


@dataclasses.dataclass(frozen=True)
class Unreachable:
    """Declares a cell (or case) that cannot occur, with a reason.

    ``state``/``case`` may be ``'*'`` to cover every state of an event
    or every case of a cell.  The completeness check requires a reason;
    the determinism check rejects rows inside a covered cell.
    """

    role: str
    event: str
    state: str = "*"
    case: str = "*"
    reason: str = ""

    def covers(self, role: str, state: str, event: str, case: str) -> bool:
        return (
            self.role == role
            and self.event == event
            and self.state in ("*", state)
            and self.case in ("*", case)
        )


# ---------------------------------------------------------------------------
# the guard-case universe: every (role, event) -> {state: cases} cell
# grid the table must tile.  Constant across Semantics variants.
# ---------------------------------------------------------------------------

def _uniform(states: Tuple[str, ...], cases: Tuple[str, ...]) -> Dict[str, Tuple[str, ...]]:
    return {s: cases for s in states}


CASE_UNIVERSE: Dict[Tuple[str, str], Dict[str, Tuple[str, ...]]] = {
    # ---- home (directory) role ----
    ("home", "READ_REQUEST"): {
        "U": ("any",), "S": ("any",),
        "EM": ("owner_is_requester", "owner_is_other"),
    },
    ("home", "WRITE_REQUEST"): {
        "U": ("any",), "S": ("any",),
        "EM": ("owner_is_requester", "owner_is_other"),
    },
    ("home", "UPGRADE"): _uniform(HOME_STATES, ("any",)),
    ("home", "EVICT_SHARED"): {
        "U": ("any",),
        "S": ("sender_only_sharer", "two_sharers", "many_sharers",
              "sender_not_sharer"),
        "EM": ("sender_is_owner", "sender_not_owner"),
    },
    ("home", "EVICT_MODIFIED"): {
        "U": ("any",), "S": ("any",),
        "EM": ("sender_is_owner", "sender_not_owner"),
    },
    ("home", "FLUSH"): _uniform(HOME_STATES, ("any",)),
    ("home", "FLUSH_INVACK"): _uniform(HOME_STATES, ("any",)),
    ("home", "NACK"): _uniform(
        HOME_STATES, ("read_intervention", "write_intervention")
    ),
    # cache-bound messages never consult the directory
    ("home", "REPLY_RD"): _uniform(HOME_STATES, ("any",)),
    ("home", "REPLY_WR"): _uniform(HOME_STATES, ("any",)),
    ("home", "REPLY_ID"): _uniform(HOME_STATES, ("any",)),
    ("home", "INV"): _uniform(HOME_STATES, ("any",)),
    ("home", "WRITEBACK_INT"): _uniform(HOME_STATES, ("any",)),
    ("home", "WRITEBACK_INV"): _uniform(HOME_STATES, ("any",)),
    ("home", "UPGRADE_NOTIFY"): _uniform(HOME_STATES, ("any",)),
    # ---- cache (line) role ----
    ("cache", "REPLY_RD"): {
        "I": ("excl", "shared"),
        **_uniform(("M", "E", "S"),
                   ("match_excl", "match_shared",
                    "victim_excl", "victim_shared")),
    },
    ("cache", "FLUSH"): {
        "I": ("any",),
        **_uniform(("M", "E", "S"), ("match", "victim")),
    },
    ("cache", "REPLY_WR"): {
        "I": ("any",),
        **_uniform(("M", "E", "S"), ("match", "victim")),
    },
    ("cache", "FLUSH_INVACK"): {
        "I": ("any",),
        **_uniform(("M", "E", "S"), ("match", "victim")),
    },
    ("cache", "REPLY_ID"): _uniform(CACHE_STATES, ("match", "other")),
    ("cache", "INV"): _uniform(CACHE_STATES, ("match", "other")),
    ("cache", "WRITEBACK_INT"): {
        **_uniform(("M", "E"),
                   ("match_second_other", "match_second_home", "other")),
        "S": ("any",), "I": ("any",),
    },
    ("cache", "WRITEBACK_INV"): {
        **_uniform(("M", "E"),
                   ("match_second_other", "match_second_home", "other")),
        "S": ("any",), "I": ("any",),
    },
    ("cache", "UPGRADE_NOTIFY"): {
        "S": ("match_from_home", "match_not_home", "other"),
        **_uniform(("M", "E", "I"), ("any",)),
    },
    ("cache", "EVICT_SHARED"): {
        "S": ("match_from_home", "match_not_home", "other"),
        **_uniform(("M", "E", "I"), ("any",)),
    },
    ("cache", "INSTR_R"): {
        **_uniform(("M", "E", "S"), ("hit", "miss_victim")),
        "I": ("miss",),
    },
    ("cache", "INSTR_W"): {
        **_uniform(("M", "E", "S"), ("hit", "miss_victim")),
        "I": ("miss",),
    },
    # directory-bound messages never touch a remote cache line
    ("cache", "READ_REQUEST"): _uniform(CACHE_STATES, ("any",)),
    ("cache", "WRITE_REQUEST"): _uniform(CACHE_STATES, ("any",)),
    ("cache", "UPGRADE"): _uniform(CACHE_STATES, ("any",)),
    ("cache", "EVICT_MODIFIED"): _uniform(CACHE_STATES, ("any",)),
    ("cache", "NACK"): _uniform(CACHE_STATES, ("any",)),
}


@dataclasses.dataclass
class TransitionTable:
    semantics: Semantics
    rows: List[Row]
    unreachable: List[Unreachable]
    protocol: str = "mesi"
    cache_states: Tuple[str, ...] = CACHE_STATES
    home_states: Tuple[str, ...] = HOME_STATES
    case_universe: Optional[
        Dict[Tuple[str, str], Dict[str, Tuple[str, ...]]]] = None

    @property
    def universe(self) -> Dict[Tuple[str, str], Dict[str, Tuple[str, ...]]]:
        """The guard-case grid this table must tile."""
        return self.case_universe if self.case_universe is not None \
            else CASE_UNIVERSE

    def cell(self, role: str, state: str, event: str) -> List[Row]:
        return [
            r for r in self.rows
            if r.role == role and r.state == state and r.event == event
        ]

    def row(self, role: str, state: str, event: str, case: str) -> Row:
        for r in self.rows:
            if r.key == (role, state, event, case):
                return r
        raise KeyError((role, state, event, case))

    def is_unreachable(
        self, role: str, state: str, event: str, case: str
    ) -> bool:
        return any(
            u.covers(role, state, event, case) for u in self.unreachable
        )

    def replaced(self, old: Row, new: Row) -> "TransitionTable":
        rows = [new if r is old else r for r in self.rows]
        return dataclasses.replace(self, rows=rows)


# ---------------------------------------------------------------------------
# table construction
# ---------------------------------------------------------------------------

_DROP_STALE_EVICT = (
    "stale eviction: sender no longer in the sharer set; removing it "
    "again is idempotent (assignment.c:548-560 release build)"
)
_DROP_POLICY = 'Semantics.intervention_miss_policy == "drop"'


def build_table(sem: Semantics, protocol: str = "mesi") -> TransitionTable:
    """Materialize the declarative table for one Semantics variant.

    ``protocol`` selects the row set ("mesi", "moesi", "mesif"); MESI is
    byte-for-byte the historical table.  Non-MESI protocols reject the
    overloaded-notify HEAD quirk (a MESI-fixture artifact).
    """
    if protocol not in PROTOCOLS:
        raise ValueError(
            f"unknown protocol {protocol!r}; expected one of {PROTOCOLS}")
    if protocol == "mesi":
        rows, unreachable = _mesi_rows(sem)
        universe = CASE_UNIVERSE
    else:
        if sem.overloaded_evict_shared_notify:
            raise ValueError(
                "overloaded_evict_shared_notify is a MESI-fixture quirk; "
                f"the {protocol} table does not model it")
        builder = _moesi_rows if protocol == "moesi" else _mesif_rows
        rows, unreachable = builder(sem)
        universe = protocol_case_universe(protocol)
    return TransitionTable(
        semantics=sem, rows=rows, unreachable=unreachable,
        protocol=protocol,
        cache_states=PROTOCOL_CACHE_STATES[protocol],
        home_states=PROTOCOL_HOME_STATES[protocol],
        case_universe=universe)


def _mesi_rows(sem: Semantics) -> Tuple[List[Row], List[Unreachable]]:
    rows: List[Row] = []
    unreachable: List[Unreachable] = []
    nack = sem.intervention_miss_policy == "nack"
    notify = "EVICT_SHARED" if sem.overloaded_evict_shared_notify else "UPGRADE_NOTIFY"

    def home(state, event, case, next_state=None, **kw):
        rows.append(Row("home", state, event, case,
                        next_state if next_state is not None else state, **kw))

    def cache(state, event, case, next_state=None, **kw):
        rows.append(Row("cache", state, event, case,
                        next_state if next_state is not None else state, **kw))

    # ---- home: READ_REQUEST (assignment.c:187-232) ----
    home("U", "READ_REQUEST", "any", "EM", sharers="requester",
         emits=(Emit("REPLY_RD", "requester", value="mem", sharers="excl"),))
    home("S", "READ_REQUEST", "any", "S", sharers="+requester",
         emits=(Emit("REPLY_RD", "requester", value="mem", sharers="shared"),))
    home("EM", "READ_REQUEST", "owner_is_requester", "EM", sharers="same",
         emits=(Emit("REPLY_RD", "requester", value="mem", sharers="excl"),),
         note="owner re-requesting after silent loss (assignment.c:215-221)")
    home("EM", "READ_REQUEST", "owner_is_other", "S", sharers="+requester",
         emits=(Emit("WRITEBACK_INT", "owner", second="requester"),),
         note="optimistic pre-flush S transition (assignment.c:230-231)")

    # ---- home: WRITE_REQUEST (assignment.c:362-430) ----
    eager = sem.eager_write_request_memory
    home("U", "WRITE_REQUEST", "any", "EM", sharers="requester",
         writes_memory=eager,
         emits=(Emit("REPLY_WR", "requester"),))
    home("S", "WRITE_REQUEST", "any", "EM", sharers="requester",
         writes_memory=eager,
         emits=(Emit("REPLY_ID", "requester", sharers="others"),))
    home("EM", "WRITE_REQUEST", "owner_is_requester", "EM", sharers="same",
         writes_memory=eager,
         emits=(Emit("REPLY_WR", "requester"),))
    home("EM", "WRITE_REQUEST", "owner_is_other", "EM", sharers="requester",
         writes_memory=eager,
         emits=(Emit("WRITEBACK_INV", "owner", second="requester"),),
         note="sharers optimistically = requester (assignment.c:429)")

    # ---- home: UPGRADE (assignment.c:300-326) ----
    home("S", "UPGRADE", "any", "EM", sharers="requester",
         emits=(Emit("REPLY_ID", "requester", sharers="others"),))
    for st in ("U", "EM"):
        home(st, "UPGRADE", "any", "EM", sharers="requester",
             emits=(Emit("REPLY_ID", "requester", sharers="none"),),
             note="directory lost track fallback (assignment.c:317-326)")

    # ---- home: EVICT_SHARED (assignment.c:498-521) ----
    home("U", "EVICT_SHARED", "any", drop=_DROP_STALE_EVICT)
    home("S", "EVICT_SHARED", "sender_only_sharer", "U", sharers="empty")
    home("S", "EVICT_SHARED", "two_sharers", "EM", sharers="-sender",
         emits=(Emit(notify, "survivor"),),
         note="last survivor silently upgraded S->E")
    home("S", "EVICT_SHARED", "many_sharers", "S", sharers="-sender")
    home("S", "EVICT_SHARED", "sender_not_sharer", drop=_DROP_STALE_EVICT)
    home("EM", "EVICT_SHARED", "sender_is_owner", "U", sharers="empty")
    home("EM", "EVICT_SHARED", "sender_not_owner", drop=_DROP_STALE_EVICT)

    # ---- home: EVICT_MODIFIED (assignment.c:541-566) ----
    home("U", "EVICT_MODIFIED", "any", writes_memory=True,
         note="stale eviction: memory still updated")
    home("S", "EVICT_MODIFIED", "any", writes_memory=True,
         note="stale eviction: memory still updated, directory untouched")
    home("EM", "EVICT_MODIFIED", "sender_is_owner", "U", sharers="empty",
         writes_memory=True)
    home("EM", "EVICT_MODIFIED", "sender_not_owner", writes_memory=True,
         note="stale eviction: directory untouched (assignment.c:548-560)")

    # ---- home: FLUSH / FLUSH_INVACK directory parts ----
    for st in HOME_STATES:
        home(st, "FLUSH", "any", writes_memory=True,
             note="home part: commit the flushed value")
        home(st, "FLUSH_INVACK", "any", "EM", sharers="second",
             writes_memory=True,
             note="home part: new owner = msg.second_receiver")

    # ---- home: NACK (robust policy only) ----
    if nack:
        for st in ("S", "EM"):
            home(st, "NACK", "read_intervention", "S", sharers="+second",
                 emits=(Emit("REPLY_RD", "second", value="mem",
                             sharers="shared"),),
                 note="re-serve the read from memory")
            home(st, "NACK", "write_intervention", "EM", sharers="second",
                 emits=(Emit("REPLY_WR", "second"),),
                 note="re-serve the write from memory")
        unreachable.append(Unreachable(
            "home", "NACK", "U",
            reason="the home cannot be U while an intervention it "
                   "initiated is outstanding (it moved to S/EM when "
                   "forwarding the WRITEBACK_*)"))
    else:
        unreachable.append(Unreachable(
            "home", "NACK",
            reason="NACK is never emitted under "
                   'Semantics.intervention_miss_policy == "drop"'))

    # cache-bound messages never consult the directory role
    for ev in ("REPLY_RD", "REPLY_WR", "REPLY_ID", "INV",
               "WRITEBACK_INT", "WRITEBACK_INV", "UPGRADE_NOTIFY"):
        unreachable.append(Unreachable(
            "home", ev,
            reason="addressed to a cache line; a home node receiving it "
                   "uses the cache-role rows for its own cache"))

    # ---- cache: REPLY_RD (assignment.c:234-251) ----
    def _victim_emit(state: str) -> Tuple[Emit, ...]:
        if state == "M":
            return (Emit("EVICT_MODIFIED", "victim_home", value="line"),)
        return (Emit("EVICT_SHARED", "victim_home"),)

    cache("I", "REPLY_RD", "excl", "E", value_src="msg", clears_waiting=True)
    cache("I", "REPLY_RD", "shared", "S", value_src="msg", clears_waiting=True)
    for st in ("M", "E", "S"):
        cache(st, "REPLY_RD", "match_excl", "E", value_src="msg",
              clears_waiting=True)
        cache(st, "REPLY_RD", "match_shared", "S", value_src="msg",
              clears_waiting=True)
        cache(st, "REPLY_RD", "victim_excl", "E", value_src="msg",
              clears_waiting=True, emits=_victim_emit(st))
        cache(st, "REPLY_RD", "victim_shared", "S", value_src="msg",
              clears_waiting=True, emits=_victim_emit(st))

    # ---- cache: FLUSH second-receiver part (assignment.c:286-298) ----
    cache("I", "FLUSH", "any", "S", value_src="msg", clears_waiting=True)
    for st in ("M", "E", "S"):
        cache(st, "FLUSH", "match", "S", value_src="msg", clears_waiting=True)
        cache(st, "FLUSH", "victim", "S", value_src="msg",
              clears_waiting=True, emits=_victim_emit(st))

    # ---- cache: REPLY_WR (assignment.c:432-441) ----
    cache("I", "REPLY_WR", "any", "M", value_src="pending",
          clears_waiting=True)
    for st in ("M", "E", "S"):
        cache(st, "REPLY_WR", "match", "M", value_src="pending",
              clears_waiting=True)
        unreachable.append(Unreachable(
            "cache", "REPLY_WR", st, "victim",
            reason="engine asserts the slot is ours or invalid: a "
                   "REPLY_WR can only follow our own WRITE_REQUEST, "
                   "whose placeholder fill owns the slot"))

    # ---- cache: FLUSH_INVACK second-receiver part (assignment.c:474-496) --
    fia_src = "msg" if sem.flush_invack_fills_old_value else "pending"
    cache("I", "FLUSH_INVACK", "any", "M", value_src=fia_src,
          clears_waiting=True)
    for st in ("M", "E", "S"):
        cache(st, "FLUSH_INVACK", "match", "M", value_src=fia_src,
              clears_waiting=True)
        unreachable.append(Unreachable(
            "cache", "FLUSH_INVACK", st, "victim",
            reason="engine asserts the slot is ours or invalid (same "
                   "argument as REPLY_WR)"))

    # ---- cache: REPLY_ID (assignment.c:328-360) ----
    for st in ("I", "E", "S"):
        cache(st, "REPLY_ID", "match", "M", value_src="pending",
              clears_waiting=True,
              emits=(Emit("INV", "sharers"),))
    cache("M", "REPLY_ID", "match", "M", clears_waiting=True,
          emits=(Emit("INV", "sharers"),),
          note="write already applied locally on the S-hit path")
    for st in CACHE_STATES:
        cache(st, "REPLY_ID", "other", clears_waiting=True,
              note="line replaced while waiting: INV fan-out suppressed "
                   "(assignment.c:339-347)")

    # ---- cache: INV (assignment.c:292-299) ----
    for st in ("E", "S"):
        cache(st, "INV", "match", "I")
    cache("M", "INV", "match",
          drop="stale INV: our write raced ahead and the line is "
               "already M (assignment.c:292 guards S/E only)")
    cache("I", "INV", "match",
          drop="stale INV: line already invalid; invalidating again "
               "is idempotent")
    for st in CACHE_STATES:
        cache(st, "INV", "other",
              drop="stale INV: line already replaced by another address")

    # ---- cache: WRITEBACK_INT / WRITEBACK_INV (owner side) ----
    def _miss_row(st, event, case, wr: bool):
        if nack:
            cache(st, event, case,
                  emits=(Emit("NACK", "home", sharers="wr" if wr else "rd",
                              second="fwd"),),
                  note="stale intervention bounced to home")
        else:
            cache(st, event, case, drop=_DROP_POLICY,
                  note="stale intervention silently dropped: the "
                       "requester hangs (assignment.c:265-270)")

    for st in ("M", "E"):
        cache(st, "WRITEBACK_INT", "match_second_other", "S",
              emits=(Emit("FLUSH", "home", value="line", second="fwd"),
                     Emit("FLUSH", "second", value="line", second="fwd")))
        cache(st, "WRITEBACK_INT", "match_second_home", "S",
              emits=(Emit("FLUSH", "home", value="line", second="fwd"),),
              note="requester is the home: single FLUSH")
        _miss_row(st, "WRITEBACK_INT", "other", wr=False)
    cache_states_miss = (("S", "any"), ("I", "any"))
    for st, case in cache_states_miss:
        _miss_row(st, "WRITEBACK_INT", case, wr=False)

    for st in ("M", "E"):
        cache(st, "WRITEBACK_INV", "match_second_other", "I",
              emits=(Emit("FLUSH_INVACK", "home", value="line",
                          second="fwd"),
                     Emit("FLUSH_INVACK", "second", value="line",
                          second="fwd")))
        cache(st, "WRITEBACK_INV", "match_second_home", "I",
              emits=(Emit("FLUSH_INVACK", "home", value="line",
                          second="fwd"),),
              note="requester is the home: single FLUSH_INVACK")
        _miss_row(st, "WRITEBACK_INV", "other", wr=True)
    for st, case in cache_states_miss:
        _miss_row(st, "WRITEBACK_INV", case, wr=True)

    # ---- cache: survivor upgrade notification ----
    _notify_rows = (
        ("match_from_home", "E", ""),
        ("match_not_home", "S",
         "notify must come from the home (spoof guard)"),
        ("other", "S", "stale notify: line already replaced"),
    )

    def _notify_cell(event: str):
        for case, nxt, why in _notify_rows:
            if nxt == "E":
                cache("S", event, case, "E",
                      note="last survivor: silent S->E upgrade")
            else:
                cache("S", event, case, drop=why)
        for st in ("M", "E", "I"):
            cache(st, event, "any",
                  drop="stale notify: line no longer SHARED")

    if sem.overloaded_evict_shared_notify:
        _notify_cell("EVICT_SHARED")
        unreachable.append(Unreachable(
            "cache", "UPGRADE_NOTIFY",
            reason="overloaded-HEAD semantics never emit the distinct "
                   "UPGRADE_NOTIFY type"))
    else:
        _notify_cell("UPGRADE_NOTIFY")
        unreachable.append(Unreachable(
            "cache", "EVICT_SHARED",
            reason="under fixture semantics the survivor notify is the "
                   "distinct UPGRADE_NOTIFY type; EVICT_SHARED is only "
                   "ever addressed to the home"))

    # directory-bound messages never reach the cache role
    for ev in ("READ_REQUEST", "WRITE_REQUEST", "UPGRADE", "EVICT_MODIFIED"):
        unreachable.append(Unreachable(
            "cache", ev,
            reason="requests and evictions are addressed to the home "
                   "directory; the home's own cache is untouched"))
    unreachable.append(Unreachable(
        "cache", "NACK",
        reason="NACK is addressed to the home directory (re-serve path)"))

    # ---- cache: instruction issue (assignment.c:590-697) ----
    for st in ("M", "E", "S"):
        cache(st, "INSTR_R", "hit", note="read hit: no traffic")
        cache(st, "INSTR_R", "miss_victim", "I", value_src="placeholder",
              sets_waiting=True,
              emits=_victim_emit(st) + (Emit("READ_REQUEST", "home"),))
    cache("I", "INSTR_R", "miss", "I", value_src="placeholder",
          sets_waiting=True,
          emits=(Emit("READ_REQUEST", "home"),))

    cache("M", "INSTR_W", "hit", "M", value_src="instr",
          note="write hit on M: local update")
    cache("E", "INSTR_W", "hit", "M", value_src="instr",
          note="silent E->M upgrade")
    cache("S", "INSTR_W", "hit", "M", value_src="instr", sets_waiting=True,
          emits=(Emit("UPGRADE", "home"),),
          note="write applied locally before REPLY_ID (assignment.c:656-658)")
    for st in ("M", "E", "S"):
        cache(st, "INSTR_W", "miss_victim", "I", value_src="placeholder",
              sets_waiting=True,
              emits=_victim_emit(st)
              + (Emit("WRITE_REQUEST", "home", value="instr"),))
    cache("I", "INSTR_W", "miss", "I", value_src="placeholder",
          sets_waiting=True,
          emits=(Emit("WRITE_REQUEST", "home", value="instr"),))

    return rows, unreachable


# ---------------------------------------------------------------------------
# protocol-variant case universes
# ---------------------------------------------------------------------------

def protocol_case_universe(
    protocol: str,
) -> Dict[Tuple[str, str], Dict[str, Tuple[str, ...]]]:
    """The exhaustive guard-case grid for one protocol's table."""
    if protocol == "mesi":
        return CASE_UNIVERSE
    C = PROTOCOL_CACHE_STATES[protocol]
    H = PROTOCOL_HOME_STATES[protocol]
    valid = tuple(s for s in C if s != "I")
    u: Dict[Tuple[str, str], Dict[str, Tuple[str, ...]]] = {}

    if protocol == "moesi":
        u[("home", "READ_REQUEST")] = {
            "U": ("any",), "S": ("any",),
            "EM": ("owner_is_requester", "owner_is_other"),
            "SO": ("owner_is_requester", "owner_is_other"),
        }
        u[("home", "WRITE_REQUEST")] = {
            "U": ("any",), "S": ("any",),
            "EM": ("owner_is_requester", "owner_is_other"),
            "SO": ("any",),
        }
        u[("home", "EVICT_SHARED")] = {
            "U": ("any",),
            "S": ("sender_only_sharer", "two_sharers", "many_sharers",
                  "sender_not_sharer"),
            "EM": ("sender_is_owner", "sender_not_owner"),
            "SO": ("none_left", "one_left", "several_left",
                   "sender_not_sharer"),
        }
        u[("home", "EVICT_MODIFIED")] = {
            "U": ("any",), "S": ("any",),
            "EM": ("sender_is_owner", "sender_not_owner"),
            "SO": ("sender_is_owner_last", "sender_is_owner_more",
                   "sender_not_owner"),
        }
        wbint_resp = ("M", "E", "O")
        notify_states = ("S", "O")
        rd_flags = ("excl", "shared")
    else:  # mesif
        u[("home", "READ_REQUEST")] = {
            "U": ("any",),
            "S": ("no_fwd", "fwd_is_requester", "fwd_other"),
            "EM": ("owner_is_requester", "owner_is_other"),
        }
        u[("home", "WRITE_REQUEST")] = {
            "U": ("any",), "S": ("any",),
            "EM": ("owner_is_requester", "owner_is_other"),
        }
        u[("home", "EVICT_SHARED")] = {
            "U": ("any",),
            "S": ("sender_only_sharer", "two_sharers", "many_sharers",
                  "sender_not_sharer"),
            "EM": ("sender_is_owner", "sender_not_owner"),
        }
        u[("home", "EVICT_MODIFIED")] = {
            "U": ("any",), "S": ("any",),
            "EM": ("sender_is_owner", "sender_not_owner"),
        }
        wbint_resp = ("M", "E", "F")
        notify_states = ("S", "F")
        rd_flags = ("excl", "fwd")

    u[("home", "UPGRADE")] = _uniform(H, ("any",))
    u[("home", "FLUSH")] = _uniform(H, ("any",))
    u[("home", "FLUSH_INVACK")] = _uniform(H, ("any",))
    u[("home", "NACK")] = _uniform(
        H, ("read_intervention", "write_intervention"))
    for ev in ("REPLY_RD", "REPLY_WR", "REPLY_ID", "INV",
               "WRITEBACK_INT", "WRITEBACK_INV", "UPGRADE_NOTIFY"):
        u[("home", ev)] = _uniform(H, ("any",))

    u[("cache", "REPLY_RD")] = {
        "I": rd_flags,
        **_uniform(valid, tuple(f"match_{f}" for f in rd_flags)
                   + tuple(f"victim_{f}" for f in rd_flags)),
    }
    u[("cache", "FLUSH")] = {
        "I": ("any",), **_uniform(valid, ("match", "victim")),
    }
    u[("cache", "REPLY_WR")] = {
        "I": ("any",), **_uniform(valid, ("match", "victim")),
    }
    u[("cache", "FLUSH_INVACK")] = {
        "I": ("any",), **_uniform(valid, ("match", "victim")),
    }
    u[("cache", "REPLY_ID")] = _uniform(C, ("match", "other"))
    u[("cache", "INV")] = _uniform(C, ("match", "other"))
    u[("cache", "WRITEBACK_INT")] = {
        **_uniform(wbint_resp,
                   ("match_second_other", "match_second_home", "other")),
        **_uniform(tuple(s for s in C if s not in wbint_resp), ("any",)),
    }
    u[("cache", "WRITEBACK_INV")] = {
        **_uniform(("M", "E"),
                   ("match_second_other", "match_second_home", "other")),
        **_uniform(tuple(s for s in C if s not in ("M", "E")), ("any",)),
    }
    u[("cache", "UPGRADE_NOTIFY")] = {
        **_uniform(notify_states,
                   ("match_from_home", "match_not_home", "other")),
        **_uniform(tuple(s for s in C if s not in notify_states), ("any",)),
    }
    u[("cache", "EVICT_SHARED")] = _uniform(C, ("any",))
    u[("cache", "INSTR_R")] = {
        **_uniform(valid, ("hit", "miss_victim")), "I": ("miss",),
    }
    u[("cache", "INSTR_W")] = {
        **_uniform(valid, ("hit", "miss_victim")), "I": ("miss",),
    }
    for ev in ("READ_REQUEST", "WRITE_REQUEST", "UPGRADE",
               "EVICT_MODIFIED", "NACK"):
        u[("cache", ev)] = _uniform(C, ("any",))
    return u


# ---------------------------------------------------------------------------
# MOESI rows: the OWNED state keeps dirty data cache-resident after a
# read intervention — the owner answers reads with a cache-to-cache
# FLUSH (requester only; memory stays stale) and the home tracks it in
# the SO directory state's owner pointer.
# ---------------------------------------------------------------------------

def _moesi_rows(sem: Semantics) -> Tuple[List[Row], List[Unreachable]]:
    rows: List[Row] = []
    unreachable: List[Unreachable] = []
    nack = sem.intervention_miss_policy == "nack"
    eager = sem.eager_write_request_memory

    def home(state, event, case, next_state=None, **kw):
        rows.append(Row("home", state, event, case,
                        next_state if next_state is not None else state, **kw))

    def cache(state, event, case, next_state=None, **kw):
        rows.append(Row("cache", state, event, case,
                        next_state if next_state is not None else state, **kw))

    valid = ("M", "E", "S", "O")

    # ---- home: READ_REQUEST ----
    home("U", "READ_REQUEST", "any", "EM", sharers="requester",
         emits=(Emit("REPLY_RD", "requester", value="mem", sharers="excl"),))
    home("S", "READ_REQUEST", "any", "S", sharers="+requester",
         emits=(Emit("REPLY_RD", "requester", value="mem", sharers="shared"),))
    home("EM", "READ_REQUEST", "owner_is_requester", "EM", sharers="same",
         emits=(Emit("REPLY_RD", "requester", value="mem", sharers="excl"),),
         note="owner re-requesting after silent loss")
    home("EM", "READ_REQUEST", "owner_is_other", "SO", sharers="+requester",
         owner="owner",
         emits=(Emit("WRITEBACK_INT", "owner", second="requester"),),
         note="owner keeps the dirty line as OWNED; home tracks it in SO")
    home("SO", "READ_REQUEST", "owner_is_other", "SO", sharers="+requester",
         owner="same",
         emits=(Emit("WRITEBACK_INT", "tracked_owner", second="requester"),),
         note="owner serves every read cache-to-cache while SO")
    home("SO", "READ_REQUEST", "owner_is_requester", "S",
         sharers="+requester", owner="none",
         emits=(Emit("REPLY_RD", "requester", value="mem", sharers="shared"),),
         note="owner lost its line (eviction in flight): demote to clean-"
              "shared; the in-flight EVICT_MODIFIED updates memory as a "
              "stale eviction")

    # ---- home: WRITE_REQUEST ----
    home("U", "WRITE_REQUEST", "any", "EM", sharers="requester",
         writes_memory=eager,
         emits=(Emit("REPLY_WR", "requester"),))
    home("S", "WRITE_REQUEST", "any", "EM", sharers="requester",
         writes_memory=eager,
         emits=(Emit("REPLY_ID", "requester", sharers="others"),))
    home("EM", "WRITE_REQUEST", "owner_is_requester", "EM", sharers="same",
         writes_memory=eager,
         emits=(Emit("REPLY_WR", "requester"),))
    home("EM", "WRITE_REQUEST", "owner_is_other", "EM", sharers="requester",
         writes_memory=eager,
         emits=(Emit("WRITEBACK_INV", "owner", second="requester"),))
    home("SO", "WRITE_REQUEST", "any", "EM", sharers="requester",
         writes_memory=eager, owner="none",
         emits=(Emit("REPLY_ID", "requester", sharers="others"),),
         note="writer invalidates everyone incl. the old owner")

    # ---- home: UPGRADE ----
    home("S", "UPGRADE", "any", "EM", sharers="requester",
         emits=(Emit("REPLY_ID", "requester", sharers="others"),))
    home("SO", "UPGRADE", "any", "EM", sharers="requester", owner="none",
         emits=(Emit("REPLY_ID", "requester", sharers="others"),),
         note="write hit on OWNED upgrades in place; old owner tracking "
              "dissolves")
    for st in ("U", "EM"):
        home(st, "UPGRADE", "any", "EM", sharers="requester",
             emits=(Emit("REPLY_ID", "requester", sharers="none"),),
             note="directory lost track fallback")

    # ---- home: EVICT_SHARED ----
    home("U", "EVICT_SHARED", "any", drop=_DROP_STALE_EVICT)
    home("S", "EVICT_SHARED", "sender_only_sharer", "U", sharers="empty")
    home("S", "EVICT_SHARED", "two_sharers", "EM", sharers="-sender",
         emits=(Emit("UPGRADE_NOTIFY", "survivor"),),
         note="last survivor silently upgraded S->E")
    home("S", "EVICT_SHARED", "many_sharers", "S", sharers="-sender")
    home("S", "EVICT_SHARED", "sender_not_sharer", drop=_DROP_STALE_EVICT)
    home("EM", "EVICT_SHARED", "sender_is_owner", "U", sharers="empty")
    home("EM", "EVICT_SHARED", "sender_not_owner", drop=_DROP_STALE_EVICT)
    home("SO", "EVICT_SHARED", "none_left", "U", sharers="empty",
         owner="none",
         note="stale tracking collapsed: fall back to uncached")
    home("SO", "EVICT_SHARED", "one_left", "EM", sharers="-sender",
         owner="none",
         emits=(Emit("UPGRADE_NOTIFY", "survivor"),),
         note="only the owner remains: promote OWNED->MODIFIED in place")
    home("SO", "EVICT_SHARED", "several_left", "SO", sharers="-sender",
         owner="same")
    home("SO", "EVICT_SHARED", "sender_not_sharer", drop=_DROP_STALE_EVICT)

    # ---- home: EVICT_MODIFIED ----
    home("U", "EVICT_MODIFIED", "any", writes_memory=True,
         note="stale eviction: memory still updated")
    home("S", "EVICT_MODIFIED", "any", writes_memory=True,
         note="stale eviction: memory still updated, directory untouched")
    home("EM", "EVICT_MODIFIED", "sender_is_owner", "U", sharers="empty",
         writes_memory=True)
    home("EM", "EVICT_MODIFIED", "sender_not_owner", writes_memory=True,
         note="stale eviction: directory untouched")
    home("SO", "EVICT_MODIFIED", "sender_is_owner_last", "U",
         sharers="empty", owner="none", writes_memory=True)
    home("SO", "EVICT_MODIFIED", "sender_is_owner_more", "S",
         sharers="-sender", owner="none", writes_memory=True,
         note="owner wrote back: remaining sharers are clean-shared")
    home("SO", "EVICT_MODIFIED", "sender_not_owner", writes_memory=True,
         note="stale eviction: directory untouched")

    # ---- home: FLUSH / FLUSH_INVACK directory parts ----
    for st in PROTOCOL_HOME_STATES["moesi"]:
        home(st, "FLUSH", "any", writes_memory=True,
             note="home part: commit the flushed value")
        home(st, "FLUSH_INVACK", "any", "EM", sharers="second",
             writes_memory=True, owner="none",
             note="home part: new owner = msg.second_receiver")

    # ---- home: NACK (robust policy only) ----
    if nack:
        for st in PROTOCOL_HOME_STATES["moesi"]:
            home(st, "NACK", "read_intervention", "S", sharers="+second",
                 owner="none",
                 emits=(Emit("REPLY_RD", "second", value="mem",
                             sharers="shared"),),
                 note="re-serve the read from memory; owner tracking is "
                      "stale by construction")
            home(st, "NACK", "write_intervention", "EM", sharers="second",
                 owner="none",
                 emits=(Emit("REPLY_WR", "second"),),
                 note="re-serve the write from memory")
    else:
        unreachable.append(Unreachable(
            "home", "NACK",
            reason="NACK is never emitted under "
                   'Semantics.intervention_miss_policy == "drop"'))

    for ev in ("REPLY_RD", "REPLY_WR", "REPLY_ID", "INV",
               "WRITEBACK_INT", "WRITEBACK_INV", "UPGRADE_NOTIFY"):
        unreachable.append(Unreachable(
            "home", ev,
            reason="addressed to a cache line; a home node receiving it "
                   "uses the cache-role rows for its own cache"))

    # ---- cache: fills ----
    def _victim_emit(state: str) -> Tuple[Emit, ...]:
        if state in ("M", "O"):
            return (Emit("EVICT_MODIFIED", "victim_home", value="line"),)
        return (Emit("EVICT_SHARED", "victim_home"),)

    cache("I", "REPLY_RD", "excl", "E", value_src="msg", clears_waiting=True)
    cache("I", "REPLY_RD", "shared", "S", value_src="msg",
          clears_waiting=True)
    for st in valid:
        cache(st, "REPLY_RD", "match_excl", "E", value_src="msg",
              clears_waiting=True)
        cache(st, "REPLY_RD", "match_shared", "S", value_src="msg",
              clears_waiting=True)
        cache(st, "REPLY_RD", "victim_excl", "E", value_src="msg",
              clears_waiting=True, emits=_victim_emit(st))
        cache(st, "REPLY_RD", "victim_shared", "S", value_src="msg",
              clears_waiting=True, emits=_victim_emit(st))

    cache("I", "FLUSH", "any", "S", value_src="msg", clears_waiting=True)
    for st in valid:
        cache(st, "FLUSH", "match", "S", value_src="msg",
              clears_waiting=True)
        cache(st, "FLUSH", "victim", "S", value_src="msg",
              clears_waiting=True, emits=_victim_emit(st))

    cache("I", "REPLY_WR", "any", "M", value_src="pending",
          clears_waiting=True)
    fia_src = "msg" if sem.flush_invack_fills_old_value else "pending"
    cache("I", "FLUSH_INVACK", "any", "M", value_src=fia_src,
          clears_waiting=True)
    for st in valid:
        cache(st, "REPLY_WR", "match", "M", value_src="pending",
              clears_waiting=True)
        cache(st, "FLUSH_INVACK", "match", "M", value_src=fia_src,
              clears_waiting=True)
        for ev in ("REPLY_WR", "FLUSH_INVACK"):
            unreachable.append(Unreachable(
                "cache", ev, st, "victim",
                reason="engine asserts the slot is ours or invalid: the "
                       "reply can only follow our own request, whose "
                       "placeholder fill owns the slot"))

    # ---- cache: REPLY_ID ----
    for st in ("I", "E", "S", "O"):
        cache(st, "REPLY_ID", "match", "M", value_src="pending",
              clears_waiting=True,
              emits=(Emit("INV", "sharers"),))
    cache("M", "REPLY_ID", "match", "M", clears_waiting=True,
          emits=(Emit("INV", "sharers"),),
          note="write already applied locally on the upgrade-hit path")
    for st in PROTOCOL_CACHE_STATES["moesi"]:
        cache(st, "REPLY_ID", "other", clears_waiting=True,
              note="line replaced while waiting: INV fan-out suppressed")

    # ---- cache: INV ----
    for st in ("E", "S", "O"):
        cache(st, "INV", "match", "I")
    cache("M", "INV", "match",
          drop="stale INV: our write raced ahead and the line is "
               "already M")
    cache("I", "INV", "match",
          drop="stale INV: line already invalid; invalidating again "
               "is idempotent")
    for st in PROTOCOL_CACHE_STATES["moesi"]:
        cache(st, "INV", "other",
              drop="stale INV: line already replaced by another address")

    # ---- cache: interventions ----
    def _miss_row(st, event, case, wr: bool):
        if nack:
            cache(st, event, case,
                  emits=(Emit("NACK", "home", sharers="wr" if wr else "rd",
                              second="fwd"),),
                  note="stale intervention bounced to home")
        else:
            cache(st, event, case, drop=_DROP_POLICY,
                  note="stale intervention silently dropped: the "
                       "requester hangs")

    for st in ("M", "E", "O"):
        cache(st, "WRITEBACK_INT", "match_second_other", "O",
              emits=(Emit("FLUSH", "second", value="line", second="fwd"),),
              note="cache-to-cache fill; memory stays stale (OWNED keeps "
                   "the dirty copy)")
        cache(st, "WRITEBACK_INT", "match_second_home", "O",
              emits=(Emit("FLUSH", "second", value="line", second="fwd"),),
              note="requester is the home: single FLUSH (its home part "
                   "also freshens memory)")
        _miss_row(st, "WRITEBACK_INT", "other", wr=False)
    for st in ("S", "I"):
        _miss_row(st, "WRITEBACK_INT", "any", wr=False)

    for st in ("M", "E"):
        cache(st, "WRITEBACK_INV", "match_second_other", "I",
              emits=(Emit("FLUSH_INVACK", "home", value="line",
                          second="fwd"),
                     Emit("FLUSH_INVACK", "second", value="line",
                          second="fwd")))
        cache(st, "WRITEBACK_INV", "match_second_home", "I",
              emits=(Emit("FLUSH_INVACK", "home", value="line",
                          second="fwd"),),
              note="requester is the home: single FLUSH_INVACK")
        _miss_row(st, "WRITEBACK_INV", "other", wr=True)
    for st in ("S", "I", "O"):
        _miss_row(st, "WRITEBACK_INV", "any", wr=True)

    # ---- cache: survivor upgrade notification ----
    cache("S", "UPGRADE_NOTIFY", "match_from_home", "E",
          note="last survivor: silent S->E upgrade")
    cache("S", "UPGRADE_NOTIFY", "match_not_home",
          drop="notify must come from the home (spoof guard)")
    cache("S", "UPGRADE_NOTIFY", "other",
          drop="stale notify: line already replaced")
    cache("O", "UPGRADE_NOTIFY", "match_from_home", "M",
          note="sole survivor owns the only copy: promote OWNED->MODIFIED")
    cache("O", "UPGRADE_NOTIFY", "match_not_home",
          drop="notify must come from the home (spoof guard)")
    cache("O", "UPGRADE_NOTIFY", "other",
          drop="stale notify: line already replaced")
    for st in ("M", "E", "I"):
        cache(st, "UPGRADE_NOTIFY", "any",
              drop="stale notify: line no longer shared")
    unreachable.append(Unreachable(
        "cache", "EVICT_SHARED",
        reason="the survivor notify is the distinct UPGRADE_NOTIFY type; "
               "EVICT_SHARED is only ever addressed to the home"))

    for ev in ("READ_REQUEST", "WRITE_REQUEST", "UPGRADE",
               "EVICT_MODIFIED"):
        unreachable.append(Unreachable(
            "cache", ev,
            reason="requests and evictions are addressed to the home "
                   "directory; the home's own cache is untouched"))
    unreachable.append(Unreachable(
        "cache", "NACK",
        reason="NACK is addressed to the home directory (re-serve path)"))

    # ---- cache: instruction issue ----
    for st in valid:
        cache(st, "INSTR_R", "hit", note="read hit: no traffic")
        cache(st, "INSTR_R", "miss_victim", "I", value_src="placeholder",
              sets_waiting=True,
              emits=_victim_emit(st) + (Emit("READ_REQUEST", "home"),))
    cache("I", "INSTR_R", "miss", "I", value_src="placeholder",
          sets_waiting=True,
          emits=(Emit("READ_REQUEST", "home"),))

    cache("M", "INSTR_W", "hit", "M", value_src="instr",
          note="write hit on M: local update")
    cache("E", "INSTR_W", "hit", "M", value_src="instr",
          note="silent E->M upgrade")
    for st in ("S", "O"):
        cache(st, "INSTR_W", "hit", "M", value_src="instr",
              sets_waiting=True,
              emits=(Emit("UPGRADE", "home"),),
              note="write applied locally before REPLY_ID")
    for st in valid:
        cache(st, "INSTR_W", "miss_victim", "I", value_src="placeholder",
              sets_waiting=True,
              emits=_victim_emit(st)
              + (Emit("WRITE_REQUEST", "home", value="instr"),))
    cache("I", "INSTR_W", "miss", "I", value_src="placeholder",
          sets_waiting=True,
          emits=(Emit("WRITE_REQUEST", "home", value="instr"),))

    return rows, unreachable


# ---------------------------------------------------------------------------
# MESIF rows: the FORWARD state is a single clean designated responder —
# reads in dir-S are served cache-to-cache by the forwarder (tracked in
# the home's owner pointer), and the forwarder role migrates to the most
# recent reader.  Memory is never stale (F is clean).
# ---------------------------------------------------------------------------

def _mesif_rows(sem: Semantics) -> Tuple[List[Row], List[Unreachable]]:
    rows: List[Row] = []
    unreachable: List[Unreachable] = []
    nack = sem.intervention_miss_policy == "nack"
    eager = sem.eager_write_request_memory

    def home(state, event, case, next_state=None, **kw):
        rows.append(Row("home", state, event, case,
                        next_state if next_state is not None else state, **kw))

    def cache(state, event, case, next_state=None, **kw):
        rows.append(Row("cache", state, event, case,
                        next_state if next_state is not None else state, **kw))

    valid = ("M", "E", "S", "F")

    # ---- home: READ_REQUEST ----
    home("U", "READ_REQUEST", "any", "EM", sharers="requester",
         emits=(Emit("REPLY_RD", "requester", value="mem", sharers="excl"),))
    home("S", "READ_REQUEST", "no_fwd", "S", sharers="+requester",
         owner="requester",
         emits=(Emit("REPLY_RD", "requester", value="mem",
                     sharers="fwdf"),),
         note="no live forwarder: serve from memory, reader becomes F")
    home("S", "READ_REQUEST", "fwd_is_requester", "S", sharers="+requester",
         owner="same",
         emits=(Emit("REPLY_RD", "requester", value="mem",
                     sharers="fwdf"),),
         note="forwarder re-requesting after silent loss")
    home("S", "READ_REQUEST", "fwd_other", "S", sharers="+requester",
         owner="requester",
         emits=(Emit("WRITEBACK_INT", "tracked_owner",
                     second="requester"),),
         note="forwarder serves cache-to-cache; the newest reader "
              "becomes the forwarder")
    home("EM", "READ_REQUEST", "owner_is_requester", "EM", sharers="same",
         emits=(Emit("REPLY_RD", "requester", value="mem", sharers="excl"),),
         note="owner re-requesting after silent loss")
    home("EM", "READ_REQUEST", "owner_is_other", "S", sharers="+requester",
         owner="requester",
         emits=(Emit("WRITEBACK_INT", "owner", second="requester"),),
         note="optimistic pre-flush S transition; reader will fill F")

    # ---- home: WRITE_REQUEST ----
    home("U", "WRITE_REQUEST", "any", "EM", sharers="requester",
         writes_memory=eager,
         emits=(Emit("REPLY_WR", "requester"),))
    home("S", "WRITE_REQUEST", "any", "EM", sharers="requester",
         writes_memory=eager, owner="none",
         emits=(Emit("REPLY_ID", "requester", sharers="others"),))
    home("EM", "WRITE_REQUEST", "owner_is_requester", "EM", sharers="same",
         writes_memory=eager,
         emits=(Emit("REPLY_WR", "requester"),))
    home("EM", "WRITE_REQUEST", "owner_is_other", "EM", sharers="requester",
         writes_memory=eager,
         emits=(Emit("WRITEBACK_INV", "owner", second="requester"),))

    # ---- home: UPGRADE ----
    home("S", "UPGRADE", "any", "EM", sharers="requester", owner="none",
         emits=(Emit("REPLY_ID", "requester", sharers="others"),))
    for st in ("U", "EM"):
        home(st, "UPGRADE", "any", "EM", sharers="requester",
             emits=(Emit("REPLY_ID", "requester", sharers="none"),),
             note="directory lost track fallback")

    # ---- home: EVICT_SHARED ----
    home("U", "EVICT_SHARED", "any", drop=_DROP_STALE_EVICT)
    home("S", "EVICT_SHARED", "sender_only_sharer", "U", sharers="empty",
         owner="none")
    home("S", "EVICT_SHARED", "two_sharers", "EM", sharers="-sender",
         owner="none",
         emits=(Emit("UPGRADE_NOTIFY", "survivor"),),
         note="last survivor silently upgraded to E (F included)")
    home("S", "EVICT_SHARED", "many_sharers", "S", sharers="-sender",
         owner="drop_sender",
         note="an evicting forwarder abdicates; next reader re-seeds F")
    home("S", "EVICT_SHARED", "sender_not_sharer", drop=_DROP_STALE_EVICT)
    home("EM", "EVICT_SHARED", "sender_is_owner", "U", sharers="empty")
    home("EM", "EVICT_SHARED", "sender_not_owner", drop=_DROP_STALE_EVICT)

    # ---- home: EVICT_MODIFIED ----
    home("U", "EVICT_MODIFIED", "any", writes_memory=True,
         note="stale eviction: memory still updated")
    home("S", "EVICT_MODIFIED", "any", writes_memory=True,
         note="stale eviction: memory still updated, directory untouched")
    home("EM", "EVICT_MODIFIED", "sender_is_owner", "U", sharers="empty",
         writes_memory=True)
    home("EM", "EVICT_MODIFIED", "sender_not_owner", writes_memory=True,
         note="stale eviction: directory untouched")

    # ---- home: FLUSH / FLUSH_INVACK directory parts ----
    for st in HOME_STATES:
        home(st, "FLUSH", "any", writes_memory=True,
             note="home part: commit the flushed value")
        home(st, "FLUSH_INVACK", "any", "EM", sharers="second",
             writes_memory=True, owner="none",
             note="home part: new owner = msg.second_receiver")

    # ---- home: NACK (robust policy only) ----
    if nack:
        for st in ("S", "EM"):
            home(st, "NACK", "read_intervention", "S", sharers="+second",
                 owner="second",
                 emits=(Emit("REPLY_RD", "second", value="mem",
                             sharers="fwdf"),),
                 note="re-serve the read from memory; reader becomes F")
            home(st, "NACK", "write_intervention", "EM", sharers="second",
                 owner="none",
                 emits=(Emit("REPLY_WR", "second"),),
                 note="re-serve the write from memory")
        unreachable.append(Unreachable(
            "home", "NACK", "U",
            reason="the home cannot be U while an intervention it "
                   "initiated is outstanding (it moved to S/EM when "
                   "forwarding the WRITEBACK_*)"))
    else:
        unreachable.append(Unreachable(
            "home", "NACK",
            reason="NACK is never emitted under "
                   'Semantics.intervention_miss_policy == "drop"'))

    for ev in ("REPLY_RD", "REPLY_WR", "REPLY_ID", "INV",
               "WRITEBACK_INT", "WRITEBACK_INV", "UPGRADE_NOTIFY"):
        unreachable.append(Unreachable(
            "home", ev,
            reason="addressed to a cache line; a home node receiving it "
                   "uses the cache-role rows for its own cache"))

    # ---- cache: fills ----
    def _victim_emit(state: str) -> Tuple[Emit, ...]:
        if state == "M":
            return (Emit("EVICT_MODIFIED", "victim_home", value="line"),)
        return (Emit("EVICT_SHARED", "victim_home"),)

    cache("I", "REPLY_RD", "excl", "E", value_src="msg", clears_waiting=True)
    cache("I", "REPLY_RD", "fwd", "F", value_src="msg", clears_waiting=True)
    for st in valid:
        cache(st, "REPLY_RD", "match_excl", "E", value_src="msg",
              clears_waiting=True)
        cache(st, "REPLY_RD", "match_fwd", "F", value_src="msg",
              clears_waiting=True)
        cache(st, "REPLY_RD", "victim_excl", "E", value_src="msg",
              clears_waiting=True, emits=_victim_emit(st))
        cache(st, "REPLY_RD", "victim_fwd", "F", value_src="msg",
              clears_waiting=True, emits=_victim_emit(st))

    cache("I", "FLUSH", "any", "F", value_src="msg", clears_waiting=True)
    for st in valid:
        cache(st, "FLUSH", "match", "F", value_src="msg",
              clears_waiting=True)
        cache(st, "FLUSH", "victim", "F", value_src="msg",
              clears_waiting=True, emits=_victim_emit(st))

    cache("I", "REPLY_WR", "any", "M", value_src="pending",
          clears_waiting=True)
    fia_src = "msg" if sem.flush_invack_fills_old_value else "pending"
    cache("I", "FLUSH_INVACK", "any", "M", value_src=fia_src,
          clears_waiting=True)
    for st in valid:
        cache(st, "REPLY_WR", "match", "M", value_src="pending",
              clears_waiting=True)
        cache(st, "FLUSH_INVACK", "match", "M", value_src=fia_src,
              clears_waiting=True)
        for ev in ("REPLY_WR", "FLUSH_INVACK"):
            unreachable.append(Unreachable(
                "cache", ev, st, "victim",
                reason="engine asserts the slot is ours or invalid: the "
                       "reply can only follow our own request, whose "
                       "placeholder fill owns the slot"))

    # ---- cache: REPLY_ID ----
    for st in ("I", "E", "S", "F"):
        cache(st, "REPLY_ID", "match", "M", value_src="pending",
              clears_waiting=True,
              emits=(Emit("INV", "sharers"),))
    cache("M", "REPLY_ID", "match", "M", clears_waiting=True,
          emits=(Emit("INV", "sharers"),),
          note="write already applied locally on the upgrade-hit path")
    for st in PROTOCOL_CACHE_STATES["mesif"]:
        cache(st, "REPLY_ID", "other", clears_waiting=True,
              note="line replaced while waiting: INV fan-out suppressed")

    # ---- cache: INV ----
    for st in ("E", "S", "F"):
        cache(st, "INV", "match", "I")
    cache("M", "INV", "match",
          drop="stale INV: our write raced ahead and the line is "
               "already M")
    cache("I", "INV", "match",
          drop="stale INV: line already invalid; invalidating again "
               "is idempotent")
    for st in PROTOCOL_CACHE_STATES["mesif"]:
        cache(st, "INV", "other",
              drop="stale INV: line already replaced by another address")

    # ---- cache: interventions ----
    def _miss_row(st, event, case, wr: bool):
        if nack:
            cache(st, event, case,
                  emits=(Emit("NACK", "home", sharers="wr" if wr else "rd",
                              second="fwd"),),
                  note="stale intervention bounced to home")
        else:
            cache(st, event, case, drop=_DROP_POLICY,
                  note="stale intervention silently dropped: the "
                       "requester hangs")

    for st in ("M", "E"):
        cache(st, "WRITEBACK_INT", "match_second_other", "S",
              emits=(Emit("FLUSH", "home", value="line", second="fwd"),
                     Emit("FLUSH", "second", value="line", second="fwd")))
        cache(st, "WRITEBACK_INT", "match_second_home", "S",
              emits=(Emit("FLUSH", "home", value="line", second="fwd"),),
              note="requester is the home: single FLUSH")
        _miss_row(st, "WRITEBACK_INT", "other", wr=False)
    cache("F", "WRITEBACK_INT", "match_second_other", "S",
          emits=(Emit("FLUSH", "second", value="line", second="fwd"),),
          note="clean cache-to-cache forward: memory is already current, "
               "home copy unnecessary; forwarder demotes to S")
    cache("F", "WRITEBACK_INT", "match_second_home", "S",
          emits=(Emit("FLUSH", "second", value="line", second="fwd"),),
          note="requester is the home: single FLUSH")
    _miss_row("F", "WRITEBACK_INT", "other", wr=False)
    for st in ("S", "I"):
        _miss_row(st, "WRITEBACK_INT", "any", wr=False)

    for st in ("M", "E"):
        cache(st, "WRITEBACK_INV", "match_second_other", "I",
              emits=(Emit("FLUSH_INVACK", "home", value="line",
                          second="fwd"),
                     Emit("FLUSH_INVACK", "second", value="line",
                          second="fwd")))
        cache(st, "WRITEBACK_INV", "match_second_home", "I",
              emits=(Emit("FLUSH_INVACK", "home", value="line",
                          second="fwd"),),
              note="requester is the home: single FLUSH_INVACK")
        _miss_row(st, "WRITEBACK_INV", "other", wr=True)
    for st in ("S", "I", "F"):
        _miss_row(st, "WRITEBACK_INV", "any", wr=True)

    # ---- cache: survivor upgrade notification ----
    for st in ("S", "F"):
        cache(st, "UPGRADE_NOTIFY", "match_from_home", "E",
              note="last survivor: silent upgrade to E")
        cache(st, "UPGRADE_NOTIFY", "match_not_home",
              drop="notify must come from the home (spoof guard)")
        cache(st, "UPGRADE_NOTIFY", "other",
              drop="stale notify: line already replaced")
    for st in ("M", "E", "I"):
        cache(st, "UPGRADE_NOTIFY", "any",
              drop="stale notify: line no longer shared")
    unreachable.append(Unreachable(
        "cache", "EVICT_SHARED",
        reason="the survivor notify is the distinct UPGRADE_NOTIFY type; "
               "EVICT_SHARED is only ever addressed to the home"))

    for ev in ("READ_REQUEST", "WRITE_REQUEST", "UPGRADE",
               "EVICT_MODIFIED"):
        unreachable.append(Unreachable(
            "cache", ev,
            reason="requests and evictions are addressed to the home "
                   "directory; the home's own cache is untouched"))
    unreachable.append(Unreachable(
        "cache", "NACK",
        reason="NACK is addressed to the home directory (re-serve path)"))

    # ---- cache: instruction issue ----
    for st in valid:
        cache(st, "INSTR_R", "hit", note="read hit: no traffic")
        cache(st, "INSTR_R", "miss_victim", "I", value_src="placeholder",
              sets_waiting=True,
              emits=_victim_emit(st) + (Emit("READ_REQUEST", "home"),))
    cache("I", "INSTR_R", "miss", "I", value_src="placeholder",
          sets_waiting=True,
          emits=(Emit("READ_REQUEST", "home"),))

    cache("M", "INSTR_W", "hit", "M", value_src="instr",
          note="write hit on M: local update")
    cache("E", "INSTR_W", "hit", "M", value_src="instr",
          note="silent E->M upgrade")
    for st in ("S", "F"):
        cache(st, "INSTR_W", "hit", "M", value_src="instr",
              sets_waiting=True,
              emits=(Emit("UPGRADE", "home"),),
              note="write applied locally before REPLY_ID")
    for st in valid:
        cache(st, "INSTR_W", "miss_victim", "I", value_src="placeholder",
              sets_waiting=True,
              emits=_victim_emit(st)
              + (Emit("WRITE_REQUEST", "home", value="instr"),))
    cache("I", "INSTR_W", "miss", "I", value_src="placeholder",
          sets_waiting=True,
          emits=(Emit("WRITE_REQUEST", "home", value="instr"),))

    return rows, unreachable
