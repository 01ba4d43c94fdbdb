"""Lower a ``TransitionTable`` into the planes the kernels execute.

The lowering is *derivational*: every field of ``ProtocolPlanes`` is
computed from table rows (which states answer a WRITEBACK_INT, what a
REPLY_RD flag fills, which states evict dirty, ...), never restated by
hand.  Mutating a row therefore changes the compiled planes, and
through them the spec engine's guards and the JAX/Pallas transition
masks — the property the cross-protocol mutation fuzzing leans on.

``planes_for`` is cached on (protocol, semantics) and runs the full
static check suite as a build-time gate: a table that fails
completeness/determinism/no-silent-drop/state-product/reply-guarantee
never reaches a kernel.

The port's copy of ``hpa2_tpu/protocols/compiler.py`` (l.1-307): the
table-to-planes lowering, kept line for line because the port imports
nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
from typing import Dict, Sequence, Tuple

from hpa2_tpu_torch.config import Semantics
from hpa2_tpu_torch.models.protocol import (
    CacheState,
    DirState,
    MsgType,
    REPLY_RD_EXCLUSIVE,
    REPLY_RD_FORWARD,
    REPLY_RD_SHARED,
)
from hpa2_tpu_torch.analysis.table import (
    MSG_EVENTS,
    TransitionTable,
    build_table,
)

#: table state letters -> enum members
_CACHE_BY_LETTER = {
    "M": CacheState.MODIFIED,
    "E": CacheState.EXCLUSIVE,
    "S": CacheState.SHARED,
    "I": CacheState.INVALID,
    "O": CacheState.OWNED,
    "F": CacheState.FORWARD,
}
_HOME_BY_NAME = {
    "EM": DirState.EM,
    "S": DirState.S,
    "U": DirState.U,
    "SO": DirState.SO,
}
#: REPLY_RD flag symbols (Emit.sharers / REPLY_RD guard-case suffixes)
_RD_FLAGS = {
    "excl": REPLY_RD_EXCLUSIVE,
    "shared": REPLY_RD_SHARED,
    "fwd": REPLY_RD_FORWARD,
    "fwdf": REPLY_RD_FORWARD,
}


class TableCompileError(ValueError):
    """The table violates an invariant the lowering depends on."""


@dataclasses.dataclass(frozen=True)
class ProtocolPlanes:
    """The compiled protocol: int constants + state-set masks.

    Hashable (all-tuple fields) so it can ride jit-cache keys.  State
    ints are ``CacheState``/``DirState`` values; absent states are -1.
    """

    protocol: str
    cache_state_names: Tuple[str, ...]
    home_state_names: Tuple[str, ...]

    # ---- int constants ----
    M: int
    E: int
    S: int
    I: int  # noqa: E741 — the canonical MESI letter
    EM: int
    DS: int
    DU: int
    SO: int  # -1 unless the protocol has the shared-owned dir state
    O: int   # noqa: E741 — -1 unless MOESI
    F: int   # -1 unless MESIF

    # ---- cache-side state-set masks (sorted int tuples) ----
    inv_states: Tuple[int, ...]          # INV match -> INVALID
    wbint_resp_states: Tuple[int, ...]   # answer WRITEBACK_INT w/ FLUSH
    wbint_next_state: int                # responder's next state
    wbint_home_flush_states: Tuple[int, ...]  # responders that copy home
    fwd_count_states: Tuple[int, ...]    # cache-to-cache only (n_forwards)
    wbinv_resp_states: Tuple[int, ...]   # answer WRITEBACK_INV
    notify_pairs: Tuple[Tuple[int, int], ...]  # survivor promote map
    reply_rd_fill: Tuple[Tuple[int, int], ...]  # (flag, fill state)
    flush_fill_state: int                # FLUSH second-receiver fill
    read_hit_states: Tuple[int, ...]     # INSTR_R hit (no traffic)
    silent_write_states: Tuple[int, ...]  # INSTR_W hit, no traffic
    upgrade_write_states: Tuple[int, ...]  # INSTR_W hit -> UPGRADE
    dirty_evict_states: Tuple[int, ...]  # victim emits EVICT_MODIFIED

    # ---- home-side reply-kind constants ----
    rr_u_flag: int    # READ_REQUEST in U: REPLY_RD flag
    rr_s_flag: int    # READ_REQUEST served from dir S memory: flag
    nack_rd_flag: int  # NACK read re-serve: REPLY_RD flag

    @property
    def n_cache_states(self) -> int:
        """Size of the cache-state universe for state_in collapsing."""
        return len(self.cache_state_names)

    @property
    def has_so(self) -> bool:
        return self.SO >= 0

    @property
    def has_fwd(self) -> bool:
        return self.F >= 0

    @property
    def has_owner_plane(self) -> bool:
        """Does the home track an owner/forwarder pointer?"""
        return self.has_so or self.has_fwd

    def digest(self) -> str:
        """Reproducibility digest over the lowered planes."""
        d = dataclasses.asdict(self)
        blob = json.dumps(d, sort_keys=True).encode()
        return hashlib.sha256(blob).hexdigest()


def state_in(x, states: Sequence[int], universe: int):
    """Membership test over cache-state ints as an OR-chain.

    Collapses the (universe-1)-subset to a single ``!=`` against the
    missing member — the MESI fast paths keep their historical
    ``state != INVALID`` form in every protocol.
    """
    members = sorted(set(int(s) for s in states))
    if not members:
        return x != x
    if len(members) >= universe:
        return x == x
    if len(members) == universe - 1:
        missing = next(s for s in range(universe) if s not in members)
        return x != missing
    r = x == members[0]
    for s in members[1:]:
        r = r | (x == s)
    return r


def generated_dispatch() -> Dict[MsgType, str]:
    """The canonical MsgType -> spec-handler-name map, derived from the
    table's event vocabulary.  ``SpecEngine._DISPATCH`` stays a literal
    (the lint rule pins that) and asserts equality against this at
    import, so the literal cannot drift from the table."""
    return {MsgType[name]: "_on_" + name.lower() for name in MSG_EVENTS}


def _states_of(rows, pred) -> Tuple[str, ...]:
    return tuple(sorted({r.state for r in rows if pred(r)}))


def compile_planes(table: TransitionTable) -> ProtocolPlanes:
    """Derive the planes from table rows (no hand-written state sets)."""
    cletters = table.cache_states
    ci = {s: int(_CACHE_BY_LETTER[s]) for s in cletters}
    hi = {s: int(_HOME_BY_NAME[s]) for s in table.home_states}
    sem = table.semantics

    def cs(letters) -> Tuple[int, ...]:
        return tuple(sorted(ci[s] for s in letters))

    crows = [r for r in table.rows if r.role == "cache"]
    hrows = [r for r in table.rows if r.role == "home"]

    def cell(state, event):
        return [r for r in crows if r.state == state and r.event == event]

    # INV: states whose match row actually transitions to INVALID
    # (the I/M drop rows are no-ops, not invalidations)
    inv_states = _states_of(
        crows, lambda r: r.event == "INV" and r.case == "match"
        and not r.drop and r.next_state == "I" and r.state != "I")

    # WRITEBACK_INT responders: any row of the cell emits FLUSH
    def emits_type(r, t):
        return any(e.type == t for e in r.emits)

    wbint_rows = [r for r in crows if r.event == "WRITEBACK_INT"
                  and emits_type(r, "FLUSH")]
    wbint_resp = tuple(sorted({r.state for r in wbint_rows}))
    nexts = {r.next_state for r in wbint_rows}
    if len(nexts) != 1:
        raise TableCompileError(
            f"WRITEBACK_INT responders disagree on the next state: "
            f"{sorted(nexts)} — the lowering needs one")
    wbint_next = ci[nexts.pop()]
    wbint_home_flush = tuple(sorted({
        r.state for r in wbint_rows
        if any(e.type == "FLUSH" and e.to == "home" for e in r.emits)}))
    fwd_count = tuple(s for s in wbint_resp if s not in wbint_home_flush)

    wbinv_resp = _states_of(
        crows, lambda r: r.event == "WRITEBACK_INV"
        and emits_type(r, "FLUSH_INVACK"))

    # survivor promote map (the notify event name depends on the
    # overloaded-notify semantics quirk)
    notify_event = ("EVICT_SHARED" if sem.overloaded_evict_shared_notify
                    else "UPGRADE_NOTIFY")
    notify_pairs = tuple(sorted(
        (ci[r.state], ci[r.next_state])
        for r in crows
        if r.event == notify_event and r.case == "match_from_home"
        and r.next_state != r.state))

    # REPLY_RD fill map from the I-state rows' flag-named cases
    fill = {}
    for r in cell("I", "REPLY_RD"):
        fill[_RD_FLAGS[r.case]] = ci[r.next_state]
    if not fill:
        raise TableCompileError("no REPLY_RD fill rows for INVALID")
    reply_rd_fill = tuple(sorted(fill.items()))

    flush_rows = cell("I", "FLUSH")
    if len(flush_rows) != 1:
        raise TableCompileError("expected exactly one I/FLUSH row")
    flush_fill = ci[flush_rows[0].next_state]

    read_hit = _states_of(
        crows, lambda r: r.event == "INSTR_R" and r.case == "hit")
    silent_write = _states_of(
        crows, lambda r: r.event == "INSTR_W" and r.case == "hit"
        and not r.emits)
    upgrade_write = _states_of(
        crows, lambda r: r.event == "INSTR_W" and r.case == "hit"
        and emits_type(r, "UPGRADE"))
    dirty_evict = _states_of(
        crows, lambda r: r.event == "INSTR_R" and r.case == "miss_victim"
        and emits_type(r, "EVICT_MODIFIED"))

    # home reply kinds
    def rd_flag(state, cases) -> int:
        for r in hrows:
            if r.state == state and r.event == "READ_REQUEST" \
                    and r.case in cases:
                for e in r.emits:
                    if e.type == "REPLY_RD":
                        return _RD_FLAGS[e.sharers]
        raise TableCompileError(
            f"no memory-served REPLY_RD row for home {state}")

    rr_u = rd_flag("U", ("any",))
    rr_s = rd_flag("S", ("any", "no_fwd"))
    nack_rd = rr_s
    for r in hrows:
        if r.event == "NACK" and r.case == "read_intervention":
            for e in r.emits:
                if e.type == "REPLY_RD":
                    nack_rd = _RD_FLAGS[e.sharers]
            break

    return ProtocolPlanes(
        protocol=table.protocol,
        cache_state_names=tuple(cletters),
        home_state_names=tuple(table.home_states),
        M=ci["M"], E=ci["E"], S=ci["S"], I=ci["I"],
        EM=hi["EM"], DS=hi["S"], DU=hi["U"],
        SO=hi.get("SO", -1),
        O=ci.get("O", -1),
        F=ci.get("F", -1),
        inv_states=cs(inv_states),
        wbint_resp_states=cs(wbint_resp),
        wbint_next_state=wbint_next,
        wbint_home_flush_states=cs(wbint_home_flush),
        fwd_count_states=cs(fwd_count),
        wbinv_resp_states=cs(wbinv_resp),
        notify_pairs=notify_pairs,
        reply_rd_fill=reply_rd_fill,
        flush_fill_state=flush_fill,
        read_hit_states=cs(read_hit),
        silent_write_states=cs(silent_write),
        upgrade_write_states=cs(upgrade_write),
        dirty_evict_states=cs(dirty_evict),
        rr_u_flag=rr_u,
        rr_s_flag=rr_s,
        nack_rd_flag=nack_rd,
    )


@functools.lru_cache(maxsize=None)
def planes_for(protocol: str, semantics: Semantics) -> ProtocolPlanes:
    """Build + statically check + lower one protocol's table (cached)."""
    table = build_table(semantics, protocol)
    from hpa2_tpu_torch.analysis.checks import run_static_checks
    errors = [f for f in run_static_checks(table) if f.severity == "error"]
    if errors:
        raise TableCompileError(
            f"the {protocol} table fails its static checks:\n"
            + "\n".join(str(f) for f in errors))
    return compile_planes(table)
