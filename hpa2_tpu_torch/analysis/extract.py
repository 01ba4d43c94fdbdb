"""Probe-based cross-backend transition-table extraction, the port of
``hpa2_tpu/analysis/extract.py``.

For every declared ``Row`` this module builds one concrete single-node
scenario (states, sentinel values, one message or instruction), runs it
through a backend, and diffs the observed effect against the row's
symbolic claim resolved over the same scenario.  Three backends share
the scenario set:

* **spec**   — ``SpecEngine._handle`` / ``_issue`` called directly on a
  crafted node; emissions read from the engine outbox.
* **jax**    — one cycle of the general engine's step
  (``ops/step.py:build_step``, run eagerly) over a crafted ``SimState``;
  emissions read from the other nodes' mailboxes after end-of-cycle
  delivery (nobody else acts: empty traces, empty boxes).  Scenarios
  are the systems of one batch: one step probes every row.
* **native** — the ``hpa2_probe_transition`` C API of ``native/src``,
  through the port's own build (``hpa2_tpu_torch/native.py``).
* **pallas** — ONE cycle of the fast path's per-call kernel (K3,
  ``csrc/call_run.cu`` through ``ops/kernels.py:call_run`` at k=1,
  window 1, gate off); each scenario is staged into the packed word
  planes of one lane and emissions read back out of the other nodes'
  packed mailboxes, so the diff covers the word packing and the
  candidate-grid delivery, not just the cycle math.  Every scenario is
  a lane of one launch.  On CPU tensors the wrapper runs K3's plain
  version (``ops/call_run.py:call_plain``); on CUDA tensors it launches
  K3.

The two device probers run on ``cuda`` unless given ``device="cpu"``;
without a card they raise.

Sentinel values make data-flow claims checkable: memory holds 77, the
preloaded line 55, ``pending_write`` 66, the message payload 88, the
instruction payload 99 — so e.g. a REPLY_WR that filled the line from
the message instead of the pending write is a visible diff, not a
coincidence.

The reference geometry (4 nodes / 4 lines / 16 blocks) fixes the cast:
address 19 lives at home 1 / block 3 / line 3; the victim address 51
shares line 3 but homes at node 3.  The probed home node is 1, the
probed cache node 2, the requester 2, the displaced owner 3.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from hpa2_tpu_torch.config import Semantics, SystemConfig
from hpa2_tpu_torch.models.protocol import (
    CacheState,
    DirState,
    Instr,
    INVALID_ADDR,
    Message,
    MsgType,
    NO_PROC,
    bit,
)
from hpa2_tpu_torch.analysis.table import Row, TransitionTable, build_table

# sentinels (see module docstring)
MEM_SENTINEL = 77
LINE_SENTINEL = 55
PENDING_SENTINEL = 66
MSG_SENTINEL = 88
INSTR_SENTINEL = 99

# cast and geometry (reference config 4/4/16)
ADDR = 19          # home 1, block 3, cache line 3
VICTIM_ADDR = 51   # home 3, block 3, cache line 3 (same line, other home)
HOME = 1
CACHE_NODE = 2
REQUESTER = 2
OWNER = 3
OTHER = 0

_CACHE_NUM = {"M": 0, "E": 1, "S": 2, "I": 3, "O": 4, "F": 5}
_DIR_NUM = {"EM": 0, "S": 1, "U": 2, "SO": 3}

#: initial directory sharer masks per (event, state, case) — chosen so
#: every symbolic update resolves to a distinct concrete mask
_HOME_SHARERS: Dict[Tuple[str, str], int] = {
    ("READ_REQUEST", "U"): 0,
    ("READ_REQUEST", "S"): bit(OTHER) | bit(OWNER),
    ("WRITE_REQUEST", "U"): 0,
    ("WRITE_REQUEST", "S"): bit(OTHER) | bit(OWNER),
    ("UPGRADE", "U"): 0,
    ("UPGRADE", "S"): bit(OTHER) | bit(REQUESTER) | bit(OWNER),
    ("UPGRADE", "EM"): bit(OWNER),
    ("EVICT_SHARED", "U"): 0,
    ("EVICT_MODIFIED", "U"): 0,
    ("EVICT_MODIFIED", "S"): bit(OTHER) | bit(OWNER),
    ("FLUSH", "U"): 0,
    ("FLUSH", "S"): bit(OTHER) | bit(REQUESTER),
    ("FLUSH", "EM"): bit(OWNER),
    ("FLUSH_INVACK", "U"): 0,
    ("FLUSH_INVACK", "S"): bit(OTHER) | bit(REQUESTER),
    ("FLUSH_INVACK", "EM"): bit(OWNER),
    ("NACK", "S"): bit(OTHER) | bit(OWNER),
    ("NACK", "EM"): bit(OWNER),
    # MOESI SO cells (the tracked owner stays a sharer by invariant)
    ("WRITE_REQUEST", "SO"): bit(OTHER) | bit(OWNER),
    ("UPGRADE", "SO"): bit(OTHER) | bit(REQUESTER) | bit(OWNER),
    ("FLUSH", "SO"): bit(OTHER) | bit(REQUESTER) | bit(OWNER),
    ("FLUSH_INVACK", "SO"): bit(OTHER) | bit(REQUESTER) | bit(OWNER),
    ("NACK", "SO"): bit(OTHER) | bit(OWNER),
    ("EVICT_MODIFIED", "SO"): bit(OWNER),
}
_HOME_SHARERS_BY_CASE: Dict[str, int] = {
    "owner_is_requester": bit(REQUESTER),
    "owner_is_other": bit(OWNER),
    "sender_only_sharer": bit(REQUESTER),
    "two_sharers": bit(REQUESTER) | bit(OWNER),
    "many_sharers": bit(OTHER) | bit(REQUESTER) | bit(OWNER),
    "sender_not_sharer": bit(OTHER) | bit(OWNER),
    "sender_is_owner": bit(REQUESTER),
    "sender_not_owner": bit(OWNER),
    # MOESI SO eviction cases (sender = REQUESTER, tracked owner = the
    # staged dir_owner; "sender_is_owner_*" stage the sender as owner)
    "none_left": bit(REQUESTER),
    "one_left": bit(REQUESTER) | bit(OWNER),
    "several_left": bit(OTHER) | bit(REQUESTER) | bit(OWNER),
    "sender_is_owner_last": bit(REQUESTER),
    "sender_is_owner_more": bit(REQUESTER) | bit(OTHER),
    # MESIF forwarder cases on a shared line (requester not a sharer)
    "no_fwd": bit(OTHER) | bit(OWNER),
    "fwd_is_requester": bit(REQUESTER) | bit(OTHER),
    "fwd_other": bit(OTHER) | bit(OWNER),
}

#: REPLY_ID fan-out mask: includes the receiver itself to prove the
#: self-exclusion — expected INVs go to OTHER and OWNER only
_FANOUT_MASK = bit(OTHER) | bit(CACHE_NODE) | bit(OWNER)
_FANOUT_TARGETS = (OTHER, OWNER)


@dataclasses.dataclass
class Scenario:
    """One concrete probe setup (receiver-node state + stimulus)."""

    receiver: int
    is_instr: bool = False
    instr_op: str = "R"
    instr_addr: int = ADDR
    instr_value: int = 0
    msg_type: int = 0
    msg_sender: int = HOME
    msg_addr: int = ADDR
    msg_value: int = 0
    msg_sharers: int = 0
    msg_second: int = NO_PROC
    line_index: int = 3
    line_addr: int = INVALID_ADDR
    line_value: int = 0
    line_state: int = int(CacheState.INVALID)
    dir_blk: int = 3
    dir_state: int = int(DirState.U)
    dir_sharers: int = 0
    dir_owner: int = NO_PROC
    mem_blk: int = 3
    mem_value: int = MEM_SENTINEL
    pending: int = PENDING_SENTINEL
    waiting: bool = False


@dataclasses.dataclass
class Observed:
    """Post-transition state of the probed node plus its emissions.

    ``emits`` entries are ``(receiver, type, value, second, sharers)``
    with ``None`` meaning "don't care" (only produced on the expected
    side)."""

    line_addr: int
    line_value: int
    line_state: int
    dir_state: int
    dir_sharers: int
    mem_value: int
    waiting: bool
    emits: List[Tuple]
    dir_owner: int = NO_PROC

    def normalized(self) -> "Observed":
        return dataclasses.replace(
            self, emits=sorted(self.emits, key=lambda e: (e[0], e[1]))
        )


# ---------------------------------------------------------------------------
# scenario construction
# ---------------------------------------------------------------------------


def scenario_for(row: Row, protocol: str = "mesi") -> Optional[Scenario]:
    """Concrete probe setup for one declared row (None = not probeable:
    the row's guard needs multi-node context the probe cannot stage)."""
    if row.role == "home":
        return _home_scenario(row, protocol)
    return _cache_scenario(row)


def _home_owner(row: Row, protocol: str) -> int:
    """Initial tracked-owner/forwarder pointer for an owner-plane
    protocol, chosen so every symbolic owner update resolves to a
    transition the probe can see (set->cleared, set->moved, kept)."""
    if row.state == "SO":
        # invariant: the tracked owner is a sharer; "sender_is_owner_*"
        # cases make the evicting sender (REQUESTER) that owner
        if row.case in ("owner_is_requester", "sender_is_owner_last",
                        "sender_is_owner_more"):
            return REQUESTER
        return OWNER
    if protocol == "moesi" or row.state == "U":
        # MOESI tracks an owner only while SO; staging one elsewhere
        # would probe an unreachable configuration
        return NO_PROC
    if row.case in ("fwd_is_requester", "sender_only_sharer",
                    "two_sharers", "many_sharers"):
        return REQUESTER
    if row.case == "no_fwd":
        return NO_PROC
    if row.case == "fwd_other" or row.event in (
            "NACK", "FLUSH", "FLUSH_INVACK", "WRITE_REQUEST", "UPGRADE"):
        return OWNER
    return NO_PROC


def _home_scenario(row: Row, protocol: str = "mesi") -> Scenario:
    from hpa2_tpu_torch.protocols.compiler import planes_for

    scn = Scenario(receiver=HOME)
    scn.dir_state = _DIR_NUM[row.state]
    scn.dir_sharers = _HOME_SHARERS_BY_CASE.get(
        row.case, _HOME_SHARERS.get((row.event, row.state), 0)
    )
    if planes_for(protocol, Semantics()).has_owner_plane:
        scn.dir_owner = _home_owner(row, protocol)
    scn.msg_type = int(MsgType[row.event])
    scn.msg_sender = REQUESTER
    if row.event in ("FLUSH", "FLUSH_INVACK"):
        scn.msg_sender = OWNER
        scn.msg_second = OTHER
        scn.msg_value = MSG_SENTINEL
    elif row.event == "NACK":
        scn.msg_sender = OWNER
        scn.msg_second = REQUESTER
        scn.msg_sharers = 1 if row.case == "write_intervention" else 0
    elif row.event in ("WRITE_REQUEST", "EVICT_MODIFIED"):
        scn.msg_value = MSG_SENTINEL
    return scn


def _cache_scenario(row: Row) -> Scenario:
    scn = Scenario(receiver=CACHE_NODE)
    case = row.case
    # line setup: match cases hold the probed address, victim/other
    # cases a displaced one, INVALID-state cells the placeholder fill
    if row.state == "I":
        scn.line_state = int(CacheState.INVALID)
        scn.line_addr = VICTIM_ADDR if case == "other" else ADDR
        scn.line_value = 0
    else:
        scn.line_state = _CACHE_NUM[row.state]
        scn.line_value = LINE_SENTINEL
        if case.startswith(("victim", "miss_victim")) or case == "other":
            scn.line_addr = VICTIM_ADDR
        else:
            scn.line_addr = ADDR
    if row.event in ("INSTR_R", "INSTR_W"):
        scn.is_instr = True
        scn.instr_op = "R" if row.event == "INSTR_R" else "W"
        scn.instr_value = INSTR_SENTINEL if row.event == "INSTR_W" else 0
        return scn
    scn.msg_type = int(MsgType[row.event])
    if row.event in ("REPLY_RD", "REPLY_WR", "REPLY_ID", "FLUSH",
                     "FLUSH_INVACK"):
        scn.waiting = True
    if row.event == "REPLY_RD":
        scn.msg_value = MSG_SENTINEL
        # fill-flag wire values: 2 = exclusive, 1 = forward (MESIF), 0
        # = plain shared
        scn.msg_sharers = (2 if case.endswith("excl")
                           else 1 if case.endswith("fwd") else 0)
    elif row.event == "REPLY_ID":
        scn.msg_sharers = _FANOUT_MASK
    elif row.event in ("FLUSH", "FLUSH_INVACK"):
        scn.msg_sender = OWNER
        scn.msg_second = CACHE_NODE
        scn.msg_value = MSG_SENTINEL
    elif row.event in ("WRITEBACK_INT", "WRITEBACK_INV"):
        scn.msg_sender = HOME
        scn.msg_second = HOME if case == "match_second_home" else OTHER
    elif row.event in ("UPGRADE_NOTIFY", "EVICT_SHARED"):
        scn.msg_sender = OWNER if case == "match_not_home" else HOME
    elif row.event == "INV":
        scn.msg_sender = OTHER
    return scn


# ---------------------------------------------------------------------------
# expected observation (the row's symbolic claim resolved over the
# scenario)
# ---------------------------------------------------------------------------


def _resolve_sharers(update: str, init: int, second: int) -> int:
    if update in ("", "same"):
        return init
    if update == "empty":
        return 0
    if update == "requester":
        return bit(REQUESTER)
    if update == "+requester":
        return init | bit(REQUESTER)
    if update == "-sender":
        return init & ~bit(REQUESTER)
    if update == "second":
        return bit(second)
    if update == "+second":
        return init | bit(second)
    raise ValueError(f"unknown sharer update {update!r}")


def _emit_value(src: str) -> Optional[int]:
    return {"": None, "mem": MEM_SENTINEL, "line": LINE_SENTINEL,
            "instr": INSTR_SENTINEL}[src]


def _emit_sharers(sym: str, init_sharers: int) -> Optional[int]:
    if sym == "":
        return None
    if sym == "excl":
        return 2
    if sym == "fwdf":  # MESIF fill-as-forwarder flag
        return 1
    if sym in ("shared", "none", "rd"):
        return 0
    if sym == "wr":
        return 1
    if sym == "others":
        return init_sharers & ~bit(REQUESTER)
    raise ValueError(f"unknown emission sharer symbol {sym!r}")


def _resolve_owner(update: str, scn: Scenario) -> int:
    from hpa2_tpu_torch.models.protocol import find_owner

    if update in ("", "same"):
        return scn.dir_owner
    if update == "none":
        return NO_PROC
    if update == "requester":
        return REQUESTER
    if update == "second":
        return scn.msg_second
    if update == "owner":  # the EM owner, found from the sharer mask
        return find_owner(scn.dir_sharers)
    if update == "drop_sender":
        return (NO_PROC if scn.dir_owner == scn.msg_sender
                else scn.dir_owner)
    raise ValueError(f"unknown owner update {update!r}")


def expected_for(row: Row, scn: Scenario) -> Observed:
    if row.role == "home":
        dir_state = _DIR_NUM[row.next_state]
        dir_sharers = _resolve_sharers(
            row.sharers, scn.dir_sharers, scn.msg_second
        )
        dir_owner = _resolve_owner(row.owner, scn)
        line = (scn.line_addr, scn.line_value, scn.line_state)
    else:
        dir_state = scn.dir_state
        dir_sharers = scn.dir_sharers
        dir_owner = scn.dir_owner
        fill = {"msg": MSG_SENTINEL, "pending": PENDING_SENTINEL,
                "instr": INSTR_SENTINEL, "placeholder": 0}
        if row.value_src:
            tgt = scn.instr_addr if scn.is_instr else scn.msg_addr
            line = (tgt, fill[row.value_src], _CACHE_NUM[row.next_state])
        else:
            line = (scn.line_addr, scn.line_value,
                    _CACHE_NUM[row.next_state])
    mem = MSG_SENTINEL if row.writes_memory else scn.mem_value
    waiting = row.sets_waiting or (scn.waiting and not row.clears_waiting)

    emits: List[Tuple] = []
    targets = {
        "requester": REQUESTER, "owner": OWNER, "home": HOME,
        "second": scn.msg_second, "survivor": OWNER,
        "victim_home": VICTIM_ADDR // 16,
        "tracked_owner": scn.dir_owner,
    }
    seconds = {"": None, "requester": REQUESTER, "fwd": scn.msg_second}
    for e in row.emits:
        mtype = int(MsgType[e.type])
        value = _emit_value(e.value)
        second = seconds[e.second]
        sharers = _emit_sharers(e.sharers, scn.dir_sharers)
        if e.to == "sharers":
            emits.extend(
                (t, mtype, value, second, sharers) for t in _FANOUT_TARGETS
            )
        else:
            emits.append((targets[e.to], mtype, value, second, sharers))
    return Observed(
        line_addr=line[0], line_value=line[1], line_state=line[2],
        dir_state=dir_state, dir_sharers=dir_sharers, mem_value=mem,
        waiting=waiting, emits=emits, dir_owner=dir_owner,
    ).normalized()


# ---------------------------------------------------------------------------
# backend probes
# ---------------------------------------------------------------------------


def _stage_spec_node(eng, scn: Scenario) -> None:
    """Write one scenario's receiver-node state into a SpecEngine."""
    node = eng.nodes[scn.receiver]
    line = node.cache[scn.line_index]
    line.address = scn.line_addr
    line.value = scn.line_value
    line.state = CacheState(scn.line_state)
    entry = node.directory[scn.dir_blk]
    entry.state = DirState(scn.dir_state)
    entry.sharers = scn.dir_sharers
    entry.owner = scn.dir_owner
    node.memory[scn.mem_blk] = scn.mem_value
    node.pending_write = scn.pending
    node.waiting = scn.waiting


def probe_spec(
    scn: Scenario, sem: Semantics, protocol: str = "mesi"
) -> Observed:
    from hpa2_tpu_torch.models.spec_engine import SpecEngine

    cfg = SystemConfig(semantics=sem, protocol=protocol)
    eng = SpecEngine(cfg, [[] for _ in range(cfg.num_procs)])
    _stage_spec_node(eng, scn)
    node = eng.nodes[scn.receiver]
    line = node.cache[scn.line_index]
    entry = node.directory[scn.dir_blk]
    if scn.is_instr:
        node.trace = [Instr(scn.instr_op, scn.instr_addr, scn.instr_value)]
        node.pc = 0
        eng._issue(node)
    else:
        eng._handle(node, Message(
            MsgType(scn.msg_type), scn.msg_sender, scn.msg_addr,
            value=scn.msg_value, sharers=scn.msg_sharers,
            second_receiver=scn.msg_second,
        ))
    emits = [
        (recv, int(m.type), m.value, m.second_receiver, m.sharers)
        for (_ph, _snd, recv, m) in eng._outbox
    ]
    return Observed(
        line_addr=line.address, line_value=line.value,
        line_state=int(line.state), dir_state=int(entry.state),
        dir_sharers=entry.sharers, dir_owner=entry.owner,
        mem_value=node.memory[scn.mem_blk], waiting=node.waiting,
        emits=emits,
    ).normalized()


def probe_native(scn: Scenario, sem: Semantics) -> Observed:
    from hpa2_tpu_torch import native

    cfg = SystemConfig(semantics=sem)
    out = native.probe_transition(cfg, _native_packed(scn))
    emits = [
        tuple(out[8 + 5 * i: 8 + 5 * (i + 1)]) for i in range(out[7])
    ]
    return Observed(
        line_addr=out[0], line_value=out[1], line_state=out[2],
        dir_state=out[3], dir_sharers=out[4], mem_value=out[5],
        waiting=bool(out[6]), emits=emits,
    ).normalized()


def _native_packed(scn: Scenario) -> List[int]:
    """Input layout of the hpa2_probe_transition C API (capi.cpp)."""
    return [
        scn.receiver, int(scn.is_instr),
        1 if scn.instr_op == "W" else 0, scn.instr_addr, scn.instr_value,
        scn.msg_type, scn.msg_sender, scn.msg_addr, scn.msg_value,
        scn.msg_sharers, scn.msg_second,
        scn.line_index, scn.line_addr, scn.line_value, scn.line_state,
        scn.dir_blk, scn.dir_state, scn.dir_sharers,
        scn.mem_blk, scn.mem_value,
        scn.pending, int(scn.waiting),
    ]


def _emits_of(counts, boxes, receiver: int, decode) -> List[Tuple]:
    """Emissions in the other nodes' mailboxes: ``counts[j]`` messages
    in ``boxes[j]``, each decoded by ``decode(j, row)``."""
    return [decode(j, boxes[j][k])
            for j in range(len(counts)) if j != receiver
            for k in range(int(counts[j]))]


class JaxProber:
    """Single-transition probes against the general engine's step
    (``ops/step.py:build_step``, built once).  :meth:`probe_many` stages
    each scenario as one system of a batch and runs one eager step over
    the batch."""

    def __init__(self, sem: Semantics, protocol: str = "mesi",
                 device="cuda"):
        from hpa2_tpu_torch.ops.cuda_engine import resolve_device
        from hpa2_tpu_torch.ops.state import init_state
        from hpa2_tpu_torch.ops.step import build_step

        self.cfg = SystemConfig(semantics=sem, protocol=protocol)
        self.device = resolve_device(device)
        self.step = build_step(self.cfg)
        # one instruction slot so msg- and instr-probes share shapes
        # (init_state pads empty traces to length 1)
        self.base = init_state(
            self.cfg, [[] for _ in range(self.cfg.num_procs)],
            device=self.device)

    def batch(self, b: int):
        """``b`` copies of the empty system, as one batch."""
        from hpa2_tpu_torch.ops.state import SimState

        return SimState(*(x.repeat((b,) + (1,) * (x.dim() - 1))
                          for x in self.base))

    @staticmethod
    def _stage(st, i: int, scn: Scenario) -> None:
        """Write one scenario's receiver-node state into system ``i`` of
        ``st`` (in place)."""
        r = scn.receiver
        st.cache_addr[i, r, scn.line_index] = scn.line_addr
        st.cache_val[i, r, scn.line_index] = scn.line_value
        st.cache_state[i, r, scn.line_index] = scn.line_state
        st.dir_state[i, r, scn.dir_blk] = scn.dir_state
        st.dir_sharers[i, r, scn.dir_blk, 0] = scn.dir_sharers
        st.dir_owner[i, r, scn.dir_blk] = scn.dir_owner
        st.mem[i, r, scn.mem_blk] = scn.mem_value
        st.pending_write[i, r] = scn.pending
        st.waiting[i, r] = scn.waiting
        if scn.is_instr:
            st.tr_op[i, r, 0] = 0 if scn.instr_op == "R" else 1
            st.tr_addr[i, r, 0] = scn.instr_addr
            st.tr_val[i, r, 0] = scn.instr_value
            st.tr_len[i, r] = 1
        else:
            packed = [scn.msg_type, scn.msg_sender, scn.msg_addr,
                      scn.msg_value, scn.msg_second, scn.msg_sharers]
            st.mb_data[i, r, 0, :6] = torch.tensor(packed,
                                                   dtype=torch.int32)
            st.mb_count[i, r] = 1

    def step_staged(self, groups: Sequence[Sequence[Scenario]]):
        """One step over a batch whose system ``i`` holds every scenario
        of ``groups[i]``; returns the next state as numpy arrays."""
        st = self.batch(len(groups))
        for i, scns in enumerate(groups):
            for scn in scns:
                self._stage(st, i, scn)
        nxt = self.step(st)
        return {f: getattr(nxt, f).cpu().numpy() for f in nxt._fields}

    def probe_many(self, scns: Sequence[Scenario]) -> List[Observed]:
        from hpa2_tpu_torch.ops.state import (
            MB_SECOND, MB_SHARERS, MB_TYPE, MB_VALUE,
        )

        nxt = self.step_staged([[s] for s in scns])

        def decode(j, row):
            return (j, int(row[MB_TYPE]), int(row[MB_VALUE]),
                    int(row[MB_SECOND]), int(row[MB_SHARERS]))

        out = []
        for i, scn in enumerate(scns):
            r, li, db = scn.receiver, scn.line_index, scn.dir_blk
            out.append(Observed(
                line_addr=int(nxt["cache_addr"][i, r, li]),
                line_value=int(nxt["cache_val"][i, r, li]),
                line_state=int(nxt["cache_state"][i, r, li]),
                dir_state=int(nxt["dir_state"][i, r, db]),
                dir_sharers=int(nxt["dir_sharers"][i, r, db, 0]),
                dir_owner=int(nxt["dir_owner"][i, r, db]),
                mem_value=int(nxt["mem"][i, r, scn.mem_blk]),
                waiting=bool(nxt["waiting"][i, r]),
                emits=_emits_of(nxt["mb_count"][i], nxt["mb_data"][i], r,
                                decode),
            ).normalized())
        return out

    def probe(self, scn: Scenario) -> Observed:
        return self.probe_many([scn])[0]


class PallasProber:
    """Single-transition probes against the fast path's per-call kernel.

    :meth:`probe_many` stages each scenario directly into one lane of
    the kernel's packed planes (cache word, directory word, scalar row,
    mailbox wire words), runs exactly one cycle of the REAL kernel --
    ``kernels.call_run`` at ``k=1``, window 1, one lane block of every
    lane, the quiescence gate off: K3 on CUDA tensors, its plain version
    on CPU tensors -- and decodes the resulting planes back into one
    :class:`Observed` a lane.  The lanes are independent systems, so
    one launch probes every row.  ``launches`` counts the calls.

    The ``aux`` wire union is type-dependent (value | excl flag for
    REPLY_RD, the sharer/fan mask for REPLY_ID, the rd/wr flag for
    NACK, the byte value otherwise); the stage/decode here mirrors the
    kernel's own pack sites so a packing regression shows up as a
    table diff naming the row."""

    def __init__(self, sem: Semantics, device="cuda"):
        from hpa2_tpu_torch.ops import layout
        from hpa2_tpu_torch.ops.cuda_engine import resolve_device

        self.lo = layout
        self.cfg = SystemConfig(semantics=sem)
        if layout._split_mode(self.cfg):
            raise ValueError(
                "probe geometry is the packed-word 4-node reference")
        self.device = resolve_device(device)
        self.layout, self.W = layout._mb_layout(self.cfg)
        # t_dim 1: one instruction slot, shared by msg probes
        self.slsc = layout._scalar_layout(self.cfg, 1)
        self.launches = 0

    # -- wire-word helpers --------------------------------------------

    def _dec(self, words: Sequence[int], name: str) -> int:
        w, off, wd = self.layout[name]
        return (words[w] >> off) & ((1 << wd) - 1)

    def _msg_words(self, scn: Scenario) -> List[int]:
        mt = scn.msg_type
        if mt == int(MsgType.REPLY_RD):
            aux = (scn.msg_value & 0xFF) | (
                256 if scn.msg_sharers == 2 else 0)
        elif mt in (int(MsgType.REPLY_ID), int(MsgType.NACK)):
            aux = scn.msg_sharers
        else:
            aux = scn.msg_value & 0xFF
        vals = {"type": mt, "sender": scn.msg_sender,
                "second": scn.msg_second + 1, "addr": scn.msg_addr,
                "aux": aux}
        words = [0] * self.W
        for name, x in vals.items():
            w, off, wd = self.layout[name]
            words[w] |= (x & ((1 << wd) - 1)) << off
        return words

    def _emit_from_words(self, recv: int, words: Sequence[int]) -> Tuple:
        mtype = self._dec(words, "type")
        second = self._dec(words, "second") - 1
        aux = self._dec(words, "aux")
        if mtype == int(MsgType.REPLY_RD):
            value, sharers = aux & 0xFF, (2 if (aux >> 8) & 1 else 0)
        elif mtype in (int(MsgType.REPLY_ID), int(MsgType.NACK)):
            value, sharers = 0, aux
        else:
            value, sharers = aux & 0xFF, 0
        return (recv, mtype, value, second, sharers)

    # -- the probe ----------------------------------------------------

    def _stage(self, st, tr, tr_len, i: int, scn: Scenario) -> None:
        """Write one scenario into lane ``i`` of the numpy planes."""
        lo, slsc = self.lo, self.slsc
        r = scn.receiver
        st["cachew"][r, scn.line_index, i] = (
            scn.line_state
            | (scn.line_value << lo._CW_VAL_SHIFT)
            | ((scn.line_addr + 1) << lo._CW_ADDR_SHIFT))
        # dir fields first, then the memory byte: correct whether or
        # not the scenario's dir_blk and mem_blk coincide
        dw = int(st["dirw"][r, scn.dir_blk, i])
        st["dirw"][r, scn.dir_blk, i] = (
            (dw & 0xFF)
            | (scn.dir_state << lo._DW_STATE_SHIFT)
            | (scn.dir_sharers << lo._DW_SH_SHIFT))
        mw = int(st["dirw"][r, scn.mem_blk, i])
        st["dirw"][r, scn.mem_blk, i] = (mw & ~0xFF) | scn.mem_value
        mb_count = 0
        if scn.is_instr:
            tr[r, 0, i] = (
                (0 if scn.instr_op == "R" else 1)
                | (scn.instr_value << 1)
                | (scn.instr_addr << lo._TR_ADDR_SHIFT))
            tr_len[r, i] = 1
        else:
            mb_count = 1
            for w, word in enumerate(self._msg_words(scn)):
                st[f"mb{w}"][r, 0, i] = word
        st["nsw"][r, i] = (
            mb_count
            | (int(scn.waiting) << slsc["off_wait"])
            | (scn.pending << slsc["off_pw"]))

    def staged(self, scns: Sequence[Scenario]):
        """The planes of one launch, lane ``i`` holding ``scns[i]``:
        (state, trace plane, lengths) as tensors on the device."""
        import numpy as np

        from hpa2_tpu_torch.convert import state_from_numpy

        cfg, b = self.cfg, len(scns)
        n = cfg.num_procs
        st = self.lo._init_state(cfg, b, snapshots=False)
        tr = np.zeros((n, 1, b), np.int32)
        tr_len = np.zeros((n, b), np.int32)
        for i, scn in enumerate(scns):
            self._stage(st, tr, tr_len, i, scn)
        return (state_from_numpy(st, self.device),
                torch.from_numpy(tr).to(self.device),
                torch.from_numpy(tr_len).to(self.device))

    def run(self, state, tr, tr_len) -> None:
        """One cycle of every lane: one call of the per-call kernel, the
        whole launch one lane block (``state`` is updated in place)."""
        from hpa2_tpu_torch.ops import kernels

        kernels.call_run(self.cfg, state, tr, tr_len, seg=0,
                         block=tr_len.shape[1], k=1, window=1, gate=False,
                         snapshots=False)
        self.launches += 1

    def probe_many(self, scns: Sequence[Scenario]) -> List[Observed]:
        lo, slsc = self.lo, self.slsc
        n = self.cfg.num_procs
        state, tr, tr_len = self.staged(scns)
        self.run(state, tr, tr_len)
        out = {k: v.cpu().numpy() for k, v in state.items()}
        addr_mask = (1 << 21) - 1
        counts = out["nsw"] & slsc["count_mask"]

        obs = []
        for i, scn in enumerate(scns):
            r = scn.receiver
            cw = int(out["cachew"][r, scn.line_index, i])
            dw = int(out["dirw"][r, scn.dir_blk, i])
            nsw = int(out["nsw"][r, i])
            boxes = [[[int(out[f"mb{w}"][j, k, i]) for w in range(self.W)]
                      for k in range(int(counts[j, i]))] for j in range(n)]
            obs.append(Observed(
                line_addr=((cw >> lo._CW_ADDR_SHIFT) & addr_mask) - 1,
                line_value=(cw >> lo._CW_VAL_SHIFT) & 0xFF,
                line_state=cw & 3,
                dir_state=(dw >> lo._DW_STATE_SHIFT) & 3,
                dir_sharers=(dw >> lo._DW_SH_SHIFT) & ((1 << n) - 1),
                mem_value=int(out["dirw"][r, scn.mem_blk, i]) & 0xFF,
                waiting=bool((nsw >> slsc["off_wait"]) & 1),
                emits=_emits_of(counts[:, i], boxes, r,
                                self._emit_from_words),
            ).normalized())
        return obs

    def probe(self, scn: Scenario) -> Observed:
        return self.probe_many([scn])[0]


# ---------------------------------------------------------------------------
# diffing
# ---------------------------------------------------------------------------


def _diff_observed(where: str, exp: Observed, obs: Observed) -> List[str]:
    out = []
    for field in ("line_addr", "line_value", "line_state", "dir_state",
                  "dir_sharers", "dir_owner", "mem_value", "waiting"):
        e, o = getattr(exp, field), getattr(obs, field)
        if e != o:
            out.append(f"{where}: {field} expected {e} observed {o}")
    if len(exp.emits) != len(obs.emits):
        out.append(
            f"{where}: expected {len(exp.emits)} emissions "
            f"{[(e[0], e[1]) for e in exp.emits]}, observed "
            f"{len(obs.emits)} {[(o[0], o[1]) for o in obs.emits]}")
        return out
    names = ("receiver", "type", "value", "second", "sharers")
    for e, o in zip(exp.emits, obs.emits):
        for i, name in enumerate(names):
            if e[i] is not None and e[i] != o[i]:
                out.append(
                    f"{where}: emission {names[1]}={e[1]} "
                    f"{name} expected {e[i]} observed {o[i]}")
    return out


def probeable_rows(table: TransitionTable) -> List[Row]:
    return [r for r in table.rows
            if not table.is_unreachable(*r.key)]


def diff_backend(
    table: TransitionTable,
    backend: str,
    rows: Optional[Sequence[Row]] = None,
    prober=None,
    device="cuda",
) -> List[str]:
    """Diff the backend's effective table against the declared one.

    Returns one human-readable line per mismatch (empty = equivalent).
    ``prober`` lets callers reuse a ``JaxProber`` / ``PallasProber``
    across many diffs (e.g. the fuzzer); otherwise one is built on
    ``device``.  The ``jax`` and ``pallas`` backends probe every row in
    one step / one kernel launch.
    """
    sem = table.semantics
    protocol = table.protocol
    if protocol != "mesi" and backend in ("native", "pallas"):
        raise ValueError(
            f"the {backend} backend is specialized to MESI; "
            f"cannot extract a {protocol} table from it")
    rows = list(rows) if rows is not None else probeable_rows(table)
    diffs: List[str] = []
    if backend not in ("spec", "jax", "native", "pallas"):
        raise ValueError(f"unknown backend {backend!r}")
    if prober is None:
        if backend == "jax":
            prober = JaxProber(sem, protocol, device=device)
        elif backend == "pallas":
            prober = PallasProber(sem, device=device)
    probes = [(row, scenario_for(row, protocol)) for row in rows]
    probes = [(row, scn) for row, scn in probes if scn is not None]
    if backend in ("jax", "pallas"):
        observed = prober.probe_many([scn for _, scn in probes]) \
            if probes else []
    elif backend == "spec":
        observed = [probe_spec(scn, sem, protocol) for _, scn in probes]
    else:
        observed = [probe_native(scn, sem) for _, scn in probes]
    diffs: List[str] = []
    for (row, scn), obs in zip(probes, observed):
        diffs.extend(_diff_observed("/".join(row.key),
                                    expected_for(row, scn), obs))
    return diffs


def extract_and_diff(
    sem: Semantics, backends: Sequence[str], protocol: str = "mesi",
    device="cuda",
) -> Dict[str, List[str]]:
    table = build_table(sem, protocol)
    return {b: diff_backend(table, b, device=device) for b in backends}


# ---------------------------------------------------------------------------
# multi-stimulus probes: several deliveries in one phase.  The per-row
# probes above stage exactly one stimulus, so they can never see how
# concurrent handlers interact — emission ordering into a shared
# mailbox, two directory mutations racing an in-flight intervention.
# These scenarios stage stimuli at two or three DISTINCT receivers
# (the lockstep step handles one message per node per cycle), run one
# full cycle on both backends, and diff the ENTIRE system: every
# node's architectural state plus every mailbox's exact content and
# order.  The spec engine is the pivot; zero diffs expected.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MultiScenario:
    """Named bundle of single-node scenarios fired in the same cycle."""

    name: str
    stimuli: Tuple[Scenario, ...]


def multi_scenarios(protocol: str, sem: Semantics) -> List[MultiScenario]:
    """Same-phase interaction scenarios for one protocol (all same
    address unless noted, receivers always distinct)."""
    C, D = _CACHE_NUM, _DIR_NUM
    mesif = protocol == "mesif"
    moesi = protocol == "moesi"
    # MESIF read fills always carry a flag (2 = exclusive, 1 = as-
    # forwarder); a plain shared fill (0) exists only in MESI/MOESI
    rd_fill_flag = 1 if mesif else 0

    def msg(receiver: int, mtype: str, sender: int, **kw) -> Scenario:
        return Scenario(receiver=receiver, msg_type=int(MsgType[mtype]),
                        msg_sender=sender, **kw)

    out = [
        # a new read arrives at home while the owner is already
        # answering an earlier intervention for the same line
        MultiScenario("read_x_owner_wbint", (
            msg(HOME, "READ_REQUEST", OTHER,
                dir_state=D["EM"], dir_sharers=bit(OWNER)),
            msg(OWNER, "WRITEBACK_INT", HOME, msg_second=REQUESTER,
                line_addr=ADDR, line_value=LINE_SENTINEL,
                line_state=C["M"]),
        )),
        # a sharer eviction reaches home while another sharer handles
        # the INV of a racing write fan-out
        MultiScenario("evict_x_inv", (
            msg(HOME, "EVICT_SHARED", OTHER,
                dir_state=D["S"],
                dir_sharers=bit(OTHER) | bit(REQUESTER) | bit(OWNER),
                dir_owner=OWNER if mesif else NO_PROC),
            msg(REQUESTER, "INV", OWNER,
                line_addr=ADDR, line_value=LINE_SENTINEL,
                line_state=C["S"]),
        )),
        # home serves a write while the last-survivor notify of an
        # earlier eviction is still being absorbed
        MultiScenario("write_x_notify", (
            msg(HOME, "WRITE_REQUEST", REQUESTER, msg_value=MSG_SENTINEL,
                dir_state=D["S"], dir_sharers=bit(OTHER) | bit(OWNER),
                dir_owner=OWNER if mesif else NO_PROC),
            msg(OWNER, "UPGRADE_NOTIFY", HOME,
                line_addr=ADDR, line_value=LINE_SENTINEL,
                line_state=C["S"]),
        )),
        # a cache upgrades (hit on S) in the same cycle home shrinks
        # the sharer set under it
        MultiScenario("upgrade_x_evict", (
            Scenario(receiver=REQUESTER, is_instr=True, instr_op="W",
                     instr_value=INSTR_SENTINEL, line_addr=ADDR,
                     line_value=LINE_SENTINEL, line_state=C["S"]),
            msg(HOME, "EVICT_SHARED", OTHER,
                dir_state=D["S"],
                dir_sharers=bit(OTHER) | bit(REQUESTER),
                dir_owner=REQUESTER if mesif else NO_PROC),
        )),
        # two homes answer the same requester in one phase: pins the
        # cross-backend delivery order into a shared mailbox
        MultiScenario("two_replies_one_requester", (
            msg(HOME, "READ_REQUEST", REQUESTER, dir_state=D["U"]),
            msg(VICTIM_ADDR // 16, "WRITE_REQUEST", REQUESTER,
                msg_addr=VICTIM_ADDR, msg_value=MSG_SENTINEL,
                dir_state=D["U"]),
        )),
    ]
    if sem.intervention_miss_policy == "nack":
        # home re-serves a NACKed read while the requester is filling
        # from an earlier (stale) reply; NACK is never emitted under
        # the drop policy, so the race only exists on robust builds
        out.append(MultiScenario("nack_x_fill", (
            msg(HOME, "NACK", OWNER, msg_second=REQUESTER,
                dir_state=D["S"], dir_sharers=bit(OTHER),
                dir_owner=OWNER if mesif else NO_PROC),
            msg(REQUESTER, "REPLY_RD", HOME, msg_value=MSG_SENTINEL,
                msg_sharers=rd_fill_flag, line_addr=ADDR,
                line_state=C["I"], waiting=True),
        )))
    if moesi or mesif:
        # a tracked owner/forwarder answers one intervention while
        # home, still pointing at it, forwards the next
        out.append(MultiScenario("tracked_read_x_owner_wbint", (
            msg(HOME, "READ_REQUEST", REQUESTER,
                dir_state=D["SO"] if moesi else D["S"],
                dir_sharers=bit(OTHER) | bit(OWNER), dir_owner=OWNER),
            msg(OWNER, "WRITEBACK_INT", HOME, msg_second=OTHER,
                line_addr=ADDR, line_value=LINE_SENTINEL,
                line_state=C["O"] if moesi else C["F"]),
        )))
    return out


def _spec_system_obs(eng) -> List[dict]:
    return [
        {
            "mem": [int(x) for x in n.memory],
            "dir": [[int(e.state), int(e.sharers), int(e.owner)]
                    for e in n.directory],
            "cache": [[int(l.address), int(l.value), int(l.state)]
                      for l in n.cache],
            "pc": int(n.pc),
            "waiting": bool(n.waiting),
            "pending": int(n.pending_write),
            "mailbox": [
                [int(m.type), int(m.sender), int(m.address),
                 int(m.value), int(m.sharers), int(m.second_receiver)]
                for m in n.mailbox
            ],
        }
        for n in eng.nodes
    ]


def probe_spec_multi(
    ms: MultiScenario, sem: Semantics, protocol: str = "mesi"
) -> List[dict]:
    from hpa2_tpu_torch.models.spec_engine import SpecEngine

    cfg = SystemConfig(semantics=sem, protocol=protocol)
    eng = SpecEngine(cfg, [[] for _ in range(cfg.num_procs)])
    for scn in ms.stimuli:
        _stage_spec_node(eng, scn)
        node = eng.nodes[scn.receiver]
        if scn.is_instr:
            node.trace = [
                Instr(scn.instr_op, scn.instr_addr, scn.instr_value)
            ]
            node.pc = 0
        else:
            node.mailbox.append(Message(
                MsgType(scn.msg_type), scn.msg_sender, scn.msg_addr,
                value=scn.msg_value, sharers=scn.msg_sharers,
                second_receiver=scn.msg_second,
            ))
    eng.step()
    return _spec_system_obs(eng)


def _jax_system_obs(nxt, i: int = 0) -> List[dict]:
    """System ``i`` of a stepped batch (numpy arrays by field), in
    :func:`_spec_system_obs`'s form."""
    from hpa2_tpu_torch.ops.state import (
        MB_ADDR, MB_SECOND, MB_SENDER, MB_SHARERS, MB_TYPE, MB_VALUE,
    )

    out = []
    for j in range(nxt["pc"].shape[1]):
        box = []
        for k in range(int(nxt["mb_count"][i, j])):
            row = nxt["mb_data"][i, j, k]
            box.append([int(row[MB_TYPE]), int(row[MB_SENDER]),
                        int(row[MB_ADDR]), int(row[MB_VALUE]),
                        int(row[MB_SHARERS]), int(row[MB_SECOND])])
        out.append({
            "mem": [int(x) for x in nxt["mem"][i, j]],
            "dir": [[int(s), int(sh), int(ow)] for s, sh, ow in zip(
                nxt["dir_state"][i, j], nxt["dir_sharers"][i, j, :, 0],
                nxt["dir_owner"][i, j])],
            "cache": [[int(a), int(v), int(s)] for a, v, s in zip(
                nxt["cache_addr"][i, j], nxt["cache_val"][i, j],
                nxt["cache_state"][i, j])],
            "pc": int(nxt["pc"][i, j]),
            "waiting": bool(nxt["waiting"][i, j]),
            "pending": int(nxt["pending_write"][i, j]),
            "mailbox": box,
        })
    return out


def probe_jax_multi(ms: MultiScenario, prober: JaxProber) -> List[dict]:
    return _jax_system_obs(prober.step_staged([ms.stimuli]))


def diff_multi_backend(
    sem: Semantics, protocol: str = "mesi", device="cuda"
) -> List[str]:
    """Spec-vs-JAX whole-system diff over the same-phase interaction
    scenarios.  One line per mismatching (node, plane); empty list =
    the backends agree on every concurrent-handler interaction."""
    prober = JaxProber(sem, protocol, device=device)
    scenarios = multi_scenarios(protocol, sem)
    for ms in scenarios:
        receivers = [s.receiver for s in ms.stimuli]
        if len(set(receivers)) != len(receivers):
            raise ValueError(
                f"{ms.name}: stimuli must target distinct receivers")
    # every scenario is one system of one step
    nxt = prober.step_staged([ms.stimuli for ms in scenarios])
    diffs: List[str] = []
    for i, ms in enumerate(scenarios):
        spec = probe_spec_multi(ms, sem, protocol)
        jax = _jax_system_obs(nxt, i)
        for j, (a, b) in enumerate(zip(spec, jax)):
            for key in a:
                if a[key] != b[key]:
                    diffs.append(
                        f"{ms.name}: node {j} {key} "
                        f"spec {a[key]} jax {b[key]}")
    return diffs
