"""The executable spec: a deterministic lockstep directory-MESI engine.

The port's copy of ``hpa2_tpu/models/spec_engine.py`` (l.1-1232), kept
line for line because the port imports nothing of the JAX package and a
copy that drifts would drift quietly: the walk order of ``_deliver``,
the handler dispatch (``generated_dispatch``, the port's
``protocols/compiler.py``), the order and the guards of every draw from
the fault stream (``random.Random(config.fault.seed)``), the counters,
``stats()``, ``link_stats()``, ``msg_log``, ``issue_log`` and the stall
text are the JAX engine's (``tests/test_torch_spec_engine.py`` holds
them equal).  ``StallError`` and ``StallDiagnostic`` live here, as in
the JAX package, and every engine of the port raises these classes
(``ops/layout.py`` and ``ops/engine.py`` re-export them), so one
``except StallError`` catches any engine's stall.  The module imports
no ``torch``.

This pure-Python engine defines the protocol semantics that every
backend (the general engine in ``hpa2_tpu_torch.ops``, the fast path's
kernels, C++/OpenMP in ``native/``) must match: it is the
differential-test oracle.

Semantics are the reference's (assignment.c:187-697) with the
fixture-semantics deviations as the default (see
``hpa2_tpu_torch.config.Semantics``).  Scheduling replaces the reference's
free-running OpenMP threads (one thread per node, racy, non-terminating
— assignment.c:135-153) with a deterministic global-cycle lockstep:

  Each cycle:
    1. *handle*: every node with a non-empty mailbox pops exactly ONE
       message (FIFO) and runs the protocol handler for it.
    2. *issue*: every node whose mailbox is now empty and that is not
       waiting for a reply issues at most one instruction — this is
       exactly the reference's drain-all-then-issue loop shape
       (assignment.c:153-699) unrolled one message per cycle.  In
       *replay* mode only the node matching the next record of a
       recorded ``instruction_order.txt`` may issue, pinning the
       interleaving that produced a given fixture set (SURVEY.md §4).
    3. *deliver*: all messages sent in 1-2 are appended to receiver
       mailboxes in deterministic order (handle-phase sends first,
       then issue-phase sends; within a phase by sender id, preserving
       each sender's emission order).
    4. *dump*: a node whose trace is exhausted, that is not waiting and
       whose mailbox is empty (including this cycle's deliveries)
       snapshots its state once — the reference's
       dump-at-local-completion semantics (assignment.c:688-697),
       which still drains in-flight messages first (observed in
       tests/sample: node 0's dump contains node 1's later
       EVICT_MODIFIED value).

  Termination = global quiescence: all traces exhausted, nobody
  waiting, all mailboxes empty (the reference never terminates,
  assignment.c:153; SURVEY.md §2.3).
"""

from __future__ import annotations

import collections
import dataclasses
import random
from typing import Deque, Dict, List, Optional, Sequence, Tuple

from hpa2_tpu_torch.config import Semantics, SystemConfig
from hpa2_tpu_torch.models.protocol import (
    CacheState,
    DirState,
    Instr,
    INVALID_ADDR,
    Message,
    MsgType,
    NO_PROC,
    REPLY_RD_SHARED,
    bit,
    count_sharers,
    find_owner,
    is_bit_set,
)
from hpa2_tpu_torch.protocols.compiler import generated_dispatch, planes_for
from hpa2_tpu_torch.protocols.directory import dir_mask_int, parse_format
from hpa2_tpu_torch.utils.dump import NodeDump
from hpa2_tpu_torch.utils.trace import IssueRecord, TraceRing


@dataclasses.dataclass
class CacheLine:
    address: int = INVALID_ADDR
    value: int = 0
    state: CacheState = CacheState.INVALID


@dataclasses.dataclass
class DirEntry:
    state: DirState = DirState.U
    sharers: int = 0
    # tracked owner/forwarder node (NO_PROC = none).  MOESI: the OWNED
    # cache while state == SO; MESIF: the FORWARD cache while state ==
    # S.  MESI never writes it.
    owner: int = NO_PROC


class Node:
    """Private state of one processor node (assignment.c:70-81)."""

    def __init__(self, node_id: int, config: SystemConfig, trace: Sequence[Instr]):
        self.id = node_id
        self.config = config
        # owner-plane protocols carry dir_owner in their dumps; MESI
        # keeps NodeDump.dir_owner = None so parity comparisons against
        # native/fixture dumps stay field-for-field exact
        self._dump_owner = planes_for(
            config.protocol, config.semantics
        ).has_owner_plane
        # memory init: 20 * id + i, byte-wrapped (assignment.c:779)
        self.memory: List[int] = [
            (20 * node_id + i) % 256 for i in range(config.mem_size)
        ]
        self.directory: List[DirEntry] = [
            DirEntry() for _ in range(config.mem_size)
        ]
        self.cache: List[CacheLine] = [CacheLine() for _ in range(config.cache_size)]
        self.trace: List[Instr] = list(trace)
        self.pc = 0
        self.waiting = False
        self.pending_write = 0
        self.mailbox: Deque[Message] = collections.deque()
        # deferred sends: messages from this node's last action that
        # did not fit their receiver's mailbox (capacity backpressure).
        # While non-empty the node is BLOCKED — it neither handles nor
        # issues — the lockstep analog of the reference's blocking
        # enqueue (assignment.c:715-724, busy-wait on full buffer).
        # Entries are (phase, receiver, Message) in emission order.
        self.pending_sends: List[Tuple[int, int, Message]] = []
        self.dumped = False
        self.snapshot: Optional[NodeDump] = None
        # every legal dump-at-local-completion state: the state at
        # completion plus the state after each later handled message.
        # The reference's dump timing is OS-scheduling-dependent (a
        # thread may be descheduled between finishing its trace and
        # dumping, so the dump can include effects of arbitrarily many
        # later messages — fixture evidence: tests/test_3/run_1 core_1
        # reflects an INV issued 13 records after core_1's last
        # instruction).  Parity therefore matches fixtures against the
        # candidate set.
        self.dump_candidates: List[NodeDump] = []

    # -- helpers ------------------------------------------------------

    def line_for(self, addr: int) -> CacheLine:
        return self.cache[self.config.cache_index_of(addr)]

    def dump(self) -> NodeDump:
        return NodeDump(
            proc_id=self.id,
            memory=list(self.memory),
            dir_state=[d.state for d in self.directory],
            dir_sharers=[d.sharers for d in self.directory],
            cache_addr=[l.address for l in self.cache],
            cache_value=[l.value for l in self.cache],
            cache_state=[l.state for l in self.cache],
            dir_owner=(
                [d.owner for d in self.directory]
                if self._dump_owner else None
            ),
        )


class StallError(RuntimeError):
    """Raised when the engine stops making progress (protocol livelock,
    or an unachievable replay order)."""


class StallDiagnostic(StallError):
    """Structured stall/watchdog diagnostic.

    A ``StallError`` subclass (every existing ``except StallError``
    keeps working) carrying the machine-readable state a livelock
    post-mortem needs: per-node mailbox depth, waiting/send-blocked
    sets, cache-line states, the recent-delivery flight recorder, an
    advisory mid-flight invariant check, and the engine counters.
    """

    def __init__(
        self,
        reason: str,
        cycle: int,
        mailbox_depths: Dict[int, int],
        waiting: List[int],
        blocked: List[int],
        line_states: Dict[int, List[str]],
        recent_msgs: List[str],
        invariant_violations: List[str],
        counters: Dict[str, int],
    ):
        self.reason = reason
        self.cycle = cycle
        self.mailbox_depths = mailbox_depths
        self.waiting = waiting
        self.blocked = blocked
        self.line_states = line_states
        self.recent_msgs = recent_msgs
        self.invariant_violations = invariant_violations
        self.counters = counters
        super().__init__(self._render())

    def _render(self) -> str:
        out = [
            f"{self.reason} (cycle {self.cycle})",
            f"  waiting nodes: {self.waiting}; "
            f"send-blocked nodes: {self.blocked}",
            "  mailbox depths: "
            + ", ".join(f"{n}:{d}" for n, d in self.mailbox_depths.items()),
        ]
        for node, lines in self.line_states.items():
            if lines:
                out.append(f"  node {node} cache: " + ", ".join(lines))
        if self.recent_msgs:
            out.append(f"  last {len(self.recent_msgs)} deliveries:")
            out.extend("    " + m for m in self.recent_msgs)
        if self.invariant_violations:
            out.append("  invariant check (mid-flight subset):")
            out.extend("    " + m for m in self.invariant_violations)
        return "\n".join(out)


class SpecEngine:
    def __init__(
        self,
        config: SystemConfig,
        traces: Sequence[Sequence[Instr]],
        replay_order: Optional[Sequence[IssueRecord]] = None,
        replay_batched: bool = False,
        trace_msgs: bool = False,
        debug_invariants: bool = False,
    ):
        if len(traces) != config.num_procs:
            raise ValueError("need one trace per node")
        self.config = config
        self.sem: Semantics = config.semantics
        # the compiled protocol: every state-set guard and reply kind
        # below reads these planes, never a hand-written constant that
        # differs between protocols
        self.planes = planes_for(config.protocol, config.semantics)
        self._dir_kind, self._dir_param = parse_format(
            config.directory_format, config.num_procs
        )
        self._rd_fill = dict(self.planes.reply_rd_fill)
        self._notify_map = dict(self.planes.notify_pairs)
        self.nodes = [Node(i, config, t) for i, t in enumerate(traces)]
        self.replay_order = list(replay_order) if replay_order is not None else None
        # "batched" replay lets consecutive order records issue in the
        # same cycle (one per node) — modeling near-simultaneous issues
        # whose requests race to a home in sender-id order rather than
        # strictly in recorded-log order (the DEBUG_INSTR log captures
        # issue order, not message-arrival order; SURVEY.md §7.4.2).
        self.replay_batched = replay_batched
        self.order_pos = 0
        self.cycle = 0
        # pending sends for the current cycle: (phase, sender, receiver, Message)
        self._outbox: List[Tuple[int, int, int, Message]] = []
        # observability (the reference has none — SURVEY.md §5)
        self.counters: Dict[str, int] = collections.defaultdict(int)
        self.max_mailbox_depth = 0
        # the executed issue interleaving, one IssueRecord per issued
        # instruction — the DEBUG_INSTR log (assignment.c:596-597)
        self.issue_log: List[IssueRecord] = []
        # per-message send/receive log in the reference's DEBUG_MSG
        # format (assignment.c:170-174 receive, 734-738 send); sends
        # log at mailbox enqueue (the sendMessage analog), receives at
        # dequeue
        self.trace_msgs = trace_msgs
        self.msg_log: List[str] = []
        # link-layer fault injection (None when all rates are 0: the
        # fault-free hot path stays draw-free and branch-free)
        self._fault_rng: Optional[random.Random] = (
            random.Random(config.fault.seed) if config.fault.enabled else None
        )
        # topology-aware interconnect (None for the ideal topology:
        # delivery stays next-cycle and zero-cost, byte-identical to
        # the pre-topology engine)
        ic = config.interconnect
        self.link_tracker = None
        if ic.enabled:
            from hpa2_tpu_torch.interconnect.delay import LinkTracker
            from hpa2_tpu_torch.interconnect.topology import build_topology

            self.link_tracker = LinkTracker(
                build_topology(ic.topology, config.num_procs,
                               ic.hop_latency),
                bandwidth=ic.link_bandwidth,
                multicast=ic.multicast,
                combining=ic.combining,
            )
        # watchdog bookkeeping: last cycle that retired an instruction
        # or drained a mailbox, plus the delivery flight recorder
        self.last_activity_cycle = 0
        self.recent_msgs = TraceRing()
        # per-step mid-flight invariant checking (debug aid; O(N*M)
        # per cycle, keep off in sweeps)
        self.debug_invariants = debug_invariants

    @property
    def instructions(self) -> int:
        return self.counters["instructions"]

    @property
    def messages(self) -> int:
        return self.counters["msgs_total"]

    # -- transport ----------------------------------------------------

    def _send(self, phase: int, receiver: int, msg: Message) -> None:
        """Buffer a send for end-of-cycle delivery (the lockstep analog
        of sendMessage's locked enqueue, assignment.c:711-739)."""
        self.counters[f"msg_{msg.type.name}"] += 1
        self.counters["msgs_total"] += 1
        self._outbox.append((phase, msg.sender, receiver, msg))

    def _wire(self, sender: int, receiver: int) -> bool:
        """Simulate one message crossing the faulty link (link-layer
        reliable transport: seq/ack with in-cycle retransmission).

        Drops are retried with fresh randomness up to
        ``fault.max_retries`` rounds; duplicate, reorder and delay
        events are absorbed by the receiver's link layer (dup filter,
        reassembly window, skew buffer) and surface only as counters.
        Returns True once a copy gets through; False when the retry
        budget is exhausted — the caller then defers the message to
        the sender's pending queue and the link retries next cycle.
        """
        fm = self.config.fault
        if not fm.applies(sender, receiver):
            return True
        rng = self._fault_rng
        rounds = 0
        while rng.random() < fm.drop:
            rounds += 1
            if rounds >= fm.max_retries:
                self.counters["fault_drops"] += rounds
                self.counters["fault_link_stalls"] += 1
                return False
        if rounds:
            self.counters["fault_drops"] += rounds
            self.counters["fault_retransmissions"] += rounds
        if fm.duplicate > 0.0 and rng.random() < fm.duplicate:
            self.counters["fault_dups_filtered"] += 1
        if fm.reorder > 0.0 and rng.random() < fm.reorder:
            self.counters["fault_reorders_fixed"] += 1
        if fm.delay > 0.0 and rng.random() < fm.delay:
            self.counters["fault_delays"] += 1
        return True

    def _deliver(self) -> bool:
        """End-of-cycle delivery with capacity backpressure.

        Candidates are walked in the global deterministic order
        (phase, sender, emission order) — pending (deferred) sends at
        their original positions, this cycle's new sends at theirs (a
        node never has both: blocked nodes don't act).  A candidate is
        accepted iff its receiver's mailbox has a free slot at that
        point of the walk AND it crosses the (possibly faulty) link
        within the retry budget; rejected candidates become (stay) the
        sender's pending_sends, preserving order.  Once an edge stalls
        this cycle, every later candidate on the same (sender,
        receiver) edge defers too, keeping per-edge FIFO exact.
        Returns True if any message was delivered (progress).
        """
        cap = self.config.msg_buffer_size
        merged: List[Tuple[int, int, int, Message]] = []
        for node in self.nodes:
            for ph, receiver, msg in node.pending_sends:
                merged.append((ph, node.id, receiver, msg))
            node.pending_sends = []
        merged.extend(self._outbox)
        self._outbox.clear()
        merged.sort(key=lambda t: (t[0], t[1]))  # stable
        delivered_any = False
        fault_on = self._fault_rng is not None
        tracker = self.link_tracker
        if tracker is not None:
            tracker.begin_cycle()
        stalled_edges = set()
        for ph, sender, receiver, msg in merged:
            box = self.nodes[receiver].mailbox
            ok = len(box) < cap
            if ok and fault_on:
                edge = (sender, receiver)
                if edge in stalled_edges:
                    ok = False
                elif not self._wire(sender, receiver):
                    stalled_edges.add(edge)
                    ok = False
            if ok:
                if tracker is not None:
                    msg.deliver_at = tracker.on_accept(
                        self.cycle, sender, receiver, int(msg.type),
                        msg.address,
                        is_inv=msg.type == MsgType.INV,
                        is_read_request=msg.type == MsgType.READ_REQUEST,
                    )
                box.append(msg)
                delivered_any = True
                self.recent_msgs.record(
                    self.cycle, msg.sender, receiver,
                    int(msg.type), msg.address,
                )
                if self.trace_msgs:
                    self.msg_log.append(
                        f"Processor {msg.sender} sent msg to: "
                        f"{receiver}, type: {int(msg.type)}, "
                        f"address: 0x{msg.address:02X}"
                    )
                if len(box) > self.max_mailbox_depth:
                    self.max_mailbox_depth = len(box)
            else:
                self.nodes[sender].pending_sends.append((ph, receiver, msg))
        if tracker is not None:
            tracker.end_cycle()
        return delivered_any

    # -- cache replacement (assignment.c:742-773) ---------------------

    def _replace(self, phase: int, node: Node, line: CacheLine) -> None:
        if line.state == CacheState.INVALID or line.address == INVALID_ADDR:
            return
        home = self.config.home_of(line.address)
        self.counters["evictions"] += 1
        if int(line.state) in self.planes.dirty_evict_states:
            self._send(
                phase,
                home,
                Message(
                    MsgType.EVICT_MODIFIED, node.id, line.address, value=line.value
                ),
            )
        else:
            self._send(
                phase,
                home,
                Message(MsgType.EVICT_SHARED, node.id, line.address),
            )

    # -- owner-plane / directory-format helpers -----------------------

    def _set_owner(self, dir_entry: DirEntry, new: int) -> None:
        """Update the tracked owner/forwarder, counting migrations
        (clearing to NO_PROC is a release, not a transfer)."""
        if new >= 0 and new != dir_entry.owner:
            self.counters["owner_transfers"] += 1
        dir_entry.owner = new

    def _fanout_mask(self, sharers: int, requester: int) -> int:
        """The REPLY_ID invalidation fan-out through the configured
        directory format (the one place format precision matters)."""
        mask, overflowed = dir_mask_int(
            self._dir_kind, self._dir_param, sharers, requester,
            self.config.num_procs,
        )
        if overflowed:
            self.counters["dir_overflows"] += 1
        return mask

    # -- protocol handler (assignment.c:187-566) ----------------------
    #
    # One method per message type, dispatched through _DISPATCH.  The
    # map is the runtime mirror of the declarative transition table in
    # hpa2_tpu_torch.analysis.table — the static analyzer probes each method
    # through _handle and diffs the observed transitions against the
    # table, and the dead-handler lint checks every _on_* method is
    # reachable from here.

    _DISPATCH = {
        MsgType.READ_REQUEST: "_on_read_request",
        MsgType.WRITE_REQUEST: "_on_write_request",
        MsgType.REPLY_RD: "_on_reply_rd",
        MsgType.REPLY_WR: "_on_reply_wr",
        MsgType.REPLY_ID: "_on_reply_id",
        MsgType.INV: "_on_inv",
        MsgType.UPGRADE: "_on_upgrade",
        MsgType.WRITEBACK_INV: "_on_writeback_inv",
        MsgType.WRITEBACK_INT: "_on_writeback_int",
        MsgType.FLUSH: "_on_flush",
        MsgType.FLUSH_INVACK: "_on_flush_invack",
        MsgType.EVICT_SHARED: "_on_evict_shared",
        MsgType.EVICT_MODIFIED: "_on_evict_modified",
        MsgType.UPGRADE_NOTIFY: "_on_upgrade_notify",
        MsgType.NACK: "_on_nack",
    }

    def _handle(self, node: Node, msg: Message) -> None:
        name = self._DISPATCH.get(msg.type)
        if name is None:
            raise AssertionError(f"unknown message type {msg.type}")
        cfg = self.config
        home = cfg.home_of(msg.address)
        blk = cfg.block_of(msg.address)
        line = node.line_for(msg.address)
        dir_entry = node.directory[blk] if node.id == home else None
        getattr(self, name)(node, msg, home, blk, line, dir_entry)

    def _on_read_request(self, node, msg, home, blk, line, dir_entry):
        PH = 0
        P = self.planes
        assert dir_entry is not None, "READ_REQUEST must arrive at home"
        reply = Message(
            MsgType.REPLY_RD, node.id, msg.address,
            value=node.memory[blk], sharers=REPLY_RD_SHARED,
        )
        if dir_entry.state == DirState.U:
            dir_entry.state = DirState.EM
            dir_entry.sharers = bit(msg.sender)
            reply.sharers = P.rr_u_flag
            self._send(PH, msg.sender, reply)
        elif dir_entry.state == DirState.S:
            fwd = dir_entry.owner if P.has_fwd else NO_PROC
            if fwd >= 0 and fwd != msg.sender:
                # live forwarder serves cache-to-cache; the newest
                # reader becomes the forwarder
                self._send(
                    PH, fwd,
                    Message(
                        MsgType.WRITEBACK_INT, node.id, msg.address,
                        second_receiver=msg.sender,
                    ),
                )
                dir_entry.sharers |= bit(msg.sender)
                self._set_owner(dir_entry, msg.sender)
            else:
                dir_entry.sharers |= bit(msg.sender)
                reply.sharers = P.rr_s_flag
                self._send(PH, msg.sender, reply)
                if P.has_fwd and fwd != msg.sender:
                    # no live forwarder: the reader seeds F
                    self._set_owner(dir_entry, msg.sender)
        elif P.has_so and dir_entry.state == DirState.SO:
            owner = dir_entry.owner
            if owner == msg.sender:
                # owner lost its line (eviction in flight): demote to
                # clean-shared and serve from memory
                dir_entry.state = DirState.S
                self._set_owner(dir_entry, NO_PROC)
                dir_entry.sharers |= bit(msg.sender)
                reply.sharers = P.rr_s_flag
                self._send(PH, msg.sender, reply)
            else:
                # the owner answers every read cache-to-cache while SO
                self._send(
                    PH, owner,
                    Message(
                        MsgType.WRITEBACK_INT, node.id, msg.address,
                        second_receiver=msg.sender,
                    ),
                )
                dir_entry.sharers |= bit(msg.sender)
        else:  # EM
            owner = find_owner(dir_entry.sharers)
            assert owner != -1
            if owner == msg.sender:
                # owner re-requesting (its copy was evicted-silently
                # or lost): serve data, keep EM (assignment.c:215-221)
                reply.sharers = P.rr_u_flag
                self._send(PH, msg.sender, reply)
            else:
                self._send(
                    PH, owner,
                    Message(
                        MsgType.WRITEBACK_INT, node.id, msg.address,
                        second_receiver=msg.sender,
                    ),
                )
                if P.has_so:
                    # the owner keeps its dirty line as OWNED
                    dir_entry.state = DirState.SO
                    self._set_owner(dir_entry, owner)
                else:
                    # optimistic pre-flush transition
                    # (assignment.c:230-231)
                    dir_entry.state = DirState.S
                    if P.has_fwd:
                        self._set_owner(dir_entry, msg.sender)
                dir_entry.sharers |= bit(msg.sender)

    def _on_reply_rd(self, node, msg, home, blk, line, dir_entry):
        PH = 0
        if (
            line.address != INVALID_ADDR
            and line.address != msg.address
            and line.state != CacheState.INVALID
        ):
            self._replace(PH, node, line)
        line.address = msg.address
        line.value = msg.value
        line.state = CacheState(self._rd_fill[msg.sharers])
        node.waiting = False

    def _on_writeback_int(self, node, msg, home, blk, line, dir_entry):
        PH = 0
        P = self.planes
        if line.address == msg.address and int(line.state) in P.wbint_resp_states:
            flush = Message(
                MsgType.FLUSH, node.id, msg.address,
                value=line.value, second_receiver=msg.second_receiver,
            )
            if int(line.state) in P.wbint_home_flush_states:
                self._send(PH, home, flush)
                if msg.second_receiver != home:
                    self._send(PH, msg.second_receiver, flush.copy())
            else:
                # cache-to-cache fill without a home copy (MOESI OWNED
                # keeps the dirty line; MESIF FORWARD is already clean)
                self.counters["forwards"] += 1
                self._send(PH, msg.second_receiver, flush)
            line.state = CacheState(P.wbint_next_state)
        elif self.sem.intervention_miss_policy == "nack":
            self._send(
                PH, home,
                Message(
                    MsgType.NACK, node.id, msg.address,
                    sharers=0,  # 0 = read intervention
                    second_receiver=msg.second_receiver,
                ),
            )
        # else: silent drop (assignment.c:265-270) — requester hangs

    def _on_flush(self, node, msg, home, blk, line, dir_entry):
        PH = 0
        if node.id == home:
            node.memory[blk] = msg.value
        if node.id == msg.second_receiver:
            if (
                line.address != INVALID_ADDR
                and line.address != msg.address
                and line.state != CacheState.INVALID
            ):
                self._replace(PH, node, line)
            line.address = msg.address
            line.value = msg.value
            line.state = CacheState(self.planes.flush_fill_state)
            node.waiting = False

    def _on_upgrade(self, node, msg, home, blk, line, dir_entry):
        PH = 0
        P = self.planes
        assert dir_entry is not None, "UPGRADE must arrive at home"
        if dir_entry.state == DirState.S or (
            P.has_so and dir_entry.state == DirState.SO
        ):
            self._send(
                PH, msg.sender,
                Message(
                    MsgType.REPLY_ID, node.id, msg.address,
                    sharers=self._fanout_mask(dir_entry.sharers, msg.sender),
                ),
            )
            dir_entry.state = DirState.EM
            dir_entry.sharers = bit(msg.sender)
            if P.has_owner_plane:
                self._set_owner(dir_entry, NO_PROC)
        else:
            # fallback: directory lost track (assignment.c:317-326)
            dir_entry.state = DirState.EM
            dir_entry.sharers = bit(msg.sender)
            self._send(
                PH, msg.sender,
                Message(MsgType.REPLY_ID, node.id, msg.address, sharers=0),
            )

    def _on_reply_id(self, node, msg, home, blk, line, dir_entry):
        PH = 0
        fan_out = True
        if line.address == msg.address and line.state != CacheState.MODIFIED:
            line.value = node.pending_write
            line.state = CacheState.MODIFIED
        elif line.address == msg.address and line.state == CacheState.MODIFIED:
            pass  # write already applied locally on the S-hit path
        else:
            # line was replaced while waiting: drop, no INVs
            # (assignment.c:339-347)
            fan_out = False
        if fan_out:
            for i in range(self.config.num_procs):
                if i != node.id and is_bit_set(msg.sharers, i):
                    self._send(
                        PH, i, Message(MsgType.INV, node.id, msg.address)
                    )
        node.waiting = False

    def _on_inv(self, node, msg, home, blk, line, dir_entry):
        if (
            line.address == msg.address
            and int(line.state) in self.planes.inv_states
        ):
            line.state = CacheState.INVALID
            self.counters["invalidations"] += 1

    def _on_write_request(self, node, msg, home, blk, line, dir_entry):
        PH = 0
        P = self.planes
        assert dir_entry is not None, "WRITE_REQUEST must arrive at home"
        if self.sem.eager_write_request_memory:
            # HEAD quirk (assignment.c:379); fixtures update memory
            # only on FLUSH/FLUSH_INVACK/EVICT_MODIFIED
            node.memory[blk] = msg.value
        if dir_entry.state == DirState.U:
            dir_entry.state = DirState.EM
            dir_entry.sharers = bit(msg.sender)
            self._send(
                PH, msg.sender,
                Message(MsgType.REPLY_WR, node.id, msg.address),
            )
        elif dir_entry.state == DirState.S or (
            P.has_so and dir_entry.state == DirState.SO
        ):
            # the writer invalidates everyone, incl. any tracked
            # owner/forwarder
            self._send(
                PH, msg.sender,
                Message(
                    MsgType.REPLY_ID, node.id, msg.address,
                    sharers=self._fanout_mask(dir_entry.sharers, msg.sender),
                ),
            )
            dir_entry.state = DirState.EM
            dir_entry.sharers = bit(msg.sender)
            if P.has_owner_plane:
                self._set_owner(dir_entry, NO_PROC)
        else:  # EM
            owner = find_owner(dir_entry.sharers)
            assert owner != -1
            if owner == msg.sender:
                self._send(
                    PH, msg.sender,
                    Message(MsgType.REPLY_WR, node.id, msg.address),
                )
            else:
                self._send(
                    PH, owner,
                    Message(
                        MsgType.WRITEBACK_INV, node.id, msg.address,
                        second_receiver=msg.sender,
                    ),
                )
                # state stays EM; sharers optimistically = requester
                # (assignment.c:429)
                dir_entry.sharers = bit(msg.sender)

    def _on_reply_wr(self, node, msg, home, blk, line, dir_entry):
        assert (
            line.address == msg.address
            or line.address == INVALID_ADDR
            or line.state == CacheState.INVALID
        ), "REPLY_WR arrived but the slot holds another valid line"
        line.address = msg.address
        line.value = node.pending_write
        line.state = CacheState.MODIFIED
        node.waiting = False

    def _on_writeback_inv(self, node, msg, home, blk, line, dir_entry):
        PH = 0
        if (
            line.address == msg.address
            and int(line.state) in self.planes.wbinv_resp_states
        ):
            ack = Message(
                MsgType.FLUSH_INVACK, node.id, msg.address,
                value=line.value, second_receiver=msg.second_receiver,
            )
            self._send(PH, home, ack)
            if msg.second_receiver != home:
                self._send(PH, msg.second_receiver, ack.copy())
            line.state = CacheState.INVALID
        elif self.sem.intervention_miss_policy == "nack":
            self._send(
                PH, home,
                Message(
                    MsgType.NACK, node.id, msg.address,
                    sharers=1,  # 1 = write intervention
                    second_receiver=msg.second_receiver,
                ),
            )
        # else: silent drop (assignment.c:467-472)

    def _on_flush_invack(self, node, msg, home, blk, line, dir_entry):
        if node.id == home:
            assert dir_entry is not None
            node.memory[blk] = msg.value
            dir_entry.state = DirState.EM
            dir_entry.sharers = bit(msg.second_receiver)
            if self.planes.has_owner_plane:
                self._set_owner(dir_entry, NO_PROC)
        if node.id == msg.second_receiver:
            assert (
                line.address == msg.address
                or line.address == INVALID_ADDR
                or line.state == CacheState.INVALID
            ), "FLUSH_INVACK arrived but the slot holds another valid line"
            line.address = msg.address
            # fixtures: the requester's own pending write survives;
            # HEAD installs the flushed old value (SURVEY.md §6.2.3)
            line.value = (
                msg.value
                if self.sem.flush_invack_fills_old_value
                else node.pending_write
            )
            line.state = CacheState.MODIFIED
            node.waiting = False

    def _on_evict_shared(self, node, msg, home, blk, line, dir_entry):
        PH = 0
        P = self.planes
        if node.id == home:
            assert dir_entry is not None
            if is_bit_set(dir_entry.sharers, msg.sender):
                was_s = dir_entry.state == DirState.S
                in_so = P.has_so and dir_entry.state == DirState.SO
                dir_entry.sharers &= ~bit(msg.sender)
                remaining = count_sharers(dir_entry.sharers)
                if remaining == 0:
                    dir_entry.state = DirState.U
                    if in_so or (P.has_fwd and was_s):
                        self._set_owner(dir_entry, NO_PROC)
                elif remaining == 1 and (was_s or in_so):
                    dir_entry.state = DirState.EM
                    if in_so or (P.has_fwd and was_s):
                        self._set_owner(dir_entry, NO_PROC)
                    survivor = find_owner(dir_entry.sharers)
                    notify_type = (
                        MsgType.EVICT_SHARED
                        if self.sem.overloaded_evict_shared_notify
                        else MsgType.UPGRADE_NOTIFY
                    )
                    self._send(
                        PH, survivor,
                        Message(notify_type, node.id, msg.address),
                    )
                elif (
                    P.has_fwd and was_s
                    and dir_entry.owner == msg.sender
                ):
                    # an evicting forwarder abdicates; the next reader
                    # re-seeds F
                    self._set_owner(dir_entry, NO_PROC)
                # several_left in SO: sharers shrink, SO + owner stay
        elif self.sem.overloaded_evict_shared_notify:
            # HEAD's overloaded upgrade-notify (assignment.c:522-538)
            if msg.sender == home:
                if (
                    line.address == msg.address
                    and line.state == CacheState.SHARED
                ):
                    line.state = CacheState.EXCLUSIVE
        # else: a non-home EVICT_SHARED cannot occur in fixture
        # semantics (the notify is UPGRADE_NOTIFY)

    def _on_upgrade_notify(self, node, msg, home, blk, line, dir_entry):
        # home -> surviving sharer: silent promotion (MESI/MESIF S->E,
        # MOESI also O->M).  Distinct type fixes the home-is-a-sharer
        # livelock (SURVEY.md §6.3); the home itself receives it
        # through its own mailbox too.
        if msg.sender == home and line.address == msg.address:
            nxt = self._notify_map.get(int(line.state))
            if nxt is not None:
                line.state = CacheState(nxt)

    def _on_evict_modified(self, node, msg, home, blk, line, dir_entry):
        P = self.planes
        assert dir_entry is not None, "EVICT_MODIFIED must arrive at home"
        node.memory[blk] = msg.value
        if dir_entry.state == DirState.EM and is_bit_set(
            dir_entry.sharers, msg.sender
        ):
            dir_entry.sharers = 0
            dir_entry.state = DirState.U
        elif (
            P.has_so
            and dir_entry.state == DirState.SO
            and dir_entry.owner == msg.sender
        ):
            # the OWNED cache wrote back: remaining sharers (if any)
            # are clean-shared against the freshened memory
            dir_entry.sharers &= ~bit(msg.sender)
            self._set_owner(dir_entry, NO_PROC)
            dir_entry.state = (
                DirState.U
                if count_sharers(dir_entry.sharers) == 0
                else DirState.S
            )
        # else: stale eviction — release-build HEAD leaves the
        # directory untouched (recovery exists only under DEBUG_MSG,
        # assignment.c:548-560)

    def _on_nack(self, node, msg, home, blk, line, dir_entry):
        # robust mode only: re-serve the original request from
        # memory.  The stale owner no longer holds the line, so the
        # home can satisfy the requester directly.
        PH = 0
        P = self.planes
        assert dir_entry is not None, "NACK must arrive at home"
        requester = msg.second_receiver
        if msg.sharers == 0:  # read
            dir_entry.state = DirState.S
            dir_entry.sharers |= bit(requester)
            if P.has_fwd:
                # the re-served reader becomes the forwarder
                self._set_owner(dir_entry, requester)
            elif P.has_so:
                # owner tracking is stale by construction
                self._set_owner(dir_entry, NO_PROC)
            self._send(
                PH, requester,
                Message(
                    MsgType.REPLY_RD, node.id, msg.address,
                    value=node.memory[blk], sharers=P.nack_rd_flag,
                ),
            )
        else:  # write
            dir_entry.state = DirState.EM
            dir_entry.sharers = bit(requester)
            if P.has_owner_plane:
                self._set_owner(dir_entry, NO_PROC)
            self._send(
                PH, requester,
                Message(MsgType.REPLY_WR, node.id, msg.address),
            )

    # -- instruction issue (assignment.c:590-697) ---------------------

    def _issue(self, node: Node) -> None:
        instr = node.trace[node.pc]
        node.pc += 1
        self.counters["instructions"] += 1
        self.issue_log.append(
            IssueRecord(
                proc=node.id, op=instr.op, address=instr.address,
                value=instr.value,
            )
        )
        PH = 1  # issue phase
        P = self.planes
        cfg = self.config
        home = cfg.home_of(instr.address)
        line = node.line_for(instr.address)

        if instr.op == "R":
            if (
                line.address == instr.address
                and int(line.state) in P.read_hit_states
            ):
                self.counters["read_hits"] += 1
            else:
                self.counters["read_misses"] += 1
                if line.address != INVALID_ADDR and line.state != CacheState.INVALID:
                    self._replace(PH, node, line)
                self._send(
                    PH, home,
                    Message(MsgType.READ_REQUEST, node.id, instr.address),
                )
                node.waiting = True
                # placeholder fill (assignment.c:626-628)
                line.state = CacheState.INVALID
                line.address = instr.address
                line.value = 0
        else:
            node.pending_write = instr.value
            if line.address == instr.address and line.state != CacheState.INVALID:
                self.counters["write_hits"] += 1
                if int(line.state) in P.silent_write_states:
                    line.value = instr.value
                    line.state = CacheState.MODIFIED  # silent E->M upgrade
                elif int(line.state) in P.upgrade_write_states:
                    self._send(
                        PH, home,
                        Message(MsgType.UPGRADE, node.id, instr.address),
                    )
                    # write applied locally before the REPLY_ID arrives
                    # (assignment.c:656-658)
                    line.value = instr.value
                    line.state = CacheState.MODIFIED
                    node.waiting = True
            else:
                self.counters["write_misses"] += 1
                if line.address != INVALID_ADDR and line.state != CacheState.INVALID:
                    self._replace(PH, node, line)
                self._send(
                    PH, home,
                    Message(
                        MsgType.WRITE_REQUEST, node.id, instr.address,
                        value=instr.value,
                    ),
                )
                node.waiting = True
                line.state = CacheState.INVALID
                line.address = instr.address
                line.value = 0

    # -- the lockstep cycle -------------------------------------------

    def step(self) -> bool:
        """Run one global cycle.  Returns True if any progress was made."""
        progress = False
        active = False  # watchdog progress: retired instr / drained msg
        handled = [False] * len(self.nodes)

        # 1. handle: up to messages_per_cycle messages per node, in
        # FIFO order (blocked nodes — those with deferred sends —
        # stall entirely, like a reference thread blocked inside
        # sendMessage, assignment.c:715-724).  The blocked check is a
        # cycle-start property: a node's own sends defer only at
        # end-of-cycle delivery, so they never gate its later drains
        # within the same cycle.
        for node in self.nodes:
            if node.pending_sends:
                continue
            for _ in range(self.config.messages_per_cycle):
                if not node.mailbox:
                    break
                # interconnect gating: the mailbox is an ordered virtual
                # channel — the head blocks until its delivery cycle
                # (later entries wait behind it, preserving FIFO)
                if node.mailbox[0].deliver_at > self.cycle:
                    break
                msg = node.mailbox.popleft()
                if self.trace_msgs:
                    self.msg_log.append(
                        f"Processor {node.id} msg from: {msg.sender}, "
                        f"type: {int(msg.type)}, "
                        f"address: 0x{msg.address:02X}"
                    )
                self._handle(node, msg)
                handled[node.id] = True
                progress = True
                active = True

        # 2. issue
        if self.replay_order is not None:
            issued: set = set()
            while self.order_pos < len(self.replay_order):
                rec = self.replay_order[self.order_pos]
                node = self.nodes[rec.proc]
                ready = (
                    node.id not in issued
                    and not node.mailbox
                    and not node.waiting
                    and not node.pending_sends
                    and node.pc < len(node.trace)
                )
                if not ready:
                    break
                nxt = node.trace[node.pc]
                if (nxt.op, nxt.address) != (rec.op, rec.address):
                    raise StallError(
                        f"replay order mismatch at {self.order_pos}: "
                        f"trace has {nxt}, order has {rec}"
                    )
                self._issue(node)
                issued.add(node.id)
                self.order_pos += 1
                progress = True
                active = True
                if not self.replay_batched:
                    break
        else:
            for node in self.nodes:
                if (
                    not node.mailbox
                    and not node.waiting
                    and not node.pending_sends
                    and node.pc < len(node.trace)
                ):
                    self._issue(node)
                    progress = True
                    active = True

        # 3. deliver (capacity backpressure; delivering a previously
        # deferred send is progress even in an otherwise idle cycle)
        if self._outbox or any(n.pending_sends for n in self.nodes):
            if self._deliver():
                progress = True

        # 4. dump-at-local-completion snapshots.  The canonical dump is
        # the *earliest* legal one; every later post-completion state is
        # kept as a candidate (see Node.dump_candidates).
        for node in self.nodes:
            if (
                node.pc >= len(node.trace)
                and not node.waiting
                and not node.pending_sends
            ):
                if not node.dumped:
                    if not node.mailbox:
                        node.dumped = True
                        node.snapshot = node.dump()
                        node.dump_candidates.append(node.snapshot)
                        progress = True
                elif handled[node.id]:
                    node.dump_candidates.append(node.dump())

        if active:
            self.last_activity_cycle = self.cycle
        if self.debug_invariants:
            from hpa2_tpu_torch.utils.invariants import check_invariants

            bad = check_invariants(
                [n.dump() for n in self.nodes], self.config, mid_flight=True
            )
            if bad:
                raise self.stall_diagnostic(
                    "mid-flight invariant violation"
                )
        self.cycle += 1
        return progress

    def quiescent(self) -> bool:
        return all(
            n.pc >= len(n.trace)
            and not n.waiting
            and not n.mailbox
            and not n.pending_sends
            for n in self.nodes
        ) and (self.replay_order is None or self.order_pos >= len(self.replay_order))

    def stall_diagnostic(self, reason: str) -> StallDiagnostic:
        """Snapshot the structured post-mortem for a stalled system."""
        from hpa2_tpu_torch.utils.invariants import check_invariants

        line_states: Dict[int, List[str]] = {}
        for n in self.nodes:
            lines = []
            for idx, ln in enumerate(n.cache):
                if ln.address == INVALID_ADDR:
                    continue
                lines.append(
                    f"[{idx}] 0x{ln.address:02X}="
                    f"{CacheState(ln.state).name}({ln.value})"
                )
            line_states[n.id] = lines
        return StallDiagnostic(
            reason=reason,
            cycle=self.cycle,
            mailbox_depths={n.id: len(n.mailbox) for n in self.nodes},
            waiting=[n.id for n in self.nodes if n.waiting],
            blocked=[n.id for n in self.nodes if n.pending_sends],
            line_states=line_states,
            recent_msgs=self.recent_msgs.lines(),
            invariant_violations=check_invariants(
                self.final_dumps(), self.config, mid_flight=True
            ),
            counters=self.stats(),
        )

    def stats(self) -> Dict[str, int]:
        """Counter dict in the shared one-stats-schema shape: engine
        counters plus the interconnect aggregates (only-when-nonzero,
        so ideal/fault-free parity with the JAX engines stays
        key-for-key exact)."""
        out = dict(self.counters)
        if self.link_tracker is not None:
            out.update(self.link_tracker.counters())
        return out

    def link_stats(self) -> Dict[str, dict]:
        """Per-link interconnect observability (empty for ideal)."""
        if self.link_tracker is None:
            return {}
        return self.link_tracker.link_stats()

    def run(
        self,
        max_cycles: int = 10_000_000,
        watchdog_cycles: int = 10_000,
    ) -> None:
        """Run to quiescence.

        Two stall detectors guard the loop.  The fast detector fires
        after 3 consecutive zero-progress cycles — sound when the
        transport is reliable, because an idle non-quiescent system
        can never move again.  Under fault injection a zero-progress
        cycle still retries stalled links with fresh randomness, so
        the fast detector is replaced by the watchdog: no instruction
        retired AND no mailbox drained for ``watchdog_cycles``
        consecutive cycles (0 disables it).  Both raise a structured
        :class:`StallDiagnostic` instead of spinning to ``max_cycles``.
        """
        stall = 0
        fault_on = self._fault_rng is not None
        while not (self.quiescent() and all(n.dumped for n in self.nodes)):
            progress = self.step()
            if self.cycle >= max_cycles:
                raise StallError(f"no quiescence after {max_cycles} cycles")
            if (
                watchdog_cycles
                and self.cycle - self.last_activity_cycle >= watchdog_cycles
            ):
                raise self.stall_diagnostic(
                    "watchdog: no instruction retired and no mailbox "
                    f"drained for {watchdog_cycles} cycles"
                )
            if not progress:
                # a cycle that only waited on in-flight interconnect
                # delays is not a livelock: gated heads become
                # handleable once their delivery cycle arrives
                gated = any(
                    n.mailbox and n.mailbox[0].deliver_at > self.cycle
                    for n in self.nodes
                )
                stall = 0 if gated else stall + 1
                if stall > 2 and not fault_on:
                    raise self.stall_diagnostic(
                        f"livelock at cycle {self.cycle}: stale "
                        "intervention dropped? cyclic full mailboxes? "
                        "use Semantics.intervention_miss_policy='nack' "
                        "/ a larger msg_buffer_size"
                    )
            else:
                stall = 0

    def continue_with(self, traces: Sequence[Sequence[Instr]]) -> None:
        """Swap in the next per-node instruction window after
        quiescence and restart the program counters — the spec-side
        mirror of PallasEngine's ``trace_window`` schedule (a legal
        re-scheduling of one long program as successive quiesced
        windows)."""
        if not self.quiescent():
            raise StallError("continue_with requires a quiescent system")
        if len(traces) != self.config.num_procs:
            raise ValueError("need one trace per node")
        for nd, tr in zip(self.nodes, traces):
            nd.trace = list(tr)
            nd.pc = 0

    # -- results ------------------------------------------------------

    def snapshots(self) -> List[NodeDump]:
        return [
            n.snapshot if n.snapshot is not None else n.dump() for n in self.nodes
        ]

    def final_dumps(self) -> List[NodeDump]:
        """Final quiescent state (a mode the reference lacks)."""
        return [n.dump() for n in self.nodes]


# _DISPATCH stays a literal dict (the analyzer's dispatch lint pins
# that), but it cannot drift from the table's event vocabulary: the
# compiled-table derivation must agree with it exactly.
assert SpecEngine._DISPATCH == generated_dispatch(), (
    "SpecEngine._DISPATCH disagrees with the dispatch generated from "
    "the transition table's event vocabulary"
)
