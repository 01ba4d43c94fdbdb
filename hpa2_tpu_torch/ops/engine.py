"""Host-side drivers of the general engine, the port of
``hpa2_tpu/ops/engine.py``.

``TorchEngine`` is the counterpart of ``JaxEngine`` (l.74-243): build a
system's state from its traces, run it to quiescence on the device,
read back the dump-at-local-completion snapshots, the final dumps, the
counters and the per-link interconnect counters.
``run_capturing_candidates`` steps the same cycle from the host and
records every legal dump timing of each node.  ``BatchTorchEngine`` is
the counterpart of ``BatchJaxEngine`` (l.549) without a schedule and
with one data shard: an ensemble of independent systems advanced by one
batched step under one batch-global loop.  Both run the loop of
``ops/step.py:Run`` (a captured CUDA graph a chunk on the card).

Not ported yet: ``BatchJaxEngine``'s ``schedule=`` modes
(``_chunk_loop``, ``build_batched_run_chunk``,
``build_fused_batched_run``) and ``BatchLaneSession``, which are ROADMAP
queue 1 item 2b, and ``data_shards > 1``, which is item 4.  Each raises
``ValueError``.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.models.protocol import CacheState, Instr, MsgType
from hpa2_tpu_torch.ops import bits
from hpa2_tpu_torch.ops.cuda_engine import format_stats, resolve_device
from hpa2_tpu_torch.ops.layout import StallError
from hpa2_tpu_torch.ops.state import (
    MB_ADDR,
    MB_SENDER,
    MB_TYPE,
    SimState,
    init_state,
    init_state_batched,
    select,
    stack_states,
    trace_arrays,
)
from hpa2_tpu_torch.ops.step import build_run, build_step, quiescent
from hpa2_tpu_torch.protocols.compiler import planes_for
from hpa2_tpu_torch.utils.dump import NodeDump
from hpa2_tpu_torch.utils.trace import IssueRecord

__all__ = [
    "BatchTorchEngine", "StallDiagnostic", "TorchEngine",
    "build_batched_run", "engine_stats", "format_stats", "link_stats",
    "stack_states", "stall_diagnostic",
]


class StallDiagnostic(StallError):
    """Structured stall/watchdog diagnostic
    (``hpa2_tpu/models/spec_engine.py:StallDiagnostic``, l.156): a
    ``StallError`` carrying per-node mailbox depths, the waiting and
    send-blocked nodes, cache-line states, the still-queued mailbox
    heads, an advisory mid-flight invariant check and the counters."""

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


def _np(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def _node_dump_from(arrs, node_id: int, with_owner: bool = False) -> NodeDump:
    mem, dstate, dsh, down, caddr, cval, cstate = arrs
    return NodeDump(
        proc_id=node_id,
        memory=[int(x) for x in mem[node_id]],
        dir_state=[int(x) for x in dstate[node_id]],
        dir_sharers=[bits.to_int(m) for m in dsh[node_id]],
        cache_addr=[int(x) for x in caddr[node_id]],
        cache_value=[int(x) for x in cval[node_id]],
        cache_state=[int(x) for x in cstate[node_id]],
        dir_owner=(
            [int(x) for x in down[node_id]] if with_owner else None
        ),
    )


def _owner_dumped(config: SystemConfig) -> bool:
    """Owner-plane protocols carry dir_owner in their dumps; MESI keeps
    ``NodeDump.dir_owner = None``."""
    return planes_for(config.protocol, config.semantics).has_owner_plane


def _live_arrays(st: SimState, b: int = 0):
    return tuple(
        _np(x[b]) for x in (
            st.mem, st.dir_state, st.dir_sharers, st.dir_owner,
            st.cache_addr, st.cache_val, st.cache_state,
        )
    )


def _snap_arrays(st: SimState, b: int = 0):
    return tuple(
        _np(x[b]) for x in (
            st.snap_mem, st.snap_dir_state, st.snap_dir_sharers,
            st.snap_dir_owner, st.snap_cache_addr, st.snap_cache_val,
            st.snap_cache_state,
        )
    )


def _dumps(config: SystemConfig, arrs) -> List[NodeDump]:
    wo = _owner_dumped(config)
    return [_node_dump_from(arrs, i, wo) for i in range(config.num_procs)]


class TorchEngine:
    """One system on the general engine (``JaxEngine``'s interface):
    ``run()``, ``run_capturing_candidates()``, ``snapshots()``,
    ``final_dumps()``, ``stats()``, ``link_stats()``, ``cycle``,
    ``instructions``, ``messages``.  ``device="cpu"`` runs on the CPU;
    the default ``"cuda"`` raises when there is no GPU."""

    def __init__(
        self,
        config: SystemConfig,
        traces: Sequence[Sequence[Instr]],
        replay_order: Optional[Sequence[IssueRecord]] = None,
        max_cycles: int = 1_000_000,
        watchdog_cycles: int = 10_000,
        device="cuda",
    ):
        self.config = config
        self.max_cycles = max_cycles
        self.watchdog_cycles = watchdog_cycles
        self.replay = replay_order is not None
        self.device = resolve_device(device)
        if self.replay:
            # fail fast instead of simulating a wrong-but-plausible run
            # from a mismatched order log
            from hpa2_tpu_torch.utils.trace import (
                validate_order_against_traces,
            )

            validate_order_against_traces(replay_order, traces)
        self.state: SimState = init_state(config, traces, replay_order,
                                          device=self.device)
        self._run = build_run(
            config, replay=self.replay, max_cycles=max_cycles,
            watchdog_cycles=watchdog_cycles,
        )
        self.dump_candidates: List[List[NodeDump]] = [
            [] for _ in range(config.num_procs)
        ]

    # -- production path: whole run on the device ---------------------

    def run(self) -> "TorchEngine":
        self.state = self._run(self.state)
        self._check_completed(self.state)
        return self

    def _check_completed(self, st: SimState) -> None:
        if bool(st.overflow[0]):
            # unreachable by construction: delivery accepts at most
            # cap - count candidates per receiver; an engine-bug
            # tripwire
            raise StallError(
                "internal invariant violated: mailbox exceeded capacity "
                "despite backpressure (engine bug)"
            )
        if not bool(quiescent(st)[0]):
            cycle = int(st.cycle[0])
            stalled_for = cycle - int(st.last_progress[0])
            if (
                self.watchdog_cycles
                and cycle < self.max_cycles
                and stalled_for >= self.watchdog_cycles
            ):
                raise stall_diagnostic(
                    self.config, st,
                    "watchdog: no instruction retired and no mailbox "
                    f"drained for {stalled_for} cycles",
                )
            raise StallError(
                f"no quiescence after {cycle} cycles "
                "(livelock: stale intervention dropped? use "
                "Semantics.intervention_miss_policy='nack')"
            )

    # -- parity path: per-cycle stepping with candidate capture -------

    def run_capturing_candidates(self) -> "TorchEngine":
        """Step the lockstep cycle from the host, recording every legal
        dump timing per node (``JaxEngine.run_capturing_candidates``,
        l.143)."""
        step = build_step(self.config, replay=self.replay)
        st = self.state
        n = self.config.num_procs
        completed = np.zeros(n, dtype=bool)
        cycles = 0
        wo = _owner_dumped(self.config)
        while not bool(quiescent(st)[0]):
            if cycles >= self.max_cycles or bool(st.overflow[0]):
                self.state = st
                self._check_completed(st)
                break
            handled = (_np(st.mb_count[0]) > 0) & ~np.any(
                _np(st.ob_valid[0]), axis=1
            )
            st = step(st)
            cycles += 1
            snap_taken = _np(st.snap_taken[0])
            # a node that ended the cycle send-blocked is not a legal
            # dump timing (and is never captured later either)
            post_blocked = np.any(_np(st.ob_valid[0]), axis=1)
            capture = [
                i
                for i in range(n)
                if (snap_taken[i] and not completed[i])
                or (completed[i] and handled[i] and not post_blocked[i])
            ]
            if capture:
                arrs = _live_arrays(st)
                for i in capture:
                    completed[i] = True
                    self.dump_candidates[i].append(
                        _node_dump_from(arrs, i, wo)
                    )
        self.state = st
        return self

    # -- readback -----------------------------------------------------

    def snapshots(self) -> List[NodeDump]:
        """Canonical (earliest) dump-at-local-completion per node."""
        return _dumps(self.config, _snap_arrays(self.state))

    def final_dumps(self) -> List[NodeDump]:
        return _dumps(self.config, _live_arrays(self.state))

    @property
    def cycle(self) -> int:
        return int(self.state.cycle[0])

    @property
    def instructions(self) -> int:
        return int(self.state.n_instr[0])

    @property
    def messages(self) -> int:
        return int(self.state.n_msgs[0])

    def stats(self) -> dict:
        """Counter dict with the spec engine's key names."""
        return engine_stats(self.state)

    def link_stats(self) -> dict:
        """Per-link interconnect counters ({} under the ideal
        topology)."""
        return link_stats(self.state, self.config)


def stall_diagnostic(
    config: SystemConfig, st: SimState, reason: str, b: int = 0
) -> StallDiagnostic:
    """Structured post-mortem of system ``b`` of a state
    (``hpa2_tpu/ops/engine.py:stall_diagnostic``, l.245): the still-queued
    mailbox heads stand for the recent messages.  The same diagnostic
    whatever batch ran the system."""
    from hpa2_tpu_torch.utils.invariants import check_invariants

    n = config.num_procs
    mb_count = _np(st.mb_count[b])
    waiting = _np(st.waiting[b])
    blocked = np.any(_np(st.ob_valid[b]), axis=1)
    caddr = _np(st.cache_addr[b])
    cval = _np(st.cache_val[b])
    cstate = _np(st.cache_state[b])
    line_states = {}
    for i in range(n):
        lines = []
        for idx in range(config.cache_size):
            a = int(caddr[i, idx])
            if a == -1:
                continue
            lines.append(
                f"[{idx}] 0x{a:02X}="
                f"{CacheState(int(cstate[i, idx])).name}"
                f"({int(cval[i, idx])})"
            )
        line_states[i] = lines
    mb_data = _np(st.mb_data[b])
    queued = []
    for i in range(n):
        for s_i in range(min(int(mb_count[i]), 4)):
            row = mb_data[i, s_i]
            queued.append(
                f"queued at node {i}[{s_i}]: from "
                f"{int(row[MB_SENDER])} "
                f"{MsgType(int(row[MB_TYPE])).name} "
                f"0x{int(row[MB_ADDR]):02X}"
            )
    dumps = _dumps(config, _live_arrays(st, b))
    return StallDiagnostic(
        reason=reason,
        cycle=int(st.cycle[b]),
        mailbox_depths={i: int(mb_count[i]) for i in range(n)},
        waiting=[i for i in range(n) if waiting[i]],
        blocked=[i for i in range(n) if blocked[i]],
        line_states=line_states,
        recent_msgs=queued,
        invariant_violations=check_invariants(
            dumps, config, mid_flight=True
        ),
        counters=engine_stats(select(st, b)),
    )


def engine_stats(st: SimState) -> dict:
    """Counters summed over every system of the batch
    (``hpa2_tpu/ops/engine.py:engine_stats``, l.318)."""
    mc = _np(st.msg_counts).astype(np.int64).sum(axis=0)
    tot = lambda x: int(_np(x).astype(np.int64).sum())
    core = {
        "instructions": tot(st.n_instr),
        "msgs_total": tot(st.n_msgs),
        "read_hits": tot(st.n_read_hits),
        "read_misses": tot(st.n_read_miss),
        "write_hits": tot(st.n_write_hits),
        "write_misses": tot(st.n_write_miss),
        "evictions": tot(st.n_evictions),
        "invalidations": tot(st.n_invalidations),
    }
    # fault, interconnect, elision, protocol-variant and exchange
    # counters: present only when nonzero, so the schema of a run that
    # never used them is the reference's
    for name, field in (
        ("fault_retransmissions", st.n_retrans),
        ("fault_dups_filtered", st.n_dup_filtered),
        ("fault_reorders_fixed", st.n_reorder_fixed),
        ("fault_delays", st.n_delays),
        ("fault_link_stalls", st.n_wire_stalls),
        ("topo_delay_cycles", st.n_topo_delay),
        ("topo_multicast_saved", st.n_multicast_saved),
        ("topo_combined", st.n_combined),
        ("elided_cycles", st.n_elided),
        ("multi_hit_retired", st.n_multi_hit),
        ("forwards", st.n_forwards),
        ("owner_transfers", st.n_owner_xfer),
        ("dir_overflows", st.n_dir_overflow),
        ("exchange_sent", st.n_exch_sent),
        ("exchange_multicast_saved", st.n_exch_mc_saved),
        ("exchange_combined", st.n_exch_combined),
    ):
        val = tot(field)
        if val:
            core[name] = val
    # the slot high-water mark is a max, not a sum
    hwm = int(_np(st.n_exch_hwm).max())
    if hwm:
        core["exchange_slot_hwm"] = hwm
    return format_stats(core, mc)


def link_stats(st: SimState, config: SystemConfig) -> dict:
    """Per-link interconnect counters keyed by link name, summed (the
    maxima: max) over the batch
    (``hpa2_tpu/ops/engine.py:link_stats``, l.373)."""
    if not config.interconnect.enabled:
        return {}
    from hpa2_tpu_torch.interconnect.topology import build_topology

    topo = build_topology(
        config.interconnect.topology,
        config.num_procs,
        config.interconnect.hop_latency,
    )
    trav = _np(st.link_traversals).astype(np.int64).sum(axis=0)
    peak = _np(st.link_max_load).max(axis=0)
    return {
        "traversals": {
            name: int(trav[i])
            for i, name in enumerate(topo.link_names)
            if trav[i]
        },
        "max_load": {
            name: int(peak[i])
            for i, name in enumerate(topo.link_names)
            if peak[i]
        },
    }


def build_batched_run(config: SystemConfig, max_cycles: int = 1_000_000,
                      watchdog_cycles: int = 0):
    """The batch's run to quiescence
    (``hpa2_tpu/ops/engine.py:build_batched_run``, l.416): one loop
    drives the batched step until every system is quiescent, under the
    batch-global condition; quiescent systems idle.  The same loop as
    ``ops/step.py:build_run``."""
    return build_run(config, replay=False, max_cycles=max_cycles,
                     watchdog_cycles=watchdog_cycles)


class BatchTorchEngine:
    """An ensemble of B independent systems (``BatchJaxEngine``'s
    interface without a schedule and on one data shard):
    ``system_snapshots(b)``, ``system_final_dumps(b)``, ``stats()``,
    ``link_stats()``, ``instructions``.  Every system starts from
    ``PRNGKey(fault.seed)``, as ``BatchJaxEngine`` stacks them."""

    def __init__(
        self,
        config: SystemConfig,
        batch_traces: Sequence[Sequence[Sequence[Instr]]],
        max_cycles: int = 1_000_000,
        data_shards: int = 1,
        watchdog_cycles: int = 0,
        schedule=None,
        device="cuda",
    ):
        if schedule is not None:
            raise ValueError(
                "BatchTorchEngine(schedule=...) is not ported yet (ROADMAP "
                "queue 1 item 2b: the scheduled chunk loops and "
                "BatchLaneSession); use the fast path's CudaEngine for "
                "scheduled runs")
        if data_shards != 1:
            raise ValueError(
                "data_shards > 1 runs on several GPUs, which the port does "
                "not do yet (ROADMAP queue 1 item 4)")
        self.config = config
        self.b = len(batch_traces)
        self.max_cycles = max_cycles
        self.watchdog_cycles = watchdog_cycles
        self.data_shards = data_shards
        self.schedule = schedule
        self.device = resolve_device(device)
        # every system padded to the longest trace, as BatchJaxEngine
        # stacks init_state(..., max_trace_len=max_t)
        max_t = max(
            (len(tr) for traces in batch_traces for tr in traces), default=1
        )
        arrays = [np.stack(a) for a in zip(*(
            trace_arrays(config, traces, max_t) for traces in batch_traces))]
        self.state = init_state_batched(config, *arrays, device=self.device,
                                        fold_keys=False)
        self._run = build_batched_run(
            config, max_cycles=max_cycles, watchdog_cycles=watchdog_cycles)

    def run(self) -> "BatchTorchEngine":
        st = self._run(self.state)
        self.state = st
        if bool(st.overflow.any()):
            raise StallError(
                "internal invariant violated: mailbox overflow despite "
                "backpressure")
        vq = _np(quiescent(st))
        if not vq.all():
            raise self._batch_stall(vq)
        return self

    def _batch_stall(self, vq: np.ndarray) -> Exception:
        """A watchdog-tripped batch raises the structured diagnostic of
        its first stalled system."""
        st = self.state
        b = int(np.argmin(vq))  # first non-quiescent system
        cycle = int(st.cycle[b])
        stalled_for = cycle - int(st.last_progress[b])
        if (
            self.watchdog_cycles
            and cycle < self.max_cycles
            and stalled_for >= self.watchdog_cycles
        ):
            return stall_diagnostic(
                self.config, st,
                "watchdog: no instruction retired and no mailbox "
                f"drained for {stalled_for} cycles "
                f"(system {b} of {self.b})",
                b=b,
            )
        return StallError("batch did not reach quiescence (livelock?)")

    def system_snapshots(self, b: int) -> List[NodeDump]:
        return _dumps(self.config, _snap_arrays(self.state, b))

    def system_final_dumps(self, b: int) -> List[NodeDump]:
        return _dumps(self.config, _live_arrays(self.state, b))

    def stats(self) -> dict:
        return engine_stats(self.state)

    def link_stats(self) -> dict:
        """Ensemble-aggregated per-link interconnect counters ({}
        under the ideal topology)."""
        return link_stats(self.state, self.config)

    @property
    def instructions(self) -> int:
        return int(self.state.n_instr.sum())
