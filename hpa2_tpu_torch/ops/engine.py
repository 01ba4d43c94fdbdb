"""Host-side drivers of the general engine, the port of
``hpa2_tpu/ops/engine.py``.

``TorchEngine`` is the counterpart of ``JaxEngine`` (l.74-243): build a
system's state from its traces, run it to quiescence on the device,
read back the dump-at-local-completion snapshots, the final dumps, the
counters and the per-link interconnect counters.
``run_capturing_candidates`` steps the same cycle from the host and
records every legal dump timing of each node.  ``BatchTorchEngine`` is
the counterpart of ``BatchJaxEngine`` (l.549) on one data shard: an
ensemble of independent systems advanced by one batched step under one
batch-global loop, and with ``schedule=`` streamed through ``resident``
rows, fused (``build_fused_batched_run``, l.522) or as the host chunk
loop (``ops/step.py:ChunkRun``, l.462-519).  ``BatchLaneSession``
(l.970-1161) holds resident rows for the serving loop.
``data_shards > 1`` splits the batch over several devices
(``parallel/sharding.py:DataShardedRun``: one loop whose condition and
elision jump are global over the shards, as ``BatchJaxEngine``'s
``shard_map(vmap(step))`` loop, so every field equals the unsharded
run's; the scheduler's groups are the shards).

Where trouble lies, and what the code does about it:

* **One host read a chunk.**  A session's chunk is a few replays of a
  captured graph of gated steps and one read that carries the loop
  flag, the overflow flag and every row's quiescence
  (``step.py:BoundChunk.status``); ``quiescent_rows`` is that read.
* **Resident rows stay in the graph's buffers.**  The JAX session
  donates its rows across chunks; here the chunk graph is captured on
  the session's own tensors, and ``admit``, ``retire``,
  ``window_extend`` and ``take_row`` index them in place.  Admissions
  and trace-length updates wait in a pending set and go in before the
  next chunk as one scatter per field, not one per row and field.
* **Host reads of CUDA tensors.**  The JAX harvest reads
  ``np.asarray(x)[row]`` per field and row (l.841-845); here the
  finished rows are gathered on the device and copied to the host in
  one transfer (``BatchLaneSession.take_rows``), and the scheduled
  engine keeps its harvests on the device.
* **Per-system ``cycle`` is not schedule invariant**, exactly as in
  JAX: the batched step ticks it until the row's cohort drains.  Dumps,
  snapshots, counters and ``stats()`` are; so is ``cycle`` between the
  two packages for one schedule.
* **Per-job keys.**  Every row starts from ``init_state``'s
  ``PRNGKey(fault.seed)``, as ``BatchJaxEngine`` stacks them, so a
  job's fault stream does not depend on the row it lands in.
"""

from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.models.protocol import CacheState, Instr, MsgType
from hpa2_tpu_torch.ops import bits
from hpa2_tpu_torch.ops.cuda_engine import format_stats, resolve_device
from hpa2_tpu_torch.models.spec_engine import StallDiagnostic, StallError
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
from hpa2_tpu_torch.ops.step import (
    build_batched_run_chunk, build_run, build_step, quiescent,
)
from hpa2_tpu_torch.protocols.compiler import planes_for
from hpa2_tpu_torch.utils.dump import NodeDump
from hpa2_tpu_torch.utils.trace import IssueRecord

__all__ = [
    "BatchLaneSession", "BatchTorchEngine", "StallDiagnostic",
    "TorchEngine", "build_batched_run", "build_batched_run_chunk",
    "build_fused_batched_run", "engine_stats", "format_stats",
    "link_stats", "stack_states", "stall_diagnostic",
]


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




def build_fused_batched_run(config: SystemConfig,
                            max_cycles: int = 1_000_000,
                            watchdog_cycles: int = 0, run=None):
    """The fused scheduled run
    (``hpa2_tpu/ops/engine.py:build_fused_batched_run``, l.522):
    ``fused(waves, sys_src)`` runs each wave of ``resident`` rows to
    quiescence with the unscheduled :func:`build_batched_run` loop, one
    wave after another, then gathers every system's row out of the
    waves' results (``sys_src[b]`` indexes wave * r + row).  The JAX
    program scans the waves inside one jitted program; here the scan
    is a host loop over the same loop, so the bits are the same.  ``run``
    replaces the wave's loop (the data-sharded one)."""
    run = run or build_batched_run(config, max_cycles, watchdog_cycles)

    def fused(waves: Sequence[SimState], sys_src) -> SimState:
        flat = stack_states([run(w) for w in waves])
        return select(flat, torch.as_tensor(
            np.asarray(sys_src, np.int64), device=flat.pc.device))

    return fused


def _data_devices(config: SystemConfig, rows: int, data_shards: int,
                  device) -> List[torch.device]:
    """The devices of ``data_shards`` row groups of ``rows`` rows (JAX
    ``BatchJaxEngine``: a ``(data_shards, 1)`` mesh, whose step is built
    with the node axis, so it takes the ideal MESI/full build only)."""
    if data_shards == 1:
        return [resolve_device(device)]
    if rows % data_shards != 0:
        raise ValueError(
            f"batch {rows} not divisible by data_shards={data_shards}")
    if config.interconnect.enabled:
        raise ValueError(
            "non-ideal interconnect topologies run single-shard only; "
            "data sharding composes with topology='ideal'")
    if config.protocol != "mesi" or config.directory_format != "full":
        raise ValueError(
            "data sharding runs the MESI/full-bitvector build only; "
            "protocol and directory-format variants are single-shard")
    from hpa2_tpu_torch.parallel.sharding import make_data_mesh

    return list(make_data_mesh(data_shards, device=device).devices)


def bind_chunk(config: SystemConfig, interval: int, st: SimState,
               devices: Sequence[torch.device]):
    """The chunk program over ``st``'s own tensors: ``ChunkRun.bind``, or
    over the data shards ``parallel/sharding.py:ShardedChunk``."""
    if len(devices) == 1:
        return build_batched_run_chunk(config, interval).bind(st)
    from hpa2_tpu_torch.parallel.sharding import ShardedChunk

    return ShardedChunk(config, interval, st, devices)


def _overflow_error() -> StallError:
    return StallError(
        "internal invariant violated: mailbox overflow despite "
        "backpressure")


class BatchTorchEngine:
    """An ensemble of B independent systems (``BatchJaxEngine``'s
    interface on one data shard): ``run()``, ``system_snapshots(b)``,
    ``system_final_dumps(b)``, ``stats()``, ``link_stats()``,
    ``instructions``, and with ``schedule=`` the ``occupancy`` stats.
    Every system starts from ``PRNGKey(fault.seed)``, as
    ``BatchJaxEngine`` stacks them.

    ``schedule=Schedule(...)`` streams the ensemble through
    ``schedule.resident`` rows.  ``fused=True`` (the default) runs the
    precomputed admission waves, each to quiescence, and gathers the
    systems' rows (``build_fused_batched_run``); ``fused=False`` is the
    host chunk loop: chunks of ``schedule.interval`` cycles, quiescent
    rows harvested and backfilled from the admission queue at each
    barrier.  Dumps, snapshots, counters and ``stats()`` equal the
    unscheduled run's; per-system ``cycle`` does not (the module
    docstring)."""

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
        self.config = config
        self.b = len(batch_traces)
        self._devices = _data_devices(config, self.b, data_shards, device)
        self.max_cycles = max_cycles
        self.watchdog_cycles = watchdog_cycles
        self.data_shards = data_shards
        self.schedule = schedule
        self.occupancy = None
        self.device = self._devices[0]
        # every system padded to the longest trace, as BatchJaxEngine
        # stacks init_state(..., max_trace_len=max_t); one empty system
        # after the last, which a row index of -1 picks
        max_t = max(
            (len(tr) for traces in batch_traces for tr in traces), default=1
        )
        empty = [[] for _ in range(config.num_procs)]
        self._arrays = [np.stack(a) for a in zip(*(
            trace_arrays(config, traces, max_t)
            for traces in list(batch_traces) + [empty]))]
        if schedule is not None:
            self._resident = schedule.resident or self.b
            if not (0 < self._resident <= self.b):
                raise ValueError(
                    f"schedule.resident={schedule.resident} outside "
                    f"1..{self.b}")
            if self._resident % data_shards:
                raise ValueError(
                    f"schedule.resident={self._resident} and batch "
                    f"{self.b} must divide data_shards={data_shards}")
            # the resident rows are built in the scheduled runs; the
            # ensemble's state exists only after the run, in system
            # order
            self.state = None
            self._run = None
            return
        self.state = self._fresh(np.arange(self.b))
        self._run = self._loop()

    def _loop(self):
        """The run to quiescence of a batch: the unsharded loop, or over
        the data shards (split, one global loop, joined back on the
        first shard's device)."""
        if self.data_shards == 1:
            return build_batched_run(self.config, self.max_cycles,
                                     self.watchdog_cycles)
        from hpa2_tpu_torch.parallel.sharding import (
            DataShardedRun, join_rows, split_rows,
        )

        run = DataShardedRun(self.config, self.max_cycles,
                             self.watchdog_cycles)
        return lambda st: join_rows(run(split_rows(st, self._devices)))

    def _fresh(self, systems: np.ndarray) -> SimState:
        """Initial rows of ``systems`` (-1: the empty system)."""
        return init_state_batched(
            self.config, *(a[systems] for a in self._arrays),
            device=self.device, fold_keys=False)

    def run(self) -> "BatchTorchEngine":
        if self.schedule is not None:
            if self.schedule.fused:
                return self._run_scheduled_fused()
            return self._run_scheduled()
        self.state = self._run(self.state)
        return self._check_run()

    def _check_run(self) -> "BatchTorchEngine":
        st = self.state
        if bool(st.overflow.any()):
            raise _overflow_error()
        vq = _np(quiescent(st))
        if not vq.all():
            raise self._batch_stall(vq)
        return self

    def _tr_len(self) -> np.ndarray:
        """Each system's longest trace."""
        return self._arrays[3][:self.b].max(axis=1, initial=0).astype(
            np.int64)

    def _group_order(self, tr_len: np.ndarray, g: int, gs: int
                     ) -> np.ndarray:
        """Group-local admission order of the schedule's policy
        (``BatchJaxEngine._group_order``, l.669): fair-drr charges one
        wave slot per system."""
        from hpa2_tpu_torch.ops.schedule import policy_order

        sl = slice(g * gs, (g + 1) * gs)
        sc = self.schedule
        keys = (
            np.ones(gs, dtype=np.int64) if sc.policy == "fair-drr"
            else tr_len[sl]
        )
        return policy_order(
            keys, sc.policy,
            deadline=(
                None if sc.deadlines is None
                else np.asarray(sc.deadlines[sl], dtype=np.int64)
            ),
            tenant=(
                None if sc.tenants is None
                else np.asarray(sc.tenants[sl], dtype=np.int64)
            ),
            weights=sc.tenant_weights,
        )

    def _run_scheduled_fused(self) -> "BatchTorchEngine":
        """The precomputed waves of ``resident`` rows in admission
        order, each run to quiescence, then every system's row gathered
        (``_run_scheduled_fused``, l.697).  Dead rows of the last wave
        carry the empty system: quiescent from cycle 0, they never hold
        a wave open, and nothing gathers them."""
        from hpa2_tpu_torch.ops.schedule import simulate

        r, b = self._resident, self.b
        groups = self.data_shards
        gl, gs = r // groups, b // groups
        n_waves = -(-gs // gl)
        # group g's rows sweep its system slice gl at a time in policy
        # order (one group a data shard)
        tr_len = self._tr_len()
        wave_sys = np.full((n_waves, r), -1, dtype=np.int64)
        for g in range(groups):
            order = g * gs + self._group_order(tr_len, g, gs)
            for k in range(n_waves):
                chunk_s = order[k * gl:(k + 1) * gl]
                wave_sys[k, g * gl:g * gl + len(chunk_s)] = chunk_s
        sys_src = np.empty(b, dtype=np.int64)
        for k in range(n_waves):
            live = wave_sys[k] >= 0
            sys_src[wave_sys[k][live]] = k * r + np.nonzero(live)[0]
        fused = build_fused_batched_run(self.config, self.max_cycles,
                                        self.watchdog_cycles, self._loop())
        self.state = fused([self._fresh(w) for w in wave_sys], sys_src)
        self._check_run()
        sc = self.schedule
        self.occupancy = simulate(
            np.ones(b, dtype=np.int64), resident=r, block=1, groups=groups,
            threshold=sc.threshold, fused=True, policy=sc.policy,
            deadline=sc.deadlines, tenant=sc.tenants,
            tenant_weights=sc.tenant_weights,
        ).attach_elision(self.state)
        return self

    def _run_scheduled(self) -> "BatchTorchEngine":
        """The host chunk loop (``_run_scheduled``, l.784): chunks of
        ``schedule.interval`` cycles over the resident rows, in place;
        at each barrier the quiescent rows are gathered on the device
        and refilled from the admission queue in row order, and a row
        older than ``max_cycles`` raises the stall diagnostic."""
        from hpa2_tpu_torch.ops.schedule import OccupancyStats

        cfg, r = self.config, self._resident
        chunk = max(1, self.schedule.interval)
        # one group (admission queue and rows) a data shard
        groups = self.data_shards
        gl, gs = r // groups, self.b // groups
        tr_len = self._tr_len()
        row_sys = np.full(r, -1, dtype=np.int64)
        queues = []
        for g in range(groups):
            order = g * gs + self._group_order(tr_len, g, gs)
            row_sys[g * gl:(g + 1) * gl] = order[:gl]
            queues.append(deque(int(s) for s in order[gl:]))
        st = self._fresh(row_sys)
        bound = bind_chunk(cfg, chunk, st, self._devices)
        done_sys: List[np.ndarray] = []
        done_rows: List[SimState] = []
        stats = OccupancyStats()
        row_age = np.zeros(r, dtype=np.int64)  # cycles since admission
        while (row_sys >= 0).any():
            live = row_sys >= 0
            stats.intervals += 1
            stats.live_lane_intervals += int(live.sum())
            stats.lane_intervals += r
            stats.block_segments += int(live.sum())
            bound.advance()
            row_age += chunk
            q, overflow = bound.status()
            if overflow:
                raise _overflow_error()
            rows = np.nonzero(live & q)[0]
            if len(rows):
                done_sys.append(row_sys[rows].copy())
                done_rows.append(select(st, torch.as_tensor(
                    rows, device=self.device)))
                row_sys[rows] = -1
            stuck = (row_sys >= 0) & ~q & (row_age > self.max_cycles)
            if stuck.any():
                row = int(np.argmax(stuck))
                raise stall_diagnostic(
                    cfg, st,
                    f"no quiescence within {self.max_cycles} cycles "
                    f"(system {int(row_sys[row])} of {self.b}, "
                    "scheduled run)",
                    b=row)
            repl = []
            for g, queue in enumerate(queues):
                for row in range(g * gl, (g + 1) * gl):
                    if not queue:
                        break
                    if row_sys[row] < 0:
                        s = queue.popleft()
                        row_sys[row] = s
                        row_age[row] = 0
                        repl.append((row, s))
            if repl:
                stats.admissions += len(repl)
                idx = torch.as_tensor([row for row, _ in repl],
                                      device=self.device)
                init = self._fresh(np.array([s for _, s in repl]))
                for dst, src in zip(st, init):
                    dst.index_copy_(0, idx, src)
        # the rows in system order, so every readback works unchanged
        perm = np.argsort(np.concatenate(done_sys), kind="stable")
        self.state = select(stack_states(done_rows), torch.as_tensor(
            perm, device=self.device))
        self.occupancy = stats.set_mode(fused=False).attach_elision(
            self.state)
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


# ---------------------------------------------------------------------------
# Resident-row serving session: the always-on analog of the scheduled
# chunk loop above.  Row completion is device quiescence, so the serving
# loop reads once a chunk; building arriving jobs' rows overlaps the
# chunk in flight.


def _signature(x) -> tuple:
    return tuple((tuple(t.shape[1:]), t.dtype) for t in x)


class BatchLaneSession:
    """Resident-row serving session for the general engine
    (``hpa2_tpu/ops/engine.py:BatchLaneSession``, l.970).

    Holds ``resident`` rows of :class:`SimState` at fixed shapes; dead
    rows carry the empty-trace state (quiescent from cycle 0, a fixed
    point of the step).  The serving loop drives chunks of ``interval``
    cycles:

    1. ``row = fresh_row(batch_traces)``: an arriving job's initial row,
       built on the host while a chunk runs;
    2. ``admit(idx, row)`` / ``retire(idx)``: a job into a free row / a
       finished row back to the empty state (both go in before the next
       chunk, one scatter per field);
    3. ``advance()``: enqueue one chunk;
    4. ``quiescent_rows()``: the chunk's one host read; rows quiescent
       with a job resident are finished;
    5. ``take_rows(idxs)`` / ``take_row(idx)``: the rows' states on the
       host, in one transfer.

    ``window=w`` emulates the fast path's window schedule: each row
    sees its trace clipped to successive ``w``-entry windows, with a
    quiescence barrier between (the loop crosses it with
    ``window_extend``), so a job migrated from the fast path keeps
    byte-identical dumps.  ``compile_counts()`` reports, for each
    program, the shapes it has taken (the chunk's graph captures on the
    card); the serving loop's guard needs each at one.  This backend
    has the fault layer, the protocol variants and the topologies.
    """

    def __init__(
        self,
        config: SystemConfig,
        resident: int,
        max_trace_len: int,
        *,
        interval: int = 256,
        max_cycles: int = 1_000_000,
        data_shards: int = 1,
        window: Optional[int] = None,
        device="cuda",
    ):
        self.config = config
        self.r = int(resident)
        devices = _data_devices(config, self.r, data_shards, device)
        self._sharded = data_shards != 1
        self._max_t = int(max_trace_len)
        self.interval = max(1, int(interval))
        self.max_cycles = max_cycles
        self.device = devices[0]
        self.window = None if window is None else max(1, int(window))
        self._full_len = np.zeros((self.r, config.num_procs), np.int32)
        self._seg = np.ones(self.r, np.int64)
        empty = [[] for _ in range(config.num_procs)]
        self._empty_row = init_state(config, empty,
                                     max_trace_len=self._max_t,
                                     device="cpu")
        self._st = stack_states([init_state(
            config, empty, max_trace_len=self._max_t, device=self.device)
        ] * self.r)
        self._bound = bind_chunk(config, self.interval, self._st, devices)
        # writes waiting for the next chunk: whole rows, and trace
        # lengths of resident rows (window barriers)
        self._rows: Dict[int, SimState] = {}
        self._lens: Dict[int, np.ndarray] = {}
        self._signatures = {"admit": set(), "take_row": set(),
                            "quiescent": set()}

    @property
    def state(self) -> SimState:
        """The resident rows, with every pending write applied."""
        self._flush()
        return self._st

    def _upload(self, t: torch.Tensor) -> torch.Tensor:
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _flush(self) -> None:
        if self._rows:
            idx = sorted(self._rows)
            rows = [self._rows[i] for i in idx]
            it = self._upload(torch.as_tensor(idx, dtype=torch.int64))
            for f, dst in enumerate(self._st):
                dst.index_copy_(0, it, self._upload(
                    torch.cat([row[f] for row in rows])))
            self._rows.clear()
        if self._lens:
            idx = sorted(self._lens)
            it = self._upload(torch.as_tensor(idx, dtype=torch.int64))
            self._st.tr_len.index_copy_(0, it, self._upload(
                torch.as_tensor(np.stack([self._lens[i] for i in idx]))))
            self._lens.clear()

    def fresh_row(self, batch_traces) -> SimState:
        """An arriving job's initial row on the host: the ``init_state``
        call (same key) the one-shot engine makes, so served dumps equal
        the batch's."""
        return init_state(self.config, batch_traces,
                          max_trace_len=self._max_t, device="cpu")

    def admit(self, idx: int, row: SimState) -> None:
        row = SimState(*(x.cpu() for x in row))
        self._signatures["admit"].add(_signature(row))
        if self.window is not None:
            full = _np(row.tr_len[0]).astype(np.int32)
            self._full_len[idx] = full
            self._seg[idx] = 1
            row = row._replace(tr_len=torch.as_tensor(
                np.minimum(full, self.window)[None]))
        self._rows[idx] = row
        self._lens.pop(idx, None)

    def window_done(self, idx: int) -> bool:
        """Under window emulation: is a quiescent row finished (every
        node's whole trace visible), or only at a barrier?"""
        if self.window is None:
            return True
        return bool(
            (self._seg[idx] * self.window >= self._full_len[idx]).all())

    def window_extend(self, idx: int) -> None:
        """Cross one window barrier: show a quiescent row the next
        ``window`` trace entries (a quiescent state is a fixed point, so
        where the chunk boundary fell changes nothing)."""
        self._seg[idx] += 1
        clip = np.minimum(self._full_len[idx],
                          self._seg[idx] * self.window).astype(np.int32)
        if idx in self._rows:
            self._rows[idx] = self._rows[idx]._replace(
                tr_len=torch.as_tensor(clip[None]))
        else:
            self._lens[idx] = clip

    def retire(self, idx: int) -> None:
        """Reset a harvested row to the empty-trace state so it stops
        holding its chunk's loop open."""
        self.admit(idx, self._empty_row)

    def advance(self) -> None:
        """Enqueue one chunk of up to ``interval`` cycles over every
        row (no host read on the card)."""
        self._flush()
        self._bound.advance()

    def quiescent_rows(self) -> np.ndarray:
        """The chunk's one host read: per-row quiescence, and the
        overflow invariant."""
        self._signatures["quiescent"].add(())
        quiet, overflow = self._bound.status()
        if overflow:
            raise _overflow_error()
        return quiet

    def take_rows(self, idxs: Sequence[int]) -> List[SimState]:
        """Rows ``idxs`` as host states (batches of one): one gather
        per field on the device, then one copy to the host."""
        self._flush()
        self._signatures["take_row"].add(())
        it = self._upload(torch.as_tensor(list(idxs), dtype=torch.int64))
        k = len(idxs)
        parts = [x.index_select(0, it) for x in self._st]
        flat = torch.cat([p.reshape(k, -1).to(torch.int32) for p in parts],
                         dim=1).cpu()
        fields, at = [], 0
        for p in parts:
            width = int(np.prod(p.shape[1:], dtype=np.int64))
            v = flat[:, at:at + width].reshape(p.shape)
            fields.append(v.bool() if p.dtype == torch.bool else v)
            at += width
        return [SimState(*(v[i:i + 1] for v in fields)) for i in range(k)]

    def take_row(self, idx: int) -> SimState:
        return self.take_rows([idx])[0]

    def dumps_of(self, row: SimState) -> List[NodeDump]:
        return _dumps(self.config, _live_arrays(row))

    def counters_of(self, row: SimState) -> dict:
        return {
            "instructions": int(row.n_instr.sum()),
            "cycles": int(row.cycle[0]),
            "messages": int(row.n_msgs.sum()),
        }

    def stall_of(self, idx: int, reason: str) -> StallDiagnostic:
        return stall_diagnostic(self.config, self.take_row(idx), reason)

    def compile_counts(self) -> dict:
        """For each program, the shapes it has taken: the chunk graph's
        captures on the card (one shape on the CPU), the row shapes
        admitted, and the gathers' and reads' shapes."""
        # the data-sharded chunk loop is not captured: one program shape
        out = {"runner": self._bound.graphs if self.device.type == "cuda"
               and not self._sharded else 1}
        out.update({k: len(v) for k, v in self._signatures.items()})
        return out
