"""The always-on serving loop on one GPU: the port's own copy of
``hpa2_tpu/serving/loop.py`` — ``TracePool`` (l.52-181),
``ServingStats`` and ``_percentile`` (l.184-240), ``_guard_compiles``
(l.243), ``ServingSession`` (l.251-456), ``BatchServingSession``
(l.459-717), ``build_serving`` and ``serve`` (l.720-826) — for the
``pallas`` backend, which here builds a
:class:`~hpa2_tpu_torch.ops.session.CudaLaneSession`, and the ``jax``
backend, the general engine's
:class:`~hpa2_tpu_torch.ops.engine.BatchLaneSession`.

Serving keeps the same resident lanes alive and grows the schedule as
jobs arrive: admissions ride the segment-barrier transform, so the
kernels never see a new shape and nothing is rebuilt after the first
interval (pinned by :meth:`ServingStats.compile_counts`).  Per interval
``k`` the host

1. polls the job source and packs arrivals into the
   :class:`TracePool` (host staging),
2. assembles interval ``k``'s trace windows and stages them to the
   device (host staging),
3. launches ``advance``, which returns at once,
4. plans the barrier and enqueues the harvests, then the barrier,
5. only *then* waits for interval ``k-1``'s status and decodes
   ``k-1``'s harvested dumps.

So while the card runs interval ``k``, the host is already parsing and
staging interval ``k+1``'s admission wave; the session's readbacks wait
only for the interval they belong to.  ``overlap=False`` waits right
after each launch: the serial baseline that shows how much staging
time the pipeline hides.

:class:`BatchServingSession` drives the ``jax`` backend, the only one
with the fault layer, the protocol variants and the topologies.  Row
completion there is device quiescence, so the loop reads once a chunk
(``BatchLaneSession.quiescent_rows``); with ``overlap=True`` the host
builds arriving jobs' rows while the chunk runs and scatters them in at
the chunk boundary.  The window emulation (``jax_window``) lets a job
migrated from the fast path keep byte-identical dumps: ``_harvest``
extends a row at a window barrier instead of retiring it, and resets
its watchdog age.

``pallas-sharded`` serves on a data mesh
(``parallel/sharding.py:DataShardedLaneSession``: one group of lanes a
card, never crossing); ``pallas-node-sharded`` on a ``(data, node)``
mesh of ranks (``parallel/sharding.py:NodeShardedLaneSession``: each
lane's nodes split over ranks that live as long as the session, which
:func:`serve` closes at the end).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.ops.layout import StallError, _pack_traces
from hpa2_tpu_torch.ops.schedule import (
    LaneScheduler, OccupancyStats, policy_order, segments_needed)
from hpa2_tpu_torch.serving.ingest import JobSource
from hpa2_tpu_torch.serving.jobs import Job, JobResult


class TracePool:
    """Packed trace words for every admitted-but-unfinished system, in
    one growing ``[N, columns]`` plane so per-interval window assembly
    is a single vectorized gather (no per-lane Python at 32k lanes).

    Each system ``s`` owns ``nseg[s] * window`` contiguous columns at
    ``off[s]`` (its packed trace zero-padded to whole windows).  Freed
    blocks accumulate as waste; when waste exceeds the live half the
    pool compacts live blocks down (system ids are stable — only
    offsets move).
    """

    def __init__(self, config: SystemConfig, window: int,
                 capacity: int = 4096):
        self._pack = _pack_traces
        self.config = config
        self.window = int(window)
        n = config.num_procs
        self._words = np.zeros((n, max(self.window, capacity)), np.int32)
        self._off = np.zeros(64, np.int64)
        self._plen = np.zeros((n, 64), np.int32)
        self._nseg = np.zeros(64, np.int64)
        self.count = 0          # systems ever added (== scheduler's b)
        self._used = 0          # columns handed out (tail pointer)
        self._waste = 0         # columns owned by freed systems
        self._freed: set = set()

    def _grow_meta(self) -> None:
        if self.count < len(self._off):
            return
        cap = 2 * len(self._off)
        self._off = np.resize(self._off, cap)
        self._nseg = np.resize(self._nseg, cap)
        plen = np.zeros((self._plen.shape[0], cap), np.int32)
        plen[:, : self._plen.shape[1]] = self._plen
        self._plen = plen

    def _reserve(self, cols: int) -> None:
        need = self._used + cols
        if need <= self._words.shape[1]:
            return
        cap = self._words.shape[1]
        while cap < need:
            cap *= 2
        words = np.zeros((self._words.shape[0], cap), np.int32)
        words[:, : self._used] = self._words[:, : self._used]
        self._words = words

    def add(self, job: Job) -> int:
        """Pack one arriving job; returns its system id (the next
        scheduler id, in arrival order)."""
        w = self.window
        ln = np.asarray(job.tr_len, np.int32)
        nseg = int(segments_needed(ln[:, None], w)[0])
        cols = nseg * w
        self._grow_meta()
        self._reserve(cols)
        # the packer keeps the input array width; columns past
        # nseg * window are guaranteed zero (beyond every tr_len), so
        # truncate to this system's allocation
        packed = self._pack(
            self.config,
            np.asarray(job.tr_op)[None],
            np.asarray(job.tr_addr)[None],
            np.asarray(job.tr_val)[None],
            ln[None],
        )[:, :cols, 0]
        s = self.count
        off = self._used
        self._words[:, off:off + packed.shape[1]] = packed
        self._words[:, off + packed.shape[1]:off + cols] = 0
        self._off[s] = off
        self._plen[:, s] = ln
        self._nseg[s] = nseg
        self.count += 1
        self._used += cols
        return s

    def nseg_of(self, s: int) -> int:
        return int(self._nseg[s])

    def free(self, s: int) -> None:
        """Release a retired system's columns (lazily — reclaimed by
        the next compaction)."""
        if s in self._freed:
            return
        self._freed.add(s)
        self._waste += int(self._nseg[s]) * self.window
        if self._waste > max(4 * self.window,
                             (self._used - self._waste)):
            self._compact()

    def _compact(self) -> None:
        live = [s for s in range(self.count) if s not in self._freed
                and self._nseg[s] > 0]
        live.sort(key=lambda s: int(self._off[s]))
        dst = 0
        for s in live:
            cols = int(self._nseg[s]) * self.window
            src = int(self._off[s])
            if src != dst:
                self._words[:, dst:dst + cols] = \
                    self._words[:, src:src + cols]
                self._off[s] = dst
            dst += cols
        for s in self._freed:
            self._nseg[s] = 0
        self._used = dst
        self._waste = 0

    def windows(self, lanes: np.ndarray, lane_sys: np.ndarray,
                lane_seg: np.ndarray, resident: int):
        """Assemble one interval's ``[N, W, R]`` trace plane and
        ``[N, R]`` window lengths for the live lanes — the vectorized
        analog of the one-shot engine's per-interval gather."""
        n, w = self.config.num_procs, self.window
        tr_int = np.zeros((n, w, resident), np.int32)
        tl_int = np.zeros((n, resident), np.int32)
        if len(lanes):
            sys_ = lane_sys[lanes]
            base = lane_seg[lanes] * w
            cols = (self._off[sys_] + base)[None, :] \
                + np.arange(w, dtype=np.int64)[:, None]
            tr_int[:, :, lanes] = self._words[:, cols]
            tl_int[:, lanes] = np.clip(
                self._plen[:, sys_] - base[None, :], 0, w
            )
        return tr_int, tl_int


def _percentile(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


@dataclasses.dataclass
class ServingStats:
    """End-of-feed serving report: job latency distribution, sustained
    throughput, the wall-clock phase split, and the occupancy counters
    (one schema with the batch scheduler — ``occupancy`` embeds
    :meth:`~hpa2_tpu_torch.ops.schedule.OccupancyStats.as_dict`)."""

    backend: str
    policy: str
    resident: int
    overlap: bool
    jobs_submitted: int = 0
    jobs_completed: int = 0
    instructions: int = 0
    wall_s: float = 0.0
    host_staging_s: float = 0.0
    device_wait_s: float = 0.0
    readback_s: float = 0.0
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    occupancy: Dict = dataclasses.field(default_factory=dict)
    compile_counts: Dict[str, int] = dataclasses.field(
        default_factory=dict)

    @property
    def ops_per_s(self) -> float:
        return self.instructions / self.wall_s if self.wall_s else 0.0

    def as_dict(self) -> dict:
        ls = self.latencies_s
        return {
            "backend": self.backend,
            "policy": self.policy,
            "resident": self.resident,
            "overlap": self.overlap,
            "jobs_submitted": self.jobs_submitted,
            "jobs_completed": self.jobs_completed,
            "instructions": self.instructions,
            "wall_s": round(self.wall_s, 6),
            "sustained_ops_per_s": round(self.ops_per_s, 1),
            "phases": {
                "host_staging_s": round(self.host_staging_s, 6),
                "device_wait_s": round(self.device_wait_s, 6),
                "readback_s": round(self.readback_s, 6),
            },
            "latency_s": {
                "p50": round(_percentile(ls, 50), 6),
                "p99": round(_percentile(ls, 99), 6),
                "mean": round(float(np.mean(ls)) if ls else 0.0, 6),
                "max": round(max(ls, default=0.0), 6),
            },
            "occupancy": self.occupancy,
            "compile_counts": self.compile_counts,
        }


def _guard_compiles(counts: Dict[str, int], enabled: bool) -> None:
    if enabled and any(c > 1 for c in counts.values()):
        raise RuntimeError(
            f"serving session recompiled after warmup: compile counts "
            f"{counts} (every program must stay at <= 1 entry)"
        )


class ServingSession:
    """Always-on serving over a resident-lane session
    (:class:`~hpa2_tpu_torch.ops.session.CudaLaneSession`).  See the
    module docstring for the pipeline; ``run()`` drives the source to exhaustion and returns
    (:class:`JobResult` list, :class:`ServingStats`).  ``emit`` streams
    each result the moment its lane's dumps decode."""

    def __init__(
        self,
        session,
        source: JobSource,
        *,
        policy: str = "fcfs",
        groups: int = 1,
        threshold: float = 0.5,
        overlap: bool = True,
        decode_dumps: bool = True,
        emit: Optional[Callable[[JobResult], None]] = None,
        compile_guard: bool = True,
        backend: str = "pallas",
        tenant_weights: Optional[Dict[str, float]] = None,
        interval_hook: Optional[Callable[[int, "ServingSession"],
                                         None]] = None,
    ):
        self.session = session
        self.source = source
        self.interval_hook = interval_hook
        # tenant names -> dense integer ids, default tenant "" first;
        # the id-keyed weight dict is handed to the scheduler BY
        # REFERENCE so names first seen later still order correctly
        self._tenant_ids: Dict[str, int] = {}
        self._tenant_weights_named = dict(tenant_weights or {})
        self._tenant_weights_by_id: Dict[int, float] = {}
        self._tenant_id("")
        for name in self._tenant_weights_named:
            self._tenant_id(name)
        self.sched = LaneScheduler.serving(
            session.r, block=session.block, groups=groups,
            threshold=threshold, policy=policy,
            tenant_weights=self._tenant_weights_by_id,
        )
        self.pool = TracePool(session.config, session.window)
        self.overlap = overlap
        self.decode_dumps = decode_dumps
        self.emit = emit
        self.compile_guard = compile_guard
        self._jobs: List[Job] = []
        self._submitted: List[float] = []
        self.stats = ServingStats(
            backend=backend, policy=policy, resident=session.r,
            overlap=overlap,
        )

    # -- pipeline pieces ----------------------------------------------

    def _tenant_id(self, name: str) -> int:
        tid = self._tenant_ids.get(name)
        if tid is None:
            tid = len(self._tenant_ids)
            self._tenant_ids[name] = tid
            w = self._tenant_weights_named.get(name)
            if w is not None:
                self._tenant_weights_by_id[tid] = float(w)
        return tid

    def _ingest(self) -> None:
        t0 = time.perf_counter()
        arrived = self.source.poll()
        if arrived:
            now = time.perf_counter()
            nseg, dls, tns = [], [], []
            for job in arrived:
                s = self.pool.add(job)
                assert s == len(self._jobs)
                self._jobs.append(job)
                self._submitted.append(now)
                nseg.append(self.pool.nseg_of(s))
                dls.append(int(job.deadline))
                tns.append(self._tenant_id(job.tenant))
            self.sched.extend(
                np.asarray(nseg, np.int64),
                deadline=np.asarray(dls, np.int64),
                tenant=np.asarray(tns, np.int64),
            )
            self.stats.jobs_submitted += len(arrived)
        self.stats.host_staging_s += time.perf_counter() - t0

    def _apply_barrier(self, plan) -> List[Tuple[int, object]]:
        """Dispatch harvest gathers then the barrier transform for one
        plan; returns the pending (system, device cols) list."""
        sess, st = self.session, self.sched.stats
        pending = []
        for lane, s in plan.finished:
            pending.append((s, sess.harvest(lane)))
        if not plan.trivial:
            perm = (
                plan.perm if plan.perm is not None
                else np.arange(self.sched.r, dtype=np.int64)
            )
            reset = np.zeros(self.sched.r, bool)
            for lane, _ in plan.admitted:
                reset[lane] = True
            sess.barrier(perm, reset)
        for _, s in plan.admitted:
            self._wait_of[s] = (
                st.intervals - self.sched._enq_at[s]
            )
        return pending

    def _drain(self, pending) -> None:
        """Decode harvested lane columns into streamed results."""
        if not pending:
            return
        t0 = time.perf_counter()
        sess = self.session
        for s, cols in pending:
            job = self._jobs[s]
            dumps = sess.dumps_of(cols) if self.decode_dumps else []
            counters = sess.counters_of(cols)
            res = JobResult(
                job_id=job.job_id,
                dumps=dumps,
                counters=counters,
                submitted_s=self._submitted[s],
                retired_s=time.perf_counter(),
                wait_intervals=self._wait_of.get(s, 0),
                tenant=job.tenant,
            )
            self.pool.free(s)
            self.results.append(res)
            self.stats.jobs_completed += 1
            self.stats.instructions += counters.get("instructions", 0)
            self.stats.latencies_s.append(res.latency_s)
            if self.emit:
                self.emit(res)
        self.stats.readback_s += time.perf_counter() - t0

    def _sync(self, status) -> None:
        if status is None:
            return
        t0 = time.perf_counter()
        self.session.check(status)
        self.stats.device_wait_s += time.perf_counter() - t0

    # -- the loop -----------------------------------------------------

    def run(self) -> Tuple[List[JobResult], ServingStats]:
        sess, sched, st = self.session, self.sched, self.stats
        self.results: List[JobResult] = []
        self._wait_of: Dict[int, int] = {}
        prev_status = None          # interval k-1's un-synced status
        prev_pending: list = []     # interval k-1's un-decoded harvests
        wall0 = time.perf_counter()
        while True:
            self._ingest()
            if not sched.live().any():
                # nothing running: admissions can't ride an interval
                # barrier, so flush them between intervals
                plan = sched.flush_admissions()
                if not plan.trivial:
                    t0 = time.perf_counter()
                    self._apply_barrier(plan)
                    st.host_staging_s += time.perf_counter() - t0
                    continue
                self._sync(prev_status)
                prev_status = None
                self._drain(prev_pending)
                prev_pending = []
                if self.source.exhausted and sched.done():
                    break
                self.source.wait(0.002)
                continue
            lanes = np.nonzero(sched.begin_interval())[0]
            t0 = time.perf_counter()
            tr_int, tl_int = self.pool.windows(
                lanes, sched.lane_sys, sched.lane_seg, sched.r
            )
            tr, tl = sess.stage(tr_int, tl_int)
            st.host_staging_s += time.perf_counter() - t0
            status = sess.advance(tr, tl)
            plan = sched.end_interval()
            pending = self._apply_barrier(plan)
            if self.overlap:
                # sync one interval behind: the device is already off
                # running interval k while we block on k-1's status
                # and decode k-1's harvests
                self._sync(prev_status)
                self._drain(prev_pending)
                prev_status, prev_pending = status, pending
            else:
                self._sync(status)
                self._drain(pending)
            if self.interval_hook is not None:
                # interval k's barrier has been applied: the tap a
                # recovery supervisor checkpoints at
                self.interval_hook(sched.stats.intervals, self)
        self._sync(prev_status)
        self._drain(prev_pending)
        st.wall_s = time.perf_counter() - wall0
        sched.stats.shed_jobs = int(
            getattr(self.source, "shed_jobs", 0) or 0)
        st.occupancy = sched.stats.set_mode(fused=False).as_dict()
        st.compile_counts = sess.compile_counts()
        _guard_compiles(st.compile_counts, self.compile_guard)
        return self.results, st


class BatchServingSession:
    """Always-on serving over :class:`~hpa2_tpu_torch.ops.engine.\
BatchLaneSession` rows (``hpa2_tpu/serving/loop.py:BatchServingSession``,
    l.459).  Row completion is device quiescence, so the loop reads once
    a chunk; with ``overlap=True`` the host builds arriving jobs' rows
    *while* the chunk is in flight and scatters them in at the chunk
    boundary.  The serving backend with the fault-injection layer."""

    def __init__(
        self,
        session,
        source: JobSource,
        *,
        policy: str = "fcfs",
        overlap: bool = True,
        decode_dumps: bool = True,
        emit: Optional[Callable[[JobResult], None]] = None,
        compile_guard: bool = True,
        backend: str = "jax",
        tenant_weights: Optional[Dict[str, float]] = None,
        interval_hook: Optional[Callable[[int, "BatchServingSession"],
                                         None]] = None,
    ):
        self.session = session
        self.source = source
        self.interval_hook = interval_hook
        self.policy = policy
        self.overlap = overlap
        self.decode_dumps = decode_dumps
        self.emit = emit
        self.compile_guard = compile_guard
        self._jobs: List[Job] = []
        self._submitted: List[float] = []
        self._tenant_ids: Dict[str, int] = {"": 0}
        self._tenant_weights_named = dict(tenant_weights or {})
        self._tenant_weights_by_id: Dict[int, float] = {}
        for name in self._tenant_weights_named:
            self._tid(name)
        self._tenant_of: Dict[int, int] = {}   # system -> tenant id
        self._dl_abs: Dict[int, int] = {}      # system -> abs deadline
        self.stats = ServingStats(
            backend=backend, policy=policy, resident=session.r,
            overlap=overlap,
        )

    def _tid(self, name: str) -> int:
        tid = self._tenant_ids.get(name)
        if tid is None:
            tid = len(self._tenant_ids)
            self._tenant_ids[name] = tid
            w = self._tenant_weights_named.get(name)
            if w is not None:
                self._tenant_weights_by_id[tid] = float(w)
        return tid

    def _poll(self, queue: deque, enq_at: Dict[int, int],
              chunk: int) -> None:
        t0 = time.perf_counter()
        arrived = self.source.poll()
        if arrived:
            now = time.perf_counter()
            for job in arrived:
                s = len(self._jobs)
                self._jobs.append(job)
                self._submitted.append(now)
                queue.append(s)
                enq_at[s] = chunk
                self._tenant_of[s] = self._tid(job.tenant)
                self._dl_abs[s] = (
                    chunk + job.deadline if job.deadline >= 0 else -1
                )
            if self.policy != "fcfs":
                # fair-drr charges one row per job (keys of one):
                # row-granularity serving has no segment cost
                if self.policy == "fair-drr":
                    keys = np.ones(len(queue), dtype=np.int64)
                else:
                    keys = np.asarray(
                        [self._jobs[s].max_len for s in queue]
                    )
                order = policy_order(
                    keys, self.policy,
                    deadline=np.asarray(
                        [self._dl_abs[s] for s in queue], np.int64
                    ),
                    tenant=np.asarray(
                        [self._tenant_of[s] for s in queue], np.int64
                    ),
                    weights=self._tenant_weights_by_id,
                )
                items = list(queue)
                queue.clear()
                queue.extend(items[int(i)] for i in order)
            self.stats.jobs_submitted += len(arrived)
        self.stats.host_staging_s += time.perf_counter() - t0

    def _stage(self, queue: deque, free: List[int]) -> list:
        """Build rows for as many queued jobs as there are free rows
        (the ingest cost hidden behind the in-flight chunk)."""
        t0 = time.perf_counter()
        staged = []
        for idx in free:
            if not queue:
                break
            s = queue.popleft()
            staged.append(
                (idx, s, self.session.fresh_row(
                    self._jobs[s].batch_traces()))
            )
        self.stats.host_staging_s += time.perf_counter() - t0
        return staged

    def _harvest(self, row_sys: np.ndarray, quiet: np.ndarray,
                 wait_of: Dict[int, int], occ: OccupancyStats,
                 chunk: int) -> None:
        sess = self.session
        done_rows = [
            int(i) for i in np.nonzero((row_sys >= 0) & quiet)[0]
        ]
        if getattr(sess, "window", None) is not None:
            # window-schedule emulation: a quiescent row at a window
            # barrier extends instead of retiring (and made progress,
            # so its stall-watchdog age resets)
            barrier = [i for i in done_rows if not sess.window_done(i)]
            for i in barrier:
                sess.window_extend(i)
                self._row_age[i] = 0
            done_rows = [i for i in done_rows if i not in barrier]
        if not done_rows:
            return
        t0 = time.perf_counter()
        # the finished rows in one gather and one copy to the host
        rows = sess.take_rows(done_rows)
        for idx, row in zip(done_rows, rows):
            s = int(row_sys[idx])
            job = self._jobs[s]
            dl = self._dl_abs.get(s, -1)
            if dl >= 0:
                if chunk <= dl:
                    occ.deadline_met += 1
                else:
                    occ.deadline_missed += 1
            counters = sess.counters_of(row)
            res = JobResult(
                job_id=job.job_id,
                dumps=sess.dumps_of(row) if self.decode_dumps else [],
                counters=counters,
                submitted_s=self._submitted[s],
                retired_s=time.perf_counter(),
                wait_intervals=wait_of.get(s, 0),
                tenant=job.tenant,
            )
            self.results.append(res)
            self.stats.jobs_completed += 1
            self.stats.instructions += counters.get("instructions", 0)
            self.stats.latencies_s.append(res.latency_s)
            if self.emit:
                self.emit(res)
            sess.retire(idx)
            row_sys[idx] = -1
        self.stats.readback_s += time.perf_counter() - t0

    def _account_chunk(self, occ: OccupancyStats, row_sys: np.ndarray,
                       row_age: np.ndarray, queue: deque) -> None:
        occ.intervals += 1
        live = int((row_sys >= 0).sum())
        occ.live_lane_intervals += live
        occ.lane_intervals += self.session.r
        # row granularity = block 1; serving has no lockstep baseline,
        # so both segment counters accrue the live-row work
        occ.block_segments += live
        occ.lockstep_block_segments += live
        if self._tenant_weights_by_id or len(self._tenant_ids) > 1:
            for s in row_sys[row_sys >= 0]:
                t = self._tenant_of.get(int(s), 0)
                occ.tenant_live[t] = occ.tenant_live.get(t, 0) + 1
        depth = len(queue)
        occ.queue_depth_sum += depth
        occ.queue_depth_peak = max(occ.queue_depth_peak, depth)
        row_age[row_sys >= 0] += 1
        max_chunks = -(-self.session.max_cycles
                       // self.session.interval)
        if (row_age > max_chunks).any():
            bad = int(np.argmax(row_age))
            raise StallError(
                f"job {self._jobs[int(row_sys[bad])].job_id!r} made "
                f"no quiescence within ~{self.session.max_cycles} "
                f"cycles: "
                f"{self.session.stall_of(bad, 'serving chunk limit')}"
            )

    def _chunk(self, occ, row_sys, row_age, queue, wait_of,
               chunk: int) -> None:
        """Read the chunk in flight, account it, harvest, and call the
        interval hook."""
        t0 = time.perf_counter()
        quiet = self.session.quiescent_rows()
        self.stats.device_wait_s += time.perf_counter() - t0
        self._account_chunk(occ, row_sys, row_age, queue)
        self._harvest(row_sys, quiet, wait_of, occ, chunk)
        if self.interval_hook is not None:
            # the supervisor's tap: checkpoint/failure-injection point
            self.interval_hook(chunk, self)

    def run(self) -> Tuple[List[JobResult], ServingStats]:
        sess = self.session
        st = self.stats
        self.results: List[JobResult] = []
        occ = OccupancyStats(lockstep_block_segments=0)
        row_sys = np.full(sess.r, -1, np.int64)
        row_age = np.zeros(sess.r, np.int64)  # chunks since admission
        queue: deque = deque()
        enq_at: Dict[int, int] = {}
        wait_of: Dict[int, int] = {}
        # live handles for the recovery supervisor: the interval hook
        # reads these to checkpoint mid-run state at chunk barriers
        self.row_sys = row_sys
        self.wait_of = wait_of
        self.occ = occ
        self._row_age = row_age
        chunk = 0
        wall0 = time.perf_counter()
        while True:
            self._poll(queue, enq_at, chunk)
            free = [int(i) for i in np.nonzero(row_sys < 0)[0]]
            if not (row_sys >= 0).any() and not queue:
                if self.source.exhausted:
                    break
                self.source.wait(0.002)
                continue
            if self.overlap and (row_sys >= 0).any():
                # chunk k in flight while the host builds arrivals' rows
                sess.advance()
                staged = self._stage(queue, free)
                chunk += 1
                self._chunk(occ, row_sys, row_age, queue, wait_of, chunk)
            else:
                staged = self._stage(queue, free)
            for idx, s, row in staged:
                t0 = time.perf_counter()
                sess.admit(idx, row)
                st.host_staging_s += time.perf_counter() - t0
                row_sys[idx] = s
                row_age[idx] = 0
                occ.admissions += 1
                wait = chunk - enq_at[s]
                wait_of[s] = wait
                occ.wait_intervals_total += wait
                occ.wait_intervals_max = max(
                    occ.wait_intervals_max, wait
                )
            if not self.overlap and (row_sys >= 0).any():
                sess.advance()
                chunk += 1
                self._chunk(occ, row_sys, row_age, queue, wait_of, chunk)
        st.wall_s = time.perf_counter() - wall0
        occ.shed_jobs = int(getattr(self.source, "shed_jobs", 0) or 0)
        st.occupancy = occ.as_dict()
        st.compile_counts = sess.compile_counts()
        _guard_compiles(st.compile_counts, self.compile_guard)
        return self.results, st


def build_serving(
    config: SystemConfig,
    source: JobSource,
    *,
    backend: str = "pallas",
    resident: int = 8,
    window: int = 16,
    block: Optional[int] = None,
    policy: str = "fcfs",
    data_shards: int = 1,
    node_shards: int = 1,
    overlap: bool = True,
    interval: int = 256,
    max_trace_len: int = 1024,
    threshold: float = 0.5,
    max_cycles: int = 1_000_000,
    decode_dumps: bool = True,
    emit: Optional[Callable[[JobResult], None]] = None,
    compile_guard: bool = True,
    interpret: Optional[bool] = None,
    tenant_weights: Optional[Dict[str, float]] = None,
    interval_hook: Optional[Callable] = None,
    jax_window: Optional[int] = None,
    device="cuda",
):
    """Build the resident session and the serving loop for
    ``backend`` without running it (the recovery supervisor keeps the
    loop and its interval hook); :func:`serve` is
    ``build_serving(...).run()``.  The keywords are the JAX package's,
    plus ``device``: the session runs on the card unless ``device="cpu"``
    (the fast path's plain versions, the general engine's CPU loop), and
    raises when asked for a card that is not there.  ``interpret`` has
    no counterpart in the port (its CPU path is ``device="cpu"``).
    ``pallas`` is the fast path (``window``, ``block``); ``jax`` the
    general engine (``interval``, ``max_trace_len``, and ``jax_window``,
    which opts it into the fast path's window schedule so a migrated
    job's dumps stay byte-identical).  ``pallas-node-sharded`` starts
    ``node_shards x data_shards`` ranks that the caller ends with
    ``session.session.close()``."""
    if interpret:
        raise ValueError(
            "the port has no Pallas interpreter; run the plain versions "
            "with device='cpu'")
    if backend == "pallas":
        from hpa2_tpu_torch.ops.session import CudaLaneSession

        sess = CudaLaneSession(
            config, resident, window, block=block or 1024,
            max_cycles=max_cycles, device=device,
        )
        return ServingSession(
            sess, source, policy=policy, threshold=threshold,
            overlap=overlap, decode_dumps=decode_dumps, emit=emit,
            compile_guard=compile_guard, backend=backend,
            tenant_weights=tenant_weights, interval_hook=interval_hook,
        )
    if backend == "pallas-sharded":
        from hpa2_tpu_torch.parallel.sharding import DataShardedLaneSession

        sess = DataShardedLaneSession(
            config, resident, window, data_shards=data_shards,
            block=block or 1024, max_cycles=max_cycles, device=device,
        )
        return ServingSession(
            sess, source, policy=policy, groups=sess.data_shards,
            threshold=threshold, overlap=overlap,
            decode_dumps=decode_dumps, emit=emit,
            compile_guard=compile_guard, backend=backend,
            tenant_weights=tenant_weights, interval_hook=interval_hook,
        )
    if backend == "pallas-node-sharded":
        from hpa2_tpu_torch.parallel.sharding import NodeShardedLaneSession

        sess = NodeShardedLaneSession(
            config, resident, window, node_shards=node_shards,
            data_shards=data_shards, block=block or 1024,
            max_cycles=max_cycles, device=device,
        )
        return ServingSession(
            sess, source, policy=policy, groups=sess.data_shards,
            threshold=threshold, overlap=overlap,
            decode_dumps=decode_dumps, emit=emit,
            compile_guard=compile_guard, backend=backend,
            tenant_weights=tenant_weights, interval_hook=interval_hook,
        )
    if backend == "jax":
        from hpa2_tpu_torch.ops.engine import BatchLaneSession

        sess = BatchLaneSession(
            config, resident, max_trace_len, interval=interval,
            max_cycles=max_cycles, data_shards=data_shards,
            window=jax_window, device=device,
        )
        return BatchServingSession(
            sess, source, policy=policy, overlap=overlap,
            decode_dumps=decode_dumps, emit=emit,
            compile_guard=compile_guard, backend=backend,
            tenant_weights=tenant_weights, interval_hook=interval_hook,
        )
    raise ValueError(
        f"unknown serving backend {backend!r}; expected "
        "pallas | pallas-sharded | pallas-node-sharded | jax"
    )


def serve(config: SystemConfig, source: JobSource,
          **kwargs) -> Tuple[List[JobResult], ServingStats]:
    """Build the resident session for ``backend`` and drive the source
    to exhaustion: ``pallas`` (the fast path), ``pallas-sharded``,
    ``pallas-node-sharded`` or ``jax`` (the general engine).  Accepts
    every :func:`build_serving` keyword; a session with ranks is closed
    at the end."""
    drv = build_serving(config, source, **kwargs)
    try:
        return drv.run()
    finally:
        close = getattr(drv.session, "close", None)
        if close is not None:
            close()
