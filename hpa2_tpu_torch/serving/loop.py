"""The always-on serving loop on the single-GPU fast backend: the
port's own copy of ``hpa2_tpu/serving/loop.py`` — ``TracePool``
(l.52-181), ``ServingStats`` and ``_percentile`` (l.184-240),
``_guard_compiles`` (l.243), ``ServingSession`` (l.251-456),
``build_serving`` and ``serve`` (l.720-826) — for the ``pallas``
backend, which here builds a
:class:`~hpa2_tpu_torch.ops.session.CudaLaneSession`.

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

The other backends of the JAX package are not here yet:
``pallas-sharded`` and ``pallas-node-sharded`` come with the multi-GPU
slice and ``jax`` (``BatchServingSession``) with the general engine
family; :func:`build_serving` refuses them.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.ops.layout import _pack_traces
from hpa2_tpu_torch.ops.schedule import LaneScheduler, segments_needed
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


#: the serving backends of the JAX package that the port does not run
#: yet, and the ROADMAP item (queue 1) that brings each
_NOT_PORTED = {
    "pallas-sharded": "queue 1 item 4 (multi-GPU)",
    "pallas-node-sharded": "queue 1 item 4 (multi-GPU)",
    "jax": "queue 1 item 2b (the general engine's serving session)",
}


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
) -> ServingSession:
    """Build the resident session and the serving loop for
    ``backend`` without running it; :func:`serve` is
    ``build_serving(...).run()``.  The keywords are the JAX package's,
    plus ``device``: the session runs on the card unless ``device="cpu"``
    (the kernels' plain versions), and raises when asked for a card
    that is not there.  ``interpret`` has no counterpart in the port
    (its CPU path is ``device="cpu"``); ``data_shards``,
    ``node_shards``, ``interval``, ``max_trace_len`` and ``jax_window``
    belong to backends the port does not run yet."""
    if interpret:
        raise ValueError(
            "the port has no Pallas interpreter; run the plain versions "
            "with device='cpu'")
    if backend in _NOT_PORTED:
        raise ValueError(
            f"serving backend {backend!r} is not ported yet (ROADMAP "
            f"{_NOT_PORTED[backend]}); the port serves on 'pallas', the "
            "single-GPU fast backend")
    if backend != "pallas":
        raise ValueError(
            f"unknown serving backend {backend!r}; expected "
            "pallas | pallas-sharded | pallas-node-sharded | jax"
        )
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


def serve(config: SystemConfig, source: JobSource,
          **kwargs) -> Tuple[List[JobResult], ServingStats]:
    """Build the resident session for ``backend`` and drive the source
    to exhaustion.  Accepts every :func:`build_serving` keyword."""
    return build_serving(config, source, **kwargs).run()
