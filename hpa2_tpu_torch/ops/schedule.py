"""Occupancy scheduling for the ensemble engines: the port's own copy of
``hpa2_tpu/ops/schedule.py``, numpy only, with the same names and the
same replay, so a plan or an ``OccupancyStats`` built here equals the
JAX package's field for field.

Lockstep ensembles pay the per-block cycle cost until the *slowest*
lane in the block drains: on heterogeneous workloads (zipf trace
lengths, divergent quiescence times) most lanes are dead for most of
the run while wall-clock is unchanged.  The run programs already force
every lane to quiescence at trace-window segment boundaries, which
makes the segment barrier a legal reschedule point: any lane may carry
any system's state into the next window, because systems are
independent along the lane axis and the pc restarts from the window
base.

This module is the *policy*: a deterministic host-side lane scheduler
that, at each barrier,

1. **harvests** lanes whose system has run out of segments,
2. **backfills** freed lanes from a per-group admission queue of
   not-yet-resident systems (ensembles larger than the device-resident
   batch stream through continuously), and
3. **compacts** — once the queue is dry and a block's occupancy falls
   below ``Schedule.threshold`` — by stably packing live lanes into
   dense blocks so whole blocks go quiescent and skip.

The JAX package's static occupancy model replays the same policy with
no simulator attached, so its predicted counters and an engine's
measured ones agree exactly.

Groups exist for data sharding: each shard is one scheduling group
with its own queue, and lane moves never cross a group boundary.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class Schedule:
    """The ``schedule=`` knob shared by both ensemble backends.

    ``resident``: device-resident lanes (rows, for the XLA batch
    engine).  ``None`` keeps the whole ensemble resident; smaller
    values stream the ensemble through the device via the admission
    queue.  ``threshold``: compact a scheduling group once every block
    is backfilled and some live block's occupancy falls below this
    fraction (1.0 = compact whenever it frees a block).  ``interval``:
    cycles per barrier for the XLA batch engine (the Pallas engines
    barrier at trace-window boundaries instead).  ``fused``: drive the
    whole scheduled run as ONE device program from a precomputed
    :class:`SchedulePlan` (compaction/backfill applied on-device at
    the barriers); ``fused=False`` keeps the host-barrier loop,
    which relaunches one device program per interval.  ``policy``:
    admission order within each group's queue — ``"fcfs"`` admits in
    ensemble order, ``"longest-first"`` admits systems with the most
    remaining segments first, which packs stragglers early so the tail
    of the run is short traces draining together, ``"deadline-edf"``
    admits earliest-absolute-deadline first (deadline-less systems
    last, arrival order among ties), and ``"fair-drr"`` interleaves
    tenants by weighted deficit round robin (deficit in segments, so a
    heavy job charges its tenant proportionally).

    The multi-tenant metadata rides as optional hashable tuples so the
    knob stays usable as a cache key: ``deadlines[s]`` is system s's
    completion deadline in scheduling intervals (-1 = none),
    ``tenants[s]`` its integer tenant id, and ``tenant_weights[t]``
    tenant t's DRR weight (indexed by tenant id; omitted tenants weigh
    1.0).
    """

    resident: Optional[int] = None
    threshold: float = 0.5
    interval: int = 256
    fused: bool = True
    policy: str = "fcfs"
    deadlines: Optional[Tuple[int, ...]] = None
    tenants: Optional[Tuple[int, ...]] = None
    tenant_weights: Optional[Tuple[float, ...]] = None


#: Admission-queue orderings understood by :class:`LaneScheduler`.
POLICIES = ("fcfs", "longest-first", "deadline-edf", "fair-drr")

#: Per-tenant DRR weights: a dict keyed by tenant id, or a sequence
#: indexed by tenant id.  Missing tenants weigh 1.0.
TenantWeights = Union[Dict[int, float], Sequence[float], None]


def _total(x) -> int:
    """Sum of a counter: a numpy array, or a tensor on any device (summed
    where it lies, then read once; ``np.asarray`` cannot read a CUDA
    tensor)."""
    if hasattr(x, "detach"):
        return int(x.detach().long().sum())
    return int(np.sum(np.asarray(x)))


def _weight_of(weights: TenantWeights, tenant: int) -> float:
    if weights is None:
        return 1.0
    if isinstance(weights, dict):
        w = float(weights.get(tenant, 1.0))
    elif 0 <= tenant < len(weights):
        w = float(weights[tenant])
    else:
        w = 1.0
    if w <= 0:
        raise ValueError(
            f"tenant {tenant} has non-positive DRR weight {w}"
        )
    return w


def _drr_order(
    keys: np.ndarray, tenant: np.ndarray, weights: TenantWeights
) -> np.ndarray:
    """Deterministic weighted deficit-round-robin total order: tenants
    take turns in sorted-id order, each turn banking ``weight`` segments
    of deficit and releasing queued jobs (arrival order within a
    tenant) while the bank covers the head job's segment cost.  An
    emptied tenant forfeits its bank (classic DRR), so fairness is over
    *backlogged* tenants only."""
    cost = np.maximum(np.asarray(keys, dtype=np.float64), 1.0)
    queues: Dict[int, deque] = {}
    for i, t in enumerate(tenant):
        queues.setdefault(int(t), deque()).append(i)
    order = sorted(queues)
    deficit = {t: 0.0 for t in order}
    out: List[int] = []
    remaining = len(cost)
    while remaining:
        for t in order:
            q = queues[t]
            if not q:
                continue
            deficit[t] += _weight_of(weights, t)
            while q and deficit[t] >= cost[q[0]]:
                i = q.popleft()
                deficit[t] -= cost[i]
                out.append(i)
                remaining -= 1
            if not q:
                deficit[t] = 0.0
    return np.asarray(out, dtype=np.int64)


def policy_order(
    keys: np.ndarray,
    policy: str,
    *,
    deadline: Optional[np.ndarray] = None,
    tenant: Optional[np.ndarray] = None,
    weights: TenantWeights = None,
) -> np.ndarray:
    """Indices of ``keys`` in the admission order ``policy`` dictates.

    ``keys`` are per-system segment counts.  ``fcfs`` preserves the
    given order; ``longest-first`` sorts by descending key, stably, so
    equal-length systems keep their arrival order and the replay stays
    deterministic.  ``deadline-edf`` sorts by ascending ``deadline``
    (absolute interval index; -1 = no deadline, ordered last), stably.
    ``fair-drr`` runs the deterministic weighted deficit round robin
    over ``tenant`` ids with ``keys`` as the per-job segment cost.
    The metadata arrays are ignored by the policies that don't use
    them, so existing two-argument callers are unchanged.
    """
    keys = np.asarray(keys)
    ids = np.arange(len(keys), dtype=np.int64)
    if policy == "fcfs":
        return ids
    if policy == "longest-first":
        return ids[np.argsort(-keys, kind="stable")]
    if policy == "deadline-edf":
        if deadline is None:
            return ids
        dl = np.asarray(deadline, dtype=np.int64)
        eff = np.where(dl < 0, np.iinfo(np.int64).max, dl)
        return ids[np.argsort(eff, kind="stable")]
    if policy == "fair-drr":
        if tenant is None:
            tenant = np.zeros(len(keys), dtype=np.int64)
        return _drr_order(keys, np.asarray(tenant), weights)
    raise ValueError(f"unknown policy {policy!r}; expected one of {POLICIES}")


@dataclasses.dataclass
class OccupancyStats:
    """Counters from a scheduled run (or its static replay)."""

    intervals: int = 0
    #: blocks with >= 1 live lane, summed over intervals — the unit of
    #: device work the gate cannot skip
    block_segments: int = 0
    #: what unscheduled lockstep would execute for the same workload
    lockstep_block_segments: int = 0
    live_lane_intervals: int = 0
    lane_intervals: int = 0
    compactions: int = 0
    admissions: int = 0
    #: host round-trips the run pays for scheduling: one per interval
    #: on the host-barrier path, zero when the plan is fused into
    #: the device program
    host_barriers: int = 0
    #: separately launched device programs per run: ``intervals`` on
    #: the host-barrier path, exactly 1 when fused
    device_programs: int = 0
    #: admission-queue depth sampled at every begin_interval (peak and
    #: running sum for the mean) — for a batch run this is the not-yet-
    #: resident backlog; for a served run it is the live job queue
    queue_depth_peak: int = 0
    queue_depth_sum: int = 0
    #: lane-wait (admission latency) in intervals: how long admitted
    #: systems sat queued between enqueue and their backfill barrier
    wait_intervals_total: int = 0
    wait_intervals_max: int = 0
    #: event-driven elision counters, attached from the
    #: device state after a scheduled run — zero (hence absent from
    #: ``as_dict``) under ``Config.elide=False``, on lockstep
    #: backends, and in the static replay model, so the artifact
    #: schema is unchanged wherever elision never fired
    elided_cycles: int = 0
    multi_hit_retired: int = 0
    #: multi-tenant service counters — deadline outcomes at
    #: harvest (absolute-interval deadlines only; -1 jobs count in
    #: neither) and live-lane-intervals per tenant id.  Like the
    #: elision counters, absent from ``as_dict`` unless the run carried
    #: deadlines / nontrivial tenants, so legacy artifacts are byte-
    #: identical
    deadline_met: int = 0
    deadline_missed: int = 0
    tenant_live: Dict[int, int] = dataclasses.field(default_factory=dict)
    #: graceful-degradation counter: batch-class jobs the
    #: admission ledger shed under overload.  Absent from ``as_dict``
    #: when zero so every pre-shedding artifact is byte-identical.
    shed_jobs: int = 0

    @property
    def mean_live_fraction(self) -> float:
        if not self.lane_intervals:
            return 0.0
        return self.live_lane_intervals / self.lane_intervals

    @property
    def speedup(self) -> float:
        """Lockstep block-segments over scheduled block-segments."""
        if not self.block_segments:
            return 0.0
        return self.lockstep_block_segments / self.block_segments

    @property
    def queue_depth_mean(self) -> float:
        if not self.intervals:
            return 0.0
        return self.queue_depth_sum / self.intervals

    @property
    def wait_intervals_mean(self) -> float:
        if not self.admissions:
            return 0.0
        return self.wait_intervals_total / self.admissions

    def as_dict(self) -> dict:
        out = {
            "intervals": self.intervals,
            "block_segments": self.block_segments,
            "lockstep_block_segments": self.lockstep_block_segments,
            "mean_live_fraction": round(self.mean_live_fraction, 4),
            "speedup": round(self.speedup, 3),
            "compactions": self.compactions,
            "admissions": self.admissions,
            "host_barriers": self.host_barriers,
            "device_programs": self.device_programs,
            "queue_depth_peak": self.queue_depth_peak,
            "queue_depth_mean": round(self.queue_depth_mean, 3),
            "wait_intervals_mean": round(self.wait_intervals_mean, 3),
            "wait_intervals_max": self.wait_intervals_max,
        }
        if self.elided_cycles:
            out["elided_cycles"] = self.elided_cycles
        if self.multi_hit_retired:
            out["multi_hit_retired"] = self.multi_hit_retired
        if self.deadline_met or self.deadline_missed:
            total = self.deadline_met + self.deadline_missed
            out["deadline_met"] = self.deadline_met
            out["deadline_missed"] = self.deadline_missed
            out["deadline_hit_rate"] = round(self.deadline_met / total, 4)
        if self.shed_jobs:
            out["shed_jobs"] = self.shed_jobs
        if self.tenant_live:
            total = sum(self.tenant_live.values())
            out["tenant_share"] = {
                int(t): round(v / total, 4) if total else 0.0
                for t, v in sorted(self.tenant_live.items())
            }
        return out

    def attach_elision(self, state) -> "OccupancyStats":
        """Fold the device elision counters from a finished run's
        state into the scheduler stats (lane-summed, matching
        ``engine_stats``).  The counters may be tensors on the card:
        each is summed there and read as one number."""
        self.elided_cycles = _total(state.n_elided)
        self.multi_hit_retired = _total(state.n_multi_hit)
        return self

    def set_mode(self, fused: bool) -> "OccupancyStats":
        """Fill the execution-shape counters for a run mode: the fused
        path compiles the whole plan into ONE device program with zero
        host barriers; the host-barrier path launches (and syncs) once
        per interval."""
        self.host_barriers = 0 if fused else self.intervals
        self.device_programs = 1 if fused else self.intervals
        return self


@dataclasses.dataclass
class BarrierPlan:
    """What the engine must do to its carried state at one barrier.

    Apply in order: harvest ``finished`` lane columns (pre-permute
    indices), gather-permute lanes by ``perm`` (None = identity), then
    reset ``admitted`` lane columns to the init state (post-permute
    indices; a group never permutes and admits at the same barrier, so
    the two never interact).
    """

    finished: List[Tuple[int, int]]   # (lane, system)
    admitted: List[Tuple[int, int]]   # (lane, system)
    perm: Optional[np.ndarray]        # [R] gather indices or None

    @property
    def trivial(self) -> bool:
        return not self.admitted and self.perm is None


def lockstep_block_segments(nseg: np.ndarray, block: int) -> int:
    """Block-segments an *unscheduled* lockstep run executes: systems
    sit at their ensemble index, and every block runs until its slowest
    lane's last segment (blocks whose lanes have all finished skip at
    the gate for ~free)."""
    nseg = np.asarray(nseg)
    total = 0
    for lo in range(0, len(nseg), block):
        total += int(nseg[lo:lo + block].max(initial=0))
    return total


class LaneScheduler:
    """Deterministic lane->system scheduler, replayed identically by
    the engines (with the simulator in the middle) and by the static
    occupancy model (without one).

    ``nseg[s]`` is the number of trace-window segments system ``s``
    needs (>= 1).  ``resident`` lanes are split into ``groups`` equal
    contiguous lane ranges; systems are partitioned contiguously over
    groups and never migrate between them.

    ``policy`` orders each group's admission queue (see
    :data:`POLICIES`).  The default ``"fcfs"`` reproduces the original
    replay bit-for-bit.

    A scheduler built with :meth:`serving` starts with *no* systems
    and grows by :meth:`extend` as jobs arrive — the serving loop's
    rolling extension of the batch replay.  Lanes, groups, and blocks
    keep their fixed shapes; only the system table grows.
    """

    def __init__(
        self,
        nseg: np.ndarray,
        *,
        resident: Optional[int] = None,
        block: int = 1,
        groups: int = 1,
        threshold: float = 0.5,
        policy: str = "fcfs",
        deadline: Optional[np.ndarray] = None,
        tenant: Optional[np.ndarray] = None,
        tenant_weights: TenantWeights = None,
        _serving: bool = False,
    ):
        nseg = np.asarray(nseg, dtype=np.int64)
        if policy not in POLICIES:
            raise ValueError(
                f"unknown policy {policy!r}; expected one of {POLICIES}"
            )
        if nseg.ndim != 1 or (len(nseg) == 0 and not _serving):
            raise ValueError("nseg must be a non-empty 1-D array")
        if (nseg < 1).any():
            raise ValueError("every system needs >= 1 segment")
        b = len(nseg)
        r = b if resident is None else int(resident)
        if not _serving and not (0 < r <= b):
            raise ValueError(f"resident={r} outside 1..{b}")
        if (b % groups and not _serving) or r % groups:
            raise ValueError(
                f"batch {b} and resident {r} must divide into "
                f"{groups} groups"
            )
        if (r // groups) % block:
            raise ValueError(
                f"per-group lanes {r // groups} not divisible by "
                f"block {block}"
            )
        self.nseg = nseg
        self.b, self.r = b, r
        self.block, self.groups = block, groups
        self.threshold = float(threshold)
        self.policy = policy
        gl = r // groups
        self._gl = gl
        self._serving = _serving
        #: absolute deadline in intervals (-1 = none); at construction
        #: enqueue time is interval 0 so relative == absolute
        if deadline is None:
            self._deadline = np.full(b, -1, dtype=np.int64)
        else:
            self._deadline = np.asarray(deadline, dtype=np.int64).copy()
            if self._deadline.shape != (b,):
                raise ValueError(
                    f"deadline must have shape ({b},), got "
                    f"{self._deadline.shape}"
                )
        if tenant is None:
            self._tenant = np.zeros(b, dtype=np.int64)
        else:
            self._tenant = np.asarray(tenant, dtype=np.int64).copy()
            if self._tenant.shape != (b,):
                raise ValueError(
                    f"tenant must have shape ({b},), got "
                    f"{self._tenant.shape}"
                )
        #: kept by reference: the serving loop grows its weight table
        #: as tenants first appear, and order-time lookups must see it
        self._tenant_weights = tenant_weights
        self._track_tenants = bool(
            (self._tenant != 0).any() or tenant_weights
        )
        self.lane_sys = np.full(r, -1, dtype=np.int64)
        self.lane_seg = np.zeros(r, dtype=np.int64)
        self._queues: List[deque] = [deque() for _ in range(groups)]
        #: stats.intervals at the moment each system was enqueued, for
        #: the lane-wait (admission latency) counters
        self._enq_at: List[int] = [0] * b
        self.stats = OccupancyStats(
            lockstep_block_segments=lockstep_block_segments(nseg, block)
        )
        if not _serving:
            gs = b // groups  # systems per group
            for g in range(groups):
                sys0 = g * gs
                order = self._order_ids(
                    sys0 + np.arange(gs, dtype=np.int64)
                )
                fill = min(gl, gs)
                self.lane_sys[g * gl:g * gl + fill] = order[:fill]
                self._queues[g] = deque(int(s) for s in order[fill:])
        self._in_interval = False

    def _order_ids(self, ids: np.ndarray) -> np.ndarray:
        """System ids reordered by ``policy`` with their metadata."""
        ids = np.asarray(ids, dtype=np.int64)
        order = policy_order(
            self.nseg[ids], self.policy,
            deadline=self._deadline[ids],
            tenant=self._tenant[ids],
            weights=self._tenant_weights,
        )
        return ids[order]

    @classmethod
    def serving(
        cls,
        resident: int,
        *,
        block: int = 1,
        groups: int = 1,
        threshold: float = 0.5,
        policy: str = "fcfs",
        tenant_weights: TenantWeights = None,
    ) -> "LaneScheduler":
        """An initially-empty scheduler for the always-on serving loop:
        all admissions flow through :meth:`extend` + barrier plans."""
        return cls(
            np.zeros(0, dtype=np.int64), resident=resident, block=block,
            groups=groups, threshold=threshold, policy=policy,
            tenant_weights=tenant_weights, _serving=True,
        )

    def extend(
        self,
        nseg_new: np.ndarray,
        *,
        deadline: Optional[np.ndarray] = None,
        tenant: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Enqueue newly-arrived systems (serving mode): each joins the
        group with the shortest queue (ties to the lowest group), and
        each group's queue is re-ordered by ``policy``.  ``deadline``
        is *relative* — intervals from now — and is converted to the
        absolute interval index here.  Returns the new system ids, in
        arrival order."""
        if not self._serving:
            raise RuntimeError("extend() only valid on a serving scheduler")
        nseg_new = np.asarray(nseg_new, dtype=np.int64)
        if nseg_new.ndim != 1 or len(nseg_new) == 0:
            raise ValueError("nseg_new must be a non-empty 1-D array")
        if (nseg_new < 1).any():
            raise ValueError("every system needs >= 1 segment")
        n = len(nseg_new)
        sys0 = self.b
        new_ids = sys0 + np.arange(n, dtype=np.int64)
        self.nseg = np.concatenate([self.nseg, nseg_new])
        self.b = len(self.nseg)
        now = self.stats.intervals
        if deadline is None:
            dl_abs = np.full(n, -1, dtype=np.int64)
        else:
            dl = np.asarray(deadline, dtype=np.int64)
            if dl.shape != (n,):
                raise ValueError(
                    f"deadline must have shape ({n},), got {dl.shape}"
                )
            dl_abs = np.where(dl >= 0, now + dl, -1)
        self._deadline = np.concatenate([self._deadline, dl_abs])
        if tenant is None:
            t_new = np.zeros(n, dtype=np.int64)
        else:
            t_new = np.asarray(tenant, dtype=np.int64)
            if t_new.shape != (n,):
                raise ValueError(
                    f"tenant must have shape ({n},), got {t_new.shape}"
                )
        self._tenant = np.concatenate([self._tenant, t_new])
        if (t_new != 0).any():
            self._track_tenants = True
        self._enq_at.extend([now] * n)
        self.stats.lockstep_block_segments += lockstep_block_segments(
            nseg_new, self.block
        )
        touched = set()
        for s in new_ids:
            # live lanes count toward a group's load so arrivals spread
            # across shards instead of piling onto the first queue
            load = [
                len(self._queues[g])
                + int((self.lane_sys[g * self._gl:(g + 1) * self._gl]
                       >= 0).sum())
                for g in range(self.groups)
            ]
            g = int(np.argmin(load))
            self._queues[g].append(int(s))
            touched.add(g)
        if self.policy != "fcfs":
            for g in touched:
                order = self._order_ids(
                    np.asarray(self._queues[g], dtype=np.int64)
                )
                self._queues[g] = deque(int(s) for s in order)
        return new_ids

    # -- interval protocol -------------------------------------------

    def done(self) -> bool:
        return not (self.lane_sys >= 0).any() and not any(
            self._queues
        )

    def live(self) -> np.ndarray:
        return self.lane_sys >= 0

    def begin_interval(self) -> np.ndarray:
        """Account one interval's device work; returns the live mask
        (every live lane runs exactly one trace-window segment)."""
        if self._in_interval:
            raise RuntimeError("begin_interval called twice")
        self._in_interval = True
        live = self.live()
        st = self.stats
        st.intervals += 1
        st.live_lane_intervals += int(live.sum())
        st.lane_intervals += self.r
        blk = live.reshape(-1, self.block)
        st.block_segments += int(blk.any(axis=1).sum())
        depth = sum(len(q) for q in self._queues)
        st.queue_depth_sum += depth
        st.queue_depth_peak = max(st.queue_depth_peak, depth)
        if self._track_tenants and live.any():
            tenants, counts = np.unique(
                self._tenant[self.lane_sys[live]], return_counts=True
            )
            for t, c in zip(tenants, counts):
                st.tenant_live[int(t)] = (
                    st.tenant_live.get(int(t), 0) + int(c)
                )
        return live

    def end_interval(self) -> BarrierPlan:
        """Advance every live lane one segment and plan the barrier:
        harvest finished systems, backfill from the queues, compact
        under-occupied groups once their queue is dry."""
        if not self._in_interval:
            raise RuntimeError("end_interval before begin_interval")
        self._in_interval = False
        live = self.live()
        self.lane_seg[live] += 1
        finished: List[Tuple[int, int]] = []
        for lane in np.nonzero(live)[0]:
            s = self.lane_sys[lane]
            if self.lane_seg[lane] >= self.nseg[s]:
                finished.append((int(lane), int(s)))
                self.lane_sys[lane] = -1
                self.lane_seg[lane] = 0
                dl = self._deadline[s]
                if dl >= 0:
                    if self.stats.intervals <= dl:
                        self.stats.deadline_met += 1
                    else:
                        self.stats.deadline_missed += 1
        return self._plan_barrier(finished)

    def flush_admissions(self) -> BarrierPlan:
        """Backfill + compact *between* intervals — the serving loop's
        way of admitting queued jobs when no lanes are live (nothing is
        running, so there is no end-of-interval barrier to ride)."""
        if self._in_interval:
            raise RuntimeError("flush_admissions inside an interval")
        return self._plan_barrier([])

    def _plan_barrier(
        self, finished: List[Tuple[int, int]]
    ) -> BarrierPlan:
        admitted: List[Tuple[int, int]] = []
        perm = None
        gl = self._gl
        st = self.stats
        for g in range(self.groups):
            lo, hi = g * gl, (g + 1) * gl
            q = self._queues[g]
            for lane in range(lo, hi):
                if not q:
                    break
                if self.lane_sys[lane] < 0:
                    s = q.popleft()
                    self.lane_sys[lane] = s
                    self.lane_seg[lane] = 0
                    admitted.append((lane, s))
                    wait = st.intervals - self._enq_at[s]
                    st.wait_intervals_total += wait
                    st.wait_intervals_max = max(
                        st.wait_intervals_max, wait
                    )
            if q:
                continue  # group is full again; nothing to compact
            gperm = self._plan_compaction(lo, hi)
            if gperm is not None:
                if perm is None:
                    perm = np.arange(self.r, dtype=np.int64)
                perm[lo:hi] = gperm
        st.admissions += len(admitted)
        return BarrierPlan(finished=finished, admitted=admitted, perm=perm)

    def _plan_compaction(self, lo: int, hi: int) -> Optional[np.ndarray]:
        """Stable live-lane packing for one group, or None if the
        occupancy threshold / block-count test says it isn't worth a
        gather.  Updates lane_sys/lane_seg to the packed layout."""
        sys_g = self.lane_sys[lo:hi]
        seg_g = self.lane_seg[lo:hi]
        live_idx = np.nonzero(sys_g >= 0)[0]
        n_live = len(live_idx)
        if not n_live:
            return None
        per_block = (sys_g >= 0).reshape(-1, self.block).sum(axis=1)
        live_blocks = int((per_block > 0).sum())
        needed = -(-n_live // self.block)
        min_frac = per_block[per_block > 0].min() / self.block
        if needed >= live_blocks or min_frac >= self.threshold:
            return None
        gperm = np.arange(hi - lo, dtype=np.int64)
        gperm[:n_live] = live_idx
        new_sys = np.full(hi - lo, -1, dtype=np.int64)
        new_seg = np.zeros(hi - lo, dtype=np.int64)
        new_sys[:n_live] = sys_g[live_idx]
        new_seg[:n_live] = seg_g[live_idx]
        self.lane_sys[lo:hi] = new_sys
        self.lane_seg[lo:hi] = new_seg
        self.stats.compactions += 1
        return gperm + lo


def simulate(
    nseg: np.ndarray,
    *,
    resident: Optional[int] = None,
    block: int = 1,
    groups: int = 1,
    threshold: float = 0.5,
    fused: bool = True,
    policy: str = "fcfs",
    deadline: Optional[np.ndarray] = None,
    tenant: Optional[np.ndarray] = None,
    tenant_weights: TenantWeights = None,
) -> OccupancyStats:
    """The static occupancy model: replay the scheduling policy from a
    per-system segment-count vector alone.  Because the engines drive
    the *same* ``LaneScheduler``, the returned ``block_segments``
    equals a real scheduled run's counter exactly.  ``fused`` selects
    which execution shape the ``host_barriers``/``device_programs``
    counters describe (the policy itself is mode-invariant)."""
    sched = LaneScheduler(
        nseg, resident=resident, block=block, groups=groups,
        threshold=threshold, policy=policy, deadline=deadline,
        tenant=tenant, tenant_weights=tenant_weights,
    )
    while not sched.done():
        sched.begin_interval()
        sched.end_interval()
    return sched.stats.set_mode(fused)


@dataclasses.dataclass
class SchedulePlan:
    """The whole scheduled run, precomputed: one row per interval of
    the exact ``LaneScheduler`` replay, in the form the fused device
    program consumes.

    Row ``i`` describes interval ``i``: ``sys[i, l]`` is the system
    resident in lane ``l`` (-1 = dead lane), ``seg[i, l]`` its
    trace-window segment index, and the barrier to apply BEFORE the
    interval runs is ``state[l] <- reset[i, l] ? init : state[perm[i,
    l]]`` — exactly the host barrier transform
    (``pallas_engine._barrier_fn``), so the fused path is bit-exact by
    construction.  Row 0's barrier is the identity.  Harvest needs no
    plan: a system's state only changes while it is resident, so
    scattering every live lane to its system's store column after
    every interval leaves each column holding the harvest-time value.
    """

    sys: np.ndarray    # [n_int, R] int32, -1 = dead lane
    seg: np.ndarray    # [n_int, R] int32
    perm: np.ndarray   # [n_int, R] int32 gather indices
    reset: np.ndarray  # [n_int, R] int32 0/1
    stats: OccupancyStats

    @property
    def n_intervals(self) -> int:
        return self.sys.shape[0]

    @property
    def resident(self) -> int:
        return self.sys.shape[1]


def build_plan(
    nseg: np.ndarray,
    *,
    resident: Optional[int] = None,
    block: int = 1,
    groups: int = 1,
    threshold: float = 0.5,
    policy: str = "fcfs",
    deadline: Optional[np.ndarray] = None,
    tenant: Optional[np.ndarray] = None,
    tenant_weights: TenantWeights = None,
) -> SchedulePlan:
    """Replay the scheduling policy once, up-front, into the dense
    per-interval arrays the fused run program scans over."""
    sched = LaneScheduler(
        nseg, resident=resident, block=block, groups=groups,
        threshold=threshold, policy=policy, deadline=deadline,
        tenant=tenant, tenant_weights=tenant_weights,
    )
    r = sched.r
    ident = np.arange(r, dtype=np.int32)
    sys_rows, seg_rows, perm_rows, reset_rows = [], [], [], []
    next_perm = ident
    next_reset = np.zeros(r, dtype=np.int32)
    while not sched.done():
        sched.begin_interval()
        sys_rows.append(sched.lane_sys.astype(np.int32))
        seg_rows.append(sched.lane_seg.astype(np.int32))
        perm_rows.append(next_perm)
        reset_rows.append(next_reset)
        plan = sched.end_interval()
        next_perm = (
            ident if plan.perm is None
            else plan.perm.astype(np.int32)
        )
        next_reset = np.zeros(r, dtype=np.int32)
        for lane, _s in plan.admitted:
            next_reset[lane] = 1
    # the final barrier is harvest-only (nothing left to admit or
    # compact), and harvest is implicit in the per-interval scatter
    return SchedulePlan(
        sys=np.stack(sys_rows) if sys_rows else np.zeros(
            (0, r), np.int32),
        seg=np.stack(seg_rows) if seg_rows else np.zeros(
            (0, r), np.int32),
        perm=np.stack(perm_rows) if perm_rows else np.zeros(
            (0, r), np.int32),
        reset=np.stack(reset_rows) if reset_rows else np.zeros(
            (0, r), np.int32),
        stats=sched.stats.set_mode(fused=True),
    )


def segments_needed(tr_len: np.ndarray, window: int) -> np.ndarray:
    """Per-system segment counts from a ``[N, B]`` (or ``[B, N]``-
    transposed caller-side) per-node trace-length plane: a system needs
    ``ceil(longest node trace / window)`` segments, minimum one."""
    longest = np.asarray(tr_len).max(axis=0)
    return np.maximum(1, -(-longest // int(window)))
