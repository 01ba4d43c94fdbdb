"""The ensemble fast path on the GPU: ``CudaEngine``, the counterpart of
``hpa2_tpu.ops.pallas_engine.PallasEngine``.

With ``stream=True`` (the default) one ``run()`` is one launch of the
streamed-run kernel over every lane block, then a single host sync that
reads the status word.  With ``stream=False`` the run is driven from the
host by ``ops/call_run.py:run_windows``, one launch of the per-call
kernel per call and one host read of the ensemble's quiescence after
each.  ``schedule=`` turns on the occupancy scheduler
(``ops/schedule.py``): fused, the whole precomputed plan is enqueued on
the device with no host sync until the final status read; with
``fused=False`` the host runs one interval at a time and reads its
status (a host barrier).  The engine owns its state planes and the
kernels update them in place.

It covers MESI with a full directory on the ideal topology, split
sharer planes (``num_procs > 21``; the kernels take up to
``kernels.MAX_NODES`` nodes, the plain versions any number), packed
planes, and no sharding; anything else is refused with a
``ValueError``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.convert import state_from_numpy
from hpa2_tpu_torch.models.protocol import MsgType
from hpa2_tpu_torch.ops import kernels
from hpa2_tpu_torch.ops.call_run import run_windows, run_windows_multi
from hpa2_tpu_torch.ops.cycle import ablate_set
from hpa2_tpu_torch.ops.layout import (
    _SC_CYCLE, _SC_EV, _SC_INSTR, _SC_INV, _SC_MSGS, _SC_OVERFLOW, _SC_RH,
    _SC_RM, _SC_WH, _SC_WM, TORCH_DTYPES, StallError, _check_geometry,
    _check_semantics, _init_state, _join_word_planes_np, _pack_traces,
    _scalar_layout, _split_sw, choose_block, decode_dumps,
    packed_plane_dtypes, state_dtypes, state_shapes,
)
from hpa2_tpu_torch.ops.schedule import (
    LaneScheduler, build_plan, segments_needed,
)
from hpa2_tpu_torch.utils.dump import NodeDump


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device must exist (there is
    no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: hpa2_tpu_torch runs on the GPU unless "
            "the caller passes device='cpu'")
    return dev


def fast_path_setup(config: SystemConfig, *, lanes: int, block: int,
                    packed: bool, device):
    """The refusals ``CudaEngine`` and ``CudaLaneSession`` share: the
    ideal topology, the geometry and semantics the kernels implement,
    packable planes when ``packed``, and on the card a CUDA device that
    exists, a node count its kernels take and a lane block they take
    (``kernels.MAX_LANE_BLOCK``; the plain versions take any divisor of
    the lanes).  Returns the device and the lane block chosen for
    ``lanes`` lanes."""
    if config.interconnect.enabled:
        raise ValueError(
            "the fast path implements the ideal topology only; use the "
            "general engine (ops/engine.py) for "
            f"topology={config.interconnect.topology!r}"
        )
    _check_geometry(config)
    _check_semantics(config)
    if packed:
        packed_plane_dtypes(config)  # raises on unpackable geometry
    dev = resolve_device(device)
    block = choose_block(lanes, block)
    if dev.type == "cuda":
        kernels.check_kernel_bound(config)
        kernels.check_block(config, block)
    return dev, block


def format_stats(core: dict, msg_counts) -> dict:
    """Counter dict in the spec engine's key names; per-type message
    counts appear only when nonzero."""
    out = dict(core)
    for t in MsgType:
        if msg_counts[int(t)]:
            out[f"msg_{t.name}"] = int(msg_counts[int(t)])
    return out


def run_program(config: SystemConfig, state: Dict[str, torch.Tensor],
                tr: torch.Tensor, tr_len: torch.Tensor, *, stream: bool,
                block: int, k: int, window: int, n_seg: int, max_calls: int,
                gate: bool, snapshots: bool,
                packed: bool = False,
                ablate: frozenset = frozenset()) -> torch.Tensor:
    """Run every system of ``state`` through the ``n_seg`` windows of
    ``tr``: the streamed kernel (``stream=True``) or the per-call
    kernel's host loop.  Updates ``state`` in place and returns the
    status word (bit 0 stall, bit 1 overflow) as an int32 scalar on the
    planes' device, not read.  ``ablate`` stubs out cycle stages (the
    ablation kernels; timing only)."""
    kw = dict(block=block, k=k, window=window, n_seg=n_seg,
              max_calls=max_calls, gate=gate, snapshots=snapshots,
              packed=packed, ablate=ablate)
    if not stream:
        return run_windows(config, state, tr, tr_len, **kw)
    stall = kernels.stream_run(config, state, tr, tr_len, **kw)
    overflow = (state["scalars"][_SC_OVERFLOW] > 0).any()
    return (stall != 0).any().to(torch.int32) | (
        overflow.to(torch.int32) << 1)


def run_programs(config: SystemConfig, parts, *, stream: bool, block: int,
                 k: int, window: int, n_seg: int, max_calls: int,
                 gate: bool, snapshots: bool, packed: bool = False,
                 ablate: frozenset = frozenset()) -> List[torch.Tensor]:
    """:func:`run_program` over several ``(state, tr, tr_len)`` parts
    (one, or one a data shard, each on its own device); returns each
    part's status word, not read.  Streamed, every part's launch is
    enqueued before any status is read; per call, ``run_windows_multi``
    enqueues a call of every open part before each host read."""
    kw = dict(block=block, k=k, window=window, n_seg=n_seg,
              max_calls=max_calls, gate=gate, snapshots=snapshots,
              packed=packed, ablate=ablate)
    if not stream:
        return run_windows_multi(config, parts, **kw)
    return [run_program(config, st, tr, tl, stream=True, **kw)
            for st, tr, tl in parts]


def read_status(statuses: List[torch.Tensor]) -> int:
    """The status words of a run's parts ORed on the first part's device
    and read once (one host sync, ``kernels.HOST_SYNCS``): the counterpart
    of the single OR-reduce in ``hpa2_tpu/parallel/sharding.py:520-532``.
    A shard's word crosses to that device behind the work that wrote it."""
    home = statuses[0].device
    word = statuses[0]
    for x in statuses[1:]:
        word = word | x.to(home)
    return int(kernels.HOST_SYNCS.read(word))


def _signed(x: torch.Tensor) -> torch.Tensor:
    """``x``, a u16 plane seen as int16 (the same bits): CUDA has no
    gather or ``where`` for u16."""
    return x.view(torch.int16) if x.dtype == torch.uint16 else x


def barrier_(state: Dict[str, torch.Tensor], init: Dict[str, torch.Tensor],
             perm: torch.Tensor, reset: torch.Tensor) -> None:
    """The segment-barrier transform, in place: gather-permute every
    carried plane along the lane axis by ``perm`` ([R] int64), then
    reset the lanes where ``reset`` ([R] bool) is set to ``init``.
    Plain torch, as it is plain XLA in the JAX package."""
    for f, v in state.items():
        g = _signed(v).index_select(-1, perm)
        _signed(v).copy_(torch.where(reset, _signed(init[f]), g))


def interval_windows(tr_np: np.ndarray, tl_np: np.ndarray,
                     lane_sys: np.ndarray, lane_seg: np.ndarray,
                     live: np.ndarray, window: int):
    """The next interval's ``[N, w, R]`` trace windows and ``[N, R]``
    window lengths, assembled on the host from the ``[N, T, B]`` trace
    plane and ``[N, B]`` lengths: lane ``l`` carries window
    ``lane_seg[l]`` of system ``lane_sys[l]``; idle lanes get an empty
    window."""
    n, r, w = tr_np.shape[0], len(lane_sys), window
    tr_int = np.zeros((n, w, r), np.int32)
    tl_int = np.zeros((n, r), np.int32)
    lanes = np.nonzero(live)[0]
    if len(lanes):
        sys_ = lane_sys[lanes]
        base = lane_seg[lanes] * w
        idx = np.broadcast_to(
            base[None, None, :] + np.arange(w)[None, :, None],
            (n, w, len(lanes)))
        tr_int[:, :, lanes] = np.take_along_axis(tr_np[:, :, sys_], idx,
                                                 axis=1)
        tl_int[:, lanes] = np.clip(tl_np[:, sys_] - base[None, :], 0, w)
    return tr_int, tl_int


def _schedule_kw(schedule, resident: int, block: int,
                 groups: int = 1) -> dict:
    """The ``LaneScheduler``/``build_plan`` arguments a ``Schedule``
    asks for (``groups`` scheduling groups)."""
    return dict(resident=resident, block=block, groups=groups,
                threshold=schedule.threshold, policy=schedule.policy,
                deadline=schedule.deadlines, tenant=schedule.tenants,
                tenant_weights=schedule.tenant_weights)


class CudaEngine:
    """Ensemble engine on the GPU, one thread a system.

    Same observable behavior as ``PallasEngine``: fixture semantics,
    dump-at-local-completion snapshots, counters, the stall status,
    bit-identical state planes, and with ``schedule=`` the same
    per-system results and ``occupancy`` counters.  ``trace_window=w``
    runs traces longer than ``w`` as successive windows that quiesce in
    between; ``gate`` skips 8-cycle bursts of quiescent lane blocks;
    ``snapshots=False`` drops the phase-D snapshot planes; ``packed``
    stores the cache and directory words as narrow u8/u16 planes;
    ``stream=False`` runs the per-call kernel from a host loop instead
    of the streamed kernel.

    ``schedule=Schedule(...)`` (``ops/schedule.py``) runs the trace as
    single-window intervals over ``schedule.resident`` lanes (all by
    default): at each window barrier finished systems are harvested,
    freed lanes are backfilled from the admission queue and
    under-occupied blocks are compacted.  It needs ``snapshots=False``;
    ``self.occupancy`` holds the replay's ``OccupancyStats`` after the
    run.

    ``device="cpu"`` runs the kernels' plain PyTorch versions (the
    tests); the default ``"cuda"`` launches the kernels and raises when
    there is no GPU.

    ``_ablate`` (timing only, ``scripts/perf_sweep.py --ablate``) names
    cycle stages to stub out (``ops/cycle.py:ABLATE_STAGES``), on every
    path: the run is then deliberately wrong and never quiesces unless
    its traces are empty, so bound it with ``max_cycles``.  On the card
    it runs the ablation kernels (int32 or packed planes); an unknown
    stage name raises here."""

    def __init__(
        self,
        config: SystemConfig,
        tr_op: np.ndarray,
        tr_addr: np.ndarray,
        tr_val: np.ndarray,
        tr_len: np.ndarray,
        block: int = 1024,
        cycles_per_call: int = 128,
        snapshots: bool = True,
        trace_window: Optional[int] = None,
        gate: bool = True,
        stream: bool = True,
        schedule=None,
        packed: bool = False,
        device="cuda",
        _ablate: frozenset = frozenset(),
    ):
        b, _, t = tr_op.shape
        self._ablate = ablate_set(_ablate)
        self.config = config
        self.b = b
        self.schedule = schedule
        self.occupancy = None
        if schedule is not None:
            if snapshots:
                raise ValueError(
                    "the occupancy scheduler reorders and reuses lanes;"
                    " dump-at-local-completion snapshots are defined on"
                    " the whole-trace lockstep run — build with"
                    " snapshots=False"
                )
            self._resident = schedule.resident or b
            if not (0 < self._resident <= b):
                raise ValueError(
                    f"schedule.resident={schedule.resident} outside "
                    f"1..{b}"
                )
        else:
            self._resident = b
        # the device carries `resident` lanes, so the blocks tile that
        # lane count
        self.device, self.block = fast_path_setup(
            config, lanes=self._resident, block=block, packed=packed,
            device=device)
        self.cycles_per_call = cycles_per_call
        self._snapshots = snapshots
        self._gate = gate
        self._stream = stream
        self._packed = packed

        tr_len = tr_len.astype(np.int32)
        tr_words = _pack_traces(config, tr_op, tr_addr, tr_val, tr_len)
        w = trace_window if trace_window else t
        w = max(1, min(w, t))
        self._window = w
        self._n_seg = -(-t // w)
        if snapshots and self._n_seg > 1:
            raise ValueError(
                "dump-at-local-completion snapshots are defined on the "
                "whole trace; run windowed traces with snapshots=False"
            )
        _scalar_layout(config, w)  # raises when nsw cannot hold the window
        t_pad = self._n_seg * w
        if t_pad != t:
            tr_words = np.pad(tr_words, ((0, 0), (0, t_pad - t), (0, 0)))
        tr_len_nb = np.ascontiguousarray(np.moveaxis(tr_len, 0, 1))
        if schedule is not None:
            # host copies drive the host-barrier loop's window assembly
            self._tr_np = tr_words
            self._tr_len_np = tr_len_nb
            self._nseg = segments_needed(tr_len_nb, w)
        self._tr_full = torch.from_numpy(tr_words).to(self.device)
        self._tr_len_full = torch.from_numpy(tr_len_nb).to(self.device)
        self.state = state_from_numpy(
            _init_state(config, b, snapshots, packed), self.device)
        self._completed = False
        self._poisoned = False

    def _check_status(self, status: int, max_cycles: int) -> None:
        if status:
            self._poisoned = True
        if status & 2:
            raise StallError(
                "internal invariant violated: mailbox overflow despite "
                "backpressure"
            )
        if status & 1:
            raise StallError(
                f"no quiescence within ~{max_cycles} cycles over the "
                "whole run (livelock? use Semantics.robust(); raise "
                "max_cycles for long windowed workloads)"
            )

    def _programs(self, parts, *, n_seg: int, snapshots: bool,
                  max_cycles: int) -> List[torch.Tensor]:
        max_calls = max(1, -(-max_cycles // self.cycles_per_call))
        return run_programs(
            self.config, parts, stream=self._stream, block=self.block,
            k=self.cycles_per_call, window=self._window, n_seg=n_seg,
            max_calls=max_calls, gate=self._gate, snapshots=snapshots,
            packed=self._packed, ablate=self._ablate)

    def run(self, max_cycles: int = 1_000_000) -> "CudaEngine":
        # the run loop resets pc at every window base, so a run is not
        # resumable: completed runs are a no-op, stalled runs leave
        # in-flight state that only a rebuild can clear
        if self._completed:
            return self
        if self._poisoned:
            raise StallError(
                "engine state is mid-flight after a failed run; "
                "rebuild the engine to retry"
            )
        if self.schedule is not None:
            if self.schedule.fused:
                return self._run_scheduled_fused(max_cycles)
            return self._run_scheduled(max_cycles)
        statuses = self._programs(
            self._parts(), n_seg=self._n_seg, snapshots=self._snapshots,
            max_cycles=max_cycles)
        self._check_status(read_status(statuses), max_cycles)
        self._completed = True
        return self

    # -- lane groups ----------------------------------------------------
    #
    # The scheduler splits the resident lanes and the systems into
    # ``_sched_groups`` contiguous groups that never exchange work.  One
    # here; one a data shard, each on its own device, in
    # ``parallel/sharding.py:DataShardedCudaEngine``.

    _sched_groups = 1

    def _parts(self):
        """The ``(planes, traces, lengths)`` of each data shard."""
        return [(self.state, self._tr_full, self._tr_len_full)]

    def _group_device(self, g: int) -> torch.device:
        return self.device

    def _group_traces(self, g: int):
        """Group ``g``'s systems' trace plane and lengths."""
        return self._tr_full, self._tr_len_full

    def _join_groups(self, states):
        """The ensemble's planes from each group's, in system order."""
        return states[0]

    # -- occupancy scheduling (ops/schedule.py) -----------------------

    def _lane_planes(self, lanes: int, device):
        """Fresh initial planes of ``lanes`` lanes on ``device``."""
        return state_from_numpy(
            _init_state(self.config, lanes, snapshots=False,
                        packed=self._packed), device)

    def _empty_store(self, lanes: int, device):
        shapes = state_shapes(self.config, False, self._packed)
        dtypes = state_dtypes(self.config, False, self._packed)
        return {f: torch.zeros(tuple(shapes[f]) + (lanes,),
                               dtype=TORCH_DTYPES[dtypes[f]],
                               device=device)
                for f in shapes}

    def _run_scheduled_fused(self, max_cycles: int) -> "CudaEngine":
        """The fused scheduled run: the plan from ``build_plan``, every
        interval's trace gather, barrier, run and scatter enqueued on
        the device in order, and one host read of the status word at
        the end (with ``stream=False`` the per-call host loop also reads
        the ensemble's quiescence after each call).  Each interval's
        live lanes are scattered to their systems' columns of a store
        with one extra trash column, which idle lanes write and which
        is dropped; a system's state changes only while it is resident,
        so the last scatter holds its final state.  Each group runs its
        slice of the plan, rebased to its own lanes and systems (the
        permutations are block-diagonal over the groups), on its own
        device; the groups' intervals are enqueued in turn."""
        groups = self._sched_groups
        plan = build_plan(self._nseg, **_schedule_kw(
            self.schedule, self._resident, self.block, groups))
        n, w = self.config.num_procs, self._window
        gl, gs = self._resident // groups, self.b // groups
        nseg_max = self._n_seg
        ident = np.arange(gl)
        runs = []
        for g in range(groups):
            dev = self._group_device(g)
            cols = slice(g * gl, (g + 1) * gl)
            sys_g = plan.sys[:, cols]
            sys_g = np.where(sys_g >= 0, sys_g - g * gs, -1)
            perm_g = plan.perm[:, cols].astype(np.int64) - g * gl
            reset_g = plan.reset[:, cols] != 0
            # all host-to-device copies come before the first launch
            rows = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
                    for k, v in (("sys", sys_g), ("seg", plan.seg[:, cols]),
                                 ("perm", perm_g), ("reset", reset_g))}
            tr_full, tl_full = self._group_traces(g)
            # [n, nseg_max*w, gs] -> [nseg_max*gs, n, w]: one gather row
            # per (window, system)
            trf = tr_full.view(n, nseg_max, w, gs).permute(
                1, 3, 0, 2).reshape(nseg_max * gs, n, w)
            runs.append(dict(
                rows=rows, trf=trf, tl_full=tl_full,
                state=self._lane_planes(gl, dev),
                init=self._lane_planes(gl, dev),
                store=self._empty_store(gs + 1, dev),
                status=torch.zeros((), dtype=torch.int32, device=dev),
                barrier=reset_g.any(axis=1) | (perm_g != ident).any(axis=1)))
        for i in range(plan.n_intervals):
            parts = []
            for run in runs:
                rows, state = run["rows"], run["state"]
                if run["barrier"][i]:
                    barrier_(state, run["init"], rows["perm"][i],
                             rows["reset"][i])
                sys_i, seg_i = rows["sys"][i], rows["seg"][i]
                sysc = sys_i.clamp(0, gs - 1)
                gidx = seg_i.clamp(0, nseg_max - 1) * gs + sysc
                tr_i = run["trf"].index_select(0, gidx).permute(
                    1, 2, 0).contiguous()
                tl_i = torch.where(
                    sys_i >= 0,
                    (run["tl_full"].index_select(1, sysc)
                     - seg_i[None, :] * w).clamp(0, w),
                    0).to(torch.int32)
                parts.append((state, tr_i, tl_i))
            statuses = self._programs(parts, n_seg=1, snapshots=False,
                                      max_cycles=max_cycles)
            for run, st in zip(runs, statuses):
                run["status"] |= st
                sys_i = run["rows"]["sys"][i]
                tgt = torch.where(sys_i >= 0, sys_i, gs).to(torch.int64)
                for f, v in run["state"].items():
                    _signed(run["store"][f]).index_copy_(-1, tgt,
                                                         _signed(v))
        self.state = self._join_groups(
            [{f: v[..., :gs].contiguous() for f, v in run["store"].items()}
             for run in runs])
        self._check_status(read_status([r["status"] for r in runs]),
                           max_cycles)
        self.occupancy = plan.stats
        self._completed = True
        return self

    def _run_scheduled(self, max_cycles: int) -> "CudaEngine":
        """The host-barrier scheduled run: per interval, the host
        assembles the resident lanes' trace windows, runs them, reads
        the status (one host barrier an interval), harvests finished
        lanes into a store in system order and applies the barrier.
        Each group's lanes, systems and barrier live on its device."""
        groups = self._sched_groups
        sched = LaneScheduler(self._nseg, **_schedule_kw(
            self.schedule, self._resident, self.block, groups))
        r = self._resident
        gl, gs = r // groups, self.b // groups
        devs = [self._group_device(g) for g in range(groups)]
        states = [self._lane_planes(gl, d) for d in devs]
        inits = [self._lane_planes(gl, d) for d in devs]
        stores = [self._empty_store(gs, d) for d in devs]
        while not sched.done():
            live = sched.begin_interval()
            tr_int, tl_int = interval_windows(
                self._tr_np, self._tr_len_np, sched.lane_sys,
                sched.lane_seg, live, self._window)
            parts = [
                (states[g], *(torch.from_numpy(np.ascontiguousarray(
                    a[..., g * gl:(g + 1) * gl])).to(d)
                    for a in (tr_int, tl_int)))
                for g, d in enumerate(devs)]
            statuses = self._programs(parts, n_seg=1, snapshots=False,
                                      max_cycles=max_cycles)
            self._check_status(read_status(statuses), max_cycles)
            plan = sched.end_interval()
            for g, d in enumerate(devs):
                done = [(lane - g * gl, s - g * gs)
                        for lane, s in plan.finished if lane // gl == g]
                if done:
                    lanes, systems = (torch.tensor(x, dtype=torch.int64,
                                                   device=d)
                                      for x in zip(*done))
                    for f, v in states[g].items():
                        _signed(stores[g][f]).index_copy_(
                            -1, systems, _signed(v).index_select(-1, lanes))
            if not plan.trivial:
                perm = (plan.perm if plan.perm is not None
                        else np.arange(r, dtype=np.int64))
                reset = np.zeros(r, bool)
                for lane, _ in plan.admitted:
                    reset[lane] = True
                for g, d in enumerate(devs):
                    lanes = slice(g * gl, (g + 1) * gl)
                    barrier_(states[g], inits[g],
                             torch.from_numpy(perm[lanes] - g * gl).to(d),
                             torch.from_numpy(reset[lanes]).to(d))
        # the full-ensemble planes in system order, so every readback
        # accessor works unchanged
        self.state = self._join_groups(stores)
        self.occupancy = sched.stats.set_mode(fused=False)
        self._completed = True
        return self

    # -- readback -----------------------------------------------------

    def _plane(self, f: str) -> np.ndarray:
        return self.state[f].cpu().numpy()

    def _split_planes(self, prefix: str):
        """The split sharer-word planes ``prefix{w}``, or None when the
        sharers sit in the directory word."""
        sw = _split_sw(self.config)
        return [self._plane(f"{prefix}{w}") for w in range(sw)] or None

    def _word_planes(self, prefix: str = ""):
        """(cachew, dirw) as int32 words; packed planes are joined."""
        if self._packed:
            return _join_word_planes_np(*(self._plane(prefix + f) for f in (
                "cvalw", "cmetaw", "dmemw", "dmetaw")))
        return self._plane(f"{prefix}cachew"), self._plane(f"{prefix}dirw")

    def system_snapshots(self, sys_idx: int) -> List[NodeDump]:
        if not self._snapshots:
            raise ValueError(
                "engine built with snapshots=False has no phase-D state"
            )
        return decode_dumps(self.config, *self._word_planes("snap_"),
                            sys_idx, dirs=self._split_planes("snap_dirs"))

    def system_final_dumps(self, sys_idx: int) -> List[NodeDump]:
        return decode_dumps(self.config, *self._word_planes(), sys_idx,
                            dirs=self._split_planes("dirs"))

    # single-system aliases matching the other engines' interface (the
    # CLI's `run` path)

    def snapshots(self) -> List[NodeDump]:
        if self.b != 1:
            raise ValueError(
                "snapshots() is the batch-1 interface; use "
                "system_snapshots(b) on ensembles"
            )
        return self.system_snapshots(0)

    def final_dumps(self) -> List[NodeDump]:
        if self.b != 1:
            raise ValueError(
                "final_dumps() is the batch-1 interface; use "
                "system_final_dumps(b) on ensembles"
            )
        return self.system_final_dumps(0)

    @property
    def instructions(self) -> int:
        return int(self.state["scalars"][_SC_INSTR].sum())

    @property
    def messages(self) -> int:
        return int(self.state["scalars"][_SC_MSGS].sum())

    @property
    def cycle(self) -> int:
        """Max per-system cycle count (lockstep wall cycles)."""
        return int(self.state["scalars"][_SC_CYCLE].max())

    def stats(self) -> dict:
        sc = self._plane("scalars").astype(np.int64)
        return format_stats(
            {
                "instructions": int(sc[_SC_INSTR].sum()),
                "msgs_total": int(sc[_SC_MSGS].sum()),
                "read_hits": int(sc[_SC_RH].sum()),
                "read_misses": int(sc[_SC_RM].sum()),
                "write_hits": int(sc[_SC_WH].sum()),
                "write_misses": int(sc[_SC_WM].sum()),
                "evictions": int(sc[_SC_EV].sum()),
                "invalidations": int(sc[_SC_INV].sum()),
            },
            self._plane("msg_counts").astype(np.int64).sum(axis=1),
        )
