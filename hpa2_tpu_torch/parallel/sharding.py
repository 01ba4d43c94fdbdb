"""Several GPUs: meshes, the data-sharded fast path and general engine,
and the node-sharded general engine and fast path; the port of
``hpa2_tpu/parallel/sharding.py``.

The reference scales by OpenMP threads in one address space; the JAX
package by two mesh axes.  The port keeps both axes with a runtime
chosen for each:

* ``data`` -- the ensemble axis: B independent systems split into
  ``data_shards`` contiguous groups, one a device.  One process drives
  every card, as JAX's single controller does: a data mesh
  (:class:`DataMesh`) is an ordered list of devices, each shard's lanes,
  traces and planes live on its card, every shard's kernel is enqueued
  on its card's current stream before any status is read, and the
  shards' status words are ORed on one device and read once (the single
  OR of ``build_data_sharded_pallas_run``, JAX l.520-532).  Shards never
  exchange anything else.  ``device="cpu"`` runs the shards one after
  another on the CPU with the plain versions; an explicit ``devices=``
  list may name one card twice (a smoke test on one card).
* ``node`` -- the simulated-node axis of one system: SPMD ranks on
  ``torch.distributed``, one rank a card (NCCL; gloo on the CPU), each
  holding a contiguous block of ``num_procs // node_shards`` nodes.  The
  cross-shard delivery is the targeted exchange of ``ops/exchange.py``
  through the counting wrapper of ``parallel/comm.py``; the ranks start
  through ``parallel/launch.py`` (or join ``torchrun``'s group), and a
  run gathers every rank's node block back to the caller, so the JAX
  accessors work unchanged.

Both compose in :class:`GridEngine` (a data x node grid of ranks; the
exchange runs in the node group of each data row).

Where the port departs from the JAX code, and why:

* **The node-sharded loop runs on the host, uncaptured.**  JAX keeps the
  ``while_loop`` on the device.  Here each cycle is the step (its
  exchange collectives, one SUM, one MAX), then one MIN over the node
  group (quiescence) and one MIN over every rank (the loop condition
  and, under elision, the jump), read on the host.  The single-device
  ``Run`` captures 16 gated steps in a CUDA graph; capturing the NCCL
  calls as well is later work (ROADMAP queue 2).
* **The data-sharded general engine also steps on the host.**
  ``BatchJaxEngine(data_shards=)`` runs one loop whose condition and
  elision jump are global over the shards; :class:`DataShardedRun`
  keeps that (so every field, ``cycle`` included, equals the unsharded
  run) with one host read a cycle of every shard's condition terms.
* **The fast path's node axis is four hand-written kernels between
  NCCL calls.**  JAX runs K1's node-sharded variant as XLA under
  ``shard_map`` (no Pallas kernel can hold a collective); the port's
  :class:`NodeShardedCudaEngine` and :class:`NodeShardedLaneSession` run
  ``ops/node_cycle.py:NodeCycle`` on each rank: N1-N4 of
  ``csrc/node_cycle.cu`` (the register instantiations up to 64 nodes,
  the wide family above, to the 4,096 nodes of the node axis's own
  geometry and past it) between the exchange's collectives, the k-cycle
  loop on the rank's host (:class:`NodeInterval`, one host read a
  call).  ``cycle="tensor"`` (the plain versions) runs only where a
  caller names it.  Capturing the k cycles and their NCCL calls is
  ROADMAP queue 2 item 8.
* **The serving session's ranks live in a pool.**  JAX's single
  controller drives a mesh; here the controller process holds no card
  state and sends each command of the serving protocol to the ranks of
  a ``parallel/launch.py:RankPool``.
"""

from __future__ import annotations

import dataclasses
import re
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.models.protocol import Instr
from hpa2_tpu_torch.models.spec_engine import StallError
from hpa2_tpu_torch.ops import kernels
from hpa2_tpu_torch.ops.cuda_engine import (
    CudaEngine, _schedule_kw, _signed, barrier_, resolve_device,
    run_programs,
)
from hpa2_tpu_torch.ops.cycle import TRANSIENTS, build_cycle
from hpa2_tpu_torch.ops.engine import (
    _dumps, _live_arrays, _snap_arrays, engine_stats,
)
from hpa2_tpu_torch.ops.layout import (
    _SC_CYCLE, _SC_INSTR, _SC_MSGS, _SC_OVERFLOW, _init_state,
    _join_word_planes_np, _mb_layout, _scalar_layout, _sharer_words,
    _split_sw, choose_block, decode_dumps, deferred_valid,
)
from hpa2_tpu_torch.ops.schedule import build_plan
from hpa2_tpu_torch.ops.session import CudaLaneSession, _Pending, _record
from hpa2_tpu_torch.ops.state import SimState, init_state, stack_states
from hpa2_tpu_torch.ops.step import (
    build_fast_forward, build_propose, build_step, quiescent,
)
from hpa2_tpu_torch.utils.dump import NodeDump

I32 = torch.int32

# SimState fields whose first axis after the batch is the node axis;
# every other field (cycle, counters, replay schedule, fault and
# watchdog bookkeeping, link and exchange telemetry) is replicated
_NODE_LEADING = frozenset(
    f
    for f in SimState._fields
    if f not in ("order_node", "order_pos", "order_len",
                 "cycle", "n_instr", "n_msgs", "overflow",
                 "n_read_hits", "n_read_miss", "n_write_hits",
                 "n_write_miss", "n_evictions", "n_invalidations",
                 "msg_counts", "rng_key", "last_progress",
                 "n_retrans", "n_dup_filtered", "n_reorder_fixed",
                 "n_delays", "n_wire_stalls",
                 "link_traversals", "link_max_load", "n_topo_delay",
                 "n_multicast_saved", "n_combined",
                 "n_elided", "n_multi_hit",
                 "n_forwards", "n_owner_xfer", "n_dir_overflow",
                 "n_exch_sent", "n_exch_hwm", "n_exch_mc_saved",
                 "n_exch_combined")
)

# ---------------------------------------------------------------------------
# meshes


def _cuda_devices() -> List[torch.device]:
    resolve_device("cuda")  # raises without CUDA
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """A 1-D ``('data',)`` mesh: the ordered devices of the shards."""

    devices: tuple

    axis_names = ("data",)

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": len(self.devices)}


def make_data_mesh(data_shards: Optional[int] = None,
                   devices: Optional[Sequence] = None,
                   device="cuda") -> DataMesh:
    """A data mesh (JAX ``make_data_mesh``, l.451): ``data_shards`` of
    ``devices``, by default every card (``torch.cuda.device_count()``),
    and more shards than devices raises.  An explicit ``devices`` list
    may name one card twice.  ``device="cpu"`` makes ``data_shards``
    logical shards on the CPU (one by default)."""
    if devices is None:
        if torch.device(device).type == "cpu":
            devices = [torch.device("cpu")] * (
                1 if data_shards is None else max(data_shards, 0))
        else:
            devices = _cuda_devices()
    devices = [torch.device(d) for d in devices]
    for d in devices:
        if d.type == "cuda":
            resolve_device(d)
            if (d.index or 0) >= torch.cuda.device_count():
                raise ValueError(
                    f"{d} named, but this machine has "
                    f"{torch.cuda.device_count()} card(s)")
    if data_shards is None:
        data_shards = len(devices)
    if data_shards < 1 or data_shards > len(devices):
        raise ValueError(
            f"data_shards={data_shards} outside 1..{len(devices)} "
            "available devices"
        )
    return DataMesh(tuple(devices[:data_shards]))


def _check_data_mesh(mesh) -> int:
    if not isinstance(mesh, DataMesh):
        raise ValueError(
            f"need a 1-D ('data',) mesh, got axes "
            f"{getattr(mesh, 'axis_names', type(mesh).__name__)}")
    return len(mesh.devices)


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A ``(data, node)`` grid of ranks (JAX ``make_mesh``, l.78): rank
    ``d * node + i`` holds node block ``i`` of data row ``d``, on
    ``cuda:rank`` or on the CPU."""

    data: int
    node: int
    device: str = "cuda"
    local: bool = False

    axis_names = ("data", "node")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "node": self.node}

    @property
    def size(self) -> int:
        return self.data * self.node


def make_mesh(node_shards: int = 1, data_shards: Optional[int] = None,
              device="cuda", local: bool = False) -> Mesh:
    """A ``(data, node)`` mesh over the cards (JAX ``make_mesh``,
    l.78-104): every card by default, and a grid larger than the cards
    raises (NCCL takes one rank a card).  On the CPU the ranks are gloo
    processes and ``data_shards`` defaults to 1.

    ``local=True`` makes the ranks threads of this process on one device
    (``cuda:0``, or the CPU), whose collectives are copies in memory
    behind a barrier (``parallel/comm.py:LocalComm``): the port's
    counterpart of the host-platform devices on which the JAX package
    runs ``shard_map`` in one process, so a node-sharded run needs one
    card; ``data_shards`` defaults to 1."""
    dev = torch.device(device)
    if local:
        if dev.type == "cuda":
            _cuda_devices()
        data_shards = 1 if data_shards is None else data_shards
        if node_shards < 1 or data_shards < 1:
            raise ValueError(
                f"empty mesh: data_shards={data_shards} x "
                f"node_shards={node_shards}")
        return Mesh(data_shards, node_shards, dev.type, local=True)
    count = len(_cuda_devices()) if dev.type == "cuda" else None
    if node_shards < 1 or (count is not None and node_shards > count):
        raise ValueError(
            f"node_shards={node_shards} outside 1..{count} available "
            "devices")
    if data_shards is None:
        data_shards = 1 if count is None else count // node_shards
    need = data_shards * node_shards
    if need < 1:
        raise ValueError(
            f"empty mesh: data_shards={data_shards} x "
            f"node_shards={node_shards}")
    if count is not None and need > count:
        raise ValueError(
            f"mesh {data_shards}x{node_shards} needs {need} devices, "
            f"have {count}")
    return Mesh(data_shards, node_shards, dev.type)


def state_specs() -> Dict[str, Optional[str]]:
    """Per ``SimState`` field, the mesh axis its node dimension (dim 1)
    splits over, or None (replicated); the batch dimension (dim 0)
    splits over ``data`` (JAX ``state_specs``, l.107)."""
    return {f: ("node" if f in _NODE_LEADING else None)
            for f in SimState._fields}


def node_block(st: SimState, i: int, node_shards: int) -> SimState:
    """Node block ``i`` of ``node_shards`` of a state (JAX ``_place``'s
    split over ``node``, by :func:`state_specs`)."""
    nl = st.pc.shape[1] // node_shards
    specs = state_specs()
    return SimState(*(
        x[:, i * nl:(i + 1) * nl] if specs[f] == "node" else x
        for f, x in zip(SimState._fields, st)))


def join_blocks(blocks: Sequence[Dict[str, np.ndarray]],
                node: int) -> Dict[str, np.ndarray]:
    """A ``data x node`` grid of ranks' numpy states (rank order) as one
    state: node blocks joined on dim 1, data rows on dim 0; replicated
    fields from each row's first rank (JAX ``fetch_host_state``'s
    gather)."""
    specs = state_specs()
    rows = []
    for d in range(len(blocks) // node):
        row = blocks[d * node:(d + 1) * node]
        rows.append({
            f: (np.concatenate([b[f] for b in row], axis=1)
                if specs[f] == "node" else row[0][f])
            for f in SimState._fields})
    return {f: np.concatenate([r[f] for r in rows], axis=0)
            for f in SimState._fields}


# ---------------------------------------------------------------------------
# the data axis of the fast path


class DataShardedCudaEngine(CudaEngine):
    """The fast path, data-parallel over a data mesh (JAX
    ``DataShardedPallasEngine``, l.600-729).

    The ensemble of B systems splits into ``data_shards`` equal lane
    groups, one a device; each shard runs the whole streamed kernel (or
    the per-call kernel's loop) on its own lanes, so the result is the
    single-device ``CudaEngine``'s: the same planes, dumps, cycle counts
    and stall status (the shards' status words OR into one word, read
    once).  Under ``schedule=`` each shard is one scheduling group (its
    own admission queue; block-diagonal compaction), so lanes never
    cross cards.  ``mesh``/``devices``/``data_shards`` choose the cards
    (:func:`make_data_mesh`); every other keyword is ``CudaEngine``'s.
    ``state`` reads the shards' planes back, joined in system order."""

    def __init__(self, config: SystemConfig, tr_op: np.ndarray,
                 tr_addr: np.ndarray, tr_val: np.ndarray,
                 tr_len: np.ndarray, data_shards: Optional[int] = None,
                 mesh: Optional[DataMesh] = None,
                 devices: Optional[Sequence] = None, block: int = 1024,
                 device="cuda", **kwargs):
        if mesh is None:
            mesh = make_data_mesh(data_shards, devices, device=device)
        shards = _check_data_mesh(mesh)
        b = tr_op.shape[0]
        if b % shards != 0:
            raise ValueError(
                f"batch {b} not divisible by data_shards={shards}")
        # each shard's blocks tile its own lanes (a divisor of them
        # divides b too); under the scheduler the shards carry
        # `resident` lanes, split the same way
        sched = kwargs.get("schedule")
        if sched is not None:
            resident = sched.resident or b
            if resident % shards:
                raise ValueError(
                    f"schedule.resident={resident} not divisible by "
                    f"data_shards={shards}")
            block = choose_block(resident // shards, block)
        else:
            block = choose_block(b // shards, block)
        self.mesh = mesh
        self.data_shards = shards
        self._shard_b = b // shards
        self._shard_states: List[Dict[str, torch.Tensor]] = []
        super().__init__(config, tr_op, tr_addr, tr_val, tr_len,
                         block=block, device=mesh.devices[0], **kwargs)
        self._sched_groups = shards
        sl = [slice(g * self._shard_b, (g + 1) * self._shard_b)
              for g in range(shards)]
        self._shard_traces = [
            (self._tr_full[..., s].contiguous().to(d),
             self._tr_len_full[..., s].contiguous().to(d))
            for s, d in zip(sl, mesh.devices)]
        self._tr_full = self._tr_len_full = None

    @property
    def state(self) -> Dict[str, torch.Tensor]:
        """The ensemble's planes on the CPU, joined in system order."""
        parts = self._shard_states
        return {f: torch.cat([p[f].cpu() for p in parts], dim=-1)
                for f in parts[0]}

    @state.setter
    def state(self, value) -> None:
        """Full-ensemble planes split onto the shards' devices, or a list
        of per-shard planes."""
        if isinstance(value, list):
            self._shard_states = value
            return
        b = next(iter(value.values())).shape[-1]
        per = b // self.data_shards
        self._shard_states = [
            {f: v[..., g * per:(g + 1) * per].contiguous().to(d)
             for f, v in value.items()}
            for g, d in enumerate(self.mesh.devices)]

    def _parts(self):
        return [(st, tr, tl) for st, (tr, tl) in
                zip(self._shard_states, self._shard_traces)]

    def _group_device(self, g: int) -> torch.device:
        return self.mesh.devices[g]

    def _group_traces(self, g: int):
        return self._shard_traces[g]

    def _join_groups(self, states):
        return list(states)


class DataShardedLaneSession:
    """The resident-lane serving session over a data mesh (JAX
    ``DataShardedLaneSession``, l.731-818): one ``CudaLaneSession`` a
    shard on its device, each over a contiguous group of ``resident /
    data_shards`` lanes.  The serving loop builds its scheduler with
    ``groups=data_shards``, so barrier permutations are block-diagonal
    and lanes never cross cards.  An interval enqueues every shard's
    run before its one status read (the shards' words ORed on the first
    device); harvested columns come from their shard's session."""

    def __init__(self, config: SystemConfig, resident: int, window: int, *,
                 data_shards: Optional[int] = None,
                 mesh: Optional[DataMesh] = None,
                 devices: Optional[Sequence] = None, block: int = 1024,
                 cycles_per_call: int = 128, gate: bool = True,
                 stream: bool = True, packed: bool = False,
                 max_cycles: int = 1_000_000, device="cuda"):
        if mesh is None:
            mesh = make_data_mesh(data_shards, devices, device=device)
        shards = _check_data_mesh(mesh)
        if resident % shards:
            raise ValueError(
                f"resident={resident} not divisible by "
                f"data_shards={shards}")
        self.mesh = mesh
        self.data_shards = shards
        self.config = config
        self.r = int(resident)
        self.window = int(window)
        self.max_cycles = max_cycles
        self.cycles_per_call = cycles_per_call
        self._stream = stream
        self._rs = self.r // shards
        block = choose_block(self._rs, block)
        self.parts = [CudaLaneSession(
            config, self._rs, window, block=block,
            cycles_per_call=cycles_per_call, gate=gate, stream=stream,
            packed=packed, max_cycles=max_cycles, device=d)
            for d in mesh.devices]
        self.block = self.parts[0].block
        self.fields = self.parts[0].fields
        self._runner = set()

    @property
    def state(self) -> Dict[str, torch.Tensor]:
        """The resident planes on the CPU, joined in lane order."""
        return {f: torch.cat([p.state[f].cpu() for p in self.parts], dim=-1)
                for f in self.fields}

    def _split(self, a: np.ndarray, g: int) -> np.ndarray:
        return a[..., g * self._rs:(g + 1) * self._rs]

    def stage(self, tr_int: np.ndarray, tl_int: np.ndarray):
        """Each shard's slice of the interval's windows, on its device."""
        staged = [p.stage(self._split(tr_int, g), self._split(tl_int, g))
                  for g, p in enumerate(self.parts)]
        return [s[0] for s in staged], [s[1] for s in staged]

    def advance(self, trs, tls) -> _Pending:
        """Every shard's lanes one window, enqueued on its card; returns
        the ORed status word as a pending host copy, not read."""
        for p in self.parts:
            p._gather_harvests()
        self._runner.add(tuple(tuple(t.shape) for t in trs))
        max_calls = max(1, -(-self.max_cycles // self.cycles_per_call))
        p0 = self.parts[0]
        statuses = run_programs(
            self.config, [(p.state, tr, tl)
                          for p, tr, tl in zip(self.parts, trs, tls)],
            stream=self._stream, block=self.block, k=self.cycles_per_call,
            window=self.window, n_seg=1, max_calls=max_calls,
            gate=p0._gate, snapshots=False, packed=p0._packed)
        home = p0.device
        word = statuses[0]
        for x in statuses[1:]:
            word = word | x.to(home)
        if home.type == "cuda":
            host = torch.empty((), dtype=word.dtype, pin_memory=True)
            host.copy_(word, non_blocking=True)
            word = host
        return _Pending(word, _record(home))

    def harvest(self, lane: int):
        g, local = divmod(int(lane), self._rs)
        return g, self.parts[g].harvest(local)

    def barrier(self, perm: np.ndarray, reset: np.ndarray) -> None:
        """The barrier transform, shard by shard; ``perm`` must be
        block-diagonal over the shards (the scheduler's groups)."""
        perm = np.asarray(perm, np.int64)
        reset = np.asarray(reset, bool)
        for g, p in enumerate(self.parts):
            pg = self._split(perm, g) - g * self._rs
            if pg.min(initial=0) < 0 or pg.max(initial=0) >= self._rs:
                raise ValueError(
                    "barrier permutation moves lanes across data shards")
            p.barrier(pg, self._split(reset, g))

    def check(self, status: _Pending) -> None:
        self.parts[0].check(status)

    def compile_counts(self) -> dict:
        out = {}
        for p in self.parts:
            for k, v in p.compile_counts().items():
                out[k] = max(out.get(k, 0), v)
        out["runner"] = len(self._runner)
        return out

    def columns_of(self, cols) -> Dict[str, np.ndarray]:
        g, inner = cols
        return self.parts[g].columns_of(inner)

    def dumps_of(self, cols) -> List[NodeDump]:
        g, inner = cols
        return self.parts[g].dumps_of(inner)

    def counters_of(self, cols) -> dict:
        g, inner = cols
        return self.parts[g].counters_of(inner)


# ---------------------------------------------------------------------------
# the data axis of the general engine: one loop over the shards


class DataShardedRun:
    """The general engine's loops over a batch split into data shards,
    one ``SimState`` a device (``BatchJaxEngine(data_shards=)``, whose
    ``shard_map(vmap(step))`` loop has one global condition).  Every
    cycle reads, in one host read, each shard's terms of the loop
    condition and, under elision, its smallest proposed jump; then every
    shard takes the same branch (the global jump, or a lockstep step).
    So each field of each system, ``cycle`` and ``n_elided`` included,
    equals the unsharded run's.

    ``__call__`` is ``build_run``'s loop to quiescence (``max_cycles``
    and the watchdog as there); :meth:`chunk` is ``ChunkRun``'s bounded
    advance of ``interval`` simulated cycles (no ``max_cycles`` term, a
    jump clamped to the budget)."""

    def __init__(self, config: SystemConfig, max_cycles: int = 1_000_000,
                 watchdog_cycles: int = 0):
        self.config = config
        self.max_cycles = max_cycles
        self.watchdog_cycles = watchdog_cycles
        self.elide = config.elide
        self.step = build_step(config)
        if self.elide:
            self.ff = build_fast_forward(config)
            self.propose = build_propose(config, max_cycles, watchdog_cycles)
            self.propose_chunk = build_propose(config, max_cycles=2**31 - 1)

    def _terms(self, shards: Sequence[SimState], wd: bool, cap: bool,
               propose) -> np.ndarray:
        """[shards, 5] on the host: live any, under max_cycles, no
        overflow, live and fresh any, smallest proposed jump."""
        home = shards[0].pc.device
        rows = []
        for st in shards:
            live = ~quiescent(st)
            t = [live.any(),
                 (st.cycle < self.max_cycles).all() if cap
                 else torch.ones((), dtype=torch.bool, device=st.pc.device),
                 ~st.overflow.any()]
            if wd:
                fresh = (st.cycle - st.last_progress) < self.watchdog_cycles
                t.append((live & fresh).any())
            else:
                t.append(t[0])
            t = [x.to(I32) for x in t]
            t.append(propose(st).min() if propose is not None
                     else torch.zeros((), dtype=I32, device=st.pc.device))
            rows.append(torch.stack(t).to(home))
        return kernels.HOST_SYNCS.read(torch.stack(rows))

    def __call__(self, shards: Sequence[SimState]) -> List[SimState]:
        shards = list(shards)
        prop = self.propose if self.elide else None
        while True:
            g = self._terms(shards, bool(self.watchdog_cycles), True, prop)
            if not (g[:, 0].any() and g[:, 1].all() and g[:, 2].all()
                    and g[:, 3].any()):
                return shards
            j = int(g[:, 4].min())
            shards = [self.ff(st, j) if j > 0 else self.step(st)
                      for st in shards]

    def chunk(self, shards: Sequence[SimState],
              interval: int) -> List[SimState]:
        """Advance by up to ``interval`` simulated cycles or until every
        system of every shard is quiescent (``ChunkRun.run_host``)."""
        shards = list(shards)
        c = 0
        prop = self.propose_chunk if self.elide else None
        while c < interval:
            g = self._terms(shards, False, False, prop)
            if not (g[:, 0].any() and g[:, 2].all()):
                break
            j = min(int(g[:, 4].min()), interval - c)
            if j > 0:
                shards = [self.ff(st, j) for st in shards]
                c += j
            else:
                shards = [self.step(st) for st in shards]
                c += 1
        return shards


class ShardedChunk:
    """``BoundChunk``'s interface over data shards: ``advance()`` splits
    the bound state's rows over the devices, runs
    :meth:`DataShardedRun.chunk` and writes the rows back in place;
    ``status()`` -> (quiescent per row, overflow).  The loop is not
    captured."""

    def __init__(self, config: SystemConfig, interval: int, st: SimState,
                 devices: Sequence[torch.device]):
        self.run = DataShardedRun(config)
        self.interval = max(1, int(interval))
        self.st = st
        self.devices = list(devices)

    def advance(self) -> None:
        new = join_rows(self.run.chunk(split_rows(self.st, self.devices),
                                       self.interval))
        for d, x in zip(self.st, new):
            d.copy_(x)

    def status(self):
        q = kernels.HOST_SYNCS.read(torch.cat([
            quiescent(self.st).to(I32), self.st.overflow.any()[None].to(I32)]))
        return q[:-1].astype(bool), bool(q[-1])


def split_rows(st: SimState, devices: Sequence[torch.device]
               ) -> List[SimState]:
    """A batch split into ``len(devices)`` contiguous row groups, each on
    its device."""
    per = st.pc.shape[0] // len(devices)
    return [SimState(*(x[g * per:(g + 1) * per].to(d) for x in st))
            for g, d in enumerate(devices)]


def join_rows(shards: Sequence[SimState]) -> SimState:
    """Row groups back into one batch, on the first group's device."""
    home = shards[0].pc.device
    return stack_states([SimState(*(x.to(home) for x in s))
                         for s in shards])


# ---------------------------------------------------------------------------
# the node axis of the general engine: SPMD ranks


class NodeShardedRun:
    """One rank's run to quiescence of a node-sharded (or grid) batch:
    the loop of ``build_node_sharded_run`` (JAX l.144-257) on the host.

    Each cycle: the loop condition on the global view (quiescence is a
    MIN over the node group, the batch-global terms a MIN over every
    rank, read on the host once), then the node-sharded step (its
    exchange, one SUM, one MAX) or, under elision, a fast-forward by
    the global minimum of every rank's proposed jump.  ``step_collectives``
    holds the collectives of the last lockstep step and
    ``loop_collectives`` those of one loop test."""

    def __init__(self, config: SystemConfig, comm, max_cycles: int,
                 watchdog_cycles: int):
        self.config = config
        self.comm = comm
        self.max_cycles = max_cycles
        self.watchdog_cycles = watchdog_cycles
        self.step = build_step(config, axis_name=comm, shards=comm.size)
        self.elide = config.elide
        if self.elide:
            self.propose = build_propose(config, max_cycles, watchdog_cycles)
            self.ff = build_fast_forward(
                config, axis_name=comm if comm.size > 1 else None)
        self.steps = 0
        self.jumps = 0
        self.step_collectives: Dict[str, int] = {}
        self.loop_collectives: Dict[str, int] = {}

    def _go(self, st: SimState):
        """(go, jump) on the host, one read."""
        from hpa2_tpu_torch.parallel.comm import COLLECTIVES

        before = COLLECTIVES.snapshot()
        comm = self.comm
        q = quiescent(st).to(I32)
        if comm.size > 1:
            q = comm.all_reduce(q, "min")
        live = q == 0
        t = [1 - live.any().to(I32),
             (st.cycle < self.max_cycles).all().to(I32),
             (~st.overflow.any()).to(I32)]
        if self.watchdog_cycles:
            fresh = (st.cycle - st.last_progress) < self.watchdog_cycles
            t.append(1 - (live & fresh).any().to(I32))
        else:
            t.append(t[0])
        t.append(self.propose(st).min().to(I32) if self.elide
                 else torch.zeros((), dtype=I32, device=st.pc.device))
        g = kernels.HOST_SYNCS.read(
            comm.all_reduce(torch.stack(t), "min", world=True))
        after = COLLECTIVES.snapshot()
        self.loop_collectives = {k: after[k] - before[k] for k in after}
        go = g[0] == 0 and g[1] == 1 and g[2] == 1 and g[3] == 0
        return go, int(g[4])

    def __call__(self, st: SimState) -> SimState:
        from hpa2_tpu_torch.parallel.comm import COLLECTIVES

        self.steps = self.jumps = 0
        while True:
            go, j = self._go(st)
            if not go:
                return st
            if self.elide and j > 0:
                st = self.ff(st, j)
                self.jumps += 1
            else:
                before = COLLECTIVES.snapshot()
                st = self.step(st)
                after = COLLECTIVES.snapshot()
                self.step_collectives = {k: after[k] - before[k]
                                         for k in after}
            self.steps += 1


def build_node_sharded_run(config: SystemConfig, comm,
                           max_cycles: int = 1_000_000,
                           watchdog_cycles: int = 0) -> NodeShardedRun:
    """This rank's run loop over its node group ``comm`` (JAX
    ``build_node_sharded_run``, l.144)."""
    return NodeShardedRun(config, comm, max_cycles, watchdog_cycles)


def _check_node_config(config: SystemConfig, node: int, what: str) -> None:
    if config.interconnect.enabled:
        raise ValueError(
            "non-ideal interconnect topologies run single-shard only; "
            f"the {what} composes with topology='ideal'")
    if config.num_procs % node != 0:
        raise ValueError(
            f"num_procs={config.num_procs} not divisible by node "
            f"shards={node}")


def _rank_device(mesh: Mesh) -> torch.device:
    if mesh.device == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _rank_run(jobs: Sequence[dict]) -> List[dict]:
    """One rank's share of node-sharded runs, each job an engine's spec
    with the module-level function that runs it on a rank."""
    return [job["rank_fn"](job) for job in jobs]


def _rank_general(job: dict) -> dict:
    """A general engine's job on this rank: its block of the initial
    state, the SPMD loop, and its block back as numpy with the run's
    counts."""
    from hpa2_tpu_torch.convert import sim_state_to_numpy
    from hpa2_tpu_torch.parallel.comm import world_comm

    mesh = job["mesh"]
    comm, row = world_comm(mesh.node, mesh.data)
    dev = _rank_device(mesh)
    full = job["state"]
    per = full.pc.shape[0] // mesh.data
    rows = SimState(*(x[row * per:(row + 1) * per] for x in full))
    st = SimState(*(x.to(dev) for x in
                    node_block(rows, comm.rank, mesh.node)))
    run = build_node_sharded_run(job["config"], comm, job["max_cycles"],
                                 job["watchdog_cycles"])
    if job["warmup"]:
        run(SimState(*(x.clone() for x in st)))
    syncs0 = kernels.HOST_SYNCS.mine
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    st = run(st)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return dict(
        state=sim_state_to_numpy(st), steps=run.steps, jumps=run.jumps,
        step_collectives=run.step_collectives,
        loop_collectives=run.loop_collectives, seconds=secs,
        host_syncs=kernels.HOST_SYNCS.mine - syncs0)


def run_node_sharded(engines: Sequence, warmup: bool = False,
                     pool=None, cycle: Optional[str] = None) -> None:
    """Run several node-sharded engines of one mesh size in one group of
    ranks (one spawn: a rank costs seconds to start), in ``pool`` (a
    ``parallel/launch.py:RankPool`` of that size that the caller keeps,
    such as a serving session's), or in place when this process is a
    rank of a ``torchrun`` group already: the general engine's
    (:class:`NodeShardedEngine`, :class:`GridEngine`) and the fast
    path's (:class:`NodeShardedCudaEngine`).  With ``warmup`` each rank
    runs each loop once untimed first, so that ``seconds`` (the second
    run's) leaves out the rank's one-time costs: its CUDA context, the
    NCCL communicators made at their first collective.  ``cycle``
    ("kernel" or "tensor") overrides the fast-path engines' node cycle
    for this run.  A mesh made with ``make_mesh(..., local=True)`` runs
    its ranks as threads of this process (``parallel/comm.py:
    LocalComm``) on one device.  Raises the first engine's stall."""
    from hpa2_tpu_torch.parallel.launch import join_torchrun, pool_for

    sizes = {(e.mesh.size, e.mesh.local) for e in engines}
    devs = {e.mesh.device for e in engines}
    if len(sizes) != 1 or len(devs) != 1:
        raise ValueError("run_node_sharded runs engines of one mesh size "
                         "and device type together")
    (size, _), device = sizes.pop(), devs.pop()
    if cycle is not None:
        for e in engines:
            if hasattr(e, "node_cycle"):
                e.node_cycle = cycle
    jobs = [dict(e._job(), warmup=warmup) for e in engines]
    if pool is not None:
        if pool.world != size or pool.device.type != device or (
                getattr(pool, "local", False) != engines[0].mesh.local):
            raise ValueError(
                f"a pool of {pool.world} {pool.device.type} ranks cannot "
                f"run meshes of {size} {device} ranks")
        every = pool.run(_rank_run, (jobs,))
    elif not engines[0].mesh.local and join_torchrun(device):
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, _rank_run(jobs))
    else:
        with pool_for(engines[0].mesh) as p:
            every = p.run(_rank_run, (jobs,))
    for i, e in enumerate(engines):
        e._gather([rank[i] for rank in every])
    for e in engines:
        e._check()


class _NodeShardedBase:
    """What :class:`NodeShardedEngine` and :class:`GridEngine` share: the
    spec a rank runs, and the gathered state."""

    mesh: Mesh
    config: SystemConfig
    max_cycles: int
    watchdog_cycles: int
    _init: SimState

    def _job(self) -> dict:
        return dict(rank_fn=_rank_general, config=self.config,
                    mesh=self.mesh, state=self._init,
                    max_cycles=self.max_cycles,
                    watchdog_cycles=self.watchdog_cycles)

    def _gather(self, blocks: Sequence[dict]) -> None:
        """Every rank's block of the state (rank order) as the caller's
        state, and the ranks' counts."""
        from hpa2_tpu_torch.convert import sim_state_from_numpy

        self.state = sim_state_from_numpy(
            join_blocks([b["state"] for b in blocks], self.mesh.node),
            device="cpu")
        self.rank_stats = [{k: v for k, v in b.items() if k != "state"}
                           for b in blocks]

    @property
    def step_collectives(self) -> Dict[str, int]:
        """The collectives of one lockstep cycle (rank 0's count)."""
        return self.rank_stats[0]["step_collectives"]


class NodeShardedEngine(_NodeShardedBase):
    """One system with its node axis sharded over ``node_shards`` ranks
    (JAX ``NodeShardedEngine``, l.264-370): each rank holds ``num_procs
    / node_shards`` nodes and mail crosses ranks through the targeted
    exchange.  ``run()`` starts the ranks (``parallel/launch.py``; in a
    ``torchrun`` group it runs in place on every rank), runs the SPMD
    loop, and gathers every rank's node block back as the caller's
    ``state`` (on the CPU), so the accessors are ``JaxEngine``'s.
    ``rank_stats`` holds each rank's steps, jumps, collectives a cycle,
    host reads and seconds.  On the card each rank takes its own card
    (NCCL), so ``node_shards`` cards are needed."""

    def __init__(self, config: SystemConfig,
                 traces: Sequence[Sequence[Instr]],
                 mesh: Optional[Mesh] = None,
                 node_shards: Optional[int] = None,
                 max_cycles: int = 1_000_000,
                 watchdog_cycles: int = 10_000, device="cuda"):
        if mesh is None:
            if node_shards is None:
                node_shards = (torch.cuda.device_count()
                               if torch.device(device).type == "cuda" else 1)
            mesh = make_mesh(node_shards=node_shards, data_shards=1,
                             device=device)
        if mesh.data != 1:
            raise ValueError(
                f"NodeShardedEngine runs one system on a 1 x node mesh, "
                f"got {mesh.data} x {mesh.node}; GridEngine shards an "
                "ensemble")
        _check_node_config(config, mesh.node, "node sharding")
        self.config = config
        self.mesh = mesh
        self.max_cycles = max_cycles
        self.watchdog_cycles = watchdog_cycles
        self._init = init_state(config, traces, device="cpu")
        self.state = self._init
        self.rank_stats: List[dict] = []

    def run(self, warmup: bool = False) -> "NodeShardedEngine":
        """Run to quiescence on the ranks (``warmup``: an untimed run
        first, for ``rank_stats``' seconds)."""
        run_node_sharded([self], warmup=warmup)
        return self

    def _check(self) -> None:
        st = self.state
        if bool(st.overflow[0]):
            raise StallError(
                "internal invariant violated: mailbox overflow despite "
                "backpressure")
        if not bool(quiescent(st)[0]):
            cycle = int(st.cycle[0])
            stalled_for = cycle - int(st.last_progress[0])
            if (self.watchdog_cycles and cycle < self.max_cycles
                    and stalled_for >= self.watchdog_cycles):
                from hpa2_tpu_torch.ops.engine import stall_diagnostic

                raise stall_diagnostic(
                    self.config, st,
                    "watchdog: no instruction retired and no mailbox "
                    f"drained for {stalled_for} cycles")
            raise StallError(
                f"no quiescence after {cycle} cycles (livelock?)")

    def snapshots(self) -> List[NodeDump]:
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
        out = engine_stats(self.state)
        sent = int(self.state.n_exch_sent.sum())
        if sent:
            # every shipped exchange entry is one [10 + sharer_words +
            # 1]-row int32 column (the payload and the combining key)
            rows = 10 + self.config.sharer_words + 1
            out["exchange_bytes_per_cycle"] = round(
                sent * rows * 4 / max(self.cycle, 1), 2)
        return out


class GridEngine(_NodeShardedBase):
    """An ensemble of node-sharded systems over a ``(data, node)`` mesh
    (JAX ``GridEngine``, l.373-440): rank ``d * node + i`` holds node
    block ``i`` of data row ``d``'s systems; the exchange runs in each
    row's node group and the loop condition over every rank."""

    def __init__(self, config: SystemConfig,
                 batch_traces: Sequence[Sequence[Sequence[Instr]]],
                 mesh: Optional[Mesh] = None, max_cycles: int = 1_000_000,
                 device="cuda"):
        if mesh is None:
            mesh = make_mesh(node_shards=1, device=device)
        _check_node_config(config, mesh.node, "grid engine")
        b = len(batch_traces)
        if b % mesh.data != 0:
            raise ValueError(
                f"batch {b} not divisible by data shards {mesh.data}")
        self.config = config
        self.mesh = mesh
        self.max_cycles = max_cycles
        self.watchdog_cycles = 0
        max_t = max((len(tr) for traces in batch_traces for tr in traces),
                    default=1)
        self._init = stack_states([
            init_state(config, t, max_trace_len=max_t, device="cpu")
            for t in batch_traces])
        self.state = self._init
        self.rank_stats = []

    def run(self, warmup: bool = False) -> "GridEngine":
        run_node_sharded([self], warmup=warmup)
        return self

    def _check(self) -> None:
        st = self.state
        if bool(st.overflow.any()):
            raise StallError(
                "internal invariant violated: mailbox overflow despite "
                "backpressure")
        if not bool(quiescent(st).all()):
            raise StallError("batch did not reach quiescence (livelock?)")

    def system_snapshots(self, b: int) -> List[NodeDump]:
        return _dumps(self.config, _snap_arrays(self.state, b))

    def system_final_dumps(self, b: int) -> List[NodeDump]:
        return _dumps(self.config, _live_arrays(self.state, b))

    @property
    def instructions(self) -> int:
        return int(self.state.n_instr.sum())


# ---------------------------------------------------------------------------
# the node axis of the fast path: SPMD ranks around K1's node-sharded
# variant (JAX l.791-1522)

def _pallas_exchange_stats(config: SystemConfig, state) -> dict:
    """The exchange telemetry from the transient rows (JAX l.819-848):
    keys only when nonzero.  Every shipped entry is one ``[W + SW +
    3]``-row int32 column (the candidate words, the INV fan-mask words,
    recv/isa/ckey)."""
    def a(f):
        return np.asarray(state[f])

    out = {}
    sent = int(a("xmsgs").astype(np.int64).sum())
    if sent:
        out["exchange_sent"] = sent
        rows = _mb_layout(config)[1] + _sharer_words(config) + 3
        cyc = int(a("scalars")[_SC_CYCLE].max())
        out["exchange_bytes_per_cycle"] = round(
            sent * rows * 4 / max(cyc, 1), 2)
    hwm = int(a("exchhw").max())
    if hwm:
        out["exchange_slot_hwm"] = hwm
    mc = int(a("exchmc").astype(np.int64).sum())
    if mc:
        out["exchange_multicast_saved"] = mc
    cb = int(a("exchcb").astype(np.int64).sum())
    if cb:
        out["exchange_combined"] = cb
    return out


def _exchange_overflow_error(dg: int, dc: int, exchange_slots) -> StallError:
    """The maxima of the worst-overflow words as a message naming the
    cycle, the shard pair and the demand against the slots (JAX
    l.851-870; both words lead with the demand, so the two maxima
    describe one event)."""
    detail = ""
    if dg > 0:
        demand = dg >> 16
        more = "+" if demand >= 0xFFFF else ""
        detail = (
            f" — worst cycle {dc & 0xFFFF}: shard "
            f"{(dg >> 8) & 0xFF} -> {dg & 0xFF} demanded "
            f"{demand}{more} slots")
    return StallError(
        "cross-shard exchange overflow: a cycle had more out-bound "
        "candidates for one peer shard than "
        f"exchange_slots={exchange_slots}; raise it (the "
        f"capacity-exact default never overflows){detail}")


def _node_leading(key: str) -> bool:
    """Does a fast-path plane split its leading (node) axis over the
    node ranks (JAX ``_node_plane_spec``, l.873-880)?  ``scalars``,
    ``msg_counts`` and the transient rows are whole on every rank."""
    return key not in ("scalars", "msg_counts") and \
        key not in TRANSIENTS


def _node_local(planes, i: int, nl: int, lanes: slice, device) -> dict:
    """Node block ``i`` (``nl`` rows) of ``planes``' lanes ``lanes``, on
    ``device``."""
    out = {}
    for f, v in planes.items():
        v = torch.as_tensor(v)
        if _node_leading(f):
            v = v[i * nl:(i + 1) * nl]
        out[f] = v[..., lanes].contiguous().to(device)
    return out


def _join_node_planes(blocks: Sequence[Dict[str, np.ndarray]],
                      node: int) -> Dict[str, np.ndarray]:
    """A ``data x node`` grid of ranks' planes (rank order) as the
    ensemble's: node blocks joined on the leading axis, data rows on the
    lane axis, the whole planes from each row's first rank."""
    rows = []
    for d in range(len(blocks) // node):
        row = blocks[d * node:(d + 1) * node]
        rows.append({f: (np.concatenate([b[f] for b in row], axis=0)
                         if _node_leading(f) else row[0][f])
                     for f in row[0]})
    return {f: np.concatenate([r[f] for r in rows], axis=-1)
            for f in rows[0]}


class NodeInterval:
    """One rank's run program (JAX ``_make_node_pallas_interval``,
    l.883-990, and ``build_node_sharded_pallas_run``, l.994): ``(planes,
    transients, tr_full, tr_len_full, n_seg) -> status`` around K1's
    node-sharded variant, with its loop on this rank's host.

    For each of ``n_seg`` trace windows: the pc field is reset, ``activeg``
    is seeded with one SUM of the local activity over the node group,
    and the gate (one MAX over every rank of ``any(activeg > 0)``, read
    on the host) opens; while it is open and fewer than ``max_calls``
    calls have run over the whole run, ``k`` cycles run and the gate is
    taken again.  So a k-cycle call costs one host read
    (``kernels.HOST_SYNCS``), and a cycle issues its plan's exchange
    collectives, one SUM and one MAX and nothing else.  Cycles past
    quiescence change no value (``_SC_CYCLE`` accrues the previous
    cycle's ``min(activeg, 1)``), so taking the gate once every ``k``
    cycles stays bit-exact.  The status word is bit 0 stall, bit 1
    mailbox overflow, bit 2 exchange overflow.

    The cycle is ``ops/node_cycle.py:NodeCycle``: its four kernels on
    the card, their plain versions on the CPU, and with ``cycle="tensor"``
    the plain versions on the card too.  ``check_calls``: the launches of
    the first that many k-cycle calls of the program's life are each
    held against their plain version on the same inputs (``checked``).

    ``census`` holds the collectives of the last cycle, of a window's
    seed (with its first gate) and of a later gate; ``cycles`` and
    ``seconds`` the cycles run and their host time; ``launches`` the
    kernel launches by kernel."""

    def __init__(self, config: SystemConfig, comm, snapshots: bool,
                 window: int, k: int, max_calls: int,
                 exchange_slots: Optional[int] = None,
                 packed: bool = False, cycle: str = "kernel",
                 check_calls: int = 0):
        self.config = config
        self.comm = comm
        self.window = window
        self.k = k
        self.max_calls = max_calls
        self.check_calls = check_calls
        self.checked_calls = 0
        self.cycle = build_cycle(config, snapshots, packed, axis_name=comm,
                                 shards=comm.size,
                                 exchange_slots=exchange_slots, cycle=cycle)
        self.slsc = _scalar_layout(config, window)
        self.census: Dict[str, Dict[str, int]] = {}
        self.cycles = 0
        self.calls = 0

    @property
    def launches(self) -> Dict[str, int]:
        return dict(self.cycle.launches)

    @property
    def checked(self) -> Dict[str, list]:
        return {f: list(v) for f, v in self.cycle.checked.items()}

    def _activity(self, st, tl) -> torch.Tensor:
        sl = self.slsc
        nsw = st["nsw"]
        pc = (nsw >> sl["off_pc"]) & sl["pc_mask"]
        waiting = (nsw >> sl["off_wait"]) & 1
        cnt = nsw & sl["count_mask"]
        dv = deferred_valid(self.config, st)
        return ((tl - pc).clamp(min=0).sum(0, dtype=I32)
                + waiting.sum(0, dtype=I32) + cnt.sum(0, dtype=I32)
                + dv.sum((0, 1), dtype=I32))[None]

    def _gate(self, st) -> bool:
        live = (st["activeg"] > 0).any().to(I32)[None]
        return bool(kernels.HOST_SYNCS.read(
            self.comm.all_reduce(live, "max", world=True))[0])

    def __call__(self, planes: Dict[str, torch.Tensor],
                 trans: Dict[str, torch.Tensor], tr_full: torch.Tensor,
                 tr_len_full: torch.Tensor, n_seg: int = 1) -> int:
        """Run ``planes`` (updated in place in the dict, with ``trans``)
        through the ``n_seg`` windows; returns the status word."""
        from hpa2_tpu_torch.parallel.comm import COLLECTIVES

        def counted(before):
            after = COLLECTIVES.snapshot()
            return {f: after[f] - before[f] for f in after}

        sl, w, comm = self.slsc, self.window, self.comm
        st = {**planes, **trans}
        stalled = False
        calls = 0
        for si in range(n_seg):
            tl_seg = (tr_len_full - si * w).clamp(0, w)
            st["nsw"] = st["nsw"] & ~(sl["pc_mask"] << sl["off_pc"])
            before = COLLECTIVES.snapshot()
            st["activeg"] = comm.all_reduce(self._activity(st, tl_seg),
                                            "sum")
            go = self._gate(st)
            self.census["seed"] = counted(before)
            while go and calls < self.max_calls:
                self.cycle.check = self.checked_calls < self.check_calls
                self.checked_calls += self.cycle.check
                full = {**st, "tr": tr_full, "tr_len": tr_len_full}
                for _ in range(self.k):
                    before = COLLECTIVES.snapshot()
                    full = self.cycle(full, si, w)
                    self.census["cycle"] = counted(before)
                st = {f: full[f] for f in st}
                calls += 1
                self.cycles += self.k
                before = COLLECTIVES.snapshot()
                go = self._gate(st)
                self.census["gate"] = counted(before)
            stalled = stalled or go
        self.calls += calls
        self.cycle.check = False
        for d in (planes, trans):
            for f in d:
                d[f] = st[f]
        flags = kernels.HOST_SYNCS.read(torch.stack([
            (st["scalars"][_SC_OVERFLOW] > 0).any(),
            (st["exchov"] > 0).any()]).to(I32))
        return int(stalled) | (int(flags[0]) << 1) | (int(flags[1]) << 2)


def build_node_fused_pallas_run(config: SystemConfig, comm, plan, *,
                                r_shard: int, bsys_shard: int, k: int,
                                window: int, nseg_max: int, max_calls: int,
                                exchange_slots: Optional[int] = None,
                                packed: bool = False, cycle: str = "kernel",
                                check_calls: int = 0):
    """This rank's fused scheduled run (JAX ``build_node_fused_pallas_run``,
    l.1053-1177): ``(init, tr_full, tr_len_full) -> (store, transients,
    status)`` over the plan rows of this rank's data shard (``plan`` a
    dict of ``sys``/``seg``/``perm``/``reset`` ``[intervals, r_shard]``
    tensors, rebased to the shard).  The admission-reset init is the
    initial state operand (a node block's memory plane differs by row);
    the transient rows ride the loop untouched by the barrier
    (``activeg`` is reseeded every interval, the rest accumulate over
    the run, whatever lane a job sat on); each interval's lanes are
    scattered to their systems' columns of a store with one trash
    column, as ``CudaEngine``'s fused run does."""
    program = NodeInterval(config, comm, False, window, k, max_calls,
                           exchange_slots, packed, cycle, check_calls)
    ident = torch.arange(r_shard)

    def run(init, tr_full, tr_len_full):
        dev = tr_full.device
        nl = tr_full.shape[0]
        st = {f: v.clone() for f, v in init.items()}
        trans = {f: torch.zeros((1, r_shard), dtype=I32, device=dev)
                 for f in TRANSIENTS}
        trf = tr_full.view(nl, nseg_max, window, bsys_shard).permute(
            1, 3, 0, 2).reshape(nseg_max * bsys_shard, nl, window)
        store = {f: torch.zeros(tuple(v.shape[:-1]) + (bsys_shard + 1,),
                                dtype=v.dtype, device=dev)
                 for f, v in init.items()}
        rows = {f: v.to(dev) for f, v in plan.items()}
        trivial = ((~plan["reset"].any(1))
                   & (plan["perm"] == ident).all(1)).tolist()
        status = 0
        for i in range(len(trivial)):
            if not trivial[i]:
                barrier_(st, init, rows["perm"][i], rows["reset"][i])
            sys_i, seg_i = rows["sys"][i], rows["seg"][i]
            sysc = sys_i.clamp(0, bsys_shard - 1)
            gidx = seg_i.clamp(0, nseg_max - 1) * bsys_shard + sysc
            tr_i = trf.index_select(0, gidx).permute(1, 2, 0).contiguous()
            tl_i = torch.where(
                sys_i >= 0,
                (tr_len_full.index_select(1, sysc)
                 - seg_i[None, :] * window).clamp(0, window),
                0).to(I32)
            status |= program(st, trans, tr_i, tl_i, n_seg=1)
            tgt = torch.where(sys_i >= 0, sys_i, bsys_shard).long()
            for f, v in st.items():
                _signed(store[f]).index_copy_(-1, tgt, _signed(v))
        return ({f: v[..., :bsys_shard] for f, v in store.items()}, trans,
                status)

    run.program = program
    return run


def _check_cycle_name(cycle: str) -> None:
    from hpa2_tpu_torch.ops.node_cycle import CYCLES

    if cycle not in CYCLES:
        raise ValueError(f"cycle={cycle!r}: one of {CYCLES}")


def _rank_fast(job: dict) -> dict:
    """A :class:`NodeShardedCudaEngine`'s job on this rank."""
    from hpa2_tpu_torch.parallel.comm import world_comm

    eng = job["engine"]
    comm, row = world_comm(eng.mesh.node, eng.mesh.data)
    return eng._rank_run(comm, row, _rank_device(eng.mesh), job["warmup"])


class NodeShardedCudaEngine(CudaEngine):
    """The fast path with the NODE axis sharded over ranks (JAX
    ``NodeShardedPallasEngine``, l.1180-1364): one system bigger than a
    card, or an ensemble of them over a ``(data, node)`` mesh, each
    system's node planes split into contiguous blocks, one a rank.

    Phase C crosses ranks through the targeted exchange of
    ``ops/exchange.py``, at a cost that grows with the candidates that
    cross (bounded by ``exchange_slots``).  The cycle is K1's
    node-sharded variant, ``ops/node_cycle.py:NodeCycle``: four kernels
    on the card (N1-N4, the register instantiations up to 64 nodes and
    the wide family above; at most 16 node shards) and their plain
    versions on the CPU; ``cycle="tensor"`` names the plain versions on
    the card too.  Its loop is
    :class:`NodeInterval` on each rank's host.  ``run()`` starts the ranks through
    ``parallel/launch.py`` (one spawn a run, or in place under
    ``torchrun``) and gathers every rank's block back, so ``state``,
    ``cycle``, ``instructions``, ``messages``, ``stats()`` (with the
    ``exchange_*`` keys) and the dumps are ``CudaEngine``'s and equal
    the one-card run's, under the fused scheduler and packed planes
    too.  ``cross_shard_msgs`` counts the entries shipped;
    ``rank_stats`` holds each rank's cycles, seconds, host reads and
    collectives.

    ``exchange_slots`` caps a peer's buffer (default the capacity-exact
    ``5 * n_local``); a tighter cap fails the whole run loudly with a
    ``StallError`` that names the worst cycle, shard pair and demand.
    ``stream``, ``gate`` and the block do not apply to this path (the
    block is still chosen and checked, as JAX does).  On the card each
    rank takes a card (NCCL): ``node_shards x data_shards`` cards, or
    with ``make_mesh(..., local=True)`` every rank is a thread of this
    process on one device (``parallel/comm.py:LocalComm``).
    ``_check_calls``: the kernel launches of each rank's first that many
    k-cycle calls are held against their plain versions
    (``rank_stats[r]["checked"]``)."""

    def __init__(self, config: SystemConfig, tr_op: np.ndarray,
                 tr_addr: np.ndarray, tr_val: np.ndarray,
                 tr_len: np.ndarray, node_shards: Optional[int] = None,
                 data_shards: int = 1, mesh: Optional[Mesh] = None,
                 exchange_slots: Optional[int] = None, block: int = 1024,
                 device="cuda", cycle: str = "kernel",
                 _check_calls: int = 0, **kwargs):
        if mesh is None:
            if node_shards is None:
                raise ValueError("pass node_shards or an explicit mesh")
            mesh = make_mesh(node_shards=node_shards,
                             data_shards=data_shards, device=device)
        if not isinstance(mesh, Mesh):
            raise ValueError(
                "need a ('data', 'node') mesh, got "
                f"{getattr(mesh, 'axis_names', type(mesh).__name__)}")
        node_shards, data_shards = mesh.node, mesh.data
        if node_shards < 2:
            raise ValueError(
                "node_shards=1 is the unsharded fast path — use "
                "CudaEngine / DataShardedCudaEngine")
        _check_cycle_name(cycle)
        if config.num_procs % node_shards != 0:
            raise ValueError(
                f"num_procs={config.num_procs} not divisible by node "
                f"shards={node_shards}")
        b = tr_op.shape[0]
        if b % data_shards != 0:
            raise ValueError(
                f"batch {b} not divisible by data_shards={data_shards}")
        if kwargs.get("_ablate"):
            raise ValueError("--ablate is single-node-shard only")
        sched = kwargs.get("schedule")
        if sched is not None:
            if not sched.fused:
                raise NotImplementedError(
                    "node-sharded fast path supports the fused occupancy "
                    "scheduler only (Schedule(fused=True)); the "
                    "host-barrier loop would round-trip the sharded "
                    "planes every interval")
            resident = sched.resident or b
            if resident % data_shards:
                raise ValueError(
                    f"schedule.resident={resident} not divisible by "
                    f"data_shards={data_shards}")
            block = choose_block(resident // data_shards, block)
        else:
            block = choose_block(b // data_shards, block)
        # the caller keeps the planes on its CPU; each rank takes its
        # block to its own device
        super().__init__(config, tr_op, tr_addr, tr_val, tr_len,
                         block=block, device="cpu", **kwargs)
        self.mesh = mesh
        # the ranks' device type (the gathered planes stay on the CPU)
        self.device = torch.device(mesh.device)
        self.node_shards = node_shards
        self.data_shards = data_shards
        self._shard_b = b // data_shards
        self._exchange_slots = exchange_slots
        self.node_cycle = cycle
        self._check_calls = _check_calls
        self._sched_groups = data_shards
        self.max_cycles = 1_000_000
        for f in TRANSIENTS:
            self.state[f] = torch.zeros((1, b), dtype=I32)
        self.rank_stats: List[dict] = []
        self._status = 0

    @property
    def cross_shard_msgs(self) -> int:
        """Exchange entries shipped across node shards over the run,
        summed over lanes (an entry bound for several peers counts once
        a peer)."""
        return int(self.state["xmsgs"].to(torch.int64).sum())

    def _job(self) -> dict:
        return dict(rank_fn=_rank_fast, engine=self)

    def __getstate__(self) -> dict:
        # a rank builds its block of the initial planes itself: only the
        # traces travel to it
        out = dict(self.__dict__)
        out.pop("state", None)
        return out

    def run(self, max_cycles: int = 1_000_000,
            warmup: bool = False) -> "NodeShardedCudaEngine":
        """Run to quiescence on the ranks (``warmup``: an untimed run
        first in the same ranks, for :attr:`rank_stats`' seconds)."""
        if self._completed:
            return self
        if self._poisoned:
            raise StallError(
                "engine state is mid-flight after a failed run; "
                "rebuild the engine to retry")
        self.max_cycles = max_cycles
        run_node_sharded([self], warmup=warmup)
        return self

    def _fused_plan_arrays(self, plan) -> Dict[str, torch.Tensor]:
        """The plan rows of every data shard, rebased to the shard's own
        lanes and systems (JAX l.1311-1330); rows replicate over
        node."""
        shards = self.data_shards
        gl = self._resident // shards
        gs = self.b // shards
        g = np.arange(self._resident, dtype=np.int64) // gl
        return dict(
            sys=torch.from_numpy(np.where(
                plan.sys >= 0, plan.sys - g[None, :] * gs, -1
            ).astype(np.int32)),
            seg=torch.from_numpy(np.asarray(plan.seg, np.int32)),
            perm=torch.from_numpy(
                (plan.perm - g[None, :] * gl).astype(np.int64)),
            reset=torch.from_numpy(np.asarray(plan.reset) != 0))

    def _rank_run(self, comm, row: int, dev: torch.device,
                  warmup: bool) -> dict:
        """This rank's share of the run: its node block of its data
        row's lanes, the run program, and its block back as numpy with
        the status word and the rank's counts."""
        from hpa2_tpu_torch.parallel.comm import COLLECTIVES

        nl = self.config.num_procs // self.node_shards
        node = slice(comm.rank * nl, (comm.rank + 1) * nl)
        lanes = slice(row * self._shard_b, (row + 1) * self._shard_b)
        tr = self._tr_full[node][..., lanes].contiguous().to(dev)
        tl = self._tr_len_full[node][..., lanes].contiguous().to(dev)
        max_calls = max(1, -(-self.max_cycles // self.cycles_per_call))
        kw = dict(k=self.cycles_per_call, window=self._window,
                  max_calls=max_calls, exchange_slots=self._exchange_slots,
                  packed=self._packed, cycle=self.node_cycle,
                  check_calls=self._check_calls)
        if self.schedule is not None:
            groups = self.data_shards
            plan = build_plan(self._nseg, **_schedule_kw(
                self.schedule, self._resident, self.block, groups))
            gl = self._resident // groups
            cols = slice(row * gl, (row + 1) * gl)
            rows = {f: v[:, cols] for f, v in
                    self._fused_plan_arrays(plan).items()}
            init = _node_local(
                _init_state(self.config, gl, False, self._packed),
                comm.rank, nl, slice(None), dev)
            program = build_node_fused_pallas_run(
                self.config, comm, rows, r_shard=gl,
                bsys_shard=self._shard_b, nseg_max=self._n_seg, **kw)

            def once():
                return program(init, tr, tl)
            counted = program.program
        else:
            start = _node_local(
                _init_state(self.config, self._shard_b, self._snapshots,
                            self._packed),
                comm.rank, nl, slice(None), dev)
            program = NodeInterval(self.config, comm,
                                   snapshots=self._snapshots, **kw)

            def once():
                planes = {f: v.clone() for f, v in start.items()}
                trans = {f: torch.zeros((1, self._shard_b), dtype=I32,
                                        device=dev)
                         for f in TRANSIENTS}
                status = program(planes, trans, tr, tl, n_seg=self._n_seg)
                return planes, trans, status
            counted = program
        if warmup:
            once()
        counted.cycles = counted.calls = 0
        counted.cycle.launches = dict.fromkeys(counted.cycle.launches, 0)
        syncs0 = kernels.HOST_SYNCS.mine
        coll0 = COLLECTIVES.snapshot()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        planes, trans, status = once()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        coll1 = COLLECTIVES.snapshot()
        planes.update(trans)
        return dict(
            planes={f: v.cpu().numpy() for f, v in planes.items()},
            status=status, cycles=counted.cycles, calls=counted.calls,
            seconds=secs, host_syncs=kernels.HOST_SYNCS.mine - syncs0,
            collectives={f: coll1[f] - coll0[f] for f in coll1},
            census=dict(counted.census), launches=counted.launches,
            checked=counted.checked)

    def _gather(self, blocks: Sequence[dict]) -> None:
        joined = _join_node_planes([b["planes"] for b in blocks],
                                   self.node_shards)
        self.state = {f: torch.from_numpy(np.ascontiguousarray(v))
                      for f, v in joined.items()}
        self._status = 0
        for b in blocks:
            self._status |= b["status"]
        self.rank_stats = [{k: v for k, v in b.items() if k != "planes"}
                           for b in blocks]

    def _check(self) -> None:
        self._check_status(self._status, self.max_cycles)
        if self.schedule is not None:
            plan = build_plan(self._nseg, **_schedule_kw(
                self.schedule, self._resident, self.block,
                self.data_shards))
            self.occupancy = plan.stats
        self._completed = True

    def _check_status(self, status: int, max_cycles: int) -> None:
        if status & 4:
            self._poisoned = True
            st = self.state
            raise _exchange_overflow_error(
                int(st["exchdg"].max()), int(st["exchdc"].max()),
                self._exchange_slots)
        super()._check_status(status, max_cycles)

    @property
    def step_collectives(self) -> Dict[str, int]:
        """The collectives of one cycle (rank 0's count)."""
        return self.rank_stats[0]["census"].get("cycle", {})

    def stats(self) -> dict:
        out = super().stats()
        out.update(_pallas_exchange_stats(self.config, self.state))
        return out


def _rank_profile(job: dict) -> dict:
    """A :class:`NodeProfile`'s job on this rank: a warm k-cycle call on
    its node block of the engine's first window, then one on fresh
    planes under ``torch.profiler``.  Logical ranks share a process, so
    rank 0 alone profiles (CUDA activity is the process's: every rank's
    kernels)."""
    from torch.profiler import ProfilerActivity, profile

    from hpa2_tpu_torch.ops import node_cycle
    from hpa2_tpu_torch.parallel.comm import LocalComm, world_comm

    eng = job["engine"]
    cfg = eng.config
    comm, row = world_comm(eng.mesh.node, eng.mesh.data)
    dev = _rank_device(eng.mesh)
    nl = cfg.num_procs // comm.size
    node = slice(comm.rank * nl, (comm.rank + 1) * nl)
    lanes = slice(row * eng._shard_b, (row + 1) * eng._shard_b)
    tr = eng._tr_full[node][:, :eng._window][..., lanes].contiguous().to(dev)
    tl = eng._tr_len_full[node][..., lanes].clamp(
        max=eng._window).contiguous().to(dev)

    def fresh():
        st = _node_local(_init_state(cfg, eng._shard_b, False, eng._packed),
                         comm.rank, nl, slice(None), dev)
        trans = {f: torch.zeros((1, eng._shard_b), dtype=I32, device=dev)
                 for f in TRANSIENTS}
        return NodeInterval(cfg, comm, False, eng._window, job["k"], 1,
                            packed=eng._packed, cycle=eng.node_cycle), \
            st, trans

    prog, st, trans = fresh()
    prog(st, trans, tr, tl)
    prog, st, trans = fresh()
    on = not isinstance(comm, LocalComm) or comm.rank == 0
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    comm.barrier()
    prof = profile(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) if on else None
    if prof is not None:
        prof.__enter__()
    comm.barrier()
    prog(st, trans, tr, tl)
    sync()
    comm.barrier()
    out = dict(planes={}, status=0, cycles=prog.cycles, kernels=None)
    if prof is not None:
        prof.__exit__(None, None, None)
        events = prof.events()
        ran = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
        out.update(kernels=len(ran),
                   nccl=sum(1 for e in ran if "nccl" in e.name.lower()),
                   device_us=sum(e.time_range.elapsed_us() for e in ran
                                 if "nccl" not in e.name.lower()),
                   node_us={k.name: sum(e.time_range.elapsed_us()
                                        for e in ran
                                        if _is_node_kernel(k, e.name))
                            for k in node_cycle.ALL_NODE_KERNELS},
                   launch_calls=sum(1 for e in events if e.name in (
                       "cudaLaunchKernel", "cudaLaunchKernelExC",
                       "cuLaunchKernel", "cuLaunchKernelEx")))
    comm.barrier()
    return out


def _is_node_kernel(entry, name: str) -> bool:
    """The CUDA kernel ``name`` is one of node kernel ``entry``'s launches
    (a wide entry's: ``node_<stage>_wide[_<launch>]_kernel``)."""
    from hpa2_tpu_torch.ops import node_cycle

    if entry in node_cycle.WIDE_KERNELS:
        return re.search(rf"{entry.name}(_[a-z]+)?_kernel", name) is not None
    return f"{entry.name}_kernel" in name


class NodeProfile:
    """The CUDA kernels a cycle of a node-sharded fast-path engine's
    cycle, by ``torch.profiler``: a job for :func:`run_node_sharded` (in
    the engine's ranks, after it or alone) that profiles one ``k``-cycle
    call on each rank (the window's seed and gates included) after a
    warm one.  :attr:`per_cycle` holds the rank maximum of the kernels,
    NCCL's among them, the host's kernel launch calls and the device
    time of the kernels but NCCL's (``device_us``), each a cycle and a
    rank (over logical ranks the process's count divided by the
    ranks), and ``node_us`` the device time of each node kernel (N1-N4
    and the wide family's, by name) a cycle and a rank."""

    def __init__(self, engine: "NodeShardedCudaEngine", k: int = 4):
        self.engine, self.mesh, self.k = engine, engine.mesh, k
        self.per_cycle: Dict[str, float] = {}

    def _job(self) -> dict:
        return dict(rank_fn=_rank_profile, engine=self.engine, k=self.k)

    def _gather(self, blocks: Sequence[dict]) -> None:
        rows = [b for b in blocks if b["kernels"] is not None]
        share = 1 if len(rows) == len(blocks) else self.mesh.node
        self.per_cycle = {
            f: round(max(r[f] / share / max(r["cycles"], 1) for r in rows),
                     2)
            for f in ("kernels", "nccl", "launch_calls", "device_us")}
        self.per_cycle["node_us"] = {
            k: round(max(r["node_us"][k] / share / max(r["cycles"], 1)
                         for r in rows), 2)
            for k in rows[0]["node_us"]} if rows else {}

    def _check(self) -> None:
        pass


class _SessionRank:
    """One rank's side of a :class:`NodeShardedLaneSession`: its node
    block of its data row's resident lanes, the transient rows among the
    carried planes (so an admission resets a lane's), and the interval
    program."""

    def __init__(self, spec: dict):
        from hpa2_tpu_torch.parallel.comm import world_comm

        mesh = spec["mesh"]
        config = spec["config"]
        self.comm, self.row = world_comm(mesh.node, mesh.data)
        self.device = _rank_device(mesh)
        nl = config.num_procs // mesh.node
        rs = spec["lanes"]
        init = _node_local(_init_state(config, rs, False, spec["packed"]),
                           self.comm.rank, nl, slice(None), self.device)
        for f in TRANSIENTS:
            init[f] = torch.zeros((1, rs), dtype=I32, device=self.device)
        self.init = init
        self.state = {f: v.clone() for f, v in init.items()}
        self.program = NodeInterval(
            config, self.comm, False, spec["window"], spec["k"],
            spec["max_calls"], spec["exchange_slots"], spec["packed"],
            spec["cycle"])
        self.staged = None

    def stage(self, tr, tl) -> None:
        self.staged = (torch.from_numpy(tr).to(self.device),
                       torch.from_numpy(tl).to(self.device))

    def advance(self) -> int:
        return self.program(self.state, {}, *self.staged, n_seg=1)

    def harvest(self, lanes) -> Dict[str, np.ndarray]:
        idx = torch.as_tensor(lanes, dtype=torch.int64, device=self.device)
        return {f: _signed(v).index_select(-1, idx).view(v.dtype).cpu()
                .numpy() for f, v in self.state.items()}

    def barrier(self, perm, reset) -> None:
        barrier_(self.state, self.init,
                 torch.from_numpy(perm).to(self.device),
                 torch.from_numpy(reset).to(self.device))

    def check(self):
        return (int(self.state["exchdg"].max()),
                int(self.state["exchdc"].max()))


def _sess_open(env: dict, spec: dict) -> None:
    env["session"] = _SessionRank(spec)


def _sess_call(env: dict, method: str, *args):
    return getattr(env["session"], method)(*args)


class NodeShardedLaneSession:
    """The resident-lane serving session with each lane's NODE axis
    split over ranks (JAX ``NodeShardedLaneSession``, l.1367-1522): one
    always-on service for jobs bigger than a card, composing with data
    shards on a ``(data, node)`` mesh.

    The ranks outlive one interval, so they live in a
    ``parallel/launch.py:RankPool`` started once; this object is the
    single controller, holds no card state, and sends every rank the
    serving protocol's ``stage``, ``advance``, ``harvest``, ``barrier``
    and ``check``.  Each rank holds its node block of its data row's
    lanes with the transient rows among the carried planes, so a lane's
    transients reset on admission (JAX l.1426-1438); an interval is
    :class:`NodeInterval` over one window.  Served dumps equal a
    one-shot :class:`NodeShardedCudaEngine` run's and the one-card
    session's.  :meth:`close` (or the ``with`` block) ends the ranks;
    on the card the mesh needs ``node_shards x data_shards`` cards
    (``make_mesh(..., local=True)``: threads of this process on one
    device).  ``cycle`` as :class:`NodeShardedCudaEngine`'s."""

    def __init__(self, config: SystemConfig, resident: int, window: int, *,
                 node_shards: Optional[int] = None, data_shards: int = 1,
                 mesh: Optional[Mesh] = None,
                 exchange_slots: Optional[int] = None, block: int = 1024,
                 cycles_per_call: int = 128, packed: bool = False,
                 max_cycles: int = 1_000_000, device="cuda",
                 cycle: str = "kernel"):
        from hpa2_tpu_torch.ops.cuda_engine import fast_path_setup
        from hpa2_tpu_torch.parallel.launch import pool_for

        if mesh is None:
            if node_shards is None:
                raise ValueError("pass node_shards or an explicit mesh")
            mesh = make_mesh(node_shards=node_shards,
                             data_shards=data_shards, device=device)
        if not isinstance(mesh, Mesh):
            raise ValueError(
                "need a ('data', 'node') mesh, got "
                f"{getattr(mesh, 'axis_names', type(mesh).__name__)}")
        if mesh.node < 2:
            raise ValueError(
                "node_shards=1 is the unsharded serving path — use "
                "CudaLaneSession / DataShardedLaneSession")
        _check_cycle_name(cycle)
        if config.num_procs % mesh.node != 0:
            raise ValueError(
                f"num_procs={config.num_procs} not divisible by node "
                f"shards={mesh.node}")
        if resident % mesh.data:
            raise ValueError(
                f"resident={resident} not divisible by "
                f"data_shards={mesh.data}")
        self.config = config
        self.mesh = mesh
        self.node_shards = mesh.node
        self.data_shards = mesh.data
        self.r = int(resident)
        self.window = int(window)
        self.max_cycles = max_cycles
        self.cycles_per_call = cycles_per_call
        self._exchange_slots = exchange_slots
        self._packed = packed
        self._rs = self.r // mesh.data
        self._nl = config.num_procs // mesh.node
        _, self.block = fast_path_setup(config, lanes=self._rs, block=block,
                                        packed=packed, device="cpu")
        self.fields = list(_init_state(config, 1, False, packed)) + list(
            TRANSIENTS)
        self._harvests: Optional[_Pending] = None
        self._counts = {"runner": set(), "barrier": set(),
                        "take_lane": set()}
        self.pool = pool_for(mesh)
        self.pool.call(_sess_open, (dict(
            config=config, mesh=mesh, lanes=self._rs, window=self.window,
            k=cycles_per_call, packed=packed, exchange_slots=exchange_slots,
            max_calls=max(1, -(-max_cycles // cycles_per_call)),
            cycle=cycle),))

    def __enter__(self) -> "NodeShardedLaneSession":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        """End the ranks (the recovery supervisor calls it before a new
        session takes the cards)."""
        self.pool.close()

    def _ranks(self):
        """(rank, data row, node block) of every rank, in rank order."""
        return [(d * self.node_shards + i, d, i)
                for d in range(self.data_shards)
                for i in range(self.node_shards)]

    # -- serving protocol ----------------------------------------------

    def stage(self, tr_int: np.ndarray, tl_int: np.ndarray):
        """Ship each rank its node block of its row's window lanes."""
        tr_int = np.asarray(tr_int, np.int32)
        tl_int = np.asarray(tl_int, np.int32)
        nl, rs = self._nl, self._rs
        self.pool.call(_sess_call, per_rank=[
            ("stage",
             np.ascontiguousarray(tr_int[i * nl:(i + 1) * nl, :,
                                         d * rs:(d + 1) * rs]),
             np.ascontiguousarray(tl_int[i * nl:(i + 1) * nl,
                                         d * rs:(d + 1) * rs]))
            for _, d, i in self._ranks()])
        return tr_int.shape, tl_int.shape

    def advance(self, tr, tl) -> _Pending:
        """Every resident lane one window on the ranks; returns the ORed
        status word (already on the host: the ranks answered)."""
        self._gather_harvests()
        self._counts["runner"].add((tuple(tr), tuple(tl)))
        status = 0
        for s in self.pool.call(_sess_call, ("advance",)):
            status |= s
        return _Pending(status)

    def harvest(self, lane: int):
        """Take one lane's columns; the lanes harvested between two other
        calls are gathered together from the ranks."""
        self._counts["take_lane"].add(())
        if self._harvests is None:
            self._harvests = _Pending()
        self._harvests.lanes.append(int(lane))
        return self._harvests, len(self._harvests.lanes) - 1

    def _gather_harvests(self) -> None:
        batch, self._harvests = self._harvests, None
        if batch is None:
            return
        lanes = np.asarray(batch.lanes, np.int64)
        rows = lanes // self._rs
        got = self.pool.call(_sess_call, per_rank=[
            ("harvest", lanes[rows == d] - d * self._rs)
            for _, d, _ in self._ranks()])
        node = self.node_shards
        per_row = []
        for d in range(self.data_shards):
            blocks = got[d * node:(d + 1) * node]
            per_row.append({f: (np.concatenate([b[f] for b in blocks], 0)
                                if _node_leading(f) else blocks[0][f])
                            for f in blocks[0]})
        # each lane's column from its row, in harvest order
        pos = np.zeros(len(lanes), np.int64)
        for d in range(self.data_shards):
            sel = np.nonzero(rows == d)[0]
            pos[sel] = np.arange(len(sel))
        batch.host = {
            f: np.stack([per_row[rows[j]][f][..., pos[j]]
                         for j in range(len(lanes))], -1)
            for f in per_row[0]}

    def barrier(self, perm: np.ndarray, reset: np.ndarray) -> None:
        """The barrier transform on every rank; ``perm`` must be
        block-diagonal over the data shards (the scheduler's groups)."""
        self._gather_harvests()
        perm = np.asarray(perm, np.int64)
        reset = np.asarray(reset, bool)
        rs = self._rs
        parts = []
        for d in range(self.data_shards):
            pg = perm[d * rs:(d + 1) * rs] - d * rs
            if pg.min(initial=0) < 0 or pg.max(initial=0) >= rs:
                raise ValueError(
                    "barrier permutation moves lanes across data shards")
            parts.append((np.ascontiguousarray(pg),
                          np.ascontiguousarray(reset[d * rs:(d + 1) * rs])))
        self._counts["barrier"].add(())
        self.pool.call(_sess_call, per_rank=[
            ("barrier",) + parts[d] for _, d, _ in self._ranks()])

    def check(self, status: _Pending) -> None:
        """Raise on stall, mailbox overflow or exchange overflow, as the
        one-card session does (the exchange overflow names its worst
        event, read from the ranks)."""
        status = int(status.wait())
        if status & 4:
            words = self.pool.call(_sess_call, ("check",))
            raise _exchange_overflow_error(
                max(w[0] for w in words), max(w[1] for w in words),
                self._exchange_slots)
        if status & 2:
            raise StallError(
                "internal invariant violated: mailbox overflow despite "
                "backpressure")
        if status & 1:
            raise StallError(
                f"no quiescence within ~{self.max_cycles} cycles in one "
                "serving interval (livelock? use Semantics.robust())")

    def compile_counts(self) -> dict:
        """Distinct argument signatures each program has seen (1 each
        after the first interval of a well-formed session)."""
        return {k: len(v) for k, v in self._counts.items()}

    # -- readback ------------------------------------------------------

    def columns_of(self, cols) -> Dict[str, np.ndarray]:
        batch, i = cols
        if batch is self._harvests:
            self._gather_harvests()
        return {f: h[..., i:i + 1] for f, h in batch.wait().items()}

    def dumps_of(self, cols) -> List[NodeDump]:
        npc = self.columns_of(cols)
        if self._packed:
            cachew, dirw = _join_word_planes_np(
                npc["cvalw"], npc["cmetaw"], npc["dmemw"], npc["dmetaw"])
        else:
            cachew, dirw = npc["cachew"], npc["dirw"]
        dirs = [npc[f"dirs{w}"] for w in range(_split_sw(self.config))]
        return decode_dumps(self.config, cachew, dirw, 0, dirs=dirs or None)

    def counters_of(self, cols) -> dict:
        """The retiring job's counters, with its exchange telemetry (JAX
        l.1511-1522)."""
        c = self.columns_of(cols)
        sc = c["scalars"][:, 0]
        return {
            "instructions": int(sc[_SC_INSTR]),
            "cycles": int(sc[_SC_CYCLE]),
            "messages": int(sc[_SC_MSGS]),
            "cross_shard_msgs": int(c["xmsgs"].astype(np.int64).sum()),
            "exchange_slot_hwm": int(c["exchhw"].max()),
            "exchange_multicast_saved": int(
                c["exchmc"].astype(np.int64).sum()),
            "exchange_combined": int(c["exchcb"].astype(np.int64).sum()),
        }


__all__ = [
    "DataMesh", "DataShardedCudaEngine", "DataShardedLaneSession",
    "DataShardedRun", "GridEngine", "Mesh", "NodeInterval", "NodeProfile",
    "NodeShardedCudaEngine", "NodeShardedEngine", "NodeShardedLaneSession",
    "NodeShardedRun", "build_node_fused_pallas_run",
    "build_node_sharded_run",
    "join_blocks", "join_rows", "make_data_mesh", "make_mesh",
    "node_block", "run_node_sharded", "split_rows", "state_specs",
]
