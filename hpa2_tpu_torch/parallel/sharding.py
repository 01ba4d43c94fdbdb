"""Several GPUs: meshes, the data-sharded fast path and general engine,
and the node-sharded general engine; the port of
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
* What stays refused names ROADMAP queue 1 item 4b: the fast path's
  node axis (K1's node-sharded variant, ``NodeShardedPallasEngine``,
  ``NodeShardedLaneSession``).
"""

from __future__ import annotations

import dataclasses
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
    CudaEngine, resolve_device, run_programs,
)
from hpa2_tpu_torch.ops.engine import (
    _dumps, _live_arrays, _snap_arrays, engine_stats,
)
from hpa2_tpu_torch.ops.layout import choose_block
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

    axis_names = ("data", "node")

    @property
    def shape(self) -> Dict[str, int]:
        return {"data": self.data, "node": self.node}

    @property
    def size(self) -> int:
        return self.data * self.node


def make_mesh(node_shards: int = 1, data_shards: Optional[int] = None,
              device="cuda") -> Mesh:
    """A ``(data, node)`` mesh over the cards (JAX ``make_mesh``,
    l.78-104): every card by default, and a grid larger than the cards
    raises (NCCL takes one rank a card).  On the CPU the ranks are gloo
    processes and ``data_shards`` defaults to 1."""
    dev = torch.device(device)
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
    """One rank's share of node-sharded runs (each job an engine's
    spec): its block of each initial state, the SPMD loop, and its
    block back as numpy with the run's counts."""
    from hpa2_tpu_torch.convert import sim_state_to_numpy
    from hpa2_tpu_torch.parallel.comm import world_comm

    out = []
    for job in jobs:
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
        syncs0 = kernels.HOST_SYNCS.count
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = run(st)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        out.append(dict(
            state=sim_state_to_numpy(st), steps=run.steps, jumps=run.jumps,
            step_collectives=run.step_collectives,
            loop_collectives=run.loop_collectives, seconds=secs,
            host_syncs=kernels.HOST_SYNCS.count - syncs0))
    return out


def run_node_sharded(engines: Sequence["_NodeShardedBase"],
                     warmup: bool = False) -> None:
    """Run several node-sharded engines of one mesh size in one group of
    ranks (one spawn: a rank costs seconds to start), or in place when
    this process is a rank of a ``torchrun`` group already.  With
    ``warmup`` each rank runs each loop once untimed first (``seconds``
    is then the second run's).  Raises the first engine's stall."""
    from hpa2_tpu_torch.convert import sim_state_from_numpy
    from hpa2_tpu_torch.parallel.launch import join_torchrun, spawn

    sizes = {e.mesh.size for e in engines}
    devs = {e.mesh.device for e in engines}
    if len(sizes) != 1 or len(devs) != 1:
        raise ValueError("run_node_sharded runs engines of one mesh size "
                         "and device type together")
    jobs = [dict(e._job(), warmup=warmup) for e in engines]
    if join_torchrun(devs.pop()):
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, _rank_run(jobs))
    else:
        every = spawn(_rank_run, sizes.pop(), args=(jobs,),
                      device=engines[0].mesh.device)
    for i, e in enumerate(engines):
        blocks = [rank[i] for rank in every]
        e.state = sim_state_from_numpy(
            join_blocks([b["state"] for b in blocks], e.mesh.node),
            device="cpu")
        e.rank_stats = [{k: v for k, v in b.items() if k != "state"}
                        for b in blocks]
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
        return dict(config=self.config, mesh=self.mesh, state=self._init,
                    max_cycles=self.max_cycles,
                    watchdog_cycles=self.watchdog_cycles)

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


__all__ = [
    "DataMesh", "DataShardedCudaEngine", "DataShardedLaneSession",
    "DataShardedRun", "GridEngine", "Mesh", "NodeShardedEngine",
    "NodeShardedRun", "build_node_sharded_run",
    "join_blocks", "join_rows", "make_data_mesh", "make_mesh",
    "node_block", "run_node_sharded", "split_rows", "state_specs",
]
