"""K1's node-sharded cycle: four hand-written kernels on the card, their
plain PyTorch versions on the CPU.

JAX runs the node-sharded variant of ``build_cycle``
(``hpa2_tpu/ops/pallas_engine.py:559-575``, the exchange branch
l.1355-1590, the stacked reductions l.1725-1797) as XLA under
``shard_map``, because collectives cannot run inside a Mosaic kernel.
Here the collectives stay NCCL calls outside the kernels (the exchange
schedules of ``ops/exchange.py``), and the rank-local work between them
is four kernels of ``csrc/node_cycle.cu``:

* **N1** :data:`NODE_AB`: phases A and B of the rank's ``nl`` node rows,
  the exchange payload ``[W + SW + 3, 5 nl, B]`` in the global candidate
  order (:func:`ab_plain`);
* **N2** :data:`NODE_BUCKET`: the order-preserving compaction of payload
  blocks into the k-slot buffers of destination shards, with the source
  telemetry and ``hier``'s combining count, once a compaction round
  (:class:`NodeBucketer`; plain: ``exchange.bucket``);
* **N3** :data:`NODE_DELIVER`: every receiver takes the entries it holds
  in the global (phase, origin, index) order while its queue has room;
  the acceptance rows go back to the senders (:func:`deliver_plain`);
* **N4** :data:`NODE_SETTLE`: the senders settle their slots against
  the returned acceptance, take the phase-D snapshots and give their
  rows of the cycle's one stacked SUM and one stacked MAX
  (:func:`settle_plain`).

:class:`NodeCycle` composes them with the exchange's ``forward`` and
``feedback`` and the two reductions.  Between the stages the state is
the rank's planes, updated in place by a kernel: after N1 the popped
mailboxes, the cache and directory rows, ``nsw`` without the
deliveries, the fresh sends in the outbox (with the sender and, packed,
the recv field: the words kept if they are not delivered) and the INV
slot's word with its receiver set; after N3 the mailboxes and ``nsw``
with the deliveries.  The plain versions compose to the cycle of the
JAX package bit for bit, and each kernel equals its plain version on
the same inputs.

A system wider than the register instantiations' ``kernels.MAX_NODES``
nodes runs on the wide family, four entries of their own
(:data:`WIDE_KERNELS`: ``node_ab_wide``, ``node_bucket_wide``,
``node_deliver_wide``, ``node_settle_wide``; the message and sharer
words run-time values, the planes reached through pointer tables in
device memory, :class:`WideArgs`), with the same plain versions.

On a CUDA tensor a stage launches its kernel (or raises); on a CPU
tensor it runs the plain version.  ``cycle="tensor"`` runs the plain
versions on the card too, only where a caller names it: the reference
``[nodeshard]`` and ``gpu_session``'s ``nodeshard4096`` hold the kernels
against.  With :attr:`NodeCycle.check` set, every launch is also run by
its plain version on copies of its inputs and the two are compared
(:attr:`NodeCycle.checked`).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence

import torch

from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.models.protocol import MsgType
from hpa2_tpu_torch.ops import exchange, kernels
from hpa2_tpu_torch.ops.cycle import (
    _isum, _narrow_cache, _narrow_dir, _popcount, _widen_cache, _widen_dir,
    build_phase_ab,
)
from hpa2_tpu_torch.ops.layout import (
    _NSCALAR, _NSLOTS, _NTYPES, _PACKED_CACHE, _PACKED_DIR, _SC_CYCLE,
    _SC_OVERFLOW, _SPLIT_BPW, TORCH_DTYPES, _mb_layout, _scalar_layout,
    _sharer_words, _split_mode, _split_sw, field, fields_of,
    packed_plane_dtypes,
)

I32 = torch.int32

#: node shards the kernels take (kMaxShards in csrc/node_cycle.cuh)
MAX_SHARDS = 16
#: N1's per-lane counters: instructions, read hits, read misses, write
#: hits, write misses, evictions, invalidations applied (kABCount)
AB_COUNTS = 7
#: rows of N4's stacked SUM (kSumRows) and MAX (kMaxRows)
SUM_ROWS = 12 + _NTYPES + 2
MAX_ROWS = 3
#: the ways a node cycle runs on the card
CYCLES = ("kernel", "tensor")


class NodeArgs(ctypes.Structure):
    """Mirror of ``hpa2::NodeArgs`` in ``csrc/node_cycle.cuh``."""

    _fields_ = (
        [("a", kernels.Args)]
        + [(f, ctypes.c_int32) for f in (
            "me", "nl", "shards", "nblk")]
        + [("payload", ctypes.c_void_p), ("cnt", ctypes.c_void_p),
           ("blk", ctypes.c_void_p * MAX_SHARDS),
           ("fb", ctypes.c_void_p * MAX_SHARDS),
           ("blen", ctypes.c_int32 * MAX_SHARDS)]
        + [(f, ctypes.c_void_p) for f in ("acc", "fs", "gsum", "gmax")]
    )


class BucketArgs(ctypes.Structure):
    """Mirror of ``hpa2::BucketArgs`` in ``csrc/node_cycle.cuh``."""

    _fields_ = (
        [(f, ctypes.c_int32) for f in (
            "n", "nl", "W", "SW", "b", "k", "ndest", "combine", "nkeys",
            "me")]
        + [("fs", ctypes.c_void_p),
           ("blk", ctypes.c_void_p * MAX_SHARDS),
           ("blen", ctypes.c_int32 * MAX_SHARDS)]
        + [(f, ctypes.c_int32 * MAX_SHARDS) for f in (
            "dblk", "dset", "dflags", "ddst")]
        + [("dmask", (ctypes.c_int32 * kernels.MAX_SHARER_WORDS)
            * MAX_SHARDS),
           ("buf", ctypes.c_void_p * MAX_SHARDS),
           ("sel", ctypes.c_void_p * MAX_SHARDS)]
    )


class WideArgs(ctypes.Structure):
    """Mirror of ``hpa2::WideArgs``: the wide family's N1, N3 and N4
    arguments (``x.a``'s word-plane arrays hold the first planes only;
    ``mb``, ``ob``, ``dirs`` and ``sdirs`` point at int64 tables of every
    plane's address on the device), N1's scratch (null unless its pairs'
    sets miss the shared tile, :func:`wide_ab_scratch`) and the zeroed
    rows of N3 and N4."""

    _fields_ = [("x", NodeArgs)] + [(f, ctypes.c_void_p) for f in (
        "mb", "ob", "dirs", "sdirs", "work", "red", "wa", "wb")]


class WideBucketArgs(ctypes.Structure):
    """Mirror of ``hpa2::WideBucketArgs``: the wide N2's arguments (the
    destinations' node masks [ndest, SW] on the device, their nonzero
    words, the flag words and the flags CTAs' lane sums its first launch
    writes whole, and ``hier``'s zeroed key bitmap)."""

    _fields_ = ([("x", BucketArgs), ("dmask", ctypes.c_void_p),
                 ("dwlo", ctypes.c_int32 * MAX_SHARDS),
                 ("dwhi", ctypes.c_int32 * MAX_SHARDS)]
                + [(f, ctypes.c_void_p) for f in ("bits", "part", "keys")])


#: sets a (node row, lane) pair of the wide N1 (kWideSets)
WIDE_SETS = 8
#: the wide N1's scalar tile rows a pair (kW1Rows) and the tile a CTA at
#: most (kWideAbSmem): the plan whose pairs' sets go to the scratch when
#: not even one pair's fit (csrc/node_cycle.cuh: wide_ab_plan)
WIDE_AB_ROWS = 27
WIDE_AB_SMEM = 100 * 1024
#: flag words a CTA of the wide N2's flags launch (kWideFlagWords)
WIDE_FLAG_WORDS = 1
#: N4's sums a lane (kSettleRed): activity, mailbox overflow, deliveries
#: and the deliveries of each type
SETTLE_RED = 3 + _NTYPES

_NODE = (ctypes.POINTER(NodeArgs),)
NODE_AB = kernels.KernelEntry(
    kernels.NODE_CYCLE, "node_ab", "hpa2_node_ab",
    "hpa2_tpu/ops/pallas_engine.py:640", _NODE)
NODE_BUCKET = kernels.KernelEntry(
    kernels.NODE_CYCLE, "node_bucket", "hpa2_node_bucket",
    "hpa2_tpu/ops/pallas_engine.py:1463",
    (ctypes.POINTER(BucketArgs),))
NODE_DELIVER = kernels.KernelEntry(
    kernels.NODE_CYCLE, "node_deliver", "hpa2_node_deliver",
    "hpa2_tpu/ops/pallas_engine.py:1517", _NODE)
NODE_SETTLE = kernels.KernelEntry(
    kernels.NODE_CYCLE, "node_settle", "hpa2_node_settle",
    "hpa2_tpu/ops/pallas_engine.py:1562", _NODE)
#: the four kernels of the node-sharded cycle
NODE_KERNELS = (NODE_AB, NODE_BUCKET, NODE_DELIVER, NODE_SETTLE)
_WIDE = (ctypes.POINTER(WideArgs),)
NODE_AB_WIDE = kernels.KernelEntry(
    kernels.NODE_CYCLE, "node_ab_wide", "hpa2_node_ab_wide",
    "hpa2_tpu/ops/pallas_engine.py:640", _WIDE)
NODE_BUCKET_WIDE = kernels.KernelEntry(
    kernels.NODE_CYCLE, "node_bucket_wide", "hpa2_node_bucket_wide",
    "hpa2_tpu/ops/pallas_engine.py:1463",
    (ctypes.POINTER(WideBucketArgs),))
NODE_DELIVER_WIDE = kernels.KernelEntry(
    kernels.NODE_CYCLE, "node_deliver_wide", "hpa2_node_deliver_wide",
    "hpa2_tpu/ops/pallas_engine.py:1517", _WIDE)
NODE_SETTLE_WIDE = kernels.KernelEntry(
    kernels.NODE_CYCLE, "node_settle_wide", "hpa2_node_settle_wide",
    "hpa2_tpu/ops/pallas_engine.py:1562", _WIDE)
#: the wide family's four, above ``kernels.MAX_NODES`` nodes
WIDE_KERNELS = (NODE_AB_WIDE, NODE_BUCKET_WIDE, NODE_DELIVER_WIDE,
                NODE_SETTLE_WIDE)
#: every node kernel entry, in ``hpa2_node_geometry``'s order
ALL_NODE_KERNELS = NODE_KERNELS + WIDE_KERNELS

_DEST_COMPACT, _DEST_STAT = 1, 2
_SIZES_CHECKED = []
#: clocks the stream sleeps before a launch timed alone (~0.5 ms):
#: longer than the host's share of a launch
SLEEP_CYCLES = 1_000_000


class _CudaLauncher:
    """Launches the node kernels on the card."""

    def launch(self, entry: kernels.KernelEntry, args, device) -> None:
        if not _SIZES_CHECKED:
            kernels.NODE_CYCLE.build()
            lib = kernels.NODE_CYCLE._lib
            for fn, mirror in (("hpa2_node_args_size", NodeArgs),
                               ("hpa2_bucket_args_size", BucketArgs),
                               ("hpa2_wide_args_size", WideArgs),
                               ("hpa2_wide_bucket_args_size",
                                WideBucketArgs)):
                f = getattr(lib, fn)
                f.restype = ctypes.c_int
                if f() != ctypes.sizeof(mirror):
                    raise RuntimeError(
                        f"{fn}() = {f()} but the ctypes mirror is "
                        f"{ctypes.sizeof(mirror)} bytes: node_cycle.py's "
                        "mirror is out of date")
            _SIZES_CHECKED.append(True)
        entry.launch(ctypes.byref(args), device=device)


CUDA_LAUNCHER = _CudaLauncher()
#: a launcher for CPU tensors (``launch(entry, args, device)``), None:
#: the plain versions run there.  Tests set it to the g++ build of the
#: kernels' bodies, so that a run on the CPU goes through them as a run
#: on the card goes through the kernels.
HOST_LAUNCHER = None


def check_node_kernel_bound(config: SystemConfig, shards: int) -> None:
    """Raise unless the node kernels take ``config`` over ``shards``: the
    register instantiations up to ``kernels.MAX_NODES`` nodes, the wide
    family above (its words at run time), at most :data:`MAX_SHARDS`
    shards either way, and row indices that fit int32."""
    if shards > MAX_SHARDS:
        raise ValueError(
            f"{shards} node shards exceed the node kernels' "
            f"{MAX_SHARDS} (a launch's blocks, buffers and destination "
            "sets are fixed arrays of its argument block); name "
            "cycle='tensor'")
    n, cap = config.num_procs, config.msg_buffer_size
    rows = n * max(cap, config.cache_size, config.mem_size, _NSLOTS)
    if rows >= 2 ** 31:
        raise ValueError(
            f"num_procs={n}: {rows} rows of a plane overflow the kernels' "
            "int32 row indices")
    if n > kernels.MAX_NODES and not _wide_layout(config):
        raise ValueError(
            f"num_procs={n}: the wide node kernels take a message of two "
            "header words and a sharer word each after them, not "
            f"{_mb_layout(config)[0]}")


def wide_ab_scratch(sw: int) -> int:
    """Words a pair's sets take in the wide N1's scratch when not even
    one pair's fit its shared tile of at most :data:`WIDE_AB_SMEM` bytes
    beside the plane tables' copy (its plan,
    ``csrc/node_cycle.cuh:wide_ab_plan``), else 0."""
    stride = (WIDE_SETS * sw) | 1
    tables = 8 * (2 * (2 + sw) + sw)
    fits = tables + 4 * (WIDE_AB_ROWS + AB_COUNTS + stride) <= WIDE_AB_SMEM
    return 0 if fits else stride


@functools.lru_cache(maxsize=16)
def _wide_layout(config: SystemConfig) -> bool:
    """``config``'s message is the wide family's: two header words, then
    sharer word j all of word 2 + j."""
    layout, W = _mb_layout(config)
    SW = _sharer_words(config)
    return W == 2 + SW and all(layout[f"shr{j}"] == (2 + j, 0, _SPLIT_BPW)
                               for j in range(SW))


def _err(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Largest abs difference of two integer tensors, on their device."""
    if tuple(got.shape) != tuple(want.shape):
        raise AssertionError(
            f"shape {tuple(got.shape)} against {tuple(want.shape)}")
    if got.numel() == 0:
        return torch.zeros((), dtype=torch.int64, device=got.device)
    return (got.to(torch.int64) - want.to(torch.int64)).abs().max()


class NodeBucketer:
    """The bucketing step of the node cycle's exchange (``exchange.forward``
    calls it once a compaction round): N2 on the card, ``exchange.bucket``
    over the node ranges on the CPU.  A destination's shard set is a
    node range: a point entry goes to it when its receiver lies in one of
    the shards, an INV entry when its fan mask meets their range."""

    def __init__(self, nc: "NodeCycle"):
        self.nc = nc
        self.fsbuf: Optional[torch.Tensor] = None
        # the wide N2's destination masks on the device, by destinations
        self._dmask: Dict[tuple, torch.Tensor] = {}

    def stats_init(self, payload: torch.Tensor) -> dict:
        self.fsbuf = torch.zeros((len(exchange.FSTATS), payload.shape[-1]),
                                 dtype=I32, device=payload.device)
        return dict(zip(exchange.FSTATS, self.fsbuf.unbind(0)))

    def union(self, shards, dev) -> torch.Tensor:
        nc = self.nc
        u = torch.zeros(nc.SW, dtype=I32)
        for p in shards:
            u = u | nc.rmask[p]
        return u.to(dev)

    def dest_of(self, blk: torch.Tensor, shards) -> torch.Tensor:
        nc = self.nc
        recv = blk[nc.W + nc.SW]
        pt = torch.zeros(blk.shape[1:], dtype=torch.bool, device=blk.device)
        for p in shards:
            lo = p * nc.nl
            pt = pt | ((recv >= lo + 1) & (recv < lo + nc.nl + 1))
        u = self.union(shards, blk.device)
        return pt | ((blk[nc.W:nc.W + nc.SW] & u[:, None, None]) != 0).any(0)

    def fan_of(self, blk: torch.Tensor, peer: int) -> torch.Tensor:
        nc = self.nc
        rm = nc.rmask[peer].to(blk.device)
        return _isum(_popcount(blk[nc.W:nc.W + nc.SW] & rm[:, None, None]),
                     0).clamp(min=1)

    def plain(self, fs, blocks, dests, k, src, combine=False):
        nc = self.nc
        return exchange.bucket(fs, blocks, dests, k, src, self.dest_of,
                               self.fan_of, nc.W + nc.SW + 2 if combine
                               else None, nc.nkeys)

    def __call__(self, fs, blocks, dests, k, src, combine=False):
        nc = self.nc
        dev = blocks[0].device
        if nc.keeping(nc.BUCKET.name):
            nc.kept[nc.BUCKET.name] = (
                self.fsbuf.clone(), {f: v.clone() for f, v in fs.items()},
                [b.clone() for b in blocks], list(dests), k, src, combine)
        launcher = nc.launcher(dev)
        if launcher is None:
            return self.plain(fs, blocks, dests, k, src, combine)
        blocks = [b.contiguous() for b in blocks]
        bb = blocks[0].shape[-1]
        comp = [d for d in dests if d.compact]
        out = torch.empty((len(comp), nc.R, k, bb), dtype=I32, device=dev)
        sels = [torch.empty((blocks[d.block].shape[1], bb), dtype=torch.int64,
                            device=dev) for d in comp]
        if nc.check:
            before = {f: v.clone() for f, v in fs.items()}
        y = WideBucketArgs() if nc.wide else None
        x = y.x if nc.wide else BucketArgs()
        x.n, x.nl, x.W, x.SW, x.b, x.k = nc.n, nc.nl, nc.W, nc.SW, bb, k
        x.ndest, x.combine, x.nkeys, x.me = len(dests), combine, nc.nkeys, src
        x.fs = self.fsbuf.data_ptr()
        for i, b in enumerate(blocks):
            x.blk[i], x.blen[i] = b.data_ptr(), b.shape[1]
        p = 0
        for i, d in enumerate(dests):
            x.dblk[i] = d.block
            x.dset[i] = sum(1 << q for q in d.shards)
            x.dflags[i] = (_DEST_COMPACT if d.compact else 0) | (
                _DEST_STAT if d.stat else 0)
            x.ddst[i] = d.dst
            u = self.union(d.shards, "cpu")
            if nc.wide:
                nz = u.nonzero().flatten().tolist() or [0, -1]
                y.dwlo[i], y.dwhi[i] = nz[0], nz[-1]
            else:
                for w, v in enumerate(u.tolist()):
                    x.dmask[i][w] = v
            if d.compact:
                x.buf[i], x.sel[i] = out[p].data_ptr(), sels[p].data_ptr()
                p += 1
        if nc.wide:
            keep = self._wide_rows(y, blocks, dests, combine, dev)
        nc.launch(launcher, nc.BUCKET, y if nc.wide else x, dev)
        if nc.check:
            want_out, want_sels = self.plain(before, blocks, dests, k, src,
                                             combine)
            nc.note_check(nc.BUCKET, [_err(out, want_out)]
                          + [_err(a, b) for a, b in zip(sels, want_sels)]
                          + [_err(self.fsbuf[i], before[f])
                             for i, f in enumerate(exchange.FSTATS)])
        return out, sels

    def _wide_rows(self, y: "WideBucketArgs", blocks, dests, combine,
                   dev) -> list:
        """The wide N2's device rows: the destinations' masks (made once
        a set of destinations and device), the flag words and lane sums
        its first launch writes whole, and under ``hier``'s combining the
        zeroed key bitmap; returns the tensors (kept alive until the
        launch is enqueued)."""
        nc, bb = self.nc, blocks[0].shape[-1]
        key = (tuple(d.shards for d in dests), str(dev))
        dmask = self._dmask.get(key)
        if dmask is None:
            dmask = self._dmask[key] = torch.stack(
                [self.union(d.shards, "cpu") for d in dests]).to(dev)
        nw = sum(-(-blocks[d.block].shape[1] // 32) for d in dests)
        nwt = -(-nw // WIDE_FLAG_WORDS)
        rows = torch.empty((nw + 3 * nwt) * bb, dtype=I32, device=dev)
        y.dmask = dmask.data_ptr()
        y.bits, y.part = rows.data_ptr(), rows[nw * bb:].data_ptr()
        keep = [dmask, rows]
        if combine and nc.nkeys:
            keys = torch.zeros(-(-nc.nkeys // 32) * bb, dtype=I32, device=dev)
            y.keys = keys.data_ptr()
            keep.append(keys)
        else:
            y.keys = None
        return keep


class NodeCycle:
    """One cycle of a node shard (``build_cycle(axis_name=comm,
    shards=D)``): ``cycle(s, seg, window) -> s`` on this rank's block of
    the planes (``s`` also holds the whole trace plane ``tr``
    [nl, n_seg * window, B], ``tr_len`` [nl, B] and the [1, B] rows of
    ``ops/cycle.py:TRANSIENTS``), updated in place by the kernels and
    entry by entry by the plain versions.  ``launches`` counts this
    rank's kernel launches by kernel; with :attr:`check` set each launch
    is held against its plain version (``checked``: kernel name ->
    [launches checked, largest abs difference])."""

    def __init__(self, config: SystemConfig, snapshots: bool, packed: bool,
                 comm, shards: int, exchange_slots: Optional[int] = None,
                 cycle: str = "kernel"):
        n = config.num_procs
        if n % shards != 0:
            raise ValueError(
                f"num_procs={n} not divisible by node shards={shards}")
        if comm.size != shards:
            raise ValueError(
                f"the node group has {comm.size} ranks, not "
                f"shards={shards}")
        if cycle not in CYCLES:
            raise ValueError(f"cycle={cycle!r}: one of {CYCLES}")
        nl = n // shards
        k = 5 * nl if exchange_slots is None else int(exchange_slots)
        if not 1 <= k <= 5 * nl:
            raise ValueError(
                f"exchange_slots={exchange_slots} out of range [1, {5 * nl}]")
        self.config, self.snapshots, self.packed = config, snapshots, packed
        self.comm, self.shards, self.cycle = comm, shards, cycle
        self.n, self.nl, self.me, self.k = n, nl, comm.rank, k
        self.cap = config.msg_buffer_size
        self.layout, self.W = _mb_layout(config)
        self.SW = _sharer_words(config)
        self.split = _split_mode(config)
        self.recv_packed = "recv" in self.layout
        self.R = self.W + self.SW + 3
        self.nkeys = n * config.mem_size
        self.plan = exchange.make_plan(shards, config.exchange_mode,
                                       config.exchange_inner)
        self.rmask = [exchange.range_mask_words(p * nl, (p + 1) * nl,
                                                self.SW, _SPLIT_BPW)
                      for p in range(shards)]
        self.phase_ab = build_phase_ab(config)
        self.pdt = {f: TORCH_DTYPES[d] for f, d in
                    packed_plane_dtypes(config).items()} if packed else {}
        self.bucketer = NodeBucketer(self)
        # a stage's NodeArgs, built for a window, a segment and the
        # planes' storage (the key), then patched (:meth:`_args`)
        self._arg_cache: Dict[str, tuple] = {}
        self._ptr_fields = [f for f in fields_of(config, snapshots, packed)
                            if f not in ("scalars", "msg_counts")]
        # the register instantiations, or the wide family above their
        # bound: the four entries this cycle launches
        self.wide = n > kernels.MAX_NODES
        self.entries = WIDE_KERNELS if self.wide else NODE_KERNELS
        self.AB, self.BUCKET, self.DELIVER, self.SETTLE = self.entries
        self._work: Optional[torch.Tensor] = None
        self.check = False
        self.launches = {e.name: 0 for e in self.entries}
        self.checked = {e.name: [0, 0] for e in self.entries}
        # with keep_at set, the inputs of every stage of that cycle (its
        # first N2 launch) are kept for :meth:`time_kept`
        self.keep_at: Optional[int] = None
        self.kept: Dict[str, tuple] = {}
        self.cycles = 0
        # a list while :meth:`time_kept` times launches alone: the CUDA
        # events around each launch
        self.timed: Optional[list] = None
        # each kernel's arguments at its last launch (:func:`geometry`)
        self.last_args: Dict[str, ctypes.Structure] = {}

    # -- dispatch --------------------------------------------------------

    def launcher(self, dev: torch.device):
        """The launcher of a stage on ``dev``, or None for the plain
        version."""
        if self.cycle == "tensor":
            return None
        if dev.type == "cuda":
            check_node_kernel_bound(self.config, self.shards)
            return CUDA_LAUNCHER
        return HOST_LAUNCHER

    def launch(self, launcher, entry, args, dev) -> None:
        if self.timed is None:
            launcher.launch(entry, args, dev)
        else:
            # the stream sleeps while the host enqueues the start event
            # and the launch, so the events time the kernel alone
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda._sleep(SLEEP_CYCLES)
            ev[0].record()
            launcher.launch(entry, args, dev)
            ev[1].record()
            self.timed.append(ev)
        self.launches[entry.name] += 1
        self.last_args[entry.name] = args

    def keeping(self, name: str) -> bool:
        return self.cycles == self.keep_at and name not in self.kept

    def note_check(self, entry, errs: Sequence[torch.Tensor]) -> None:
        """Record a checked launch: ``errs`` are the largest differences
        of its outputs from the plain version's (one host read)."""
        err = int(torch.stack(errs).max())
        row = self.checked[entry.name]
        row[0] += 1
        row[1] = max(row[1], err)
        if err:
            raise AssertionError(
                f"{entry.name}: the kernel differs from its plain version "
                f"by {err}")

    def _args(self, stage: str, s, seg: int, window: int):
        """Stage ``stage``'s NodeArgs (the wide family: its WideArgs,
        whose ``x`` is the NodeArgs, with the planes' pointer tables on
        the planes' device): built by ``kernels._kernel_args`` once for
        a window, a segment and the storage of the planes it points at
        (the pointers are the key: a plane replaced, or a copy of the
        state, builds it anew), then reused with ``scalars``, a new
        tensor every cycle, patched.  The stage sets its own tensors'
        pointers (payload, counters, blocks, feedback) before each
        launch; ``msg_counts``, which no node kernel reads, stays null."""
        tr, tl = s["tr"], s["tr_len"]
        key = (seg, window, tr.data_ptr(), tl.data_ptr(), tr.shape[1],
               tl.shape[1]) + tuple(
                   s[f].data_ptr() for f in self._ptr_fields)
        hit = self._arg_cache.get(stage)
        if hit is None or hit[0] != key:
            x = NodeArgs()
            x.a = kernels._kernel_args(
                self.config, s, tr, tl, None, block=1, k=0, window=window,
                n_seg=tr.shape[1] // window, max_calls=0, gate=False,
                snapshots=self.snapshots, packed=self.packed, seg=seg)
            x.a.msg_counts = None
            x.me, x.nl, x.shards = self.me, self.nl, self.shards
            tables = []
            if self.wide:
                y = WideArgs()
                y.x = x
                sw = _split_sw(self.config)
                for name, planes in (
                        ("mb", [f"mb{w}" for w in range(self.W)]),
                        ("ob", [f"ob{w}" for w in range(self.W)]),
                        ("dirs", [f"dirs{w}" for w in range(sw)]),
                        ("sdirs", [f"snap_dirs{w}" for w in range(sw)]
                         if self.snapshots else [])):
                    if planes:
                        t = torch.tensor([s[f].data_ptr() for f in planes],
                                         dtype=torch.int64,
                                         device=s["nsw"].device)
                        tables.append(t)
                        setattr(y, name, t.data_ptr())
                x = y
            hit = self._arg_cache[stage] = (key, x, tables)
        x = hit[1]
        (x.x if self.wide else x).a.scalars = s["scalars"].data_ptr()
        return x

    def _scratch(self, dev, bb: int) -> Optional[torch.Tensor]:
        """The wide N1's scratch [nl * B, stride] (kept), the pairs' sets
        when not even one pair's fit its shared tile
        (:func:`wide_ab_scratch`), else None."""
        stride = wide_ab_scratch(self.SW)
        if not stride:
            return None
        shape = (self.nl * bb, stride)
        w = self._work
        if w is None or tuple(w.shape) != shape or w.device != dev:
            w = self._work = torch.empty(shape, dtype=I32, device=dev)
        return w

    # -- the four stages -------------------------------------------------

    def node_ab(self, s, seg: int, window: int):
        """N1: phases A and B; returns the payload and the counters."""
        dev = s["nsw"].device
        launcher = self.launcher(dev)
        if launcher is None:
            upd, payload, cnt = ab_plain(self, s, seg, window)
            s.update(upd)
            return payload, cnt
        bb = s["nsw"].shape[1]
        before = _copies(s) if self.check else None
        payload = torch.empty((self.R, 5 * self.nl, bb), dtype=I32,
                              device=dev)
        # the wide N1 adds its counters into zeroed rows
        cnt = (torch.zeros if self.wide else torch.empty)(
            (AB_COUNTS, bb), dtype=I32, device=dev)
        y = self._args(self.AB.name, s, seg, window)
        x = y.x if self.wide else y
        x.payload, x.cnt = payload.data_ptr(), cnt.data_ptr()
        if self.wide:
            work = self._scratch(dev, bb)
            y.work = None if work is None else work.data_ptr()
        self.launch(launcher, self.AB, y, dev)
        if self.check:
            upd, want_p, want_c = ab_plain(self, before, seg, window)
            self.note_check(self.AB, [_err(payload, want_p),
                                      _err(cnt, want_c)]
                            + [_err(s[f], v) for f, v in upd.items()])
        return payload, cnt

    def node_deliver(self, s, blocks: Sequence[torch.Tensor],
                     origins: Sequence[int]) -> List[torch.Tensor]:
        """N3: the receivers take their entries; returns each block's
        acceptance rows [1 + SW, J, B], in the blocks' order."""
        dev = s["nsw"].device
        launcher = self.launcher(dev)
        if launcher is None:
            upd, fbs = deliver_plain(self, s, blocks, origins)
            s.update(upd)
            return fbs
        blocks = [b.contiguous() for b in blocks]
        bb = s["nsw"].shape[1]
        before = _copies(s) if self.check else None
        sizes = [(1 + self.SW) * b.shape[1] * bb for b in blocks]
        # N3 writes every feedback word once; the wide N3 adds into
        # zeroed rows
        flat = (torch.zeros if self.wide else torch.empty)(
            sum(sizes), dtype=I32, device=dev)
        fbs, off = [], 0
        for b, size in zip(blocks, sizes):
            fbs.append(flat[off:off + size].view(1 + self.SW, b.shape[1], bb))
            off += size
        y = self._args(self.DELIVER.name, s, 0, s["tr"].shape[1])
        x = y.x if self.wide else y
        order = sorted(range(len(blocks)), key=lambda i: origins[i])
        x.nblk = len(blocks)
        for j, i in enumerate(order):
            x.blk[j], x.fb[j] = blocks[i].data_ptr(), fbs[i].data_ptr()
            x.blen[j] = blocks[i].shape[1]
        if self.wide:
            # the phase-A and phase-B flag words [nch, nl, B] and their
            # summary words [ceil(nch / 32), nl, B], zeroed
            nch = -(-sum(b.shape[1] for b in blocks) // 32)
            flags = torch.zeros((2, nch - (-nch // 32), self.nl, bb),
                                dtype=I32, device=dev)
            y.wa, y.wb = flags[0].data_ptr(), flags[1].data_ptr()
        self.launch(launcher, self.DELIVER, y, dev)
        if self.check:
            upd, want = deliver_plain(self, before, blocks, origins)
            self.note_check(self.DELIVER,
                            [_err(a, b) for a, b in zip(fbs, want)]
                            + [_err(s[f], v) for f, v in upd.items()])
        return fbs

    def node_settle(self, s, acc: torch.Tensor, cnt: torch.Tensor,
                    fs: torch.Tensor, seg: int, window: int):
        """N4: the senders settle; returns the rank's rows of the stacked
        SUM [29, B] and MAX [3, B]."""
        dev = s["nsw"].device
        launcher = self.launcher(dev)
        if launcher is None:
            upd, gsum, gmax = settle_plain(self, s, acc, cnt, fs, seg,
                                           window)
            s.update(upd)
            return gsum, gmax
        bb = s["nsw"].shape[1]
        before = _copies(s) if self.check else None
        acc = acc.contiguous()
        gsum = torch.empty((SUM_ROWS, bb), dtype=I32, device=dev)
        gmax = torch.empty((MAX_ROWS, bb), dtype=I32, device=dev)
        y = self._args(self.SETTLE.name, s, seg, window)
        x = y.x if self.wide else y
        x.acc, x.cnt, x.fs = acc.data_ptr(), cnt.data_ptr(), fs.data_ptr()
        x.gsum, x.gmax = gsum.data_ptr(), gmax.data_ptr()
        if self.wide:
            red = torch.zeros((SETTLE_RED, bb), dtype=I32, device=dev)
            y.red = red.data_ptr()
        self.launch(launcher, self.SETTLE, y, dev)
        if self.check:
            upd, want_s, want_m = settle_plain(self, before, acc, cnt, fs,
                                               seg, window)
            self.note_check(self.SETTLE, [_err(gsum, want_s),
                                          _err(gmax, want_m)]
                            + [_err(s[f], v) for f, v in upd.items()])
        return gsum, gmax

    # -- the cycle -------------------------------------------------------

    def __call__(self, s: Dict[str, torch.Tensor], seg: int = 0,
                 window: Optional[int] = None) -> Dict[str, torch.Tensor]:
        w = s["tr"].shape[1] if window is None else window
        comm, W, SW = self.comm, self.W, self.SW
        if self.keeping(self.AB.name):
            self.kept[self.AB.name] = (_copies(s), seg, w)
        payload, cnt = self.node_ab(s, seg, w)
        bufs, origins, xctx, fs = exchange.forward(
            self.plan, comm, self.me, payload, None, self.k,
            ckey_row=W + SW + 2, nkeys=self.nkeys, bucketer=self.bucketer)
        blocks = [payload] + list(bufs)
        if self.keeping(self.DELIVER.name):
            self.kept[self.DELIVER.name] = (
                _copies(s), [b.clone() for b in blocks], list(origins))
        fbs = self.node_deliver(s, blocks, origins)
        acc = fbs[0] + exchange.feedback(self.plan, comm, fbs[1:], xctx)
        fs_t = (self.bucketer.fsbuf if self.launcher(payload.device)
                is not None else torch.stack([fs[f] for f in
                                              exchange.FSTATS]))
        if self.keeping(self.SETTLE.name):
            self.kept[self.SETTLE.name] = (
                _copies(s), acc.clone(), cnt.clone(), fs_t.clone(), seg, w)
        gsum, gmax = self.node_settle(s, acc, cnt, fs_t, seg, w)
        self.cycles += 1
        # ONE stacked SUM over the node group carries every summed
        # reduction of the cycle (the end-of-cycle activity, which is the
        # next cycle's start activity, the cross-shard entries, the
        # exchange and mailbox overflow, the counters and the savings)
        # and ONE stacked MAX the max-telemetry
        g = comm.all_reduce(gsum, "sum")
        pm = comm.all_reduce(gmax, "max")
        # the previous cycle's summed end activity is this cycle's start
        # activity (the runner seeds ``activeg`` once a window)
        inc = torch.cat([s["activeg"].clamp(max=1), g[4:6],
                         g[3:4].clamp(max=1), g[6:12]], 0)
        sc = s["scalars"]
        row_sc = torch.arange(_NSCALAR, device=sc.device)[:, None]
        # the overflow row is sticky (max), every other row accumulates
        s["scalars"] = torch.where(row_sc == _SC_OVERFLOW,
                                   torch.maximum(sc, inc), sc + inc)
        s["msg_counts"] = s["msg_counts"] + g[12:12 + _NTYPES]
        s["activeg"] = g[0:1]
        s["xmsgs"] = s["xmsgs"] + g[1:2]
        s["exchov"] = torch.maximum(s["exchov"], g[2:3])
        s["exchmc"] = s["exchmc"] + g[12 + _NTYPES:13 + _NTYPES]
        s["exchcb"] = s["exchcb"] + g[13 + _NTYPES:14 + _NTYPES]
        s["exchhw"] = torch.maximum(s["exchhw"], pm[0:1])
        s["exchdg"] = torch.maximum(s["exchdg"], pm[1:2])
        s["exchdc"] = torch.maximum(s["exchdc"], pm[2:3])
        return s


    def time_kept(self, reps: int = 10) -> Dict[str, dict]:
        """Each kept stage, its kernel and its plain version, on fresh
        copies of the kept inputs, timed by CUDA events on the card (the
        median of ``reps`` runs, ms): ``ms`` the launch alone (events
        around it, the stream held busy while the host enqueues it),
        ``wrapper_ms`` and ``plain_ms`` the whole call, the wrapper's
        allocations and host work included; and the bytes it must move
        (:meth:`_stage_bytes`).  A kernel runs on the same copy of the
        planes every rep, the kept values copied back in before it (not
        timed), as a cycle's stages find the rank's planes where they
        were: so its NodeArgs are built once, as on the main path.
        ``grid`` is the last timed launch's (:func:`geometry`) and
        ``empty_ms`` an empty kernel's launch of that grid, timed alike
        (:func:`empty_launch_ms`: the floor of a launch)."""
        out = {}
        for name in [e.name for e in self.entries if e.name in self.kept]:
            kept = self.kept[name]
            work = (None if name == self.BUCKET.name else _copies(kept[0]))

            def restore(s0, work=work):
                for f, v in s0.items():
                    if f not in ("tr", "tr_len"):
                        work[f].copy_(v)
                return work

            dev = (kept[0] if name == self.BUCKET.name
                   else kept[0]["nsw"]).device

            def med(fn):
                ms = sorted(_elapsed_ms(fn(), dev) for _ in range(reps))
                return ms[len(ms) // 2]

            def launch_ms(fn):
                self.timed = []
                try:
                    for _ in range(reps):
                        fn()()
                    torch.cuda.synchronize(dev)
                    ms = sorted(a.elapsed_time(b) for a, b in self.timed)
                finally:
                    self.timed = None
                return ms[len(ms) // 2]

            if name == self.AB.name:
                s0, seg, w = kept
                kern_fn = (lambda: functools.partial(
                    self.node_ab, restore(s0), seg, w))
                plain_fn = (lambda: functools.partial(
                    ab_plain, self, _copies(s0), seg, w))
            elif name == self.BUCKET.name:
                fsbuf, fs0, blocks, dests, k, src, combine = kept

                def kern_fn():
                    self.bucketer.fsbuf = fsbuf.clone()
                    fs = dict(zip(exchange.FSTATS,
                                  self.bucketer.fsbuf.unbind(0)))
                    return functools.partial(self.bucketer, fs, blocks,
                                             dests, k, src, combine)
                plain_fn = (lambda: functools.partial(
                    self.bucketer.plain, dict(fs0), blocks, dests, k, src,
                    combine))
            elif name == self.DELIVER.name:
                s0, blocks, origins = kept
                kern_fn = (lambda: functools.partial(
                    self.node_deliver, restore(s0), blocks, origins))
                plain_fn = (lambda: functools.partial(
                    deliver_plain, self, _copies(s0), blocks, origins))
            else:
                s0, acc, cnt, fs, seg, w = kept
                kern_fn = (lambda: functools.partial(
                    self.node_settle, restore(s0), acc, cnt, fs, seg, w))
                plain_fn = (lambda: functools.partial(
                    settle_plain, self, _copies(s0), acc, cnt, fs, seg, w))
            entry = next(e for e in self.entries if e.name == name)
            ms = launch_ms(kern_fn)
            grid = geometry(entry, self.last_args[name], dev)
            out[name] = dict(ms=ms, wrapper_ms=med(kern_fn),
                             plain_ms=med(plain_fn),
                             bytes=self._stage_bytes(name, kept), grid=grid,
                             empty_ms=empty_launch_ms(grid, dev, reps))
        return out

    def _stage_bytes(self, name: str, kept) -> int:
        """The bytes stage ``name`` must move on the kept inputs, each
        once: what its body reads (counted below, stage by stage, from
        what this cycle's data needs), the plane elements whose value it
        changes (by its plain version on a copy of the inputs) and its
        outputs."""
        W, SW, R, nl = self.W, self.SW, self.R, self.nl
        if name == self.BUCKET.name:
            _, fs0, blocks, dests, k, src, combine = kept
            _, sels = self.bucketer.plain(
                {f: v.clone() for f, v in fs0.items()}, blocks, dests, k,
                src, combine)
            bb = blocks[0].shape[-1]
            # every entry's recv and fan-mask rows (and key row under
            # hier) of the blocks it scans, the R rows of the entries a
            # buffer takes, the buffers and placements written, and the
            # telemetry rows read and written
            scan = (1 + SW + (1 if combine else 0)) * 4 * bb
            return (sum(blocks[i].shape[1] for i in {d.block for d in dests})
                    * scan
                    + sum(int((sel < k).sum()) for sel in sels) * R * 4
                    + sum(d.compact for d in dests) * R * k * bb * 4
                    + sum(sel.numel() * sel.element_size() for sel in sels)
                    + 2 * len(exchange.FSTATS) * bb * 4)
        s0 = kept[0]
        bb = s0["nsw"].shape[1]
        node = nl * bb * 4                    # one word a node and lane
        recvs = _ob_recvs(self, s0)
        recv_b = (s0["ob_recv"] if "ob_recv" in s0 else
                  s0[f"ob{self.layout['recv'][0]}"]).element_size()
        inv_b = sum(s0[f"ob{w}"][:, 2].element_size() for w in range(W))
        word_b = sum(s0[f"ob{w}"].element_size() for w in range(W))
        if name == self.AB.name:
            _, seg, w = kept
            upd, payload, cnt = ab_plain(self, _copies(s0), seg, w)
            count = s0["nsw"] & _scalar_layout(self.config, w)["count_mask"]
            mb_b = sum(s0[f"mb{q}"].element_size() for q in range(W))
            deferred = sum(int((recvs[q] >= 0).sum()) for q in (0, 1, 3, 4))
            # nsw, the trace word and tr_len, the cache and directory
            # words the instruction and the head touch, the four deferred
            # receivers and the INV slot, a node; the occupied mailbox
            # slots (the head and the rotation) and the deferred slots'
            # words
            reads = (node * (3 + 3 + SW) + 4 * nl * bb * recv_b
                     + nl * bb * inv_b + int(count.sum()) * mb_b
                     + deferred * word_b)
            return (reads + _changed_bytes(s0, upd)
                    + (payload.numel() + cnt.numel()) * 4)
        if name == self.DELIVER.name:
            blocks, origins = kept[1], kept[2]
            upd, fbs = deliver_plain(self, _copies(s0), blocks, origins)
            j = sum(b.shape[1] for b in blocks)
            # a receiver reads one fan-mask word: the words of this
            # rank's nodes
            mw = len({g // _SPLIT_BPW for g in range(self.me * nl,
                                                     (self.me + 1) * nl)})
            fb = torch.cat([f.reshape(1 + SW, -1) for f in fbs], 1)
            # every entry's phase flag, recv and those mask words, once;
            # nsw; the W words of the entries taken; written: the
            # mailbox slots and nsw words that change, and every
            # feedback word (the kernel writes them all)
            reads = (j * (2 + mw) * bb * 4 + node
                     + int((fb[0] != 0).sum()) * W * 4)
            return reads + _changed_bytes(s0, upd) + fb.numel() * 4
        acc, cnt, fs, seg, w = kept[1:]
        upd, gsum, gmax = settle_plain(self, _copies(s0), acc, cnt, fs,
                                       seg, w)
        delivered = int((acc[0] != 0).sum()) - int((acc[0, 2:3 * nl:3]
                                                     != 0).sum())
        snap = _changed_bytes(s0, {f: v for f, v in upd.items()
                                   if f.startswith("snap_")})
        # the acceptance words a node reads (its four slots' counts, the
        # INV slot's count and mask words), its four receivers and the
        # INV slot, nsw, tr_len and (snapshots) snap_taken; a delivered
        # slot's type word; the copied rows of a snapshot; the lane
        # rows of the counters, the telemetry and the cycle
        reads = (node * (5 + SW + 2 + (1 if self.snapshots else 0))
                 + 4 * nl * bb * recv_b + nl * bb * inv_b
                 + delivered * s0[f"ob{self.layout['type'][0]}"]
                 .element_size()
                 + snap + (AB_COUNTS + len(exchange.FSTATS) + 1) * bb * 4)
        return (reads + _changed_bytes(s0, upd)
                + (gsum.numel() + gmax.numel()) * 4)


def geometry(entry: kernels.KernelEntry, args: ctypes.Structure,
             device: torch.device) -> Dict[str, int]:
    """What the card makes of a launch of ``entry`` with ``args`` (its
    NodeArgs, or BucketArgs for N2; the wide family's WideArgs and
    WideBucketArgs, its main launch): CTAs, threads a CTA, bytes of
    dynamic shared memory, lanes a CTA, CTAs an SM holds at once, CTAs a
    cluster, and the SMs the grid covers (one CTA each at least while
    there are fewer CTAs than SMs).  Launches nothing; the card only."""
    kernels.NODE_CYCLE.build()
    fn = kernels.NODE_CYCLE._lib.hpa2_node_geometry
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 6)()
    which = [e.name for e in ALL_NODE_KERNELS].index(entry.name)
    with torch.cuda.device(device):
        err = fn(which, ctypes.addressof(args), device.index or 0, out)
    if err != 0:
        raise RuntimeError(
            f"{entry.name}: the geometry query failed: CUDA error {err}")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return dict(ctas=out[0], threads=out[1], smem=out[2], lanes=out[3],
                ctas_per_sm=out[4], cluster=out[5], sms=sms,
                sms_covered=min(out[0], sms))


def empty_launch_ms(grid: Dict[str, int], device: torch.device,
                    reps: int = 10) -> float:
    """The median over ``reps`` of an empty kernel's launch as ``grid``
    (:func:`geometry`: CTAs, threads, shared memory), timed as
    :meth:`NodeCycle.time_kept` times a launch alone (ms)."""
    kernels.NODE_CYCLE.build()
    fn = kernels.NODE_CYCLE._lib.hpa2_node_empty
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(device).cuda_stream
    evs = []
    with torch.cuda.device(device):
        for _ in range(reps):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda._sleep(SLEEP_CYCLES)
            ev[0].record()
            err = fn(grid["ctas"], grid["threads"], grid["smem"],
                     device.index or 0, stream)
            ev[1].record()
            if err != 0:
                raise RuntimeError(f"an empty launch failed: CUDA error {err}")
            evs.append(ev)
        torch.cuda.synchronize(device)
    ms = sorted(a.elapsed_time(b) for a, b in evs)
    return ms[len(ms) // 2]


def _changed_bytes(before: Dict[str, torch.Tensor],
                   upd: Dict[str, torch.Tensor]) -> int:
    """The bytes of the elements of ``upd``'s planes that differ from
    ``before``'s: what a stage must write of them."""
    return sum(int((v != before[f]).sum()) * v.element_size()
               for f, v in upd.items())


def _ob_recvs(nc: "NodeCycle", s) -> List[torch.Tensor]:
    """The outbox slots' receivers [nl, B] (-1: the slot is free), from
    ``ob_recv`` or the packed recv field (shipped + 1)."""
    if not nc.recv_packed:
        return [s["ob_recv"][:, k] for k in range(_NSLOTS)]
    return [field(nc.layout, [s[f"ob{w}"][:, k] for w in range(nc.W)],
                  "recv") - 1 for k in range(_NSLOTS)]


def _elapsed_ms(run, dev: torch.device) -> float:
    """``run()``'s time in ms by CUDA events (the card only)."""
    if dev.type != "cuda":
        raise ValueError("time_kept times the kernels on the card")
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    run()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1)


def _copies(s: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Copies of the planes a stage may change (the trace planes are
    only read)."""
    return {f: v if f in ("tr", "tr_len") else v.clone()
            for f, v in s.items()}


# ======================================================================
# The plain versions: the sharded branch of the cycle, split at the
# kernels' seams.  Each takes the state dict and returns the planes it
# changes (new tensors) and its outputs.
# ======================================================================


def _window(s, seg: int, window: int):
    tr = s["tr"][:, seg * window:(seg + 1) * window]
    tl = (s["tr_len"] - seg * window).clamp(0, window)
    return tr, tl


def _gids(nc: NodeCycle, bb: int, dev) -> torch.Tensor:
    return (torch.arange(nc.nl, dtype=I32, device=dev)[:, None]
            + nc.me * nc.nl).expand(nc.nl, bb)


def _sharer_fields(nc: NodeCycle):
    """The message fields that carry a sharer set: ``shr{w}`` in split
    mode, else ``aux``."""
    return ([f"shr{w}" for w in range(nc.SW)] if nc.split else ["aux"])


def _put_fields(nc: NodeCycle, words, vals: Dict[str, torch.Tensor]):
    """``words`` (a list of W word tensors) with ``vals`` ORed into their
    fields."""
    out = list(words)
    for name, v in vals.items():
        w, off, _ = nc.layout[name]
        out[w] = out[w] | (v << off)
    return out


def _cand(rows5, bb: int) -> torch.Tensor:
    """5 x [nl, B] -> [5 nl, B] in the candidate order: the A grid
    sender-major [A0, A1, INV], then the B grid [B0, B1]."""
    return torch.cat([torch.stack(rows5[:3], 1).reshape(-1, bb),
                      torch.stack(rows5[3:], 1).reshape(-1, bb)], 0)


def ab_plain(nc: NodeCycle, s, seg: int, window: int):
    """N1's plain version: ``(planes changed, payload [W + SW + 3, 5 nl,
    B], counters [7, B])``."""
    W, SW, layout = nc.W, nc.SW, nc.layout
    dev = s["nsw"].device
    bb = s["nsw"].shape[1]
    tr, tl = _window(s, seg, window)
    st = dict(s, tr=tr, tr_len=tl)
    if nc.packed:
        st["cachew"] = _widen_cache(*(s[f] for f in _PACKED_CACHE))
        st["dirw"] = _widen_dir(*(s[f] for f in _PACKED_DIR))
    gids = _gids(nc, bb, dev)
    v = nc.phase_ab(st, gids)
    slots5, words5, inv_shw = v["slots5"], v["words5"], v["inv_shw"]
    recvs = [sl["recv"] for sl in slots5]
    zero = torch.zeros((nc.nl, bb), dtype=I32, device=dev)

    # the payload: wire words, fan-mask words, recv + 1, the phase-A
    # flag and the combining key (addr + 1 of a READ request)
    cand_words = [_cand([words5[k][w] for k in range(_NSLOTS)], bb)
                  for w in range(W)]
    mask_words = [_cand([zero, zero, inv_shw[sw], zero, zero], bb)
                  for sw in range(SW)]
    recv_p1 = _cand([r + 1 for r in recvs], bb)
    isa = (torch.arange(5 * nc.nl, device=dev) < 3 * nc.nl).to(I32)[
        :, None].expand(5 * nc.nl, bb)
    ckey = _cand([
        torch.where((r >= 0) & (field(layout, w5, "type")
                                == int(MsgType.READ_REQUEST)),
                    field(layout, w5, "addr") + 1, 0)
        for r, w5 in zip(recvs, words5)], bb)
    payload = torch.stack(cand_words + mask_words + [recv_p1, isa, ckey], 0)

    # the outbox: every candidate with the fields it keeps if deferred
    inv_any = inv_shw[0] != 0
    for sw in range(1, SW):
        inv_any = inv_any | (inv_shw[sw] != 0)
    inv_w = _put_fields(nc, words5[2],
                        dict(zip(_sharer_fields(nc), inv_shw)))
    ob = []
    for w in range(W):
        col = []
        for k in range(_NSLOTS):
            if k == 2:
                col.append(torch.where(inv_any, inv_w[w], 0))
                continue
            x = words5[k][w]
            if nc.recv_packed and w == layout["recv"][0]:
                x = x | ((recvs[k] + 1) << layout["recv"][1])
            col.append(torch.where(recvs[k] >= 0, x, 0))
        ob.append(torch.stack(col, 1))
    slsc = _scalar_layout(nc.config, window)
    upd = {
        "nsw": (v["count2"] | (v["waiting"] << slsc["off_wait"])
                | (v["pending_write"] << slsc["off_pw"])
                | (v["pc"] << slsc["off_pc"])),
    }
    if not nc.recv_packed:
        upd["ob_recv"] = torch.stack(
            [torch.where(r >= 0, r, -1) if k != 2 else torch.full_like(r, -1)
             for k, r in enumerate(recvs)], 1)
    for w in range(W):
        upd[f"mb{w}"] = v["qdata"][w]
        upd[f"ob{w}"] = ob[w]
    for w, x in enumerate(v["dirsp"]):
        upd[f"dirs{w}"] = x
    if nc.packed:
        upd["cvalw"], upd["cmetaw"] = _narrow_cache(v["cachew"],
                                                    nc.pdt["cmetaw"])
        upd["dmemw"], upd["dmetaw"] = _narrow_dir(v["dirw"], nc.pdt["dmetaw"])
    else:
        upd["cachew"], upd["dirw"] = v["cachew"], v["dirw"]
    cnt = torch.stack([_isum(v[f], 0) for f in (
        "elig", "rh", "rm", "wh", "wm", "ev", "inv_applied")], 0)
    return upd, payload, cnt


def deliver_plain(nc: NodeCycle, s, blocks: Sequence[torch.Tensor],
                  origins: Sequence[int]):
    """N3's plain version: ``(planes changed, acceptance rows of each
    block)``.  Every entry this rank holds is offered to its receivers in
    the global order, ranked from its origin tag (the received blocks
    sit in the exchange's round order)."""
    W, SW, cap, bpw = nc.W, nc.SW, nc.cap, _SPLIT_BPW
    dev = s["nsw"].device
    nl, bb = s["nsw"].shape
    gids = _gids(nc, bb, dev)
    slsc = _scalar_layout(nc.config, s["tr"].shape[1])
    count2 = s["nsw"] & slsc["count_mask"]
    ent = torch.cat(list(blocks), 1)                          # [R, J, B]
    bounds = [0]
    for b in blocks:
        bounds.append(bounds[-1] + b.shape[1])
    # validity per (receiver row, entry): a point match on the shifted
    # recv, or the receiver's bit in the fan mask; a receiver's bit lies
    # in one word, so one word a row is read
    gid_row = gids[:, 0].to(torch.int64)                      # [nl]
    pv_rj = gids[:, None, :] + 1 == ent[W + SW][None]         # [nl, J, B]
    word_r = ent[W:W + SW].index_select(0, gid_row // bpw)
    inv_rj = ((word_r >> (gid_row % bpw).to(I32)[:, None, None]) & 1) != 0
    del word_r
    valid_rj = pv_rj | inv_rj
    del pv_rj, inv_rj
    isa = ent[W + SW + 1][None] != 0
    offs = exchange.ordered_rank(valid_rj & isa, valid_rj & ~isa, bounds,
                                 origins, axis=1)
    pos = count2[:, None, :] + offs
    del offs
    accept = valid_rj & (pos < cap)
    del valid_rj
    acc = _isum(accept, 1)                                    # a row
    # each mailbox slot's entry: an accepted entry's index scattered to
    # its slot count2 + rank (distinct for one receiver), the rest to a
    # trash slot past the end; then every wire word of the filled slots
    # in one gather
    j_all = ent.shape[1]
    slot = torch.where(accept, pos, cap).long()
    del pos
    which = torch.full((nl, cap + 1, bb), j_all, dtype=torch.int64,
                       device=dev)
    which.scatter_(1, slot, torch.arange(
        j_all, device=dev)[None, :, None].expand(nl, j_all, bb))
    del slot
    which = which[:, :cap]                                    # [nl, cap, B]
    words = ent[:W].gather(1, which.clamp(max=j_all - 1).reshape(
        1, nl * cap, bb).expand(W, -1, -1)).reshape(W, nl, cap, bb)
    mbs = torch.where((which < j_all)[None], words,
                      torch.stack([s[f"mb{w}"] for w in range(W)], 0))
    # acceptance feedback: an entry's accepted count and its accepted
    # receivers' bits, word by word (only the words that hold this
    # rank's nodes get any)
    acc_i3 = accept.to(I32)
    del accept
    acc_e = _isum(acc_i3, 0)                                  # [J, B]
    zero_j = torch.zeros_like(acc_e)
    fb_bits = []
    for sw in range(SW):
        r0 = max(sw * bpw - nc.me * nl, 0)
        r1 = min((sw + 1) * bpw - nc.me * nl, nl)
        if r0 >= r1:
            fb_bits.append(zero_j)
            continue
        bit = (gids[r0:r1, :1] - sw * bpw)[:, :, None]        # [r, 1, 1]
        fb_bits.append(_isum(acc_i3[r0:r1] << bit, 0))
    fbrows = torch.stack([acc_e] + fb_bits, 0)                # [1+SW, J, B]
    upd = {f"mb{w}": mbs[w] for w in range(W)}
    upd["nsw"] = s["nsw"] + acc
    return upd, [fbrows[:, bounds[i]:bounds[i + 1]]
                 for i in range(len(blocks))]


def settle_plain(nc: NodeCycle, s, acc_tot: torch.Tensor,
                 cnt: torch.Tensor, fs: torch.Tensor, seg: int, window: int):
    """N4's plain version: ``(planes changed, SUM rows [29, B], MAX rows
    [3, B])``; ``acc_tot`` [1 + SW, 5 nl, B] holds every local
    candidate's accepted count and receiver bits."""
    W, SW, layout, nl = nc.W, nc.SW, nc.layout, nc.nl
    dev = s["nsw"].device
    bb = s["nsw"].shape[1]
    slsc = _scalar_layout(nc.config, window)
    _, tl = _window(s, seg, window)
    nsw = s["nsw"]
    count3 = nsw & slsc["count_mask"]
    waiting = (nsw >> slsc["off_wait"]) & 1
    pc = (nsw >> slsc["off_pc"]) & slsc["pc_mask"]
    obk = [[s[f"ob{w}"][:, k] for w in range(W)] for k in range(_NSLOTS)]
    recvs = _ob_recvs(nc, s)
    acc_j = acc_tot[0]                                        # [J0, B]
    dcount = torch.cat([acc_j[:3 * nl].reshape(nl, 3, bb),
                        acc_j[3 * nl:].reshape(nl, 2, bb)], 1)
    inv_shw = [field(layout, obk[2], f) for f in _sharer_fields(nc)]
    remaining = [inv_shw[sw] & ~acc_tot[1 + sw, 2:3 * nl:3]
                 for sw in range(SW)]
    rem_any = remaining[0] != 0
    for sw in range(1, SW):
        rem_any = rem_any | (remaining[sw] != 0)
    md = _isum(dcount, (0, 1))
    types = [field(layout, obk[k], "type") if k != 2
             else torch.full_like(recvs[2], int(MsgType.INV))
             for k in range(_NSLOTS)]
    mc = torch.zeros((_NTYPES, bb), dtype=I32, device=dev)
    mc.scatter_add_(0, torch.stack(types, 1).reshape(-1, bb).long(),
                    dcount.reshape(-1, bb))
    defer5 = [((dcount[:, k] == 0) & (recvs[k] >= 0)) if k != 2 else rem_any
              for k in range(_NSLOTS)]
    blocked_next = defer5[0] | defer5[1] | defer5[2] | defer5[3] | defer5[4]

    # the outbox: undelivered slots stay, the INV slot keeps the
    # receivers that did not accept
    gids = _gids(nc, bb, dev)
    inv_w = [torch.zeros_like(nsw) for _ in range(W)]
    inv_w = _put_fields(nc, inv_w, {
        "type": torch.full_like(nsw, int(MsgType.INV)),
        "addr": field(layout, obk[2], "addr"), "sender": gids,
        **dict(zip(_sharer_fields(nc), remaining))})
    upd = {}
    for w in range(W):
        upd[f"ob{w}"] = torch.stack(
            [torch.where(defer5[k], obk[k][w] if k != 2 else inv_w[w], 0)
             for k in range(_NSLOTS)], 1)
    if not nc.recv_packed:
        upd["ob_recv"] = torch.stack(
            [torch.where(defer5[k], recvs[k], -1) for k in range(_NSLOTS)],
            1)

    # ===== phase D: dump-at-local-completion snapshots ===============
    if nc.snapshots:
        done_node = ((pc >= tl) & (waiting == 0) & (count3 == 0)
                     & ~blocked_next)
        taken = s["snap_taken"] != 0
        s2 = (done_node & ~taken)[:, None, :]
        upd["snap_taken"] = (taken | done_node).to(I32)
        live = (list(_PACKED_CACHE + _PACKED_DIR) if nc.packed
                else ["cachew", "dirw"])
        live += [f"dirs{w}" for w in range(_split_sw(nc.config))]
        for f in live:
            upd[f"snap_{f}"] = torch.where(s2, s[f], s[f"snap_{f}"])

    def row(x):
        return _isum(x, 0)

    end_active = (row((tl - pc).clamp(min=0)) + row(waiting) + row(count3)
                  + sum(row(d5) for d5 in defer5))
    ov_inc = _isum(count3 > nc.cap, 0).clamp(max=1)
    f = {name: fs[i] for i, name in enumerate(exchange.FSTATS)}
    gsum = torch.stack(
        [end_active, f["sent"], f["overflow"].clamp(max=1), ov_inc, cnt[0],
         md] + list(cnt[1:]) + list(mc) + [f["mc_saved"], f["combined"]], 0)
    dg = f["ovf_diag"]
    dc = torch.where(dg > 0, (dg & ~0xFFFF)
                     | (s["scalars"][_SC_CYCLE] & 0xFFFF), 0)
    gmax = torch.stack([f["hwm"], dg, dc], 0)
    return upd, gsum, gmax


__all__ = [
    "AB_COUNTS", "ALL_NODE_KERNELS", "CYCLES", "MAX_SHARDS", "NODE_AB",
    "NODE_AB_WIDE", "NODE_BUCKET", "NODE_BUCKET_WIDE", "NODE_DELIVER",
    "NODE_DELIVER_WIDE", "NODE_KERNELS", "NODE_SETTLE", "NODE_SETTLE_WIDE",
    "NodeArgs", "NodeBucketer", "NodeCycle", "BucketArgs", "WIDE_KERNELS",
    "WideArgs", "WideBucketArgs", "ab_plain", "wide_ab_scratch",
    "check_node_kernel_bound", "deliver_plain", "geometry", "settle_plain",
]
