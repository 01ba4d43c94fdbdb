"""Static shared-memory budget of one CTA of the fast path's kernels on
Hopper: the port of ``hpa2_tpu/analysis/vmem.py``.

The JAX module models the Pallas kernel's VMEM (16 MiB a TPU core).
On the H100 the binding constraint of a lane block is a CTA's dynamic
shared memory: the streamed run (K2, ``csrc/stream_run.cu``) and the
per-call kernel (K3, ``csrc/call_run.cu``) keep each system's per-node
records, counters and mailbox ring heads in shared memory
(``Shared<MAXN>``, ``csrc/cycle.cuh``), ``group`` systems a round and
``rounds`` rounds a CTA, and a CTA may opt into at most
:data:`SMEM_CAP_BYTES`.  The carried planes live in device memory.
This module predicts, WITHOUT compiling or launching anything:

* the launch geometry of a lane block (``kernels.launch_geometry``
  itself: one cluster of ``cl`` CTAs, ``rounds`` rounds of ``group``
  systems, ``threads`` threads a system);
* a CTA's dynamic shared memory, ``Shared<MAXN>::bytes(group,
  rounds)``, computed here in Python (:func:`shared_bytes`);
* whether it fits, and the CTAs an SM holds by threads and shared
  memory (registers are not modelled: ptxas reports them at build);
* the planes' bytes in device memory, per lane, unpacked or packed.

The module name and the shape of its API (:class:`VmemBudget`,
:func:`vmem_budget`, :func:`budget_table`, :func:`max_fitting_block`)
are the JAX module's.  :func:`max_fitting_block` reproduces
``kernels.MAX_LANE_BLOCK``, which ``scripts/block_limits.py`` measured
on the card, and :func:`measured_vmem_bytes` reads the card's own
figure (``CudaKernel.occupancy``).  ``node_shards > 1`` models one
rank of the fast path's node axis (JAX ``vmem.py:144-175``): every
node-leading plane and the trace window carry the shard's ``num_procs /
node_shards`` rows, ``scalars`` and ``msg_counts`` stay whole.  No CTA
runs there (the node-sharded cycle is PyTorch tensor code), so such a
budget reports one card's plane bytes and no kernel geometry.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.ops import kernels

#: dynamic shared memory a CTA may opt into on the H100
#: (``cudaFuncAttributeMaxDynamicSharedMemorySize``)
SMEM_CAP_BYTES = 232_448
#: shared memory of one SM, and the part of it reserved for each CTA
SMEM_PER_SM = 233_472
SMEM_RESERVED_PER_CTA = 1_024
#: threads and CTAs one SM holds
THREADS_PER_SM = 2_048
CTAS_PER_SM = 32
#: the JAX module's name for the cap
VMEM_CAP_BYTES = SMEM_CAP_BYTES

# csrc/cycle.cuh: kNCount (kNScalar + kNTypes), kSplitBpw, sizeof(NodeRec)
_N_COUNT = 10 + 15
_SPLIT_BPW = 31
_NODE_REC = 24

#: the protocol word planes (unpacked or packed) and split sharer
#: words: the planes ``packed=`` shrinks
_WORD_PLANES = ("cachew", "dirw", "cvalw", "cmetaw", "dmemw", "dmetaw")


def sharer_words(bound: int) -> int:
    """``Bound<MAXN>::SW``: 31-bit sharer words (1 when unsplit)."""
    return -(-bound // _SPLIT_BPW) if bound > 21 else 1


def shared_bytes(bound: int, group: int, rounds: int) -> int:
    """``Shared<MAXN>::bytes(group, rounds)`` of ``csrc/cycle.cuh``: per
    system slot its node records, INV receiver sets and accepted INV
    receivers, its work flag and a round's counters; the mailbox ring
    heads of every round (u16, padded to 4 B); the sent masks; the
    cluster reduction's two words."""
    ksw = sharer_words(bound)
    head = (rounds * bound * group * 2 + 3) & ~3
    return (group * (bound * _NODE_REC + 2 * bound * ksw * 4 + 4
                     + rounds * _N_COUNT * 4)
            + head + 8 * group * 4 + 2 * 4)


@dataclasses.dataclass(frozen=True)
class VmemBudget:
    """Predicted footprint of one lane block of K2/K3: a CTA's shared
    memory, the CTAs an SM holds, and the planes' device bytes."""

    config: SystemConfig
    block: int
    window: int
    snapshots: bool
    gate: bool
    stream: bool
    packed: bool
    node_shards: int
    bound: int                  # the instantiation's node bound
    threads: int                # threads a system
    cl: int                     # CTAs of the block's cluster
    per_cta: int                # systems a CTA
    rounds: int                 # rounds a CTA
    group: int                  # systems a round
    smem_bytes: int             # dynamic shared memory a CTA
    rows: Dict[str, int]        # carried rows/lane per plane
    lane_bytes: Dict[str, int]  # dtype-aware bytes/lane per plane
    carried_rows: int           # sum over carried (non-snapshot) planes
    snap_rows: int              # sum over snapshot planes
    trace_rows: int             # trace window rows/lane (tr + tr_len)
    total_lane_bytes: int       # device bytes a lane: planes + window

    @property
    def cta_threads(self) -> int:
        return self.group * self.threads

    @property
    def total_bytes(self) -> int:
        """Dynamic shared memory a CTA: the quantity that must fit."""
        return self.smem_bytes

    @property
    def fits(self) -> bool:
        return self.smem_bytes <= SMEM_CAP_BYTES

    @property
    def headroom_bytes(self) -> int:
        return SMEM_CAP_BYTES - self.smem_bytes

    @property
    def ctas_per_sm(self) -> int:
        """CTAs an SM holds by threads and shared memory (registers not
        modelled: the card may hold fewer)."""
        if not self.fits or not self.group:
            return 0
        return min(CTAS_PER_SM, THREADS_PER_SM // self.cta_threads,
                   SMEM_PER_SM // (self.smem_bytes + SMEM_RESERVED_PER_CTA))

    @property
    def plane_bytes(self) -> int:
        """Device bytes of the lane block's planes and trace window."""
        return self.total_lane_bytes * self.block


#: the planes every node rank holds whole
_REPLICATED_PLANES = ("scalars", "msg_counts")


def _plane_rows(config: SystemConfig, snapshots: bool,
                packed: bool = False,
                node_shards: int = 1) -> Dict[str, int]:
    from hpa2_tpu_torch.ops.layout import state_shapes

    rows = {}
    for name, prefix in state_shapes(config, snapshots, packed).items():
        if node_shards > 1 and name not in _REPLICATED_PLANES:
            prefix = (prefix[0] // node_shards,) + tuple(prefix[1:])
        rows[name] = int(np.prod(prefix, dtype=np.int64))
    return rows


def _plane_lane_bytes(config: SystemConfig, snapshots: bool,
                      packed: bool = False,
                      node_shards: int = 1) -> Dict[str, int]:
    """Per-plane BYTES per lane: rows times the carried dtype width (4
    for the int32 layout; the packed cache/dir planes 1-2)."""
    from hpa2_tpu_torch.ops.layout import state_dtypes

    rows = _plane_rows(config, snapshots, packed, node_shards)
    dtypes = state_dtypes(config, snapshots, packed)
    return {f: r * np.dtype(dtypes[f]).itemsize for f, r in rows.items()}


def state_plane_bytes(config: SystemConfig, *,
                      packed: bool = False) -> int:
    """Per-lane bytes of the MESI/dir-state/value word planes: the
    quantity the packed layout cuts."""
    lb = _plane_lane_bytes(config, snapshots=False, packed=packed)
    return sum(b for f, b in lb.items()
               if f in _WORD_PLANES or f.startswith("dirs"))


def _check_shards(config: SystemConfig, node_shards: int) -> None:
    if node_shards < 1 or config.num_procs % node_shards:
        raise ValueError(
            f"node_shards={node_shards} must divide "
            f"num_procs={config.num_procs}")


def _no_shards(node_shards: int) -> None:
    if node_shards != 1:
        raise ValueError(
            "node_shards > 1 is the node-sharded fast path, whose cycle "
            "is PyTorch tensor code: no CTA runs there, so no lane block "
            "has to fit")


def vmem_budget(
    config: SystemConfig,
    block: int,
    window: int,
    *,
    snapshots: bool = False,
    gate: bool = False,
    stream: bool = True,
    packed: bool = False,
    node_shards: int = 1,
    max_group: Optional[int] = None,
) -> VmemBudget:
    """Predict the footprint of one lane block of ``block`` systems.

    The shared memory is the same for K2 (``stream=True``) and K3
    (``stream=False``), with or without the gate, snapshots or packed
    planes: it holds per-system records, not planes.  ``window`` and
    ``snapshots`` size the device planes; ``max_group`` caps the systems
    a round (``kernels.launch_geometry``).  ``node_shards > 1``: one
    rank's planes, no kernel geometry (see the module docstring)."""
    _check_shards(config, node_shards)
    if node_shards > 1:
        nl = config.num_procs // node_shards
        rows = _plane_rows(config, snapshots, packed, node_shards)
        lane_bytes = _plane_lane_bytes(config, snapshots, packed,
                                       node_shards)
        trace_rows = nl * window + nl
        return VmemBudget(
            config=config, block=block, window=window, snapshots=snapshots,
            gate=gate, stream=stream, packed=packed,
            node_shards=node_shards, bound=0, threads=0, cl=0, per_cta=0,
            rounds=0, group=0, smem_bytes=0, rows=rows,
            lane_bytes=lane_bytes,
            carried_rows=sum(r for f, r in rows.items()
                             if not f.startswith("snap_")),
            snap_rows=sum(r for f, r in rows.items()
                          if f.startswith("snap_")),
            trace_rows=trace_rows,
            total_lane_bytes=sum(lane_bytes.values()) + trace_rows * 4)
    kernels.check_kernel_bound(config)
    bound = kernels.node_bound(config)
    threads = kernels.threads_per_system(config)
    cl, per_cta, rounds, group = kernels.launch_geometry(block, threads,
                                                         max_group)
    n = config.num_procs
    rows = _plane_rows(config, snapshots, packed)
    lane_bytes = _plane_lane_bytes(config, snapshots, packed)
    snap_rows = sum(r for f, r in rows.items() if f.startswith("snap_"))
    carried_rows = sum(r for f, r in rows.items()
                       if not f.startswith("snap_"))
    trace_rows = n * window + n  # tr + tr_len, int32
    return VmemBudget(
        config=config, block=block, window=window, snapshots=snapshots,
        gate=gate, stream=stream, packed=packed, node_shards=node_shards,
        bound=bound, threads=threads, cl=cl, per_cta=per_cta,
        rounds=rounds, group=group,
        smem_bytes=shared_bytes(bound, group, rounds),
        rows=rows, lane_bytes=lane_bytes, carried_rows=carried_rows,
        snap_rows=snap_rows, trace_rows=trace_rows,
        total_lane_bytes=sum(lane_bytes.values()) + trace_rows * 4,
    )


def _fmt_mb(b: int) -> str:
    return f"{b / (1024 * 1024):7.2f}"


def budget_table(
    config: SystemConfig,
    blocks: Tuple[int, ...] = (512, 1024, 2048),
    window: int = 32,
    *,
    snapshots: bool = False,
    gate: bool = False,
    packed: bool = False,
    node_shards: int = 1,
    measured: Optional[Dict[int, int]] = None,
) -> str:
    """The ``analysis vmem`` report: per lane block, its geometry, a
    CTA's shared memory against the 232,448 B cap, the CTAs an SM
    holds and the planes' device MiB, unpacked and packed.
    ``measured`` maps a block to the card's figure for the same
    launch (``measured_vmem_bytes``), printed beside the model.
    ``node_shards > 1``: one rank's plane bytes a block, no CTA."""
    if node_shards > 1:
        _check_shards(config, node_shards)
        lines = [
            f"node-sharded fast path, one rank of {node_shards}  "
            f"(n={config.num_procs}, {config.num_procs // node_shards} "
            f"nodes a rank, cap={config.msg_buffer_size} window={window} "
            f"snapshots={snapshots} packed={packed}; tensor code, no CTA)",
            f"{'block':>6} {'B/lane':>8} {'planes MiB':>10}",
        ]
        for block in blocks:
            bud = vmem_budget(config, block, window, snapshots=snapshots,
                              gate=gate, packed=packed,
                              node_shards=node_shards)
            lines.append(f"{block:>6} {bud.total_lane_bytes:>8} "
                         f"{_fmt_mb(bud.plane_bytes):>10}")
        return "\n".join(lines)
    lines = [
        f"Hopper CTA budget  (n={config.num_procs} cap="
        f"{config.msg_buffer_size} window={window} snapshots={snapshots}"
        f" gate={gate} packed={packed}; node bound "
        f"{kernels.node_bound(config)}; cap {SMEM_CAP_BYTES} B shared "
        "memory a CTA)",
        f"{'block':>6} {'CTAs':>4} {'group':>5} {'rounds':>6} "
        f"{'threads':>7} {'smem B':>7} {'headroom':>8} {'CTA/SM':>6} "
        f"{'planes MiB':>10} {'card B':>7}  fits",
    ]
    for block in blocks:
        bud = vmem_budget(config, block, window, snapshots=snapshots,
                          gate=gate, packed=packed)
        card = "-" if not measured or block not in measured \
            else str(measured[block])
        lines.append(
            f"{block:>6} {bud.cl:>4} {bud.group:>5} {bud.rounds:>6} "
            f"{bud.cta_threads:>7} {bud.smem_bytes:>7} "
            f"{bud.headroom_bytes:>8} {bud.ctas_per_sm:>6} "
            f"{_fmt_mb(bud.plane_bytes):>10} {card:>7}  "
            f"{'yes' if bud.fits else 'NO'}")
    lines.append(
        f"max fitting block: {max_fitting_block(config, window)} "
        f"(one cluster of {kernels.MAX_CLUSTER} CTAs, whole rounds)")
    return "\n".join(lines)


def max_fitting_block(
    config: SystemConfig,
    window: int = 32,
    *,
    snapshots: bool = False,
    gate: bool = False,
    stream: bool = True,
    packed: bool = False,
    node_shards: int = 1,
    limit: int = 1 << 20,
) -> int:
    """The largest lane block of whole rounds whose CTA fits: one
    cluster of 16 full CTAs (``group`` = 512 / threads a system) in as
    many rounds as the shared memory holds, at most ``limit``
    (``kernels.MAX_LANE_BLOCK`` at each node bound)."""
    _no_shards(node_shards)
    kernels.check_kernel_bound(config)
    bound = kernels.node_bound(config)
    group = kernels.MAX_CTA // kernels.threads_per_system(config)
    most = kernels.MAX_CLUSTER * group
    rounds = 0
    while shared_bytes(bound, group, rounds + 1) <= SMEM_CAP_BYTES \
            and most * (rounds + 1) <= limit:
        rounds += 1
    return most * rounds


def measured_vmem_bytes(config: SystemConfig, block: int, *,
                        lanes: Optional[int] = None, packed: bool = False,
                        device="cuda") -> int:
    """The card's dynamic shared memory a CTA for a K3 launch of lane
    blocks of ``block`` (``CudaKernel.occupancy``: the figure the
    launch passes).  Launches nothing; needs the card."""
    import torch

    from hpa2_tpu_torch.ops.cuda_engine import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError("the measured figure comes from the card")
    args = kernels.geometry_args(config, lanes=lanes or block, block=block,
                                 packed=packed)
    return int(kernels.CALL_RUN.occupancy(args, device=torch.device(dev))
               ["smem"])
