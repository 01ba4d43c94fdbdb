"""Struct-of-arrays state of the general engine, the port of
``hpa2_tpu/ops/state.py``.

``SimState`` has every field of the JAX ``SimState`` (l.78-170), in the
same order and with the same meaning, but always with a leading batch
axis: the JAX step is written for one system and vmapped
(``hpa2_tpu/ops/engine.py:437-441``), while the port's step
(``ops/step.py``) is written for ``[B, N, ...]`` tensors and a single
system is the case ``B = 1``.  Per-system scalars are ``[B]``; the
replay order is ``[B, L]``.  Fields that are uint32 in JAX
(``dir_sharers``, ``ob_sharers``, ``snap_dir_sharers``, ``rng_key``)
are int32 tensors with the same bits.  ``convert.py`` carries a JAX
state to the port and back.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.models.protocol import (
    INVALID_ADDR,
    CacheState,
    DirState,
    Instr,
    MsgType,
)
from hpa2_tpu_torch.ops import prng
from hpa2_tpu_torch.utils.trace import IssueRecord

I32 = torch.int32

# mb_data column layout.  Sharer words occupy [MB_SHARERS, MB_SHARERS+W);
# non-ideal interconnect builds append one deliver-at column at 5 + W.
MB_TYPE, MB_SENDER, MB_ADDR, MB_VALUE, MB_SECOND, MB_SHARERS = 0, 1, 2, 3, 4, 5


def mb_width(config: SystemConfig) -> int:
    """mb_data row width: 5 + sharer words (+ deliver-at column when a
    non-ideal topology is configured)."""
    return 5 + config.sharer_words + (1 if config.interconnect.enabled else 0)


def num_links(config: SystemConfig) -> int:
    """Length of the per-link counter planes (>= 1 so ideal states
    keep a fixed-shape placeholder instead of a zero-width array)."""
    ic = config.interconnect
    if not ic.enabled:
        return 1
    from hpa2_tpu_torch.interconnect.topology import build_topology

    return max(
        1, build_topology(ic.topology, config.num_procs,
                          ic.hop_latency).num_links
    )


def _mb_empty_row(w: int, deliver: bool = False) -> np.ndarray:
    """Packed empty-slot sentinel (type=-1, second=-1)."""
    return np.array(
        [-1, 0, 0, 0, -1] + [0] * w + ([0] if deliver else []),
        dtype=np.int32,
    )


def _mem_init(n: int, m: int) -> np.ndarray:
    """Reference memory init ``(20*id + i) mod 256`` (assignment.c:779)."""
    return np.array(
        [[(20 * i + j) % 256 for j in range(m)] for i in range(n)],
        dtype=np.int32,
    )


class SimState(NamedTuple):
    """A batch of simulated systems (leading axis B on every field)."""

    # caches [B, N, C]
    cache_addr: torch.Tensor
    cache_val: torch.Tensor
    cache_state: torch.Tensor
    # home memory + directory [B, N, M] (+ [W] sharer words)
    mem: torch.Tensor
    dir_state: torch.Tensor
    dir_sharers: torch.Tensor  # [B, N, M, W] uint32 bits
    # protocol-variant owner/forwarder pointer [B, N, M] (-1 = none)
    dir_owner: torch.Tensor
    # mailboxes: shift-down FIFO queues, head at slot 0, one packed
    # [B, N, cap, F] int32 plane (columns MB_*)
    mb_data: torch.Tensor
    mb_count: torch.Tensor  # [B, N]
    # core state [B, N]
    pc: torch.Tensor
    waiting: torch.Tensor  # bool
    pending_write: torch.Tensor
    # deferred-send outbox [B, N, 5] (slots A0, A1, AINV, B0, B1)
    ob_valid: torch.Tensor
    ob_recv: torch.Tensor
    ob_type: torch.Tensor
    ob_addr: torch.Tensor
    ob_value: torch.Tensor
    ob_second: torch.Tensor
    ob_sharers: torch.Tensor  # [B, N, 5, W] uint32 bits
    # traces [B, N, T]
    tr_op: torch.Tensor  # 0 = RD, 1 = WR
    tr_addr: torch.Tensor
    tr_val: torch.Tensor
    tr_len: torch.Tensor  # [B, N]
    # replay schedule [B, L] (L=1 dummy when not replaying)
    order_node: torch.Tensor
    order_pos: torch.Tensor  # [B]
    order_len: torch.Tensor  # [B]
    # dump-at-local-completion snapshots
    snap_taken: torch.Tensor  # [B, N] bool
    snap_mem: torch.Tensor
    snap_dir_state: torch.Tensor
    snap_dir_sharers: torch.Tensor
    snap_dir_owner: torch.Tensor
    snap_cache_addr: torch.Tensor
    snap_cache_val: torch.Tensor
    snap_cache_state: torch.Tensor
    # bookkeeping [B]
    cycle: torch.Tensor
    n_instr: torch.Tensor
    n_msgs: torch.Tensor
    overflow: torch.Tensor  # bool
    n_read_hits: torch.Tensor
    n_read_miss: torch.Tensor
    n_write_hits: torch.Tensor
    n_write_miss: torch.Tensor
    n_evictions: torch.Tensor
    n_invalidations: torch.Tensor
    msg_counts: torch.Tensor  # [B, len(MsgType)]
    # link-layer faults + watchdog
    rng_key: torch.Tensor        # [B, 2] uint32 bits
    last_progress: torch.Tensor
    n_retrans: torch.Tensor
    n_dup_filtered: torch.Tensor
    n_reorder_fixed: torch.Tensor
    n_delays: torch.Tensor
    n_wire_stalls: torch.Tensor
    # interconnect model counters; per-link planes [B, num_links]
    link_traversals: torch.Tensor
    link_max_load: torch.Tensor
    n_topo_delay: torch.Tensor
    n_multicast_saved: torch.Tensor
    n_combined: torch.Tensor
    # event-driven elision counters
    n_elided: torch.Tensor
    n_multi_hit: torch.Tensor
    # protocol-variant counters
    n_forwards: torch.Tensor
    n_owner_xfer: torch.Tensor
    n_dir_overflow: torch.Tensor
    # cross-shard exchange telemetry (zero: the port has no node
    # sharding yet)
    n_exch_sent: torch.Tensor
    n_exch_hwm: torch.Tensor
    n_exch_mc_saved: torch.Tensor
    n_exch_combined: torch.Tensor


#: fields whose JAX dtype is uint32 (int32 bit patterns here)
U32_FIELDS = ("dir_sharers", "ob_sharers", "snap_dir_sharers", "rng_key")


def _build(config: SystemConfig, tr_op, tr_addr, tr_val, tr_len,
           order_node, order_len, rng_key, device) -> SimState:
    b, n, _ = tr_op.shape
    c, m, w = config.cache_size, config.mem_size, config.sharer_words
    cap = config.msg_buffer_size
    topo_on = config.interconnect.enabled
    links = num_links(config)
    dev = torch.device(device)

    def full(shape, val, dt=I32):
        return torch.full(shape, val, dtype=dt, device=dev)

    def zeros(shape, dt=I32):
        return torch.zeros(shape, dtype=dt, device=dev)

    def arr(x):
        return torch.from_numpy(np.array(x, np.int32)).to(dev)

    mem0 = arr(np.broadcast_to(_mem_init(n, m), (b, n, m)))
    row = arr(_mb_empty_row(w, topo_on))
    return SimState(
        cache_addr=full((b, n, c), INVALID_ADDR),
        cache_val=zeros((b, n, c)),
        cache_state=full((b, n, c), int(CacheState.INVALID)),
        mem=mem0,
        dir_state=full((b, n, m), int(DirState.U)),
        dir_sharers=zeros((b, n, m, w)),
        dir_owner=full((b, n, m), -1),
        mb_data=row.expand(b, n, cap, row.shape[0]).contiguous(),
        mb_count=zeros((b, n)),
        pc=zeros((b, n)),
        waiting=zeros((b, n), torch.bool),
        pending_write=zeros((b, n)),
        ob_valid=zeros((b, n, 5), torch.bool),
        ob_recv=zeros((b, n, 5)),
        ob_type=full((b, n, 5), -1),
        ob_addr=zeros((b, n, 5)),
        ob_value=zeros((b, n, 5)),
        ob_second=full((b, n, 5), -1),
        ob_sharers=zeros((b, n, 5, w)),
        tr_op=arr(tr_op),
        tr_addr=arr(tr_addr),
        tr_val=arr(tr_val),
        tr_len=arr(tr_len),
        order_node=arr(order_node),
        order_pos=zeros((b,)),
        order_len=arr(order_len),
        snap_taken=zeros((b, n), torch.bool),
        snap_mem=mem0.clone(),
        snap_dir_state=full((b, n, m), int(DirState.U)),
        snap_dir_sharers=zeros((b, n, m, w)),
        snap_dir_owner=full((b, n, m), -1),
        snap_cache_addr=full((b, n, c), INVALID_ADDR),
        snap_cache_val=zeros((b, n, c)),
        snap_cache_state=full((b, n, c), int(CacheState.INVALID)),
        cycle=zeros((b,)),
        n_instr=zeros((b,)),
        n_msgs=zeros((b,)),
        overflow=zeros((b,), torch.bool),
        n_read_hits=zeros((b,)),
        n_read_miss=zeros((b,)),
        n_write_hits=zeros((b,)),
        n_write_miss=zeros((b,)),
        n_evictions=zeros((b,)),
        n_invalidations=zeros((b,)),
        msg_counts=zeros((b, len(MsgType))),
        rng_key=rng_key.to(dev),
        last_progress=zeros((b,)),
        n_retrans=zeros((b,)),
        n_dup_filtered=zeros((b,)),
        n_reorder_fixed=zeros((b,)),
        n_delays=zeros((b,)),
        n_wire_stalls=zeros((b,)),
        link_traversals=zeros((b, links)),
        link_max_load=zeros((b, links)),
        n_topo_delay=zeros((b,)),
        n_multicast_saved=zeros((b,)),
        n_combined=zeros((b,)),
        n_elided=zeros((b,)),
        n_multi_hit=zeros((b,)),
        n_forwards=zeros((b,)),
        n_owner_xfer=zeros((b,)),
        n_dir_overflow=zeros((b,)),
        n_exch_sent=zeros((b,)),
        n_exch_hwm=zeros((b,)),
        n_exch_mc_saved=zeros((b,)),
        n_exch_combined=zeros((b,)),
    )


def _check_arrays(config: SystemConfig, tr_op, tr_addr, tr_val, tr_len):
    b, n, t = tr_op.shape
    if n != config.num_procs:
        raise ValueError(f"trace node axis {n} != num_procs {config.num_procs}")
    for name, a in (("tr_addr", tr_addr), ("tr_val", tr_val)):
        if a.shape != (b, n, t):
            raise ValueError(f"{name} shape {a.shape} != {(b, n, t)}")
    if tr_len.shape != (b, n):
        raise ValueError(f"tr_len shape {tr_len.shape} != {(b, n)}")
    if np.any(tr_len < 0) or np.any(tr_len > t):
        raise ValueError(f"tr_len out of range 0..{t}")


def init_state_batched(
    config: SystemConfig,
    tr_op: np.ndarray,
    tr_addr: np.ndarray,
    tr_val: np.ndarray,
    tr_len: np.ndarray,
    device="cuda",
    fold_keys: bool = True,
) -> SimState:
    """Batched initial state straight from ``[B, N, T]`` trace arrays
    (op: 0=RD, 1=WR, -1=pad) and ``[B, N]`` lengths, as
    ``hpa2_tpu/ops/state.py:init_state_batched`` (l.182): system ``b``'s
    key is ``fold_in(PRNGKey(fault.seed), b)``.  ``fold_keys=False``
    gives every system ``PRNGKey(fault.seed)``, as stacking
    :func:`init_state` systems does (``BatchJaxEngine``)."""
    _check_arrays(config, tr_op, tr_addr, tr_val, tr_len)
    b = tr_op.shape[0]
    key = prng.PRNGKey(config.fault.seed)
    if fold_keys:
        keys = prng.fold_in(key, torch.arange(b))
    else:
        keys = key.expand(b, 2).contiguous()
    return _build(config, tr_op, tr_addr, tr_val, tr_len,
                  np.full((b, 1), -1, np.int32), np.full((b,), -1, np.int32),
                  keys, device)


def trace_arrays(config: SystemConfig, traces: Sequence[Sequence[Instr]],
                 max_trace_len: Optional[int] = None):
    """One system's traces -> ``[N, T]`` op/addr/val and ``[N]`` length
    arrays, T = max(max_trace_len, longest trace, 1)."""
    n = config.num_procs
    t = max(
        max_trace_len or 0, max((len(tr) for tr in traces), default=0), 1
    )
    tr_op = np.full((n, t), -1, dtype=np.int32)
    tr_addr = np.zeros((n, t), dtype=np.int32)
    tr_val = np.zeros((n, t), dtype=np.int32)
    tr_len = np.zeros((n,), dtype=np.int32)
    for i, tr in enumerate(traces):
        tr_len[i] = len(tr)
        for j, ins in enumerate(tr):
            tr_op[i, j] = 0 if ins.op == "R" else 1
            tr_addr[i, j] = ins.address
            tr_val[i, j] = ins.value
    return tr_op, tr_addr, tr_val, tr_len


def init_state(
    config: SystemConfig,
    traces: Sequence[Sequence[Instr]],
    replay_order: Optional[Sequence[IssueRecord]] = None,
    max_trace_len: Optional[int] = None,
    device="cuda",
) -> SimState:
    """The initial state of one system, as a batch of one
    (``hpa2_tpu/ops/state.py:init_state``, l.289: memory
    ``(20*id+i) mod 256``, directory all U/empty, caches invalid, key
    ``PRNGKey(fault.seed)``)."""
    tr_op, tr_addr, tr_val, tr_len = trace_arrays(config, traces,
                                                  max_trace_len)
    if replay_order is not None:
        order_node = np.array([r.proc for r in replay_order], dtype=np.int32)
        if order_node.size == 0:
            order_node = np.array([-1], dtype=np.int32)
        order_len = len(replay_order)
    else:
        order_node = np.array([-1], dtype=np.int32)
        order_len = -1  # free-run
    return _build(config, tr_op[None], tr_addr[None], tr_val[None],
                  tr_len[None], order_node[None],
                  np.array([order_len], np.int32),
                  prng.PRNGKey(config.fault.seed)[None], device)


def stack_states(states: Sequence[SimState]) -> SimState:
    """Concatenate batches of systems along the batch axis
    (``hpa2_tpu/ops/engine.py:stack_states``, l.411, which stacks
    unbatched states); the replay orders must have one length."""
    return SimState(*(torch.cat(xs, dim=0) for xs in zip(*states)))


def select(st: SimState, idx) -> SimState:
    """Systems ``idx`` (an int, a slice or an index tensor) of a batch,
    as a batch."""
    if isinstance(idx, int):
        idx = slice(idx, idx + 1)
    return SimState(*(x[idx] for x in st))
