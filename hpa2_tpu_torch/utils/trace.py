"""Trace loading, replay orders, the spec engine's delivery ring and
the synthetic uniform, heterogeneous, producer/consumer, node-local
and eviction ping-pong workloads.

``core_<n>.txt`` holds one instruction per line, ``RD <hexaddr>`` or
``WR <hexaddr> <decvalue>``; values wrap mod 256, blank lines are
skipped, malformed lines and out-of-range addresses raise.  A replay
order (``instruction_order.txt``, the reference's DEBUG_INSTR lines)
pins the issue interleaving of a run; it must be exactly an
interleaving of the traces.  For the
same seed the generators give the same arrays as their namesakes in
``hpa2_tpu.utils.trace`` (``gen_producer_consumer`` l.231,
``gen_local_only`` l.257, ``gen_eviction_pingpong`` l.332 and its
``_arrays`` l.394, ``gen_producer_consumer_arrays`` l.504: the
same numpy ``default_rng`` draws in the same order).  ``TraceRing``
(l.34) is the spec engine's flight recorder.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.models.protocol import Instr, MsgType


class TraceRing:
    """Bounded ring of recent interconnect deliveries for stall
    diagnostics (the flight recorder a watchdog dumps).  Recording is a
    bare tuple append on the delivery path; :meth:`lines` formats."""

    def __init__(self, maxlen: int = 64):
        self.maxlen = maxlen
        self._ring: "collections.deque[Tuple[int, int, int, int, int]]" = (
            collections.deque(maxlen=maxlen)
        )

    def record(
        self, cycle: int, sender: int, receiver: int, mtype: int, address: int
    ) -> None:
        self._ring.append((cycle, sender, receiver, mtype, address))

    def push(self, entry: Tuple[int, int, int, int, int]) -> None:
        """Re-append a raw entry (checkpoint restore)."""
        self._ring.append(entry)

    def entries(self) -> List[Tuple[int, int, int, int, int]]:
        return list(self._ring)

    def __len__(self) -> int:
        return len(self._ring)

    def lines(self) -> List[str]:
        return [
            f"cycle {c}: {s} -> {r} {MsgType(t).name} 0x{a:02X}"
            for c, s, r, t, a in self._ring
        ]

_RD_RE = re.compile(r"^RD\s+(?:0[xX])?([0-9a-fA-F]+)\s*$")
_WR_RE = re.compile(r"^WR\s+(?:0[xX])?([0-9a-fA-F]+)\s+(\d+)\s*$")
_ORDER_RE = re.compile(
    r"^Processor\s+(\d+):\s+instr type=([RW]),\s+address=0x([0-9a-fA-F]+),"
    r"\s+value=(\d+)\s*$"
)


def parse_core_trace(text: str, max_instr: Optional[int] = None) -> List[Instr]:
    """Parse one core trace, capped at ``max_instr`` instructions."""
    instrs: List[Instr] = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        if max_instr is not None and len(instrs) >= max_instr:
            break
        m = _RD_RE.match(line)
        if m:
            instrs.append(Instr("R", int(m.group(1), 16)))
            continue
        m = _WR_RE.match(line)
        if m:
            instrs.append(Instr("W", int(m.group(1), 16), int(m.group(2)) % 256))
            continue
        raise ValueError(f"malformed trace line {lineno}: {raw!r}")
    return instrs


def load_core_trace(path: str, max_instr: Optional[int] = None) -> List[Instr]:
    with open(path, "r") as f:
        return parse_core_trace(f.read(), max_instr)


def load_trace_dir(trace_dir: str, config: SystemConfig) -> List[List[Instr]]:
    """``core_<n>.txt`` for every node; a missing file is an error."""
    cap = config.max_instr_num if config.max_instr_num > 0 else None
    traces = []
    for n in range(config.num_procs):
        path = os.path.join(trace_dir, f"core_{n}.txt")
        trace = load_core_trace(path, cap)
        for i, instr in enumerate(trace):
            if not (0 <= instr.address < config.num_addresses):
                raise ValueError(
                    f"{path} instr {i}: address 0x{instr.address:X} out of "
                    f"range for {config.num_procs} nodes x "
                    f"{config.mem_size} blocks"
                )
        traces.append(trace)
    return traces


@dataclasses.dataclass(frozen=True)
class IssueRecord:
    """One line of instruction_order.txt."""

    proc: int
    op: str  # 'R' | 'W'
    address: int
    value: int


def parse_instruction_order(text: str) -> List[IssueRecord]:
    records = []
    for lineno, raw in enumerate(text.splitlines(), 1):
        line = raw.strip()
        if not line:
            continue
        m = _ORDER_RE.match(line)
        if not m:
            raise ValueError(f"malformed order line {lineno}: {raw!r}")
        records.append(
            IssueRecord(
                proc=int(m.group(1)),
                op=m.group(2),
                address=int(m.group(3), 16),
                value=int(m.group(4)),
            )
        )
    return records


def load_instruction_order(path: str) -> List[IssueRecord]:
    with open(path, "r") as f:
        return parse_instruction_order(f.read())


def format_instruction_order(records: Sequence[IssueRecord]) -> str:
    """Inverse of :func:`parse_instruction_order`: the DEBUG_INSTR
    lines of every shipped ``instruction_order.txt``."""
    return "".join(
        f"Processor {r.proc}: instr type={r.op}, "
        f"address=0x{r.address:02X}, value={r.value}\n"
        for r in records
    )


def validate_order_against_traces(
    order: Sequence[IssueRecord], traces: Sequence[Sequence[Instr]]
) -> None:
    """Check a recorded order is exactly an interleaving of the traces."""
    cursors = [0] * len(traces)
    for i, rec in enumerate(order):
        if not (0 <= rec.proc < len(traces)):
            raise ValueError(
                f"order line {i}: processor id {rec.proc} out of range "
                f"(have {len(traces)} traces)"
            )
        tr = traces[rec.proc]
        if cursors[rec.proc] >= len(tr):
            raise ValueError(f"order line {i}: proc {rec.proc} trace exhausted")
        instr = tr[cursors[rec.proc]]
        if (instr.op, instr.address) != (rec.op, rec.address) or (
            instr.op == "W" and instr.value != rec.value
        ):
            raise ValueError(
                f"order line {i}: {rec} does not match trace instr {instr}"
            )
        cursors[rec.proc] += 1
    for p, c in enumerate(cursors):
        if c != len(traces[p]):
            raise ValueError(f"order incomplete: proc {p} at {c}/{len(traces[p])}")


def traces_to_arrays(config: SystemConfig, batch_traces):
    """[[Instr]] per system -> ([B, N, T] op/addr/val, [B, N] length)."""
    b = len(batch_traces)
    n = config.num_procs
    t = max(
        (len(tr) for traces in batch_traces for tr in traces), default=1
    )
    op = np.full((b, n, t), -1, np.int32)
    addr = np.zeros((b, n, t), np.int32)
    val = np.zeros((b, n, t), np.int32)
    length = np.zeros((b, n), np.int32)
    for bi, traces in enumerate(batch_traces):
        if len(traces) != n:
            raise ValueError(f"system {bi}: need {n} traces")
        for ni, tr in enumerate(traces):
            length[bi, ni] = len(tr)
            for j, ins in enumerate(tr):
                op[bi, ni, j] = 0 if ins.op == "R" else 1
                addr[bi, ni, j] = ins.address
                val[bi, ni, j] = ins.value
    return op, addr, val, length


def gen_uniform_random(
    config: SystemConfig,
    instrs_per_core: int,
    seed: int = 0,
    write_frac: float = 0.5,
) -> List[List[Instr]]:
    """Uniform-random RD/WR over the whole address space for one system
    (the same traces as ``hpa2_tpu.utils.trace.gen_uniform_random``)."""
    rng = np.random.default_rng(seed)
    traces = []
    for _ in range(config.num_procs):
        ops = rng.random(instrs_per_core) < write_frac
        addrs = rng.integers(0, config.num_addresses, instrs_per_core)
        vals = rng.integers(0, 256, instrs_per_core)
        traces.append(
            [
                Instr("W", int(a), int(v)) if w else Instr("R", int(a))
                for w, a, v in zip(ops, addrs, vals)
            ]
        )
    return traces


def gen_hot_hit_zipf(
    config: SystemConfig,
    instrs_per_core: int,
    seed: int = 0,
    write_frac: float = 0.3,
    spread: float = 8.0,
    tail: float = 0.01,
) -> List[List[Instr]]:
    """Zipf-skewed private hot-set workload, the cycle-elision showcase
    (the same traces as ``hpa2_tpu.utils.trace.gen_hot_hit_zipf``).

    Each node hammers a private hot set of ``cache_size`` slot-distinct
    addresses in its own home slice (every hot line keeps its
    direct-mapped slot for the whole run) with Zipf-like weights of
    max/min ratio ``spread``, plus a ``tail`` fraction of uniform-random
    addresses over the whole space, which keeps a trickle of coherence
    traffic alive."""
    rng = np.random.default_rng(seed)
    h = min(config.cache_size, config.mem_size)
    w = np.arange(1, h + 1, dtype=np.float64) ** -(
        np.log(spread) / np.log(float(h)) if h > 1 else 0.0
    )
    p = w / w.sum()
    traces = []
    for n in range(config.num_procs):
        hot = n * config.mem_size + np.arange(h)
        addrs = np.where(
            rng.random(instrs_per_core) < tail,
            rng.integers(0, config.num_addresses, instrs_per_core),
            hot[rng.choice(h, size=instrs_per_core, p=p)],
        )
        writes = rng.random(instrs_per_core) < write_frac
        vals = rng.integers(0, 256, instrs_per_core)
        traces.append(
            [
                Instr("W", int(a), int(v)) if is_w else Instr("R", int(a))
                for a, is_w, v in zip(addrs, writes, vals)
            ]
        )
    return traces


def gen_eviction_pingpong(
    config: SystemConfig,
    instrs_per_core: int,
    seed: int = 0,
    hot_homes: int = 2,
    write_frac: float = 0.1,
) -> List[List[Instr]]:
    """Adversarial liveness workload biased toward the reference's hang
    class (SURVEY.md §6.3); the same traces as
    ``hpa2_tpu.utils.trace.gen_eviction_pingpong`` (l.332).

    Every generated address collides at cache index 0 (the test_4
    pattern: 0x00/0x20/0x30/0x3C all map to index 0).  A few of them are
    "hot" lines that every node, their own home included, reads again
    and again, so homes become sharers of their own blocks; touching any
    other address evicts the hot line from the direct-mapped slot and
    sends EVICT_SHARED to its home.  The eviction ping-pong and the
    last-sharer upgrade-notify interleavings that follow are the class
    that livelocks the reference at HEAD and that the NACK /
    UPGRADE_NOTIFY protocol must survive."""
    if config.cache_size > config.mem_size:
        raise ValueError(
            "gen_eviction_pingpong needs cache_size <= mem_size "
            "(index-0 collisions must exist in every home's slice)"
        )
    rng = np.random.default_rng(seed)
    n, c, m = config.num_procs, config.cache_size, config.mem_size

    def index0_block(home: int) -> int:
        # smallest b with (home*m + b) % c == 0; b < c <= m
        return (-home * m) % c

    homes = rng.permutation(n)[: max(1, min(hot_homes, n))]
    hot = [config.make_addr(int(h), index0_block(int(h))) for h in homes]
    colliders = [
        config.make_addr(h, b)
        for h in range(n)
        for b in range(index0_block(h), m, c)
        if config.make_addr(h, b) not in hot
    ]
    if not colliders:  # degenerate geometry (m == c, every home hot)
        colliders = hot
    traces = []
    for _ in range(n):
        tr = []
        for _ in range(instrs_per_core):
            r = rng.random()
            if r < write_frac:
                tr.append(
                    Instr("W", int(rng.choice(hot)),
                          int(rng.integers(0, 256)))
                )
            elif r < 0.65:
                tr.append(Instr("R", int(rng.choice(hot))))
            else:
                tr.append(Instr("R", int(rng.choice(colliders))))
        traces.append(tr)
    return traces


def gen_eviction_pingpong_arrays(
    config: SystemConfig,
    batch: int,
    instrs_per_core: int,
    seed: int = 0,
    **kw,
):
    """Batched :func:`gen_eviction_pingpong` as ``[B, N, T]`` arrays
    (system ``b`` drawn from seed ``seed + b``)."""
    return traces_to_arrays(
        config,
        [
            gen_eviction_pingpong(config, instrs_per_core,
                                  seed=seed + b, **kw)
            for b in range(batch)
        ],
    )


def gen_uniform_random_arrays(
    config: SystemConfig,
    batch: int,
    instrs_per_core: int,
    seed: int = 0,
    write_frac: float = 0.5,
):
    """Uniform-random RD/WR over the whole address space as ``[B, N, T]``
    arrays (op 0=RD/1=WR, addr, value) + ``[B, N]`` lengths."""
    rng = np.random.default_rng(seed)
    shape = (batch, config.num_procs, instrs_per_core)
    op = (rng.random(shape) < write_frac).astype(np.int32)
    addr = rng.integers(0, config.num_addresses, shape, dtype=np.int32)
    val = rng.integers(0, 256, shape, dtype=np.int32)
    length = np.full(
        (batch, config.num_procs), instrs_per_core, dtype=np.int32
    )
    return op, addr, val, length


def heterogeneous_lengths(
    batch: int,
    max_instrs: int,
    dist: str = "zipf",
    spread: float = 8.0,
    seed: int = 0,
):
    """Per-system trace lengths for a heterogeneous ensemble workload.

    ``zipf``: lengths are ``floor * k`` for ``k ~ Zipf(2)``, clipped to
    ``[floor, max_instrs]`` with ``floor = max_instrs / spread``: most
    systems run the shortest trace while a heavy tail of stragglers
    runs up to ``spread`` times longer.  ``uniform``: lengths uniform
    over ``[floor, max_instrs]``.  The first system drawn always gets
    ``max_instrs``.  For the same arguments the lengths equal
    ``hpa2_tpu.utils.trace.heterogeneous_lengths``'s.
    """
    if max_instrs < 1 or batch < 1:
        raise ValueError("batch and max_instrs must be >= 1")
    if spread < 1:
        raise ValueError(f"spread must be >= 1, got {spread}")
    floor = max(1, int(round(max_instrs / spread)))
    rng = np.random.default_rng(seed)
    if dist == "zipf":
        k = rng.zipf(2.0, size=batch)
        lens = np.clip(floor * k, floor, max_instrs)
    elif dist == "uniform":
        lens = rng.integers(floor, max_instrs + 1, size=batch)
    else:
        raise ValueError(f"dist must be 'uniform' or 'zipf', got {dist!r}")
    lens = lens.astype(np.int64)
    lens[rng.integers(0, batch)] = max_instrs
    return lens


def gen_heterogeneous_random_arrays(
    config: SystemConfig,
    batch: int,
    max_instrs: int,
    dist: str = "zipf",
    spread: float = 8.0,
    seed: int = 0,
    write_frac: float = 0.5,
):
    """:func:`gen_uniform_random_arrays` with per-system trace lengths
    from :func:`heterogeneous_lengths` (the occupancy scheduler's
    workload, ``bench --trace-len-dist``)."""
    op, addr, val, _ = gen_uniform_random_arrays(
        config, batch, max_instrs, seed=seed, write_frac=write_frac
    )
    lens = heterogeneous_lengths(batch, max_instrs, dist, spread, seed)
    length = np.broadcast_to(
        lens[:, None], (batch, config.num_procs)
    ).astype(np.int32).copy()
    return op, addr, val, length


def gen_producer_consumer(
    config: SystemConfig,
    instrs_per_core: int,
    seed: int = 0,
) -> List[List[Instr]]:
    """Neighbour producer/consumer sharing: node n writes its own
    blocks on even steps and reads node (n+1)'s on odd ones."""
    rng = np.random.default_rng(seed)
    traces = []
    for n in range(config.num_procs):
        out: List[Instr] = []
        peer = (n + 1) % config.num_procs
        for i in range(instrs_per_core):
            blk = int(rng.integers(0, config.mem_size))
            if i % 2 == 0:
                out.append(
                    Instr("W", config.make_addr(n, blk), int(rng.integers(0, 256)))
                )
            else:
                out.append(Instr("R", config.make_addr(peer, blk)))
        traces.append(out)
    return traces


def gen_local_only(
    config: SystemConfig,
    instrs_per_core: int,
    seed: int = 0,
    write_frac: float = 0.5,
) -> List[List[Instr]]:
    """Node-local traffic only: every node touches its own blocks."""
    rng = np.random.default_rng(seed)
    traces = []
    for n in range(config.num_procs):
        ops = rng.random(instrs_per_core) < write_frac
        blks = rng.integers(0, config.mem_size, instrs_per_core)
        vals = rng.integers(0, 256, instrs_per_core)
        traces.append(
            [
                Instr("W", config.make_addr(n, int(b)), int(v))
                if w
                else Instr("R", config.make_addr(n, int(b)))
                for w, b, v in zip(ops, blks, vals)
            ]
        )
    return traces


def gen_producer_consumer_arrays(
    config: SystemConfig,
    batch: int,
    instrs_per_core: int,
    seed: int = 0,
):
    """The producer/consumer pattern as ``[B, N, T]`` arrays in one
    vectorised draw (not the per-system :func:`gen_producer_consumer`
    stream; equal to ``hpa2_tpu.utils.trace``'s namesake)."""
    rng = np.random.default_rng(seed)
    n, t = config.num_procs, instrs_per_core
    shape = (batch, n, t)
    blk = rng.integers(0, config.mem_size, shape, dtype=np.int32)
    val = rng.integers(0, 256, shape, dtype=np.int32)
    node = np.arange(n, dtype=np.int32)[None, :, None]
    write = (np.arange(t, dtype=np.int32)[None, None, :] % 2) == 0
    op = np.broadcast_to(write, shape).astype(np.int32)
    home = np.where(write, node, (node + 1) % n)
    addr = home * config.mem_size + blk
    length = np.full((batch, n), t, dtype=np.int32)
    return op, addr, val, length
