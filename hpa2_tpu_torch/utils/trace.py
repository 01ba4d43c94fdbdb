"""Trace loading and the synthetic uniform and heterogeneous workloads.

``core_<n>.txt`` holds one instruction per line, ``RD <hexaddr>`` or
``WR <hexaddr> <decvalue>``; values wrap mod 256, blank lines are
skipped, malformed lines and out-of-range addresses raise.  For the
same seed the generators give the same arrays as their namesakes in
``hpa2_tpu.utils.trace``.
"""

from __future__ import annotations

import os
import re
from typing import List, Optional

import numpy as np

from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.models.protocol import Instr

_RD_RE = re.compile(r"^RD\s+(?:0[xX])?([0-9a-fA-F]+)\s*$")
_WR_RE = re.compile(r"^WR\s+(?:0[xX])?([0-9a-fA-F]+)\s+(\d+)\s*$")


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


def load_trace_dir(trace_dir: str, config: SystemConfig) -> List[List[Instr]]:
    """``core_<n>.txt`` for every node; a missing file is an error."""
    cap = config.max_instr_num if config.max_instr_num > 0 else None
    traces = []
    for n in range(config.num_procs):
        path = os.path.join(trace_dir, f"core_{n}.txt")
        with open(path, "r") as f:
            trace = parse_core_trace(f.read(), cap)
        for i, instr in enumerate(trace):
            if not (0 <= instr.address < config.num_addresses):
                raise ValueError(
                    f"{path} instr {i}: address 0x{instr.address:X} out of "
                    f"range for {config.num_procs} nodes x "
                    f"{config.mem_size} blocks"
                )
        traces.append(trace)
    return traces


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
