"""Serving jobs: the unit of work the always-on loop admits.  The
port's own copy of ``hpa2_tpu/serving/jobs.py`` (l.1-250), with the same
names, records and seeded generators, so a jobs file parses to the same
arrays in either package.

A *job* is one simulated DSM system — per-node instruction traces plus
an id and an optional arrival offset.  Jobs travel as JSONL records
(one job per line), either read from a jobs file or streamed over a
socket:

    {"id": "j0", "traces": [[["R", 3], ["W", 5, 7]], [], ...]}
    {"id": "j1", "arrival": 0.25,
     "workload": {"kind": "uniform", "instrs": 32, "seed": 7}}

``traces`` lists one trace per node, each instruction ``["R", addr]``
or ``["W", addr, value]`` (integer ops 0/1 are accepted).
``workload`` generates the traces server-side from the same seeded
generators the benchmarks use — the compact form for load testing.
``arrival`` is the feed-relative release time in seconds (omitted =
release immediately).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.utils.dump import NodeDump


@dataclasses.dataclass
class Job:
    """One simulation job: ``[n, t]`` per-node trace arrays.

    The multi-tenant service fields default to "anonymous, best
    effort": ``tenant`` names the submitting tenant ("" = the default
    tenant), ``priority`` breaks ties in the admission scheduler
    (higher first, reserved), and ``deadline`` is the completion
    deadline in scheduling intervals relative to admission enqueue
    (-1 = none)."""

    job_id: str
    tr_op: np.ndarray    # [n, t] int, 0=RD 1=WR
    tr_addr: np.ndarray  # [n, t] int
    tr_val: np.ndarray   # [n, t] int
    tr_len: np.ndarray   # [n] int
    arrival: float = 0.0
    tenant: str = ""
    priority: int = 0
    deadline: int = -1

    @property
    def max_len(self) -> int:
        return int(self.tr_len.max(initial=0))

    @property
    def instructions(self) -> int:
        return int(self.tr_len.sum())

    def batch_traces(self):
        """The per-node ``Instr`` lists the batch backends consume."""
        from hpa2_tpu_torch.models.protocol import Instr

        return [
            [
                Instr(
                    "RW"[int(self.tr_op[i, j])],
                    int(self.tr_addr[i, j]),
                    int(self.tr_val[i, j]),
                )
                for j in range(int(self.tr_len[i]))
            ]
            for i in range(len(self.tr_len))
        ]


@dataclasses.dataclass
class JobResult:
    """What the serving loop streams back as a job's lanes retire."""

    job_id: str
    dumps: List[NodeDump]
    counters: Dict[str, int]
    submitted_s: float
    retired_s: float
    wait_intervals: int
    tenant: str = ""

    @property
    def latency_s(self) -> float:
        return self.retired_s - self.submitted_s

    def to_record(self) -> dict:
        rec = {
            "id": self.job_id,
            "latency_s": round(self.latency_s, 6),
            "wait_intervals": self.wait_intervals,
            **self.counters,
        }
        if self.tenant:
            rec["tenant"] = self.tenant
        return rec


def _trace_arrays(config: SystemConfig, traces: Sequence[Sequence]):
    n = config.num_procs
    if len(traces) != n:
        raise ValueError(
            f"job needs one trace per node ({n}), got {len(traces)}"
        )
    t = max((len(tr) for tr in traces), default=0)
    t = max(t, 1)
    op = np.zeros((n, t), np.int32)
    addr = np.zeros((n, t), np.int32)
    val = np.zeros((n, t), np.int32)
    ln = np.zeros(n, np.int32)
    ops = {"R": 0, "W": 1, 0: 0, 1: 1}
    for i, tr in enumerate(traces):
        ln[i] = len(tr)
        for j, ins in enumerate(tr):
            if len(ins) not in (2, 3):
                raise ValueError(f"bad instruction {ins!r}")
            o = ops.get(ins[0])
            if o is None:
                raise ValueError(f"bad instruction op {ins[0]!r}")
            op[i, j] = o
            addr[i, j] = int(ins[1])
            val[i, j] = int(ins[2]) if len(ins) == 3 else 0
    return op, addr, val, ln


def _workload_job(
    config: SystemConfig, job_id: str, spec: dict, arrival: float
) -> Job:
    from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays

    kind = spec.get("kind", "uniform")
    if kind != "uniform":
        raise ValueError(f"unknown workload kind {kind!r}")
    instrs = int(spec.get("instrs", 32))
    seed = int(spec.get("seed", 0))
    write_frac = float(spec.get("write_frac", 0.33))
    op, addr, val, ln = gen_uniform_random_arrays(
        config, 1, instrs, seed=seed, write_frac=write_frac
    )
    length = spec.get("length")
    if length is not None:
        ln = np.minimum(ln, int(length))
    return Job(job_id, op[0], addr[0], val[0], ln[0].astype(np.int32),
               arrival=arrival)


def job_from_record(config: SystemConfig, record: dict) -> Job:
    """One JSONL record -> :class:`Job` (see the module docstring for
    the format)."""
    if "id" not in record:
        raise ValueError("job record needs an 'id'")
    job_id = str(record["id"])
    arrival = float(record.get("arrival", 0.0))
    if ("traces" in record) == ("workload" in record):
        raise ValueError(
            f"job {job_id!r} needs exactly one of 'traces'/'workload'"
        )
    if "workload" in record:
        job = _workload_job(config, job_id, record["workload"], arrival)
    else:
        op, addr, val, ln = _trace_arrays(config, record["traces"])
        job = Job(job_id, op, addr, val, ln, arrival=arrival)
    job.tenant = str(record.get("tenant", ""))
    job.priority = int(record.get("priority", 0))
    job.deadline = int(record.get("deadline", -1))
    return job


def job_to_record(job: Job) -> dict:
    """Inverse of :func:`job_from_record` (explicit-traces form) — the
    record/replay serializer."""
    traces = []
    for i in range(len(job.tr_len)):
        tr = []
        for j in range(int(job.tr_len[i])):
            if int(job.tr_op[i, j]):
                tr.append(["W", int(job.tr_addr[i, j]),
                           int(job.tr_val[i, j])])
            else:
                tr.append(["R", int(job.tr_addr[i, j])])
        traces.append(tr)
    rec = {"id": job.job_id, "traces": traces}
    if job.arrival:
        rec["arrival"] = job.arrival
    if job.tenant:
        rec["tenant"] = job.tenant
    if job.priority:
        rec["priority"] = job.priority
    if job.deadline >= 0:
        rec["deadline"] = job.deadline
    return rec


def parse_jobs_lines(
    config: SystemConfig, lines: Sequence[str]
) -> List[Job]:
    jobs = []
    for ix, line in enumerate(lines):
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        try:
            rec = json.loads(line)
        except json.JSONDecodeError as e:
            raise ValueError(f"jobs line {ix + 1}: bad JSON: {e}") from e
        jobs.append(job_from_record(config, rec))
    return jobs


def load_jobs_file(config: SystemConfig, path: str) -> List[Job]:
    with open(path) as fh:
        return parse_jobs_lines(config, fh.readlines())


def synthetic_jobs(
    config: SystemConfig,
    count: int,
    max_instrs: int,
    *,
    seed: int = 0,
    write_frac: float = 0.33,
    dist: str = "zipf",
    spread: float = 4.0,
    arrivals: Optional[np.ndarray] = None,
) -> List[Job]:
    """A seeded feed of heterogeneous-length jobs (the benchmark and
    smoke-test workload): uniform random traces, per-job lengths drawn
    from ``dist`` exactly like ``gen_heterogeneous_random_arrays``."""
    from hpa2_tpu_torch.utils.trace import (
        gen_uniform_random_arrays, heterogeneous_lengths)

    op, addr, val, ln = gen_uniform_random_arrays(
        config, count, max_instrs, seed=seed, write_frac=write_frac
    )
    lens = heterogeneous_lengths(count, max_instrs, dist, spread, seed)
    ln = np.minimum(ln, np.asarray(lens)[:, None]).astype(np.int32)
    jobs = []
    for s in range(count):
        t = float(arrivals[s]) if arrivals is not None else 0.0
        jobs.append(
            Job(f"job-{s:05d}", op[s], addr[s], val[s], ln[s], arrival=t)
        )
    return jobs
