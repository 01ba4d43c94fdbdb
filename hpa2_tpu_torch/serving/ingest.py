"""Job sources for the always-on serving loop: the port's own copy of
``hpa2_tpu/serving/ingest.py`` (l.1-223), the same sources and the same
seeded arrival processes.

A :class:`JobSource` hands the loop whatever jobs have *arrived* by
now; the loop polls it once per admission opportunity (segment
barrier) so ingest never blocks the device.  Three sources:

- :class:`ListJobSource` — an in-memory feed, optionally released on
  each job's ``arrival`` offset (``timed=True``) or all at once.
  Deterministic replay uses ``timed=False``: arrival *order* is
  whatever order the list is in, independent of wall clock.
- :class:`FileJobSource` — a JSONL jobs file, released on arrival
  offsets (or immediately with ``timed=False``).
- :class:`SocketJobSource` — a TCP listener; each client connection
  streams JSONL job records.  A reader thread parses into a queue so
  the serving loop's poll stays non-blocking.

Arrival processes for benchmarks live here too: Poisson
(:func:`poisson_arrivals`) and heavy-tail burst
(:func:`zipf_burst_arrivals`) offsets, both seeded.
"""

from __future__ import annotations

import json
import queue
import socket
import threading
import time
from typing import Iterable, List, Optional, Sequence

import numpy as np

from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.serving.jobs import Job, job_from_record


class JobSource:
    """Poll-based job feed: ``poll()`` returns the jobs that arrived
    since the last call; ``exhausted`` turns true once the feed is
    done AND everything has been handed out."""

    def poll(self) -> List[Job]:
        raise NotImplementedError

    @property
    def exhausted(self) -> bool:
        raise NotImplementedError

    def wait(self, timeout_s: float) -> None:
        """Idle until the next job might arrive (the loop calls this
        when all lanes are free and poll() came back empty)."""
        time.sleep(min(timeout_s, 0.005))

    def close(self) -> None:
        pass


class ListJobSource(JobSource):
    def __init__(self, jobs: Sequence[Job], *, timed: bool = False):
        self._jobs = sorted(jobs, key=lambda j: j.arrival) if timed \
            else list(jobs)
        self._timed = timed
        self._next = 0
        self._t0 = time.perf_counter()

    def poll(self) -> List[Job]:
        if not self._timed:
            out, self._next = self._jobs[self._next:], len(self._jobs)
            return out
        now = time.perf_counter() - self._t0
        out = []
        while (self._next < len(self._jobs)
               and self._jobs[self._next].arrival <= now):
            out.append(self._jobs[self._next])
            self._next += 1
        return out

    @property
    def exhausted(self) -> bool:
        return self._next >= len(self._jobs)

    def wait(self, timeout_s: float) -> None:
        if not self._timed or self.exhausted:
            return
        now = time.perf_counter() - self._t0
        dt = self._jobs[self._next].arrival - now
        if dt > 0:
            time.sleep(min(dt, timeout_s))


class FileJobSource(ListJobSource):
    def __init__(self, config: SystemConfig, path: str, *,
                 timed: bool = True):
        from hpa2_tpu_torch.serving.jobs import load_jobs_file

        super().__init__(load_jobs_file(config, path), timed=timed)


class SocketJobSource(JobSource):
    """TCP JSONL feed: one job record per line, any number of client
    connections.  ``poll()`` drains the parse queue; the feed is done
    when a client sends ``{"eof": true}`` (or after ``close()``)."""

    def __init__(self, config: SystemConfig, host: str = "127.0.0.1",
                 port: int = 0, *, backlog: int = 4):
        self._config = config
        self._queue: "queue.Queue[Job]" = queue.Queue()
        self._eof = threading.Event()
        self._closed = threading.Event()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(backlog)
        self._srv.settimeout(0.1)
        self.address = self._srv.getsockname()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()

    def _serve(self) -> None:
        while not self._closed.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            t = threading.Thread(
                target=self._read_conn, args=(conn,), daemon=True)
            t.start()

    def _read_conn(self, conn: socket.socket) -> None:
        # An abrupt client disconnect (RST mid-line, half-open reset)
        # surfaces as ConnectionResetError / OSError from the iterator
        # or the close; swallow it so the reader thread dies quietly —
        # every complete record already parsed stays in the queue, and
        # a partial final line simply fails json.loads and is dropped.
        try:
            with conn, conn.makefile("r", encoding="utf-8") as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    if rec.get("eof"):
                        self._eof.set()
                        break
                    try:
                        self._queue.put(
                            job_from_record(self._config, rec)
                        )
                    except ValueError:
                        continue
        except (OSError, ValueError):
            pass

    def poll(self) -> List[Job]:
        out = []
        while True:
            try:
                out.append(self._queue.get_nowait())
            except queue.Empty:
                return out

    @property
    def exhausted(self) -> bool:
        return ((self._eof.is_set() or self._closed.is_set())
                and self._queue.empty())

    def wait(self, timeout_s: float) -> None:
        try:
            job = self._queue.get(timeout=min(timeout_s, 0.05))
            self._queue.put(job)
        except queue.Empty:
            pass

    def close(self) -> None:
        self._closed.set()
        try:
            self._srv.close()
        except OSError:
            pass


def poisson_arrivals(
    count: int, rate: float, seed: int = 0
) -> np.ndarray:
    """Cumulative arrival offsets (seconds) of a Poisson process with
    ``rate`` jobs/sec — exponential inter-arrival gaps."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate, size=count))


def zipf_burst_arrivals(
    count: int, rate: float, seed: int = 0, *, alpha: float = 2.0
) -> np.ndarray:
    """Heavy-tail bursty arrivals at the same mean ``rate``: jobs come
    in Zipf(alpha)-sized bursts (whole burst arrives at one instant),
    with exponential gaps between bursts scaled so the long-run mean
    rate matches the Poisson feed.  The serving tail (p99) under this
    feed is the overload robustness number."""
    if rate <= 0:
        raise ValueError(f"rate must be > 0, got {rate}")
    rng = np.random.default_rng(seed)
    sizes: List[int] = []
    total = 0
    while total < count:
        k = int(np.clip(rng.zipf(alpha), 1, max(1, count - total)))
        sizes.append(k)
        total += k
    # mean burst size compensates the gap so jobs/sec stays = rate
    gaps = rng.exponential(1.0 / rate, size=len(sizes))
    out = np.empty(count, np.float64)
    t, ix = 0.0, 0
    for k, g in zip(sizes, gaps):
        t += g * k
        out[ix:ix + k] = t
        ix += k
    return out
