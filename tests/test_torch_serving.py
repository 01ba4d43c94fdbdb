"""The port's always-on serving (``hpa2_tpu_torch.serving``, ``device=
"cpu"``: the kernels' plain versions) against the JAX package's
(``hpa2_tpu.serving``, ``backend="pallas"``, the Pallas kernel in
interpret mode), on the feed of ``tests/test_serving.py``: a 4-node
robust configuration, 8 zipf-length jobs, 4 resident lanes, windows of
8, lane blocks of 4.

Every served job's dumps and counters must equal the JAX package's,
job for job, and the port's one-shot scheduled run; the untimed feeds'
``occupancy`` dicts must be equal; every compile count must be 1.  The
job records, the sources and the seeded arrival processes must give
the same jobs and the same numbers in both packages."""

import dataclasses
import json
import socket
import struct
import threading
import time

import numpy as np
import pytest

from hpa2_tpu.serving import ListJobSource as JListJobSource
from hpa2_tpu.serving import TracePool as JTracePool
from hpa2_tpu.serving import job_from_record as jjob_from_record
from hpa2_tpu.serving import job_to_record as jjob_to_record
from hpa2_tpu.serving import parse_jobs_lines as jparse_jobs_lines
from hpa2_tpu.serving import poisson_arrivals as jpoisson_arrivals
from hpa2_tpu.serving import serve as jserve
from hpa2_tpu.serving import synthetic_jobs as jsynthetic_jobs
from hpa2_tpu.serving import zipf_burst_arrivals as jzipf_burst_arrivals
from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
from hpa2_tpu_torch.ops.schedule import Schedule
from hpa2_tpu_torch.serving import (
    ListJobSource, SocketJobSource, TracePool, job_from_record,
    job_to_record, parse_jobs_lines, poisson_arrivals, serve,
    synthetic_jobs, zipf_burst_arrivals,
)
from hpa2_tpu_torch.serving.loop import _guard_compiles
from torch_pairs import IGNORE_PLTPU_ANY, config_pair, dicts
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings(IGNORE_PLTPU_ANY)

N_JOBS = 8
SERVE_KW = dict(resident=4, window=8, block=4)


@pytest.fixture(scope="module")
def cfgs():
    return config_pair(True, num_procs=4)


@pytest.fixture(scope="module")
def jobs(cfgs):
    jcfg, tcfg = cfgs
    return (jsynthetic_jobs(jcfg, N_JOBS, 24, seed=7, spread=3.0),
            synthetic_jobs(tcfg, N_JOBS, 24, seed=7, spread=3.0))


def _batch_arrays(jobs):
    return tuple(np.stack([getattr(j, f) for j in jobs])
                 for f in ("tr_op", "tr_addr", "tr_val", "tr_len"))


@pytest.fixture(scope="module")
def one_shot(cfgs, jobs):
    """The port's one-shot scheduled run of the feed, by job id."""
    eng = CudaEngine(cfgs[1], *_batch_arrays(jobs[1]), block=4,
                     trace_window=8, snapshots=False,
                     schedule=Schedule(resident=4, fused=False),
                     device="cpu").run()
    return {j.job_id: eng.system_final_dumps(s)
            for s, j in enumerate(jobs[1])}


@pytest.fixture(scope="module")
def jax_served(cfgs, jobs):
    """JAX ``serve`` of the feed in arrival order (interpret mode)."""
    results, stats = jserve(cfgs[0], JListJobSource(jobs[0]),
                            backend="pallas", **SERVE_KW)
    return {r.job_id: r for r in results}, stats


def _assert_same_results(results, want, one_shot=None):
    """Each port result's dumps and counters equal the JAX result's of
    the same job (and the port's one-shot run's dumps)."""
    assert sorted(r.job_id for r in results) == sorted(want)
    for r in results:
        assert dicts(r.dumps) == dicts(want[r.job_id].dumps), r.job_id
        assert r.counters == want[r.job_id].counters, r.job_id
        if one_shot is not None:
            assert r.dumps == one_shot[r.job_id], r.job_id


def _assert_compiled_once(stats):
    assert stats.compile_counts == {"runner": 1, "barrier": 1,
                                    "take_lane": 1}


@pytest.mark.parametrize("overlap", [True, False])
def test_served_matches_jax_and_one_shot(cfgs, jobs, one_shot, overlap):
    """Pipelined (``overlap=True``) and serial: every job's dumps and
    counters equal JAX ``serve``'s and the one-shot run's; the
    occupancy dict equals the JAX one, key for key."""
    jcfg, tcfg = cfgs
    jres, jstats = jserve(jcfg, JListJobSource(jobs[0]), backend="pallas",
                          overlap=overlap, **SERVE_KW)
    results, stats = serve(tcfg, ListJobSource(jobs[1]), backend="pallas",
                           overlap=overlap, device="cpu", **SERVE_KW)
    _assert_same_results(results, {r.job_id: r for r in jres}, one_shot)
    assert [r.job_id for r in results] == [r.job_id for r in jres]
    assert stats.occupancy == jstats.occupancy
    assert stats.occupancy["admissions"] == N_JOBS
    _assert_compiled_once(stats)
    d, jd = stats.as_dict(), jstats.as_dict()
    assert set(d) == set(jd) and set(d["phases"]) == set(jd["phases"])
    assert d["overlap"] is overlap and d["jobs_completed"] == N_JOBS
    assert d["instructions"] == jd["instructions"] > 0
    assert d["latency_s"]["p99"] >= d["latency_s"]["p50"] > 0
    assert [r.wait_intervals for r in results] == [
        r.wait_intervals for r in jres]


def test_shuffled_arrival_record_replay(cfgs, jobs, one_shot):
    """Jobs in shuffled order, written as JSONL records and parsed back:
    the records are equal between the packages, and the port serves
    them (fcfs and longest-first) to the JAX package's dumps."""
    jcfg, tcfg = cfgs
    perm = np.random.default_rng(11).permutation(N_JOBS)
    lines = [json.dumps(job_to_record(jobs[1][i])) for i in perm]
    assert lines == [json.dumps(jjob_to_record(jobs[0][i])) for i in perm]
    replayed = parse_jobs_lines(tcfg, lines)
    jreplayed = jparse_jobs_lines(jcfg, lines)
    assert [j.job_id for j in replayed] == [jobs[1][i].job_id for i in perm]
    for policy in ("fcfs", "longest-first"):
        jres, jstats = jserve(jcfg, JListJobSource(jreplayed),
                              backend="pallas", policy=policy, **SERVE_KW)
        results, stats = serve(tcfg, ListJobSource(replayed),
                               policy=policy, device="cpu", **SERVE_KW)
        _assert_same_results(results, {r.job_id: r for r in jres},
                             one_shot)
        assert stats.occupancy == jstats.occupancy
        _assert_compiled_once(stats)


def test_admission_policies(cfgs, jobs, one_shot):
    """deadline-edf, and fair-drr with tenant weights, reorder admission
    alike in both packages: equal dumps, counters and occupancy (its
    deadline and tenant-share columns included)."""
    jcfg, tcfg = cfgs

    def tagged(feed):
        return [dataclasses.replace(j, tenant=("a", "b")[i % 2],
                                    deadline=(8, 32, -1)[i % 3])
                for i, j in enumerate(feed)]

    for policy, weights in (("deadline-edf", None),
                            ("fair-drr", {"a": 2.0, "b": 1.0})):
        jres, jstats = jserve(jcfg, JListJobSource(tagged(jobs[0])),
                              backend="pallas", policy=policy,
                              tenant_weights=weights, **SERVE_KW)
        results, stats = serve(tcfg, ListJobSource(tagged(jobs[1])),
                               policy=policy, tenant_weights=weights,
                               device="cpu", **SERVE_KW)
        _assert_same_results(results, {r.job_id: r for r in jres},
                             one_shot)
        assert stats.occupancy == jstats.occupancy
        occ = stats.occupancy
        assert occ["deadline_met"] + occ["deadline_missed"] == sum(
            1 for i in range(N_JOBS) if (8, 32, -1)[i % 3] >= 0)
        if weights:
            assert len(occ["tenant_share"]) == 2
        assert [r.tenant for r in results] == [r.tenant for r in jres]
        _assert_compiled_once(stats)


def test_unported_backends_raise(cfgs, jobs):
    tcfg = cfgs[1]
    for backend in ("jax", "pallas-sharded", "pallas-node-sharded"):
        with pytest.raises(ValueError, match="not ported yet"):
            serve(tcfg, ListJobSource(jobs[1]), backend=backend,
                  device="cpu", **SERVE_KW)
    with pytest.raises(ValueError, match="unknown serving backend"):
        serve(tcfg, ListJobSource(jobs[1]), backend="tpu", device="cpu")
    with pytest.raises(ValueError, match="device='cpu'"):
        serve(tcfg, ListJobSource(jobs[1]), interpret=True, device="cpu")


def test_compile_guard_trips_on_recompile(cfgs, jobs):
    _guard_compiles({"runner": 1, "barrier": 1}, True)
    with pytest.raises(RuntimeError, match="recompil"):
        _guard_compiles({"runner": 2, "barrier": 1}, True)
    _guard_compiles({"runner": 2}, False)


def test_trace_pool_compaction_matches_jax(cfgs):
    """The port's pool against the JAX pool on the same jobs: windows
    equal before and after the frees that trip compaction."""
    jcfg, tcfg = cfgs
    window = 8
    feeds = (jsynthetic_jobs(jcfg, 12, 24, seed=3, spread=3.0),
             synthetic_jobs(tcfg, 12, 24, seed=3, spread=3.0))
    pools = (JTracePool(jcfg, window, capacity=window),
             TracePool(tcfg, window, capacity=window))
    for pool, feed in zip(pools, feeds):
        assert [pool.add(j) for j in feed] == list(range(12))
    survivors = np.arange(0, 12, 3)

    def windows(pool):
        return pool.windows(np.arange(len(survivors)), survivors,
                            np.zeros(len(survivors), np.int64),
                            len(survivors))

    before = [windows(p) for p in pools]
    used = pools[1]._used
    for pool in pools:
        for s in range(12):
            if s not in survivors:
                pool.free(s)
    assert pools[1]._waste == 0 and pools[1]._used < used
    assert pools[1]._used == pools[0]._used
    after = [windows(p) for p in pools]
    for (jtr, jtl), (tr, tl) in (before, after):  # (JAX, port) pairs
        np.testing.assert_array_equal(tr, jtr)
        np.testing.assert_array_equal(tl, jtl)
    np.testing.assert_array_equal(before[1][0], after[1][0])


def _error_of(fn, *args):
    with pytest.raises(ValueError) as e:
        fn(*args)
    return str(e.value)


def test_job_records_and_errors_match_jax(cfgs):
    jcfg, tcfg = cfgs
    job = synthetic_jobs(tcfg, 1, 16, seed=5)[0]
    rec = job_to_record(job)
    assert rec == jjob_to_record(jsynthetic_jobs(jcfg, 1, 16, seed=5)[0])
    back, jback = job_from_record(tcfg, rec), jjob_from_record(jcfg, rec)
    for f in ("tr_op", "tr_addr", "tr_val", "tr_len"):
        np.testing.assert_array_equal(getattr(back, f), getattr(jback, f))
    assert job_to_record(back) == rec
    wl = {"id": "w0", "workload": {"kind": "uniform", "instrs": 16,
                                   "seed": 9, "length": 11},
          "tenant": "t", "priority": 2, "deadline": 5, "arrival": 0.5}
    a, ja = job_from_record(tcfg, wl), jjob_from_record(jcfg, wl)
    for f in ("tr_op", "tr_addr", "tr_val", "tr_len"):
        np.testing.assert_array_equal(getattr(a, f), getattr(ja, f))
    assert (a.tenant, a.priority, a.deadline, a.arrival) == (
        ja.tenant, ja.priority, ja.deadline, ja.arrival) == ("t", 2, 5, 0.5)
    bad = [{"traces": [[]] * 4},
           {"id": "x", "traces": [], "workload": {}},
           {"id": "x", "traces": [[["R", 0]]]},
           {"id": "x", "traces": [[["Q", 0]], [], [], []]},
           {"id": "x", "traces": [[["R"]], [], [], []]},
           {"id": "x", "workload": {"kind": "zipf"}}]
    for r in bad:
        assert _error_of(job_from_record, tcfg, r) == _error_of(
            jjob_from_record, jcfg, r)
    assert "bad JSON" in _error_of(parse_jobs_lines, tcfg, ["{nope"])
    assert _error_of(parse_jobs_lines, tcfg, ["", "# c", "{nope"]) == \
        _error_of(jparse_jobs_lines, jcfg, ["", "# c", "{nope"])


def test_socket_source_feeds_serving(cfgs, jobs, jax_served, one_shot):
    src = SocketJobSource(cfgs[1])
    lines = [json.dumps(job_to_record(j)) for j in jobs[1]]
    lines.append(json.dumps({"eof": True}))

    def feed():
        with socket.create_connection(src.address) as conn:
            conn.sendall(("\n".join(lines) + "\n").encode())

    t = threading.Thread(target=feed, daemon=True)
    t.start()
    try:
        results, stats = serve(cfgs[1], src, device="cpu", **SERVE_KW)
    finally:
        src.close()
    t.join(timeout=5)
    assert not t.is_alive()
    _assert_same_results(results, jax_served[0], one_shot)
    _assert_compiled_once(stats)


def test_socket_source_survives_abrupt_disconnect(cfgs, jobs, jax_served,
                                                  one_shot):
    """A client that resets mid-line leaves its complete records queued
    and its partial one dropped; a later connection ends the feed."""
    feed = jobs[1]
    src = SocketJobSource(cfgs[1])
    try:
        first = socket.create_connection(src.address)
        payload = "".join(json.dumps(job_to_record(j)) + "\n"
                          for j in feed[:3])
        payload += json.dumps(job_to_record(feed[3]))[:20]
        first.sendall(payload.encode())
        first.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                         struct.pack("ii", 1, 0))
        first.close()
        deadline = time.monotonic() + 10.0
        while src._queue.qsize() < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert src._queue.qsize() == 3
        lines = [json.dumps(job_to_record(j)) for j in feed[3:]]
        lines.append(json.dumps({"eof": True}))
        with socket.create_connection(src.address) as second:
            second.sendall(("\n".join(lines) + "\n").encode())
        results, stats = serve(cfgs[1], src, device="cpu", **SERVE_KW)
    finally:
        src.close()
    _assert_same_results(results, jax_served[0], one_shot)
    _assert_compiled_once(stats)


def test_timed_list_source_releases_on_arrival(cfgs):
    jcfg, tcfg = cfgs
    arrivals = np.array([0.0, 0.0, 60.0, 60.0])
    srcs = (ListJobSource(synthetic_jobs(tcfg, 4, 8, seed=1,
                                         arrivals=arrivals), timed=True),
            JListJobSource(jsynthetic_jobs(jcfg, 4, 8, seed=1,
                                           arrivals=arrivals), timed=True))
    for src in srcs:
        assert [j.job_id for j in src.poll()] == ["job-00000",
                                                   "job-00001"]
        assert not src.exhausted
        assert src.poll() == []


def test_arrival_processes_match_jax():
    for gen, jgen in ((poisson_arrivals, jpoisson_arrivals),
                      (zipf_burst_arrivals, jzipf_burst_arrivals)):
        a = gen(2000, 50.0, seed=4)
        np.testing.assert_array_equal(a, jgen(2000, 50.0, seed=4))
        np.testing.assert_array_equal(a, gen(2000, 50.0, seed=4))
        assert np.all(np.diff(a) >= 0)
        assert 0.7 * 50.0 <= 2000 / a[-1] <= 1.3 * 50.0
    for gen in (poisson_arrivals, zipf_burst_arrivals):
        with pytest.raises(ValueError):
            gen(10, 0.0)
