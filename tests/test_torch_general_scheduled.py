"""The general engine's scheduled runs and its serving backend on the
port (``device="cpu"``) against the JAX package, on the same seeded
inputs, tolerance zero (all state is integer):

* the chunk runner (``ops/step.py:ChunkRun``) against
  ``build_batched_run_chunk``, chunk after chunk, in every ``SimState``
  field, and its card form (gated steps, one read a chunk, long jumps
  under faults finished on the host) run eagerly against its host loop;
* ``BatchTorchEngine(schedule=...)``, fused and with the host chunk
  loop, against ``BatchJaxEngine(schedule=...)`` with faults
  (``tests/test_occupancy.py:247-281``) and with elision
  (``tests/test_elision.py:176-195``): every field, dump, snapshot,
  ``stats()`` and ``occupancy.as_dict()``;
* ``serve(backend="jax")`` against JAX ``serve(backend="jax")``
  (``tests/test_serving.py:166-207, 289-310``): plain with overlap on
  and off, with faults, with MOESI and with the fast path's window
  schedule, job by job, with zero recompiles.
"""

import dataclasses

import numpy as np
import pytest
import torch

import hpa2_tpu.config as jconfig
from hpa2_tpu.ops.engine import BatchJaxEngine
from hpa2_tpu.ops.engine import build_batched_run_chunk as jchunk
from hpa2_tpu.ops.schedule import Schedule as JSchedule
from hpa2_tpu.ops.state import init_state_batched as jinit_batched
from hpa2_tpu.serving import ListJobSource as JListJobSource
from hpa2_tpu.serving import serve as jserve
from hpa2_tpu.serving import synthetic_jobs as jsynthetic_jobs
from hpa2_tpu.utils.trace import (
    gen_hot_hit_zipf, gen_uniform_random, gen_uniform_random_arrays,
    heterogeneous_lengths,
)
from hpa2_tpu_torch.convert import sim_state_from_numpy
from hpa2_tpu_torch.ops import kernels
from hpa2_tpu_torch.ops.engine import BatchLaneSession, BatchTorchEngine
from hpa2_tpu_torch.ops.layout import StallError
from hpa2_tpu_torch.ops.schedule import Schedule
from hpa2_tpu_torch.ops.state import SimState, init_state, stack_states
from hpa2_tpu_torch.ops.step import ChunkRun, build_batched_run_chunk
from hpa2_tpu_torch.serving import ListJobSource, serve, synthetic_jobs
from torch_general import (
    ACCEPT, ROBUST, dicts, port_config, port_traces, state_diff,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CFG = jconfig.SystemConfig(num_procs=4, semantics=ROBUST)
FAULTY = dataclasses.replace(CFG, fault=jconfig.FaultModel(**ACCEPT))


def _zipf_batch(cfg):
    """12 zipf-length systems of up to 24 instructions
    (``test_occupancy.py:253-257``)."""
    lens = heterogeneous_lengths(12, 24, dist="zipf", spread=4.0, seed=3)
    return [gen_uniform_random(cfg, int(n), seed=100 + s)
            for s, n in enumerate(lens)]


def _assert_engines_equal(je, te, b):
    assert state_diff(je.state, te.state, batched=True) == []
    for s in range(b):
        assert dicts(te.system_final_dumps(s)) == dicts(
            je.system_final_dumps(s))
        assert dicts(te.system_snapshots(s)) == dicts(
            je.system_snapshots(s))
    assert te.stats() == je.stats()
    assert te.occupancy.as_dict() == je.occupancy.as_dict()


# -- the chunk runner -------------------------------------------------------


@pytest.mark.parametrize("cfg", [CFG, FAULTY], ids=["plain", "faults"])
def test_chunks_equal_jax_chunks(cfg):
    """Chunk after chunk of 10 simulated cycles, every field (``cycle``
    included) equals ``build_batched_run_chunk``'s, to quiescence."""
    arrays = gen_uniform_random_arrays(cfg, 3, 16, seed=0)
    jst = jinit_batched(cfg, *arrays)
    tst = sim_state_from_numpy(jst._asdict(), device="cpu")
    jrun, trun = jchunk(cfg, 10), build_batched_run_chunk(
        port_config(cfg), 10)
    assert trun is build_batched_run_chunk(port_config(cfg), 10)
    for _ in range(200):
        jst, tst = jrun(jst), trun(tst)
        assert state_diff(jst, tst, batched=True) == []
        if bool(np.asarray(jst.pc >= jst.tr_len).all()) and int(
                np.asarray(jst.mb_count).sum()) == 0 and not bool(
                np.asarray(jst.waiting).any()):
            break
    else:
        raise AssertionError("no quiescence in 200 chunks")


def test_gated_chunks_equal_host_chunks():
    """The card's form of a chunk, run eagerly (rounds of 16 gated
    steps, one read, jumps past the in-graph key replay finished on the
    host), equals the host loop in every field after every chunk, on a
    workload whose elided jumps outgrow the key replay under faults."""
    cfg = port_config(FAULTY)
    st = init_state(cfg, port_traces(gen_hot_hit_zipf(FAULTY, 128, seed=0,
                                                      spread=1.0)),
                    device="cpu")
    host = SimState(*(x.clone() for x in st))
    gated = SimState(*(x.clone() for x in st))
    runner = ChunkRun(cfg, 40)
    hb, gb = runner.bind(host, gated=False), runner.bind(gated, gated=True)
    syncs, chunks = kernels.HOST_SYNCS.count, 0
    while True:
        hb.advance()
        gb.advance()
        hq, hov = hb.status()
        gq, gov = gb.status()
        chunks += 1
        assert all(torch.equal(a, b) for a, b in zip(host, gated))
        assert (hq == gq).all() and hov == gov
        if hq.all():
            break
    assert int(host.n_elided.sum()) > 0
    # some chunk stopped for a jump longer than the key replay
    assert kernels.HOST_SYNCS.count - syncs > chunks


# -- BatchTorchEngine(schedule=...) -----------------------------------------


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host"])
def test_scheduled_with_faults_matches_jax(fused):
    """Streaming 12 systems through 4 rows with an active fault model:
    every field, dump, counter and occupancy counter equals
    ``BatchJaxEngine``'s (whose dumps equal its unscheduled run's,
    ``test_occupancy.py``)."""
    batch = _zipf_batch(FAULTY)
    sched = dict(resident=4, interval=64, fused=fused)
    je = BatchJaxEngine(FAULTY, batch, schedule=JSchedule(**sched)).run()
    tb = [port_traces(t) for t in batch]
    te = BatchTorchEngine(port_config(FAULTY), tb,
                          schedule=Schedule(**sched), device="cpu").run()
    _assert_engines_equal(je, te, len(batch))
    assert te.occupancy.admissions == 12 - 4
    assert te.stats()["fault_retransmissions"] > 0


@pytest.mark.parametrize("sched", [
    dict(resident=2, fused=True), dict(interval=16, fused=False),
], ids=["fused", "host"])
def test_scheduled_elision_matches_jax(sched):
    """The hot-hit zipf workload of ``test_elision.py``, scheduled with
    elision on: equal to JAX (whose elided runs equal its lockstep
    runs, ``test_elision.py``), elision counters included."""
    cfg = CFG
    batch = [gen_hot_hit_zipf(cfg, 48, seed=s)
             for s in range(6 if sched["fused"] else 4)]
    je = BatchJaxEngine(cfg, batch, schedule=JSchedule(**sched)).run()
    tb = [port_traces(t) for t in batch]
    te = BatchTorchEngine(port_config(cfg), tb, schedule=Schedule(**sched),
                          device="cpu").run()
    _assert_engines_equal(je, te, len(batch))
    assert te.occupancy.as_dict()["elided_cycles"] > 0


def test_host_loop_stall_matches_jax():
    """A row older than ``max_cycles`` raises the same stall diagnostic
    as JAX's host chunk loop."""
    from hpa2_tpu.models.spec_engine import StallError as JStallError

    batch = _zipf_batch(CFG)[:4]
    sched = dict(resident=2, interval=8, fused=False)
    with pytest.raises(JStallError) as jerr:
        BatchJaxEngine(CFG, batch, max_cycles=20,
                       schedule=JSchedule(**sched)).run()
    with pytest.raises(StallError) as terr:
        BatchTorchEngine(port_config(CFG), [port_traces(t) for t in batch],
                         max_cycles=20, schedule=Schedule(**sched),
                         device="cpu").run()
    assert str(terr.value) == str(jerr.value)


def test_schedule_refusals_name_their_items():
    tb = [port_traces(t) for t in _zipf_batch(CFG)[:2]]
    # data shards are ported: what stays refused is a resident count
    # the shards do not divide
    with pytest.raises(ValueError, match="must divide data_shards=2"):
        BatchTorchEngine(port_config(CFG), tb, data_shards=2,
                         schedule=Schedule(resident=1), device="cpu")
    with pytest.raises(ValueError, match="outside"):
        BatchTorchEngine(port_config(CFG), tb, device="cpu",
                         schedule=Schedule(resident=3))
    with pytest.raises(ValueError, match="not divisible by data_shards=2"):
        BatchLaneSession(port_config(CFG), 3, 8, data_shards=2,
                         device="cpu")


# -- serve(backend="jax") ---------------------------------------------------


def _served(results):
    return {r.job_id: (dicts(r.dumps), r.counters, r.wait_intervals)
            for r in results}


@pytest.mark.parametrize("variant,kw", [
    ("plain", dict(overlap=True)),
    ("plain", dict(overlap=False)),
    ("faults", {}),
    ("moesi", {}),
    ("window", dict(resident=4, max_trace_len=64, interval=8,
                    jax_window=8)),
], ids=["overlap", "serial", "faults", "moesi", "window"])
def test_serve_jax_matches_jax_serve(variant, kw):
    """Eight zipf-length jobs through two rows: every job's dumps,
    counters and wait, and the occupancy dict, equal JAX's serving run
    of the same feed; every compile count is 1."""
    cfg = {"plain": CFG, "window": CFG,
           "faults": dataclasses.replace(CFG, fault=jconfig.FaultModel(
               drop=0.2, duplicate=0.1, reorder=0.1, seed=13)),
           "moesi": dataclasses.replace(CFG, protocol="moesi")}[variant]
    kw = {**dict(resident=2, max_trace_len=32, interval=64), **kw}
    jjobs = jsynthetic_jobs(cfg, 8, 24, seed=7, spread=3.0)
    tcfg = port_config(cfg)
    tjobs = synthetic_jobs(tcfg, 8, 24, seed=7, spread=3.0)
    jres, jst = jserve(cfg, JListJobSource(jjobs), backend="jax", **kw)
    tres, tst = serve(tcfg, ListJobSource(tjobs), backend="jax",
                      device="cpu", **kw)
    assert _served(tres) == _served(jres)
    assert tst.occupancy == jst.occupancy
    assert tst.jobs_completed == 8
    assert set(tst.compile_counts) == set(jst.compile_counts)
    assert set(tst.compile_counts.values()) == {1}


def test_lane_session_admits_in_one_scatter_and_keeps_its_rows():
    """Admissions wait for the next chunk and go in together; the
    resident tensors keep their storage; ``take_rows`` returns what
    ``take_row`` does, row by row."""
    cfg = port_config(CFG)
    sess = BatchLaneSession(cfg, 4, 16, interval=8, device="cpu")
    ptrs = [x.data_ptr() for x in sess.state]
    rows = [sess.fresh_row(port_traces(gen_uniform_random(CFG, 8, seed=s)))
            for s in range(3)]
    for i, row in enumerate(rows):
        sess.admit(i, row)
    assert len(sess._rows) == 3
    sess.advance()
    assert not sess._rows
    while not sess.quiescent_rows()[:3].all():
        sess.advance()
    assert [x.data_ptr() for x in sess.state] == ptrs
    got = sess.take_rows([2, 0])
    for i, row in zip([2, 0], got):
        assert all(torch.equal(a, b) for a, b in zip(row, sess.take_row(i)))
    assert sess.counters_of(got[1])["instructions"] == 4 * 8
    assert stack_states(got).pc.shape[0] == 2
