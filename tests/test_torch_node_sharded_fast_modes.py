"""The fast path's node axis on the CPU, part two: the four exchange
schedules over 4 gloo ranks (one spawned group) against JAX
``NodeShardedPallasEngine`` (``tests/test_node_sharded_pallas.py:128-
140``), the collectives and host reads of what runs (the census of the
``node-sharded-pallas-a2a`` contract: a cycle, a window's seed, a later
gate), the node-sharded serving session (``NodeShardedLaneSession`` on a
``RankPool``) against the one-card session, the one-shot run and JAX's
``serve(backend="pallas-node-sharded")``, and the rank pool's failure
paths."""

import dataclasses
import functools
import os
import time

import jax
import numpy as np
import pytest

from hpa2_tpu.parallel.sharding import NodeShardedPallasEngine
from hpa2_tpu.serving import ListJobSource as JListJobSource
from hpa2_tpu.serving import serve as jserve
from hpa2_tpu.serving import synthetic_jobs as jsynthetic_jobs
from hpa2_tpu.utils.trace import gen_uniform_random_arrays
from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
from hpa2_tpu_torch.ops.cycle import TRANSIENTS
from hpa2_tpu_torch.ops.exchange import make_plan, plan_collectives
from hpa2_tpu_torch.ops.schedule import Schedule
from hpa2_tpu_torch.parallel import (
    NodeShardedCudaEngine, NodeShardedLaneSession, make_mesh,
)
from hpa2_tpu_torch.parallel.launch import RankPool
from hpa2_tpu_torch.parallel.sharding import run_node_sharded
from hpa2_tpu_torch.serving import ListJobSource, serve, synthetic_jobs
from hpa2_tpu_torch.serving.loop import ServingSession
from torch_pairs import IGNORE_PLTPU_ANY, config_pair, dicts
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings(IGNORE_PLTPU_ANY)

MODES = ("pairwise", "a2a", "butterfly", "hier")
JCFG, TCFG = config_pair(True, num_procs=8)
ARRAYS = gen_uniform_random_arrays(JCFG, 4, 12, seed=1)


def _need(d):
    if len(jax.devices()) < d:
        pytest.skip(f"needs {d} virtual devices")


@functools.lru_cache(maxsize=None)
def _jax(mode):
    """JAX's node-sharded run at 4 shards with the schedule ``mode``."""
    return NodeShardedPallasEngine(
        dataclasses.replace(JCFG, exchange_mode=mode), *ARRAYS,
        node_shards=4, cycles_per_call=16).run()


@functools.lru_cache(maxsize=None)
def _modes():
    """Every schedule at 4 gloo ranks in one spawned group."""
    engs = {m: NodeShardedCudaEngine(
        dataclasses.replace(TCFG, exchange_mode=m), *ARRAYS,
        mesh=make_mesh(node_shards=4, data_shards=1, device="cpu"),
        cycles_per_call=16) for m in MODES}
    run_node_sharded(list(engs.values()))
    return engs


@pytest.mark.parametrize("mode", MODES)
def test_every_exchange_mode_bit_exact(mode):
    """``tests/test_node_sharded_pallas.py:128-140``: every plane, the
    eight transient rows, the counters, ``stats()`` (the ``exchange_*``
    keys, hier's combining count among them) and every dump equal JAX's
    run at 4 shards with the same schedule; and the schedule changes
    how entries travel, never what arrives: the architectural planes
    equal the a2a run's."""
    _need(4)
    eng, ref = _modes()[mode], _jax(mode)
    for f, v in ref.state.items():
        assert np.array_equal(np.asarray(v), eng.state[f].numpy()), f
    assert set(TRANSIENTS) <= set(ref.state)
    assert eng.cycle == ref.cycle and eng.messages == ref.messages
    assert eng.instructions == ref.instructions
    assert eng.stats() == ref.stats()
    for s in range(ref.b):
        assert dicts(eng.system_final_dumps(s)) == dicts(
            ref.system_final_dumps(s))
    a2a = _modes()["a2a"]
    for f, v in a2a.state.items():
        if f not in TRANSIENTS:
            assert np.array_equal(v.numpy(), eng.state[f].numpy()), f


@pytest.mark.parametrize("mode", MODES)
def test_collectives_and_host_reads(mode):
    """What each rank issues (``tests/test_node_sharded_pallas.py:279-
    309`` counts JAX's traced program; the port counts what runs): a
    cycle is the plan's collectives plus one SUM and one MAX; a window's
    seed is one SUM and the gate's MAX; a later k-cycle call's gate one
    MAX; and one host read a call plus the seed's gate and the status."""
    _need(4)
    eng = _modes()[mode]
    want = dict(plan_collectives(make_plan(4, mode)), sum=1, max=1, min=0)
    for st in eng.rank_stats:
        c = st["census"]
        assert c["cycle"] == want
        assert c["seed"] == dict.fromkeys(want, 0) | {"sum": 1, "max": 1}
        assert c["gate"] == dict.fromkeys(want, 0) | {"max": 1}
        assert st["host_syncs"] == st["calls"] + 2
        assert st["cycles"] == 16 * st["calls"] >= eng.cycle


JOBS_N, RESIDENT, WINDOW = 8, 4, 8


@functools.lru_cache(maxsize=None)
def _feeds():
    jcfg, tcfg = config_pair(True, num_procs=4)
    return (jcfg, jsynthetic_jobs(jcfg, JOBS_N, 24, seed=7, spread=3.0),
            tcfg, synthetic_jobs(tcfg, JOBS_N, 24, seed=7, spread=3.0))


def _served(results):
    return {r.job_id: (dicts(r.dumps), r.counters) for r in results}


def test_session_serves_the_one_card_and_jax_results():
    """``NodeShardedLaneSession`` over two gloo ranks (a ``RankPool``)
    driven by the serving loop: every job's dumps equal the one-card
    session's and the one-shot scheduled run's, its counters
    (``cross_shard_msgs``, ``exchange_slot_hwm``, the savings) equal
    JAX's ``serve(backend="pallas-node-sharded")``, every compile count
    is 1, a one-shot run in the session's ranks equals the unsharded
    run (a pool of another size is refused), and closing the session
    ends the ranks."""
    _need(2)
    jcfg, jjobs, tcfg, jobs = _feeds()
    kw = dict(resident=RESIDENT, window=WINDOW, block=4)
    arrays = tuple(np.stack([getattr(j, f) for j in jobs])
                   for f in ("tr_op", "tr_addr", "tr_val", "tr_len"))
    run_kw = dict(block=4, trace_window=WINDOW, snapshots=False,
                  cycles_per_call=16)
    shot = NodeShardedCudaEngine(
        tcfg, *arrays, mesh=make_mesh(node_shards=2, device="cpu"),
        **run_kw)
    with NodeShardedLaneSession(tcfg, RESIDENT, WINDOW, node_shards=2,
                                cycles_per_call=16, device="cpu") as sess:
        res, st = ServingSession(sess, ListJobSource(jobs)).run()
        # a one-shot run in the session's ranks
        run_node_sharded([shot], pool=sess.pool)
        with pytest.raises(ValueError, match="pool of 2"):
            run_node_sharded([NodeShardedCudaEngine(
                tcfg, *arrays, mesh=make_mesh(node_shards=4, device="cpu"),
                **run_kw)], pool=sess.pool)
        procs = list(sess.pool._procs)
    assert not any(p.is_alive() for p in procs)
    assert set(st.compile_counts.values()) == {1}
    unsharded = CudaEngine(tcfg, *arrays, device="cpu", **run_kw).run()
    for f, v in unsharded.state.items():
        assert np.array_equal(v.numpy(), shot.state[f].numpy()), f
    assert shot.cycle == unsharded.cycle
    got = _served(res)
    one_card, _ = serve(tcfg, ListJobSource(jobs), device="cpu", **kw)
    assert {k: d for k, (d, _) in got.items()} == {
        k: d for k, (d, _) in _served(one_card).items()}
    one_shot = CudaEngine(tcfg, *arrays, block=4, trace_window=WINDOW,
                          snapshots=False, device="cpu",
                          schedule=Schedule(resident=RESIDENT)).run()
    for s, j in enumerate(jobs):
        assert got[j.job_id][0] == dicts(one_shot.system_final_dumps(s))
    jres, _ = jserve(jcfg, JListJobSource(jjobs),
                     backend="pallas-node-sharded", node_shards=2, **kw)
    want = _served(jres)
    for k, (d, c) in got.items():
        assert d == want[k][0]
        assert {x: c[x] for x in want[k][1]} == want[k][1], k
        assert c["cross_shard_msgs"] > 0


def _boom(env):
    raise RuntimeError("rank says no")


def _rank_of(env):
    import torch.distributed as dist

    return dist.get_rank()


def _die(env):
    os._exit(3)


def test_rank_pool_failures_raise_and_end_the_ranks():
    """A rank's exception raises in the caller with its traceback; a
    rank that dies raises (it never hangs); either way the pool has
    ended every rank."""
    with RankPool(2, device="cpu") as pool:
        assert pool.call(_rank_of) == [0, 1]
        with pytest.raises(RuntimeError, match="rank says no"):
            pool.call(_boom)
        assert pool.closed
        assert not any(p.is_alive() for p in pool._procs)
        with pytest.raises(RuntimeError, match="closed"):
            pool.call(_rank_of)
    pool = RankPool(2, device="cpu")
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="exited"):
        pool.call(_die)
    assert time.monotonic() - t0 < 30
    assert not any(p.is_alive() for p in pool._procs)
    with pytest.raises(ValueError, match="ranks"):
        RankPool(0, device="cpu")
