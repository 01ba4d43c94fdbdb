"""The fast path's node axis over logical ranks (``make_mesh(...,
local=True)``: threads of this process meeting through
``parallel/comm.py:LocalComm``) on the CPU, against the JAX package:
every plane, the eight transient rows, cycle, counters, ``stats()`` (the
``exchange_*`` keys) and every dump equal JAX ``NodeShardedPallasEngine``
on the same mesh size (XLA on the virtual CPU devices, as
``tests/test_node_sharded_pallas.py`` runs it), and the architectural
planes equal interpreted ``PallasEngine``'s; a cycle's collectives are
the plan's plus one SUM and one MAX, counted as NCCL ranks count them;
and a served feed through ``NodeShardedLaneSession`` on logical ranks
equals the one-card session's."""

import dataclasses
import functools

import jax
import numpy as np
import pytest

from hpa2_tpu.ops.pallas_engine import PallasEngine
from hpa2_tpu.parallel.sharding import NodeShardedPallasEngine
from hpa2_tpu.utils.trace import gen_uniform_random_arrays
from hpa2_tpu_torch.ops.cycle import TRANSIENTS
from hpa2_tpu_torch.ops.exchange import make_plan, plan_collectives
from hpa2_tpu_torch.parallel import (
    NodeShardedCudaEngine, NodeShardedLaneSession, make_mesh,
)
from hpa2_tpu_torch.serving import ListJobSource, serve, synthetic_jobs
from hpa2_tpu_torch.serving.loop import ServingSession
from torch_pairs import IGNORE_PLTPU_ANY, config_pair, dicts
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings(IGNORE_PLTPU_ANY)

JCFG, TCFG = config_pair(True, num_procs=8)
ARRAYS = gen_uniform_random_arrays(JCFG, 4, 12, seed=1)
#: (logical ranks, exchange schedule)
CASES = [(2, "a2a"), (2, "pairwise"), (4, "a2a")]


@functools.lru_cache(maxsize=None)
def _jax(node, mode):
    if len(jax.devices()) < node:
        pytest.skip(f"needs {node} virtual devices")
    return NodeShardedPallasEngine(
        dataclasses.replace(JCFG, exchange_mode=mode), *ARRAYS,
        node_shards=node, cycles_per_call=16).run()


@functools.lru_cache(maxsize=None)
def _interpreted():
    return PallasEngine(JCFG, *ARRAYS, interpret=True, block=2,
                        snapshots=True).run()


@functools.lru_cache(maxsize=None)
def _local(node, mode):
    return NodeShardedCudaEngine(
        dataclasses.replace(TCFG, exchange_mode=mode), *ARRAYS,
        mesh=make_mesh(node_shards=node, device="cpu", local=True),
        cycles_per_call=16).run()


@pytest.mark.parametrize("node,mode", CASES)
def test_logical_ranks_equal_jax_node_sharded(node, mode):
    ref, eng = _jax(node, mode), _local(node, mode)
    for f, v in ref.state.items():
        assert np.array_equal(np.asarray(v), eng.state[f].numpy()), f
    assert set(TRANSIENTS) <= set(ref.state)
    assert eng.cycle == ref.cycle and eng.messages == ref.messages
    assert eng.instructions == ref.instructions
    assert eng.stats() == ref.stats()
    for s in range(ref.b):
        assert dicts(eng.system_final_dumps(s)) == dicts(
            ref.system_final_dumps(s))
        assert dicts(eng.system_snapshots(s)) == dicts(
            ref.system_snapshots(s))
    one = _interpreted()
    for f, v in one.state.items():
        assert np.array_equal(np.asarray(v), eng.state[f].numpy()), f


@pytest.mark.parametrize("node,mode", CASES)
def test_logical_ranks_collectives_and_host_reads(node, mode):
    """Each logical rank counts its own collectives: a cycle is the
    plan's plus one SUM and one MAX, a window's seed one SUM and the
    gate's MAX, a later gate one MAX; one host read a call plus the
    seed's gate and the status."""
    eng = _local(node, mode)
    want = dict(plan_collectives(make_plan(node, mode)), sum=1, max=1,
                min=0)
    assert len(eng.rank_stats) == node
    for st in eng.rank_stats:
        c = st["census"]
        assert c["cycle"] == want
        assert c["seed"] == dict.fromkeys(want, 0) | {"sum": 1, "max": 1}
        assert c["gate"] == dict.fromkeys(want, 0) | {"max": 1}
        assert st["host_syncs"] == st["calls"] + 2
        assert st["cycles"] == 16 * st["calls"] >= eng.cycle
        # the CPU runs the plain versions: no kernel was launched
        assert set(st["launches"].values()) == {0}


def test_session_on_logical_ranks_serves_the_one_card_results():
    """``NodeShardedLaneSession`` on two logical ranks: every served job's
    dumps equal the one-card session's, every compile count is 1."""
    jobs = synthetic_jobs(TCFG, 8, 16, seed=7, spread=3.0)
    kw = dict(resident=4, window=8, block=4)
    want, _ = serve(TCFG, ListJobSource(jobs), device="cpu", **kw)
    with NodeShardedLaneSession(
            TCFG, 4, 8, mesh=make_mesh(node_shards=2, device="cpu",
                                       local=True),
            cycles_per_call=16, device="cpu") as sess:
        got, st = ServingSession(sess, ListJobSource(jobs)).run()
    assert set(st.compile_counts.values()) == {1}
    assert {r.job_id: dicts(r.dumps) for r in got} == {
        r.job_id: dicts(r.dumps) for r in want}
    assert sum(r.counters["cross_shard_msgs"] for r in got) > 0
