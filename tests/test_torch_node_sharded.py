"""The general engine's node axis (``hpa2_tpu_torch.parallel``:
``NodeShardedEngine``, ``GridEngine``) in 2, 4 and 8 gloo ranks on the
CPU, against the JAX package (``tests/test_parallel.py:38-82``,
``tests/test_node_sharded_pallas.py:378``): every exchange mode with
elision on, and off, and under link faults; each run equal to
``JaxEngine`` in cycle, counters, snapshots and dumps, and where the
JAX ``NodeShardedEngine`` ran the same mesh, equal to it in every state
field (``n_exch_*`` and, under faults, each shard's own fault stream
included); ``GridEngine`` (2 x 2 ranks) against per-system runs; and a
cycle's collectives equal to ``plan_collectives`` plus one SUM and one
MAX.  The runs of one rank count share one spawned group."""

import dataclasses
import functools

import jax
import pytest

from hpa2_tpu.config import FaultModel, InterconnectConfig
from hpa2_tpu.ops.engine import JaxEngine
from hpa2_tpu.parallel import NodeShardedEngine as JNodeShardedEngine
from hpa2_tpu.parallel import make_mesh as jmake_mesh
from hpa2_tpu.utils.trace import gen_producer_consumer, gen_uniform_random
from hpa2_tpu_torch.ops.exchange import make_plan, plan_collectives
from hpa2_tpu_torch.parallel import GridEngine, NodeShardedEngine, make_mesh
from hpa2_tpu_torch.parallel.sharding import run_node_sharded
from torch_general import (
    ACCEPT, dicts, freeze, jax_single, port_config, port_traces, state_diff,
)
from torch_pairs import config_pair
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

MODES = ("pairwise", "a2a", "butterfly", "hier")
JCFG = config_pair(True, num_procs=8)[0]
TRACES = gen_uniform_random(JCFG, 12, seed=1)
JCFG16 = dataclasses.replace(JCFG, num_procs=16)
TRACES16 = gen_producer_consumer(JCFG16, 8, seed=3)
FAULTY = dataclasses.replace(JCFG, interconnect=InterconnectConfig(
    fault=FaultModel(**ACCEPT)))
GRID = [gen_uniform_random(JCFG, 10, seed=20 + s) for s in range(4)]

#: per rank count, the runs of its group: (name, JAX config, traces)
RUNS = {
    2: [(f"{m}", dataclasses.replace(JCFG, exchange_mode=m), TRACES)
        for m in MODES]
    + [("a2a no-elide", dataclasses.replace(JCFG, elide=False), TRACES),
       ("a2a faults", FAULTY, TRACES)],
    4: [(f"{m}", dataclasses.replace(JCFG, exchange_mode=m), TRACES)
        for m in MODES],
    8: [("a2a", JCFG, TRACES),
        ("pairwise", dataclasses.replace(JCFG, exchange_mode="pairwise"),
         TRACES),
        ("a2a 16 nodes", JCFG16, TRACES16)],
}
#: runs the JAX NodeShardedEngine repeats on the same mesh
JAX_SHARDED = {(2, "pairwise"), (4, "a2a"), (2, "a2a faults")}


#: every (rank count, run index)
CASES = [(d, i) for d in sorted(RUNS) for i in range(len(RUNS[d]))]


@functools.lru_cache(maxsize=None)
def _spawned(d):
    """One spawned group of ``d`` gloo ranks running every run of
    ``RUNS[d]`` (and, at 4, the 2 x 2 grid), once a process:
    {name: engine}."""
    engines = {name: NodeShardedEngine(
        port_config(cfg), port_traces(traces),
        mesh=make_mesh(node_shards=d, data_shards=1, device="cpu"))
        for name, cfg, traces in RUNS[d]}
    if d == 4:
        engines["grid"] = GridEngine(
            port_config(JCFG), [port_traces(t) for t in GRID],
            mesh=make_mesh(node_shards=2, data_shards=2, device="cpu"))
    run_node_sharded(list(engines.values()))
    return engines


@pytest.fixture
def group(request):
    d = request.param
    if len(jax.devices()) < d:
        pytest.skip(f"needs {d} virtual devices")
    return d, _spawned(d)


def _stats(s):
    # a rank's watchdog proposal keys on its own issuers, so the jump
    # sizes (not the cycles) may differ from the unsharded run's (JAX
    # build_node_sharded_run); the exchange counters exist only sharded
    skip = ("exchange", "elided", "multi_hit")
    return {k: v for k, v in s.items() if not k.startswith(skip)}


@pytest.mark.parametrize("group,idx", CASES, indirect=["group"])
def test_node_sharded_matches_jax_engine(group, idx):
    d, engines = group
    name, cfg, traces = RUNS[d][idx]
    eng = engines[name]
    ref, err = jax_single(cfg, freeze(traces))
    assert err is None
    assert eng.cycle == ref.cycle
    assert eng.instructions == ref.instructions
    assert eng.messages == ref.messages
    assert dicts(eng.snapshots()) == dicts(ref.snapshots())
    assert dicts(eng.final_dumps()) == dicts(ref.final_dumps())
    if not cfg.fault.enabled:  # a shard draws its own link stream
        assert _stats(eng.stats()) == _stats(ref.stats())
    if (d, name) in JAX_SHARDED:
        je = JNodeShardedEngine(cfg, traces, mesh=jmake_mesh(node_shards=d))
        je.run()
        assert state_diff(je.state, eng.state, batched=False) == []
        assert eng.stats() == je.stats()


@pytest.mark.parametrize("group,idx", CASES, indirect=["group"])
def test_collectives_a_cycle(group, idx):
    """``tests/test_node_sharded_pallas.py:378``: a cycle's collectives
    are the plan's plus one SUM and one MAX, and a loop test is two
    MINs (quiescence over the node group, the loop's terms over every
    rank)."""
    d, engines = group
    name, cfg, _ = RUNS[d][idx]
    eng = engines[name]
    want = dict(plan_collectives(make_plan(d, cfg.exchange_mode,
                                           cfg.exchange_inner)),
                sum=1, max=1, min=0)
    for r, st in enumerate(eng.rank_stats):
        assert st["step_collectives"] == want, (r, st)
        assert st["loop_collectives"] == dict.fromkeys(want, 0) | {"min": 2}
    if cfg.elide:
        assert eng.rank_stats[0]["jumps"] > 0 or eng.cycle == \
            eng.rank_stats[0]["steps"]


@pytest.mark.parametrize("group", [4], indirect=True)
def test_grid_matches_per_system(group):
    _, engines = group
    grid = engines["grid"]
    for b, traces in enumerate(GRID):
        ref = JaxEngine(JCFG, traces).run()
        assert dicts(grid.system_snapshots(b)) == dicts(ref.snapshots())
    assert grid.instructions == sum(len(t) for tr in GRID for t in tr)
    assert grid.mesh.shape == {"data": 2, "node": 2}


def test_refusals():
    tcfg = port_config(JCFG)
    traces = port_traces(TRACES)
    with pytest.raises(ValueError, match="not divisible"):
        NodeShardedEngine(tcfg, traces, mesh=make_mesh(
            node_shards=3, data_shards=1, device="cpu"))
    topo = dataclasses.replace(tcfg, interconnect=dataclasses.replace(
        tcfg.interconnect, topology="mesh2d"))
    with pytest.raises(ValueError, match="ideal"):
        NodeShardedEngine(topo, traces, mesh=make_mesh(
            node_shards=2, data_shards=1, device="cpu"))
    with pytest.raises(ValueError, match="1 x node"):
        NodeShardedEngine(tcfg, traces, mesh=make_mesh(
            node_shards=2, data_shards=2, device="cpu"))
    with pytest.raises(ValueError, match="divisible"):
        GridEngine(tcfg, [traces] * 3, mesh=make_mesh(
            node_shards=1, data_shards=2, device="cpu"))
    with pytest.raises(ValueError, match="empty mesh"):
        make_mesh(node_shards=1, data_shards=0, device="cpu")
