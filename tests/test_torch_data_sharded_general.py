"""The general engine's data axis on the CPU:
``BatchTorchEngine(data_shards=)`` (the batch split into row groups, one
loop whose condition and elision jump are global over them,
``parallel/sharding.py:DataShardedRun``) against ``BatchJaxEngine(
data_shards=)`` on the virtual mesh in every state field, unscheduled
and scheduled (fused and the host chunk loop, one scheduling group a
shard), as ``tests/test_parallel.py:84``; the one ``data_shards`` knob
on both of the port's ensemble backends (``tests/test_parallel.py:134``);
and ``serve(backend="jax", data_shards=)`` against JAX's."""

import pytest
import torch

from hpa2_tpu.ops.schedule import Schedule as JSchedule
from hpa2_tpu.serving import ListJobSource as JListJobSource
from hpa2_tpu.serving import serve as jserve
from hpa2_tpu.serving import synthetic_jobs as jsynthetic_jobs
from hpa2_tpu.utils.trace import gen_uniform_random
from hpa2_tpu_torch.ops.engine import BatchTorchEngine
from hpa2_tpu_torch.parallel import DataShardedCudaEngine
from hpa2_tpu_torch.serving import ListJobSource, serve, synthetic_jobs
from hpa2_tpu_torch.utils.trace import traces_to_arrays
from torch_general import assert_batch_equal, port_config, port_traces
from torch_pairs import IGNORE_PLTPU_ANY, config_pair, dicts
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings(IGNORE_PLTPU_ANY)


def test_batch_engine_data_shards_match_jax():
    """``tests/test_parallel.py:84`` at a small size: 8 data shards of
    an 8-system ensemble equal JAX's and the unsharded run in every
    field, cycles included."""
    jcfg, _ = config_pair(True, num_procs=4, msg_buffer_size=16)
    batch = [gen_uniform_random(jcfg, 12, seed=100 + s) for s in range(8)]
    je, te = assert_batch_equal(jcfg, batch, data_shards=8)
    ref = BatchTorchEngine(port_config(jcfg),
                           [port_traces(t) for t in batch], device="cpu")
    ref.run()
    for a, b in zip(te.state, ref.state):
        assert torch.equal(a, b)
    assert te.data_shards == je.data_shards == 8


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host"])
def test_scheduled_batch_engine_data_shards_match_jax(fused):
    jcfg, _ = config_pair(True, num_procs=4)
    batch = [gen_uniform_random(jcfg, 4 + 3 * (s % 5), seed=s)
             for s in range(8)]
    je, te = assert_batch_equal(
        jcfg, batch, data_shards=2, schedule=JSchedule(
            resident=4, fused=fused, interval=8))
    assert te.occupancy.as_dict() == je.occupancy.as_dict()


def test_unified_data_shards_knob_both_backends():
    """``tests/test_parallel.py:134``: one ``data_shards`` knob on both
    port backends; the same workload agrees on the final dumps and on
    the ensemble's wall cycles."""
    jcfg, tcfg = config_pair(True, num_procs=8, msg_buffer_size=16)
    batch = [gen_uniform_random(jcfg, 12, seed=40 + s) for s in range(8)]
    xla = BatchTorchEngine(tcfg, [port_traces(t) for t in batch],
                           data_shards=4, device="cpu").run()
    fast = DataShardedCudaEngine(
        tcfg, *traces_to_arrays(tcfg, [port_traces(t) for t in batch]),
        data_shards=4, block=2, cycles_per_call=64, snapshots=False,
        device="cpu").run()
    assert xla.data_shards == fast.data_shards == 4
    assert fast.instructions == xla.instructions
    for s in (0, 5, 7):
        assert dicts(fast.system_final_dumps(s)) == dicts(
            xla.system_final_dumps(s))
    assert fast.cycle == int(xla.state.cycle.max())


@pytest.mark.parametrize("data_shards", [2])
def test_jax_serving_data_shards_match_jax(data_shards):
    """``serve(backend="jax", data_shards=)``: the rows split over the
    shards, one chunk loop over them; every job's dumps and counters
    equal JAX's."""
    jcfg, tcfg = config_pair(True, num_procs=4)
    jjobs = jsynthetic_jobs(jcfg, 8, 16, seed=3, spread=3.0)
    tjobs = synthetic_jobs(tcfg, 8, 16, seed=3, spread=3.0)
    kw = dict(backend="jax", resident=4, interval=16, max_trace_len=16,
              data_shards=data_shards)
    # the JAX session re-places its rows on the mesh at admission, which
    # its own recompile guard counts: the guard holds on the port's side
    jres, _ = jserve(jcfg, JListJobSource(jjobs), compile_guard=False, **kw)
    tres, tst = serve(tcfg, ListJobSource(tjobs), device="cpu", **kw)
    by_id = {r.job_id: r for r in jres}
    assert sorted(by_id) == sorted(r.job_id for r in tres)
    for r in tres:
        assert dicts(r.dumps) == dicts(by_id[r.job_id].dumps), r.job_id
        assert r.counters == by_id[r.job_id].counters
    assert all(v == 1 for v in tst.compile_counts.values())
    assert torch.get_num_threads() == 1
