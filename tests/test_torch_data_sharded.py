"""The data axis of the port (``hpa2_tpu_torch.parallel``) against the
JAX package's, on the CPU: ``DataShardedCudaEngine(device="cpu")`` (the
kernels' plain versions on logical shards) against interpreted
``DataShardedPallasEngine`` on the virtual 8-device mesh, plane for
plane with the status, dumps, counters and ``occupancy`` (every run
variant of ``tests/test_data_sharded_pallas.py``, the bench workload,
fewer shards than devices, packed planes, fused and host-barrier
scheduled runs); the refusals; one status read and no collective in a
data-sharded run; ``DataShardedLaneSession`` and
``serve(backend="pallas-sharded")`` against JAX's job for job.  The
general engine's data axis is ``test_torch_data_sharded_general.py``."""

import numpy as np
import pytest
import torch

from hpa2_tpu.ops.schedule import Schedule as JSchedule
from hpa2_tpu.parallel.sharding import DataShardedPallasEngine
from hpa2_tpu.serving import ListJobSource as JListJobSource
from hpa2_tpu.serving import serve as jserve
from hpa2_tpu.serving import synthetic_jobs as jsynthetic_jobs
from hpa2_tpu.utils.trace import (
    gen_heterogeneous_random_arrays, gen_uniform_random_arrays,
)
from hpa2_tpu_torch.convert import state_to_numpy
from hpa2_tpu_torch.ops import kernels
from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
from hpa2_tpu_torch.ops.schedule import Schedule
from hpa2_tpu_torch.parallel import (
    DataShardedCudaEngine, DataShardedLaneSession, make_data_mesh, make_mesh,
)
from hpa2_tpu_torch.parallel.comm import COLLECTIVES
from hpa2_tpu_torch.serving import ListJobSource, serve, synthetic_jobs
from torch_pairs import IGNORE_PLTPU_ANY, config_pair, dicts
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings(IGNORE_PLTPU_ANY)

# every run-program shape of tests/test_data_sharded_pallas.py:69
VARIANTS = {
    "default": dict(),
    "window7": dict(trace_window=7, snapshots=False),
    "window1": dict(trace_window=1, snapshots=False),
    "legacy": dict(stream=False),
    "nogate": dict(gate=False),
}


def _both(jcfg, tcfg, arrays, shards, max_cycles=200_000, fused=None,
          **kw):
    """The two data-sharded engines on the same arrays (``fused`` not
    None: under each package's ``Schedule(resident=b/2, fused=)``);
    asserts every plane, the status, dumps, counters and occupancy
    agree."""
    jkw, tkw = dict(kw), dict(kw)
    if fused is not None:
        resident = arrays[0].shape[0] // 2
        jkw["schedule"] = JSchedule(resident=resident, fused=fused)
        tkw["schedule"] = Schedule(resident=resident, fused=fused)
    je = DataShardedPallasEngine(jcfg, *arrays, data_shards=shards,
                                 interpret=True, **jkw)
    te = DataShardedCudaEngine(tcfg, *arrays, data_shards=shards,
                               device="cpu", **tkw)
    outcome = []
    for eng in (je, te):
        try:
            eng.run(max_cycles=max_cycles)
            outcome.append(None)
        except Exception as e:  # noqa: BLE001 (the stall message)
            outcome.append(str(e))
    assert outcome[0] == outcome[1]
    assert te.data_shards == je.data_shards == shards
    got = state_to_numpy(te.state)
    assert set(got) == set(je.state)
    for f, v in got.items():
        np.testing.assert_array_equal(v, np.asarray(je.state[f]),
                                      err_msg=f"plane {f!r}")
    assert te.cycle == je.cycle
    assert te.instructions == je.instructions
    assert te.messages == je.messages
    assert te.stats() == je.stats()
    for s in {0, te.b // 2, te.b - 1}:
        assert dicts(te.system_final_dumps(s)) == dicts(
            je.system_final_dumps(s))
    if fused is not None:
        assert te.occupancy.as_dict() == je.occupancy.as_dict()
    return je, te


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sharded_engine_matches_jax(variant):
    jcfg, tcfg = config_pair(True, num_procs=4)
    arrays = gen_uniform_random_arrays(jcfg, 16, 12, seed=2)
    _both(jcfg, tcfg, arrays, 8, block=2, cycles_per_call=16,
          **VARIANTS[variant])


def test_sharded_bench_workload_matches_jax():
    jcfg, tcfg = config_pair(True, num_procs=8, msg_buffer_size=16)
    arrays = gen_uniform_random_arrays(jcfg, 32, 16, seed=0)
    _both(jcfg, tcfg, arrays, 8, max_cycles=500_000, block=4,
          cycles_per_call=64, snapshots=False, trace_window=8)


@pytest.mark.parametrize("packed", [False, True], ids=["int32", "packed"])
def test_fewer_shards_than_devices(packed):
    jcfg, tcfg = config_pair(True, num_procs=4)
    arrays = gen_uniform_random_arrays(jcfg, 16, 12, seed=5)
    _, te = _both(jcfg, tcfg, arrays, 2, block=8, cycles_per_call=16,
                  packed=packed)
    # and the single-device engine's planes
    ref = CudaEngine(tcfg, *arrays, block=8, cycles_per_call=16,
                     packed=packed, device="cpu").run()
    for f, v in ref.state.items():
        assert torch.equal(te.state[f], v), f


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "host"])
@pytest.mark.parametrize("stream", [True, False], ids=["stream", "call"])
def test_scheduled_sharded_engine_matches_jax(fused, stream):
    jcfg, tcfg = config_pair(True, num_procs=4)
    arrays = gen_heterogeneous_random_arrays(jcfg, 16, 16, dist="zipf",
                                             spread=4.0, seed=3)
    _both(jcfg, tcfg, arrays, 4, block=2, cycles_per_call=16,
          snapshots=False, trace_window=6, stream=stream, fused=fused)


def test_refusals_and_mesh_bounds():
    jcfg, tcfg = config_pair(True, num_procs=4)
    arrays = gen_uniform_random_arrays(jcfg, 30, 8, seed=1)
    with pytest.raises(ValueError, match="divisible"):
        DataShardedCudaEngine(tcfg, *arrays, data_shards=8, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        DataShardedCudaEngine(tcfg, *arrays, data_shards=3, device="cpu",
                              schedule=Schedule(resident=10),
                              snapshots=False)
    # a foreign (data x node) mesh
    with pytest.raises(ValueError, match="1-D"):
        DataShardedCudaEngine(tcfg, *arrays, device="cpu",
                              mesh=make_mesh(node_shards=2, device="cpu"))
    with pytest.raises(ValueError, match="outside"):
        make_data_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        make_data_mesh(9, devices=["cpu"] * 8)
    mesh = make_data_mesh(device="cpu")
    assert mesh.axis_names == ("data",) and mesh.shape == {"data": 1}
    assert make_data_mesh(4, device="cpu").shape == {"data": 4}
    if not torch.cuda.is_available():
        # nothing falls back to the CPU
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make_data_mesh(2)


@pytest.mark.parametrize("stream", [True, False], ids=["stream", "call"])
def test_sharded_run_has_no_collective_and_one_read(stream):
    """The shards never talk: no collective, and a streamed run reads
    the ORed status once (the per-call loop once per round of calls)."""
    _, tcfg = config_pair(True, num_procs=4)
    arrays = gen_uniform_random_arrays(tcfg, 32, 16, seed=4)
    eng = DataShardedCudaEngine(tcfg, *arrays, data_shards=4, block=8,
                                stream=stream, device="cpu")
    before = COLLECTIVES.snapshot()
    calls = kernels.CALLS.stream_run, kernels.CALLS.call_run
    syncs = kernels.HOST_SYNCS.count
    eng.run()
    assert COLLECTIVES.snapshot() == before
    syncs = kernels.HOST_SYNCS.count - syncs
    if stream:
        assert kernels.CALLS.stream_run - calls[0] == 4
        assert syncs == 1
    else:
        rounds = syncs - eng._n_seg  # a read at each window base
        assert kernels.CALLS.call_run - calls[1] >= rounds > 0
    assert len({id(s["nsw"]) for s in eng._shard_states}) == 4


def _jobs(n, seed):
    jcfg, tcfg = config_pair(True, num_procs=4)
    return (jcfg, tcfg, jsynthetic_jobs(jcfg, n, 24, seed=seed, spread=3.0),
            synthetic_jobs(tcfg, n, 24, seed=seed, spread=3.0))


@pytest.mark.parametrize("overlap", [True, False])
def test_pallas_sharded_serving_matches_jax(overlap):
    jcfg, tcfg, jjobs, tjobs = _jobs(12, 7)
    kw = dict(backend="pallas-sharded", resident=8, window=8, block=2,
              data_shards=2, overlap=overlap)
    jres, jst = jserve(jcfg, JListJobSource(jjobs), interpret=True, **kw)
    tres, tst = serve(tcfg, ListJobSource(tjobs), device="cpu", **kw)
    by_id = {r.job_id: r for r in jres}
    assert sorted(by_id) == sorted(r.job_id for r in tres)
    for r in tres:
        assert dicts(r.dumps) == dicts(by_id[r.job_id].dumps), r.job_id
        assert r.counters == by_id[r.job_id].counters
        assert r.wait_intervals == by_id[r.job_id].wait_intervals
    assert tst.occupancy == jst.occupancy
    assert all(v == 1 for v in tst.compile_counts.values())


def test_sharded_session_protocol():
    """``DataShardedLaneSession``: a lane's state comes from its own
    shard, a permutation that crosses shards is refused, and the
    resident planes keep their storage."""
    _, tcfg = config_pair(True, num_procs=4)
    sess = DataShardedLaneSession(tcfg, 8, 4, data_shards=2, block=2,
                                  device="cpu")
    ptrs = [p.state["nsw"].data_ptr() for p in sess.parts]
    n = tcfg.num_procs
    tr, tl = sess.stage(np.zeros((n, 4, 8), np.int32),
                        np.zeros((n, 8), np.int32))
    sess.check(sess.advance(tr, tl))
    cols = sess.harvest(5)
    assert cols[0] == 1
    assert sess.columns_of(cols)["nsw"].shape[-1] == 1
    with pytest.raises(ValueError, match="across data shards"):
        sess.barrier(np.array([4, 1, 2, 3, 0, 5, 6, 7]), np.zeros(8, bool))
    sess.barrier(np.array([1, 0, 2, 3, 4, 5, 7, 6]), np.zeros(8, bool))
    assert [p.state["nsw"].data_ptr() for p in sess.parts] == ptrs
    assert sess.state["nsw"].shape[-1] == 8
