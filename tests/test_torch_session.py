"""The port's resident-lane session (``CudaLaneSession`` on the CPU,
the kernels' plain versions) against ``PallasLaneSession`` in the
Pallas interpreter, both driven through the same sequence of the
port's ``LaneScheduler``: stage, advance, harvest the finished lanes,
barrier, check.

Each harvested system's ``dumps_of`` and ``counters_of`` must be equal
between the sessions and equal to the port's one-shot run; the resident
planes must keep their storage across intervals (they are updated in
place), and every entry of ``compile_counts()`` must be 1."""

import numpy as np
import pytest

from hpa2_tpu.ops.pallas_engine import PallasLaneSession
from hpa2_tpu_torch.ops.cuda_engine import CudaEngine, interval_windows
from hpa2_tpu_torch.ops.layout import StallError, _pack_traces
from hpa2_tpu_torch.ops.schedule import LaneScheduler, segments_needed
from hpa2_tpu_torch.ops.session import CudaLaneSession
from hpa2_tpu_torch.utils.trace import gen_heterogeneous_random_arrays
from torch_pairs import IGNORE_PLTPU_ANY, config_pair, dicts

pytestmark = pytest.mark.filterwarnings(IGNORE_PLTPU_ANY)

W, R, BLOCK, K = 8, 8, 4, 32


@pytest.fixture(scope="module")
def workload():
    jcfg, tcfg = config_pair(True, num_procs=4)
    arrays = gen_heterogeneous_random_arrays(tcfg, 20, 32, dist="zipf",
                                             spread=4.0, seed=3)
    t = arrays[0].shape[2]
    tr = _pack_traces(tcfg, *arrays)
    tr = np.pad(tr, ((0, 0), (0, -(-t // W) * W - t), (0, 0)))
    tl = np.ascontiguousarray(arrays[3].T)
    return jcfg, tcfg, arrays, tr, tl


def drive(session, tr, tl):
    """One batch through ``session`` under a fresh scheduler; returns
    {system: harvested columns}, the scheduler, and the resident
    planes' storage after each interval."""
    sched = LaneScheduler(segments_needed(tl, W), resident=R, block=BLOCK,
                          threshold=0.5)
    out, ptrs = {}, []
    while not sched.done():
        live = sched.begin_interval()
        tr_i, tl_i = interval_windows(tr, tl, sched.lane_sys, sched.lane_seg,
                                      live, W)
        status = session.advance(*session.stage(tr_i, tl_i))
        plan = sched.end_interval()
        for lane, s in plan.finished:
            out[s] = session.harvest(lane)
        if not plan.trivial:
            perm = plan.perm if plan.perm is not None else np.arange(R)
            reset = np.zeros(R, bool)
            reset[[lane for lane, _ in plan.admitted]] = True
            session.barrier(perm, reset)
        session.check(status)
        if hasattr(session.state["nsw"], "data_ptr"):
            ptrs.append({f: v.data_ptr() for f, v in session.state.items()})
    return out, sched, ptrs


@pytest.mark.parametrize("stream", [True, False])
def test_session_matches_pallas_session(workload, stream):
    jcfg, tcfg, arrays, tr, tl = workload
    kw = dict(block=BLOCK, cycles_per_call=K, stream=stream)
    port = CudaLaneSession(tcfg, R, W, device="cpu", **kw)
    jax_s = PallasLaneSession(jcfg, R, W, interpret=True, **kw)
    got, sched, ptrs = drive(port, tr, tl)
    want, jsched, _ = drive(jax_s, tr, tl)
    assert sorted(got) == sorted(want) == list(range(20))
    assert sched.stats.as_dict() == jsched.stats.as_dict()
    one_shot = CudaEngine(tcfg, *arrays, block=BLOCK, cycles_per_call=K,
                          snapshots=False, trace_window=W,
                          device="cpu").run()
    for s in range(20):
        assert dicts(port.dumps_of(got[s])) == dicts(
            jax_s.dumps_of(want[s])), s
        assert port.dumps_of(got[s]) == one_shot.system_final_dumps(s), s
        assert port.counters_of(got[s]) == jax_s.counters_of(want[s]), s
    assert len(ptrs) > 2 and all(p == ptrs[0] for p in ptrs)
    assert port.compile_counts() == {"runner": 1, "barrier": 1,
                                     "take_lane": 1}


def test_session_check_raises_like_the_engine(workload):
    _, tcfg, _, tr, tl = workload
    port = CudaLaneSession(tcfg, R, W, block=BLOCK, cycles_per_call=K,
                           max_cycles=8, device="cpu")
    sched = LaneScheduler(segments_needed(tl, W), resident=R, block=BLOCK)
    live = sched.begin_interval()
    status = port.advance(*port.stage(*interval_windows(
        tr, tl, sched.lane_sys, sched.lane_seg, live, W)))
    with pytest.raises(StallError, match="no quiescence within ~8 cycles"):
        port.check(status)
