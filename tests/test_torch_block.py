"""Lane blocks above 1,024 lanes on the CPU: the plain versions take any
block that divides the lanes, as ``PallasEngine`` does, and only the
card bounds it (``kernels.MAX_LANE_BLOCK``, by node bound).  A block of
2,048 decides the gate, the shared call budget and the stall status
for 2,048 systems at once, so it must be reproduced, not replaced by a
smaller one."""

import numpy as np
import pytest

from hpa2_tpu.ops.pallas_engine import PallasEngine
from hpa2_tpu_torch.ops import kernels
from hpa2_tpu_torch.ops.cuda_engine import fast_path_setup, interval_windows
from hpa2_tpu_torch.ops.layout import (
    _SC_CYCLE, _SC_INSTR, _SC_MSGS, _pack_traces,
)
from hpa2_tpu_torch.ops.schedule import LaneScheduler, segments_needed
from hpa2_tpu_torch.ops.session import CudaLaneSession
from hpa2_tpu_torch.utils.trace import (
    gen_heterogeneous_random_arrays, gen_uniform_random_arrays,
)
from torch_pairs import IGNORE_PLTPU_ANY, config_pair, dicts, run_both

BLOCK = 2048


@pytest.mark.filterwarnings(IGNORE_PLTPU_ANY)
def test_engine_block_2048_matches_pallas():
    """Two lane blocks of 2,048 through ``CudaEngine(device="cpu")`` and
    the interpreted ``PallasEngine``: every plane, the snapshots' dumps
    and the final dumps equal."""
    jcfg, tcfg = config_pair(True, num_procs=4, msg_buffer_size=16)
    arrays = gen_uniform_random_arrays(tcfg, 2 * BLOCK, 6, seed=21)
    pe, ce, stall = run_both(jcfg, tcfg, arrays, block=BLOCK,
                             cycles_per_call=64)
    assert stall is None and ce.block == pe.block == BLOCK
    for s in (0, BLOCK - 1, BLOCK, 2 * BLOCK - 1):
        assert dicts(ce.system_snapshots(s)) == dicts(pe.system_snapshots(s))
        assert dicts(ce.system_final_dumps(s)) == dicts(
            pe.system_final_dumps(s))
    assert ce.instructions == int(arrays[3].sum())


@pytest.mark.filterwarnings(IGNORE_PLTPU_ANY)
def test_session_block_2048_matches_one_shot():
    """A resident session of 2,048 lanes in one lane block, driven by
    the scheduler over 4,096 zipf systems: every harvested system's
    dumps and counters equal the interpreted ``PallasEngine``'s one-shot
    run of the same systems at the same block of 2,048."""
    jcfg, cfg = config_pair(True, num_procs=4, msg_buffer_size=16)
    w, b = 8, 2 * BLOCK
    arrays = gen_heterogeneous_random_arrays(cfg, b, 16, dist="zipf",
                                             spread=2.0, seed=5)
    tr = _pack_traces(cfg, *arrays)
    tr = np.pad(tr, ((0, 0), (0, -(-tr.shape[1] // w) * w - tr.shape[1]),
                     (0, 0)))
    tl = np.ascontiguousarray(arrays[3].T)
    sess = CudaLaneSession(cfg, BLOCK, w, block=BLOCK, device="cpu")
    assert sess.block == BLOCK
    sched = LaneScheduler(segments_needed(tl, w), resident=BLOCK,
                          block=BLOCK)
    got, pending = {}, None
    while not sched.done():
        live = sched.begin_interval()
        status = sess.advance(*sess.stage(*interval_windows(
            tr, tl, sched.lane_sys, sched.lane_seg, live, w)))
        plan = sched.end_interval()
        for lane, s in plan.finished:
            got[s] = sess.harvest(lane)
        if not plan.trivial:
            perm = plan.perm if plan.perm is not None else np.arange(BLOCK)
            reset = np.zeros(BLOCK, bool)
            reset[[lane for lane, _ in plan.admitted]] = True
            sess.barrier(perm, reset)
        if pending is not None:
            sess.check(pending)
        pending = status
    sess.check(pending)
    assert sched.stats.admissions == b - BLOCK
    one_shot = PallasEngine(jcfg, *arrays, block=BLOCK, snapshots=False,
                            trace_window=w, interpret=True)
    one_shot.run()
    assert one_shot.block == BLOCK
    assert sorted(got) == list(range(b))
    sc = np.asarray(one_shot.state["scalars"])
    for s in range(b):
        assert dicts(sess.dumps_of(got[s])) == dicts(
            one_shot.system_final_dumps(s)), s
        assert sess.counters_of(got[s]) == {
            "instructions": sc[_SC_INSTR, s], "cycles": sc[_SC_CYCLE, s],
            "messages": sc[_SC_MSGS, s]}, s
    assert set(sess.compile_counts().values()) == {1}


def test_card_block_bound_is_per_node_bound():
    """The card's bound follows the node bound; the CPU has none."""
    _, cfg8 = config_pair(True, num_procs=8, msg_buffer_size=16)
    _, cfg64 = config_pair(True, num_procs=64, cache_size=2, mem_size=4,
                           msg_buffer_size=16)
    for cfg, bound in ((cfg8, 8), (cfg64, 64)):
        most = kernels.MAX_LANE_BLOCK[bound]
        assert kernels.node_bound(cfg) == bound and most > 1024
        kernels.check_block(cfg, most)
        with pytest.raises(ValueError, match="device='cpu'"):
            kernels.check_block(cfg, most + 1)
        lanes = 2 * (most + 1)
        assert fast_path_setup(cfg, lanes=lanes, block=most + 1,
                               packed=False, device="cpu")[1] == most + 1
