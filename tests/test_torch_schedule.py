"""The port's copy of the occupancy scheduler (``hpa2_tpu_torch/ops/
schedule.py``, numpy only) against ``hpa2_tpu/ops/schedule.py`` on random
segment-count vectors, for all four admission policies: the policy
order, every barrier plan of a step-by-step replay, the fused plan's
rows, the static model and ``OccupancyStats.as_dict()`` must be equal.
Also the heterogeneous workload generators of both packages."""

import numpy as np
import pytest

from hpa2_tpu.config import SystemConfig as JSystemConfig
from hpa2_tpu.ops import schedule as js
from hpa2_tpu.utils import trace as jtrace
from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.ops import schedule as ts
from hpa2_tpu_torch.utils import trace as ttrace


def _workload(seed, b):
    rng = np.random.default_rng(seed)
    nseg = rng.integers(1, 9, size=b)
    deadline = np.where(rng.random(b) < 0.7, rng.integers(0, 12, size=b), -1)
    tenant = rng.integers(0, 3, size=b)
    return nseg, tuple(int(x) for x in deadline), \
        tuple(int(x) for x in tenant)


def _kw(policy, resident, block, seed, b, threshold=0.5):
    nseg, deadline, tenant = _workload(seed, b)
    return nseg, dict(resident=resident, block=block, threshold=threshold,
                      policy=policy, deadline=deadline, tenant=tenant,
                      tenant_weights=(1.0, 2.0, 0.5))


CASES = [(policy, resident, block, seed)
         for policy in ts.POLICIES
         for resident, block, seed in ((None, 4, 0), (8, 4, 1), (16, 2, 2),
                                       (12, 3, 3))]


def test_the_copy_has_the_same_names():
    for name in ("Schedule", "POLICIES", "policy_order", "OccupancyStats",
                 "BarrierPlan", "lockstep_block_segments", "LaneScheduler",
                 "simulate", "SchedulePlan", "build_plan",
                 "segments_needed"):
        assert hasattr(ts, name), name
    assert ts.POLICIES == js.POLICIES
    assert ts.Schedule() == ts.Schedule(resident=None, threshold=0.5,
                                        interval=256, fused=True,
                                        policy="fcfs")
    assert {f.name for f in ts.Schedule.__dataclass_fields__.values()} == \
        {f.name for f in js.Schedule.__dataclass_fields__.values()}


@pytest.mark.parametrize("policy", ts.POLICIES)
@pytest.mark.parametrize("seed", range(4))
def test_policy_order_matches(policy, seed):
    nseg, deadline, tenant = _workload(seed, 40)
    kw = dict(deadline=np.array(deadline), tenant=np.array(tenant),
              weights={0: 1.0, 1: 3.0})
    np.testing.assert_array_equal(ts.policy_order(nseg, policy, **kw),
                                  js.policy_order(nseg, policy, **kw))


@pytest.mark.parametrize("policy,resident,block,seed", CASES)
def test_replay_and_plan_match(policy, resident, block, seed):
    nseg, kw = _kw(policy, resident, block, seed, b=48)
    scheds = (ts.LaneScheduler(nseg, **kw), js.LaneScheduler(nseg, **kw))
    while not scheds[1].done():
        assert not scheds[0].done()
        lives = [s.begin_interval() for s in scheds]
        np.testing.assert_array_equal(*lives)
        plans = [s.end_interval() for s in scheds]
        assert plans[0].finished == plans[1].finished
        assert plans[0].admitted == plans[1].admitted
        assert plans[0].trivial == plans[1].trivial
        if plans[1].perm is None:
            assert plans[0].perm is None
        else:
            np.testing.assert_array_equal(plans[0].perm, plans[1].perm)
        for a in ("lane_sys", "lane_seg"):
            np.testing.assert_array_equal(getattr(scheds[0], a),
                                          getattr(scheds[1], a))
    assert scheds[0].done()
    for fused in (True, False):
        assert scheds[0].stats.set_mode(fused).as_dict() == \
            scheds[1].stats.set_mode(fused).as_dict()
        assert ts.simulate(nseg, fused=fused, **kw).as_dict() == \
            js.simulate(nseg, fused=fused, **kw).as_dict()
    tp, jp = ts.build_plan(nseg, **kw), js.build_plan(nseg, **kw)
    for row in ("sys", "seg", "perm", "reset"):
        np.testing.assert_array_equal(getattr(tp, row), getattr(jp, row),
                                      err_msg=row)
        assert getattr(tp, row).dtype == getattr(jp, row).dtype
    assert (tp.n_intervals, tp.resident) == (jp.n_intervals, jp.resident)
    assert tp.stats.as_dict() == jp.stats.as_dict()
    assert ts.lockstep_block_segments(nseg, block) == \
        js.lockstep_block_segments(nseg, block)


@pytest.mark.parametrize("policy", ts.POLICIES)
def test_serving_scheduler_matches(policy):
    """The serving form: jobs arrive over time through ``extend`` and
    are admitted at barriers or by ``flush_admissions``."""
    rng = np.random.default_rng(7)
    kw = dict(block=2, threshold=0.75, policy=policy,
              tenant_weights={0: 1.0, 1: 2.0})
    scheds = (ts.LaneScheduler.serving(8, **kw),
              js.LaneScheduler.serving(8, **kw))
    for step in range(12):
        if step % 3 == 0:
            n = int(rng.integers(1, 6))
            nseg = rng.integers(1, 5, size=n)
            dl = rng.integers(-1, 6, size=n)
            tn = rng.integers(0, 2, size=n)
            ids = [s.extend(nseg, deadline=dl, tenant=tn) for s in scheds]
            np.testing.assert_array_equal(*ids)
        if not scheds[1].live().any():
            plans = [s.flush_admissions() for s in scheds]
        else:
            for s in scheds:
                s.begin_interval()
            plans = [s.end_interval() for s in scheds]
        assert plans[0].finished == plans[1].finished
        assert plans[0].admitted == plans[1].admitted
        np.testing.assert_array_equal(scheds[0].lane_sys, scheds[1].lane_sys)
    assert scheds[0].stats.as_dict() == scheds[1].stats.as_dict()


def test_segments_needed_matches():
    tl = np.random.default_rng(3).integers(0, 50, size=(4, 30))
    for w in (1, 7, 8, 64):
        np.testing.assert_array_equal(ts.segments_needed(tl, w),
                                      js.segments_needed(tl, w))


@pytest.mark.parametrize("dist", ["zipf", "uniform"])
@pytest.mark.parametrize("spread", [1.0, 4.0, 8.0])
def test_heterogeneous_generators_match(dist, spread):
    np.testing.assert_array_equal(
        ttrace.heterogeneous_lengths(64, 32, dist, spread, seed=5),
        jtrace.heterogeneous_lengths(64, 32, dist, spread, seed=5))
    got = ttrace.gen_heterogeneous_random_arrays(
        SystemConfig(num_procs=4), 16, 24, dist, spread, seed=2)
    want = jtrace.gen_heterogeneous_random_arrays(
        JSystemConfig(num_procs=4), 16, 24, dist, spread, seed=2)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def test_heterogeneous_lengths_refuse_bad_arguments():
    with pytest.raises(ValueError):
        ttrace.heterogeneous_lengths(0, 8)
    with pytest.raises(ValueError):
        ttrace.heterogeneous_lengths(8, 8, spread=0.5)
    with pytest.raises(ValueError):
        ttrace.heterogeneous_lengths(8, 8, dist="pareto")
