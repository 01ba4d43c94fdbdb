"""The occupancy scheduler on the port's engine on the CPU
(``CudaEngine(schedule=...)``, the kernels' plain versions) against
``PallasEngine(schedule=...)`` in the Pallas interpreter, at the small
zipf geometry of ``tests/test_occupancy.py`` (``_KW``: 4 nodes, block 4,
window 8, 24 systems of 8-32 instructions): fused and host-barrier
runs, a resident set smaller than the ensemble and the admission
policies, and at its 8x-zipf geometry (``_ZIPF_KW``).

Every carried plane of the system-ordered result (so every dump, the
``scalars`` plane and ``msg_counts``) and ``occupancy.as_dict()`` must
be equal, and the dumps and ``scalars`` must equal the port's
unscheduled run.  The fused streamed run reads the device once.  The
per-call run (``stream=False``) as the interval runner, packed planes
and split sharer planes are in ``test_torch_scheduled_wide.py``."""

import pytest

from hpa2_tpu.ops.schedule import Schedule as JSchedule
from hpa2_tpu_torch.ops import kernels
from hpa2_tpu_torch.ops.schedule import Schedule
from hpa2_tpu_torch.utils.trace import gen_heterogeneous_random_arrays
from torch_pairs import IGNORE_PLTPU_ANY, config_pair
from torch_scheduled import (
    KW, ZIPF_KW, run_scheduled_pair, same_as_unscheduled,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings(IGNORE_PLTPU_ANY)


@pytest.fixture(scope="module")
def small():
    """(jcfg, tcfg, arrays) of the shared small zipf geometry."""
    jcfg, tcfg = config_pair(True, num_procs=4)
    arrays = gen_heterogeneous_random_arrays(tcfg, 24, 32, dist="zipf",
                                             spread=4.0, seed=1)
    return jcfg, tcfg, arrays


@pytest.mark.parametrize(
    "sched",
    [
        dict(),
        dict(fused=False),
        dict(resident=8),
        dict(resident=8, fused=False),
        dict(resident=8, policy="longest-first"),
        dict(resident=8, policy="fair-drr", tenants=(0, 1, 2) * 8,
             tenant_weights=(1.0, 2.0, 1.0)),
    ],
    ids=["fused", "host-barriers", "resident8", "resident8-host-barriers",
         "longest-first", "fair-drr"],
)
def test_scheduled_matches_pallas(small, sched):
    jcfg, tcfg, arrays = small
    syncs = kernels.HOST_SYNCS.count
    ce = run_scheduled_pair(jcfg, tcfg, arrays, sched, **KW)
    occ = ce.occupancy.as_dict()
    if sched.get("fused", True):
        assert kernels.HOST_SYNCS.count - syncs == 1
        assert occ["host_barriers"] == 0 and occ["device_programs"] == 1
    else:
        assert occ["host_barriers"] == occ["intervals"] > 1
        assert kernels.HOST_SYNCS.count - syncs == occ["intervals"]
    if sched.get("resident"):
        assert occ["admissions"] == 24 - 8
    same_as_unscheduled(tcfg, arrays, ce, **KW)


def test_zipf_geometry_matches_pallas():
    """The 8x-zipf geometry (40 systems in 5 blocks of 8): the scheduled
    run does at least 2x fewer block-segments than lockstep."""
    jcfg, tcfg = config_pair(True, num_procs=4)
    arrays = gen_heterogeneous_random_arrays(tcfg, 40, 64, dist="zipf",
                                             spread=8.0, seed=2)
    ce = run_scheduled_pair(jcfg, tcfg, arrays, dict(), **ZIPF_KW)
    occ = ce.occupancy
    assert occ.block_segments * 2 <= occ.lockstep_block_segments
    assert occ.compactions > 0
    same_as_unscheduled(tcfg, arrays, ce, **ZIPF_KW)


def test_schedule_refuses_snapshots_and_bad_resident(small):
    from hpa2_tpu_torch.ops.cuda_engine import CudaEngine

    _, tcfg, arrays = small
    kw = dict(KW, device="cpu")
    with pytest.raises(ValueError, match="snapshots=False"):
        CudaEngine(tcfg, *arrays, schedule=Schedule(),
                   **dict(kw, snapshots=True))
    for resident in (25, -1):
        with pytest.raises(ValueError, match="outside 1..24"):
            CudaEngine(tcfg, *arrays, schedule=Schedule(resident=resident),
                       **kw)
    JSchedule()  # the JAX knob is a separate class with the same fields
