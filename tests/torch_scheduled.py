"""Shared helpers of the scheduled-run tests: the same ``Schedule`` in
both packages, ``PallasEngine`` and ``CudaEngine`` run side by side."""

import numpy as np

from hpa2_tpu.ops.pallas_engine import PallasEngine
from hpa2_tpu.ops.schedule import Schedule as JSchedule
from hpa2_tpu_torch.convert import state_to_numpy
from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
from hpa2_tpu_torch.ops.schedule import Schedule

#: the small exactness geometry of tests/test_occupancy.py (``_KW``)
KW = dict(block=4, cycles_per_call=32, snapshots=False, trace_window=8,
          gate=True)
#: its larger zipf geometry (``_ZIPF_KW``)
ZIPF_KW = dict(block=8, cycles_per_call=32, snapshots=False,
               trace_window=8, gate=True)


def run_scheduled_pair(jcfg, tcfg, arrays, sched: dict, stream=True, **kw):
    """``PallasEngine`` (interpreted) and ``CudaEngine`` on the CPU with
    the same schedule; asserts that every plane of the system-ordered
    result and ``occupancy.as_dict()`` agree.  Returns the port's
    engine."""
    pe = PallasEngine(jcfg, *arrays, interpret=True, stream=stream,
                      schedule=JSchedule(**sched), **kw).run()
    ce = CudaEngine(tcfg, *arrays, device="cpu", stream=stream,
                    schedule=Schedule(**sched), **kw).run()
    got = state_to_numpy(ce.state)
    assert set(got) == set(pe.state)
    for f in got:
        np.testing.assert_array_equal(got[f], np.asarray(pe.state[f]),
                                      err_msg=f"plane {f!r}")
    assert ce.occupancy.as_dict() == pe.occupancy.as_dict()
    assert ce.stats() == pe.stats()
    return ce


def same_as_unscheduled(tcfg, arrays, ce, **kw):
    """Every dump and the ``scalars`` plane of a scheduled run equal the
    port's unscheduled run's."""
    ref = CudaEngine(tcfg, *arrays, device="cpu", **kw).run()
    for s in range(ref.b):
        assert ce.system_final_dumps(s) == ref.system_final_dumps(s), s
    np.testing.assert_array_equal(ce.state["scalars"].numpy(),
                                  ref.state["scalars"].numpy())
    np.testing.assert_array_equal(ce.state["msg_counts"].numpy(),
                                  ref.state["msg_counts"].numpy())
