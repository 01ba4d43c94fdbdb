"""The occupancy scheduler on the port's engine on the CPU against
``PallasEngine(schedule=...)`` in the Pallas interpreter, as in
``test_torch_scheduled.py``, with the per-call run (``stream=False``,
the TPU kernel K3) as the interval runner, with packed planes, and with
split sharer planes (22 nodes).  Every plane of the system-ordered
result and ``occupancy.as_dict()`` must be equal, and the dumps and
``scalars`` must equal the port's unscheduled run."""

import pytest

from hpa2_tpu_torch.ops import kernels
from hpa2_tpu_torch.utils.trace import gen_heterogeneous_random_arrays
from torch_pairs import IGNORE_PLTPU_ANY, config_pair
from torch_scheduled import KW, run_scheduled_pair, same_as_unscheduled
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings(IGNORE_PLTPU_ANY)


@pytest.fixture(scope="module")
def small():
    """(jcfg, tcfg, arrays) of the small zipf geometry of
    ``tests/test_occupancy.py``."""
    jcfg, tcfg = config_pair(True, num_procs=4)
    arrays = gen_heterogeneous_random_arrays(tcfg, 24, 32, dist="zipf",
                                             spread=4.0, seed=1)
    return jcfg, tcfg, arrays


@pytest.mark.parametrize("fused", [True, False])
def test_scheduled_per_call_matches_pallas(small, fused, monkeypatch):
    """``stream=False``: the per-call kernel runs each interval; beside
    the final status read (fused) or one read an interval (host
    barriers), the only host reads are the per-call host loop's, one at
    each interval's window base and one after each call."""
    jcfg, tcfg, arrays = small
    calls = []
    real = kernels.call_run

    def counted(*a, **kw):
        calls.append(kw["seg"])
        return real(*a, **kw)

    monkeypatch.setattr(kernels, "call_run", counted)
    syncs = kernels.HOST_SYNCS.count
    ce = run_scheduled_pair(jcfg, tcfg, arrays,
                            dict(resident=8, fused=fused), stream=False,
                            **KW)
    occ = ce.occupancy.as_dict()
    barrier_reads = 1 if fused else occ["intervals"]
    assert set(calls) == {0}
    assert kernels.HOST_SYNCS.count - syncs == \
        barrier_reads + occ["intervals"] + len(calls)
    same_as_unscheduled(tcfg, arrays, ce, **KW)


def test_scheduled_packed_matches_pallas(small):
    jcfg, tcfg, arrays = small
    kw = dict(KW, packed=True)
    ce = run_scheduled_pair(jcfg, tcfg, arrays, dict(resident=8), **kw)
    same_as_unscheduled(tcfg, arrays, ce, **kw)


def test_scheduled_split_22_nodes_matches_pallas():
    jcfg, tcfg = config_pair(True, num_procs=22, cache_size=2, mem_size=4,
                             msg_buffer_size=16)
    arrays = gen_heterogeneous_random_arrays(tcfg, 8, 12, dist="zipf",
                                             spread=3.0, seed=4)
    kw = dict(block=2, cycles_per_call=16, snapshots=False, trace_window=4,
              gate=True)
    ce = run_scheduled_pair(jcfg, tcfg, arrays, dict(resident=4), **kw)
    assert ce.occupancy.admissions == 8 - 4
    same_as_unscheduled(tcfg, arrays, ce, **kw)
