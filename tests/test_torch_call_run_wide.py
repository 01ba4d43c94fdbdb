"""The per-call run (``stream=False``) of the port's engine on the CPU
against ``PallasEngine(stream=False)`` in the Pallas interpreter, as in
``test_torch_call_run.py``, for split sharer planes (22 nodes), packed
planes and a stall under a short call budget: every carried plane and
the stall status must agree bit for bit."""

import pytest

from hpa2_tpu.utils.trace import gen_uniform_random_arrays
from torch_pairs import config_pair, dicts, run_both
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def test_split_22_nodes_matches_pallas():
    """Split sharer planes (two sharer words), two windows."""
    jcfg, tcfg = config_pair(True, num_procs=22, cache_size=2, mem_size=4,
                             msg_buffer_size=16)
    arrays = gen_uniform_random_arrays(jcfg, 2, 8, seed=22)
    pe, ce, stall = run_both(jcfg, tcfg, arrays, stream=False, block=1,
                             cycles_per_call=16, snapshots=False,
                             trace_window=4)
    assert stall is None
    assert ce.stats() == pe.stats()


def test_packed_matches_pallas():
    jcfg, tcfg = config_pair(True, num_procs=4, cache_size=4, mem_size=16,
                             msg_buffer_size=16)
    arrays = gen_uniform_random_arrays(jcfg, 4, 12, seed=9)
    pe, ce, stall = run_both(jcfg, tcfg, arrays, stream=False, block=2,
                             cycles_per_call=16, packed=True)
    assert stall is None
    for b in range(4):
        assert dicts(ce.system_final_dumps(b)) == dicts(
            pe.system_final_dumps(b))
        assert dicts(ce.system_snapshots(b)) == dicts(pe.system_snapshots(b))


def test_stall_under_short_budget_matches_pallas():
    """Tiny mailboxes at 8 nodes and a two-call budget: both engines
    raise the same stall, with the same planes mid-flight."""
    jcfg, tcfg = config_pair(True, num_procs=8, msg_buffer_size=4)
    arrays = gen_uniform_random_arrays(jcfg, 4, 16, seed=4)
    pe, ce, stall = run_both(jcfg, tcfg, arrays, max_cycles=64,
                             stream=False, block=2, cycles_per_call=32,
                             snapshots=False, trace_window=8)
    assert stall is not None and "no quiescence" in stall
