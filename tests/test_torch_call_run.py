"""The per-call run (``stream=False``) on the port's engine on the CPU,
which runs the per-call kernel's plain version under its host loop
(``ops/call_run.py``), against ``hpa2_tpu.ops.pallas_engine.PallasEngine``
with ``stream=False`` in the Pallas interpreter (the TPU kernel K3,
``_build_call``, and its host loop ``_make_run``).

Every carried plane (snapshots included), the stall status, the
counters and the dumps must agree bit for bit; tolerance zero, since
all state is integer.  The port's ``stream=False`` run must also equal
its ``stream=True`` run on a clean run, calls after quiescence must
change no plane, and the host loop's reads are counted.  Split
sharer planes, packed planes and a stall are in
``test_torch_call_run_wide.py``."""

import numpy as np
import pytest
import torch

from hpa2_tpu.models.spec_engine import SpecEngine
from hpa2_tpu.utils.trace import gen_uniform_random_arrays
from hpa2_tpu_torch.convert import state_to_numpy
from hpa2_tpu_torch.ops import kernels
from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
from torch_pairs import (
    config_pair, dicts, run_both, spec_on_windows, traces_of,
)


@pytest.mark.parametrize("gate", [True, False])
def test_four_nodes_snapshots_match_pallas_and_spec(gate):
    jcfg, tcfg = config_pair(True, num_procs=4, msg_buffer_size=16)
    arrays = gen_uniform_random_arrays(jcfg, 4, 16, seed=5)
    pe, ce, stall = run_both(jcfg, tcfg, arrays, stream=False, block=2,
                             cycles_per_call=16, gate=gate)
    assert stall is None
    assert ce.stats() == pe.stats()
    for b in range(4):
        spec = SpecEngine(jcfg, traces_of(*arrays, b, 4))
        spec.run()
        assert dicts(ce.system_final_dumps(b)) == dicts(spec.final_dumps())
        assert dicts(ce.system_snapshots(b)) == dicts(spec.snapshots())


@pytest.mark.parametrize(
    "w,t,gate",
    [
        (7, 20, False),   # the window does not divide the trace length
        (1, 6, True),     # one-instruction windows
        (8, 40, True),    # many exact windows
    ],
)
def test_ragged_windows_match_pallas_and_spec(w, t, gate):
    """The windowed shapes of ``test_stream_windowed_edges_bitexact``."""
    jcfg, tcfg = config_pair(True, num_procs=8, msg_buffer_size=16)
    arrays = gen_uniform_random_arrays(jcfg, 4, t, seed=20 + w)
    pe, ce, stall = run_both(jcfg, tcfg, arrays, max_cycles=400_000,
                             stream=False, block=2, cycles_per_call=32,
                             snapshots=False, trace_window=w, gate=gate)
    assert stall is None
    for b in range(4):
        spec = spec_on_windows(jcfg, arrays, b, 8, w, t)
        assert dicts(ce.system_final_dumps(b)) == dicts(spec.final_dumps())


@pytest.mark.parametrize("snapshots", [True, False])
def test_per_call_run_equals_streamed_run(snapshots):
    _, tcfg = config_pair(True, num_procs=8, msg_buffer_size=16)
    arrays = gen_uniform_random_arrays(tcfg, 8, 16, seed=31)
    window = None if snapshots else 6
    kw = dict(block=4, cycles_per_call=16, snapshots=snapshots,
              trace_window=window, device="cpu")
    per_call = CudaEngine(tcfg, *arrays, stream=False, **kw).run()
    streamed = CudaEngine(tcfg, *arrays, stream=True, **kw).run()
    a, b = state_to_numpy(per_call.state), state_to_numpy(streamed.state)
    assert set(a) == set(b)
    for f in a:
        np.testing.assert_array_equal(a[f], b[f], err_msg=f)


@pytest.mark.parametrize("gate", [True, False])
def test_calls_after_quiescence_change_nothing(gate):
    _, tcfg = config_pair(True, num_procs=4, msg_buffer_size=16)
    arrays = gen_uniform_random_arrays(tcfg, 4, 12, seed=8)
    eng = CudaEngine(tcfg, *arrays, block=2, cycles_per_call=16,
                     stream=False, gate=gate, device="cpu").run()
    before = {f: v.clone() for f, v in eng.state.items()}
    for _ in range(2):
        kernels.call_run(tcfg, eng.state, eng._tr_full, eng._tr_len_full,
                         seg=0, block=2, k=16, window=12, gate=gate,
                         snapshots=True)
    for f, v in before.items():
        assert torch.equal(eng.state[f], v), f


def test_host_reads_are_counted(monkeypatch):
    """One read at each window base and after each call, and one for
    the status word; the plain run makes no launch."""
    _, tcfg = config_pair(True, num_procs=4, msg_buffer_size=16)
    arrays = gen_uniform_random_arrays(tcfg, 4, 12, seed=2)
    calls = []
    real = kernels.call_run

    def counted(*a, **kw):
        calls.append(kw["seg"])
        return real(*a, **kw)

    monkeypatch.setattr(kernels, "call_run", counted)
    syncs, launches = kernels.HOST_SYNCS.count, kernels.CALL_RUN.launches
    CudaEngine(tcfg, *arrays, block=2, cycles_per_call=8, stream=False,
               snapshots=False, trace_window=4, device="cpu").run()
    assert sorted(set(calls)) == [0, 1, 2]
    assert kernels.HOST_SYNCS.count - syncs == 3 + len(calls) + 1
    assert kernels.CALL_RUN.launches == launches
