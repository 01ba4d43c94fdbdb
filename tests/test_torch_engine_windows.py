"""The port's engine on windowed traces, with the quiescence gate both
ways, against ``PallasEngine`` (interpreted, streamed) plane by plane
and against the spec engine run on the same window schedule."""

import pytest

from hpa2_tpu.utils.trace import gen_uniform_random_arrays
from torch_pairs import (
    IGNORE_PLTPU_ANY, config_pair, dicts, run_both, spec_on_windows,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings(IGNORE_PLTPU_ANY)


@pytest.mark.parametrize(
    "w,t,gate",
    [
        (7, 20, False),   # the window does not divide the trace
        (1, 6, True),     # one-instruction windows
        (20, 20, False),  # one window spanning the trace
        (8, 24, True),    # several exact windows, gate on
    ],
)
def test_windowed_edges(w, t, gate):
    jcfg, tcfg = config_pair(True, num_procs=8, msg_buffer_size=16)
    arrays = gen_uniform_random_arrays(jcfg, 2, t, seed=20 + w)
    _, ce, stall = run_both(jcfg, tcfg, arrays, max_cycles=400_000, block=1,
                            cycles_per_call=32, snapshots=False,
                            trace_window=w, gate=gate)
    assert stall is None
    for b in range(2):
        spec = spec_on_windows(jcfg, arrays, b, 8, w, t)
        assert dicts(ce.system_final_dumps(b)) == dicts(
            spec.final_dumps()), f"b={b}"
