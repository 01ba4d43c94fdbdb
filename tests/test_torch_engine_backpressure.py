"""The port's engine at 8 nodes, with roomy and with tiny mailboxes
(deferred sends and backpressure), against ``PallasEngine``
(interpreted, streamed) plane by plane and against the spec engine."""

import pytest

from hpa2_tpu.models.spec_engine import SpecEngine
from hpa2_tpu.utils.trace import gen_uniform_random_arrays
from torch_pairs import (
    IGNORE_PLTPU_ANY, config_pair, dicts, run_both, traces_of,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings(IGNORE_PLTPU_ANY)


@pytest.mark.parametrize(
    "cap,batch,block,t,seed",
    [
        (64, 6, 3, 12, 1),   # two lane blocks
        (4, 2, 2, 24, 0),    # tiny mailboxes: sends defer, senders block
    ],
)
def test_eight_nodes_match_pallas_and_spec(cap, batch, block, t, seed):
    jcfg, tcfg = config_pair(True, num_procs=8, msg_buffer_size=cap)
    arrays = gen_uniform_random_arrays(jcfg, batch, t, seed=seed)
    pe, ce, stall = run_both(jcfg, tcfg, arrays, max_cycles=100_000,
                             block=block, cycles_per_call=32)
    assert stall is None
    assert ce.instructions == batch * 8 * t
    assert ce.stats() == pe.stats()
    for b in range(batch):
        spec = SpecEngine(jcfg, traces_of(*arrays, b, 8))
        spec.run()
        assert dicts(ce.system_final_dumps(b)) == dicts(spec.final_dumps())
