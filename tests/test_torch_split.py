"""Wide systems (``num_procs > 21``: split sharer planes ``dirs{w}`` and
``shr{w}`` message fields) on the port's engine on the CPU, which runs
the kernel's plain version, against
``hpa2_tpu.ops.pallas_engine.PallasEngine`` with ``stream=True`` in the
Pallas interpreter and against the spec engine.

22 nodes has one sharer word (SW=1), 33 nodes two and 64 nodes three;
the 64-node interpreted JAX run is slow, so that geometry is held
against the spec engine's dumps only.  Every carried plane, the stall
status, the counters and the dumps must agree bit for bit."""

import numpy as np
import pytest

from hpa2_tpu.models.spec_engine import SpecEngine
from hpa2_tpu.ops import pallas_engine as jpe
from hpa2_tpu.utils.trace import gen_uniform_random_arrays
from hpa2_tpu_torch.convert import state_from_numpy
from hpa2_tpu_torch.ops import layout
from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
from torch_pairs import (
    IGNORE_PLTPU_ANY, config_pair, dicts, run_both, spec_on_windows,
    traces_of,
)

pytestmark = pytest.mark.filterwarnings(IGNORE_PLTPU_ANY)


@pytest.mark.parametrize("n,c,m,cap", [(22, 2, 4, 16), (33, 4, 8, 32),
                                       (62, 2, 4, 16), (64, 2, 4, 16)])
def test_split_layout_matches(n, c, m, cap):
    jcfg, tcfg = config_pair(True, num_procs=n, cache_size=c, mem_size=m,
                             msg_buffer_size=cap)
    assert layout._mb_layout(tcfg) == jpe._mb_layout(jcfg)
    assert layout._sharer_words(tcfg) == jpe._sharer_words(jcfg)
    for snapshots in (False, True):
        assert layout.state_shapes(tcfg, snapshots) == jpe.state_shapes(
            jcfg, snapshots)
        assert layout.fields_of(tcfg, snapshots) == jpe._state_fields(
            jpe._mb_layout(jcfg)[1], snapshots,
            "recv" in jpe._mb_layout(jcfg)[0], jpe._sharer_words(jcfg),
            False)
        got = layout._init_state(tcfg, 2, snapshots)
        want = jpe._init_state(jcfg, 2, snapshots)
        assert set(got) == set(want)
        for f in want:
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@pytest.mark.parametrize("n", [22, 33, 64])
def test_split_deferred_valid_and_dumps(n):
    jcfg, tcfg = config_pair(True, num_procs=n, cache_size=2, mem_size=4,
                             msg_buffer_size=16)
    lay, W = jpe._mb_layout(jcfg)
    rng = np.random.default_rng(n)
    st = {f"ob{w}": rng.integers(0, 1 << 31, (n, 5, 3), dtype=np.int32)
          for w in range(W)}
    if "recv" not in lay:
        st["ob_recv"] = rng.integers(-1, n, (n, 5, 3), dtype=np.int32)
    # empty INV slots: every shr{w} field zero
    for w in range(W):
        st[f"ob{w}"][:, 2, 0] = 0
    got = layout.deferred_valid(tcfg, state_from_numpy(st, "cpu"))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpe.deferred_valid(jcfg, st)))

    sw = layout._sharer_words(tcfg)
    cachew = rng.integers(0, 1 << 20, (n, 2, 3), dtype=np.int32)
    dirw = rng.integers(0, 1 << 10, (n, 4, 3), dtype=np.int32)
    dirs = [rng.integers(0, 1 << 31, (n, 4, 3), dtype=np.int32)
            for _ in range(sw)]
    for s in range(3):
        assert dicts(layout.decode_dumps(tcfg, cachew, dirw, s, dirs)) == \
            dicts(jpe.decode_dumps(jcfg, cachew, dirw, s, dirs))


def test_windowed_22_nodes_matches_pallas_and_spec():
    """One sharer word in its own plane, with a ragged last window
    (``tests/test_pallas_engine.py``'s 22-node geometry)."""
    jcfg, tcfg = config_pair(True, num_procs=22, cache_size=2, mem_size=4,
                             msg_buffer_size=16)
    arrays = gen_uniform_random_arrays(jcfg, 2, 12, seed=4)
    pe, ce, stall = run_both(jcfg, tcfg, arrays, max_cycles=400_000,
                             block=2, cycles_per_call=32, snapshots=False,
                             trace_window=5, gate=False)
    assert stall is None
    assert "dirs0" in ce.state and "dirs1" not in ce.state
    assert ce.stats() == pe.stats()
    for b in range(2):
        spec = spec_on_windows(jcfg, arrays, b, 22, 5, 12)
        assert dicts(ce.system_final_dumps(b)) == dicts(spec.final_dumps())
        assert dicts(ce.system_final_dumps(b)) == dicts(
            pe.system_final_dumps(b))


def test_33_nodes_snapshots_match_pallas_and_spec():
    """Two sharer words (``tests/test_random_differential.py``'s 33-node
    geometry), one window, snapshots on.  Building the interpreted JAX
    kernel at 33 nodes takes most of this test's minute."""
    jcfg, tcfg = config_pair(True, num_procs=33, cache_size=4, mem_size=8,
                             msg_buffer_size=32)
    arrays = gen_uniform_random_arrays(jcfg, 2, 10, seed=12)
    pe, ce, stall = run_both(jcfg, tcfg, arrays, block=2,
                             cycles_per_call=32, snapshots=True)
    assert stall is None
    assert "snap_dirs1" in ce.state
    assert ce.stats() == pe.stats()
    for b in range(2):
        assert dicts(ce.system_snapshots(b)) == dicts(pe.system_snapshots(b))
        spec = SpecEngine(jcfg, traces_of(*arrays, b, 33))
        spec.run()
        assert dicts(ce.system_final_dumps(b)) == dicts(spec.final_dumps())
        assert dicts(ce.system_snapshots(b)) == dicts(spec.snapshots())


def test_64_nodes_matches_spec():
    """Three sharer words: the widest system of the CUDA kernel
    (``tests/test_pallas_engine.py``'s SW=3 geometry), against the spec
    engine (the interpreted JAX run takes minutes here)."""
    jcfg, tcfg = config_pair(True, num_procs=64, cache_size=2, mem_size=4,
                             msg_buffer_size=16)
    arrays = gen_uniform_random_arrays(tcfg, 2, 6, seed=9)
    ce = CudaEngine(tcfg, *arrays, block=2, cycles_per_call=32,
                    device="cpu").run(max_cycles=100_000)
    assert ce.instructions == 2 * 64 * 6
    assert [f"dirs{w}" in ce.state for w in range(4)] == [True] * 3 + [False]
    for b in range(2):
        spec = SpecEngine(jcfg, traces_of(*arrays, b, 64))
        spec.run(max_cycles=50_000)
        assert dicts(ce.system_final_dumps(b)) == dicts(spec.final_dumps())
        assert dicts(ce.system_snapshots(b)) == dicts(spec.snapshots())
