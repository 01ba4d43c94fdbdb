"""The port's engine (``hpa2_tpu_torch.ops.cuda_engine.CudaEngine``) on
the CPU, which runs the kernel's plain version, against
``hpa2_tpu.ops.pallas_engine.PallasEngine`` with ``stream=True`` in the
Pallas interpreter, at the unsplit, unpacked geometries of
``tests/test_pallas_engine.py`` (the windowed and backpressure cases
are in ``test_torch_engine_windows.py`` and
``test_torch_engine_backpressure.py``).

Every carried plane, the stall status and the dumps must agree bit for
bit; the dumps must also equal the spec engine's."""

import numpy as np
import pytest

from hpa2_tpu.models.spec_engine import SpecEngine
from hpa2_tpu.utils.trace import gen_local_only, gen_uniform_random_arrays
from hpa2_tpu_torch.config import InterconnectConfig, Semantics, SystemConfig
from hpa2_tpu_torch.ops import kernels
from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
from hpa2_tpu_torch.ops.layout import StallError
from torch_pairs import (
    IGNORE_PLTPU_ANY, config_pair, dicts, run_both, traces_of,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings(IGNORE_PLTPU_ANY)


@pytest.mark.parametrize(
    "n,batch,block,t,seed",
    [
        (4, 4, 4, 16, 0),
        (4, 2, 2, 24, 2),
    ],
)
def test_robust_matches_pallas_and_spec(n, batch, block, t, seed):
    jcfg, tcfg = config_pair(True, num_procs=n, msg_buffer_size=64)
    arrays = gen_uniform_random_arrays(jcfg, batch, t, seed=seed)
    pe, ce, stall = run_both(jcfg, tcfg, arrays, block=block,
                             cycles_per_call=64)
    assert stall is None
    assert ce.stats() == pe.stats()
    for b in range(batch):
        spec = SpecEngine(jcfg, traces_of(*arrays, b, n))
        spec.run()
        assert dicts(ce.system_final_dumps(b)) == dicts(spec.final_dumps())
        assert dicts(ce.system_snapshots(b)) == dicts(spec.snapshots())


def test_default_drop_local_traffic_completes():
    """Fixture ("drop") semantics on node-local traffic runs clean."""
    jcfg, tcfg = config_pair(False, num_procs=4, msg_buffer_size=32)
    traces = gen_local_only(jcfg, 24, seed=3)
    op = np.array([[[0 if i.op == "R" else 1 for i in tr] for tr in traces]],
                  np.int32)
    addr = np.array([[[i.address for i in tr] for tr in traces]], np.int32)
    val = np.array([[[i.value for i in tr] for tr in traces]], np.int32)
    length = np.full((1, 4), 24, np.int32)
    _, ce, stall = run_both(jcfg, tcfg, (op, addr, val, length), block=1,
                            cycles_per_call=64)
    assert stall is None
    spec = SpecEngine(jcfg, traces)
    spec.run()
    assert dicts(ce.final_dumps()) == dicts(spec.final_dumps())


@pytest.mark.parametrize("seed", [0, 5])
def test_default_drop_stall_agrees(seed):
    """Random traffic under "drop" semantics livelocks by design: both
    engines must report the same stall, from the same planes, and
    refuse to run again."""
    jcfg, tcfg = config_pair(False, num_procs=4, msg_buffer_size=16)
    arrays = gen_uniform_random_arrays(jcfg, 4, 24, seed=seed)
    _, ce, stall = run_both(jcfg, tcfg, arrays, max_cycles=256, block=2,
                            cycles_per_call=32)
    assert stall is not None and "no quiescence" in stall
    with pytest.raises(StallError, match="mid-flight"):
        ce.run()


def test_single_window_snapshots():
    jcfg, tcfg = config_pair(True, num_procs=4, msg_buffer_size=32)
    arrays = gen_uniform_random_arrays(jcfg, 2, 10, seed=6)
    pe, ce, stall = run_both(jcfg, tcfg, arrays, block=2, cycles_per_call=32,
                             snapshots=True, trace_window=10)
    assert stall is None
    for b in range(2):
        assert dicts(ce.system_snapshots(b)) == dicts(pe.system_snapshots(b))
        spec = SpecEngine(jcfg, traces_of(*arrays, b, 4))
        spec.run()
        assert dicts(ce.system_snapshots(b)) == dicts(spec.snapshots())


def test_run_is_idempotent():
    _, tcfg = config_pair(True, num_procs=4, msg_buffer_size=16)
    arrays = gen_uniform_random_arrays(tcfg, 2, 8, seed=1)
    ce = CudaEngine(tcfg, *arrays, block=2, cycles_per_call=32,
                    device="cpu").run()
    before = ce.instructions
    ce.run()
    assert ce.instructions == before == 2 * 4 * 8


def _arrays(cfg, b=2, t=4):
    return gen_uniform_random_arrays(cfg, b, t, seed=0)


@pytest.mark.parametrize(
    "cfg_kw,eng_kw,match",
    [
        # the per-call path runs now; it keeps the whole-trace snapshot
        # gate of windowed runs
        pytest.param({}, dict(stream=False, trace_window=2),
                     "snapshots=False", id="cfg_kw0-eng_kw0-stream=False"),
        ({}, dict(schedule=object()), "schedule"),
        ({}, dict(trace_window=2), "snapshots=False"),
        (dict(interconnect=InterconnectConfig(topology="mesh2d")), {},
         "ideal topology"),
        (dict(protocol="moesi"), {}, "MESI"),
        (dict(directory_format="limited:2"), {}, "MESI"),
        (dict(messages_per_cycle=2), {}, "one message"),
        (dict(semantics=Semantics(overloaded_evict_shared_notify=True)), {},
         "fixture semantics"),
        (dict(num_procs=16, mem_size=1 << 17), {}, "2\\^21"),
    ],
)
def test_refusal_gates(cfg_kw, eng_kw, match):
    cfg = SystemConfig(**{"msg_buffer_size": 16, **cfg_kw})
    with pytest.raises(ValueError, match=match):
        CudaEngine(cfg, *_arrays(cfg), block=2, device="cpu", **eng_kw)


def test_per_call_and_scheduled_runs_are_accepted():
    """``stream=False`` and ``schedule=`` no longer raise: both run and
    retire every instruction."""
    from hpa2_tpu_torch.ops.schedule import Schedule

    cfg = SystemConfig(msg_buffer_size=16, semantics=Semantics().robust())
    for kw in (dict(stream=False),
               dict(schedule=Schedule(resident=2), snapshots=False),
               dict(stream=False, schedule=Schedule(fused=False),
                    snapshots=False)):
        eng = CudaEngine(cfg, *_arrays(cfg, b=4), block=2, device="cpu",
                         **kw).run()
        assert eng.instructions == 4 * 4 * 4, kw


def test_block_above_kernel_limit_refused():
    """The kernel's lane-block limit is the card's, by node bound
    (``kernels.MAX_LANE_BLOCK``): a block above it is refused by the
    check the card's setup and launch make, while the plain version
    takes any block that divides the lanes, as ``PallasEngine`` does."""
    cfg = SystemConfig(msg_buffer_size=16)
    most = kernels.MAX_LANE_BLOCK[8]
    with pytest.raises(ValueError, match=f"exceeds the {most} lanes"):
        kernels.check_block(cfg, most + 1)
    eng = CudaEngine(cfg, *_arrays(cfg, b=2048, t=1), block=2048,
                     device="cpu").run()
    assert eng.block == 2048 and eng.instructions == 2048 * 4


def test_kernel_node_bound():
    """The CUDA kernel's frame is sized for at most 64 nodes: a wider
    system is refused on the card, and runs on the plain version."""
    cfg = SystemConfig(num_procs=65, cache_size=2, mem_size=4,
                       msg_buffer_size=16, semantics=Semantics().robust())
    kernels.check_kernel_bound(SystemConfig(num_procs=64))
    with pytest.raises(ValueError, match="node bound of 64"):
        kernels.check_kernel_bound(cfg)
    ce = CudaEngine(cfg, *_arrays(cfg, b=2, t=1), block=2, snapshots=False,
                    device="cpu").run()
    assert ce.instructions == 2 * 65
