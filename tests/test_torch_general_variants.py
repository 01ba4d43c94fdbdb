"""The general engine of the port on the CPU against the JAX engines:
each topology (with multicast and combining), the fault mixes, and
the batch engine (``BatchTorchEngine`` against ``BatchJaxEngine``, and
against the fast path's ``CudaEngine`` at MESI), with every
``SimState`` field, dumps, snapshots, ``stats()`` and ``link_stats()``
equal bit for bit (geometries of ``tests/test_interconnect.py`` and
``test_faults.py``, cut to 4-6 nodes); and the loop's gated chunks,
which the card replays as CUDA graphs, against its host loop."""

import pytest
import torch

from hpa2_tpu.config import (
    FaultModel, InterconnectConfig, Semantics, SystemConfig,
)
from hpa2_tpu.utils.trace import gen_hot_hit_zipf, gen_uniform_random
from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
from hpa2_tpu_torch.ops.engine import BatchTorchEngine, StallDiagnostic
from hpa2_tpu_torch.ops.state import init_state_batched
from hpa2_tpu_torch.ops.step import Run
from hpa2_tpu_torch.utils.trace import (
    gen_uniform_random_arrays, traces_to_arrays,
)

from torch_general import (
    ACCEPT, ROBUST, SEVERED, assert_batch_equal, assert_single_equal, dicts,
    gen_hot, port_config, port_traces,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

TOPOLOGIES = {
    "mesh2d-multicast": (6, dict(topology="mesh2d", multicast=True)),
    "mesh2d-bandwidth-combining": (4, dict(topology="mesh2d",
                                           link_bandwidth=2,
                                           combining=True)),
    "torus2d-combining": (6, dict(topology="torus2d", combining=True)),
    "hierarchical-hop2": (4, dict(topology="hierarchical", hop_latency=2,
                                  multicast=True)),
}


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
def test_topology_matches_jax(name):
    n, ic = TOPOLOGIES[name]
    cfg = SystemConfig(num_procs=n, semantics=ROBUST,
                       interconnect=InterconnectConfig(**ic))
    je, _ = assert_single_equal(cfg, gen_hot(cfg, 24, seed=1))
    stats = je.stats()
    assert stats["topo_delay_cycles"] > 0 and je.link_stats()["traversals"]
    if ic.get("multicast"):
        assert stats.get("topo_multicast_saved", 0) > 0


FAULTS = {
    "drop": dict(drop=0.1, seed=3),
    "dup-reorder": dict(duplicate=0.3, reorder=0.3, seed=11),
    "bench-mix": dict(drop=0.2, duplicate=0.05, reorder=0.05, delay=0.1,
                      seed=7),
    "edge-delay": dict(drop=0.5, delay=0.5, edge_sender=2, seed=5),
}


@pytest.mark.parametrize("name", sorted(FAULTS))
def test_fault_mix_matches_jax(name):
    """Faults are masked by the link layer, and counted the same."""
    cfg = SystemConfig(num_procs=4, semantics=ROBUST,
                       fault=FaultModel(**FAULTS[name]))
    je, _ = assert_single_equal(cfg, gen_uniform_random(cfg, 24, seed=5))
    assert any(k.startswith("fault_") for k in je.stats())


def test_faults_on_a_topology_under_elision_match_jax():
    """Topology gates and fault key replays in one elided run."""
    cfg = SystemConfig(num_procs=4, semantics=ROBUST,
                       interconnect=InterconnectConfig(
                           topology="mesh2d", fault=FaultModel(**ACCEPT)))
    je, _ = assert_single_equal(cfg, gen_hot_hit_zipf(cfg, 24, seed=2))
    assert je.stats()["elided_cycles"] > 0


@pytest.mark.parametrize("name,kw", [
    ("mesi", dict(msg_buffer_size=8)),
    ("moesi-lockstep", dict(protocol="moesi", elide=False)),
    ("faults-mesh2d", dict(interconnect=InterconnectConfig(
        topology="mesh2d", fault=FaultModel(drop=0.3, duplicate=0.1,
                                            seed=3)))),
])
def test_batch_engine_matches_jax(name, kw):
    cfg = SystemConfig(num_procs=4, semantics=ROBUST, **kw)
    batch = [gen_uniform_random(cfg, 16, seed=s) for s in range(5)]
    assert_batch_equal(cfg, batch, watchdog_cycles=500)


def test_batch_watchdog_matches_jax():
    """A batch whose systems stall on a severed edge raises the same
    diagnostic as ``BatchJaxEngine`` (its first stalled system)."""
    cfg = SystemConfig(num_procs=4, semantics=ROBUST,
                       fault=FaultModel(**SEVERED))
    batch = [gen_uniform_random(cfg, 16, seed=3)] * 3
    je, te = assert_batch_equal(cfg, batch, max_cycles=100_000,
                                watchdog_cycles=50)
    with pytest.raises(StallDiagnostic) as ei:
        te.run()
    assert ei.value.reason.endswith("(system 0 of 3)")


def test_batch_livelock_matches_jax():
    """Systems that livelock under fixture semantics idle together: the
    batch's shared jump stops at the watchdog boundary of the live
    system that progressed last, as in ``BatchJaxEngine``."""
    cfg = SystemConfig(num_procs=4, msg_buffer_size=8)
    batch = [gen_hot(cfg, 16, seed=s) for s in range(3)]
    je, te = assert_batch_equal(cfg, batch, watchdog_cycles=200)
    assert int(te.state.n_elided.max()) > 0


def test_batch_engine_matches_the_fast_path():
    """At MESI/full/ideal the general engine and the fast path
    (``CudaEngine``'s plain version) agree on dumps, snapshots, the
    counters and the longest system's cycle count."""
    from hpa2_tpu_torch.config import Semantics
    from hpa2_tpu_torch.config import SystemConfig as TSystemConfig

    cfg = TSystemConfig(num_procs=8, msg_buffer_size=16,
                        semantics=Semantics().robust())
    traces = _instr_lists(gen_uniform_random_arrays(cfg, 8, 24, seed=4))
    ge = BatchTorchEngine(cfg, traces, device="cpu").run()
    fe = CudaEngine(cfg, *traces_to_arrays(cfg, traces), block=8,
                    device="cpu").run()
    for b in range(8):
        assert dicts(ge.system_final_dumps(b)) == dicts(
            fe.system_final_dumps(b))
        assert dicts(ge.system_snapshots(b)) == dicts(
            fe.system_snapshots(b))
    strip = lambda s: {k: v for k, v in s.items()
                       if k not in ("elided_cycles", "multi_hit_retired")}
    assert strip(ge.stats()) == fe.stats()
    assert int(ge.state.cycle.max()) == fe.cycle


def _instr_lists(arrays):
    from hpa2_tpu_torch.models.protocol import Instr

    op, addr, val, length = arrays
    return [[[Instr("W", int(a), int(v)) if o else Instr("R", int(a))
              for o, a, v in zip(op[s, i, :length[s, i]],
                                 addr[s, i, :length[s, i]],
                                 val[s, i, :length[s, i]])]
             for i in range(op.shape[1])] for s in range(op.shape[0])]


def _chunked(run, st, steps):
    """The card's loop without the graph: gated chunks, one flag read a
    chunk, the host finishing a jump too long for the in-graph key
    replay."""
    while True:
        st, flag = run.advance_chunk(st, steps)
        f = int(flag)
        if f == 0:
            return st
        if f == 2:
            st = run.body(st)


@pytest.mark.parametrize("name,kw", [
    ("lockstep", dict(elide=False)),
    ("elide-hot", dict()),
    ("elide-livelock", dict(semantics=Semantics())),
    ("faults-elide", dict(fault=FaultModel(**ACCEPT))),
    ("topology-faults", dict(interconnect=InterconnectConfig(
        topology="torus2d", combining=True,
        fault=FaultModel(drop=0.2, seed=1)))),
])
def test_gated_chunks_match_the_host_loop(name, kw):
    """``state = where(go, body(state), state)`` in chunks (with a key
    bound of 1, so long jumps go to the host) ends in the same state
    as the host loop, every field, whatever the chunk length."""
    cfg = port_config(SystemConfig(num_procs=4, **{"semantics": ROBUST,
                                                   **kw}))
    batch = [port_traces(gen_hot_hit_zipf(cfg, 24, seed=s))
             for s in range(3)]
    st0 = init_state_batched(cfg, *traces_to_arrays(cfg, batch),
                             device="cpu")
    run = Run(cfg, watchdog_cycles=400, key_bound=1)
    want = run(st0)
    for steps in (1, 7):
        got = _chunked(run, st0, steps)
        bad = [f for f, x, y in zip(want._fields, got, want)
               if not torch.equal(x, y)]
        assert bad == [], (steps, bad)
    if "elide" in name:
        assert int(want.n_elided.sum()) > 0
