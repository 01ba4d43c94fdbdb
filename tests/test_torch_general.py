"""The general engine of the port (``TorchEngine``, on the CPU) against
``JaxEngine`` on the same traces, at one case per protocol, directory
format and elision setting, plus replay, dump-candidate capture, the
severed-edge watchdog and a livelock's jump to the watchdog's boundary:
every ``SimState`` field, dumps, snapshots,
``stats()``, ``link_stats()``, ``cycle`` and ``n_elided`` equal, bit for
bit (geometries of ``tests/test_jax_engine.py``, ``test_protocols.py``,
``test_elision.py`` and ``test_faults.py``, cut to 4-8 nodes and at
most 32 instructions a core); and what the port refuses, naming the
ROADMAP item that brings it."""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from hpa2_tpu.config import FaultModel, SystemConfig
from hpa2_tpu.models.spec_engine import SpecEngine
from hpa2_tpu.ops.engine import JaxEngine
from hpa2_tpu.ops.state import init_state
from hpa2_tpu.utils.trace import gen_hot_hit_zipf, gen_uniform_random
from hpa2_tpu_torch.convert import sim_state_from_numpy, sim_state_to_numpy
from hpa2_tpu_torch.ops.engine import (
    BatchTorchEngine, StallDiagnostic, TorchEngine,
)
from hpa2_tpu_torch.ops.layout import StallError
from hpa2_tpu_torch.ops.state import init_state as port_init_state

from torch_general import (
    ACCEPT, ROBUST, SEVERED, assert_single_equal, dicts, gen_hot,
    port_config, port_order, port_traces,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


CASES = {
    # protocols (test_protocols.py: 4 nodes, 64-deep mailboxes)
    "mesi": (dict(msg_buffer_size=8), gen_uniform_random, 24),
    "moesi": (dict(protocol="moesi", msg_buffer_size=64), gen_uniform_random,
              24),
    "mesif": (dict(protocol="mesif", msg_buffer_size=64), gen_uniform_random,
              24),
    # directory formats on shared hot lines (6-8 nodes: K and G below
    # num_procs)
    "limited:2": (dict(num_procs=6, directory_format="limited:2"),
                  gen_hot, 20),
    "coarse:2": (dict(num_procs=6, directory_format="coarse:2"), gen_hot,
                 20),
    "coarse:4-mesif": (dict(num_procs=8, directory_format="coarse:4",
                            protocol="mesif"), gen_hot, 12),
    # elision on a hot-hit workload (test_elision.py), and lockstep
    "elide": (dict(), gen_hot_hit_zipf, 32),
    "lockstep": (dict(elide=False), gen_hot_hit_zipf, 32),
    # the value quirks every lockstep backend implements
    "quirks": (dict(msg_buffer_size=16), gen_uniform_random, 24),
}


def _cfg(name):
    kw, gen, t = CASES[name]
    kw = dict(kw)
    sem = ROBUST
    if name == "quirks":
        sem = dataclasses.replace(sem, eager_write_request_memory=True,
                                  flush_invack_fills_old_value=True)
    cfg = SystemConfig(num_procs=kw.pop("num_procs", 4), semantics=sem, **kw)
    return cfg, gen(cfg, t, seed=5)


@pytest.mark.parametrize("name", sorted(CASES))
def test_engine_matches_jax(name):
    cfg, traces = _cfg(name)
    je, te = assert_single_equal(cfg, traces)
    stats = je.stats()
    if name == "elide":
        assert stats["elided_cycles"] > 0 and stats["multi_hit_retired"] > 0
    if name == "lockstep":
        assert int(np.asarray(te.state.n_elided).sum()) == 0
    if name in ("moesi", "mesif"):
        assert stats.get("forwards", 0) + stats.get("owner_transfers", 0) > 0
    if name.startswith("limited"):
        assert stats.get("dir_overflows", 0) > 0
    if name.startswith("coarse"):
        assert stats["invalidations"] > 0


def test_elision_changes_nothing_but_its_counters():
    """Elision on and off in the port: the same cycle, dumps and
    activity counters (``test_elision.py:_assert_single_exact``)."""
    cfg, traces = _cfg("elide")
    on = TorchEngine(port_config(cfg), port_traces(traces),
                     device="cpu").run()
    off = TorchEngine(port_config(dataclasses.replace(cfg, elide=False)),
                      port_traces(traces), device="cpu").run()
    assert on.cycle == off.cycle
    assert dicts(on.final_dumps()) == dicts(off.final_dumps())
    assert dicts(on.snapshots()) == dicts(off.snapshots())
    strip = lambda s: {k: v for k, v in s.items()
                       if k not in ("elided_cycles", "multi_hit_retired")}
    assert strip(on.stats()) == strip(off.stats())
    assert on.stats()["elided_cycles"] > 0


def test_replay_matches_jax():
    """A recorded issue order (the spec engine's) replayed by both."""
    cfg = SystemConfig(num_procs=4, semantics=ROBUST)
    traces = gen_uniform_random(cfg, 16, seed=2)
    spec = SpecEngine(cfg, traces)
    spec.run()
    je, te = assert_single_equal(cfg, traces, replay=spec.issue_log)
    assert int(np.asarray(je.state.order_pos)) == len(spec.issue_log)


def test_replay_rejects_a_mismatched_order():
    cfg = SystemConfig(num_procs=4, semantics=ROBUST)
    traces = gen_uniform_random(cfg, 8, seed=2)
    spec = SpecEngine(cfg, traces)
    spec.run()
    order = port_order(spec.issue_log)[1:]
    with pytest.raises(ValueError, match="order"):
        TorchEngine(port_config(cfg), port_traces(traces),
                    replay_order=order, device="cpu")


def test_capturing_candidates_matches_jax():
    cfg = SystemConfig(num_procs=4, semantics=ROBUST)
    traces = gen_uniform_random(cfg, 12, seed=4)
    je = JaxEngine(cfg, traces).run_capturing_candidates()
    te = TorchEngine(port_config(cfg), port_traces(traces),
                     device="cpu").run_capturing_candidates()
    assert [dicts(c) for c in te.dump_candidates] == [
        dicts(c) for c in je.dump_candidates]
    assert dicts(te.final_dumps()) == dicts(je.final_dumps())


def test_severed_edge_raises_the_same_diagnostic():
    """drop=1.0 on edge 1->0: the watchdog converts the livelock into
    the same ``StallDiagnostic`` (every field, and the text)."""
    cfg = SystemConfig(num_procs=4, semantics=ROBUST,
                       fault=FaultModel(**SEVERED))
    traces = gen_uniform_random(cfg, 16, seed=3)
    je, te = assert_single_equal(cfg, traces, watchdog_cycles=50)
    with pytest.raises(StallDiagnostic) as ei:
        TorchEngine(port_config(cfg), port_traces(traces),
                    watchdog_cycles=50, device="cpu").run()
    assert isinstance(ei.value, StallError)
    assert ei.value.cycle < 1000 and ei.value.blocked


def test_livelock_idle_jump_to_the_watchdog_matches_jax():
    """Fixture semantics drop a stale intervention and livelock: every
    node idles, so elision jumps straight to the watchdog's boundary
    (``build_propose``'s watchdog candidate) and both engines raise the
    same diagnostic after the same elided cycles."""
    cfg = SystemConfig(num_procs=4, msg_buffer_size=8)
    traces = gen_hot(cfg, 24, seed=3)
    je, te = assert_single_equal(cfg, traces, watchdog_cycles=300)
    assert int(np.asarray(je.state.n_elided)) > 200


def test_fault_mix_matches_jax():
    """The acceptance fault mix under elision on a hot-hit workload: the
    fast-forward replays the per-cycle key splits."""
    cfg = SystemConfig(num_procs=4, semantics=ROBUST,
                       fault=FaultModel(**ACCEPT))
    traces = gen_hot_hit_zipf(cfg, 32, seed=3)
    je, _ = assert_single_equal(cfg, traces)
    stats = je.stats()
    assert stats["fault_retransmissions"] > 0 and stats["elided_cycles"] > 0


def test_sim_state_round_trip():
    """A JAX state carried to the port and back is the same arrays,
    uint32 words as uint32; the port's initial state equals JAX's."""
    cfg = SystemConfig(num_procs=4, semantics=ROBUST,
                       fault=FaultModel(drop=0.1, seed=2**31 + 3))
    traces = gen_uniform_random(cfg, 6, seed=1)
    jst = init_state(cfg, traces)
    pst = sim_state_from_numpy(jst, device="cpu", batched=False)
    back = sim_state_to_numpy(pst, batched=False)
    for f in jst._fields:
        want = np.asarray(getattr(jst, f))
        assert back[f].dtype == want.dtype and np.array_equal(
            back[f], want), f
    mine = port_init_state(port_config(cfg), port_traces(traces),
                           device="cpu")
    for f, x, y in zip(pst._fields, pst, mine):
        assert torch.equal(x, y), f


def test_engines_default_to_the_card():
    cfg = SystemConfig(num_procs=4, semantics=ROBUST)
    traces = port_traces(gen_uniform_random(cfg, 4, seed=0))
    for engine, arg in ((TorchEngine, traces),
                        (BatchTorchEngine, [traces, traces])):
        assert inspect.signature(engine).parameters[
            "device"].default == "cuda"
        if torch.cuda.is_available():
            assert engine(port_config(cfg), arg).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                engine(port_config(cfg), arg)


@pytest.mark.parametrize("what,match", [
    ("node-shards", "item 4"),
    ("messages-per-cycle", "messages_per_cycle"),
    ("overloaded-notify", "fixture semantics"),
    ("schedule", "item 2b"),
    ("data-shards", "item 4"),
])
def test_engine_refuses_what_is_not_ported(what, match):
    from hpa2_tpu_torch.config import Semantics
    from hpa2_tpu_torch.config import SystemConfig as TSystemConfig
    from hpa2_tpu_torch.ops.step import build_step

    cfg = TSystemConfig(num_procs=4, semantics=Semantics().robust())
    traces = port_traces(gen_uniform_random(cfg, 4, seed=0))
    with pytest.raises(ValueError, match=match):
        if what == "node-shards":
            build_step(cfg, axis_name="nodes", shards=2)
        elif what == "messages-per-cycle":
            build_step(dataclasses.replace(cfg, messages_per_cycle=2))
        elif what == "overloaded-notify":
            build_step(dataclasses.replace(cfg, semantics=dataclasses.replace(
                cfg.semantics, overloaded_evict_shared_notify=True)))
        elif what == "schedule":
            BatchTorchEngine(cfg, [traces], schedule=object(), device="cpu")
        else:
            BatchTorchEngine(cfg, [traces, traces], data_shards=2,
                             device="cpu")
