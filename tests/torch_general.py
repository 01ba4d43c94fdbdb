"""Shared helpers of the general-engine port tests
(``test_torch_general*.py``): one configuration and one set of traces
in both packages, each JAX reference run once per process, and the
comparison of a ``JaxEngine``/``BatchJaxEngine`` with its port
counterpart in every ``SimState`` field (through ``convert.py``), the
dumps, snapshots, counters and link counters.  Tolerance zero: all
state is integer."""

import dataclasses
import functools

import numpy as np

import hpa2_tpu.config as jconfig
import hpa2_tpu_torch.config as tconfig
from hpa2_tpu.models.protocol import Instr as JInstr
from hpa2_tpu.models.spec_engine import StallError as JStallError
from hpa2_tpu.ops.engine import BatchJaxEngine, JaxEngine
from hpa2_tpu.utils.trace import gen_uniform_random
from hpa2_tpu_torch.convert import sim_state_to_numpy
from hpa2_tpu_torch.models.protocol import Instr
from hpa2_tpu_torch.ops.engine import BatchTorchEngine, TorchEngine
from hpa2_tpu_torch.ops.layout import StallError
from hpa2_tpu_torch.utils.trace import IssueRecord

ROBUST = jconfig.Semantics().robust()
#: the fault mix of the JAX fault tests' acceptance criteria
ACCEPT = dict(drop=0.2, duplicate=0.1, reorder=0.2, seed=7)
#: one severed directed edge (every copy from node 1 to node 0 drops)
SEVERED = dict(drop=1.0, edge_sender=1, edge_receiver=0, seed=1)
#: the diagnostic's fields, as the JAX fault tests compare them
DIAG_FIELDS = (
    "reason", "cycle", "mailbox_depths", "waiting", "blocked",
    "line_states", "recent_msgs", "invariant_violations", "counters",
)


def gen_hot(cfg, t, seed):
    """Uniform traffic folded onto the first home's blocks, so sharer
    sets grow: invalidation fan-outs outgrow a limited directory's
    pointers and share links (``test_protocols.py:_hot_arrays``)."""
    return [[JInstr(i.op, i.address % cfg.mem_size, i.value) for i in tr]
            for tr in gen_uniform_random(cfg, t, seed=seed)]


def port_config(cfg):
    """A ``hpa2_tpu.config`` dataclass -> the same one in the port."""
    if dataclasses.is_dataclass(cfg):
        cls = getattr(tconfig, type(cfg).__name__)
        return cls(**{f.name: port_config(getattr(cfg, f.name))
                      for f in dataclasses.fields(cfg)})
    if isinstance(cfg, tuple):
        return tuple(port_config(x) for x in cfg)
    return cfg


def port_traces(traces):
    return [[Instr(i.op, i.address, i.value) for i in tr] for tr in traces]


def port_order(order):
    return [IssueRecord(r.proc, r.op, r.address, r.value) for r in order]


def dicts(dumps):
    return [d.__dict__ for d in dumps]


def state_diff(jstate, tstate, batched: bool):
    """Fields of the JAX state the port's state does not equal."""
    got = sim_state_to_numpy(tstate, batched=batched)
    bad = []
    for f in jstate._fields:
        want = np.asarray(getattr(jstate, f))
        if want.dtype != got[f].dtype or not np.array_equal(want, got[f]):
            bad.append(f)
    return bad


def _run(eng):
    try:
        eng.run()
    except (JStallError, StallError) as e:
        return e
    return None


@functools.lru_cache(maxsize=None)
def jax_single(cfg, traces_key, replay=None, watchdog_cycles=10_000):
    """``JaxEngine`` on ``traces_key`` (a tuple of tuples of JAX
    Instr), run once per process: (engine, the stall it raised)."""
    eng = JaxEngine(cfg, [list(t) for t in traces_key],
                    replay_order=list(replay) if replay else None,
                    watchdog_cycles=watchdog_cycles)
    return eng, _run(eng)


def torch_single(cfg, traces, replay=None, watchdog_cycles=10_000):
    eng = TorchEngine(port_config(cfg), port_traces(traces),
                      replay_order=port_order(replay) if replay else None,
                      watchdog_cycles=watchdog_cycles, device="cpu")
    return eng, _run(eng)


def freeze(traces):
    return tuple(tuple(t) for t in traces)


def assert_single_equal(cfg, traces, replay=None, watchdog_cycles=10_000):
    """``TorchEngine(device="cpu")`` equals ``JaxEngine``: every state
    field, dumps, snapshots, stats, link stats, cycle and stall."""
    je, jerr = jax_single(cfg, freeze(traces),
                          tuple(replay) if replay else None, watchdog_cycles)
    te, terr = torch_single(cfg, traces, replay, watchdog_cycles)
    assert state_diff(je.state, te.state, batched=False) == []
    assert dicts(te.final_dumps()) == dicts(je.final_dumps())
    assert dicts(te.snapshots()) == dicts(je.snapshots())
    assert te.stats() == je.stats()
    assert te.link_stats() == je.link_stats()
    assert te.cycle == je.cycle
    assert (jerr is None) == (terr is None)
    if jerr is not None:
        assert type(terr).__name__ == type(jerr).__name__
        for f in DIAG_FIELDS if hasattr(jerr, "counters") else ():
            assert getattr(terr, f) == getattr(jerr, f), f
        assert str(terr) == str(jerr)
    return je, te


def assert_batch_equal(cfg, batch, **kw):
    """``BatchTorchEngine(device="cpu")`` equals ``BatchJaxEngine``."""
    je = BatchJaxEngine(cfg, batch, **kw)
    jerr = _run(je)
    te = BatchTorchEngine(port_config(cfg), [port_traces(t) for t in batch],
                          device="cpu", **kw)
    terr = _run(te)
    assert (jerr is None) == (terr is None)
    if jerr is not None:
        assert str(terr) == str(jerr)
    assert state_diff(je.state, te.state, batched=True) == []
    for b in range(len(batch)):
        assert dicts(te.system_final_dumps(b)) == dicts(
            je.system_final_dumps(b))
        assert dicts(te.system_snapshots(b)) == dicts(
            je.system_snapshots(b))
    assert te.stats() == je.stats()
    assert te.link_stats() == je.link_stats()
    assert te.instructions == je.instructions
    return je, te
