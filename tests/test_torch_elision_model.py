"""The port's exact-replay model of cycle elision
(``hpa2_tpu_torch/analysis/elision.py``) against ``TorchEngine`` and
``BatchTorchEngine`` on the CPU, and against the JAX package's model.

The model replays the device's jump policy on the spec engine, so its
counters equal a real run's ``elided_cycles``, ``multi_hit_retired``
and final cycle exactly (tolerance zero: integer counters)."""

import dataclasses

import pytest

from hpa2_tpu.analysis import elision as jx_elision
from hpa2_tpu.config import InterconnectConfig as JxInterconnect
from hpa2_tpu.config import Semantics as JxSemantics
from hpa2_tpu.config import SystemConfig as JxConfig
from hpa2_tpu.utils.trace import gen_hot_hit_zipf as jx_gen_hot_hit_zipf
from hpa2_tpu_torch.analysis.elision import (
    elision_table, predicted_batch_elision, predicted_elision,
)
from hpa2_tpu_torch.config import InterconnectConfig, Semantics, SystemConfig
from hpa2_tpu_torch.ops.engine import BatchTorchEngine, TorchEngine
from hpa2_tpu_torch.ops.schedule import Schedule
from hpa2_tpu_torch.utils.trace import gen_hot_hit_zipf
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _configs(topology="ideal"):
    return (SystemConfig(num_procs=4, semantics=Semantics().robust(),
                         interconnect=InterconnectConfig(topology=topology)),
            JxConfig(num_procs=4, semantics=JxSemantics().robust(),
                     interconnect=JxInterconnect(topology=topology)))


def test_hot_hit_zipf_traces_equal_jax():
    cfg, jcfg = _configs()
    for spread in (2.0, 8.0):
        got = gen_hot_hit_zipf(cfg, 64, seed=3, spread=spread)
        want = jx_gen_hot_hit_zipf(jcfg, 64, seed=3, spread=spread)
        assert [[(i.op, i.address, i.value) for i in tr] for tr in got] \
            == [[(i.op, i.address, i.value) for i in tr] for tr in want]


@pytest.mark.parametrize("topology,seed,spread", [
    ("ideal", 4, 8.0), ("ideal", 5, 2.0), ("mesh2d", 4, 8.0),
    ("torus2d", 6, 4.0),
])
def test_model_equals_torch_engine_and_jax_model(topology, seed, spread):
    cfg, jcfg = _configs(topology)
    traces = gen_hot_hit_zipf(cfg, 96, seed=seed, spread=spread)
    pred = predicted_elision(cfg, traces)
    eng = TorchEngine(cfg, traces, device="cpu").run()
    stats = eng.stats()
    assert pred.cycles == eng.cycle
    assert pred.elided_cycles == stats.get("elided_cycles", 0)
    assert pred.multi_hit_retired == stats.get("multi_hit_retired", 0)
    assert pred.device_steps == pred.cycles - pred.elided_cycles
    assert pred.elided_cycles > 0
    want = jx_elision.predicted_elision(
        jcfg, jx_gen_hot_hit_zipf(jcfg, 96, seed=seed, spread=spread))
    assert dataclasses.asdict(pred) == dataclasses.asdict(want)


def test_chunked_model_equals_jax_model():
    cfg, jcfg = _configs()
    traces = gen_hot_hit_zipf(cfg, 80, seed=2)
    pred = predicted_elision(cfg, traces, interval=24)
    want = jx_elision.predicted_elision(
        jcfg, jx_gen_hot_hit_zipf(jcfg, 80, seed=2), interval=24)
    assert dataclasses.asdict(pred) == dataclasses.asdict(want)
    assert sum(pred.per_interval) == pred.elided_cycles


def test_batch_model_equals_scheduled_run_and_jax_model():
    """The per-interval extension against the port's host-loop
    scheduled run, all rows resident: its occupancy counters."""
    cfg, jcfg = _configs()
    batch = [gen_hot_hit_zipf(cfg, 80, seed=s) for s in range(3)]
    pred = predicted_batch_elision(cfg, batch, interval=24)
    eng = BatchTorchEngine(cfg, batch, device="cpu",
                           schedule=Schedule(interval=24, fused=False)).run()
    occ = eng.occupancy.as_dict()
    assert sum(pred.per_interval) == pred.elided_cycles
    assert pred.elided_cycles == occ["elided_cycles"]
    assert pred.multi_hit_retired == occ["multi_hit_retired"]
    assert len(pred.per_interval) == occ["intervals"]
    want = jx_elision.predicted_batch_elision(
        jcfg, [jx_gen_hot_hit_zipf(jcfg, 80, seed=s) for s in range(3)],
        interval=24)
    assert dataclasses.asdict(pred) == dataclasses.asdict(want)


def test_elision_table_verifies_on_the_cpu():
    table, rc = elision_table(procs=4, instrs=64, spreads=(8.0,),
                              device="cpu")
    assert rc == 0, table
    assert "exact match" in table
    want, _ = jx_elision.elision_table(procs=4, instrs=64, spreads=(8.0,),
                                       verify=False)
    # the model's columns are the JAX model's
    assert [ln.split()[:6] for ln in table.splitlines()[2:]] == \
        [ln.split()[:6] for ln in want.splitlines()[2:]]
