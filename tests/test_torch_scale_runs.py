"""``hpa2_tpu_torch/scripts/scale_runs.py`` (BASELINE.json's configurations
4 and 5) against the JAX package's runs of the same configurations at
small sizes, on the CPU.  Tolerance zero: all state is integer.

* config4 (256 nodes, producer-consumer, the general engine) equals
  ``hpa2_tpu.ops.engine.build_batched_run`` on the same arrays in every
  ``SimState`` field, instructions and cycles;
* config5 (8 nodes, the fast path in trace windows of 32) equals the
  interpreted ``PallasEngine`` at the script's shape in every carried
  plane, and with the zipf workload under the occupancy scheduler in the
  scalars plane, instructions, cycle and occupancy counters;
* ``multichip`` (the data-parallel ladder) runs on the CPU's logical
  shards bit-exact with one device, configuration 5 over two shards
  equals one device's run, the fast path's node-shard ladder and its
  exchange A/B (``nodeshard``, ``nodeshard_ab``) run over two gloo ranks
  bit-exact with one device's K2 plain version, and the card's entry
  points raise without a card."""

import json

import jax
import numpy as np
import pytest
import torch

from hpa2_tpu.config import Semantics as JSemantics
from hpa2_tpu.config import SystemConfig as JSystemConfig
from hpa2_tpu.ops.engine import build_batched_run as jax_batched_run
from hpa2_tpu.ops.pallas_engine import PallasEngine
from hpa2_tpu.ops.schedule import Schedule as JSchedule
from hpa2_tpu.ops.state import init_state_batched as jax_init
from hpa2_tpu.utils.trace import (
    gen_heterogeneous_random_arrays as jhet,
    gen_producer_consumer_arrays as jpc,
    gen_uniform_random_arrays as juni,
)
from hpa2_tpu_torch.convert import state_to_numpy
from hpa2_tpu_torch.scripts import scale_runs
from torch_general import state_diff
from torch_pairs import IGNORE_PLTPU_ANY
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings(IGNORE_PLTPU_ANY)

#: the JAX script's configuration 5 engine shape (scale_runs.py:117-118)
CONFIG5_KW = dict(block=512, cycles_per_call=128, snapshots=False,
                  trace_window=32, interpret=True)


def jax_config5():
    return JSystemConfig(num_procs=8, msg_buffer_size=16, max_instr_num=0,
                         semantics=JSemantics().robust())


def test_config4_equals_jax():
    """256 nodes x 8 instructions a core: 36 cycles in both, every field
    of the final state equal."""
    rec, out, arrays = scale_runs.config4_run(instrs_per_core=8,
                                              device="cpu")
    jcfg = JSystemConfig(num_procs=256, msg_buffer_size=64, max_instr_num=0,
                         semantics=JSemantics().robust())
    jarrays = jpc(jcfg, 1, 8)
    for got, want in zip(arrays, jarrays):
        np.testing.assert_array_equal(got, want)
    jout = jax.block_until_ready(jax_batched_run(
        jcfg, max_cycles=2_000_000)(jax_init(jcfg, *jarrays)))
    assert state_diff(jout, out, batched=True) == []
    assert rec["instructions"] == int(np.sum(jout.n_instr)) == 256 * 8
    assert rec["cycles"] == int(np.max(jout.cycle))
    assert rec["nodes"] == 256 and rec["sharer_words"] == 8
    assert rec["device"] == "cpu"


def test_config5_equals_interpreted_pallas():
    """8 systems x 8 nodes x 64 instructions (two trace windows), the
    script's shape (the block falls to the 8 lanes): every carried plane
    equal."""
    rec, eng, arrays = scale_runs.config5_run(batch=8, instrs_per_core=64,
                                              device="cpu")
    jarrays = juni(jax_config5(), 8, 64)
    for got, want in zip(arrays, jarrays):
        np.testing.assert_array_equal(got, want)
    pe = PallasEngine(jax_config5(), *jarrays, **CONFIG5_KW)
    pe.run(max_cycles=5_000_000)
    got = state_to_numpy(eng.state)
    assert set(got) == set(pe.state)
    for f in got:
        np.testing.assert_array_equal(got[f], np.asarray(pe.state[f]), f)
    assert rec["instructions"] == eng.instructions == pe.instructions
    assert rec["cycles"] == eng.cycle == pe.cycle
    assert rec["block"] == 8 and rec["k2_launches"] == 1


def test_config5_zipf_scheduled_equals_interpreted_pallas():
    """The zipf workload under ``Schedule()``: the scalars plane,
    instructions, cycle and occupancy counters equal."""
    rec, eng, arrays = scale_runs.config5_run(
        batch=8, instrs_per_core=64, dist="zipf", schedule=True,
        device="cpu")
    jarrays = jhet(jax_config5(), 8, 64, dist="zipf", spread=8.0)
    for got, want in zip(arrays, jarrays):
        np.testing.assert_array_equal(got, want)
    pe = PallasEngine(jax_config5(), *jarrays, schedule=JSchedule(),
                      **CONFIG5_KW)
    pe.run(max_cycles=5_000_000)
    np.testing.assert_array_equal(eng.state["scalars"].numpy(),
                                  np.asarray(pe.state["scalars"]))
    assert rec["instructions"] == eng.instructions == pe.instructions
    assert rec["cycles"] == eng.cycle == pe.cycle
    assert rec["occupancy"] == pe.occupancy.as_dict()
    assert rec["trace_len_dist"] == {"dist": "zipf", "spread": 8.0}


@pytest.mark.parametrize("mode", ["multichip", "nodeshard", "nodeshard_ab"])
def test_multi_device_modes_raise(mode, capsys):
    if mode == "multichip":
        # the data axis is ported: the ladder runs, every rung bit-exact
        # with one device's run of the same arrays
        assert scale_runs.main([mode, "--device", "cpu"]) == 0
        rec = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert rec["bit_exact_vs_one_card"] and not rec["indicative"]
        assert [(r["scaling"], r["data_shards"]) for r in rec["rows"]] == [
            (s, d) for s in ("weak", "strong") for d in (1, 2, 4)]
        assert all(r["host_syncs"] == 1 for r in rec["rows"])
        return
    if mode == "nodeshard":
        # the fast path's node axis is ported: one device, then two
        # ranks, each rung's planes equal to the first's
        assert scale_runs.main([mode, "--device", "cpu"]) == 0
        rec = json.loads(capsys.readouterr().out.splitlines()[-1])
        assert rec["bit_exact_vs_one_card"] and not rec["indicative"]
        assert [r["node_shards"] for r in rec["shards"]] == [1, 2]
        two = rec["shards"][1]
        assert two["collectives_per_cycle"] == dict(
            two["plan_collectives"], sum=1, max=1, min=0)
        # one read a k-cycle call, the window's first gate, the status
        assert two["host_syncs"] == two["calls"] + 2
        assert two["cross_shard_msgs"] > 0
        return
    rec = scale_runs.nodeshard_ab(nodes=8, batch=2, instrs_per_core=4,
                                  ranks=(2,), reps=1, device="cpu")
    assert rec["bit_exact_vs_one_card"]
    row = rec["shards"][0]
    assert [row[k]["exchange_mode"] for k in (
        "old_pairwise", "new_a2a", "new_butterfly", "new_hier")] == [
        "pairwise", "a2a", "butterfly", "hier"]
    assert row["old_pairwise"]["collectives_per_cycle"]["ppermute"] == 2


def test_data_shards_raise(capsys):
    """``config5`` over two data shards equals one device's run (the
    data axis is ported); an unknown configuration still exits 2."""
    one, eng1, _ = scale_runs.config5_run(batch=8, instrs_per_core=8,
                                          device="cpu")
    two, eng2, _ = scale_runs.config5_run(batch=8, instrs_per_core=8,
                                          data_shards=2, device="cpu")
    assert two["data_shards"] == 2
    assert (two["instructions"], two["cycles"]) == (
        one["instructions"], one["cycles"])
    for f, v in eng1.state.items():
        assert torch.equal(eng2.state[f], v), f
    assert scale_runs.main(["6", "--device", "cpu"]) == 2


def test_card_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this refusal needs none")
    for fn in (scale_runs.config4, scale_runs.config5):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn()
