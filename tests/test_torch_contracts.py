"""The port's program contracts (``hpa2_tpu_torch/analysis/
contracts.py`` over ``analysis/ir.py``) on the CPU, mirroring
``tests/test_contracts.py``:

* the registry holds the JAX package's 12 points, and all four sharded
  ones run (the three node-sharded points in one group of four gloo
  ranks);
* the pin files are present and digest-fresh;
* the CPU census is clean (the card rules, which read what only the
  card has, are skipped and say so);
* each seeded mutation makes a check fail with a drift diff naming the
  key that moved, and the mutation is undone after;
* the walker's pieces (op census, launch census, ptxas parsing) and the
  counter-backfill lint rule.
"""

import subprocess
import sys

import pytest

from hpa2_tpu.analysis.contracts import registry as jx_registry
from hpa2_tpu_torch.analysis import contracts, ir
from hpa2_tpu_torch.analysis.contracts import (
    check_contract, load_pins, registry, seeded_mutation, spec_digest,
)
from hpa2_tpu_torch.analysis.lint import lint_counter_backfill
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def _by_name(name):
    c = next((c for c in registry() if c.name == name), None)
    assert c is not None, f"contract {name!r} missing from registry"
    return c


def _rules(c):
    return {r.key: (r.op, r.expect) for r in c.rules}


def test_registry_has_the_jax_packages_points():
    cs = registry()
    assert [c.name for c in cs] == [c.name for c in jx_registry()]
    assert len(cs) == 12
    assert [c.engine for c in cs] == [c.engine for c in jx_registry()]
    sharded = [c for c in cs if c.engine == "sharded"]
    assert len(sharded) == 4
    # every point has its measure (the fast path's node point since its
    # node axis is ported)
    assert [c.name for c in cs if c.measure is None] == []


def test_rules_carry_the_ports_claims():
    assert _rules(_by_name("xla-run-loop"))["elided.jump_min"] == ("==", 1)
    dma = _rules(_by_name("pallas-stream-dma"))
    assert dma["calls.stream_run"] == ("==", 1)
    assert dma["calls.call_run"] == ("==", 0)
    assert dma["host_syncs"] == ("==", 1)
    body = _rules(_by_name("pallas-cycle-body"))
    assert body["stream_run.registers"] == ("<=", 128)
    assert body["call_run.spill_bytes"] == ("<=", 52)
    assert all(r.card for r in _by_name("pallas-cycle-body").rules)
    assert _rules(_by_name("pallas-vmem-budget"))["max_block.equal"] == \
        ("==", 1)
    assert _rules(_by_name("xla-run-interconnect"))["gather.extra"] == \
        ("==", 0)


def test_pin_files_present_and_digest_fresh():
    for c in registry():
        pinned = [r.key for r in c.rules if r.expect is None]
        if not pinned:
            continue
        doc = load_pins(c)
        assert doc is not None, f"{c.name}: pinned rules but no pin file"
        assert doc.get("digest") == spec_digest(c), c.name
        assert not [k for k in pinned if k not in doc.get("pins", {})]


def test_cpu_census_is_clean_and_sharded_points_skip():
    lines = []
    results = contracts.run_contracts(device="cpu", out=lines.append)
    status = {r.contract: r.status for r in results}
    # the data-sharded point and the three node-sharded points (four
    # gloo ranks) run on the CPU: nothing is skipped
    assert sorted(s for s in status.values()) == ["ok"] * 12
    assert status["node-sharded-pallas-a2a"] == "ok"
    obs = contracts.measure_node_sharded_pallas("cpu").values
    # JAX's traced census (all_to_all 2, psum 2, pmax 3) as what runs:
    # a cycle, a window's seed with its first gate, a later gate
    assert (obs["all_to_all"], obs["sum"], obs["max"]) == (2, 1, 1)
    assert (obs["seed.sum"], obs["seed.max"], obs["gate.max"]) == (1, 1, 1)
    assert any("card rule(s) skipped on cpu" in ln for ln in lines)


@pytest.mark.parametrize("name", ["xla-run-loop", "pallas-stream-dma"])
def test_measurement_is_drift_free(name):
    c = _by_name(name)
    assert not check_contract(c, c.measure("cpu"))


def test_odd_seed_strips_elision_and_the_loop_drifts():
    c = _by_name("xla-run-loop")
    with seeded_mutation(1) as what:
        drifts = check_contract(c, c.measure("cpu"))
    assert what.endswith("step.build_run")
    keys = {d.key for d in drifts}
    assert {"elided.jump_min", "elided.extra_ops"} <= keys, keys
    diff = "\n".join(d.render() for d in drifts)
    assert "elided.jump_min: expected == 1, found 0" in diff
    assert not check_contract(c, c.measure("cpu"))


def test_even_seed_forces_per_call_and_the_stream_drifts():
    c = _by_name("pallas-stream-dma")
    with seeded_mutation(0) as what:
        drifts = check_contract(c, c.measure("cpu"))
    assert what.endswith("cuda_engine.run_program")
    keys = {d.key for d in drifts}
    assert {"calls.stream_run", "calls.call_run", "host_syncs"} <= keys
    diff = "\n".join(d.render() for d in drifts)
    assert "calls.stream_run: expected == 1, found 0" in diff
    assert not check_contract(c, c.measure("cpu"))


def test_a_stale_pin_file_drifts(tmp_path, monkeypatch):
    monkeypatch.setattr(contracts, "CONTRACT_DIR", str(tmp_path))
    c = _by_name("xla-run-loop")
    drifts = check_contract(c, c.measure("cpu"))
    assert [d.key for d in drifts] == ["<pin-file>"]
    contracts.write_pins(c, c.measure("cpu"))
    assert not check_contract(c, c.measure("cpu"))


def test_card_rules_are_skipped_off_the_card():
    c = _by_name("pallas-cycle-body")
    obs = c.measure("cpu")
    assert obs.values == {} and obs.device == "cpu"
    assert len(contracts.skipped_rules(c, obs)) == len(c.rules)
    assert not check_contract(c, obs)


def test_op_census_and_launch_census():
    import torch

    from hpa2_tpu_torch.config import Semantics, SystemConfig
    from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
    from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays

    x = torch.arange(6)
    _, census = ir.op_census(lambda: (x + 1).min().view(1).sort())
    assert census.names == ["aten.add", "aten.min", "aten.sort"]
    assert ir.count_ops(census, ("min", "aten.sort")) == 2
    assert ir.op_paths(census, ("sort",)) == ["op[2]:aten.sort"]
    cfg = SystemConfig(num_procs=4, semantics=Semantics().robust())
    arrays = gen_uniform_random_arrays(cfg, 4, 8, seed=0)
    with ir.launch_census() as c:
        CudaEngine(cfg, *arrays, block=4, snapshots=False,
                   stream=False, trace_window=4, device="cpu").run()
    assert c["calls.call_run"] >= 2 and c["calls.stream_run"] == 0
    assert c["launches.call_run"] == 0  # the plain version on the CPU
    assert c["host_syncs"] == c["calls.call_run"] + 2 + 1


def test_ptxas_census_parses_a_build_log():
    log = (
        "ptxas info    : Compiling entry function '_Z1kILi8ELb0EEv' for "
        "'sm_90a'\n"
        "ptxas info    : Function properties for _Z1kILi8ELb0EEv\n"
        "    16 bytes stack frame, 4 bytes spill stores, 8 bytes spill "
        "loads\n"
        "ptxas info    : Used 128 registers, 536 bytes cmem[0]\n"
        "ptxas info    : Compiling entry function '_Z1kILi64ELb1EEv' for "
        "'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads\n"
        "ptxas info    : Used 96 registers, 536 bytes cmem[0]\n")
    got = ir.ptxas_census(log)
    assert [(f["registers"], f["stack"], f["spill_stores"],
             f["spill_loads"]) for f in got] == [(128, 16, 4, 8),
                                                 (96, 0, 0, 0)]


def _write_stats_pair(root, backfill_names):
    ops = root / "hpa2_tpu_torch" / "ops"
    utils = root / "hpa2_tpu_torch" / "utils"
    ops.mkdir(parents=True)
    utils.mkdir(parents=True)
    (ops / "engine.py").write_text(
        "def engine_stats(st):\n"
        "    core = {\"cycle\": st.cycle}\n"
        "    out = dict(core)\n"
        "    if st.n_shiny:\n"
        "        out[\"n_shiny\"] = int(st.n_shiny)\n"
        "    return out\n"
    )
    names = ", ".join(f"\"{n}\"" for n in backfill_names)
    (utils / "checkpoint.py").write_text(
        f"_ZERO_BACKFILL = frozenset({{{names}}})\n")


def test_counter_backfill_flags_an_unbackfilled_counter(tmp_path):
    _write_stats_pair(tmp_path, ["n_other"])
    findings = lint_counter_backfill(str(tmp_path))
    assert len(findings) == 1 and "n_shiny" in findings[0].message


def test_counter_backfill_clean_when_backfilled(tmp_path):
    _write_stats_pair(tmp_path, ["n_shiny"])
    assert lint_counter_backfill(str(tmp_path)) == []


def test_counter_backfill_clean_on_the_port():
    assert lint_counter_backfill(".") == []


def test_drift_render_carries_location_and_why():
    d = contracts.Drift("c", "sort", "==", 0, 2, where="op[7]:aten.sort",
                        why="no sort in the loop")
    out = d.render()
    assert "sort: expected == 0, found 2" in out
    assert "op[7]:aten.sort" in out and "no sort in the loop" in out


def test_cli_contracts_on_the_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "hpa2_tpu_torch.analysis", "contracts",
         "--device", "cpu"], capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "12 contract(s) clean, 0 drifted, 0 skipped" in proc.stdout
