"""The two card scripts of the port on the CPU, at tiny shapes:
``scripts/perf_sweep.py`` (throughput and the per-stage ablation
attribution; the plain versions, so no device time) and
``scripts/gpu_differential.py`` (K2 against the general engine; the
comparison itself on the plain version, and its refusal to run
without a card)."""

import numpy as np
import pytest
import torch

from hpa2_tpu_torch.config import Semantics, SystemConfig
from hpa2_tpu_torch.scripts import gpu_differential, perf_sweep
from hpa2_tpu_torch.utils.trace import gen_eviction_pingpong_arrays
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

JAX_KEYS = {"batch", "instrs_per_core", "block", "cap", "cycles_per_call",
            "window", "gate", "instructions", "seconds", "warm_seconds",
            "ops_per_sec", "cycles", "us_per_cycle"}
JAX_ABLATE_KEYS = {"ablate", "batch", "block", "cap", "window", "run_s",
                   "cycles_run", "us_per_cycle"}


def test_measure_keeps_the_jax_keys():
    rec = perf_sweep.measure(16, 8, 8, 8, window=4, device="cpu")
    assert JAX_KEYS <= set(rec)
    assert rec["instructions"] == 16 * 8 * 8
    assert rec["cycles"] > 0 and rec["device"] == "cpu"
    assert "card" not in rec  # no device name on a CPU run


def test_attribution_runs_every_set_in_turns():
    recs = perf_sweep.attribution(
        reps=2, device="cpu", shapes=(((8, 8, 8, 8, 16, 4), 4),
                                      ((2, 4, 2, 8, 16, 4), 22)))
    sets = [tuple(r["ablate"]) for r in recs]
    n = len(perf_sweep.ATTRIBUTION_SETS)
    assert len(recs) == 4 * n
    assert sets[:n] == [tuple(sorted(s)) for s in perf_sweep.ATTRIBUTION_SETS]
    assert sets[n:2 * n] == sets[:n][::-1]
    for r in recs:
        assert JAX_ABLATE_KEYS <= set(r)
        if r["ablate"]:  # four calls of k 8, then the stall
            assert r["cycles_run"] == 32 and r["stalled"], r
        else:
            assert 0 < r["cycles_run"] <= 32, r
    assert {r["num_procs"] for r in recs} == {4, 22}


def test_cli_parses_the_jax_arguments(monkeypatch):
    got = []
    monkeypatch.setattr(perf_sweep, "measure_ablate",
                        lambda *a, **k: got.append(a))
    monkeypatch.setattr(perf_sweep, "measure", lambda *a, **k: got.append(a))
    perf_sweep.main(["--ablate", "phase_a", "deliver", "1024", "64"])
    perf_sweep.main(["--ablate"])
    perf_sweep.main(["64", "16", "8", "8"])
    perf_sweep.main([])
    assert got == [
        (1024, 64, 512, 128, 16, 32, ["phase_a", "deliver"]),
        (8192, 128, 512, 128, 16, 32, []),
        (64, 16, 8, 8), (8192, 128, 128, 128)]


def test_scripts_refuse_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        perf_sweep.measure_ablate(8, 8, 8, 8, 16, 4, ["phase_b"])
    with pytest.raises(ValueError, match="unknown ablation stage"):
        perf_sweep.measure_ablate(8, 8, 8, 8, 16, 4, ["phase_q"],
                                  device="cpu")
    assert gpu_differential.main([]) == 2


def test_gpu_differential_compares_on_the_plain_version():
    """The comparison at the script's geometries, cut to a few systems:
    K2's plain version (no launch, so ``ok`` is false off the card) and
    the general engine agree on every dump field, count and stall."""
    for tag, cfg, arrays in gpu_differential.cases():
        small = tuple(np.ascontiguousarray(x[:3]) for x in arrays)
        rec = gpu_differential.compare(tag, cfg, small, device="cpu")
        assert rec["node_mismatches"] == 0, rec
        assert rec["counts_agree"] and rec["stalls_agree"], rec
        assert rec["plain_checked"] == 1 and rec["max_abs_err"] == 0, rec
        assert rec["k2_launches"] == 0 and not rec["ok"]
        assert rec["instr_k2"] == rec["instr_general"] > 0


def test_gpu_differential_agrees_on_deadlocks(monkeypatch):
    """Eviction ping-pong at 8 nodes and 4 mailbox slots deadlocks two
    systems of the first 20 (seed 7001): both engines stall on exactly
    those, and agree on the rest."""
    monkeypatch.setattr(gpu_differential, "MAX_CYCLES", 256)
    monkeypatch.setattr(gpu_differential, "WATCHDOG", 32)
    cfg = SystemConfig(num_procs=8, cache_size=2, mem_size=8,
                       msg_buffer_size=4, semantics=Semantics().robust())
    arrays = gen_eviction_pingpong_arrays(cfg, 20, 16, seed=7001)
    rec = gpu_differential.compare("deadlock", cfg, arrays, device="cpu")
    assert rec["stalled_systems"] == 2 and rec["stalls_agree"], rec
    assert rec["node_mismatches"] == 0 and rec["counts_agree"], rec
