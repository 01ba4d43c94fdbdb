"""The port's static analysis suite: table checks, lint, the mutation
self-test and the analysis CLI (``python -m hpa2_tpu_torch.analysis``),
mirroring ``tests/test_analysis.py``, with the port's results held
against the JAX package's where both compute the same thing."""

import os
import re
import subprocess
import sys

import pytest

from hpa2_tpu.analysis.mutate import run_all_mutations as jx_mutations
from hpa2_tpu.analysis.mutate import run_fuzz as jx_run_fuzz
from hpa2_tpu.config import Semantics as JxSemantics
from hpa2_tpu_torch.analysis.checks import run_static_checks
from hpa2_tpu_torch.analysis.lint import HOST_SYNC_SCOPE, run_lint
from hpa2_tpu_torch.analysis.mutate import (
    MUTATIONS, run_all_mutations, run_fuzz,
)
from hpa2_tpu_torch.analysis.table import CASE_UNIVERSE, build_table
from hpa2_tpu_torch.config import Semantics
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SEMS = {
    "default": Semantics(),
    "robust": Semantics().robust(),
    "head": Semantics().head_quirks(),
}
PROTOCOLS = ("mesi", "moesi", "mesif")


@pytest.mark.parametrize("name", sorted(SEMS))
def test_shipped_table_has_no_errors(name):
    findings = run_static_checks(build_table(SEMS[name]))
    errors = [f for f in findings if f.severity == "error"]
    assert not errors, "\n".join(str(f) for f in errors)


def test_drop_policy_warnings_are_the_only_warnings():
    warn = [f for f in run_static_checks(build_table(SEMS["default"]))
            if f.severity == "warning"]
    assert warn and all(f.check == "reply-guarantee" for f in warn)
    assert not [f for f in run_static_checks(build_table(SEMS["robust"]))
                if f.severity == "warning"]


def test_case_universe_is_semantics_invariant():
    for name, sem in SEMS.items():
        t = build_table(sem)
        covered = {r.key for r in t.rows}
        for (role, event), per_state in CASE_UNIVERSE.items():
            for state, cases in per_state.items():
                for case in cases:
                    assert (role, state, event, case) in covered \
                        or t.is_unreachable(role, state, event, case), \
                        (name, role, state, event, case)


def test_lint_clean_on_the_port():
    findings = run_lint(".")
    assert not findings, "\n".join(str(f) for f in findings)


def _tree(tmp_path, rel, text):
    (tmp_path / "hpa2_tpu_torch" / "ops").mkdir(parents=True, exist_ok=True)
    (tmp_path / "hpa2_tpu_torch" / "models").mkdir(parents=True,
                                                   exist_ok=True)
    (tmp_path / rel).write_text(text)
    return run_lint(str(tmp_path))


def test_lint_catches_seeded_pitfalls(tmp_path):
    bad = (
        "import time, random\n"
        "import numpy as np\n"
        "def step(st, config):\n"
        "    t = time.time()\n"
        "    x = random.randint(0, 3)\n"
        "    y = np.zeros(4, dtype=int)\n"
        "    z = st.astype(int)\n"
        "    w = st['cmetaw'] + 1\n"
    )
    rules = {f.rule for f in _tree(tmp_path, "hpa2_tpu_torch/ops/bad.py",
                                   bad)}
    assert {"nondeterminism", "dtype-drift", "dtype-widening"} <= rules


def test_lint_host_sync_flags_unaccounted_reads(tmp_path):
    """In the scoped run loop, ``if``/``bool``/``int``/``.item()``/
    ``.tolist()`` on a device tensor are findings; the same reads
    through ``HOST_SYNCS.read``, and host values, are not."""
    rel = os.path.join("hpa2_tpu_torch", "ops", "call_run.py")
    assert "run_windows" in HOST_SYNC_SCOPE[rel]
    bad = (
        "import torch\n"
        "def run_windows(config, state, tr, tr_len, *, block):\n"
        "    busy = (state['nsw'] != 0).any()\n"
        "    if busy:\n"
        "        pass\n"
        "    n = int(tr_len.sum())\n"
        "    v = torch.zeros(3).item()\n"
        "    rows = state['scalars'].tolist()\n"
        "    while bool(busy):\n"
        "        break\n"
    )
    hits = [f for f in _tree(tmp_path, rel, bad) if f.rule == "host-sync"]
    assert sorted(f.line for f in hits) == [4, 6, 7, 8, 9]
    good = (
        "from hpa2_tpu_torch.ops import kernels\n"
        "def run_windows(config, state, tr, tr_len, *, block):\n"
        "    busy = (state['nsw'] != 0).any()\n"
        "    done = not kernels.HOST_SYNCS.read(busy)\n"
        "    if done or block > 1 or tr.shape[0]:\n"
        "        pass\n"
        "    status = kernels.HOST_SYNCS.read(state['nsw'])\n"
        "    if status[0]:\n"
        "        pass\n"
        "    def quiet():\n"
        "        return not kernels.HOST_SYNCS.read(busy)\n"
        "    while not quiet():\n"
        "        break\n"
    )
    assert not [f for f in _tree(tmp_path, rel, good)
                if f.rule == "host-sync"]


def test_lint_host_sync_scope_is_the_card_paths(tmp_path):
    """The same read outside the scoped functions (a stats read after a
    run) is not a finding."""
    text = (
        "def engine_stats(st):\n"
        "    if st.n_msgs.any():\n"
        "        return int(st.n_msgs.sum())\n"
    )
    assert not _tree(tmp_path, "hpa2_tpu_torch/ops/call_run.py", text)


def test_lint_dead_handler_detection(tmp_path):
    src = open("hpa2_tpu_torch/models/spec_engine.py").read()
    mutated, n = re.subn(r"MsgType\.NACK: \"_on_nack\",\n", "", src)
    assert n == 1
    msgs = [f.message for f in _tree(
        tmp_path, "hpa2_tpu_torch/models/spec_engine.py", mutated)
        if f.rule == "dead-handler"]
    assert any("_on_nack" in m for m in msgs)
    assert any("MsgType.NACK" in m for m in msgs)


def test_lint_hand_written_state_in_the_cycle(tmp_path):
    text = ("from hpa2_tpu_torch.models.protocol import CacheState\n"
            "M = CacheState.MODIFIED\n")
    rules = [f.rule for f in _tree(tmp_path, "hpa2_tpu_torch/ops/cycle.py",
                                   text)]
    assert rules.count("hand-written-state") == 2


def test_lint_interconnect_purity(tmp_path):
    (tmp_path / "hpa2_tpu_torch" / "interconnect").mkdir(parents=True)
    (tmp_path / "hpa2_tpu_torch" / "interconnect" / "x.py").write_text(
        "import random\n")
    assert [f.rule for f in run_lint(str(tmp_path))] == [
        "interconnect-purity"]


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_every_seeded_mutation_is_caught_as_in_jax(protocol):
    """Every curated mutation is caught, by the same catcher as in the
    JAX package."""
    results = run_all_mutations(Semantics(), protocol)
    assert len(results) == len(MUTATIONS) >= 10
    assert not [r.name for r in results if not r.caught]
    want = jx_mutations(JxSemantics(), protocol)
    assert [(r.name, r.caught_by) for r in results] == \
        [(r.name, r.caught_by) for r in want]


def test_mutations_exercise_both_catchers():
    by = {r.caught_by for r in run_all_mutations()}
    assert by == {"static", "spec-diff"}


@pytest.mark.parametrize("protocol", PROTOCOLS)
def test_fuzzed_mutations_are_caught(protocol):
    """The seeded fuzzer draws the same corruptions as the JAX one, and
    the port catches every one (the ``jax`` prober on the CPU)."""
    sem = Semantics().robust()
    got = run_fuzz(sem, protocol, seed=3, count=25, device="cpu")
    assert all(r.caught for r in got), [r.name for r in got
                                        if not r.caught]
    want = jx_run_fuzz(JxSemantics().robust(), protocol, seed=3, count=25,
                       with_jax=False)
    assert [r.name for r in got] == [r.name for r in want]


@pytest.mark.parametrize("argv", [
    ["check"],
    ["lint"],
    ["mutation-test"],
    ["equiv", "--device", "cpu", "--backends", "pallas,jax",
     "--protocol", "mesi"],
    ["table"],
    ["topology", "--nodes", "4", "--rounds", "2"],
])
def test_cli_subcommands(argv):
    proc = subprocess.run(
        [sys.executable, "-m", "hpa2_tpu_torch.analysis"] + argv,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_cli_output_matches_the_jax_cli():
    """``check``'s report is the JAX CLI's, line for line."""
    def run(pkg):
        return subprocess.run(
            [sys.executable, "-m", f"{pkg}.analysis", "check"],
            capture_output=True, text=True, timeout=300).stdout

    assert run("hpa2_tpu_torch") == run("hpa2_tpu")


def test_cli_device_subcommands_want_the_card():
    """Without ``--device cpu`` the device subcommands run on the card,
    and raise without one."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    proc = subprocess.run(
        [sys.executable, "-m", "hpa2_tpu_torch.analysis", "equiv",
         "--backends", "pallas", "--protocol", "mesi"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and "CUDA is not available" in proc.stderr
