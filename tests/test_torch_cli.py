"""``python -m hpa2_tpu_torch run --device cpu`` writes the same dump
bytes as ``python -m hpa2_tpu.cli run --backend spec`` (and, on a
33-node system, ``--backend pallas``) on a synthesized trace directory,
and ``bench --device cpu`` retires every instruction, on uniform and on
zipf trace lengths, unscheduled and under the occupancy scheduler."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from hpa2_tpu import cli as jcli
from hpa2_tpu_torch import cli

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent


def _write_traces(d: pathlib.Path, seed: int, n=4, t=12, n_addr=64):
    rng = np.random.default_rng(seed)
    for core in range(n):
        lines = []
        for _ in range(t):
            a = int(rng.integers(0, n_addr))
            if rng.random() < 0.5:
                lines.append(f"WR 0x{a:02X} {int(rng.integers(0, 256))}")
            else:
                lines.append(f"RD 0x{a:02X}")
        (d / f"core_{core}.txt").write_text("\n".join(lines) + "\n")


def _outputs(d: pathlib.Path):
    return {p.name: p.read_bytes() for p in sorted(d.glob("core_*_output.txt"))}


@pytest.mark.parametrize("final_dump", [False, True])
def test_run_matches_spec_cli_bytes(tmp_path, final_dump):
    traces = tmp_path / "traces"
    traces.mkdir()
    _write_traces(traces, seed=11 + final_dump)
    extra = ["--final-dump"] if final_dump else []
    want_dir, got_dir = tmp_path / "spec", tmp_path / "port"
    assert jcli.main(["run", str(traces), "--backend", "spec", "--robust",
                      "--out", str(want_dir)] + extra) == 0
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO_ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run(
        [sys.executable, "-m", "hpa2_tpu_torch", "run", str(traces),
         "--device", "cpu", "--robust", "--out", str(got_dir)] + extra,
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "[cpu]" in proc.stderr
    want = _outputs(want_dir)
    assert len(want) == 4
    assert _outputs(got_dir) == want


@pytest.mark.filterwarnings(
    "ignore:pltpu.ANY is deprecated:DeprecationWarning")
def test_run_33_nodes_matches_pallas_cli_bytes(tmp_path):
    """A split-plane system (two sharer words) through both CLIs."""
    traces = tmp_path / "traces"
    traces.mkdir()
    _write_traces(traces, seed=5, n=33, t=4, n_addr=33 * 4)
    geom = ["--nodes", "33", "--cache-size", "2", "--mem-size", "4",
            "--msg-buffer-size", "16", "--robust"]
    want_dir, got_dir = tmp_path / "pallas", tmp_path / "port"
    assert jcli.main(["run", str(traces), "--backend", "pallas",
                      "--out", str(want_dir)] + geom) == 0
    assert cli.main(["run", str(traces), "--device", "cpu",
                     "--out", str(got_dir)] + geom) == 0
    want = _outputs(want_dir)
    assert len(want) == 33
    assert _outputs(got_dir) == want


def test_bench_cpu_retires_every_instruction(capsys):
    assert cli.main(["bench", "--batch", "4", "--instrs", "16", "--seed",
                     "3", "--nodes", "4", "--msg-buffer-size", "16",
                     "--robust", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["backend"] == "cpu"
    assert rec["instrs"] == 4 * 4 * 16
    assert rec["ops_per_sec"] > 0


@pytest.mark.parametrize("extra", [
    [],
    ["--schedule-resident", "8"],
    ["--schedule-resident", "8", "--host-barriers"],
    ["--schedule-resident", "64"],
])
def test_bench_cpu_zipf_lengths(capsys, extra):
    """``--trace-len-dist zipf`` with the headline's shape flags; a
    scheduled run's JSON line carries its occupancy counters."""
    from hpa2_tpu_torch.utils.trace import heterogeneous_lengths

    assert cli.main(["bench", "--batch", "16", "--instrs", "24", "--seed",
                     "1", "--nodes", "4", "--msg-buffer-size", "16",
                     "--robust", "--block", "4", "--trace-window", "8",
                     "--cycles-per-call", "32", "--trace-len-dist", "zipf",
                     "--trace-len-spread", "3", "--device", "cpu"]
                    + extra) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    lens = heterogeneous_lengths(16, 24, "zipf", 3.0, seed=1)
    assert rec["workload"] == "zipf"
    assert rec["instrs"] == 4 * int(lens.sum())
    if not extra:
        assert "occupancy" not in rec
        return
    occ = rec["occupancy"]
    fused = "--host-barriers" not in extra
    assert occ["host_barriers"] == (0 if fused else occ["intervals"])
    assert occ["admissions"] == (8 if extra[1] == "8" else 0)
