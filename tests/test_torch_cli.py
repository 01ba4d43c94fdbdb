"""``python -m hpa2_tpu_torch run --device cpu`` writes the same dump
bytes as ``python -m hpa2_tpu.cli run`` on a synthesized trace
directory: on the fast path (``--backend pallas``) as the JAX CLI's
``spec`` and, on a 33-node system, ``pallas`` backends; on the general
engine (``--backend jax``, the default) as its ``jax`` backend, with
protocol, directory-format, topology and fault flags and ``--replay``.
``bench --device cpu`` retires every instruction: on the fast path on
uniform and on zipf trace lengths, unscheduled and under the occupancy
scheduler; on the general engine with the JAX CLI's keys."""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from hpa2_tpu import cli as jcli
from hpa2_tpu_torch import cli
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

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
         "--backend", "pallas", "--device", "cpu", "--robust", "--out",
         str(got_dir)] + extra,
        capture_output=True, text=True, env=env, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "[pallas cpu]" in proc.stderr
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
    assert cli.main(["run", str(traces), "--backend", "pallas", "--device",
                     "cpu", "--out", str(got_dir)] + geom) == 0
    want = _outputs(want_dir)
    assert len(want) == 33
    assert _outputs(got_dir) == want


def test_bench_cpu_retires_every_instruction(capsys):
    assert cli.main(["bench", "--backend", "pallas", "--batch", "4",
                     "--instrs", "16", "--seed", "3", "--nodes", "4",
                     "--msg-buffer-size", "16", "--robust", "--device",
                     "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["backend"] == "pallas" and rec["device"] == "cpu"
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

    assert cli.main(["bench", "--backend", "pallas", "--batch", "16",
                     "--instrs", "24", "--seed", "1", "--nodes", "4",
                     "--msg-buffer-size", "16",
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


GENERAL_FLAGS = {
    "default": [],
    "moesi-mesh2d": ["--protocol", "moesi", "--topology", "mesh2d",
                     "--multicast", "--hop-latency", "2"],
    "faults-limited": ["--fault-drop", "0.2", "--fault-dup", "0.1",
                       "--fault-seed", "4", "--directory-format",
                       "limited:2", "--final-dump"],
    "mesif-hierarchical": ["--protocol", "mesif", "--topology",
                           "hierarchical", "--combining",
                           "--link-bandwidth", "2"],
}


@pytest.mark.parametrize("name", sorted(GENERAL_FLAGS))
def test_run_jax_backend_matches_jax_cli_bytes(tmp_path, name):
    """``run`` on the general engine (the default backend) writes the
    JAX CLI's ``--backend jax`` bytes."""
    traces = tmp_path / "traces"
    traces.mkdir()
    _write_traces(traces, seed=21)
    flags = ["--robust"] + GENERAL_FLAGS[name]
    want_dir, got_dir = tmp_path / "jax", tmp_path / "port"
    assert jcli.main(["run", str(traces), "--backend", "jax", "--out",
                      str(want_dir)] + flags) == 0
    assert cli.main(["run", str(traces), "--device", "cpu", "--out",
                     str(got_dir)] + flags) == 0
    want = _outputs(want_dir)
    assert len(want) == 4
    assert _outputs(got_dir) == want


def test_run_jax_backend_replays_an_order(tmp_path):
    """``--replay`` of an order the JAX CLI's spec backend recorded."""
    traces = tmp_path / "traces"
    traces.mkdir()
    _write_traces(traces, seed=8)
    order = tmp_path / "instruction_order.txt"
    assert jcli.main(["run", str(traces), "--backend", "spec", "--robust",
                      "--out", str(tmp_path / "spec"), "--record-order",
                      str(order)]) == 0
    want_dir, got_dir = tmp_path / "jax", tmp_path / "port"
    assert jcli.main(["run", str(traces), "--backend", "jax", "--robust",
                      "--replay", str(order), "--out", str(want_dir)]) == 0
    assert cli.main(["run", str(traces), "--backend", "jax", "--robust",
                     "--replay", str(order), "--device", "cpu", "--out",
                     str(got_dir)]) == 0
    assert _outputs(got_dir) == _outputs(want_dir)


JAX_BENCH_KEYS = {"backend", "workload", "nodes", "batch", "node_shards",
                  "data_shards", "instrs", "resumed_instrs", "seconds",
                  "ops_per_sec"}


@pytest.mark.parametrize("batch", [1, 3])
def test_bench_jax_backend_prints_the_jax_keys(capsys, batch):
    args = ["bench", "--batch", str(batch), "--instrs", "12", "--seed",
            "2", "--nodes", "4", "--robust", "--fault-drop", "0.1"]
    assert jcli.main(args) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert cli.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(got) == JAX_BENCH_KEYS | {"device"}
    assert set(want) == JAX_BENCH_KEYS
    for k in JAX_BENCH_KEYS - {"seconds", "ops_per_sec"}:
        assert got[k] == want[k], k
    assert got["device"] == "cpu" and got["ops_per_sec"] > 0


@pytest.mark.parametrize("args,match", [
    (["bench", "--trace-len-dist", "zipf", "--batch", "2"],
     "fast-path flag"),
    (["bench", "--schedule-resident", "2", "--batch", "2"],
     "fast-path flag"),
    (["bench", "--backend", "pallas", "--topology", "mesh2d"], "jax"),
    (["run", "TRACES", "--backend", "pallas", "--protocol", "moesi"],
     "jax"),
    (["run", "TRACES", "--backend", "pallas", "--fault-drop", "0.1"],
     "jax"),
    (["run", "TRACES", "--backend", "pallas", "--replay", "ORDER"],
     "jax"),
])
def test_cli_refuses_what_a_backend_lacks(tmp_path, args, match):
    traces = tmp_path / "traces"
    traces.mkdir()
    _write_traces(traces, seed=1)
    args = [str(traces) if a == "TRACES" else a for a in args]
    if "ORDER" in args:
        order = tmp_path / "order.txt"
        order.write_text("")
        args[args.index("ORDER")] = str(order)
    with pytest.raises(SystemExit, match=match):
        cli.main(args + ["--device", "cpu", "--robust"])


def _serve_feed(path, n_jobs=8):
    """A JSONL feed of ``n_jobs`` zipf-length 4-node jobs."""
    from hpa2_tpu_torch.config import Semantics, SystemConfig
    from hpa2_tpu_torch.serving import job_to_record, synthetic_jobs

    cfg = SystemConfig(num_procs=4, semantics=Semantics().robust())
    jobs = synthetic_jobs(cfg, n_jobs, 24, seed=7, spread=3.0)
    path.write_text("".join(json.dumps(job_to_record(j)) + "\n"
                            for j in jobs))
    return [j.job_id for j in jobs]


def _tree(d: pathlib.Path):
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


@pytest.mark.filterwarnings(
    "ignore:pltpu.ANY is deprecated:DeprecationWarning")
def test_serve_matches_jax_serve_dump_files(tmp_path, capsys):
    """``serve JOBS.jsonl --out DIR`` writes the same dump files as
    ``python -m hpa2_tpu.cli serve`` (its ``pallas`` backend), and its
    last line is the stats JSON with every job completed."""
    feed = tmp_path / "jobs.jsonl"
    ids = _serve_feed(feed)
    flags = ["--robust", "--resident", "4", "--window", "8", "--block", "4",
             "--immediate"]
    want_dir, got_dir = tmp_path / "jax", tmp_path / "port"
    assert jcli.main(["serve", str(feed), "--out", str(want_dir)]
                     + flags) == 0
    jstats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(REPO_ROOT)] + [p for p in [env.get("PYTHONPATH")] if p])
    proc = subprocess.run(
        [sys.executable, "-m", "hpa2_tpu_torch", "serve", str(feed),
         "--device", "cpu", "--out", str(got_dir),
         "--results-jsonl", str(tmp_path / "results.jsonl")] + flags,
        capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    stats = json.loads(proc.stdout.strip().splitlines()[-1])
    assert stats["jobs_completed"] == 8 and stats["backend"] == "pallas"
    assert stats["occupancy"] == jstats["occupancy"]
    assert stats["compile_counts"] == {"runner": 1, "barrier": 1,
                                       "take_lane": 1}
    want = _tree(want_dir)
    assert len(want) == 8 * 4
    assert sorted({k.split(os.sep)[0] for k in want}) == sorted(ids)
    assert _tree(got_dir) == want
    records = [json.loads(line) for line in
               (tmp_path / "results.jsonl").read_text().splitlines()]
    assert sorted(r["id"] for r in records) == sorted(ids)


# the data axis and the fast path's node axis are ported (serve
# --data-shards/--node-shards, --migrate-to jax:2 and pallas:1:2): the
# three cases that pinned the node axis's refusal keep their ids and now
# serve, each job's dumps equal to the unsharded serve's
@pytest.mark.parametrize("extra,match", [
    pytest.param(["--data-shards", "2", "--node-shards", "2",
                  "--resident", "2"], None, id="extra0-item 4"),
    pytest.param(["--node-shards", "2"], None, id="extra1-item 4"),
    pytest.param(["--failure-plan", "kill@1", "--migrate-to", "pallas:1:2"],
                 None, id="extra2-item 4"),
    (["--failure-plan", "kill@1", "--migrate-to", "tpu"],
     "backend jax|pallas"),
    (["--failure-plan", "frob@1"], "--failure-plan"),
    (["--wire"], "--listen"),
])
def test_serve_refuses_what_the_port_lacks(tmp_path, extra, match):
    feed = tmp_path / "jobs.jsonl"
    _serve_feed(feed, 1)
    if match is None:
        base, got = tmp_path / "base", tmp_path / "got"
        run = ["serve", str(feed), "--robust", "--device", "cpu", "--out"]
        assert cli.main(run + [str(base)]) == 0
        assert cli.main(run + [str(got)] + extra) == 0
        assert _tree(got) == _tree(base) and len(_tree(base)) == 4
        return
    with pytest.raises(SystemExit, match=match):
        cli.main(["serve", str(feed), "--device", "cpu"] + extra)
