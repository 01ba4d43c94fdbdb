"""The entry points of the port's multi-GPU slice on the CPU (logical
data shards, gloo ranks): ``run --node-shards`` writes the JAX CLI's
``run --node-shards`` dump files; ``serve --data-shards`` the same dump
files as one shard; ``bench --backend jax --node-shards/--data-shards``
(``NodeShardedEngine``/``GridEngine``) and ``bench --backend pallas
--data-shards`` print the JAX CLI's keys with the sharded work;
``--migrate-to``'s data-shard targets; the ``--measure-dp`` child of
``scripts/gpu_session.py``; ``scripts/scale_runs.py
nodeshard_general``; and the engines joining a ``torchrun`` group."""

import json
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest

from hpa2_tpu import cli as jcli
from hpa2_tpu_torch import cli
from hpa2_tpu_torch.scripts import gpu_session, scale_runs
from torch_pairs import IGNORE_PLTPU_ANY
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings(IGNORE_PLTPU_ANY)


def _traces(d: pathlib.Path, n=8, t=10, seed=3):
    d.mkdir(parents=True)
    rng = np.random.default_rng(seed)
    for core in range(n):
        lines = [f"WR 0x{int(a):02X} {int(v)}" if w else f"RD 0x{int(a):02X}"
                 for a, v, w in zip(rng.integers(0, 64, t),
                                    rng.integers(0, 256, t),
                                    rng.random(t) < 0.5)]
        (d / f"core_{core}.txt").write_text("\n".join(lines) + "\n")
    return d


def _tree(d: pathlib.Path):
    return {str(p.relative_to(d)): p.read_bytes()
            for p in sorted(d.rglob("*")) if p.is_file()}


def _line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("mode", ["a2a", "pairwise"])
def test_run_node_shards_matches_jax_command(tmp_path, mode):
    traces = _traces(tmp_path / "traces")
    flags = ["--nodes", "8", "--mem-size", "16", "--robust",
             "--node-shards", "2"]
    want, got = tmp_path / "jax", tmp_path / "port"
    assert jcli.main(["run", str(traces), "--out", str(want)] + flags) == 0
    assert cli.main(["run", str(traces), "--out", str(got), "--device",
                     "cpu", "--exchange-mode", mode] + flags) == 0
    assert len(_tree(want)) == 8 and _tree(got) == _tree(want)


def test_serve_data_shards_writes_one_shards_dumps(tmp_path, capsys):
    from hpa2_tpu_torch.config import Semantics, SystemConfig
    from hpa2_tpu_torch.serving import job_to_record, synthetic_jobs

    cfg = SystemConfig(num_procs=4, semantics=Semantics().robust())
    feed = tmp_path / "jobs.jsonl"
    feed.write_text("".join(
        json.dumps(job_to_record(j)) + "\n"
        for j in synthetic_jobs(cfg, 8, 24, seed=7, spread=3.0)))
    flags = ["serve", str(feed), "--robust", "--resident", "4", "--window",
             "8", "--block", "2", "--immediate", "--device", "cpu"]
    out = {}
    for shards in ("1", "2"):
        out[shards] = tmp_path / shards
        assert cli.main(flags + ["--out", str(out[shards]),
                                 "--data-shards", shards]) == 0
        stats = _line(capsys)
        assert stats["jobs_completed"] == 8
        assert stats["backend"] == ("pallas" if shards == "1"
                                    else "pallas-sharded")
    assert len(_tree(out["1"])) == 8 * 4
    assert _tree(out["2"]) == _tree(out["1"])


@pytest.mark.parametrize("flags,shards", [
    (["--node-shards", "2", "--batch", "1"], {"node_shards": 2,
                                              "data_shards": 1}),
    (["--node-shards", "2", "--data-shards", "2", "--batch", "4"],
     {"node_shards": 2, "data_shards": 2}),
])
def test_bench_sharded_general_engine(capsys, flags, shards):
    assert cli.main(["bench", "--backend", "jax", "--nodes", "4",
                     "--instrs", "8", "--robust", "--device", "cpu"]
                    + flags) == 0
    rec = _line(capsys)
    assert {k: rec[k] for k in shards} == shards
    assert rec["instrs"] == rec["batch"] * 4 * 8
    assert rec["collectives_per_cycle"]["sum"] == 1
    assert rec["device"] == "cpu"


def test_bench_fast_path_data_shards(capsys):
    base = ["bench", "--backend", "pallas", "--nodes", "4", "--instrs", "8",
            "--batch", "8", "--block", "2", "--robust", "--device", "cpu"]
    assert cli.main(base) == 0
    one = _line(capsys)
    assert cli.main(base + ["--data-shards", "2"]) == 0
    two = _line(capsys)
    assert two["data_shards"] == 2 and two["instrs"] == one["instrs"]
    with pytest.raises(SystemExit, match="needs --batch > 1"):
        cli.main(["bench", "--data-shards", "2", "--device", "cpu"])
    with pytest.raises(SystemExit, match="applies to bench"):
        cli.main(["run", "TRACES", "--data-shards", "2", "--device", "cpu"])


def test_migration_targets_take_data_shards():
    assert cli._migration_targets("pallas:2,jax:2,pallas") == [
        {"backend": "pallas-sharded", "data_shards": 2},
        {"backend": "jax", "data_shards": 2}, {"backend": "pallas"}]
    # node shards serve on the fast path's node axis, whatever the
    # backend named (hpa2_tpu/cli.py:696-698)
    assert cli._migration_targets("jax:1:2,pallas:2:2") == [
        {"backend": "pallas-node-sharded", "data_shards": 1,
         "node_shards": 2},
        {"backend": "pallas-node-sharded", "data_shards": 2,
         "node_shards": 2}]


def test_measure_dp_child(capsys):
    assert gpu_session.main(["--measure-dp", "8", "8", "2", "16", "16", "4",
                             "1", "2", "--device", "cpu"]) == 0
    rec = _line(capsys)
    assert rec["data_shards"] == 2 and rec["instructions"] == 8 * 8 * 8


def test_nodeshard_general_script(capsys):
    assert scale_runs.main(["nodeshard_general", "--device", "cpu"]) == 0
    rec = _line(capsys)
    assert rec["equal_to_torch_engine"] and rec["uncaptured"]
    assert sorted(r["exchange_mode"] for r in rec["rows"]) == sorted(
        ["a2a", "pairwise", "butterfly", "hier"])
    for r in rec["rows"]:
        assert r["collectives_per_cycle"] == dict(
            r["plan_collectives"], sum=1, max=1, min=0)


TORCHRUN_RANK = """
import json
import torch
torch.set_num_threads(1)
from hpa2_tpu_torch.config import Semantics, SystemConfig
from hpa2_tpu_torch.ops.engine import TorchEngine
from hpa2_tpu_torch.parallel import NodeShardedEngine, make_mesh
from hpa2_tpu_torch.utils.trace import gen_uniform_random

cfg = SystemConfig(num_procs=8, semantics=Semantics().robust())
traces = gen_uniform_random(cfg, 8, seed=2)
eng = NodeShardedEngine(cfg, traces, mesh=make_mesh(
    node_shards=2, data_shards=1, device="cpu")).run()
ref = TorchEngine(cfg, traces, device="cpu").run()
print(json.dumps({"equal": eng.final_dumps() == ref.final_dumps()
                  and eng.cycle == ref.cycle,
                  "ranks": len(eng.rank_stats),
                  "group": torch.distributed.get_world_size()}))
"""


def test_engines_join_a_torchrun_group():
    """Under ``torchrun`` (its ``RANK``/``WORLD_SIZE``/``MASTER_*``
    environment) the engine joins that group and runs in place on every
    rank instead of spawning; each rank gathers the whole state."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    root = pathlib.Path(__file__).resolve().parent.parent
    procs = [subprocess.Popen(
        [sys.executable, "-c", TORCHRUN_RANK], cwd=root,
        env={**os.environ, "RANK": str(r), "LOCAL_RANK": str(r),
             "WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
             "MASTER_PORT": str(port), "PYTHONPATH": str(root)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
        assert json.loads(out.strip().splitlines()[-1]) == {
            "equal": True, "ranks": 2, "group": 2}
