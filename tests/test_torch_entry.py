"""The port's entry points against the JAX package's on the same inputs.

First the fast path's HEAD value quirks: ``CudaEngine(device="cpu")``
(the kernel's plain version, which carries the quirk flags the kernel
takes at run time) against ``PallasEngine`` in the Pallas interpreter,
every plane bit for bit, and the dumps against the spec engine.  Then
``python -m hpa2_tpu_torch run|bench`` against ``hpa2_tpu.cli.main``:
the ``spec`` and ``omp`` backends, ``--quirks``/``--head-quirks``,
``--messages-per-cycle``, ``--trace-msgs``, ``--record-order``,
``--replay``, ``--crash-at``/``--resume`` across the packages and
``--workload``, byte for byte on the files written and key for key on
the bench line, and every refusal with the JAX CLI's message."""

import dataclasses
import json
import pathlib

import numpy as np
import pytest

from hpa2_tpu import cli as jcli
from hpa2_tpu.config import Semantics as JSemantics
from hpa2_tpu.config import SystemConfig as JSystemConfig
from hpa2_tpu.models.spec_engine import SpecEngine as JSpecEngine
from hpa2_tpu.utils.trace import gen_uniform_random_arrays
from hpa2_tpu_torch import cli
from hpa2_tpu_torch.config import Semantics, SystemConfig
from torch_pairs import IGNORE_PLTPU_ANY, dicts, run_both, traces_of
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

QUIRKS = {
    "eager-write": dict(eager_write_request_memory=True),
    "flush-old-fill": dict(flush_invack_fills_old_value=True),
    "both": dict(eager_write_request_memory=True,
                 flush_invack_fills_old_value=True),
}


@pytest.mark.filterwarnings(IGNORE_PLTPU_ANY)
@pytest.mark.parametrize("name", sorted(QUIRKS))
def test_fast_path_quirks_match_interpreted_pallas(name):
    """Every plane of the plain version equals the interpreted Pallas
    kernel's under the quirk; the dumps equal the spec engine's, and on
    some system they differ from the run without the quirk."""
    flags = QUIRKS[name]
    jcfg = JSystemConfig(num_procs=4, msg_buffer_size=32,
                         semantics=JSemantics(**flags).robust())
    tcfg = SystemConfig(num_procs=4, msg_buffer_size=32,
                        semantics=Semantics(**flags).robust())
    arrays = gen_uniform_random_arrays(jcfg, 4, 24, seed=1)
    pe, ce, stall = run_both(jcfg, tcfg, arrays, block=4,
                             cycles_per_call=64)
    assert stall is None
    assert ce.stats() == pe.stats()
    plain = dataclasses.replace(jcfg, semantics=JSemantics().robust())
    changed = 0
    for b in range(4):
        traces = traces_of(*arrays, b, 4)
        spec = JSpecEngine(jcfg, traces)
        spec.run()
        assert dicts(ce.system_final_dumps(b)) == dicts(spec.final_dumps())
        assert dicts(ce.system_snapshots(b)) == dicts(spec.snapshots())
        base = JSpecEngine(plain, traces)
        base.run()
        changed += dicts(base.final_dumps()) != dicts(spec.final_dumps())
    assert changed


def write_traces(d: pathlib.Path, seed: int, n=4, t=16, n_addr=64):
    d.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for core in range(n):
        lines = []
        for _ in range(t):
            a = int(rng.integers(0, n_addr))
            lines.append(f"WR 0x{a:02X} {int(rng.integers(0, 256))}"
                         if rng.random() < 0.5 else f"RD 0x{a:02X}")
        (d / f"core_{core}.txt").write_text("\n".join(lines) + "\n")
    return d


def tree(d: pathlib.Path):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def both_run(tmp_path, flags, traces=None):
    """``run`` through both CLIs with ``flags`` (``OUT/`` marks a file
    written into the output directory) on ``traces`` (default: a fresh
    4-node directory); -> (JAX files, port files)."""
    traces = traces or write_traces(tmp_path / "traces", seed=3)
    outs = []
    for tag, main in (("jax", jcli.main), ("port", cli.main)):
        out = tmp_path / tag
        out.mkdir(parents=True)
        args = [str(out / a[4:]) if a.startswith("OUT/") else a
                for a in flags]
        assert main(["run", str(traces), "--out", str(out), *args]) == 0
        outs.append(tree(out))
    return outs


RUNS = {
    "spec": ["--backend", "spec", "--robust"],
    "spec-logs": ["--backend", "spec", "--robust", "--trace-msgs",
                  "OUT/msgs.txt", "--record-order", "OUT/order.txt"],
    "spec-final-k2": ["--backend", "spec", "--robust", "--final-dump",
                      "--messages-per-cycle", "2"],
    "spec-head-quirks": ["--backend", "spec", "--head-quirks"],
    "spec-overloaded-notify": ["--backend", "spec", "--robust", "--quirks",
                               "overloaded-notify"],
    "spec-moesi-mesh2d-faults": ["--backend", "spec", "--robust",
                                 "--protocol", "moesi", "--topology",
                                 "mesh2d", "--fault-drop", "0.2"],
    "omp": ["--backend", "omp", "--robust"],
    "omp-logs-quirks": ["--backend", "omp", "--robust", "--quirks",
                        "eager-write,flush-old-fill", "--trace-msgs",
                        "OUT/msgs.txt", "--record-order", "OUT/order.txt"],
    "omp-head-quirks": ["--backend", "omp", "--head-quirks",
                        "--final-dump"],
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_host_backends_match_jax_cli_bytes(tmp_path, name):
    want, got = both_run(tmp_path, RUNS[name])
    assert len([k for k in want if k.startswith("core_")]) == 4
    assert got == want


@pytest.mark.parametrize("backend", ["pallas", "jax"])
def test_run_device_backends_with_value_quirks_match_jax_spec(tmp_path,
                                                              backend):
    """``--quirks eager-write,flush-old-fill`` on the port's fast path
    and general engine: the JAX CLI's spec bytes (its jax and pallas
    backends equal its spec backend, tests/test_head_quirks.py)."""
    quirks = ["--robust", "--quirks", "eager-write,flush-old-fill"]
    traces = write_traces(tmp_path / "traces", seed=3)
    assert jcli.main(["run", str(traces), "--out", str(tmp_path / "want"),
                      "--backend", "spec", *quirks]) == 0
    assert cli.main(["run", str(traces), "--out", str(tmp_path / "got"),
                     "--backend", backend, "--device", "cpu",
                     *quirks]) == 0
    assert tree(tmp_path / "got") == tree(tmp_path / "want")


def test_run_replays_an_order_on_every_host_backend(tmp_path):
    traces = write_traces(tmp_path / "traces", seed=6)
    order = tmp_path / "order.txt"
    assert jcli.main(["run", str(traces), "--backend", "spec", "--robust",
                      "--out", str(tmp_path / "rec"), "--record-order",
                      str(order)]) == 0
    for backend in ("spec", "omp"):
        want, got = both_run(tmp_path / backend,
                             ["--backend", backend, "--robust", "--replay",
                              str(order)], traces)
        assert got == want


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_crash_and_resume_across_packages(tmp_path, writer):
    """``run --crash-at`` in one CLI, ``--resume`` in the other: the
    dumps equal the straight run's, under faults."""
    traces = write_traces(tmp_path / "traces", seed=5)
    flags = ["--backend", "spec", "--robust", "--fault-drop", "0.3",
             "--fault-dup", "0.1", "--fault-seed", "4"]
    crash, resume = (jcli.main, cli.main) if writer == "jax" \
        else (cli.main, jcli.main)
    ckpt = tmp_path / "ck.json"
    assert crash(["run", str(traces), *flags, "--crash-at", "12",
                  "--crash-checkpoint", str(ckpt)]) == 0
    assert resume(["run", str(traces), *flags, "--resume", str(ckpt),
                   "--out", str(tmp_path / "resumed")]) == 0
    assert jcli.main(["run", str(traces), *flags, "--out",
                      str(tmp_path / "straight")]) == 0
    assert tree(tmp_path / "resumed") == tree(tmp_path / "straight")


def _bench_line(main, args, capsys):
    assert main(["bench", *args]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("args", [
    ["--backend", "spec", "--instrs", "24", "--workload", "uniform"],
    ["--backend", "spec", "--instrs", "24", "--workload",
     "producer-consumer", "--messages-per-cycle", "2"],
    ["--backend", "spec", "--instrs", "24", "--workload", "local",
     "--head-quirks"],
    ["--backend", "omp", "--instrs", "200", "--nodes", "8"],
    ["--backend", "omp", "--instrs", "200", "--free-running"],
])
def test_bench_host_backends_print_the_jax_line(args, capsys):
    args = args + ["--robust", "--seed", "4"]
    want = _bench_line(jcli.main, args, capsys)
    got = _bench_line(cli.main, args, capsys)
    assert set(got) == set(want)
    for k in set(want) - {"seconds", "ops_per_sec"}:
        assert got[k] == want[k], k
    assert got["ops_per_sec"] > 0


@pytest.mark.parametrize("workload", ["producer-consumer", "local"])
@pytest.mark.parametrize("backend", ["pallas", "jax"])
def test_bench_workloads_on_the_device_backends(workload, backend, capsys):
    """``--workload`` on the fast path and the general engine (CPU):
    the JAX CLI's keys, and every instruction of the workload retired
    (the spec engine's count on each system's traces)."""
    from hpa2_tpu_torch.models.spec_engine import SpecEngine

    args = ["bench", "--backend", backend, "--workload", workload,
            "--batch", "3", "--instrs", "12", "--nodes", "4", "--robust",
            "--seed", "2", "--device", "cpu"]
    rec = _bench_line(cli.main, args[1:], capsys)
    assert rec["workload"] == workload and rec["device"] == "cpu"
    assert rec["backend"] == backend
    assert set(rec) - {"device"} == JAX_BENCH_KEYS
    cfg = SystemConfig(num_procs=4, semantics=Semantics().robust())
    gen = cli._generator(workload)
    want = 0
    for b in range(3):
        spec = SpecEngine(cfg, gen(cfg, 12, seed=2 + b))
        spec.run()
        want += spec.instructions
    assert rec["instrs"] == want == 3 * 4 * 12


JAX_BENCH_KEYS = {"backend", "workload", "nodes", "batch", "node_shards",
                  "data_shards", "instrs", "resumed_instrs", "seconds",
                  "ops_per_sec"}


REFUSALS = [
    ["run", "TRACES", "--backend", "jax", "--quirks", "overloaded-notify"],
    ["run", "TRACES", "--backend", "pallas", "--head-quirks"],
    ["run", "TRACES", "--quirks", "frob"],
    ["run", "TRACES", "--backend", "jax", "--messages-per-cycle", "2"],
    ["run", "TRACES", "--backend", "omp", "--messages-per-cycle", "2"],
    ["run", "TRACES", "--backend", "jax", "--trace-msgs", "M"],
    ["run", "TRACES", "--backend", "pallas", "--record-order", "M"],
    ["run", "TRACES", "--backend", "jax", "--crash-at", "5"],
    ["run", "TRACES", "--backend", "omp", "--fault-drop", "0.1"],
    ["run", "TRACES", "--backend", "omp", "--topology", "mesh2d"],
    ["run", "TRACES", "--backend", "omp", "--protocol", "moesi"],
    ["bench", "--backend", "omp", "--workload", "local"],
    ["bench", "--backend", "omp", "--batch", "2"],
    ["bench", "--backend", "spec", "--batch", "2"],
    ["bench", "--backend", "pallas", "--fault-drop", "0.1"],
]


@pytest.mark.parametrize("args", REFUSALS, ids=lambda a: "-".join(a[2:]))
def test_refusals_carry_the_jax_cli_message(tmp_path, args):
    traces = write_traces(tmp_path / "traces", seed=1)
    args = [str(traces) if a == "TRACES" else a for a in args]
    args += ["--robust", "--out", str(tmp_path)] if args[0] == "run" \
        else ["--robust"]
    with pytest.raises(SystemExit) as want:
        jcli.main(args)
    with pytest.raises(SystemExit) as got:
        cli.main(args + ["--device", "cpu"])
    assert isinstance(want.value.code, str)
    assert got.value.code == want.value.code


# the data axis and both engines' node axes are ported: the fast path's
# node axis equals the JAX CLI's (NodeShardedPallasEngine on the virtual
# devices), the dumps file for file and the bench line key for key
@pytest.mark.parametrize("args", [
    ["run", "TRACES", "--backend", "pallas", "--node-shards", "2"],
    ["bench", "--backend", "pallas", "--node-shards", "2", "--data-shards",
     "2", "--batch", "4", "--nodes", "4", "--instrs", "8"],
    ["bench", "--backend", "pallas", "--node-shards", "2", "--batch", "4",
     "--nodes", "4", "--instrs", "8"],
])
def test_sharding_flags_name_the_multi_gpu_item(tmp_path, args, capsys):
    if args[0] == "run":
        traces = write_traces(tmp_path / "traces", seed=1)
        flags = ["--robust", "--backend", "pallas", "--node-shards", "2"]
        assert jcli.main(["run", str(traces), "--out", str(tmp_path / "want"),
                          *flags]) == 0
        assert cli.main(["run", str(traces), "--out", str(tmp_path / "got"),
                         *flags, "--device", "cpu"]) == 0
        got = tree(tmp_path / "got")
        assert got == tree(tmp_path / "want") and len(got) == 4
        return
    want = _bench_line(jcli.main, args[1:] + ["--robust"], capsys)
    got = _bench_line(cli.main, args[1:] + ["--robust", "--device", "cpu"],
                      capsys)
    assert set(got) - {"device"} == set(want)
    for k in set(want) - {"seconds", "ops_per_sec"}:
        assert got[k] == want[k], k
