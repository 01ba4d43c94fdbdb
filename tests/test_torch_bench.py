"""``python -m hpa2_tpu_torch.bench`` against the repo's ``bench.py``,
each called in process on the CPU: the ``--topology`` and
``--protocol`` studies at small ``HPA2_TOPO_*``/``HPA2_PROTO_*`` sizes
give the same JSON (their numbers are model output: cycle counts and
counters of the spec engine, cross-checked against the general
engine), and the headline at the CPU shape (8 systems x 16
instructions) carries ``bench.py``'s keys and values, its fault
counters from ``BatchTorchEngine`` equal to ``BatchJaxEngine``'s."""

import importlib.util
import json
import pathlib

import pytest

from hpa2_tpu_torch import bench
from torch_pairs import IGNORE_PLTPU_ANY
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def jbench():
    """The repo's ``bench.py``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "repo_bench", REPO_ROOT / "bench.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _line(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_topology_study_matches_bench_py(jbench, monkeypatch, capsys):
    for k, v in (("NODES", "4"), ("ROUNDS", "2"), ("BANDWIDTH", "1")):
        monkeypatch.setenv(f"HPA2_TOPO_{k}", v)
    assert jbench.topo_main() == 0
    want = _line(capsys)
    assert bench.main(["--topology", "--device", "cpu"]) == 0
    got = _line(capsys)
    assert want["spec_jax_agree_all"] and got == want


def test_protocol_study_matches_bench_py(jbench, monkeypatch, capsys):
    for k, v in (("NODES", "4"), ("INSTRS", "8"), ("BATCH", "1"),
                 ("WIDE_NODES", "6")):
        monkeypatch.setenv(f"HPA2_PROTO_{k}", v)
    assert jbench.protocol_main() == 0
    want = _line(capsys)
    assert bench.main(["--protocol", "--device", "cpu"]) == 0
    got = _line(capsys)
    assert want["spec_jax_agree_all"] and got == want


@pytest.mark.filterwarnings(IGNORE_PLTPU_ANY)
def test_headline_carries_the_bench_py_line(jbench, monkeypatch, capsys):
    """``bench.py``'s CPU child (its fast path interpreted) and the
    port's headline on the CPU: the same keys but the port's own
    (``jax_engine``, ``device``), the same work and counters.  The
    JAX child's native lockstep context runs the port's build of the
    same sources (the JAX binding's ``make`` is not raced here)."""
    from hpa2_tpu_torch import native

    def bench_omp(config, instrs_per_core, seed=0, mode="omp"):
        res = native.bench_random(bench._bench_config(), instrs_per_core,
                                  seed=seed, mode=mode)
        return int(res.instructions), float(res.seconds)

    monkeypatch.setattr(jbench, "bench_omp", bench_omp)
    for k in ("TRACE_DIST", "SCHEDULE_RESIDENT", "HOST_BARRIERS", "PACKED",
              "NO_ELIDE"):
        monkeypatch.delenv(f"HPA2_BENCH_{k}", raising=False)
    assert jbench.child_main("cpu", True, "") == 0
    want = _line(capsys)
    assert bench.main(["--device", "cpu"]) == 0
    got = _line(capsys)
    assert set(got) == set(want) | {"jax_engine", "device"}
    for k in ("metric", "unit", "vs_baseline", "engine", "indicative",
              "batch", "jax_instrs", "packed_planes", "elide",
              "fused_schedule", "kernel_shape", "fault_counters"):
        assert got[k] == want[k], k
    assert (want["platform"], got["platform"]) == ("cpu", "cpu")
    assert got["jax_instrs"] == 8 * 8 * 16 == got["jax_engine"]["instrs"]
    assert set(got["phases"]) == set(want["phases"])
    assert got["device"] == {"name": "cpu", "power_limit": None}


def test_scheduled_headline_records_its_occupancy(monkeypatch, capsys):
    """``--trace-len-dist zipf --schedule-resident 4`` on the CPU: the
    flags become ``bench.py``'s environment knobs (restored after the
    test) and the line carries the scheduler's counters."""
    monkeypatch.setenv("HPA2_BENCH_TRACE_DIST", "")
    monkeypatch.setenv("HPA2_BENCH_SCHEDULE_RESIDENT", "0")
    assert bench.main(["--device", "cpu", "--trace-len-dist", "zipf",
                       "--schedule-resident", "4"]) == 0
    rec = _line(capsys)
    assert rec["fused_schedule"] and rec["schedule"] == {
        "resident": 4, "fused": True}
    assert rec["occupancy"]["admissions"] == 4
    assert rec["trace_len_dist"] == {"dist": "zipf", "spread": 8.0}


@pytest.mark.parametrize("flag", ["--data-shards", "--node-shards",
                                  "--exchange-mode"])
def test_multi_gpu_flags_are_refused(flag, monkeypatch, capsys):
    """The sharding flags are ported (the baselines' contexts stubbed:
    they do not shard): ``--data-shards`` runs the headline over two
    shards, ``--node-shards`` each system's nodes over two gloo ranks
    (``bench.py:236-310``: the ``exchange`` block), ``--exchange-mode``
    picks its schedule; each says so in its record."""
    # restored after
    monkeypatch.setenv("HPA2_BENCH_DATA_SHARDS", "1")
    monkeypatch.setenv("HPA2_BENCH_NODE_SHARDS", "1")
    monkeypatch.setenv("HPA2_BENCH_EXCHANGE_MODE", "")
    for k in ("TRACE_DIST", "SCHEDULE_RESIDENT", "HOST_BARRIERS", "PACKED"):
        monkeypatch.delenv(f"HPA2_BENCH_{k}", raising=False)
    monkeypatch.setattr(bench, "bench_omp", lambda *a, **k: (1, 1.0))
    monkeypatch.setattr(bench, "bench_jax", lambda *a, **k: (1, 1.0, {}))
    monkeypatch.setattr(bench, "fault_counters", lambda *a, **k: {})
    args = [flag, "2"] if flag != "--exchange-mode" else [
        flag, "pairwise", "--node-shards", "2"]
    assert bench.main(args + ["--device", "cpu"]) == 0
    rec = _line(capsys)
    assert rec["jax_instrs"] == 8 * 8 * 16
    if flag != "--data-shards":
        assert rec["node_shards"] == 2 and rec["batch"] == 8
        x = rec["exchange"]
        mode = "pairwise" if flag == "--exchange-mode" else "a2a"
        assert x["exchange_mode"] == mode
        assert x["collectives_per_cycle"] == (
            {"ppermute": 2, "all_to_all": 0} if mode == "pairwise"
            else {"ppermute": 0, "all_to_all": 2})
        assert x["cross_shard_msgs"] > 0
        assert rec["cross_shard_msgs_per_cycle"] == x[
            "cross_shard_msgs_per_cycle"]
        return
    assert rec["data_shards"] == 2 and rec["batch"] == 8
