"""``hpa2_tpu_torch/scripts/gpu_session.py`` on the CPU: its records and
abort rule with fake children, its step list against the JAX session's,
the probe's refusal without a card, and each measure child at a tiny
size with ``--device cpu``, passing, and failing when its gate is made
to fail."""

import json
import pathlib
import re

import pytest
import torch

from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
from hpa2_tpu_torch.scripts import gpu_session
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

JAX_SESSION = pathlib.Path(__file__).resolve().parent.parent / "scripts" / \
    "r5_tpu_session.py"

#: the JAX session's steps in order (scripts/r5_tpu_session.py:656-862)
JAX_STEPS = [
    "probe", "vmemprobe512", "vmemprobe1024", "vmemprobe2048", "bench",
    "differential", "sweep512", "block1024", "block2048", "sweep_b1024_w16",
    "sweep_b1024_gate", "sweep_b512_w8", "sweep_b2048_w8", "tuning",
    "scale4", "scale5", "sweep512_dp", "occupancy512", "fused_occupancy512",
    "serve512", "serve_mt512", "failover512", "elision512", "topo512",
    "multichip", "nodeshard", "nodeshard_ladder", "nodeshard_ab",
    "nodeshard4096", "nodeshard_x2", "nodeshard_x4",
    "nodeshard_x4_butterfly", "elided_nodeshard",
]
#: the steps on several cards: the data-parallel ones and the node axis's
#: (the fast path's and, in elided_nodeshard, the general engine's)
MULTI_DEVICE = {
    "sweep512_dp", "multichip", "nodeshard", "nodeshard_ladder",
    "nodeshard_ab", "nodeshard4096", "nodeshard_x2", "nodeshard_x4",
    "nodeshard_x4_butterfly", "elided_nodeshard",
}

#: a tiny fast-path shape: batch instrs block k cap window gate
TINY = ["8", "8", "8", "8", "16", "4", "1"]


def lines(path):
    return [json.loads(x) for x in pathlib.Path(path).read_text().splitlines()]


def test_run_py_records_an_ok_child(tmp_path):
    s = gpu_session.Session(tmp_path / "s.jsonl")
    rec = s.run_py("fake", "print('noise'); print('{\"x\": 1}')", 60)
    assert rec["ok"] and rec["rc"] == 0 and rec["result"] == {"x": 1}
    assert rec["stderr_tail"] == "" and rec["step"] == "fake"
    assert lines(tmp_path / "s.jsonl") == [rec]


def test_run_py_records_a_failed_child(tmp_path):
    s = gpu_session.Session(tmp_path / "s.jsonl")
    rec = s.run_py("bad", [
        "-c", "import sys; print('{\"y\": 2}'); "
        "sys.stderr.write('it broke'); sys.exit(3)"], 60, argv=True)
    assert not rec["ok"] and rec["rc"] == 3 and rec["result"] == {"y": 2}
    assert rec["stderr_tail"].endswith("it broke")


def test_run_py_timeout_keeps_the_tails(tmp_path):
    s = gpu_session.Session(tmp_path / "s.jsonl")
    rec = s.run_py("slow", (
        "import sys, time\n"
        "print('{\"z\": 3}', flush=True)\n"
        "sys.stderr.write('still going'); sys.stderr.flush()\n"
        "time.sleep(60)\n"), 3)
    assert not rec["ok"] and rec["error"] == "timeout 3s"
    assert '{"z": 3}' in rec["stdout_tail"]
    assert rec["stderr_tail"] == "still going"
    assert rec["wall_s"] < 30


def test_abort_after_two_failures_and_skip(tmp_path):
    out = tmp_path / "s.jsonl"
    s = gpu_session.Session(out, skip=["b", "sweeps"], card=lambda: True)
    fail = ["-c", "import sys; sys.exit(1)"]
    ok = ["-c", "print('{}')"]
    assert s.step("b", ok, 60) is None              # skipped by name
    assert s.step("p", ok, 60, group="sweeps") is None  # by its group
    assert s.step("a1", fail, 60)["rc"] == 1
    assert s.step("a2", ok, 60)["ok"]                # success resets
    assert s.step("a3", fail, 60)["rc"] == 1
    assert s.step("a4", fail, 60)["rc"] == 1
    assert s.step("a5", ok, 60) is None              # aborted
    recs = lines(out)
    assert [r["step"] for r in recs] == ["a1", "a2", "a3", "a4", "a5"]
    assert recs[-1] == {**recs[-1], "ok": False,
                        "error": "skipped: session aborted"}


def test_a_lost_card_skips_the_rest(tmp_path):
    s = gpu_session.Session(tmp_path / "s.jsonl", card=lambda: False)
    assert s.step("a", ["-c", "print('{}')"], 60) is None
    assert s.step("b", ["-c", "print('{}')"], 60) is None
    assert [(r["step"], r["error"]) for r in lines(tmp_path / "s.jsonl")] \
        == [("a", "skipped: no card visible"),
            ("b", "skipped: session aborted")]


def test_run_session_order_and_tuning(tmp_path, monkeypatch):
    """Fake steps in the session's loop: each runs in order, and
    ``tuning`` records the best headline-shape point it saw."""
    pt = {"batch": 32768, "instrs_per_core": 128, "cap": 16, "block": 1024,
          "window": 8, "cycles_per_call": 64, "gate": 0}
    fake = [
        ("m1", ["-c", "print(%r)" % json.dumps(
            dict(pt, ops_per_sec=5.0))], 60, None, None),
        ("m2", ["-c", "print(%r)" % json.dumps(
            dict(pt, block=2048, ops_per_sec=9.0))], 60, None, None),
        ("tuning", None, 0, None, None),
        ("env", ["-c", "import os; print('{\"v\": \"%s\"}' "
                 "% os.environ['HPA2_X'])"], 60, None, {"HPA2_X": "7"}),
    ]
    monkeypatch.setattr(gpu_session, "steps", lambda: fake)
    s = gpu_session.Session(tmp_path / "s.jsonl", skip=["probe"],
                            card=lambda: True)
    assert gpu_session.run_session(s) == 0
    recs = lines(tmp_path / "s.jsonl")
    assert [r["step"] for r in recs] == ["m1", "m2", "tuning", "env"]
    assert recs[2]["result"] == {"block": 2048, "window": 8, "k": 64,
                                 "gate": False, "from_ops_per_sec": 9.0,
                                 "file": None}
    assert recs[3]["result"] == {"v": "7"}
    assert not (tmp_path / "BENCH_TUNING.json").exists()


def test_probe_fails_the_session_without_a_card(tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: this refusal needs none")
    out = tmp_path / "s.jsonl"
    assert gpu_session.main(["--out", str(out)]) == 1
    recs = lines(out)
    assert [r["step"] for r in recs] == ["probe"]
    assert not recs[0]["ok"] and recs[0]["rc"] == 3
    assert recs[0]["result"]["cuda"] is False
    assert "no card" in capsys.readouterr().err


def test_step_list_is_the_jax_sessions_minus_multi_device():
    src = JAX_SESSION.read_text()
    for name in JAX_STEPS:  # each is named in the JAX session's source
        stem = re.sub(r"(512|1024|2048)$", "", name)
        assert f'"{name}"' in src or f'"{stem}' in src \
            or f'f"{stem}' in src, name
    ours = ["probe"] + [name for name, *_ in gpu_session.steps()]
    want = [n.replace("vmemprobe", "smemprobe") for n in JAX_STEPS]
    assert ours == want
    assert MULTI_DEVICE <= set(ours)
    for name, argv, *_ in gpu_session.steps():
        if argv is not None:
            assert "-m" in argv and all("hpa2_tpu." not in a for a in argv)
    doc = gpu_session.__doc__
    for name in ("sweep512_dp", "multichip", "nodeshard", "elided_nodeshard",
                 "nodeshard4096", "BENCH_TUNING.json"):
        assert name in doc
    assert "item 4b" not in doc


def _json_out(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_measure_child(capsys):
    assert gpu_session.main(["--measure", *TINY, "--device", "cpu"]) == 0
    rec = _json_out(capsys)
    assert rec["instructions"] == 8 * 8 * 8 and rec["device"] == "cpu"


def test_measure_child_fails_its_gate(capsys, monkeypatch):
    monkeypatch.setattr(CudaEngine, "instructions", property(lambda s: 1))
    assert gpu_session.main(["--measure", *TINY, "--device", "cpu"]) == 1


def _corrupt(monkeypatch, method):
    """A scheduled run whose result is off by one retired instruction in
    system 0."""
    orig = getattr(CudaEngine, method)

    def run(self, *a, **k):
        out = orig(self, *a, **k)
        self.state["scalars"][1, 0] += 1
        return out
    monkeypatch.setattr(CudaEngine, method, run)


@pytest.mark.parametrize("broken", [None, "_run_scheduled"])
def test_measure_occupancy_child(capsys, monkeypatch, broken):
    if broken:
        _corrupt(monkeypatch, broken)
    rc = gpu_session.main(["--measure-occupancy", *TINY, "8", "--device",
                           "cpu"])
    rec = _json_out(capsys)
    assert rc == (1 if broken else 0)
    assert rec["bit_exact"] is (broken is None)
    assert rec["occupancy"]["intervals"] >= 1


@pytest.mark.parametrize("broken", [None, "_run_scheduled_fused"])
def test_measure_fused_occupancy_child(capsys, monkeypatch, broken):
    if broken:
        _corrupt(monkeypatch, broken)
    rc = gpu_session.main(["--measure-fused-occupancy", *TINY, "8", "1",
                           "--device", "cpu"])
    rec = _json_out(capsys)
    assert rc == (1 if broken else 0)
    assert rec["packed"] is True and rec["bit_exact_pr5"] is True
    assert rec["bit_exact_fused"] is (broken is None)


def test_measure_elision_child(capsys):
    assert gpu_session.main(["--measure-elision", "2", "64", "8", "0",
                             "--device", "cpu"]) == 0
    rec = _json_out(capsys)
    assert rec["bit_exact"] and rec["elided_cycles"] > 0


def test_measure_elision_child_fails_its_gate(capsys, monkeypatch):
    """The elision-off run's state off by one retired instruction."""
    import hpa2_tpu_torch.convert as convert

    orig, calls = convert.sim_state_to_numpy, []

    def to_numpy(st, *a, **k):
        out = orig(st, *a, **k)
        calls.append(1)
        if len(calls) == 2:
            out["n_instr"][0] += 1
        return out
    monkeypatch.setattr(convert, "sim_state_to_numpy", to_numpy)
    assert gpu_session.main(["--measure-elision", "2", "64", "8", "0",
                             "--device", "cpu"]) == 1
    assert _json_out(capsys)["bit_exact"] is False


def test_measure_children_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: this refusal needs none")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        gpu_session.main(["--measure", *TINY])
