"""The port's binding to the C++/OpenMP engine (``hpa2_tpu_torch.native``)
against ``hpa2_tpu.native`` on the same inputs: lockstep dumps, counts
and cycles of ``run_trace_dir`` (plain, HEAD quirks, replay, recorded
order and message log), ``bench_random``'s counts, and
``probe_transition``'s output block.  The port builds ``native/src``
into its own folder and never runs ``make`` or opens ``native/build``;
the free-running mode is nondeterministic, so only its instruction
count is compared."""

import ctypes
import pathlib

import numpy as np
import pytest

from hpa2_tpu import config as jconfig
from hpa2_tpu import native as jnative
from hpa2_tpu_torch import config as tconfig
from hpa2_tpu_torch import native
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent


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


def pair(**sem):
    robust = sem.pop("robust", True)
    out = []
    for mod in (jconfig, tconfig):
        s = mod.Semantics(**sem)
        out.append(mod.SystemConfig(semantics=s.robust() if robust else s))
    return out


def files(d: pathlib.Path):
    return {p.name: p.read_bytes() for p in sorted(d.iterdir())}


def counts(res):
    return res.instructions, res.messages, res.cycles, res.ok


@pytest.mark.parametrize("sem", [
    {},
    {"eager_write_request_memory": True,
     "flush_invack_fills_old_value": True},
    {"overloaded_evict_shared_notify": True},
])
def test_run_trace_dir_lockstep_matches_jax_binding(tmp_path, sem):
    traces = write_traces(tmp_path / "traces", seed=4)
    jcfg, tcfg = pair(**sem)
    outs = {}
    for tag, mod, cfg in (("jax", jnative, jcfg), ("port", native, tcfg)):
        out = tmp_path / tag
        out.mkdir()
        res = mod.run_trace_dir(
            cfg, str(traces), str(out), mode="lockstep",
            record_order_path=str(out / "order.txt"),
            msg_trace_path=str(out / "msgs.txt"))
        outs[tag] = (counts(res), files(out))
    assert outs["port"] == outs["jax"]
    assert len(outs["port"][1]) == 4 + 2


def test_replay_and_final_dump_match_jax_binding(tmp_path):
    traces = write_traces(tmp_path / "traces", seed=9)
    jcfg, tcfg = pair()
    order = tmp_path / "order.txt"
    native.run_trace_dir(tcfg, str(traces), str(tmp_path),
                         record_order_path=str(order))
    outs = {}
    for tag, mod, cfg in (("jax", jnative, jcfg), ("port", native, tcfg)):
        out = tmp_path / tag
        out.mkdir()
        res = mod.run_trace_dir(cfg, str(traces), str(out),
                                replay_path=str(order), final_dump=True)
        outs[tag] = (counts(res), files(out))
    assert outs["port"] == outs["jax"]


def test_free_running_retires_every_instruction(tmp_path):
    traces = write_traces(tmp_path / "traces", seed=2)
    _, tcfg = pair()
    res = native.run_trace_dir(tcfg, str(traces), str(tmp_path / "o"),
                               mode="omp")
    assert res.ok and res.instructions == 4 * 16


@pytest.mark.parametrize("mode", ["lockstep", "omp"])
def test_bench_random_matches_jax_binding(mode):
    cfgs = []
    for mod in (jconfig, tconfig):
        cfgs.append(mod.SystemConfig(num_procs=8, msg_buffer_size=16,
                                     semantics=mod.Semantics().robust()))
    want = jnative.bench_random(cfgs[0], 500, seed=3, mode=mode)
    got = native.bench_random(cfgs[1], 500, seed=3, mode=mode)
    assert got.ok and got.instructions == want.instructions == 8 * 500
    if mode == "lockstep":
        assert counts(got) == counts(want)


def test_probe_transition_matches_jax_binding():
    jcfg, tcfg = pair()
    # home 0 receives a READ_REQUEST for 0x05 from node 1, block
    # uncached (the packed scenario of hpa2_tpu/analysis/extract.py)
    probe = [0, 0, 0, 0, 0,          # receiver, is_instr, op, addr, value
             0, 1, 0x05, 0, 0, -1,   # message: type, sender, addr, ...
             1, -1, 0, 3,            # line: index, addr, value, INVALID
             5, 2, 0,                # directory: block, U, sharers
             5, 5, 0, 0]             # memory block and value, pending
    assert native.probe_transition(tcfg, probe) == \
        jnative.probe_transition(jcfg, probe)


def test_refusals_match_jax_binding():
    for mod in (native, jnative):
        cfg_mod = tconfig if mod is native else jconfig
        with pytest.raises(mod.NativeError, match="up to 64 nodes"):
            mod.bench_random(cfg_mod.SystemConfig(num_procs=65), 4)
        with pytest.raises(mod.NativeError, match="messages_per_cycle"):
            mod.bench_random(cfg_mod.SystemConfig(messages_per_cycle=2), 4)


def test_builds_its_own_library_and_never_native_build(monkeypatch):
    """A fresh load compiles ``native/src`` with g++ into the port's
    build folder (or finds that build there), loads only it, and runs
    no ``make``."""
    import subprocess

    calls, loads = [], []
    real_run, real_cdll = subprocess.run, ctypes.CDLL

    def run(cmd, *a, **k):
        calls.append(list(cmd))
        return real_run(cmd, *a, **k)

    def cdll(path, *a, **k):
        loads.append(str(path))
        return real_cdll(path, *a, **k)

    monkeypatch.setattr(native.subprocess, "run", run)
    monkeypatch.setattr(native.ctypes, "CDLL", cdll)
    monkeypatch.setattr(native, "_lib", None)
    native.ensure_built(force=True)
    native._load()
    build = REPO_ROOT / "hpa2_tpu_torch" / "build" / "native"
    assert loads and all(pathlib.Path(p).parent == build for p in loads)
    assert calls and all(c[0] == "g++" for c in calls)
    srcs = [a for c in calls for a in c if a.endswith(".cpp")]
    assert sorted(pathlib.Path(s).name for s in srcs) == \
        ["capi.cpp", "io.cpp", "sim.cpp"]
    assert all(pathlib.Path(s).parent == REPO_ROOT / "native" / "src"
               for s in srcs)
    flat = " ".join(a for c in calls for a in c) + " ".join(loads)
    assert "native/build" not in flat and "make" not in flat.split()


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "NATIVE_SRC", tmp_path)
    for name in native.SOURCES + native.HEADERS:
        (tmp_path / name).write_text("this is not C++\n")
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(native.NativeError, match="g\\+\\+ failed"):
        native.ensure_built()
