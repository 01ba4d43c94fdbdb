"""The recovery supervisor on the port (``hpa2_tpu_torch.serving.
recovery``, ``service/failover.py``; ``device="cpu"``) against the JAX
package's on the same feed and failure plan, in the shapes of
``tests/test_failover.py:86-255``: ``kill`` for the ``jax`` and
``pallas`` primaries, the jax -> jax mid-state resume from a schema-v2
checkpoint, ``hang`` and ``poison`` on the fast path, and an unfailed
supervised run.  The supervised results must equal the JAX
supervisor's: dumps, ``jobs_completed``, every recovery counter, the
recovery events and the checkpoint files written.  Only ``InjectedFailure`` and ``StallError`` migrate: an
error from the primary's kernel wrapper propagates.  The ``serve``
command's ``--backend jax``, ``--failure-plan`` and
``--checkpoint-dir`` write the JAX command's dump files."""

import json
import os

import pytest

import hpa2_tpu.config as jconfig
from hpa2_tpu.serving import ListJobSource as JListJobSource
from hpa2_tpu.serving import supervised_serve as jsupervised_serve
from hpa2_tpu.serving import synthetic_jobs as jsynthetic_jobs
from hpa2_tpu_torch import cli
from hpa2_tpu_torch.config import FailureEvent, FailurePlan
from hpa2_tpu_torch.ops import kernels
from hpa2_tpu_torch.service import FailureInjector, InjectedFailure
from hpa2_tpu_torch.serving import (
    ListJobSource, default_targets, job_to_record, serve, supervised_serve,
    synthetic_jobs,
)
from torch_general import ROBUST, port_config
from torch_pairs import IGNORE_PLTPU_ANY
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings(IGNORE_PLTPU_ANY)

JCFG = jconfig.SystemConfig(num_procs=4, semantics=ROBUST)
TCFG = port_config(JCFG)
JAX_KW = dict(backend="jax", resident=4, max_trace_len=64, interval=8)
PALLAS_KW = dict(backend="pallas", resident=4, window=8, block=4)


@pytest.fixture(scope="module")
def jobs():
    return (jsynthetic_jobs(JCFG, 8, 24, seed=7, spread=3.0),
            synthetic_jobs(TCFG, 8, 24, seed=7, spread=3.0))


def _dump_map(results):
    return {r.job_id: tuple(repr(d) for d in r.dumps) for r in results}


def _recovery(stats):
    return stats.occupancy.get("recovery", {})


def test_injector_fires_each_event_once():
    plan = FailurePlan.parse("kill@2")
    inj = FailureInjector(plan)
    inj.hook(0, None)
    inj.hook(1, None)
    with pytest.raises(InjectedFailure) as ei:
        inj.hook(2, None)
    assert ei.value.event == FailureEvent("kill", 2)
    assert ei.value.interval == 2
    inj.hook(2, None)
    inj.hook(3, None)
    assert not inj.pending
    assert default_targets("pallas") == [{"backend": "jax",
                                          "data_shards": 1}]
    assert default_targets("jax") == [{"backend": "pallas",
                                       "data_shards": 1}]


@pytest.mark.parametrize("plan,kw,extra", [
    ("kill@3", JAX_KW, {}),
    ("kill@3", PALLAS_KW, {}),
    ("kill@4", JAX_KW, dict(targets=[{"backend": "jax", "data_shards": 1}])),
    ("hang@2", PALLAS_KW, dict(detect_after=2)),
    ("poison@2:1", PALLAS_KW, {}),
    ("", PALLAS_KW, {}),
], ids=["kill-jax", "kill-pallas", "jax-to-jax", "hang", "poison",
        "unfailed"])
def test_supervised_matches_jax_supervisor(jobs, tmp_path, plan, kw, extra):
    """The port's supervisor and the JAX package's, on the same feed and
    plan: the same dumps (the JAX supervisor's equal its unfailed run's,
    ``test_failover.py``; unfailed, the port's equal its plain run's),
    the same jobs completed, recovery counters and events, and the
    same checkpoint files."""
    jjobs, tjobs = jobs
    jdir, tdir = tmp_path / "j", tmp_path / "t"
    jdir.mkdir()
    tdir.mkdir()
    ck = dict(checkpoint_dir=str(tdir)) if plan else {}
    jres, jst = jsupervised_serve(
        JCFG, JListJobSource(jjobs),
        plan=jconfig.FailurePlan.parse(plan, seed=1),
        interpret=True if kw["backend"] == "pallas" else None,
        **(dict(checkpoint_dir=str(jdir)) if plan else {}), **kw, **extra)
    tres, tst = supervised_serve(
        TCFG, ListJobSource(tjobs), plan=FailurePlan.parse(plan, seed=1),
        device="cpu", **ck, **kw, **extra)
    assert _dump_map(tres) == _dump_map(jres)
    if not plan:
        base, _ = serve(TCFG, ListJobSource(tjobs), device="cpu", **kw)
        assert _dump_map(tres) == _dump_map(base)
    assert tst.jobs_completed == jst.jobs_completed == len(tjobs)
    assert _recovery(tst) == _recovery(jst)
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    rec = _recovery(tst)
    if not plan:
        assert "recovery" not in tst.occupancy
    elif plan.startswith("poison"):
        assert rec["migrations"] == 0 and rec["evacuations"] >= 1
    elif plan == "kill@4":
        # jax -> jax: the rows resume mid-state from the npz
        assert rec["lanes_resumed"] >= 1
        assert rec["evacuations"] >= rec["lanes_resumed"]
        assert any(n.endswith(".npz") for n in os.listdir(tdir))
    else:
        assert rec["failures_detected"] == 1 and rec["migrations"] >= 1
    if plan.startswith("hang"):
        detected = [e for e in rec["events"]
                    if e["event"] == "failure_detected"]
        assert (detected[0]["kind"], detected[0]["via"]) == (
            "hang", "watchdog")


def test_kernel_error_propagates_instead_of_migrating(jobs, tmp_path,
                                                      monkeypatch):
    """An error from the primary's kernel wrapper is a crash: the
    supervisor catches only InjectedFailure and StallError, so it
    neither migrates nor replays."""
    calls = []
    launch = kernels.stream_run

    def failing(*args, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("CUDA error: an illegal memory access")
        return launch(*args, **kw)

    monkeypatch.setattr(kernels, "stream_run", failing)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        supervised_serve(TCFG, ListJobSource(jobs[1]),
                         plan=FailurePlan.parse("kill@5"),
                         checkpoint_dir=str(tmp_path), device="cpu",
                         **PALLAS_KW)
    assert len(calls) == 2


@pytest.mark.parametrize("kw", [
    dict(backend="pallas", targets=[{"backend": "jax", "data_shards": 2}]),
    dict(backend="pallas",
         targets=[{"backend": "pallas-node-sharded", "node_shards": 2}]),
    dict(backend="pallas-sharded", data_shards=2),
], ids=["data-shards", "node-shards", "sharded-primary"])
def test_multi_gpu_targets_refused(jobs, kw):
    """Data shards and the fast path's node axis are ported: a kill
    migrates to (or from) them (``pallas-node-sharded`` over two gloo
    ranks, whose pool the supervisor closes) and every job's dumps equal
    the unfailed run's."""
    geometry = dict(resident=4, window=8, block=2, max_trace_len=64,
                    interval=8)
    tres, tst = supervised_serve(TCFG, ListJobSource(jobs[1]), device="cpu",
                                 plan=FailurePlan.parse("kill@1"),
                                 **geometry, **kw)
    base, _ = serve(TCFG, ListJobSource(jobs[1]), device="cpu",
                    **dict(PALLAS_KW, block=2))
    assert _dump_map(tres) == _dump_map(base)
    assert tst.jobs_completed == len(jobs[1])
    assert _recovery(tst)["migrations"] >= 1


# -- the serve command ------------------------------------------------------


def _tree(d):
    return {os.path.relpath(os.path.join(r, f), d):
            open(os.path.join(r, f)).read()
            for r, _, fs in os.walk(d) for f in fs}


@pytest.mark.parametrize("extra", [
    ["--backend", "jax", "--interval", "8", "--max-instr", "64"],
    ["--failure-plan", "kill@3", "--checkpoint-dir", "CK", "--window", "8",
     "--block", "4"],
    ["--backend", "jax", "--interval", "8", "--max-instr", "64",
     "--checkpoint-dir", "CK", "--migrate-to", "jax"],
], ids=["jax", "failure-plan", "checkpoint-dir"])
def test_serve_command_matches_jax_command(jobs, tmp_path, capsys, extra):
    """``serve --backend jax``, and ``serve`` under the supervisor, write
    the JAX command's dump files; their stats lines carry the same
    jobs and recovery counters."""
    from hpa2_tpu.cli import main as jmain

    feed = tmp_path / "jobs.jsonl"
    feed.write_text("".join(json.dumps(job_to_record(j)) + "\n"
                            for j in jobs[1]))
    outs = {}
    for name, main, dev in (("t", cli.main, ["--device", "cpu"]),
                            ("j", jmain, [])):
        args = [a.replace("CK", str(tmp_path / f"ck_{name}"))
                for a in extra]
        assert main(["serve", str(feed), "--nodes", "4", "--robust",
                     "--resident", "4", "--immediate", "--out",
                     str(tmp_path / name)] + args + dev) == 0
        outs[name] = json.loads(
            capsys.readouterr().out.strip().splitlines()[-1])
    assert _tree(tmp_path / "t") == _tree(tmp_path / "j")
    assert len(_tree(tmp_path / "t")) == 8 * 4
    for k in ("jobs_completed", "instructions", "backend"):
        assert outs["t"][k] == outs["j"][k], k
    assert outs["t"]["occupancy"].get("recovery") == \
        outs["j"]["occupancy"].get("recovery")
