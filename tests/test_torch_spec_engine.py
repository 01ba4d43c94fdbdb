"""The port's spec engine (``hpa2_tpu_torch.models.spec_engine``)
against ``hpa2_tpu.models.spec_engine.SpecEngine`` on the same seeded
traces, at tolerance zero: final dumps, snapshots, ``counters``,
``stats()``, ``link_stats()``, ``msg_log``, ``issue_log``, ``cycle``
and the text of a stall, over the protocols, the limited and coarse
directories, the two non-ideal delivery variants, a fault mix,
``messages_per_cycle=2``, a replay, the HEAD quirks (overloaded-notify
included), ``continue_with`` and a severed edge's ``StallDiagnostic``.
Then the spec engine's JSON checkpoints written by each package and
resumed in the other, and ``utils/parity.py`` on a run set the JAX
spec engine writes."""

import dataclasses

import pytest

from hpa2_tpu import config as jconfig
from hpa2_tpu.models.spec_engine import SpecEngine as JSpecEngine
from hpa2_tpu.models.spec_engine import StallError as JStallError
from hpa2_tpu.utils import checkpoint as jcheckpoint
from hpa2_tpu.utils.dump import format_processor_state as jformat
from hpa2_tpu.utils.trace import (
    format_instruction_order as jformat_order,
    gen_local_only as jgen_local_only,
    gen_producer_consumer as jgen_producer_consumer,
    gen_uniform_random as jgen_uniform_random,
)
from hpa2_tpu_torch import config as tconfig
from hpa2_tpu_torch.models.protocol import Instr
from hpa2_tpu_torch.models.spec_engine import SpecEngine, StallError
from hpa2_tpu_torch.utils import checkpoint, parity, trace
from torch_threads import one_torch_thread  # noqa: F401 (autouse)


def config_pair(sem=None, ic=None, fault=None, **kw):
    """One configuration in both packages: ``sem`` the ``Semantics``
    fields (``robust`` for the NACK policy), ``ic`` the interconnect's
    and ``fault`` the fault model's."""
    out = []
    for mod in (jconfig, tconfig):
        sem_kw = dict(sem or {})
        robust = sem_kw.pop("robust", True)
        s = mod.Semantics(**sem_kw)
        if robust:
            s = s.robust()
        ick = dict(ic or {})
        if fault:
            ick["fault"] = mod.FaultModel(**fault)
        out.append(mod.SystemConfig(
            semantics=s, interconnect=mod.InterconnectConfig(**ick), **kw))
    return out


def _run(eng, **kw):
    try:
        eng.run(**kw)
    except (StallError, JStallError) as e:
        return type(e).__name__, str(e)
    return None


def observed(eng, stall):
    """Everything the engine exposes after a run."""
    return dict(
        stall=stall,
        cycle=eng.cycle,
        final=[d.__dict__ for d in eng.final_dumps()],
        snapshots=[d.__dict__ for d in eng.snapshots()],
        counters=dict(eng.counters),
        stats=eng.stats(),
        link_stats=eng.link_stats(),
        msg_log=list(eng.msg_log),
        issue_log=[dataclasses.astuple(r) for r in eng.issue_log],
        instructions=eng.instructions,
        messages=eng.messages,
        max_mailbox_depth=eng.max_mailbox_depth,
    )


def run_pair(jcfg, tcfg, traces, run_kw=None, **kw):
    """Both spec engines on ``traces`` (the port's own ``Instr``s,
    rebuilt for the JAX engine); asserts that they agree on everything
    and returns the port's engine and its observations."""
    from hpa2_tpu.models.protocol import Instr as JInstr

    jtraces = [[JInstr(i.op, i.address, i.value) for i in tr]
               for tr in traces]
    je = JSpecEngine(jcfg, jtraces, **kw)
    te = SpecEngine(tcfg, traces, **kw)
    want = observed(je, _run(je, **(run_kw or {})))
    got = observed(te, _run(te, **(run_kw or {})))
    assert got == want
    return te, got


def _traces(tcfg, instrs, seed, gen=trace.gen_uniform_random):
    return gen(tcfg, instrs, seed=seed)


CASES = {
    "mesi": dict(num_procs=8, msg_buffer_size=16),
    "moesi": dict(num_procs=6, protocol="moesi"),
    "mesif": dict(num_procs=6, protocol="mesif"),
    "limited:2": dict(num_procs=8, directory_format="limited:2"),
    "coarse:4": dict(num_procs=8, directory_format="coarse:4"),
    "mesh2d-multicast": dict(num_procs=8, ic=dict(
        topology="mesh2d", multicast=True, hop_latency=2)),
    "torus2d-combining": dict(num_procs=8, ic=dict(
        topology="torus2d", combining=True, link_bandwidth=2)),
    "faults": dict(num_procs=4, fault=dict(
        drop=0.2, duplicate=0.05, reorder=0.05, delay=0.1, seed=7)),
    "messages-per-cycle-2": dict(num_procs=4, messages_per_cycle=2),
    "fixture-local": dict(num_procs=4, sem=dict(robust=False)),
    "value-quirks": dict(num_procs=4, sem=dict(
        eager_write_request_memory=True,
        flush_invack_fills_old_value=True)),
    "overloaded-notify": dict(num_procs=4, sem=dict(
        eager_write_request_memory=True, flush_invack_fills_old_value=True,
        overloaded_evict_shared_notify=True)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_spec_engine_matches_jax_spec_engine(name):
    kw = dict(CASES[name])
    jcfg, tcfg = config_pair(**kw)
    gen = trace.gen_local_only if name == "fixture-local" \
        else trace.gen_uniform_random
    traces = _traces(tcfg, 24, seed=3, gen=gen)
    te, got = run_pair(jcfg, tcfg, traces, trace_msgs=True,
                       debug_invariants=name in ("mesi", "moesi"))
    assert got["stall"] is None
    assert got["instructions"] == sum(len(t) for t in traces)
    assert got["msg_log"]
    if "ic" in kw:
        assert got["link_stats"]["traversals"]
    if "fault" in kw:
        assert got["stats"]["fault_retransmissions"] > 0


def test_head_quirks_fixture_semantics_match_or_stall_alike():
    """``Semantics.head_quirks()`` (drop policy) on uniform traffic:
    both engines run or stall alike, with the same diagnostic text."""
    traces = _traces(tconfig.SystemConfig(num_procs=4), 32, seed=1)
    out = []
    for mod in (jconfig, tconfig):
        out.append(mod.SystemConfig(num_procs=4,
                                    semantics=mod.Semantics().head_quirks()))
    assert dataclasses.asdict(out[1].semantics) == \
        dataclasses.asdict(out[0].semantics)
    run_pair(*out, traces)


def test_replay_matches_jax_spec_engine():
    """An order recorded by one run, replayed strictly and batched."""
    jcfg, tcfg = config_pair(num_procs=4)
    traces = _traces(tcfg, 16, seed=5)
    te, _ = run_pair(jcfg, tcfg, traces)
    order = trace.parse_instruction_order(
        trace.format_instruction_order(te.issue_log))
    from hpa2_tpu.utils.trace import IssueRecord as JIssueRecord

    for batched in (False, True):
        je = JSpecEngine(jcfg, _jax_traces(traces), replay_batched=batched,
                         replay_order=[JIssueRecord(*dataclasses.astuple(r))
                                       for r in order])
        tx = SpecEngine(tcfg, traces, replay_order=order,
                        replay_batched=batched)
        assert observed(tx, _run(tx)) == observed(je, _run(je))


def _jax_traces(traces):
    from hpa2_tpu.models.protocol import Instr as JInstr

    return [[JInstr(i.op, i.address, i.value) for i in tr] for tr in traces]


def test_continue_with_matches_jax_spec_engine():
    jcfg, tcfg = config_pair(num_procs=4, msg_buffer_size=8)
    traces = _traces(tcfg, 24, seed=9)
    je = JSpecEngine(jcfg, _jax_traces([t[:12] for t in traces]))
    te = SpecEngine(tcfg, [t[:12] for t in traces])
    for eng, tr in ((je, _jax_traces(traces)), (te, traces)):
        eng.run()
        eng.continue_with([t[12:] for t in tr])
        eng.run()
    assert observed(te, None) == observed(je, None)


def test_severed_edge_stall_diagnostic_matches():
    jcfg, tcfg = config_pair(num_procs=4, fault=dict(
        drop=1.0, edge_sender=1, edge_receiver=0, seed=2))
    traces = _traces(tcfg, 12, seed=4)
    te, got = run_pair(jcfg, tcfg, traces, run_kw=dict(watchdog_cycles=64))
    assert got["stall"][0] == "StallDiagnostic"
    assert "watchdog" in got["stall"][1]


def test_generators_match_jax():
    cfg_j, cfg_t = config_pair(num_procs=8)
    for jgen, tgen in ((jgen_uniform_random, trace.gen_uniform_random),
                       (jgen_producer_consumer,
                        trace.gen_producer_consumer),
                       (jgen_local_only, trace.gen_local_only)):
        want = [[(i.op, i.address, i.value) for i in t]
                for t in jgen(cfg_j, 20, seed=6)]
        got = [[(i.op, i.address, i.value) for i in t]
               for t in tgen(cfg_t, 20, seed=6)]
        assert got == want
    from hpa2_tpu.utils.trace import gen_producer_consumer_arrays

    for w, g in zip(gen_producer_consumer_arrays(cfg_j, 3, 10, seed=2),
                    trace.gen_producer_consumer_arrays(cfg_t, 3, 10, seed=2)):
        assert (w == g).all()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_spec_checkpoint_resumes_across_packages(tmp_path, writer):
    """A run stopped at cycle 15 under faults, saved by one package and
    resumed by the other, ends equal to the straight run."""
    jcfg, tcfg = config_pair(num_procs=4, fault=dict(
        drop=0.2, duplicate=0.1, reorder=0.1, delay=0.1, seed=3),
        ic=dict(topology="mesh2d"))
    traces = _traces(tcfg, 16, seed=2)
    straight = SpecEngine(tcfg, traces, trace_msgs=True)
    straight.run()
    path = str(tmp_path / "ck.json")
    if writer == "jax":
        eng = JSpecEngine(jcfg, _jax_traces(traces), trace_msgs=True)
        save, load = jcheckpoint.save_spec_state, checkpoint.load_spec_state
    else:
        eng = SpecEngine(tcfg, traces, trace_msgs=True)
        save, load = checkpoint.save_spec_state, jcheckpoint.load_spec_state
    while eng.cycle < 15:
        eng.step()
    save(path, eng)
    resumed = load(path)
    resumed.run()
    assert observed(resumed, None) == observed(straight, None)


def test_parity_harness_on_a_jax_written_run_set(tmp_path):
    """``utils/parity.py`` on a run set (dumps and
    ``instruction_order.txt``) that the JAX spec engine wrote."""
    jcfg, tcfg = config_pair(num_procs=4)
    traces = _traces(tcfg, 12, seed=8)
    suite = tmp_path / "suite"
    run_set = suite / "run_1"
    run_set.mkdir(parents=True)
    for n, tr in enumerate(traces):
        (suite / f"core_{n}.txt").write_text("".join(
            f"RD 0x{i.address:02X}\n" if i.op == "R"
            else f"WR 0x{i.address:02X} {i.value}\n" for i in tr))
    je = JSpecEngine(jcfg, _jax_traces(traces))
    je.run()
    (run_set / "instruction_order.txt").write_text(
        jformat_order(je.issue_log))
    for d in je.snapshots():
        (run_set / f"core_{d.proc_id}_output.txt").write_text(
            jformat(d, jcfg))
    assert parity.discover_run_sets(str(suite)) == [str(run_set)]
    assert parity.check_suite(str(suite), tcfg) == {str(run_set): {}}
    # a wrong dump is reported, against that node only
    bad = run_set / "core_1_output.txt"
    bad.write_text(bad.read_text().replace("0x", "0y", 1))
    diffs = parity.check_suite(str(suite), tcfg)[str(run_set)]
    assert sorted(diffs) == [1] and "0y" in diffs[1]


def test_instr_and_ring_are_the_ports_own():
    ring = trace.TraceRing(maxlen=2)
    for c in range(3):
        ring.record(c, 0, 1, 0, 0x10)
    assert len(ring) == 2 and ring.lines()[0].startswith("cycle 1: 0 -> 1")
    assert Instr.__module__ == "hpa2_tpu_torch.models.protocol"
