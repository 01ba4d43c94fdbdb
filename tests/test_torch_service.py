"""The port's service plane (``hpa2_tpu_torch.service``) against the JAX
package's (``hpa2_tpu.service``): frames byte for byte, the same
framing errors, tenant tables, deadline classes and admission ledger;
then the wire over TCP with the port's ``serve(device="cpu")`` behind
it, on the shapes of ``tests/test_service.py`` (over-submission draws a
NACK and drains, credits clock a client, two clients are admitted in
ack order, a malformed body NACKs after its ack) and of the sever test
of ``tests/test_failover.py``: a connection cut mid-ACK at admission
seq 2 resumes, and its resent SUBMIT draws the original seq."""

import threading

import numpy as np
import pytest

from hpa2_tpu import service as jservice
from hpa2_tpu.ops.pallas_engine import PallasEngine
from hpa2_tpu.ops.schedule import Schedule as JSchedule
from hpa2_tpu_torch.config import FailurePlan
from hpa2_tpu_torch.ops.session import CudaLaneSession
from hpa2_tpu_torch.service import (
    ACK, BYE, CREDIT, DEADLINE_CLASSES, EOF, HEARTBEAT, HELLO, NACK, RESULT,
    SUBMIT, AdmissionLedger, AdmissionReject, AdmissionShed, FrameReader,
    TenantTable, WireClient, WireError, WireJobSource, WireNack,
    backoff_delay, encode_frame, resolve_deadline,
)
from hpa2_tpu_torch.serving import job_to_record, serve, synthetic_jobs
from hpa2_tpu_torch.serving.loop import ServingSession
from torch_pairs import IGNORE_PLTPU_ANY, config_pair, dicts
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings(IGNORE_PLTPU_ANY)

SERVE_KW = dict(resident=4, window=8, block=4, device="cpu")


@pytest.fixture(scope="module")
def cfgs():
    return config_pair(True, num_procs=4)


@pytest.fixture(scope="module")
def jobs(cfgs):
    return synthetic_jobs(cfgs[1], 8, 24, seed=7, spread=3.0)


def _records(jobs, tenant_of=lambda i: ""):
    recs = []
    for i, j in enumerate(jobs):
        r = job_to_record(j)
        if tenant_of(i):
            r["tenant"] = tenant_of(i)
        recs.append(r)
    return recs


def _raised(fn, *args):
    """(exception type name, message) of ``fn(*args)``."""
    with pytest.raises(Exception) as e:
        fn(*args)
    return type(e.value).__name__, str(e.value)


# -- framing, tenants, deadlines and the ledger: equal to the JAX modules


def test_frames_equal_jax_byte_for_byte():
    frames = [(SUBMIT, {"id": "j0", "traces": [[["R", 1]]]}),
              (ACK, {"id": "j0", "seq": 0, "queue_pos": 0}),
              (RESULT, {"id": "j0", "latency_s": 0.25}),
              (HELLO, {"version": 1, "credits": 2, "session": "s0"}),
              (CREDIT, {"credits": 3}), (NACK, {"id": "x", "reason": "r"}),
              (HEARTBEAT, None), (EOF, None), (BYE, {})]
    blob = b"".join(encode_frame(t, p) for t, p in frames)
    assert blob == b"".join(jservice.encode_frame(t, p) for t, p in frames)
    got, jgot = [], []
    reader, jreader = FrameReader(), jservice.FrameReader()
    for i in range(len(blob)):
        got.extend(reader.feed(blob[i:i + 1]))
        jgot.extend(jreader.feed(blob[i:i + 1]))
    want = [(t, p or {}) for t, p in frames]
    assert [(f.ftype, f.payload) for f in got] == want
    assert [(f.ftype, f.payload) for f in jgot] == want
    assert [(f.ftype, f.payload) for f in FrameReader().feed(blob)] == want
    assert [backoff_delay(a, seed=s) for a in range(6) for s in (0, 3)] == [
        jservice.backoff_delay(a, seed=s) for a in range(6) for s in (0, 3)]


def test_framing_violations_raise_like_jax():
    good = encode_frame(BYE)
    bad = [b"\x00" * 8, bytes([good[0], 99]) + good[2:],
           bytes([good[0], good[1], 200]) + good[3:],
           good[:4] + (1 << 25).to_bytes(4, "big")]
    for blob in bad:
        name, msg = _raised(FrameReader().feed, blob)
        assert name == "WireError"
        assert (name, msg) == _raised(jservice.FrameReader().feed, blob)
    assert _raised(encode_frame, 200, {}) == _raised(
        jservice.encode_frame, 200, {})
    assert issubclass(WireError, Exception)


def test_tenant_tables_and_deadlines_match_jax():
    for spec in ("alice:4, bob:1.5", "", "a:1,b:2,c:0.5"):
        t, jt = TenantTable.parse(spec), jservice.TenantTable.parse(spec)
        assert t.weights == jt.weights and bool(t) == bool(jt)
        assert [t.weight_of(n) for n in ("alice", "a", "zz")] == [
            jt.weight_of(n) for n in ("alice", "a", "zz")]
    for spec in ("alice", "alice:heavy", "alice:0", ":3"):
        assert _raised(TenantTable.parse, spec) == _raised(
            jservice.TenantTable.parse, spec)
    assert DEADLINE_CLASSES == jservice.DEADLINE_CLASSES
    records = [{}, {"deadline": 5}, {"class": "interactive", "deadline": 99}]
    records += [{"class": name} for name in DEADLINE_CLASSES]
    for rec in records:
        assert resolve_deadline(rec) == jservice.resolve_deadline(rec)
    assert _raised(resolve_deadline, {"class": "platinum"}) == _raised(
        jservice.resolve_deadline, {"class": "platinum"})


def test_ledger_matches_jax():
    """The same calls on both ledgers give the same seqs, waves, credit
    returns and refusals."""
    tr = {"traces": []}
    dl = {"class": "interactive"}
    calls = [("register", 0)]
    calls += [("submit", 0, dict(tr, id=i)) for i in "abcz"]
    calls += [("submit", 0, tr), ("submit", 0, {"id": "x"}), ("wave",),
              ("submit", 0, dict(tr, id="c")), ("register", 1)]
    calls += [("submit", 1, dict(tr, id=i)) for i in "de"]
    calls += [("submit", 1, dict(tr, id="f", **dl)),
              ("submit", 1, dict(tr, id="g", **{"class": "batch"})),
              ("submit", 1, dict(tr, id="h", **{"class": "platinum"})),
              ("submit", 1, dict(tr, id="i", deadline=4)),
              ("submit", 1, dict(tr, id="j", **dl)),
              ("ack", "c"), ("ack", "zz"), ("transfer", 1, 7), ("wave",)]

    def play(ledger):
        out = []
        for c in calls:
            try:
                if c[0] == "register":
                    out.append(ledger.register(c[1]))
                elif c[0] == "submit":
                    out.append(ledger.try_submit(c[1], c[2]))
                elif c[0] == "wave":
                    wave, back = ledger.take_wave()
                    out.append(([(p.seq, p.conn) for p in wave], back))
                elif c[0] == "ack":
                    out.append(ledger.ack_of(c[1]))
                else:
                    out.append(ledger.transfer(c[1], c[2]))
            except Exception as e:
                out.append((type(e).__name__, str(e)))
            out.append(ledger.pending)
        return out

    got = play(AdmissionLedger(credits=4, shed_threshold=3))
    assert got == play(jservice.AdmissionLedger(credits=4, shed_threshold=3))
    refusals = [x[1].split(":")[0].split(" ")[0] for x in got
                if isinstance(x, tuple) and isinstance(x[0], str)]
    assert refusals == ["overload", "job", "job", "duplicate", "overload",
                        "unknown", "backpressure"]
    assert issubclass(AdmissionShed, AdmissionReject)


# -- the wire with the port's serve behind it -------------------------------


def test_over_submit_draws_nack_then_drains(cfgs, jobs):
    recs = _records(jobs)
    src = WireJobSource(cfgs[1], credits=2)
    cli = WireClient(*src.address)
    assert cli.credits == 2
    acks = [cli.submit(recs[0]), cli.submit(recs[1])]
    assert [a["seq"] for a in acks] == [0, 1]
    for _ in range(2):  # repeatable, never a hang
        with pytest.raises(WireNack, match="backpressure"):
            cli.submit(recs[2], force=True)
    streamed = []
    t = threading.Thread(target=lambda: streamed.extend(cli.finish()),
                         daemon=True)
    t.start()
    results, _ = serve(cfgs[1], src, emit=src.deliver, **SERVE_KW)
    t.join(timeout=30)
    cli.close()
    assert not t.is_alive()
    want = sorted(r["id"] for r in recs[:2])
    assert sorted(r.job_id for r in results) == want
    assert sorted(r["id"] for r in streamed) == want
    assert cli.credits == 2


def test_credit_replenishment_self_clocks(cfgs, jobs):
    recs = _records(jobs)
    src = WireJobSource(cfgs[1], credits=2)
    streamed, acks = [], []

    def client():
        with WireClient(*src.address) as cli:
            for r in recs:
                acks.append(cli.submit(r))
            streamed.extend(cli.finish())

    t = threading.Thread(target=client, daemon=True)
    t.start()
    results, _ = serve(cfgs[1], src, emit=src.deliver, **SERVE_KW)
    t.join(timeout=30)
    assert not t.is_alive()
    assert [a["seq"] for a in acks] == list(range(len(recs)))
    assert sorted(r["id"] for r in streamed) == sorted(r["id"] for r in recs)
    assert len(results) == len(recs)


def test_two_clients_admission_order_is_ack_order(cfgs, jobs):
    """Whatever interleaving the reader threads saw, the port's serving
    loop admits in ACK-seq order, and the served dumps equal the JAX
    package's one-shot run of the seq-ordered ensemble."""
    jcfg, tcfg = cfgs
    recs = _records(jobs, tenant_of=lambda i: ("a", "b")[i % 2])
    half = len(recs) // 2
    src = WireJobSource(tcfg, credits=16)
    acks = {}

    def client(mine):
        with WireClient(*src.address) as cli:
            for r in mine:
                acks[r["id"]] = cli.submit(r)
            cli.finish()

    ts = [threading.Thread(target=client, args=(recs[:half],)),
          threading.Thread(target=client, args=(recs[half:],))]
    for t in ts:
        t.start()
    drv = ServingSession(CudaLaneSession(tcfg, 4, 8, block=4, device="cpu"),
                         src, emit=src.deliver)
    results, stats = drv.run()
    for t in ts:
        t.join(timeout=30)
        assert not t.is_alive()
    seqs = sorted(acks.values(), key=lambda a: a["seq"])
    assert [a["seq"] for a in seqs] == list(range(len(recs)))
    assert [j.job_id for j in drv._jobs] == [a["id"] for a in seqs]
    by_id = {j.job_id: j for j in jobs}
    ordered = [by_id[a["id"]] for a in seqs]
    ref = PallasEngine(
        jcfg, *(np.stack([getattr(j, f) for j in ordered])
                for f in ("tr_op", "tr_addr", "tr_val", "tr_len")),
        block=4, trace_window=8, snapshots=False,
        schedule=JSchedule(resident=4, fused=False)).run()
    got = {r.job_id: r.dumps for r in results}
    for s, j in enumerate(ordered):
        assert dicts(got[j.job_id]) == dicts(ref.system_final_dumps(s))
    assert set(stats.compile_counts.values()) == {1}


def test_malformed_trace_body_nacks_after_ack(cfgs):
    src = WireJobSource(cfgs[1], credits=4)
    cli = WireClient(*src.address)
    ack = cli.submit({"id": "bad", "traces": [[["Q", 1]]] + [[]] * 3})
    assert ack["seq"] == 0
    assert src.poll() == []
    assert "bad instruction" in cli._next_frame((NACK,)).payload["reason"]
    cli.close()
    src.close()


def test_sever_mid_frame_resumes_with_idempotent_submit(cfgs, jobs):
    """``sever@2``: the server tears the connection mid-ACK at admission
    seq 2; the client reconnects, resumes its session and resends, and
    gets the original seq back flagged ``dup``; every result arrives
    exactly once."""
    recs = _records(jobs)
    src = WireJobSource(cfgs[1], failures=FailurePlan.parse("sever@2",
                                                           seed=3))
    acks, streamed, state = [], [], {}

    def client():
        cli = WireClient(*src.address, timeout_s=10.0, retries=4,
                         backoff_s=0.01, backoff_seed=3)
        for r in recs:
            acks.append(cli.submit(r))
        streamed.extend(cli.finish())
        state["retries"] = cli.retries
        cli.close()

    t = threading.Thread(target=client, daemon=True)
    t.start()
    results, _ = serve(cfgs[1], src, emit=src.deliver, **SERVE_KW)
    t.join(timeout=60)
    assert state.get("retries") == 1, "client thread died or never cut"
    assert [a["seq"] for a in acks] == list(range(len(recs)))
    assert acks[2].get("dup") is True
    assert not any(a.get("dup") for a in acks[:2] + acks[3:])
    want = sorted(r["id"] for r in recs)
    assert sorted(r["id"] for r in streamed) == want
    assert sorted(r.job_id for r in results) == want
