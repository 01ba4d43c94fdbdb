"""The wire frontend: a framed TCP listener that feeds the serving
loop through the admission ledger.  The port's own copy of
``hpa2_tpu/service/frontend.py`` (l.1-384); of a failure plan it
honours the ``sever`` events only, as that module does.

:class:`WireJobSource` is a drop-in
:class:`~hpa2_tpu_torch.serving.ingest.JobSource`: the serving loop polls it
once per admission opportunity exactly like the JSONL socket feed, but
every submission is acknowledged (ACK with the global admission seq)
or rejected loudly (NACK with a reason), and each connection is
credit-clocked so overload pushes back instead of silently dropping.

``poll()`` drains **one admission wave** from the ledger in seq order
— many small jobs arriving between two scheduler intervals enter the
scheduler as one batch, ordered by their ack sequence numbers, not by
reader-thread timing.  Results stream back to the *owning* session
as RESULT frames via :meth:`WireJobSource.deliver` (pass it as the
serving loop's ``emit`` callback); once a session has sent EOF and
its last result is delivered the server answers BYE and closes.

Sessions and resilience.  Ownership lives on a *session*,
not a TCP connection: the accept-time HELLO names a deterministic
session id (``s0, s1, ...`` in accept order) and a reconnecting
client re-attaches with HELLO ``{"resume": sid}``.  Admission credits
(the ledger is keyed by session id), the ack-replay cache that makes
SUBMIT idempotent, and results the server could not deliver all
survive the dead socket and flush on resume.  A session that dies
mid-conversation with work in flight keeps the source non-exhausted
until it resumes and finishes — a severed client can always come
back for its results.  Optional extras: ``heartbeat_s`` starts a
beacon thread (HEARTBEAT frames on every live connection) so clients
can tell a stalled server from a slow one; ``shed_threshold`` arms
the ledger's graceful degradation (batch-class jobs shed first with a
structured ``"shed": true`` NACK); ``failures`` injects the *sever*
events of a :class:`~hpa2_tpu_torch.config.FailurePlan` — when a SUBMIT's
ack seq matches a planned ``sever@seq``, the server writes a torn
partial ACK header and hard-closes the socket, exactly the mid-frame
cut the resume path must survive.
"""

from __future__ import annotations

import itertools
import socket
import threading
from typing import Dict, List, Optional

from hpa2_tpu_torch.config import FailurePlan, SystemConfig
from hpa2_tpu_torch.serving.ingest import JobSource
from hpa2_tpu_torch.serving.jobs import Job, JobResult, job_from_record
from hpa2_tpu_torch.service.admission import (
    AdmissionLedger, AdmissionReject, AdmissionShed, TenantTable,
    resolve_deadline)
from hpa2_tpu_torch.service.wire import (
    ACK, BYE, CREDIT, EOF, HEARTBEAT, HELLO, NACK, RESULT, SUBMIT,
    VERSION, FrameReader, WireError, encode_frame)


class _Conn:
    """One client connection: socket + send lock (the reader thread
    answers ACK/NACK while the serving thread streams RESULT/CREDIT)."""

    def __init__(self, conn_id: int, sock: socket.socket):
        self.id = conn_id
        self.sock = sock
        self.lock = threading.Lock()
        self.dead = False

    def send(self, ftype: int, payload: Optional[dict] = None) -> bool:
        data = encode_frame(ftype, payload)
        with self.lock:
            if self.dead:
                return False
            try:
                self.sock.sendall(data)
                return True
            except OSError:
                self.dead = True
                return False

    def sever(self, data: bytes) -> None:
        """Injected fault: write a torn prefix, then hard-close — the
        peer sees a partial frame followed by EOF mid-stream."""
        with self.lock:
            if not self.dead:
                try:
                    self.sock.sendall(data)
                except OSError:
                    pass
            self.dead = True
            try:
                self.sock.close()
            except OSError:
                pass

    def close(self) -> None:
        with self.lock:
            self.dead = True
            try:
                self.sock.close()
            except OSError:
                pass


class _Session:
    """One client *conversation*, surviving reconnects: admissions,
    result ownership, the ack-replay cache and any undelivered results
    live here, keyed by the HELLO-negotiated session id."""

    def __init__(self, sid: str, conn: _Conn):
        self.id = sid
        self.conn: Optional[_Conn] = conn
        self.acks: Dict[str, dict] = {}   # job id -> original ACK
        self.undelivered: List[dict] = [] # results awaiting resume
        self.outstanding = 0              # admitted, result not sent
        self.eof = False

    def send(self, ftype: int, payload: Optional[dict] = None) -> bool:
        c = self.conn
        return c is not None and c.send(ftype, payload)


class WireJobSource(JobSource):
    """Framed multi-tenant TCP feed (see the module docstring)."""

    def __init__(self, config: SystemConfig, host: str = "127.0.0.1",
                 port: int = 0, *, credits: int = 64, backlog: int = 8,
                 tenants: Optional[TenantTable] = None,
                 shed_threshold: int = 0, heartbeat_s: float = 0.0,
                 failures: Optional[FailurePlan] = None):
        self._config = config
        self.tenants = tenants or TenantTable()
        self.ledger = AdmissionLedger(credits,
                                      shed_threshold=shed_threshold)
        if failures is None:
            failures = config.failures
        self._severs = sorted(
            failures.of_kind("sever"), key=lambda ev: ev.at
        ) if failures is not None else []
        self._severed: set = set()   # seqs already fired
        self._lock = threading.Lock()
        self._conns: Dict[int, _Conn] = {}
        self._sessions: Dict[str, _Session] = {}
        self._owner: Dict[str, _Session] = {}
        self._open: set = set()    # session ids with a live, pre-EOF conn
        self._saw_conn = False
        self._ids = itertools.count()
        self._sids = itertools.count()
        self._closed = threading.Event()
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind((host, port))
        self._srv.listen(backlog)
        self._srv.settimeout(0.1)
        self.address = self._srv.getsockname()
        self._thread = threading.Thread(target=self._serve, daemon=True)
        self._thread.start()
        self._beacon: Optional[threading.Thread] = None
        if heartbeat_s > 0:
            self._beacon = threading.Thread(
                target=self._heartbeat, args=(heartbeat_s,), daemon=True)
            self._beacon.start()

    @property
    def tenant_weights(self) -> Optional[Dict[str, float]]:
        """The weight dict ``serve(tenant_weights=...)`` wants."""
        return dict(self.tenants.weights) or None

    @property
    def shed_jobs(self) -> int:
        """Batch-class jobs shed under overload (ledger counter)."""
        return self.ledger.shed_jobs

    # -- listener ------------------------------------------------------

    def _serve(self) -> None:
        while not self._closed.is_set():
            try:
                sock, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            c = _Conn(next(self._ids), sock)
            sess = _Session(f"s{next(self._sids)}", c)
            with self._lock:
                self._conns[c.id] = c
                self._sessions[sess.id] = sess
                self._open.add(sess.id)
                self._saw_conn = True
            budget = self.ledger.register(sess.id)
            c.send(HELLO, {"version": VERSION, "credits": budget,
                           "session": sess.id})
            threading.Thread(
                target=self._read_conn, args=(c, sess), daemon=True
            ).start()

    def _heartbeat(self, period_s: float) -> None:
        while not self._closed.wait(period_s):
            with self._lock:
                conns = [s.conn for s in self._sessions.values()
                         if s.conn is not None and not s.conn.dead]
            for c in conns:
                c.send(HEARTBEAT)

    def _resume(self, c: _Conn, fresh: _Session,
                payload: dict) -> _Session:
        """Re-attach ``c`` to the session the client asks to resume;
        falls back to the fresh accept-time session if it's unknown."""
        sid = str(payload.get("resume"))
        with self._lock:
            old = self._sessions.get(sid)
            resumable = (old is not None and old is not fresh
                         and not old.eof)
            if resumable:
                old.conn = c
                self._open.add(old.id)
                # the provisional session never admitted anything
                self._sessions.pop(fresh.id, None)
                self._open.discard(fresh.id)
        if not resumable:
            c.send(HELLO, {"version": VERSION, "resumed": False,
                           "session": fresh.id,
                           "credits": self.ledger.balance(fresh.id)})
            return fresh
        self.ledger.forget(fresh.id)
        c.send(HELLO, {"version": VERSION, "resumed": True,
                       "session": old.id,
                       "credits": self.ledger.balance(old.id)})
        # flush results that died with the previous socket
        with self._lock:
            stale, old.undelivered = old.undelivered, []
        for rec in stale:
            if not old.send(RESULT, rec):
                with self._lock:
                    old.undelivered.append(rec)
        self._maybe_bye(old)
        return old

    def _read_conn(self, c: _Conn, sess: _Session) -> None:
        reader = FrameReader()
        try:
            while not sess.eof:
                data = c.sock.recv(65536)
                if not data:
                    break
                for fr in reader.feed(data):
                    if fr.ftype == HELLO:
                        sess = self._resume(c, sess, fr.payload)
                    elif fr.ftype == SUBMIT:
                        self._on_submit(c, sess, fr.payload)
                    elif fr.ftype == EOF:
                        with self._lock:
                            sess.eof = True
                            self._open.discard(sess.id)
                        self._maybe_bye(sess)
                        break
                    else:
                        raise WireError(
                            f"unexpected client frame {fr.ftype}")
                if c.dead:
                    break   # severed under this reader's feet
        except (OSError, WireError, ValueError):
            # abrupt disconnect or framing violation: drop the
            # connection; everything already ACK'd stays admitted and
            # the session stays resumable while work is in flight
            c.close()
        finally:
            with self._lock:
                if sess.conn is c and c.dead:
                    self._open.discard(sess.id)
        # reader exits after EOF with the socket open — the serving
        # thread still streams RESULT frames and the closing BYE

    def _on_submit(self, c: _Conn, sess: _Session,
                   record: dict) -> None:
        job_id = str(record.get("id"))
        replay = sess.acks.get(job_id)
        if replay is not None:
            # idempotent SUBMIT: the client resent after losing our
            # ack — replay the original seq instead of NACKing
            c.send(ACK, {**replay, "dup": True})
            return
        try:
            seq, pos = self.ledger.try_submit(sess.id, record)
        except AdmissionShed as e:
            c.send(NACK, {"id": record.get("id"), "reason": str(e),
                          "shed": True})
            return
        except AdmissionReject as e:
            c.send(NACK, {"id": record.get("id"), "reason": str(e)})
            return
        ack = {"id": record.get("id"), "seq": seq, "queue_pos": pos}
        with self._lock:
            self._owner[job_id] = sess
            sess.outstanding += 1
            sess.acks[job_id] = ack
        if self._sever_at(seq):
            # planned mid-frame cut: the job IS admitted and the ack
            # cached — the client must recover it via resume + resubmit
            c.sever(encode_frame(ACK, ack)[:5])
            return
        c.send(ACK, ack)

    def _sever_at(self, seq: int) -> bool:
        for ev in self._severs:
            if ev.at == seq and seq not in self._severed:
                self._severed.add(seq)
                return True
        return False

    # -- the serving loop side ----------------------------------------

    def poll(self) -> List[Job]:
        wave, back = self.ledger.take_wave()
        jobs: List[Job] = []
        for p in wave:
            rec = dict(p.record)
            rec["deadline"] = resolve_deadline(rec)
            try:
                jobs.append(job_from_record(self._config, rec))
            except ValueError as e:
                # malformed past the ledger's checks (bad trace body):
                # still loud — a post-ack NACK, never a silent drop
                sess = self._owner.pop(str(rec.get("id")), None)
                if sess is not None:
                    sess.send(NACK,
                              {"id": rec.get("id"), "reason": str(e)})
                    with self._lock:
                        sess.outstanding -= 1
                    self._maybe_bye(sess)
        for key, n in back.items():
            sess = self._sessions.get(key)
            if sess is not None:
                sess.send(CREDIT, {"credits": n})
        return jobs

    def deliver(self, result: JobResult) -> None:
        """Stream one result to its owning session (pass as the
        serving loop's ``emit`` callback).  If the session's socket is
        down, the record parks on the session and flushes on resume."""
        sess = self._owner.pop(result.job_id, None)
        if sess is None:
            return
        rec = result.to_record()
        if not sess.send(RESULT, rec):
            with self._lock:
                sess.undelivered.append(rec)
        with self._lock:
            sess.outstanding -= 1
        self._maybe_bye(sess)

    def _maybe_bye(self, sess: _Session) -> None:
        with self._lock:
            done = (sess.eof and sess.outstanding <= 0
                    and not sess.undelivered)
        if done and sess.send(BYE):
            if sess.conn is not None:
                sess.conn.close()
            self.ledger.forget(sess.id)
            with self._lock:
                self._sessions.pop(sess.id, None)

    @property
    def exhausted(self) -> bool:
        if self._closed.is_set():
            return self.ledger.pending == 0
        with self._lock:
            resumable = any(
                not s.eof
                and (s.conn is None or s.conn.dead)
                and (s.outstanding > 0 or s.undelivered)
                for s in self._sessions.values())
            drained = self._saw_conn and not self._open and not resumable
        return drained and self.ledger.pending == 0

    def close(self) -> None:
        self._closed.set()
        try:
            self._srv.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns.values())
        for c in conns:
            c.close()
