"""The framed wire protocol of the multi-tenant service plane: the
port's own copy of ``hpa2_tpu/service/wire.py`` (l.1-361), frame for
frame and byte for byte.

The JSONL socket feed (:class:`~hpa2_tpu_torch.serving.ingest.\
SocketJobSource`) is fire-and-forget: a client never learns whether a
job was admitted, results don't come back, and overload is a silent
drop at the TCP buffer.  The service plane replaces it with a
length-prefixed *framed* protocol with explicit acknowledgement and
credit-based backpressure:

- every frame is an 8-byte header + a JSON payload::

      >BBBxI  = magic (0xA2) | version (1) | type | pad | payload len

- the server opens with HELLO advertising this connection's admission
  *credits* and a ``session`` id; each SUBMIT consumes one credit and
  draws either an ACK (``{"id", "seq", "queue_pos"}``) or a loud NACK
  (``{"id", "reason"}``) — **never** a silent drop;
- credits replenish via CREDIT frames as submitted jobs are admitted
  into the scheduler, so a well-behaved client self-clocks to the
  server's admission rate;
- results stream back as RESULT frames while the connection is still
  submitting; EOF (client) / BYE (server) close the conversation.

ACK ``seq`` is the global admission sequence number — the order jobs
enter the scheduler, fixed at SUBMIT time by the server, independent
of client thread timing.  That is what makes multi-client ingest
deterministic *given the ack transcript*.

Resilience.  The TCP connection is no longer the
conversation: the server's HELLO names a *session*, and a client that
loses its socket mid-stream reconnects and sends its own HELLO
``{"resume": session, "last_seq": n}`` to re-attach — admission
credits, result ownership, and any results the server could not
deliver all survive on the session.  SUBMIT is *idempotent within a
session*: resubmitting an id the server already ACK'd replays the
original ACK (same ``seq``, flagged ``"dup": true``) instead of
NACKing, so a client that never saw its ACK can blindly resend.
:class:`WireClient` wires this up end to end: every socket op carries
a timeout, a dead server raises :class:`ConnectionLost` instead of
blocking forever, and ``retries > 0`` makes ``submit()``/``finish()``
transparently reconnect-resume under capped exponential backoff whose
jitter derives from a *seed*, not a runtime RNG.  The server emits
HEARTBEAT frames on idle connections so a stalled backend is
distinguishable from a slow one.

The JSONL feed remains for offline replay (jobs files); this module is
the live path.
"""

from __future__ import annotations

import json
import socket
import struct
import time
import zlib
from typing import List, Optional, Tuple

MAGIC = 0xA2
VERSION = 1

# frame types
HELLO = 1      # server -> client: {"version", "credits", "session"};
#                client -> server: {"resume": session, "last_seq": n}
SUBMIT = 2     # client -> server: a job record (jobs.py JSONL schema)
ACK = 3        # server -> client: {"id", "seq", "queue_pos"[, "dup"]}
NACK = 4       # server -> client: {"id", "reason"[, "shed"]}
RESULT = 5     # server -> client: a JobResult record chunk
CREDIT = 6     # server -> client: {"credits": n} replenish
EOF = 7        # client -> server: done submitting on this connection
BYE = 8        # server -> client: all results delivered, closing
HEARTBEAT = 9  # server -> client: liveness beacon on idle connections

FRAME_NAMES = {
    HELLO: "HELLO", SUBMIT: "SUBMIT", ACK: "ACK", NACK: "NACK",
    RESULT: "RESULT", CREDIT: "CREDIT", EOF: "EOF", BYE: "BYE",
    HEARTBEAT: "HEARTBEAT",
}

_HEADER = struct.Struct(">BBBxI")
MAX_PAYLOAD = 1 << 24  # 16 MiB — far beyond any job record


class WireError(Exception):
    """Framing violation: bad magic/version/type or oversized frame."""


class ConnectionLost(WireError):
    """The transport died under the conversation: connect refused, a
    socket timeout (dead or hung server), or the peer closing
    mid-stream.  Retryable — :class:`WireClient` with ``retries > 0``
    reconnects and resumes the session instead of surfacing this."""


class WireNack(Exception):
    """A SUBMIT was rejected by the server (the payload says why)."""

    def __init__(self, payload: dict):
        super().__init__(payload.get("reason", "rejected"))
        self.payload = payload

    @property
    def shed(self) -> bool:
        """True when the job was load-shed (overload degradation),
        not malformed — safe to resubmit later."""
        return bool(self.payload.get("shed"))


def encode_frame(ftype: int, payload: Optional[dict] = None) -> bytes:
    if ftype not in FRAME_NAMES:
        raise WireError(f"unknown frame type {ftype}")
    body = b"" if payload is None else json.dumps(
        payload, separators=(",", ":")).encode("utf-8")
    if len(body) > MAX_PAYLOAD:
        raise WireError(
            f"frame payload {len(body)} bytes exceeds {MAX_PAYLOAD}")
    return _HEADER.pack(MAGIC, VERSION, ftype, len(body)) + body


def backoff_delay(attempt: int, *, base_s: float = 0.05,
                  cap_s: float = 2.0, seed: int = 0) -> float:
    """Capped exponential backoff with deterministic jitter.

    The jitter fraction is a pure function of ``(seed, attempt)``
    (CRC32 — no RNG, no clock), so a retry schedule is reproducible
    from its seed: delay = min(cap, base * 2^attempt) * [0.5, 1.0).
    """
    ceiling = min(cap_s, base_s * (2.0 ** attempt))
    frac = (zlib.crc32(f"{seed}:{attempt}".encode()) % 1000) / 1000.0
    return ceiling * (0.5 + 0.5 * frac)


class Frame:
    __slots__ = ("ftype", "payload")

    def __init__(self, ftype: int, payload: dict):
        self.ftype = ftype
        self.payload = payload

    def __repr__(self) -> str:
        name = FRAME_NAMES.get(self.ftype, self.ftype)
        return f"Frame({name}, {self.payload!r})"


class FrameReader:
    """Incremental frame parser: ``feed(chunk)`` returns every frame
    completed by that chunk, buffering any partial tail.  Byte-at-a-
    time feeding reassembles identically — framing never depends on
    TCP segmentation."""

    def __init__(self) -> None:
        self._buf = bytearray()

    def feed(self, data: bytes) -> List[Frame]:
        self._buf.extend(data)
        out: List[Frame] = []
        while True:
            if len(self._buf) < _HEADER.size:
                return out
            magic, version, ftype, length = _HEADER.unpack_from(self._buf)
            if magic != MAGIC:
                raise WireError(f"bad magic 0x{magic:02x}")
            if version != VERSION:
                raise WireError(
                    f"wire version {version} != {VERSION}")
            if ftype not in FRAME_NAMES:
                raise WireError(f"unknown frame type {ftype}")
            if length > MAX_PAYLOAD:
                raise WireError(
                    f"frame payload {length} bytes exceeds {MAX_PAYLOAD}")
            if len(self._buf) < _HEADER.size + length:
                return out
            body = bytes(self._buf[_HEADER.size:_HEADER.size + length])
            del self._buf[:_HEADER.size + length]
            payload = json.loads(body.decode("utf-8")) if body else {}
            out.append(Frame(ftype, payload))


class WireClient:
    """A blocking framed client for tests, benchmarks and the CLI.

    ``submit()`` consumes one local credit (blocking on CREDIT
    replenishment when out) and returns the server's ACK payload;
    a NACK raises :class:`WireNack`.  ``force=True`` skips the local
    credit gate — the way to *prove* the server NACKs over-submission
    instead of dropping it.  RESULT frames that arrive interleaved are
    collected on :attr:`results`; ``finish()`` sends EOF and drains to
    BYE.

    Every socket operation carries ``timeout_s`` — a dead or hung
    server raises :class:`ConnectionLost` instead of blocking forever.
    With ``retries > 0``, ``submit()`` and ``finish()`` survive a lost
    connection: the client sleeps a seeded backoff
    (:func:`backoff_delay`), reconnects, resumes its server session
    (HELLO ``{"resume": ...}``) and resends — idempotent SUBMIT means
    a resend of an already-admitted id draws the *original* ACK seq.
    :attr:`retries` counts reconnections actually performed.
    """

    def __init__(self, host: str, port: int, *,
                 timeout_s: float = 30.0, retries: int = 0,
                 backoff_s: float = 0.05, backoff_cap_s: float = 2.0,
                 backoff_seed: int = 0):
        self._host, self._port = host, port
        self._timeout_s = timeout_s
        self._retries = int(retries)
        self._backoff_s = backoff_s
        self._backoff_cap_s = backoff_cap_s
        self._backoff_seed = int(backoff_seed)
        self._sock: Optional[socket.socket] = None
        self._reader = FrameReader()
        self._inbox: List[Frame] = []
        self.results: List[dict] = []
        self.credits = 0
        self.session: Optional[str] = None
        self.last_seq = -1
        self.retries = 0      # reconnections performed
        self.heartbeats = 0   # HEARTBEAT frames absorbed
        self._with_retry(lambda: None)  # connect (with backoff)

    # -- connection lifecycle -----------------------------------------

    def _teardown(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        self._sock = None
        self._reader = FrameReader()
        self._inbox = []

    def _connect(self) -> None:
        """Dial, read the server HELLO, and (re)attach the session."""
        resume = self.session
        try:
            self._sock = socket.create_connection(
                (self._host, self._port), timeout=self._timeout_s)
        except OSError as e:
            self._sock = None
            raise ConnectionLost(
                f"connect to {self._host}:{self._port} failed: {e}"
            ) from None
        self._reader = FrameReader()
        self._inbox = []
        hello = self._next_frame((HELLO,))
        if hello.payload.get("version") != VERSION:
            raise WireError(
                f"server wire version {hello.payload.get('version')}"
                f" != {VERSION}")
        self.credits = int(hello.payload.get("credits", 0))
        self.session = hello.payload.get("session")
        if resume is not None:
            # ask the server to re-attach the old conversation; its
            # reply HELLO reports the surviving credit balance (and
            # re-sends any results it could not deliver)
            self._send(encode_frame(
                HELLO, {"resume": resume, "last_seq": self.last_seq}))
            hello = self._next_frame((HELLO,))
            self.credits = int(hello.payload.get("credits", 0))
            if hello.payload.get("resumed"):
                self.session = resume
            else:
                self.session = hello.payload.get("session", self.session)

    def _with_retry(self, op):
        """Run ``op`` with the (re)connect-resume-backoff loop around
        it; ``op`` runs on a live connection."""
        attempt = 0
        while True:
            try:
                if self._sock is None:
                    self._connect()
                return op()
            except ConnectionLost:
                self._teardown()
                if attempt >= self._retries:
                    raise
                time.sleep(backoff_delay(
                    attempt, base_s=self._backoff_s,
                    cap_s=self._backoff_cap_s, seed=self._backoff_seed))
                attempt += 1
                self.retries += 1

    # -- frame plumbing -----------------------------------------------

    def _send(self, data: bytes) -> None:
        try:
            self._sock.sendall(data)
        except (socket.timeout, OSError) as e:
            raise ConnectionLost(f"send failed: {e}") from None

    def _pump(self) -> None:
        try:
            data = self._sock.recv(65536)
        except socket.timeout:
            raise ConnectionLost(
                f"server silent for {self._timeout_s}s"
            ) from None
        except OSError as e:
            raise ConnectionLost(f"recv failed: {e}") from None
        if not data:
            raise ConnectionLost(
                "server closed the connection mid-stream")
        self._inbox.extend(self._reader.feed(data))

    def _next_frame(self, wanted: Tuple[int, ...]) -> Frame:
        """Return the next frame of a wanted type, absorbing RESULT,
        CREDIT and HEARTBEAT frames that arrive in between."""
        while True:
            while self._inbox:
                fr = self._inbox.pop(0)
                if fr.ftype == RESULT:
                    self.results.append(fr.payload)
                elif fr.ftype == CREDIT:
                    self.credits += int(fr.payload.get("credits", 0))
                elif fr.ftype == HEARTBEAT:
                    self.heartbeats += 1
                if fr.ftype in wanted:
                    return fr
            self._pump()

    # -- the conversation ---------------------------------------------

    def _submit_once(self, record: dict, force: bool) -> dict:
        if not force:
            while self.credits <= 0:
                # blocked on backpressure: wait for a CREDIT frame
                self._next_frame((CREDIT,))
        self._send(encode_frame(SUBMIT, record))
        fr = self._next_frame((ACK, NACK))
        if fr.ftype == NACK:
            raise WireNack(fr.payload)
        if not fr.payload.get("dup"):
            # a replayed ack never consumed a fresh server credit
            self.credits -= 1
        self.last_seq = max(self.last_seq,
                            int(fr.payload.get("seq", -1)))
        return fr.payload

    def submit(self, record: dict, *, force: bool = False) -> dict:
        return self._with_retry(
            lambda: self._submit_once(record, force))

    def _finish_once(self) -> List[dict]:
        self._send(encode_frame(EOF))
        self._next_frame((BYE,))
        return self.results

    def finish(self) -> List[dict]:
        """EOF, then drain RESULT frames until the server says BYE."""
        return self._with_retry(self._finish_once)

    def close(self) -> None:
        self._teardown()

    def __enter__(self) -> "WireClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
