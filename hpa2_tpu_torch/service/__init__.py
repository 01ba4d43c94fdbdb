"""Multi-tenant service plane over the port's always-on serving loop,
the counterpart of ``hpa2_tpu.service``.

- :mod:`hpa2_tpu_torch.service.wire`: the length-prefixed framed
  protocol: versioned frames for SUBMIT / ACK / RESULT streaming /
  NACK, with credit-based backpressure (overflow is a loud NACK, never
  a silent drop).
- :mod:`hpa2_tpu_torch.service.admission`: tenant weights, deadline
  classes, and the thread-safe admission ledger that fixes job order
  by ack sequence.
- :mod:`hpa2_tpu_torch.service.frontend`: :class:`WireJobSource`, the
  framed TCP listener the serving loop polls; results stream back to
  the owning *session*.
- :mod:`hpa2_tpu_torch.service.failover`: deterministic failure
  injection above the link layer (:class:`FailureInjector` driving the
  seeded :class:`~hpa2_tpu_torch.config.FailurePlan`) and the
  structured recovery log the supervisor publishes.

Quick start (server side)::

    from hpa2_tpu_torch.service import TenantTable, WireJobSource
    from hpa2_tpu_torch.serving import serve

    source = WireJobSource(config, tenants=TenantTable.parse("a:2,b:1"))
    results, stats = serve(config, source, policy="fair-drr",
                           emit=source.deliver,
                           tenant_weights=source.tenant_weights)

and the client::

    from hpa2_tpu_torch.service import WireClient
    with WireClient(host, port) as cli:
        ack = cli.submit({"id": "j0", "tenant": "a", "traces": ...})
        results = cli.finish()
"""

from hpa2_tpu_torch.service.admission import (
    DEADLINE_CLASSES, AdmissionLedger, AdmissionReject, AdmissionShed,
    TenantTable, resolve_deadline)
from hpa2_tpu_torch.service.failover import (
    FailureInjector, InjectedFailure, RecoveryLog, recovery_record)
from hpa2_tpu_torch.service.frontend import WireJobSource
from hpa2_tpu_torch.service.wire import (
    ACK, BYE, CREDIT, EOF, HEARTBEAT, HELLO, NACK, RESULT, SUBMIT,
    ConnectionLost, Frame, FrameReader, WireClient, WireError,
    WireNack, backoff_delay, encode_frame)

__all__ = [
    "ACK", "BYE", "CREDIT", "DEADLINE_CLASSES", "EOF", "Frame",
    "FrameReader", "HEARTBEAT", "HELLO", "NACK", "RESULT", "SUBMIT",
    "AdmissionLedger", "AdmissionReject", "AdmissionShed",
    "ConnectionLost", "FailureInjector", "InjectedFailure",
    "RecoveryLog", "TenantTable", "WireClient", "WireError",
    "WireJobSource", "WireNack", "backoff_delay", "encode_frame",
    "recovery_record", "resolve_deadline",
]
