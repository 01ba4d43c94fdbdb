"""Always-on serving on the port: continuous-batching ingest over
resident lanes, the counterpart of ``hpa2_tpu.serving`` on one GPU
(the fast path's ``pallas`` backend and the general engine's ``jax``
backend).

- :mod:`hpa2_tpu_torch.serving.jobs`: the JSONL job format and
  generators.
- :mod:`hpa2_tpu_torch.serving.ingest`: file / socket / in-memory job
  sources and seeded arrival processes.
- :mod:`hpa2_tpu_torch.serving.loop`: the serving loops themselves:
  trace pool, overlapped admission pipeline, phase timers, no-rebuild
  guard (``ServingSession`` on the fast path, ``BatchServingSession``
  on the general engine).
- :mod:`hpa2_tpu_torch.serving.recovery`: the recovery supervisor:
  checkpoints, failure detection and migration between backends.

Quick start::

    from hpa2_tpu_torch.serving import serve, ListJobSource, synthetic_jobs
    jobs = synthetic_jobs(config, 64, 96, seed=7)
    results, stats = serve(config, ListJobSource(jobs),
                           backend="pallas", resident=16, window=16)
"""

from hpa2_tpu_torch.serving.ingest import (
    FileJobSource, JobSource, ListJobSource, SocketJobSource,
    poisson_arrivals, zipf_burst_arrivals)
from hpa2_tpu_torch.serving.jobs import (
    Job, JobResult, job_from_record, job_to_record, load_jobs_file,
    parse_jobs_lines, synthetic_jobs)
from hpa2_tpu_torch.serving.loop import (
    BatchServingSession, ServingSession, ServingStats, TracePool,
    build_serving, serve)
from hpa2_tpu_torch.serving.recovery import (
    ServeSupervisor, default_targets, supervised_serve)

__all__ = [
    "BatchServingSession", "FileJobSource", "Job", "JobResult",
    "JobSource", "ListJobSource", "ServeSupervisor", "ServingSession",
    "ServingStats", "SocketJobSource", "TracePool", "build_serving",
    "default_targets", "job_from_record", "job_to_record",
    "load_jobs_file", "parse_jobs_lines", "poisson_arrivals", "serve",
    "supervised_serve", "synthetic_jobs", "zipf_burst_arrivals",
]
