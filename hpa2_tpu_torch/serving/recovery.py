"""Checkpointed live migration: the fault-tolerant serving supervisor,
the port's own copy of ``hpa2_tpu/serving/recovery.py``.

:func:`supervised_serve` wraps the plain serving loops
(:mod:`hpa2_tpu_torch.serving.loop`) in a recovery driver:

- **checkpoint** — at every ``checkpoint_every``-th interval barrier
  the supervisor snapshots the run: on the jax backend a schema-v2
  ``save_state`` npz of the whole resident-row
  :class:`~hpa2_tpu_torch.ops.state.SimState` (copied to the host by
  ``save_state``; the JAX package gathers sharded layouts with
  ``fetch_host_state``, and the port has one device) plus a row→job
  manifest; on the fast path a JSON manifest (lane state lives inside
  the kernel's planes, so its recovery is replay-based);
- **detect** — :class:`~hpa2_tpu_torch.service.failover.FailureInjector`
  raises :class:`InjectedFailure` per the seeded plan, and genuine
  :class:`StallError`\\ s from the watchdog path are caught the same
  way, and nothing else: a CUDA error, or a kernel that fails to build
  or launch, propagates as a crash;
- **recover** — in-flight jobs *evacuate* to the next target spec
  (``kill``/``hang`` rotate to a different backend or shard count —
  a *migration*; ``poison`` re-runs on a fresh session of the same
  spec).  When both the checkpoint and the target are the jax batch
  engine, live rows resume **mid-state** from the npz (the
  checkpoint's bit-identical resume contract); otherwise jobs replay
  from their manifests — either way the final dumps are byte-identical
  to an unfailed run, because each job's simulation is deterministic
  and independent of lane placement, admission timing and backend.

The primary's window schedule travels with a migration: a fast-path
primary windows its traces, so its ``jax`` target runs with
``jax_window`` (``BatchLaneSession``'s window emulation).  Targets may
shard data (``pallas-sharded``, ``jax`` with ``data_shards``) and the
fast path's nodes (``pallas-node-sharded`` with ``node_shards``; the
CLI's ``--migrate-to pallas:D:N`` names it).  A session
that holds ranks is closed whenever its attempt ends, before the next
session takes the cards: after a kill, a hang or a poison as after a
clean finish.

Determinism: the failure plan is config data; the supervisor adds no
RNG and keys every decision off interval barriers and admission
order.  Two runs of the same plan take the same checkpoints, fire the
same failures, and migrate the same jobs.
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

from hpa2_tpu_torch.config import FailurePlan, SystemConfig
from hpa2_tpu_torch.ops.layout import StallError
from hpa2_tpu_torch.serving.ingest import JobSource
from hpa2_tpu_torch.serving.jobs import Job, JobResult
from hpa2_tpu_torch.serving.loop import ServingStats, build_serving
from hpa2_tpu_torch.service.failover import (
    FailureInjector, InjectedFailure, RecoveryLog)
from hpa2_tpu_torch.utils.checkpoint import load_state, save_state

#: serve()/build_serving() keywords that define a migration target —
#: everything else (resident, window, policy, ...) is shared geometry.
SPEC_KEYS = ("backend", "data_shards", "node_shards")


def default_targets(backend: str) -> List[Dict]:
    """Where to migrate when the caller names no targets: cross the
    pallas ↔ jax divide (kills must land on a *different* backend),
    and fold sharded sessions back to single-chip lanes — a shard
    failure shouldn't require the same mesh to still exist."""
    if backend == "jax":
        return [{"backend": "pallas", "data_shards": 1}]
    if backend == "pallas-node-sharded":
        return [{"backend": "pallas", "node_shards": 1}]
    return [{"backend": "jax", "data_shards": 1}]


class _RecordingSource(JobSource):
    """Wraps the real feed; remembers every job it ever handed out (in
    admission order, with its poll timestamp) so the supervisor can
    rebuild the outstanding work-list after a failure."""

    def __init__(self, inner: JobSource):
        self.inner = inner
        self.seen: List[Job] = []
        self.seen_at: Dict[str, float] = {}

    def poll(self) -> List[Job]:
        jobs = self.inner.poll()
        if jobs:
            now = time.perf_counter()
            for j in jobs:
                self.seen.append(j)
                self.seen_at.setdefault(j.job_id, now)
        return jobs

    @property
    def exhausted(self) -> bool:
        return self.inner.exhausted

    def wait(self, timeout_s: float) -> None:
        self.inner.wait(timeout_s)

    def close(self) -> None:
        self.inner.close()

    @property
    def shed_jobs(self) -> int:
        return int(getattr(self.inner, "shed_jobs", 0) or 0)


class _ReplaySource(JobSource):
    """Evacuated jobs first (one wave, original admission order), then
    whatever the live feed still delivers."""

    def __init__(self, replay: List[Job], inner: JobSource):
        self._replay = list(replay)
        self.inner = inner

    def poll(self) -> List[Job]:
        wave, self._replay = self._replay, []
        return wave + self.inner.poll()

    @property
    def exhausted(self) -> bool:
        return not self._replay and self.inner.exhausted

    def wait(self, timeout_s: float) -> None:
        self.inner.wait(timeout_s)

    def close(self) -> None:
        self.inner.close()

    @property
    def shed_jobs(self) -> int:
        return int(getattr(self.inner, "shed_jobs", 0) or 0)




def _write_json(path: str, doc: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)


class ServeSupervisor:
    """One fault-tolerant serving run (see the module docstring).

    ``targets`` is the migration rotation — a list of dicts over
    :data:`SPEC_KEYS` tried in order (cycling) on each ``kill``/
    ``hang``; ``poison`` always re-runs on the failed spec.  Every
    serve keyword not in SPEC_KEYS is shared across attempts.
    """

    def __init__(
        self,
        config: SystemConfig,
        source: JobSource,
        *,
        plan: Optional[FailurePlan] = None,
        targets: Optional[List[Dict]] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 1,
        detect_after: int = 2,
        max_recoveries: int = 8,
        emit: Optional[Callable[[JobResult], None]] = None,
        **serve_kwargs,
    ):
        if plan is None:
            plan = config.failures
        self.config = config
        self.plan = plan
        self.recorder = _RecordingSource(source)
        self.primary = {
            "backend": serve_kwargs.pop("backend", "pallas"),
            "data_shards": serve_kwargs.pop("data_shards", 1),
            "node_shards": serve_kwargs.pop("node_shards", 1),
        }
        self.targets = list(
            targets if targets is not None
            else default_targets(self.primary["backend"]))
        self.ck_dir = checkpoint_dir
        self.ck_every = max(1, int(checkpoint_every))
        self.max_recoveries = int(max_recoveries)
        self.user_emit = emit
        self.kwargs = serve_kwargs
        # the primary's segment schedule, preserved across backends:
        # a pallas primary windows its traces (quiescence barrier
        # every `window` entries), so a jax migration target replays
        # the same schedule via jax_window; a jax primary is
        # unwindowed, so a pallas target gets one whole-trace window.
        # Either way the migrated jobs' dumps stay byte-identical.
        self.sched_window = (
            None if self.primary["backend"] == "jax"
            else int(serve_kwargs.get("window", 16)))
        self.log = RecoveryLog()
        self.injector = (
            FailureInjector(plan, detect_after=detect_after)
            if plan is not None and plan.enabled else None
        )
        self._results: Dict[str, JobResult] = {}
        self._last_ck: Optional[Tuple[int, str, Dict, Dict]] = None
        self._tix = 0

    # -- plumbing ------------------------------------------------------

    def _emit(self, res: JobResult) -> None:
        """Exactly-once result fanout: a job that completed both before
        a checkpoint-window failure and again after replay (the window
        between snapshot and detection) publishes only its first copy."""
        if res.job_id in self._results:
            return
        self._results[res.job_id] = res
        if self.user_emit is not None:
            self.user_emit(res)

    def _spec_kwargs(self, spec: Dict) -> Dict:
        kw = dict(self.kwargs)
        kw.update({k: spec[k] for k in SPEC_KEYS})
        if spec["backend"] == "jax":
            kw.pop("window", None)
            kw["jax_window"] = self.sched_window
        elif self.sched_window is None:
            # jax primary migrating onto a pallas target: a single
            # whole-trace window reproduces the unwindowed schedule
            kw["window"] = int(kw.get("max_trace_len", 1024))
        return kw

    # -- checkpointing -------------------------------------------------

    def _checkpoint(self, k: int, driver, spec: Dict) -> None:
        if self.ck_dir is None:
            return
        completed = sorted(self._results)
        manifest = {
            "interval": k,
            "spec": dict(spec),
            "completed": completed,
            "in_flight": [j.job_id for j in self.recorder.seen
                          if j.job_id not in self._results],
            "recovery": self.log.counters(),
        }
        state = getattr(getattr(driver, "session", None), "state", None)
        row_sys = getattr(driver, "row_sys", None)
        if state is not None and row_sys is not None:
            # jax batch backend: full mid-state snapshot (schema v2)
            jobs = driver._jobs
            manifest["rows"] = [
                jobs[int(s)].job_id if int(s) >= 0 else None
                for s in row_sys
            ]
            manifest["wait_of"] = {
                jobs[int(s)].job_id: int(w)
                for s, w in driver.wait_of.items()
                if int(s) < len(jobs)
            }
            path = os.path.join(self.ck_dir, f"recovery_{k}.npz")
            save_state(path, state, self.config,
                       extra_meta={"recovery": self.log.counters(),
                                   "serving": manifest})
        else:
            path = os.path.join(self.ck_dir, f"recovery_{k}.json")
            _write_json(path, manifest)
        self.log.checkpoints += 1
        self._last_ck = (k, path, dict(spec), manifest)

    def _hook(self, k: int, driver, spec: Dict) -> None:
        if k % self.ck_every == 0:
            self._checkpoint(k, driver, spec)
        if self.injector is not None:
            self.injector.hook(k, driver)

    # -- mid-state resume ----------------------------------------------

    def _resume_rows(self, next_spec: Dict) -> set:
        """jax → jax live migration: re-arm the last npz checkpoint's
        live rows on a fresh :class:`BatchLaneSession` and drive them to
        quiescence.
        Returns the resumed job ids; empty when the checkpoint or the
        target can't exchange mid-state (→ replay evacuation)."""
        if self._last_ck is None or next_spec["backend"] != "jax":
            return set()
        k, path, ck_spec, manifest = self._last_ck
        if ck_spec.get("backend") != "jax" or not path.endswith(".npz"):
            return set()
        from hpa2_tpu_torch.ops.engine import BatchLaneSession
        from hpa2_tpu_torch.ops.state import select

        state, _, meta = load_state(path, with_meta=True, device="cpu")
        serving = meta.get("serving", manifest)
        rows = serving.get("rows") or []
        wait_of = serving.get("wait_of") or {}
        by_id = {j.job_id: j for j in self.recorder.seen}
        live = [(i, jid) for i, jid in enumerate(rows)
                if jid is not None and jid not in self._results
                and jid in by_id]
        if not live:
            return set()
        sess = BatchLaneSession(
            self.config, len(rows),
            self.kwargs.get("max_trace_len", 1024),
            interval=self.kwargs.get("interval", 256),
            max_cycles=self.kwargs.get("max_cycles", 1_000_000),
            data_shards=next_spec.get("data_shards", 1),
            device=self.kwargs.get("device", "cuda"),
        )
        for i, _ in live:
            sess.admit(i, select(state, i))
        resumed: set = set()
        pending = dict(live)
        max_chunks = 2 + (-(-sess.max_cycles // sess.interval))
        chunks = 0
        while pending:
            sess.advance()
            quiet = sess.quiescent_rows()
            done = [i for i in pending if quiet[i]]
            for i, row in zip(done, sess.take_rows(done) if done else []):
                jid = pending.pop(i)
                job = by_id[jid]
                counters = sess.counters_of(row)
                res = JobResult(
                    job_id=jid,
                    dumps=sess.dumps_of(row),
                    counters=counters,
                    submitted_s=self.recorder.seen_at.get(
                        jid, time.perf_counter()),
                    retired_s=time.perf_counter(),
                    wait_intervals=int(wait_of.get(jid, 0)),
                    tenant=job.tenant,
                )
                sess.retire(i)
                self._emit(res)
                resumed.add(jid)
            chunks += 1
            if chunks > max_chunks:
                raise StallError(
                    f"resumed rows made no quiescence within "
                    f"~{sess.max_cycles} cycles after migration")
        self.log.lanes_resumed += len(resumed)
        self.log.record(
            "lanes_resumed", interval=k, count=len(resumed),
            jobs=sorted(resumed), target=dict(next_spec))
        return resumed

    # -- recovery ------------------------------------------------------

    def _next_spec(self, failed: Dict, kind: str) -> Dict:
        if kind == "poison" or not self.targets:
            # corruption: same spec, fresh session (an evacuation,
            # not a migration)
            return dict(failed)
        spec = dict(failed)
        spec.update(self.targets[self._tix % len(self.targets)])
        self._tix += 1
        for key in SPEC_KEYS:
            spec.setdefault(key, 1 if key != "backend" else "pallas")
        return spec

    def _recover(self, exc: Exception, spec: Dict
                 ) -> Tuple[Dict, List[Job]]:
        self.log.failures_detected += 1
        self.log.retries += 1
        if isinstance(exc, InjectedFailure):
            kind, at = exc.event.kind, exc.interval
            via = ("watchdog" if exc.event.kind == "hang"
                   else "interval_hook")
            diag = exc.diagnostic
        else:  # a genuine stall caught by the watchdog path
            kind, at, via, diag = "hang", -1, "watchdog", exc
        self.log.record(
            "failure_detected", kind=kind, interval=at, via=via,
            spec=dict(spec),
            diagnostic=(str(diag).splitlines()[0] if diag else None))
        nxt = self._next_spec(spec, kind)
        if nxt != spec:
            self.log.migrations += 1
            self.log.record("migration", interval=at,
                            source=dict(spec), target=dict(nxt))
        resumed = self._resume_rows(nxt)
        replay = [j for j in self.recorder.seen
                  if j.job_id not in self._results
                  and j.job_id not in resumed]
        self.log.evacuations += len(replay) + len(resumed)
        self.log.jobs_replayed += len(replay)
        self.log.record(
            "evacuation", interval=at, replayed=len(replay),
            resumed=len(resumed), target=dict(nxt))
        return nxt, replay

    # -- the run -------------------------------------------------------

    def run(self) -> Tuple[List[JobResult], ServingStats]:
        spec = dict(self.primary)
        replay: List[Job] = []
        attempt = 0
        while True:
            source: JobSource = (
                _ReplaySource(replay, self.recorder) if replay
                else self.recorder)
            cur = dict(spec)
            drv = build_serving(
                self.config, source, emit=self._emit,
                interval_hook=lambda k, d, _s=cur: self._hook(k, d, _s),
                **self._spec_kwargs(cur),
            )
            try:
                _, stats = drv.run()
                break
            except (InjectedFailure, StallError) as exc:
                attempt += 1
                if attempt > self.max_recoveries:
                    raise
                spec, replay = self._recover(exc, cur)
            finally:
                # the failed (or finished) session's ranks end before
                # the next session takes the cards
                close = getattr(drv.session, "close", None)
                if close is not None:
                    close()
        # supervisor-wide totals over the last attempt's stats shell
        results = list(self._results.values())
        stats.jobs_submitted = len(self.recorder.seen)
        stats.jobs_completed = len(results)
        stats.instructions = sum(
            r.counters.get("instructions", 0) for r in results)
        stats.latencies_s = [r.latency_s for r in results]
        self.log.shed_jobs = int(
            getattr(self.recorder.inner, "shed_jobs", 0) or 0)
        rec = self.log.as_dict()
        if any(v for v in rec.values()):
            stats.occupancy = dict(stats.occupancy)
            stats.occupancy["recovery"] = rec
        return results, stats


def supervised_serve(config: SystemConfig, source: JobSource,
                     **kwargs) -> Tuple[List[JobResult], ServingStats]:
    """:func:`~hpa2_tpu_torch.serving.loop.serve` with the fault-tolerance
    supervisor around it — accepts every serve keyword plus ``plan``,
    ``targets``, ``checkpoint_dir``, ``checkpoint_every``,
    ``detect_after`` and ``max_recoveries``."""
    return ServeSupervisor(config, source, **kwargs).run()
