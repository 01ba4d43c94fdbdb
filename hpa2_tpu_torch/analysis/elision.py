"""Exact-replay model for event-driven cycle elision (the port of
``hpa2_tpu/analysis/elision.py``).

Predicts how many simulated cycles the event-driven device loop
(``hpa2_tpu_torch/ops/step.py``) elides — and how many instructions it
retires inside aggregated multi-hit fast-forwards — WITHOUT running
the general engine.  The prediction replays the *exact* jump policy the
device `propose` reduction implements, evaluated against the pure-
Python spec engine's state at every aligned cycle boundary, so the
modeled counters equal a real run's ``elided_cycles`` /
``multi_hit_retired`` stats not within a tolerance band but
bit-for-bit (the same contract
:mod:`hpa2_tpu_torch.analysis.occupancy` gives the scheduler counters;
tests/test_torch_elision_model.py pins the equality against
``TorchEngine`` and the JAX package's model).

Model structure: drive a :class:`~hpa2_tpu_torch.models.spec_engine.
SpecEngine` one cycle at a time.  Before each cycle, mirror the
device's candidate classes host-side —

* per-node **must-step** (0 when the node is send-blocked or its
  mailbox head is deliverable now),
* per-node **topology gate** (head ``deliver_at - cycle`` under a
  non-ideal interconnect),
* per-node **issuer hit-run length** (prefix of the next
  ``_ELISION_WINDOW`` trace entries that are silent cache hits
  against the current cache planes),
* the **watchdog** and **max_cycles** boundary scalars —

take the minimum ``j``, and account one fast-forward (``j - 1``
elided cycles, ``j`` retired instructions per ready issuer) when
``j > 0`` or one lockstep step otherwise.  The spec engine then
advances ``max(j, 1)`` real cycles, keeping model and device state
aligned for the next proposal.

``python -m hpa2_tpu_torch.analysis elision`` renders the model as a table
over workload shapes and asserts model == device on each row.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.models.spec_engine import SpecEngine
from hpa2_tpu_torch.models.protocol import CacheState

# mirror of the device constants (ops/step.py): the static multi-hit
# scan window and the "no constraint" distance marker
_ELISION_WINDOW = 64
_FAR = 2**31 - 1


@dataclasses.dataclass
class ElisionPrediction:
    """Modeled counters for one run (field names match the stats
    schema keys the device engines emit)."""

    cycles: int = 0            # final simulated-cycle count
    device_steps: int = 0      # loop iterations the elided run pays
    elided_cycles: int = 0     # cycles skipped by fast-forwards
    multi_hit_retired: int = 0  # instructions retired inside them
    #: per-scheduling-interval elided-cycle totals (empty for the
    #: unchunked whole-run loop) — the occupancy-model extension:
    #: sums to ``elided_cycles``
    per_interval: Tuple[int, ...] = ()

    @property
    def step_reduction(self) -> float:
        """Lockstep device steps over elided device steps."""
        if not self.device_steps:
            return 0.0
        return self.cycles / self.device_steps


def _propose_spec(
    eng: SpecEngine,
    max_cycles: int,
    watchdog_cycles: int,
) -> Tuple[int, int]:
    """The device ``propose`` reduction evaluated on spec state at a
    cycle boundary -> (j, n_issuers)."""
    cfg = eng.config
    topo_on = cfg.interconnect.enabled
    cands: List[int] = [max_cycles - eng.cycle]
    issuers = 0
    any_issuer = False
    for node in eng.nodes:
        blocked = bool(node.pending_sends)
        has_mail = bool(node.mailbox)
        if topo_on and has_mail:
            head_at = node.mailbox[0].deliver_at
            ready_now = head_at <= eng.cycle
            if not ready_now:
                cands.append(head_at - eng.cycle)
        else:
            ready_now = has_mail
        if blocked or ready_now:
            cands.append(0)
        if (
            not has_mail
            and not node.waiting
            and not blocked
            and node.pc < len(node.trace)
        ):
            any_issuer = True
            run = _hit_run(node)
            cands.append(run)
            if run:
                issuers += 1
        # a zero-run issuer forces must-step; count only hit-running
        # issuers toward multi_hit (j > 0 implies all issuers hit-run)
    if watchdog_cycles and not any_issuer:
        gap = eng.last_activity_cycle + watchdog_cycles - eng.cycle
        if gap >= 1:
            cands.append(gap)
    return min(cands), issuers


def _hit_run(node) -> int:
    """Prefix length of silent cache hits from ``node.pc``, capped at
    the device's static scan window (a longer run retires in several
    fast-forwards device-side, and the model sees the same cap)."""
    run = 0
    for k in range(min(_ELISION_WINDOW, len(node.trace) - node.pc)):
        instr = node.trace[node.pc + k]
        line = node.line_for(instr.address)
        if line.address != instr.address:
            break
        if instr.op == "W":
            if line.state not in (CacheState.MODIFIED, CacheState.EXCLUSIVE):
                break
        elif line.state == CacheState.INVALID:
            break
        run += 1
    return run


def predicted_elision(
    config: SystemConfig,
    traces: Sequence[Sequence],
    max_cycles: int = 1_000_000,
    watchdog_cycles: int = 10_000,
    interval: Optional[int] = None,
) -> ElisionPrediction:
    """Replay one system's run through the event-driven jump policy.

    ``interval`` models the *chunked* scheduled loop instead of the
    whole-run loop: jumps are additionally capped at the interval
    barrier (``chunk - c``, exactly ``ops.engine._chunk_loop``) and
    the prediction carries per-interval elided totals — the
    occupancy-model extension for scheduled runs.  The chunk loop's
    propose uses no watchdog/max_cycles boundary (both are enforced
    host-side at barriers), which the model mirrors.
    """
    eng = SpecEngine(config, traces)
    pred = ElisionPrediction()
    per_interval: List[int] = []
    c_in_interval = 0
    interval_elided = 0
    while not eng.quiescent() and eng.cycle < max_cycles:
        if watchdog_cycles and (
            eng.cycle - eng.last_activity_cycle >= watchdog_cycles
        ):
            break
        if interval:
            j, issuers = _propose_spec(eng, _FAR, 0)
            j = min(j, interval - c_in_interval)
        else:
            j, issuers = _propose_spec(eng, max_cycles, watchdog_cycles)
        pred.device_steps += 1
        if j > 0:
            pred.elided_cycles += j - 1
            interval_elided += j - 1
            pred.multi_hit_retired += j * issuers
            for _ in range(j):
                eng.step()
        else:
            eng.step()
        c_in_interval += max(j, 1)
        if interval and c_in_interval >= interval:
            per_interval.append(interval_elided)
            c_in_interval = 0
            interval_elided = 0
    if interval and (c_in_interval or not per_interval):
        per_interval.append(interval_elided)
    pred.cycles = eng.cycle
    pred.per_interval = tuple(per_interval)
    return pred


def predicted_batch_elision(
    config: SystemConfig,
    batch_traces: Sequence[Sequence[Sequence]],
    interval: int,
    max_cycles: int = 1_000_000,
) -> ElisionPrediction:
    """Replay a *batched scheduled* run (all rows resident, one
    group — ``BatchTorchEngine(schedule=Schedule(interval=...,
    resident=None))``) through the chunked shared-jump
    loop: lanes share one cycle counter, so the device jump is the
    minimum over every lane's candidates and EVERY lane's
    ``n_elided`` advances by ``j - 1`` per jump.  The prediction's
    ``elided_cycles`` therefore equals the lane-summed
    ``elided_cycles`` stat of the scheduled ensemble, and
    ``per_interval`` carries the per-scheduling-interval totals the
    static occupancy model cannot see (it has no protocol state)."""
    lanes = [SpecEngine(config, t) for t in batch_traces]
    b = len(lanes)
    pred = ElisionPrediction()
    per_interval: List[int] = []
    while any(not l.quiescent() for l in lanes):
        interval_elided = 0
        c = 0
        while c < interval and any(not l.quiescent() for l in lanes):
            j = min(
                min(_propose_spec(l, _FAR, 0)[0] for l in lanes),
                interval - c,
            )
            pred.device_steps += 1
            if j > 0:
                pred.elided_cycles += b * (j - 1)
                interval_elided += b * (j - 1)
                for lane in lanes:
                    pred.multi_hit_retired += (
                        j * _propose_spec(lane, _FAR, 0)[1]
                    )
                    for _ in range(j):
                        lane.step()
            else:
                for lane in lanes:
                    lane.step()
            c += max(j, 1)
            if max(l.cycle for l in lanes) >= max_cycles:
                break
        per_interval.append(interval_elided)
        if max(l.cycle for l in lanes) >= max_cycles:
            break
    pred.cycles = max(l.cycle for l in lanes)
    pred.per_interval = tuple(per_interval)
    return pred


def elision_table(
    procs: int = 4,
    instrs: int = 400,
    *,
    spreads: Sequence[float] = (2.0, 4.0, 8.0),
    tail: float = 0.01,
    write_frac: float = 0.3,
    seed: int = 3,
    topology: str = "ideal",
    verify: bool = True,
    device="cuda",
) -> Tuple[str, int]:
    """The ``analysis elision`` report: predicted elided cycles and
    device-step reduction per Zipf hot-set spread, checked against a
    real run of ``TorchEngine`` on ``device`` when ``verify`` (model
    counters must equal the engine's ``elided_cycles`` /
    ``multi_hit_retired`` stats AND the final cycle count,
    bit-for-bit).  Returns (table, rc) — rc
    nonzero on any model/device mismatch."""
    from hpa2_tpu_torch.config import InterconnectConfig, Semantics
    from hpa2_tpu_torch.utils.trace import gen_hot_hit_zipf

    config = SystemConfig(
        num_procs=procs,
        semantics=Semantics().robust(),
        interconnect=InterconnectConfig(topology=topology),
    )
    lines = [
        f"Cycle-elision model  (procs={procs} instrs={instrs} "
        f"tail={tail} write_frac={write_frac} topology={topology} "
        f"seed={seed})",
        f"{'spread':>6} {'cycles':>7} {'steps':>7} {'elided':>7} "
        f"{'multihit':>8} {'reduction':>9}  {'device':>14}",
    ]
    rc = 0
    for spread in spreads:
        traces = gen_hot_hit_zipf(
            config, instrs, seed=seed, write_frac=write_frac,
            spread=spread, tail=tail,
        )
        pred = predicted_elision(config, traces)
        status = "unverified"
        if verify:
            from hpa2_tpu_torch.ops.engine import TorchEngine

            eng = TorchEngine(config, traces, device=device).run()
            stats = eng.stats()
            dev = (
                eng.cycle,
                stats.get("elided_cycles", 0),
                stats.get("multi_hit_retired", 0),
            )
            mod = (pred.cycles, pred.elided_cycles, pred.multi_hit_retired)
            if dev == mod:
                status = "exact match"
            else:
                status = f"MISMATCH {dev}"
                rc = 1
        lines.append(
            f"{spread:>6.1f} {pred.cycles:>7} {pred.device_steps:>7} "
            f"{pred.elided_cycles:>7} {pred.multi_hit_retired:>8} "
            f"{pred.step_reduction:>8.2f}x  {status:>14}"
        )
    return "\n".join(lines), rc
