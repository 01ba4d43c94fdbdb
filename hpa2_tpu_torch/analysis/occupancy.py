"""Static occupancy model for the ensemble scheduler.

Predicts the block-segments a run executes with and without the
occupancy scheduler (``schedule=`` on both ensemble backends) from a
trace-length distribution alone — WITHOUT running a simulator.  The
prediction replays the *exact* deterministic barrier policy the
engines drive (:class:`hpa2_tpu_torch.ops.schedule.LaneScheduler`), so the
modeled block-segment count equals a real scheduled run's counter not
within a tolerance band but bit-for-bit (the JAX package's
``tests/test_occupancy.py`` pins the equality).

The unit of cost is the **block-segment**: one grid block executing
one trace-window segment's while-to-quiescence loop.  Blocks whose
lanes have all drained are skipped by the in-kernel gate for ~free, so
block-segments with >= 1 live lane is the device work the gate cannot
remove — and the quantity the scheduler minimizes by compacting live
lanes into dense blocks and backfilling freed lanes from the
admission queue.

The port's copy of ``hpa2_tpu/analysis/occupancy.py``, over the
port's ``ops/schedule.py``: the bench's scheduler record
(``hpa2_tpu_torch/bench.py``) reads ``predicted_stats``, and ``python -m
hpa2_tpu_torch.analysis occupancy`` renders :func:`occupancy_table`.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from hpa2_tpu_torch.ops.schedule import (
    OccupancyStats, TenantWeights, simulate,
)


def predicted_stats(
    lengths: np.ndarray,
    window: int,
    block: int,
    *,
    resident: Optional[int] = None,
    groups: int = 1,
    threshold: float = 0.5,
    fused: bool = True,
    policy: str = "fcfs",
    deadline: Optional[np.ndarray] = None,
    tenant: Optional[np.ndarray] = None,
    tenant_weights: TenantWeights = None,
) -> OccupancyStats:
    """Model a scheduled run over per-system trace lengths: convert
    lengths to segment counts and replay the barrier policy.  ``fused``
    selects the launch accounting: the fused path costs one device
    program and zero host barriers per run; the host-barrier loop pays
    one of each per scheduling interval."""
    nseg = np.maximum(
        1, -(-np.asarray(lengths, dtype=np.int64) // int(window))
    )
    return simulate(
        nseg, resident=resident, block=block, groups=groups,
        threshold=threshold, fused=fused, policy=policy,
        deadline=deadline, tenant=tenant,
        tenant_weights=tenant_weights,
    )


#: Synthetic multi-tenant metadata for the policy-comparison table:
#: four tenants round-robin with 1:2:4:8 weights, and (seeded) a third
#: of the systems carrying a tight deadline.  Deterministic in
#: (batch, seed) so the table is reproducible.
TABLE_TENANTS = 4
TABLE_WEIGHTS = (1.0, 2.0, 4.0, 8.0)


def table_metadata(
    lengths: np.ndarray, window: int, resident: int, seed: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(deadline, tenant) arrays used by ``occupancy_table`` whenever a
    row's policy consumes them.  Deadlines: roughly one system in three
    (seeded) must finish within the perfect-packing drain estimate
    ``ceil(total segments / resident)`` — tight enough that admission
    order decides hit-vs-miss, so the column separates policies."""
    lengths = np.asarray(lengths, dtype=np.int64)
    batch = len(lengths)
    nseg = np.maximum(1, -(-lengths // int(window)))
    drain = max(1, -(-int(nseg.sum()) // max(1, int(resident))))
    rng = np.random.default_rng(seed)
    tenant = np.arange(batch, dtype=np.int64) % TABLE_TENANTS
    deadline = np.full(batch, -1, dtype=np.int64)
    tight = rng.random(batch) < (1.0 / 3.0)
    deadline[tight] = drain
    return deadline, tenant


def occupancy_table(
    batch: int,
    max_instrs: int,
    window: int,
    block: int,
    *,
    dists: Sequence[str] = ("uniform", "zipf"),
    spreads: Sequence[float] = (2.0, 4.0, 8.0),
    threshold: float = 0.5,
    resident: Optional[int] = None,
    groups: int = 1,
    seed: int = 0,
    fused: bool = True,
    policies: Sequence[str] = ("fcfs",),
) -> Tuple[str, int]:
    """The ``analysis occupancy`` report: scheduled vs lockstep
    block-segments per workload shape, plus the launch cost — host
    barriers and device programs per run (0 / 1 on the fused path,
    n_intervals / n_intervals on the PR-5 host loop).  Passing more
    than one admission policy renders one row per policy, turning the
    table into a side-by-side policy comparison (the ``--policy``
    flag).  The deadline/tenant-aware policies (``deadline-edf``,
    ``fair-drr``) run over deterministic synthetic metadata
    (:func:`table_metadata`: 4 round-robin tenants, 1:2:4:8 weights,
    ~1/3 of systems deadlined at the drain estimate) and fill the
    ``dlmiss`` / ``maxshr%`` columns; the legacy policies print "-"
    there.  Returns (table, rc) — rc is nonzero if the model ever
    predicts the scheduler doing MORE work than lockstep (a policy
    bug, not a modeling error)."""
    from hpa2_tpu_torch.utils.trace import heterogeneous_lengths

    r = resident if resident else batch
    lines = [
        f"Occupancy scheduler model  (batch={batch} resident={r} "
        f"block={block} window={window} max_instrs={max_instrs} "
        f"threshold={threshold} groups={groups} fused={fused})",
        f"{'dist':>8} {'spread':>6} {'policy':>13} {'lockstep':>9} "
        f"{'scheduled':>9} {'speedup':>8} {'live%':>6} {'wait':>6} "
        f"{'compact':>7} {'admit':>6} {'barrier':>7} {'progrm':>6} "
        f"{'dlmiss':>6} {'maxshr%':>7}",
    ]
    rc = 0
    for dist in dists:
        for spread in spreads:
            lens = heterogeneous_lengths(
                batch, max_instrs, dist, spread, seed
            )
            for policy in policies:
                tenanted = policy in ("deadline-edf", "fair-drr")
                if tenanted:
                    deadline, tenant = table_metadata(
                        lens, window, r, seed
                    )
                    st = predicted_stats(
                        lens, window, block, resident=resident,
                        groups=groups, threshold=threshold,
                        fused=fused, policy=policy, deadline=deadline,
                        tenant=tenant, tenant_weights=TABLE_WEIGHTS,
                    )
                    miss = f"{st.deadline_missed:>6}"
                    shares = st.tenant_live
                    total = sum(shares.values()) or 1
                    shr = f"{100 * max(shares.values()) / total:>7.1f}"
                else:
                    st = predicted_stats(
                        lens, window, block, resident=resident,
                        groups=groups, threshold=threshold,
                        fused=fused, policy=policy,
                    )
                    miss, shr = f"{'-':>6}", f"{'-':>7}"
                if st.block_segments > st.lockstep_block_segments:
                    rc = 1
                lines.append(
                    f"{dist:>8} {spread:>6.1f} {policy:>13} "
                    f"{st.lockstep_block_segments:>9} "
                    f"{st.block_segments:>9} {st.speedup:>7.2f}x "
                    f"{100 * st.mean_live_fraction:>5.1f} "
                    f"{st.wait_intervals_mean:>6.1f} "
                    f"{st.compactions:>7} {st.admissions:>6} "
                    f"{st.host_barriers:>7} {st.device_programs:>6} "
                    f"{miss} {shr}"
                )
    return "\n".join(lines), rc
