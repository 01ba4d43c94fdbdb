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

The port's copy of ``predicted_stats`` (``hpa2_tpu/analysis/
occupancy.py:35-69``), over the port's ``ops/schedule.py``: the bench's
scheduler record (``hpa2_tpu_torch/bench.py``) reads it.  The JAX
module's table renderer serves ``python -m hpa2_tpu.analysis``, which
the port does not have yet (ROADMAP queue 1 item 6).
"""

from __future__ import annotations

from typing import Optional

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
