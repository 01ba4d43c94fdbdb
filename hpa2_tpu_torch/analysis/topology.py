"""Topology sensitivity study: invalidation-storm cost per topology.

Runs one fixed coherence workload — the *invalidation storm*: every
node reads the same line (building a full sharer set), then one node
writes it (a directory fan-out of INVs to everyone), with the writer
rotating per round — through the spec engine under every interconnect
topology and delivery variant: how many extra cycles each topology
costs over ``ideal``, and how much of that the ``multicast`` /
``combining`` delivery variants claw back.

Everything here is deterministic (the interconnect model has no RNG —
hpa2_tpu_torch/interconnect/), so the numbers are a pure function of the
arguments.

The port's copy of ``VARIANTS``, ``storm_traces`` and ``storm_run``
(``hpa2_tpu/analysis/topology.py:28-66``), over the port's spec engine:
the bench's topology study (``hpa2_tpu_torch/bench.py --topology``)
runs them.  The JAX module's table renderer serves ``python -m
hpa2_tpu.analysis``, which the port does not have yet (ROADMAP queue 1
item 6).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.models.protocol import Instr

#: delivery variants rendered per topology, name -> config kwargs
VARIANTS = (
    ("unicast", {}),
    ("multicast", {"multicast": True}),
    ("combining", {"combining": True}),
    ("mcast+comb", {"multicast": True, "combining": True}),
)


def storm_traces(config: SystemConfig, rounds: int) -> List[List[Instr]]:
    """The invalidation-storm workload: per round, every node reads a
    shared line, then one node (rotating) writes it — the write's INV
    fan-out hits every other sharer at once, the worst case for a
    topology without multicast, and the all-read phase is the best
    case for request combining."""
    n = config.num_procs
    traces: List[List[Instr]] = [[] for _ in range(n)]
    for r in range(rounds):
        addr = r % (config.num_procs * config.mem_size)
        writer = r % n
        for i in range(n):
            traces[i].append(Instr("R", addr))
        traces[writer].append(Instr("W", addr, value=(r + 1) % 128))
    return traces


def storm_run(
    config: SystemConfig, traces: Sequence[Sequence[Instr]]
) -> Tuple[int, Dict[str, int], dict]:
    """-> (cycles, aggregate counters, per-link stats) for one spec
    run of the storm under ``config``'s interconnect."""
    from hpa2_tpu_torch.models.spec_engine import SpecEngine

    eng = SpecEngine(config, [list(t) for t in traces])
    eng.run()
    link = eng.link_stats() if eng.link_tracker is not None else {}
    return eng.cycle, dict(eng.stats()), link
