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

The port's copy of ``hpa2_tpu/analysis/topology.py``, over the port's
spec engine: the bench's topology study (``hpa2_tpu_torch/bench.py
--topology``) runs ``storm_traces`` and ``storm_run``, and ``python -m
hpa2_tpu_torch.analysis topology`` renders :func:`topology_table`.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

from hpa2_tpu_torch.config import InterconnectConfig, SystemConfig
from hpa2_tpu_torch.interconnect.topology import TOPOLOGIES
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


def topology_table(
    nodes: int = 8,
    rounds: int = 6,
    hop_latency: int = 1,
    bandwidth: int = 1,
    topologies: Sequence[str] = TOPOLOGIES,
) -> str:
    """The ``analysis topology`` report: one row per (topology,
    delivery variant) with run cycles, slowdown over ideal, total
    added delay cycles, the variants' savings counters, and the
    hottest link's peak single-cycle load."""
    base_cfg = SystemConfig(
        num_procs=nodes,
        max_instr_num=0,  # uncapped: the storm sets trace lengths
    )
    traces = storm_traces(base_cfg, rounds)
    ideal_cycles, _, _ = storm_run(base_cfg, traces)

    header = (
        f"{'topology':<14}{'variant':<12}{'cycles':>8}{'xideal':>8}"
        f"{'delay_cyc':>10}{'mc_saved':>9}{'combined':>9}{'peak_link':>10}"
    )
    lines = [
        f"invalidation storm: {nodes} nodes x {rounds} rounds, "
        f"hop={hop_latency}, bw={bandwidth} (ideal: {ideal_cycles} "
        "cycles)",
        header,
        "-" * len(header),
    ]
    for topo in topologies:
        if topo == "ideal":
            continue
        for vname, kw in VARIANTS:
            cfg = dataclasses.replace(
                base_cfg,
                interconnect=InterconnectConfig(
                    topology=topo,
                    hop_latency=hop_latency,
                    link_bandwidth=bandwidth,
                    **kw,
                ),
            )
            cycles, stats, link = storm_run(cfg, traces)
            peak = max(link["max_load"].values(), default=0)
            lines.append(
                f"{topo:<14}{vname:<12}{cycles:>8}"
                f"{cycles / ideal_cycles:>8.2f}"
                f"{stats.get('topo_delay_cycles', 0):>10}"
                f"{stats.get('topo_multicast_saved', 0):>9}"
                f"{stats.get('topo_combined', 0):>9}"
                f"{peak:>10}"
            )
    return "\n".join(lines)
