"""Topology-aware interconnect model: the static topologies (hop paths
and base latencies) of ``hpa2_tpu/interconnect/topology.py``, which the
general engine's step bakes in as constants, and the spec engine's
per-cycle ``LinkTracker`` (``delay.py``), as ``hpa2_tpu.interconnect``
exports them."""

from hpa2_tpu_torch.interconnect.delay import LinkTracker
from hpa2_tpu_torch.interconnect.topology import (
    TOPOLOGIES,
    Topology,
    build_topology,
)

__all__ = ["TOPOLOGIES", "Topology", "build_topology", "LinkTracker"]
