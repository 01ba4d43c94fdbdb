"""Topology-aware interconnect model: the static topologies (hop paths
and base latencies) of ``hpa2_tpu/interconnect/topology.py``, which the
general engine's step bakes in as constants.  The spec engine's
per-cycle ``LinkTracker`` (``delay.py``) is not ported."""

from hpa2_tpu_torch.interconnect.topology import (
    TOPOLOGIES,
    Topology,
    build_topology,
)

__all__ = ["TOPOLOGIES", "Topology", "build_topology"]
