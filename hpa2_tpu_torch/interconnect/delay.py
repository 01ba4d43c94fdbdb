"""Deterministic per-cycle link occupancy: the sequential reference.

One :class:`LinkTracker` instance models contention for one system.
Per delivery cycle, every *accepted* message is walked in the global
deterministic candidate order (phase, sender, emission order — exactly
the spec engine's ``_deliver`` walk, which the JAX step's candidate-grid
id order provably equals) and charged

    ``deliver_at = cycle + max(1, base_lat[src, dst]) + penalty``

where ``penalty`` is the queueing cost of finite link bandwidth:
each link carries ``bandwidth`` messages per cycle, so a message pays
``floor(prior_traversals / bandwidth)`` extra cycles per link on its
path, with ``prior_traversals`` counting the *earlier* accepted
messages this cycle that traversed that link (FIFO per link, tie-break
by walk position — i.e. by (node, mailbox order)).  The model is
memoryless across cycles: occupancy resets every cycle, so delivery
cycles are a pure function of config + trace — no RNG, no clocks
(enforced by the interconnect lint rule), and the JAX step computes
the identical function vectorially (ops/step.py ``topo_on`` block).

Variants:

  ``multicast``  one INV fan-out payload traverses a shared link once
                 for all destinations (the AXI-crossbar model,
                 PAPERS.md): within a fan-out, only the first receiver
                 (ascending) to use a link contributes occupancy;
                 later receivers ride along.  Riders still *see* the
                 group's single traversal in their own penalty prefix —
                 they queue behind the shared transfer, a deliberate
                 conservative-by-<=1-slot simplification that keeps the
                 spec walk and the JAX cumsum trivially identical.
  ``combining``  same-address READ_REQUESTs merge in the network
                 (Ultracomputer-style): only the first request this
                 cycle per address traverses; merged riders contribute
                 zero occupancy on every link (and are counted).

The tracker also keeps the per-link observability the stats schema
exports: total traversals, max single-cycle load, and an occupancy
histogram (spec side only — the JAX state carries traversals/max).

The port's copy of ``hpa2_tpu/interconnect/delay.py`` (l.1-198), kept
line for line because the port imports nothing of the JAX package; the
port's spec engine (``models/spec_engine.py``) drives it and the
general engine's step (``ops/step.py``) computes the same function on
tensors.
"""

from __future__ import annotations

import collections
from typing import Dict, Set, Tuple

import numpy as np

from hpa2_tpu_torch.interconnect.topology import Topology


class LinkTracker:
    def __init__(
        self,
        topo: Topology,
        bandwidth: int = 1,
        multicast: bool = False,
        combining: bool = False,
    ):
        if bandwidth < 1:
            raise ValueError("link bandwidth must be >= 1")
        self.topo = topo
        self.bandwidth = bandwidth
        self.multicast = multicast
        self.combining = combining
        L = topo.num_links
        # per-cycle state
        self._load = np.zeros(L, dtype=np.int64)
        self._mcast_links: Dict[Tuple[int, int], Set[int]] = {}
        self._combined_seen: Set[int] = set()
        # cumulative observability
        self.traversals = np.zeros(L, dtype=np.int64)
        self.max_load = np.zeros(L, dtype=np.int64)
        self.occupancy_hist: Dict[int, collections.Counter] = {
            l: collections.Counter() for l in range(L)
        }
        self.n_topo_delay = 0
        self.n_multicast_saved = 0
        self.n_combined = 0
        # paths as index lists (dense path_mat rows are slow to re-scan)
        self._paths = [
            [
                np.nonzero(topo.path_mat[s, d])[0].tolist()
                for d in range(topo.n)
            ]
            for s in range(topo.n)
        ]

    def begin_cycle(self) -> None:
        self._load[:] = 0
        self._mcast_links.clear()
        self._combined_seen.clear()

    def on_accept(
        self, cycle: int, sender: int, receiver: int,
        msg_type: int, addr: int, is_inv: bool, is_read_request: bool,
    ) -> int:
        """Charge one accepted message (called in walk order); returns
        its delivery cycle."""
        path = self._paths[sender][receiver]
        base = max(1, int(self.topo.base_lat[sender, receiver]))
        penalty = 0
        bw = self.bandwidth
        for l in path:
            penalty += int(self._load[l]) // bw
        combined = (
            self.combining
            and is_read_request
            and addr in self._combined_seen
        )
        if combined:
            self.n_combined += 1
        elif self.multicast and is_inv:
            used = self._mcast_links.setdefault((sender, addr), set())
            for l in path:
                if l in used:
                    self.n_multicast_saved += 1
                else:
                    used.add(l)
                    self._load[l] += 1
                    self.traversals[l] += 1
        else:
            for l in path:
                self._load[l] += 1
                self.traversals[l] += 1
        if self.combining and is_read_request:
            self._combined_seen.add(addr)
        delay = base + penalty
        self.n_topo_delay += delay - 1
        return cycle + delay

    def end_cycle(self) -> None:
        np.maximum(self.max_load, self._load, out=self.max_load)
        for l in np.nonzero(self._load)[0]:
            self.occupancy_hist[int(l)][int(self._load[l])] += 1

    # -- observability -------------------------------------------------

    def counters(self) -> Dict[str, int]:
        """Aggregate counters, only-when-nonzero (the one-stats-schema
        pattern: fault-free/ideal parity stays key-for-key exact)."""
        out = {}
        for key, val in (
            ("topo_delay_cycles", self.n_topo_delay),
            ("topo_multicast_saved", self.n_multicast_saved),
            ("topo_combined", self.n_combined),
        ):
            if val:
                out[key] = int(val)
        return out

    def link_stats(self) -> Dict[str, dict]:
        names = self.topo.link_names
        return {
            "traversals": {
                names[l]: int(self.traversals[l])
                for l in range(len(names))
                if self.traversals[l]
            },
            "max_load": {
                names[l]: int(self.max_load[l])
                for l in range(len(names))
                if self.max_load[l]
            },
            "occupancy_hist": {
                names[l]: dict(sorted(h.items()))
                for l, h in self.occupancy_hist.items()
                if h
            },
        }

    # -- checkpoint support (spec crash-resume) ------------------------

    def dump_state(self) -> dict:
        return {
            "traversals": self.traversals.tolist(),
            "max_load": self.max_load.tolist(),
            "hist": {
                str(l): {str(k): v for k, v in h.items()}
                for l, h in self.occupancy_hist.items()
                if h
            },
            "n_topo_delay": self.n_topo_delay,
            "n_multicast_saved": self.n_multicast_saved,
            "n_combined": self.n_combined,
        }

    def load_state(self, doc: dict) -> None:
        self.traversals[:] = np.asarray(doc["traversals"], dtype=np.int64)
        self.max_load[:] = np.asarray(doc["max_load"], dtype=np.int64)
        for l, h in doc.get("hist", {}).items():
            self.occupancy_hist[int(l)] = collections.Counter(
                {int(k): int(v) for k, v in h.items()}
            )
        self.n_topo_delay = int(doc["n_topo_delay"])
        self.n_multicast_saved = int(doc["n_multicast_saved"])
        self.n_combined = int(doc["n_combined"])
