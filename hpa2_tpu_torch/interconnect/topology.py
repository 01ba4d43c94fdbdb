"""Topology registry: per-(src, dst) hop paths and base latencies.

The reference simulator teleports messages between mailboxes (SURVEY.md
§0 — no interconnect at all); the fault layer injects loss/reorder but
no *cost*.  This module is the static half of the interconnect model: a
named topology is compiled once into dense numpy tensors —

  ``hops[src, dst]``      number of links on the routed path,
  ``base_lat[src, dst]``  sum of per-link latencies along the path,
  ``path_mat[src, dst, l]`` link-incidence of the path (bool),

which both engines consume: the spec engine walks them scalar-by-scalar
(:class:`hpa2_tpu.interconnect.delay.LinkTracker`) and the JAX step
bakes them into the jitted program as constants (ops/step.py).  Every
function here is pure and deterministic — no RNG, no clocks — so
delivery cycles stay a pure function of config + trace (the lint rule
in hpa2_tpu/analysis/lint.py enforces this for the whole package).

Registered topologies (mirrored by ``config.TOPOLOGIES``):

  ``ideal``         zero links, zero base latency — today's behavior
                    (a message accepted in cycle c is handled in c+1).
  ``mesh2d``        R x C grid (R = largest divisor of N with R <= C),
                    XY dimension-ordered routing, one directed link per
                    neighbor direction, each ``hop_latency`` cycles.
  ``torus2d``       the mesh plus wraparound links; per dimension the
                    shorter direction is taken, ties broken positive.
  ``hierarchical``  two-tier ICI/DCN split: G groups (divisor of N
                    nearest sqrt(N)) of nodes around a group switch
                    (up/down links at ``hop_latency``) with all-to-all
                    inter-switch links at ``4 * hop_latency`` — the DCN
                    tier costs 4x the ICI tier.

The port's copy of ``hpa2_tpu/interconnect/topology.py`` (l.1-221): the
static topologies, kept line for line because the port imports nothing
of the JAX package.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, List, Tuple

import numpy as np

TOPOLOGIES = ("ideal", "mesh2d", "torus2d", "hierarchical")

# DCN (inter-switch) links cost this many ICI hops (hierarchical only)
DCN_LATENCY_FACTOR = 4


@dataclasses.dataclass(frozen=True)
class Topology:
    """One compiled topology (immutable; arrays are never mutated)."""

    name: str
    n: int
    hop_latency: int
    link_names: Tuple[str, ...]
    link_latency: np.ndarray  # [L] int32
    hops: np.ndarray          # [N, N] int32
    base_lat: np.ndarray      # [N, N] int32 (0 on the diagonal)
    path_mat: np.ndarray      # [N, N, L] bool

    @property
    def num_links(self) -> int:
        return len(self.link_names)


class _Builder:
    """Accumulates directed links + routed paths into the dense form."""

    def __init__(self, name: str, n: int, hop_latency: int):
        self.name = name
        self.n = n
        self.hop_latency = hop_latency
        self._idx: Dict[str, int] = {}
        self._lat: List[int] = []

    def link(self, label: str, latency: int) -> int:
        if label not in self._idx:
            self._idx[label] = len(self._lat)
            self._lat.append(latency)
        return self._idx[label]

    def finish(self, paths: Dict[Tuple[int, int], List[int]]) -> Topology:
        n, L = self.n, len(self._lat)
        lat = np.asarray(self._lat, dtype=np.int32).reshape(L)
        hops = np.zeros((n, n), dtype=np.int32)
        base = np.zeros((n, n), dtype=np.int32)
        pmat = np.zeros((n, n, L), dtype=bool)
        for (s, d), links in paths.items():
            hops[s, d] = len(links)
            base[s, d] = int(sum(lat[l] for l in links))
            for l in links:
                pmat[s, d, l] = True
        names = tuple(
            sorted(self._idx, key=self._idx.__getitem__)
        )
        return Topology(
            name=self.name, n=n, hop_latency=self.hop_latency,
            link_names=names, link_latency=lat, hops=hops,
            base_lat=base, path_mat=pmat,
        )


def _grid_shape(n: int) -> Tuple[int, int]:
    """R x C with R the largest divisor of n not exceeding sqrt(n)."""
    r = 1
    for d in range(1, int(math.isqrt(n)) + 1):
        if n % d == 0:
            r = d
    return r, n // r


def _build_grid(name: str, n: int, hop: int, wrap: bool) -> Topology:
    rows, cols = _grid_shape(n)
    b = _Builder(name, n, hop)

    def step_link(u: int, v: int) -> int:
        return b.link(f"n{u}->n{v}", hop)

    def walk_axis(cur: int, tgt: int, size: int) -> List[int]:
        """Steps (+1/-1 in grid coordinates) from cur to tgt along one
        axis; torus takes the shorter way round, ties positive."""
        if cur == tgt:
            return []
        fwd = (tgt - cur) % size
        if wrap and fwd > size - fwd:
            return [-1] * (size - fwd)
        if not wrap and tgt < cur:
            return [-1] * (cur - tgt)
        return [+1] * (fwd if wrap else tgt - cur)

    # register every neighbor link (both directions) so link ids are
    # stable regardless of which paths happen to use them
    for r in range(rows):
        for c in range(cols):
            u = r * cols + c
            for dr, dc in ((0, 1), (0, -1), (1, 0), (-1, 0)):
                rr, cc = r + dr, c + dc
                if wrap:
                    rr, cc = rr % rows, cc % cols
                elif not (0 <= rr < rows and 0 <= cc < cols):
                    continue
                v = rr * cols + cc
                if v != u:
                    step_link(u, v)

    paths: Dict[Tuple[int, int], List[int]] = {}
    for s in range(n):
        r0, c0 = divmod(s, cols)
        for d in range(n):
            if s == d:
                continue
            r1, c1 = divmod(d, cols)
            links: List[int] = []
            r, c = r0, c0
            # XY dimension-ordered routing: columns first, then rows
            for dc in walk_axis(c, c1, cols):
                nc = (c + dc) % cols if wrap else c + dc
                links.append(step_link(r * cols + c, r * cols + nc))
                c = nc
            for dr in walk_axis(r, r1, rows):
                nr = (r + dr) % rows if wrap else r + dr
                links.append(step_link(r * cols + c, nr * cols + c))
                r = nr
            paths[(s, d)] = links
    return b.finish(paths)


def _build_hierarchical(n: int, hop: int) -> Topology:
    root = math.sqrt(n)
    groups = min(
        (d for d in range(1, n + 1) if n % d == 0),
        key=lambda d: (abs(d - root), -d),
    )
    m = n // groups
    b = _Builder("hierarchical", n, hop)
    dcn = DCN_LATENCY_FACTOR * hop
    for i in range(n):
        g = i // m
        b.link(f"n{i}->s{g}", hop)
        b.link(f"s{g}->n{i}", hop)
    for g in range(groups):
        for h in range(groups):
            if g != h:
                b.link(f"s{g}->s{h}", dcn)
    paths: Dict[Tuple[int, int], List[int]] = {}
    for s in range(n):
        g = s // m
        for d in range(n):
            if s == d:
                continue
            h = d // m
            links = [b.link(f"n{s}->s{g}", hop)]
            if g != h:
                links.append(b.link(f"s{g}->s{h}", dcn))
            links.append(b.link(f"s{h}->n{d}", hop))
            paths[(s, d)] = links
    return b.finish(paths)


@functools.lru_cache(maxsize=32)
def build_topology(name: str, n: int, hop_latency: int = 1) -> Topology:
    """Compile topology ``name`` for ``n`` nodes (cached: the tensors
    are baked into jitted programs, so identity matters for the jit
    caches keyed on config)."""
    if name not in TOPOLOGIES:
        raise ValueError(
            f"unknown topology {name!r}; registered: {TOPOLOGIES}"
        )
    if n < 1:
        raise ValueError("topology needs n >= 1")
    if hop_latency < 1:
        raise ValueError("hop_latency must be >= 1")
    if name == "ideal":
        return _Builder("ideal", n, hop_latency).finish({})
    if name == "mesh2d":
        return _build_grid("mesh2d", n, hop_latency, wrap=False)
    if name == "torus2d":
        return _build_grid("torus2d", n, hop_latency, wrap=True)
    return _build_hierarchical(n, hop_latency)
