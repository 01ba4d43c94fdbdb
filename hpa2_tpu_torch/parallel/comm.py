"""The collectives of the node axis on ``torch.distributed``, each
counted.

The JAX package names a mesh axis inside ``shard_map`` and lets XLA
lower the collectives; here every rank is a process of its own, and a
node group is a ``torch.distributed`` group of the ranks that hold the
node blocks of one system (of one data row, under ``GridEngine``).  The
JAX primitives map to:

* ``ppermute`` -> :meth:`NodeComm.ppermute`, one
  ``dist.batch_isend_irecv`` of this rank's send and receive;
* ``all_to_all`` (tiled, split and concat on axis 0) ->
  :meth:`NodeComm.all_to_all`, ``dist.all_to_all_single``;
* ``psum``/``pmax``/``pmin`` -> :meth:`NodeComm.all_reduce` with
  ``SUM``/``MAX``/``MIN``;
* ``axis_index`` -> :attr:`NodeComm.rank`, the rank in the node group.

Every call goes through :data:`COLLECTIVES`, so tests and the
``contracts`` analysis count the collectives of a cycle.  On the card
the backend is NCCL (each rank on its own card; NCCL refuses two ranks
on one), on the CPU gloo.

:class:`LocalComm` is the same interface for logical ranks that are
threads of one process on one device (``make_mesh(..., local=True)``):
each collective is a copy in memory behind a barrier, counted as
:class:`NodeComm` counts.  It is the port's counterpart of the
host-platform devices on which the JAX package runs ``shard_map`` in one
process, and lets a node-sharded run use one card.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class Collectives:
    """Count of the collectives this rank has issued, by kind: this
    thread's count (a rank is a process, or under :class:`LocalComm` a
    thread)."""

    KINDS = ("ppermute", "all_to_all", "sum", "max", "min")

    def __init__(self) -> None:
        self._tls = threading.local()

    @property
    def counts(self) -> Dict[str, int]:
        c = getattr(self._tls, "counts", None)
        if c is None:
            c = self._tls.counts = dict.fromkeys(self.KINDS, 0)
        return c

    def reset(self) -> None:
        self._tls.counts = dict.fromkeys(self.KINDS, 0)

    def snapshot(self) -> Dict[str, int]:
        return dict(self.counts)


COLLECTIVES = Collectives()

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


class NodeComm:
    """One rank's node group: ``ranks`` are the group's global ranks in
    node order (this rank among them), ``group`` its process group
    (None: the default group), ``world`` the group every rank of the run
    is in (the batch-global loop condition reduces over it)."""

    def __init__(self, ranks: Sequence[int], group=None, world=None):
        self.ranks = list(ranks)
        self.group = group
        self.world = world
        self.rank = self.ranks.index(dist.get_rank())
        self.size = len(self.ranks)

    def ppermute(self, x: torch.Tensor,
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """``jax.lax.ppermute``: ``perm`` lists ``(source, destination)``
        ranks of the group; a rank no pair sends to gets zeros."""
        dst = [d for s, d in perm if s == self.rank]
        src = [s for s, d in perm if d == self.rank]
        out = torch.zeros_like(x)
        ops = []
        if dst:
            ops.append(dist.P2POp(dist.isend, x.contiguous(),
                                  self.ranks[dst[0]], group=self.group))
        if src:
            ops.append(dist.P2POp(dist.irecv, out, self.ranks[src[0]],
                                  group=self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        COLLECTIVES.counts["ppermute"] += 1
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """Tiled ``jax.lax.all_to_all`` on axis 0 (split and concat):
        block ``p`` of ``x`` goes to rank ``p``, and block ``b`` of the
        result came from rank ``b``."""
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x.contiguous(), group=self.group)
        COLLECTIVES.counts["all_to_all"] += 1
        return out

    def all_reduce(self, x: torch.Tensor, op: str,
                   world: bool = False) -> torch.Tensor:
        """``psum``/``pmax``/``pmin`` (``op`` ``sum``/``max``/``min``)
        over the node group, or with ``world`` over every rank."""
        y = x.clone()
        dist.all_reduce(y, op=_OPS[op],
                        group=self.world if world else self.group)
        COLLECTIVES.counts[op] += 1
        return y

    def barrier(self) -> None:
        """Wait for every rank of the node group (not counted: no
        collective of the simulation)."""
        dist.barrier(group=self.group)


class LocalGroup:
    """The meeting point of a group of logical ranks: one slot a rank and
    a barrier.  ``abort`` breaks the barrier, so a failed rank never
    leaves the others waiting.

    ``turn`` (a lock shared by every group of the ranks) makes the ranks
    take turns on the host: a rank holds it while it runs and gives it
    up only to wait in a collective, so one thread at a time runs Python
    and the others sleep, instead of all of them handing the
    interpreter's lock back and forth at every call into PyTorch."""

    def __init__(self, ranks: Sequence[int],
                 turn: Optional[threading.Lock] = None):
        self.ranks = list(ranks)
        self.slots: Dict[int, torch.Tensor] = {}
        self.barrier = threading.Barrier(len(self.ranks))
        self.turn = turn

    def _wait(self) -> None:
        if self.turn is not None:
            self.turn.release()
        try:
            self.barrier.wait()
        finally:
            if self.turn is not None:
                self.turn.acquire()

    def gather(self, rank: int, x: torch.Tensor) -> List[torch.Tensor]:
        """Every rank's ``x`` (group order); the caller copies what it
        keeps, then calls :meth:`done`."""
        self.slots[rank] = x
        self._wait()
        return [self.slots[r] for r in self.ranks]

    def done(self) -> None:
        """Every rank has copied what it keeps: a rank may change the
        tensor it offered."""
        self._wait()

    def abort(self) -> None:
        self.barrier.abort()


class LocalComm:
    """A node group of logical ranks, threads of one process on one
    device: ``rank`` this thread's rank in the group (``ranks``, global
    ranks in node order), ``group`` and ``world`` the
    :class:`LocalGroup` of the node group and of every rank.  The
    collectives are :class:`NodeComm`'s, done in memory: each rank
    offers its tensor, waits for the others, copies what it receives
    and waits again.  On the card every rank enqueues on the device's
    default stream, so a copy is ordered after the kernels that wrote
    what it copies and before those that write it next."""

    def __init__(self, grank: int, group: LocalGroup, world: LocalGroup):
        self.grank = grank
        self.group = group
        self.world = world
        self.ranks = group.ranks
        self.rank = self.ranks.index(grank)
        self.size = len(self.ranks)

    def ppermute(self, x: torch.Tensor,
                 perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
        src = [s for s, d in perm if d == self.rank]
        got = self.group.gather(self.grank, x)
        out = got[src[0]].clone() if src else torch.zeros_like(x)
        self.group.done()
        COLLECTIVES.counts["ppermute"] += 1
        return out

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        got = self.group.gather(self.grank, x)
        out = torch.stack([g[self.rank] for g in got])
        self.group.done()
        COLLECTIVES.counts["all_to_all"] += 1
        return out

    def all_reduce(self, x: torch.Tensor, op: str,
                   world: bool = False) -> torch.Tensor:
        grp = self.world if world else self.group
        st = torch.stack(grp.gather(self.grank, x))
        if op == "sum":
            y = st.sum(0, dtype=x.dtype)
        elif op == "max":
            y = st.amax(0)
        else:
            y = st.amin(0)
        grp.done()
        COLLECTIVES.counts[op] += 1
        return y

    def barrier(self) -> None:
        """Wait for every rank of the node group (not counted)."""
        self.group._wait()


#: this thread's logical rank: (global rank, its node group's
#: ``LocalComm``, its data row) while a ``LocalPool`` runs it
_LOCAL = threading.local()


def set_local_rank(rank: Optional[Tuple[int, LocalComm, int]]) -> None:
    """Make this thread a logical rank (``parallel/launch.py:LocalPool``),
    or none (``None``)."""
    _LOCAL.rank = rank


def backend_for(device: torch.device) -> str:
    """NCCL on the card, gloo on the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


#: each ``data x node`` shape's groups, made once a process: a new
#: group is a new set of NCCL communicators, whose first calls are slow
_ROW_GROUPS: Dict[Tuple[int, int], list] = {}


def world_comm(node: int, data: int = 1) -> Tuple[NodeComm, int]:
    """This rank's node group in an initialized ``data x node`` world
    (rank ``d * node + i`` holds node block ``i`` of data row ``d``), and
    its data row.  Every rank creates every row's group, as
    ``dist.new_group`` requires, once a process for a shape.  In a
    logical rank's thread, its :class:`LocalComm`."""
    local = getattr(_LOCAL, "rank", None)
    if local is not None:
        _, comm, row = local
        if comm.world.barrier.parties != node * data or comm.size != node:
            raise ValueError(
                f"this logical rank's group is {comm.size} of "
                f"{comm.world.barrier.parties}; a {data}x{node} mesh needs "
                f"{node} of {node * data}")
        return comm, row
    world = dist.get_world_size()
    if world != node * data:
        raise ValueError(
            f"the process group has {world} ranks; a {data}x{node} mesh "
            f"needs {node * data}")
    rank = dist.get_rank()
    row = rank // node
    if data == 1:
        return NodeComm(range(node)), row
    if (node, data) not in _ROW_GROUPS:
        _ROW_GROUPS[(node, data)] = [
            dist.new_group(list(range(d * node, (d + 1) * node)))
            for d in range(data)]
    ranks = list(range(row * node, (row + 1) * node))
    return NodeComm(ranks, group=_ROW_GROUPS[(node, data)][row]), row
