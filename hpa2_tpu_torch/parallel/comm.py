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
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


class Collectives:
    """Count of the collectives this process has issued, by kind."""

    KINDS = ("ppermute", "all_to_all", "sum", "max", "min")

    def __init__(self) -> None:
        self.counts: Dict[str, int] = dict.fromkeys(self.KINDS, 0)

    def reset(self) -> None:
        self.counts = dict.fromkeys(self.KINDS, 0)

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
    ``dist.new_group`` requires, once a process for a shape."""
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
