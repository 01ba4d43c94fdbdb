"""Rank functions the port's sharded tests start with
``hpa2_tpu_torch.parallel.launch.spawn`` (gloo ranks on the CPU).  They
live in a module of their own that imports no JAX, so a spawned rank
starts in the time PyTorch takes to import."""

import numpy as np
import torch

#: the telemetry keys of ``exchange.forward``
FSTATS = ("sent", "hwm", "mc_saved", "combined", "overflow", "ovf_diag")


def exchange_dest(blk, peer):
    """Row 2 of an entry is the bit set of its destination shards."""
    return ((blk[2] >> peer) & 1) != 0


def exchange_fan(blk, peer):
    """Row 3 is an entry's receiver count (in any shard)."""
    return blk[3]


def exchange_rank(cases, size=None):
    """Each case ``(mode, inner, k, payloads)`` through this rank's
    ``exchange.forward`` (payload ``payloads[rank]``, destinations and
    fan from rows 2 and 3, combining key row 4 over 8 keys) and
    ``feedback`` of rows 5-6 of what arrived: the received blocks, their
    origins, the feedback on the local candidates and the telemetry, as
    numpy; and the collectives each case issued.  ``size``: the group's
    ranks (default the process group's; logical ranks pass theirs)."""
    torch.set_num_threads(1)
    from hpa2_tpu_torch.ops import exchange
    from hpa2_tpu_torch.parallel.comm import COLLECTIVES, world_comm

    comm, _ = world_comm(size or torch.distributed.get_world_size())
    out = []
    for mode, inner, k, payloads in cases:
        before = COLLECTIVES.snapshot()
        plan = exchange.make_plan(comm.size, mode, inner)
        payload = torch.from_numpy(payloads[comm.rank])
        bufs, origins, ctx, fs = exchange.forward(
            plan, comm, comm.rank, payload, exchange_dest, k,
            fan_fn=exchange_fan, ckey_row=4, nkeys=8)
        acc = exchange.feedback(plan, comm, [b[5:7] for b in bufs], ctx)
        after = COLLECTIVES.snapshot()
        out.append(dict(
            bufs=np.stack([b.numpy() for b in bufs]),
            origins=[int(o) for o in origins], acc=acc.numpy(),
            fs=np.stack([fs[key].numpy() for key in FSTATS]),
            collectives={key: after[key] - before[key] for key in after}))
    return out
