"""Start the ranks of a node-sharded run: the SPMD runtime of the node
axis (the JAX package's ``shard_map`` over a mesh becomes one process a
rank on ``torch.distributed``).

:func:`spawn` starts ``world`` ranks with ``torch.multiprocessing``
("spawn"), rank ``r`` on ``cuda:r`` (NCCL) or on the CPU (gloo).  They
meet at a ``FileStore`` in a fresh temporary directory, with no TCP
port, so runs side by side (pytest-xdist workers) never collide.  Each
rank runs one PyTorch intra-op thread, calls ``fn(*args)`` and hands
its return value back to the caller through a pickle in that directory;
a rank that raises fails the call with the rank's traceback.

:func:`join_torchrun` joins a group that ``torchrun`` already started
(its ``RANK``/``WORLD_SIZE``/``MASTER_ADDR`` environment), so the
engines run in place on every rank instead of spawning.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import traceback
from typing import Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from hpa2_tpu_torch.parallel.comm import backend_for


def join_torchrun(device="cuda") -> bool:
    """Join the ``torchrun`` group of this process's environment unless a
    group is up already; False when there is neither.  On the card the
    rank takes ``cuda:LOCAL_RANK``."""
    if dist.is_initialized():
        return True
    if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
        return False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend_for(dev), init_method="env://")
    return True


def _rank_main(rank: int, world: int, tmp: str, device: str,
               fn: Callable, args: Sequence) -> None:
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
    out = os.path.join(tmp, f"rank{rank}.pkl")
    try:
        store = dist.FileStore(os.path.join(tmp, "store"), world)
        dist.init_process_group(backend_for(dev), store=store, rank=rank,
                                world_size=world)
        try:
            result = ("ok", fn(*args))
        finally:
            dist.destroy_process_group()
    except BaseException:  # the caller re-raises it with the rank's name
        result = ("error", traceback.format_exc())
    with open(out + ".tmp", "wb") as f:
        pickle.dump(result, f)
    os.replace(out + ".tmp", out)


def _failed(tmp: str, procs) -> bool:
    """Has a rank failed: an error result, or an exit without one?"""
    for r, p in enumerate(procs):
        path = os.path.join(tmp, f"rank{r}.pkl")
        if os.path.exists(path):
            with open(path, "rb") as f:
                if pickle.load(f)[0] != "ok":
                    return True
        elif not p.is_alive() and p.exitcode is not None:
            return True
    return False


def spawn(fn: Callable, world: int, args: Sequence = (),
          device="cuda") -> List:
    """Run ``fn(*args)`` on ``world`` ranks of a fresh process group and
    return each rank's result, in rank order.  ``fn`` and ``args`` must
    pickle (``fn`` a module-level function).  On the card it needs
    ``world`` cards: NCCL takes one rank a card."""
    dev = torch.device(device)
    if world < 1:
        raise ValueError(f"world={world} ranks")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: hpa2_tpu_torch runs on the GPU "
                "unless the caller passes device='cpu'")
        if world > torch.cuda.device_count():
            raise ValueError(
                f"{world} ranks need {world} cards (NCCL takes one rank a "
                f"card), have {torch.cuda.device_count()}")
    tmp = tempfile.mkdtemp(prefix="hpa2_ranks_")
    try:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, tmp, dev.type, fn, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        # a rank that fails leaves the others waiting in a collective:
        # stop them all once one has failed
        while any(p.is_alive() for p in procs):
            for p in procs:
                p.join(0.05)
            if _failed(tmp, procs):
                for p in procs:
                    if p.is_alive():
                        p.terminate()
                for p in procs:
                    p.join()
        results = []
        for r, p in enumerate(procs):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if not os.path.exists(path):
                raise RuntimeError(
                    f"rank {r} of {world} exited with code {p.exitcode} "
                    "and no result")
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                raise RuntimeError(f"rank {r} of {world} failed:\n{value}")
            results.append(value)
        return results
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
