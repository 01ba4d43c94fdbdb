"""Start the ranks of a node-sharded run: the SPMD runtime of the node
axis (the JAX package's ``shard_map`` over a mesh becomes one process a
rank on ``torch.distributed``).

:class:`RankPool` starts ``world`` ranks with ``torch.multiprocessing``
("spawn"), rank ``r`` on ``cuda:r`` (NCCL) or on the CPU (gloo).  They
meet at a ``FileStore`` in a fresh temporary directory, with no TCP
port, so runs side by side (pytest-xdist workers) never collide.  Each
rank runs one PyTorch intra-op thread and a command loop on its end of
a pipe; the caller, which holds no card state, sends every rank the
same command and collects the replies, so ranks that outlive one call
(the node-sharded serving session) and a one-shot run (:func:`spawn`,
one call on a fresh pool) are the same machinery.

:class:`LocalPool` is the same for logical ranks: threads of this
process on one device, meeting through ``parallel/comm.py:LocalComm``
(``make_mesh(..., local=True)``); :func:`pool_for` picks the pool of a
mesh.

:func:`join_torchrun` joins a group that ``torchrun`` already started
(its ``RANK``/``WORLD_SIZE``/``MASTER_ADDR`` environment), so the
engines run in place on every rank instead of spawning.
"""

from __future__ import annotations

import os
import shutil
import tempfile
import threading
import time
import traceback
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from multiprocessing.connection import wait

from hpa2_tpu_torch.parallel.comm import (
    LocalComm, LocalGroup, backend_for, set_local_rank,
)


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


def _exit_with_parent() -> None:
    """End this rank when the process that started it goes away (a
    killed caller, a timed-out step), even in the middle of a run or a
    collective: no rank outlives its caller."""
    parent = os.getppid()

    def watch():
        while True:
            time.sleep(0.5)
            if os.getppid() != parent:
                os._exit(1)

    threading.Thread(target=watch, daemon=True).start()


def _check_world(world: int, dev: torch.device) -> None:
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


def _apply(env: dict, fn: Callable, args: Sequence):
    return fn(*args)


def spawn(fn: Callable, world: int, args: Sequence = (),
          device="cuda") -> List:
    """Run ``fn(*args)`` on ``world`` ranks of a fresh process group and
    return each rank's result, in rank order: one :meth:`RankPool.call`
    on a pool that is closed after it.  ``fn`` and ``args`` must pickle
    (``fn`` a module-level function).  On the card it needs ``world``
    cards: NCCL takes one rank a card."""
    with RankPool(world, device) as pool:
        return pool.run(fn, args)


def _pool_main(rank: int, world: int, tmp: str, device: str, conn) -> None:
    """A pool rank: join the group, then run each command ``(fn, args)``
    as ``fn(env, *args)`` (``env`` a dict that lives as long as the rank)
    and send back ``("ok", value)`` or ``("error", traceback)``, until
    the caller sends ``None`` or goes away."""
    _exit_with_parent()
    torch.set_num_threads(1)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank)
    store = dist.FileStore(os.path.join(tmp, "store"), world)
    dist.init_process_group(backend_for(dev), store=store, rank=rank,
                            world_size=world)
    env = {}
    try:
        while True:
            try:
                msg = conn.recv()
            except EOFError:
                break
            if msg is None:
                break
            fn, args = msg
            try:
                reply = ("ok", fn(env, *args))
            except BaseException:  # the caller re-raises it
                reply = ("error", traceback.format_exc())
            conn.send(reply)
    finally:
        dist.destroy_process_group()


class RankPool:
    """``world`` ranks of one process group that outlive a call: rank
    ``r`` on ``cuda:r`` (NCCL) or on the CPU (gloo), meeting at a
    ``FileStore`` as :func:`spawn`'s do.  :meth:`call` sends every rank a
    command and returns the replies in rank order.

    A rank's exception raises in the caller with the rank's traceback; a
    rank that dies raises too (its process sentinel wakes the caller),
    and never hangs the caller.  Either way the pool is closed first,
    since the other ranks may be waiting in a collective.  :meth:`close`
    (and leaving the ``with`` block) ends every rank."""

    def __init__(self, world: int, device="cuda"):
        dev = torch.device(device)
        _check_world(world, dev)
        self.world = world
        self.device = dev
        self.closed = False
        self._tmp = tempfile.mkdtemp(prefix="hpa2_pool_")
        ctx = mp.get_context("spawn")
        self._conns, self._procs = [], []
        for r in range(world):
            parent, child = ctx.Pipe()
            p = ctx.Process(target=_pool_main,
                            args=(r, world, self._tmp, dev.type, child),
                            daemon=True)
            p.start()
            child.close()
            self._conns.append(parent)
            self._procs.append(p)

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:
        self.close()

    def call(self, fn: Callable, args: Sequence = (),
             per_rank: Optional[Sequence[Sequence]] = None) -> List:
        """Run ``fn(env, *args)`` on every rank (``fn`` module-level, so
        that it pickles), or ``fn(env, *per_rank[r])`` on rank ``r``, and
        return the replies in rank order."""
        if self.closed:
            raise RuntimeError("the rank pool is closed")
        for r, conn in enumerate(self._conns):
            conn.send((fn, tuple(per_rank[r] if per_rank is not None
                                 else args)))
        replies: List = [None] * self.world
        waiting = set(range(self.world))
        by_conn = {self._conns[r]: r for r in range(self.world)}
        by_proc = {self._procs[r].sentinel: r for r in range(self.world)}
        while waiting:
            ready = wait([self._conns[r] for r in waiting]
                         + [self._procs[r].sentinel for r in waiting])
            for x in ready:
                if x in by_conn and by_conn[x] in waiting:
                    r = by_conn[x]
                    try:
                        status, value = x.recv()
                    except EOFError:
                        status, value = "dead", None
                    if status != "ok":
                        self._fail(r, status, value)
                    replies[r] = value
                    waiting.discard(r)
            for x in ready:
                r = by_proc.get(x)
                if r is not None and r in waiting and \
                        not self._conns[r].poll():
                    self._fail(r, "dead", None)
        return replies

    def run(self, fn: Callable, args: Sequence = ()) -> List:
        """Run ``fn(*args)`` on every rank (no ``env``) and return the
        replies in rank order."""
        return self.call(_apply, (fn, args))

    def _fail(self, r: int, status: str, value) -> None:
        code = self._procs[r].exitcode
        self.close()
        if status == "error":
            raise RuntimeError(f"rank {r} of {self.world} failed:\n{value}")
        raise RuntimeError(
            f"rank {r} of {self.world} exited (code {code}) without "
            "answering")

    def close(self) -> None:
        """End every rank: ask them to leave, then stop the ones that do
        not (a rank waiting in a collective cannot read the request)."""
        if getattr(self, "closed", True):
            return
        self.closed = True
        for conn in self._conns:
            try:
                conn.send(None)
            except (OSError, ValueError):
                pass
        deadline = time.monotonic() + 5.0
        for p in self._procs:
            p.join(max(0.0, deadline - time.monotonic()))
        for p in self._procs:
            if p.is_alive():
                p.terminate()
        for p in self._procs:
            p.join(5.0)
            if p.is_alive():
                p.kill()
                p.join()
        for conn in self._conns:
            conn.close()
        shutil.rmtree(self._tmp, ignore_errors=True)


class LocalPool:
    """``data x node`` logical ranks, threads of this process on one
    device (``cuda:0`` or the CPU), with :class:`RankPool`'s
    :meth:`call`: every call runs ``fn(env, *args)`` on one thread a
    rank, with the rank's ``parallel/comm.py:LocalComm`` its node group
    (``world_comm`` returns it), ``env`` a dict that lives as long as
    the pool.  A rank's exception breaks every barrier, so the others
    stop too, and raises in the caller."""

    local = True

    def __init__(self, node: int, data: int = 1, device="cuda"):
        dev = torch.device(device)
        _check_world(1, dev)
        self.world = node * data
        self.device = dev
        self.closed = False
        self._turn = threading.Lock()
        world = LocalGroup(range(self.world), self._turn)
        rows = [LocalGroup(range(d * node, (d + 1) * node), self._turn)
                for d in range(data)]
        self._groups = [world] + rows
        self._ranks = [(r, LocalComm(r, rows[r // node], world), r // node)
                       for r in range(self.world)]
        self._envs: List[dict] = [{} for _ in range(self.world)]

    def __enter__(self) -> "LocalPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def call(self, fn: Callable, args: Sequence = (),
             per_rank: Optional[Sequence[Sequence]] = None) -> List:
        if self.closed:
            raise RuntimeError("the rank pool is closed")
        replies: List = [None] * self.world
        errors: List = [None] * self.world

        def rank_main(r: int) -> None:
            set_local_rank(self._ranks[r])
            self._turn.acquire()
            try:
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device.index or 0)
                replies[r] = fn(self._envs[r], *(
                    per_rank[r] if per_rank is not None else args))
            except BaseException as e:  # the caller re-raises it
                errors[r] = (e, traceback.format_exc())
                for g in self._groups:
                    g.abort()
            finally:
                self._turn.release()
                set_local_rank(None)

        threads = [threading.Thread(target=rank_main, args=(r,),
                                    daemon=True)
                   for r in range(self.world)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        failed = [(r, e) for r, e in enumerate(errors) if e is not None]
        if failed:
            # the first rank that failed for a reason of its own, not
            # because another broke the barrier
            first = next(((r, e) for r, e in failed
                          if not isinstance(e[0], threading.BrokenBarrierError)),
                         failed[0])
            self.close()
            raise RuntimeError(
                f"logical rank {first[0]} of {self.world} failed:\n"
                f"{first[1][1]}")
        return replies

    def run(self, fn: Callable, args: Sequence = ()) -> List:
        return self.call(_apply, (fn, args))

    def close(self) -> None:
        self.closed = True


def pool_for(mesh):
    """The pool that runs ``mesh``'s ranks (a ``parallel/sharding.py:
    Mesh``): a :class:`LocalPool` for a local mesh, else a
    :class:`RankPool` of processes."""
    if mesh.local:
        return LocalPool(mesh.node, mesh.data, mesh.device)
    return RankPool(mesh.size, mesh.device)
