"""The port's one canonical walker for the program contracts: the
counterpart of ``hpa2_tpu/analysis/ir.py``.

The JAX package inspects lowered programs (jaxprs, compiled HLO).  The
port runs PyTorch eagerly and its kernels are hand-written, so what a
contract pins is what the port's programs *do*, counted here and
nowhere else:

* the aten ops one eager call dispatches, by name, under a
  ``TorchDispatchMode`` (:class:`OpCensus`; the general engine's graph
  capture counts the kernels it records with the same class);
* the calls of the fast path's wrappers ``kernels.stream_run`` and
  ``kernels.call_run`` (counted at the wrapper, so the CPU's plain
  versions and the card's kernels count alike), the libraries' kernel
  launches (card only) and ``kernels.HOST_SYNCS`` (:func:`launch_census`);
* CUDA-graph captures and replays of the general engine's loops
  (``Run``, ``ChunkRun``, ``BoundChunk``; :func:`graph_census`);
* ptxas's registers, stack frames and spills from a library's build
  log (card only; :func:`ptxas_census`).
"""

from __future__ import annotations

import collections
import contextlib
import re
from typing import Dict, Iterator, List, Sequence

from torch.utils._python_dispatch import TorchDispatchMode


class OpCensus(TorchDispatchMode):
    """Counts the ops dispatched inside it, views excluded (one kernel
    each on the card).  ``names`` is the sequence of op names, in
    order (``aten.min``, ``aten.where``, ...)."""

    def __init__(self) -> None:
        super().__init__()
        self.names: List[str] = []

    @property
    def count(self) -> int:
        return len(self.names)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.names.append(f"aten.{func.overloadpacket.__name__}")
        return func(*args, **(kwargs or {}))


def op_census(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` under an :class:`OpCensus` -> (result,
    census)."""
    with OpCensus() as census:
        out = fn(*args, **kwargs)
    return out, census


def _name(op: str) -> str:
    return op if op.startswith("aten.") else f"aten.{op}"


def count_ops(census: OpCensus, names: Sequence[str]) -> int:
    """Ops named in ``names`` (``min`` or ``aten.min``)."""
    want = {_name(n) for n in names}
    return sum(1 for n in census.names if n in want)


def top_counts(census: OpCensus, names: Sequence[str]) -> Dict[str, int]:
    """Per-name census."""
    c = collections.Counter(census.names)
    return {n: c[_name(n)] for n in names}


def op_paths(census: OpCensus, names: Sequence[str],
             limit: int = 6) -> List[str]:
    """Where the named ops fell in the call's op sequence, e.g.
    ``op[17]:aten.sort`` (the location half of a drift diff)."""
    want = {_name(n) for n in names}
    return [f"op[{i}]:{n}" for i, n in enumerate(census.names)
            if n in want][:limit]


#: ops that read a device value back to the host: inside a captured
#: CUDA graph they fail, and in a run's loop they are unaccounted syncs
HOST_READ_OPS = ("_local_scalar_dense", "nonzero", "item")


@contextlib.contextmanager
def launch_census() -> Iterator[Dict[str, int]]:
    """Counts what the code inside does to the fast path and the host:
    wrapper calls (``calls.stream_run``, ``calls.call_run``), kernel
    launches of each library (``launches.<library>``; zero on the CPU)
    and host syncs (``host_syncs``).  The dict is filled when the block
    exits."""
    from hpa2_tpu_torch.ops import kernels

    before_calls = (kernels.CALLS.stream_run, kernels.CALLS.call_run)
    before_launch = {k.name: k.launches for k in kernels.LIBRARIES}
    before_syncs = kernels.HOST_SYNCS.count
    out: Dict[str, int] = {}
    try:
        yield out
    finally:
        out["calls.stream_run"] = kernels.CALLS.stream_run - before_calls[0]
        out["calls.call_run"] = kernels.CALLS.call_run - before_calls[1]
        for k in kernels.LIBRARIES:
            out[f"launches.{k.name}"] = k.launches - before_launch[k.name]
        out["host_syncs"] = kernels.HOST_SYNCS.count - before_syncs


def graph_census(runner) -> Dict[str, int]:
    """CUDA-graph captures (and replays) of a general-engine loop:
    a ``Run`` (captures per shape, chunks of its last run) or a
    ``BoundChunk`` (captures, rounds).  Zero captures on the CPU."""
    if hasattr(runner, "_graphs"):
        return {"captures": len(runner._graphs), "replays": runner.chunks}
    return {"captures": runner.graphs, "replays": runner.rounds}


_ENTRY_RE = re.compile(r"Compiling entry function '([^']+)'")
_FRAME_RE = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores,"
                       r" (\d+) bytes spill loads")
_REGS_RE = re.compile(r"Used (\d+) registers")


def ptxas_census(build_log: str) -> List[Dict[str, object]]:
    """Per compiled entry function of an ``nvcc -Xptxas -v`` log: its
    name, registers a thread, stack frame and spill bytes."""
    out: List[Dict[str, object]] = []
    for line in build_log.splitlines():
        m = _ENTRY_RE.search(line)
        if m:
            out.append({"name": m.group(1), "registers": 0, "stack": 0,
                        "spill_stores": 0, "spill_loads": 0})
            continue
        if not out:
            continue
        m = _FRAME_RE.search(line)
        if m:
            out[-1].update(stack=int(m.group(1)),
                           spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        m = _REGS_RE.search(line)
        if m:
            out[-1]["registers"] = int(m.group(1))
    return out
