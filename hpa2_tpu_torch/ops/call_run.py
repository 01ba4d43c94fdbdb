"""The per-call run (``stream=False``): the plain PyTorch version of the
CUDA kernel in ``csrc/call_run.cu``, and the host loop around it.

It keeps the semantics of ``hpa2_tpu/ops/pallas_engine.py:_build_call``
and ``:_make_run`` exactly:

* one call advances each lane block by up to ``k`` cycles in one trace
  window: ``ceil(k/8)`` bursts of 8 cycles, each run only while the
  block has work (``gate=False``: ``k`` cycles straight); every state
  plane, the snapshot planes included, stays resident for the call;
* the host loop runs the trace as windows of ``window`` instructions; at
  each window base it clears the ``pc`` field of ``nsw`` and then
  calls while **any lane of the whole ensemble** has work and fewer
  than ``max_calls`` calls were made.  The call counter is global and
  carries across windows, so after a stalled window the next windows
  run with no calls left;
* a window that ends with work left stalls the run (status bit 0);
  the sticky overflow row gives bit 1.

The host loop's quiescence test is a reduction on the planes' device that
the host reads once per call (and once at each window base): JAX keeps
that loop on the device, here each read is a host sync, counted by
``kernels.HOST_SYNCS``.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch

from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.ops.cycle import build_cycle
from hpa2_tpu_torch.ops.layout import (
    _GATE, _SC_OVERFLOW, _scalar_layout, fields_of,
)
from hpa2_tpu_torch.ops.stream_run import (
    active_count, advance_blocks, block_busy,
)


def window_planes(tr: torch.Tensor, tr_len: torch.Tensor, seg: int,
                  window: int):
    """Window ``seg`` of the ``[N, n_seg*window, B]`` trace plane (a
    view) and its ``[N, B]`` lengths."""
    trw = tr[:, seg * window:(seg + 1) * window, :]
    return trw, (tr_len - seg * window).clamp(0, window)


def call_plain(config: SystemConfig, state: Dict[str, torch.Tensor],
               tr: torch.Tensor, tr_len: torch.Tensor, *, seg: int,
               block: int, k: int, window: int, gate: bool,
               snapshots: bool, packed: bool = False,
               ablate: frozenset = frozenset()):
    """One call in trace window ``seg``.  Returns the new carried
    planes (``state`` is not changed).  ``ablate`` stubs out cycle
    stages (``ops/cycle.py:ABLATE_STAGES``)."""
    fields = fields_of(config, snapshots, packed)
    cycle = build_cycle(config, snapshots, packed, ablate)
    slsc = _scalar_layout(config, window)
    trw, tl = window_planes(tr, tr_len, seg, window)
    st = {f: state[f] for f in fields}
    if not gate:
        every = torch.ones(tr_len.shape[1] // block, dtype=torch.bool,
                           device=tr_len.device)
        return advance_blocks(cycle, st, fields, trw, tl, every, block, k)
    for _ in range(-(-k // _GATE)):
        open_blocks = block_busy(config, st, tl, slsc, block)
        if not bool(open_blocks.any()):
            break  # a quiescent block stays quiescent
        st = advance_blocks(cycle, st, fields, trw, tl, open_blocks, block,
                            _GATE)
    return st


def run_windows(config: SystemConfig, state: Dict[str, torch.Tensor],
                tr: torch.Tensor, tr_len: torch.Tensor, *, block: int,
                k: int, window: int, n_seg: int, max_calls: int,
                gate: bool, snapshots: bool, packed: bool = False,
                call=None, ablate: frozenset = frozenset()) -> torch.Tensor:
    """Run every system through all ``n_seg`` windows of ``tr`` by
    calls of ``call`` (default ``kernels.call_run``: the kernel on CUDA
    tensors, the plain version on CPU tensors), updating ``state`` in
    place.  Returns the status word as an int32 scalar on the planes'
    device, not read: bit 0 a window ended with work left, bit 1 a
    mailbox overflowed.  ``ablate`` is passed on to every call."""
    return run_windows_multi(
        config, [(state, tr, tr_len)], block=block, k=k, window=window,
        n_seg=n_seg, max_calls=max_calls, gate=gate, snapshots=snapshots,
        packed=packed, call=call, ablate=ablate)[0]


def run_windows_multi(config: SystemConfig, parts: Sequence[Tuple], *,
                      block: int, k: int, window: int, n_seg: int,
                      max_calls: int, gate: bool, snapshots: bool,
                      packed: bool = False, call=None,
                      ablate: frozenset = frozenset()) -> List[torch.Tensor]:
    """:func:`run_windows` over several independent ``(state, tr,
    tr_len)`` parts at once (the data shards of an ensemble, each on its
    own device): each part keeps its own call counter and stops calling
    when its own lanes are quiescent, exactly as if it ran alone, but
    the parts' calls of a round are enqueued before the round's one
    host read of every open part's quiescence, so the devices work at
    the same time.  Returns each part's status word, not read."""
    # kernels imports this module for call_plain
    from hpa2_tpu_torch.ops import kernels

    call = call or kernels.call_run
    slsc = _scalar_layout(config, window)
    pc_clear = ~(slsc["pc_mask"] << slsc["off_pc"])
    kw = dict(block=block, k=k, window=window, gate=gate,
              snapshots=snapshots, packed=packed, ablate=ablate)
    home = parts[0][1].device
    calls = [0] * len(parts)
    stalled = [False] * len(parts)
    for seg in range(n_seg):
        # window base: every lane is quiescent (or the run has already
        # stalled), so the pc restart is a field clear
        tls = []
        for state, tr, tr_len in parts:
            state["nsw"].bitwise_and_(pc_clear)
            tls.append(window_planes(tr, tr_len, seg, window)[1])

        def busy(idx: List[int]) -> List[int]:
            """The parts of ``idx`` with work left (one host read)."""
            flags = torch.stack([
                (active_count(config, parts[p][0], tls[p], slsc) != 0)
                .any().to(home) for p in idx])
            got = kernels.HOST_SYNCS.read(flags)
            return [p for p, b in zip(idx, got) if b]

        open_ = busy(list(range(len(parts))))
        while True:
            run = [p for p in open_ if calls[p] < max_calls]
            if not run:
                break
            for p in run:
                state, tr, tr_len = parts[p]
                call(config, state, tr, tr_len, seg=seg, **kw)
                calls[p] += 1
            still = set(busy(run))
            open_ = [p for p in open_ if p not in run or p in still]
        for p in open_:
            stalled[p] = True
    out = []
    for (state, _, _), st in zip(parts, stalled):
        overflow = (state["scalars"][_SC_OVERFLOW] > 0).any()
        out.append((overflow.to(torch.int32) << 1) | int(st))
    return out
