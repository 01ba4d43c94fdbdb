"""The whole streamed run as plain PyTorch: the plain version of the
CUDA kernel in ``csrc/stream_run.cu``.

It keeps the semantics of ``hpa2_tpu/ops/pallas_engine.py:
_make_stream_run`` exactly:

* the trace runs as windows of ``window`` instructions; at each window
  base the ``pc`` field of ``nsw`` is cleared;
* inside a window each lane block loops over calls of ``k`` cycles
  until its active count is 0 or the call budget is spent; a call is
  ``ceil(k/8)`` gates of 8 cycles, a gate is skipped when the block is
  quiescent (``gate=False``: ``k`` cycles, no gate);
* the call counter carries across windows, so ``max_calls`` bounds
  the whole run;
* a block that is still active at the end of a window is stalled; the
  per-lane stall plane holds its block's flag.

The blocks are independent, so this version runs them all at once:
each cycle advances every lane and keeps the result only on the lanes
of blocks that are open, which is what running the blocks one after
another would give.
"""

from __future__ import annotations

from typing import Dict

import torch

from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.ops.cycle import build_cycle
from hpa2_tpu_torch.ops.layout import (
    _GATE, _scalar_layout, deferred_valid, fields_of,
)

I32 = torch.int32


def _keep(mask: torch.Tensor, new: torch.Tensor,
          old: torch.Tensor) -> torch.Tensor:
    """``new`` on the lanes of ``mask``, else ``old``.  A u16 plane is
    selected through its int16 view (the same bits): CUDA has no
    ``where`` for u16."""
    if new.dtype == torch.uint16:
        return torch.where(mask, new.view(torch.int16),
                           old.view(torch.int16)).view(torch.uint16)
    return torch.where(mask, new, old)


def active_count(config: SystemConfig, st, tl, slsc) -> torch.Tensor:
    """[B] outstanding work per lane: instructions left in the window,
    waiting nodes, queued messages and deferred outbox slots."""
    nswv = st["nsw"]
    pcv = (nswv >> slsc["off_pc"]) & slsc["pc_mask"]
    return (
        (tl - pcv).clamp(min=0).sum(0, dtype=I32)
        + ((nswv >> slsc["off_wait"]) & 1).sum(0, dtype=I32)
        + (nswv & slsc["count_mask"]).sum(0, dtype=I32)
        + deferred_valid(config, st).sum((0, 1), dtype=I32)
    )


def block_busy(config: SystemConfig, st, tl, slsc,
               block: int) -> torch.Tensor:
    """[B / block] bool: the lane blocks with outstanding work."""
    act = active_count(config, st, tl, slsc) != 0
    return act.view(-1, block).any(1)


def advance_blocks(cycle, st, fields, trw, tl, open_blocks: torch.Tensor,
                   block: int, cycles: int):
    """``cycles`` cycles of the lanes of the open blocks; the other
    lanes keep their planes.  Running every lane and keeping the result
    on the open ones is what running the open blocks alone gives, since
    the blocks are independent."""
    lanes = open_blocks.repeat_interleave(block)
    every = bool(open_blocks.all())
    for _ in range(cycles):
        out = cycle({**st, "tr": trw, "tr_len": tl})
        st = {
            f: out[f] if every else _keep(lanes, out[f], st[f])
            for f in fields
        }
    return st


def stream_run_plain(config: SystemConfig, state: Dict[str, torch.Tensor],
                     tr: torch.Tensor, tr_len: torch.Tensor, *,
                     block: int, k: int, window: int, n_seg: int,
                     max_calls: int, gate: bool, snapshots: bool,
                     packed: bool = False, ablate: frozenset = frozenset()):
    """Run every system to the end of its trace.  Returns the new
    carried planes and the [1, B] per-lane stall plane.  ``ablate``
    stubs out cycle stages (``ops/cycle.py:ABLATE_STAGES``)."""
    fields = fields_of(config, snapshots, packed)
    cycle = build_cycle(config, snapshots, packed, ablate)
    slsc = _scalar_layout(config, window)
    b = tr_len.shape[1]
    nb = b // block
    outer = -(-k // _GATE)
    dev = tr_len.device

    st = {f: state[f] for f in fields}
    calls = torch.zeros(nb, dtype=I32, device=dev)
    stalled = torch.zeros(nb, dtype=torch.bool, device=dev)

    for si in range(n_seg):
        trw = tr[:, si * window:(si + 1) * window, :]
        tl = (tr_len - si * window).clamp(0, window)
        st["nsw"] = st["nsw"] & ~(slsc["pc_mask"] << slsc["off_pc"])

        while True:
            running = block_busy(config, st, tl, slsc, block) & (
                calls < max_calls)
            if not bool(running.any()):
                break
            if gate:
                for g in range(outer):
                    # gate 0 opens on every running block: the loop
                    # condition just found it active
                    open_blocks = running
                    if g > 0:
                        open_blocks = running & block_busy(
                            config, st, tl, slsc, block)
                    if not bool(open_blocks.any()):
                        break
                    st = advance_blocks(cycle, st, fields, trw, tl,
                                        open_blocks, block, _GATE)
            else:
                st = advance_blocks(cycle, st, fields, trw, tl, running,
                                    block, k)
            calls = calls + running.to(I32)
        stalled = stalled | block_busy(config, st, tl, slsc, block)

    status = stalled.repeat_interleave(block).to(I32)[None, :]
    return st, status
