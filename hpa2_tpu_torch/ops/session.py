"""Resident-lane session on the GPU: ``CudaLaneSession``, the counterpart
of ``hpa2_tpu.ops.pallas_engine.PallasLaneSession``.

It holds ``resident`` lanes of carried state at fixed shapes for its
whole life; a serving loop drives one trace-window segment at a time:

1. ``tr, tl = stage(tr_np, tl_np)``: copy the next interval's
   host-assembled trace windows to the device;
2. ``status = advance(tr, tl)``: run every resident lane one window
   (queued on the device; the status is not read);
3. ``cols = harvest(lane)``: take a retiring lane's state columns; it
   must come before the barrier, which rewrites the planes;
4. ``barrier(perm, reset)``: the compaction/admission transform;
5. ``check(status)``: read the status and raise on stall or overflow,
   typically one interval behind ``advance``.

The resident planes are allocated once and every program updates them
in place (what donation does in the JAX session), so their
``data_ptr()``s never change.  ``compile_counts()`` is the analog of the
JAX session's jit-cache sizes: for each program, the number of distinct
argument signatures it has seen, and on the card the number of times
the runner's kernel library was loaded.  Each is 1 after the first
interval of a well-formed session.

On the card nothing here waits for the device but ``check`` and the
readbacks (``dumps_of``, ``counters_of``, ``columns_of``), and each
waits only for the interval it belongs to: ``advance`` copies the status
word, and the first call after a batch of ``harvest`` calls gathers the
harvested lanes' columns, into pinned host memory behind the work that
produced them, and records an event after the copies, which is what the
readers wait on.  So a loop that checks interval ``k-1`` while interval
``k`` runs does not wait for interval ``k`` (a plain ``.item()`` or
``.cpu()`` would wait for everything queued).  The host-to-device copies
of ``stage`` and ``barrier`` go through pinned memory (:func:`_upload`)
for the same reason: a copy from pageable memory waits for the stream.  On the CPU the same calls run in order, with no
events, and give the same bits.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.convert import state_from_numpy
from hpa2_tpu_torch.ops import kernels
from hpa2_tpu_torch.ops.cuda_engine import (
    _signed, barrier_, fast_path_setup, run_program,
)
from hpa2_tpu_torch.ops.layout import (
    _SC_CYCLE, _SC_INSTR, _SC_MSGS, StallError, _init_state,
    _join_word_planes_np, _split_sw, decode_dumps,
)
from hpa2_tpu_torch.utils.dump import NodeDump


def _signature(*xs: torch.Tensor):
    return tuple((tuple(x.shape), x.dtype, x.device) for x in xs)


def _record(device: torch.device) -> Optional[torch.cuda.Event]:
    """An event recorded on ``device``'s current stream; None on the
    CPU, where every call has finished when it returns."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def _upload(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on ``device``.  On the card the copy goes through
    page-locked memory, so it does not wait for the work queued on the
    stream; PyTorch's caching host allocator hands the pinned block out
    again only after the copy's event has passed.  On the CPU it is the
    array itself."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if device.type != "cuda":
        return t
    return t.pin_memory().to(device, non_blocking=True)


class _Pending:
    """Host copies of device values, valid once ``event`` has passed
    (always, on the CPU): a status word, or a batch of harvested lanes'
    columns (``lanes``, and ``host`` once gathered)."""

    def __init__(self, host=None, event=None) -> None:
        self.host = host
        self.event = event
        self.lanes: List[int] = []

    def wait(self):
        if self.event is not None:
            self.event.synchronize()
            self.event = None
        return self.host


class CudaLaneSession:
    """Resident-lane session for the GPU fast path (see the module
    docstring).  ``device="cpu"`` runs the kernels' plain versions."""

    def __init__(
        self,
        config: SystemConfig,
        resident: int,
        window: int,
        *,
        block: int = 1024,
        cycles_per_call: int = 128,
        gate: bool = True,
        stream: bool = True,
        packed: bool = False,
        max_cycles: int = 1_000_000,
        device="cuda",
    ):
        self.config = config
        self.r = int(resident)
        self.window = int(window)
        self.device, self.block = fast_path_setup(
            config, lanes=self.r, block=block, packed=packed, device=device)
        self.cycles_per_call = cycles_per_call
        self.max_cycles = max_cycles
        self._gate = gate
        self._stream = stream
        self._packed = packed
        self._kernel = kernels.STREAM_RUN if stream else kernels.CALL_RUN
        init = _init_state(config, self.r, snapshots=False, packed=packed)
        self._init = state_from_numpy(init, self.device)
        self.fields = list(init.keys())
        self.state = state_from_numpy(init, self.device)
        self._signatures = {"runner": set(), "barrier": set(),
                            "take_lane": set()}
        self._harvests: Optional[_Pending] = None

    # -- serving protocol ----------------------------------------------

    def stage(self, tr_int: np.ndarray, tl_int: np.ndarray):
        """Copy the next interval's assembled ``[n, w, r]`` trace plane
        and ``[n, r]`` window lengths to the device."""
        return (_upload(np.asarray(tr_int, np.int32), self.device),
                _upload(np.asarray(tl_int, np.int32), self.device))

    def advance(self, tr: torch.Tensor, tl: torch.Tensor) -> _Pending:
        """Run every resident lane one trace-window segment, in place.
        Returns the status word as a pending host copy, not read (with
        ``stream=False`` the per-call host loop reads the ensemble's
        quiescence after each call)."""
        self._gather_harvests()
        self._signatures["runner"].add(_signature(tr, tl))
        max_calls = max(1, -(-self.max_cycles // self.cycles_per_call))
        status = run_program(
            self.config, self.state, tr, tl, stream=self._stream,
            block=self.block, k=self.cycles_per_call, window=self.window,
            n_seg=1, max_calls=max_calls, gate=self._gate, snapshots=False,
            packed=self._packed)
        if self.device.type == "cuda":
            host = torch.empty((), dtype=status.dtype, pin_memory=True)
            host.copy_(status, non_blocking=True)
            status = host
        return _Pending(status, _record(self.device))

    def harvest(self, lane: int) -> Tuple[_Pending, int]:
        """Take one lane's state columns (leaves ``[..., 1]``); the
        lanes harvested between two other calls are gathered together,
        queued on the device.  Call after :meth:`advance` and before
        :meth:`barrier`."""
        self._signatures["take_lane"].add(())
        if self._harvests is None:
            self._harvests = _Pending()
        self._harvests.lanes.append(int(lane))
        return self._harvests, len(self._harvests.lanes) - 1

    def _gather_harvests(self) -> None:
        """Enqueue the gather of the lanes harvested since the last
        gather, and their copy to the host, before anything rewrites
        the planes."""
        batch, self._harvests = self._harvests, None
        if batch is None:
            return
        idx = _upload(np.asarray(batch.lanes, np.int64), self.device)
        host = {}
        for f, v in self.state.items():
            g = _signed(v).index_select(-1, idx)
            if self.device.type == "cuda":
                h = torch.empty(g.shape, dtype=g.dtype, pin_memory=True)
                g = h.copy_(g, non_blocking=True)
            host[f] = g.view(v.dtype)
        batch.host, batch.event = host, _record(self.device)

    def barrier(self, perm: np.ndarray, reset: np.ndarray) -> None:
        """Apply a ``BarrierPlan``'s lane permutation and admission
        resets to the resident planes, in place."""
        self._gather_harvests()
        perm_t = _upload(np.asarray(perm, np.int64), self.device)
        reset_t = _upload(np.asarray(reset, bool), self.device)
        self._signatures["barrier"].add(_signature(perm_t, reset_t))
        barrier_(self.state, self._init, perm_t, reset_t)

    def check(self, status: _Pending) -> None:
        """Wait for an interval's status word and read it (a host sync
        on the card, counted in ``kernels.HOST_SYNCS``); raises on stall
        or overflow exactly like the JAX session."""
        status = int(kernels.HOST_SYNCS.read(status.wait()))
        if status & 2:
            raise StallError(
                "internal invariant violated: mailbox overflow despite "
                "backpressure"
            )
        if status & 1:
            raise StallError(
                f"no quiescence within ~{self.max_cycles} cycles in one "
                "serving interval (livelock? use Semantics.robust())"
            )

    def compile_counts(self) -> dict:
        """Distinct argument signatures each program has seen, and on
        the card the loads of the runner's kernel library."""
        out = {k: len(v) for k, v in self._signatures.items()}
        if self.device.type == "cuda":
            out["kernel_loads"] = self._kernel.loads
        return out

    # -- readback ------------------------------------------------------

    def columns_of(self, cols) -> Dict[str, np.ndarray]:
        """A harvested lane's state columns (leaves ``[..., 1]``) as host
        arrays; waits only for the gather they came from."""
        batch, i = cols
        if batch is self._harvests:
            self._gather_harvests()
        return {f: h[..., i:i + 1].numpy() for f, h in batch.wait().items()}

    def _lane_word_planes(self, cols):
        npc = self.columns_of(cols)
        if self._packed:
            cachew, dirw = _join_word_planes_np(
                npc["cvalw"], npc["cmetaw"], npc["dmemw"], npc["dmetaw"])
        else:
            cachew, dirw = npc["cachew"], npc["dirw"]
        dirs = [npc[f"dirs{w}"] for w in range(_split_sw(self.config))]
        return cachew, dirw, dirs or None

    def dumps_of(self, cols) -> List[NodeDump]:
        """Decode a harvested lane column into per-node dump records,
        the same as ``system_final_dumps`` of a one-shot run."""
        cachew, dirw, dirs = self._lane_word_planes(cols)
        return decode_dumps(self.config, cachew, dirw, 0, dirs=dirs)

    def counters_of(self, cols) -> dict:
        """The retiring job's scalar counters."""
        sc = self.columns_of(cols)["scalars"][:, 0]
        return {
            "instructions": int(sc[_SC_INSTR]),
            "cycles": int(sc[_SC_CYCLE]),
            "messages": int(sc[_SC_MSGS]),
        }
