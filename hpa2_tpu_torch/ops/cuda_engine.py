"""The ensemble fast path on the GPU: ``CudaEngine``, the counterpart of
``hpa2_tpu.ops.pallas_engine.PallasEngine`` with ``stream=True``.

One ``run()`` is one launch of the streamed-run kernel
(``ops/kernels.py``) over every lane block, then a single host sync
that reads the status word.  The engine owns its state planes and the
kernel updates them in place.

It covers MESI with a full directory on the ideal topology, split
sharer planes (``num_procs > 21``; the kernel takes up to
``kernels.MAX_NODES`` nodes, the plain version any number), packed
planes, no occupancy schedule and no sharding; anything else is
refused with a ``ValueError`` that names the later slice.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.convert import state_from_numpy
from hpa2_tpu_torch.models.protocol import MsgType
from hpa2_tpu_torch.ops import kernels
from hpa2_tpu_torch.ops.layout import (
    _SC_CYCLE, _SC_EV, _SC_INSTR, _SC_INV, _SC_MSGS, _SC_OVERFLOW, _SC_RH,
    _SC_RM, _SC_WH, _SC_WM, StallError, _check_geometry, _check_semantics,
    _init_state, _join_word_planes_np, _pack_traces, _scalar_layout,
    _split_sw, choose_block, decode_dumps, packed_plane_dtypes,
)
from hpa2_tpu_torch.utils.dump import NodeDump


def resolve_device(device) -> torch.device:
    """``device`` as a torch device; a CUDA device must exist (there is
    no fallback to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: hpa2_tpu_torch runs on the GPU unless "
            "the caller passes device='cpu'")
    return dev


def format_stats(core: dict, msg_counts) -> dict:
    """Counter dict in the spec engine's key names; per-type message
    counts appear only when nonzero."""
    out = dict(core)
    for t in MsgType:
        if msg_counts[int(t)]:
            out[f"msg_{t.name}"] = int(msg_counts[int(t)])
    return out


class CudaEngine:
    """Ensemble engine whose whole run is one CUDA kernel launch.

    Same observable behavior as ``PallasEngine(stream=True)``: fixture
    semantics, dump-at-local-completion snapshots, counters, the stall
    status, and bit-identical state planes.  ``trace_window=w`` runs
    traces longer than ``w`` as successive windows that quiesce in
    between; ``gate`` skips 8-cycle bursts of quiescent lane blocks;
    ``snapshots=False`` drops the phase-D snapshot planes; ``packed``
    stores the cache and directory words as narrow u8/u16 planes.

    ``device="cpu"`` runs the kernel's plain PyTorch version (the
    tests); the default ``"cuda"`` launches the kernel and raises when
    there is no GPU."""

    def __init__(
        self,
        config: SystemConfig,
        tr_op: np.ndarray,
        tr_addr: np.ndarray,
        tr_val: np.ndarray,
        tr_len: np.ndarray,
        block: int = 1024,
        cycles_per_call: int = 128,
        snapshots: bool = True,
        trace_window: Optional[int] = None,
        gate: bool = True,
        stream: bool = True,
        schedule=None,
        packed: bool = False,
        device="cuda",
    ):
        if config.interconnect.enabled:
            raise ValueError(
                "the fast path implements the ideal topology only; use the "
                "spec or XLA engines of hpa2_tpu for "
                f"topology={config.interconnect.topology!r}"
            )
        _check_geometry(config)
        _check_semantics(config)
        if packed:
            packed_plane_dtypes(config)  # raises on unpackable geometry
        if not stream:
            raise ValueError(
                "stream=False (the per-call kernel driven from the host) is "
                "a later slice of the port; run with stream=True")
        if schedule is not None:
            raise ValueError(
                "the occupancy scheduler (schedule=) is a later slice of "
                "the port; run without a schedule")
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            kernels.check_kernel_bound(config)
        b, _, t = tr_op.shape
        self.config = config
        self.b = b
        self.block = choose_block(b, block)
        if self.block > kernels.MAX_BLOCK:
            raise ValueError(
                f"block={self.block} exceeds the kernel's {kernels.MAX_BLOCK}"
                " threads per lane block (one thread per system)")
        self.cycles_per_call = cycles_per_call
        self._snapshots = snapshots
        self._gate = gate
        self._packed = packed

        tr_len = tr_len.astype(np.int32)
        tr_words = _pack_traces(config, tr_op, tr_addr, tr_val, tr_len)
        w = trace_window if trace_window else t
        w = max(1, min(w, t))
        self._window = w
        self._n_seg = -(-t // w)
        if snapshots and self._n_seg > 1:
            raise ValueError(
                "dump-at-local-completion snapshots are defined on the "
                "whole trace; run windowed traces with snapshots=False"
            )
        _scalar_layout(config, w)  # raises when nsw cannot hold the window
        t_pad = self._n_seg * w
        if t_pad != t:
            tr_words = np.pad(tr_words, ((0, 0), (0, t_pad - t), (0, 0)))
        tr_len_nb = np.ascontiguousarray(np.moveaxis(tr_len, 0, 1))
        self._tr_full = torch.from_numpy(tr_words).to(self.device)
        self._tr_len_full = torch.from_numpy(tr_len_nb).to(self.device)
        self.state = state_from_numpy(
            _init_state(config, b, snapshots, packed), self.device)
        self._completed = False
        self._poisoned = False

    def _check_status(self, status: int, max_cycles: int) -> None:
        if status:
            self._poisoned = True
        if status & 2:
            raise StallError(
                "internal invariant violated: mailbox overflow despite "
                "backpressure"
            )
        if status & 1:
            raise StallError(
                f"no quiescence within ~{max_cycles} cycles over the "
                "whole run (livelock? use Semantics.robust(); raise "
                "max_cycles for long windowed workloads)"
            )

    def run(self, max_cycles: int = 1_000_000) -> "CudaEngine":
        # the driver resets pc at every window base, so a run is not
        # resumable: completed runs are a no-op, stalled runs leave
        # in-flight state that only a rebuild can clear
        if self._completed:
            return self
        if self._poisoned:
            raise StallError(
                "engine state is mid-flight after a failed run; "
                "rebuild the engine to retry"
            )
        max_calls = max(1, -(-max_cycles // self.cycles_per_call))
        stall = kernels.stream_run(
            self.config, self.state, self._tr_full, self._tr_len_full,
            block=self.block, k=self.cycles_per_call, window=self._window,
            n_seg=self._n_seg, max_calls=max_calls, gate=self._gate,
            snapshots=self._snapshots, packed=self._packed,
        )
        overflow = (self.state["scalars"][_SC_OVERFLOW] > 0).any()
        status = (stall != 0).any().to(torch.int32) | (
            overflow.to(torch.int32) << 1)
        self._check_status(int(status), max_cycles)  # single host sync
        self._completed = True
        return self

    # -- readback -----------------------------------------------------

    def _plane(self, f: str) -> np.ndarray:
        return self.state[f].cpu().numpy()

    def _split_planes(self, prefix: str):
        """The split sharer-word planes ``prefix{w}``, or None when the
        sharers sit in the directory word."""
        sw = _split_sw(self.config)
        return [self._plane(f"{prefix}{w}") for w in range(sw)] or None

    def _word_planes(self, prefix: str = ""):
        """(cachew, dirw) as int32 words; packed planes are joined."""
        if self._packed:
            return _join_word_planes_np(*(self._plane(prefix + f) for f in (
                "cvalw", "cmetaw", "dmemw", "dmetaw")))
        return self._plane(f"{prefix}cachew"), self._plane(f"{prefix}dirw")

    def system_snapshots(self, sys_idx: int) -> List[NodeDump]:
        if not self._snapshots:
            raise ValueError(
                "engine built with snapshots=False has no phase-D state"
            )
        return decode_dumps(self.config, *self._word_planes("snap_"),
                            sys_idx, dirs=self._split_planes("snap_dirs"))

    def system_final_dumps(self, sys_idx: int) -> List[NodeDump]:
        return decode_dumps(self.config, *self._word_planes(), sys_idx,
                            dirs=self._split_planes("dirs"))

    # single-system aliases matching the other engines' interface (the
    # CLI's `run` path)

    def snapshots(self) -> List[NodeDump]:
        if self.b != 1:
            raise ValueError(
                "snapshots() is the batch-1 interface; use "
                "system_snapshots(b) on ensembles"
            )
        return self.system_snapshots(0)

    def final_dumps(self) -> List[NodeDump]:
        if self.b != 1:
            raise ValueError(
                "final_dumps() is the batch-1 interface; use "
                "system_final_dumps(b) on ensembles"
            )
        return self.system_final_dumps(0)

    @property
    def instructions(self) -> int:
        return int(self.state["scalars"][_SC_INSTR].sum())

    @property
    def messages(self) -> int:
        return int(self.state["scalars"][_SC_MSGS].sum())

    @property
    def cycle(self) -> int:
        """Max per-system cycle count (lockstep wall cycles)."""
        return int(self.state["scalars"][_SC_CYCLE].max())

    def stats(self) -> dict:
        sc = self._plane("scalars").astype(np.int64)
        return format_stats(
            {
                "instructions": int(sc[_SC_INSTR].sum()),
                "msgs_total": int(sc[_SC_MSGS].sum()),
                "read_hits": int(sc[_SC_RH].sum()),
                "read_misses": int(sc[_SC_RM].sum()),
                "write_hits": int(sc[_SC_WH].sum()),
                "write_misses": int(sc[_SC_WM].sum()),
                "evictions": int(sc[_SC_EV].sum()),
                "invalidations": int(sc[_SC_INV].sum()),
            },
            self._plane("msg_counts").astype(np.int64).sum(axis=1),
        )
