"""The CUDA kernel of the streamed run: its build, its binding, its
launch count and the dispatch between it and its plain version.

``csrc/stream_run.cu`` (with the cycle in ``csrc/cycle.cuh``) is
compiled by ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface under ``hpa2_tpu_torch/build/`` at first use, and loaded with
``ctypes``.  The library's name carries a hash of the sources and flags,
so an edited source is rebuilt and a stale build is never loaded.  It
holds the kernel instantiated for node bounds 8, 21 and 64, each with
int32 or packed planes; the library reports ``sizeof(Args)``, which
must equal the ctypes mirror's.

:func:`stream_run` is the one entry the engine calls.  On CPU tensors it
runs the plain PyTorch version (``ops/stream_run.py``); on CUDA tensors
it launches the kernel or raises.  Either way the carried planes are
updated in place and the per-lane stall plane is returned.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional

import torch

from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.ops.layout import (
    TORCH_DTYPES, _mb_layout, _scalar_layout, _sharer_words, _split_sw,
    fields_of, packed_plane_dtypes, state_dtypes, state_shapes,
)
from hpa2_tpu_torch.ops.stream_run import stream_run_plain

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

#: sources of the one library (the .cu includes the .cuh)
SOURCES = ("stream_run.cu", "cycle.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: the kernel's thread-block limit (one thread per system)
MAX_BLOCK = 1024
#: the widest system of the largest compiled node bound (kMaxNodes)
MAX_NODES = 64
#: message and sharer words of that bound's frame (kMaxW, kMaxSW)
MAX_WORDS = 5
MAX_SHARER_WORDS = 3

_FIELDS = ("type", "sender", "second", "addr", "aux", "recv") + tuple(
    f"shr{w}" for w in range(MAX_SHARER_WORDS))


class WordPlanes(ctypes.Structure):
    """Mirror of ``hpa2::WordPlanes``: the cache/directory planes of one
    role, int32 words or packed narrow planes, and the split sharer
    planes."""

    _fields_ = [(f, ctypes.c_void_p) for f in (
        "cachew", "dirw", "cvalw", "cmetaw", "dmemw", "dmetaw")] + [
        ("dirs", ctypes.c_void_p * MAX_SHARER_WORDS)]


class Args(ctypes.Structure):
    """Mirror of ``hpa2::Args`` in ``csrc/cycle.cuh``, field for field."""

    _fields_ = (
        [(f, ctypes.c_int32) for f in (
            "n", "c", "m", "cap", "W", "SW", "b", "bb", "window",
            "n_seg", "t_pad", "k", "max_calls", "gate", "snapshots", "nack",
            "eager_write", "flush_old_fill", "recv_packed", "packed",
            "cmeta_u16", "dmeta_u16")]
        + [("f_word", ctypes.c_int32 * len(_FIELDS)),
           ("f_off", ctypes.c_int32 * len(_FIELDS)),
           ("f_width", ctypes.c_int32 * len(_FIELDS))]
        + [(f, ctypes.c_int32) for f in (
            "count_mask", "off_wait", "off_pw", "off_pc", "pc_mask")]
        + [("live", WordPlanes), ("snap", WordPlanes),
           ("mb", ctypes.c_void_p * MAX_WORDS), ("nsw", ctypes.c_void_p),
           ("ob", ctypes.c_void_p * MAX_WORDS)]
        + [(f, ctypes.c_void_p) for f in (
            "ob_recv", "snap_taken", "scalars", "msg_counts", "tr",
            "tr_len", "status")]
    )


def find_nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, ``nvcc`` on the
    path, or ``/usr/local/cuda/bin/nvcc``."""
    cands = []
    if os.environ.get("CUDA_HOME"):
        cands.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    cands += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernel of hpa2_tpu_torch is built from source at first use")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


class StreamRunKernel:
    """The built and bound kernel, with its launch count.

    ``launches`` counts kernel launches and nothing else; the plain
    version never touches it."""

    name = "stream_run"
    source = "hpa2_tpu_torch/csrc/stream_run.cu"
    replaces = "hpa2_tpu/ops/pallas_engine.py:2244"

    def __init__(self) -> None:
        self.launches = 0
        self.build_log = ""
        self._lib: Optional[ctypes.CDLL] = None

    def library_path(self) -> Path:
        return BUILD_DIR / f"libhpa2_stream_run_{_source_hash()}.so"

    def build(self) -> Path:
        """Compile the library unless this source's build exists; load
        it.  Returns the library's path."""
        if self._lib is not None:
            return self.library_path()
        path = self.library_path()
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC_DIR / SOURCES[0])]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            self.build_log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{self.build_log}")
            (BUILD_DIR / (path.stem + ".log")).write_text(self.build_log)
            os.replace(tmp, path)
        else:
            log = BUILD_DIR / (path.stem + ".log")
            self.build_log = log.read_text() if log.exists() else ""
        lib = ctypes.CDLL(str(path))
        lib.hpa2_stream_run.argtypes = [
            ctypes.POINTER(Args), ctypes.c_int, ctypes.c_void_p]
        lib.hpa2_stream_run.restype = ctypes.c_int
        lib.hpa2_args_size.argtypes = []
        lib.hpa2_args_size.restype = ctypes.c_int
        size = lib.hpa2_args_size()
        if size != ctypes.sizeof(Args):
            raise RuntimeError(
                f"hpa2::Args is {size} bytes but the ctypes mirror is "
                f"{ctypes.sizeof(Args)}: kernels.Args is out of date")
        self._lib = lib
        return path

    def launch(self, args: Args, device: torch.device) -> None:
        self.build()
        stream = torch.cuda.current_stream(device).cuda_stream
        err = self._lib.hpa2_stream_run(
            ctypes.byref(args), device.index or 0, stream)
        if err != 0:
            raise RuntimeError(
                f"stream_run kernel launch failed: CUDA error {err}")
        self.launches += 1


STREAM_RUN = StreamRunKernel()

#: every kernel of the streamed path
KERNELS = (STREAM_RUN,)


def check_kernel_bound(config: SystemConfig) -> None:
    """Raise unless the kernel's largest node bound holds ``config``
    (the plain version has no bound)."""
    if config.num_procs > MAX_NODES:
        raise ValueError(
            f"num_procs={config.num_procs} exceeds the CUDA kernel's node "
            f"bound of {MAX_NODES} (its per-thread frame is sized at "
            "compile time); run it on the CPU with device='cpu'")


def build_all() -> float:
    """Build every kernel; returns the seconds it took."""
    t0 = time.perf_counter()
    for k in KERNELS:
        k.build()
    return time.perf_counter() - t0


def _check_planes(config: SystemConfig, state: Dict[str, torch.Tensor],
                  tr: torch.Tensor, tr_len: torch.Tensor, fields,
                  snapshots: bool, t_pad: int, packed: bool) -> None:
    n, b = config.num_procs, tr_len.shape[-1]
    want = {f: tuple(s) + (b,)
            for f, s in state_shapes(config, snapshots, packed).items()}
    want["tr"] = (n, t_pad, b)
    want["tr_len"] = (n, b)
    dtypes = {f: TORCH_DTYPES[d]
              for f, d in state_dtypes(config, snapshots, packed).items()}
    dtypes["tr"] = dtypes["tr_len"] = torch.int32
    planes = {f: state[f] for f in fields}
    planes.update(tr=tr, tr_len=tr_len)
    dev = tr.device
    for f, x in planes.items():
        if x.device != dev:
            raise ValueError(f"plane {f!r} is on {x.device}, not {dev}")
        if x.dtype != dtypes[f]:
            raise ValueError(
                f"plane {f!r} is {x.dtype}, expected {dtypes[f]}")
        if tuple(x.shape) != want[f]:
            raise ValueError(
                f"plane {f!r} has shape {tuple(x.shape)}, expected {want[f]}")
        if not x.is_contiguous():
            raise ValueError(f"plane {f!r} is not contiguous")


def _plane_ptrs(state, prefix: str, split_sw: int) -> WordPlanes:
    """The cache/directory planes named ``prefix`` + field (those
    ``state`` holds) as a ``WordPlanes``."""
    p = WordPlanes()
    for f in ("cachew", "dirw", "cvalw", "cmetaw", "dmemw", "dmetaw"):
        if prefix + f in state:
            setattr(p, f, state[prefix + f].data_ptr())
    for w in range(split_sw):
        p.dirs[w] = state[f"{prefix}dirs{w}"].data_ptr()
    return p


def _kernel_args(config: SystemConfig, state, tr, tr_len, status, *,
                 block, k, window, n_seg, max_calls, gate,
                 snapshots, packed=False) -> Args:
    layout, W = _mb_layout(config)
    slsc = _scalar_layout(config, window)
    sem = config.semantics
    split_sw = _split_sw(config)
    a = Args()
    a.n, a.c, a.m = config.num_procs, config.cache_size, config.mem_size
    a.cap, a.W = config.msg_buffer_size, W
    a.SW = _sharer_words(config)
    a.b, a.bb = tr_len.shape[1], block
    a.window, a.n_seg, a.t_pad = window, n_seg, tr.shape[1]
    a.k, a.max_calls, a.gate, a.snapshots = k, max_calls, gate, snapshots
    a.nack = sem.intervention_miss_policy == "nack"
    a.eager_write = sem.eager_write_request_memory
    a.flush_old_fill = sem.flush_invack_fills_old_value
    a.recv_packed = "recv" in layout
    a.packed = packed
    if packed:
        pdt = packed_plane_dtypes(config)
        a.cmeta_u16 = pdt["cmetaw"].itemsize == 2
        a.dmeta_u16 = pdt["dmetaw"].itemsize == 2
    for i, f in enumerate(_FIELDS):
        a.f_word[i], a.f_off[i], a.f_width[i] = layout.get(f, (0, 0, 0))
    for f in ("count_mask", "off_wait", "off_pw", "off_pc", "pc_mask"):
        setattr(a, f, slsc[f])
    ptr = lambda f: state[f].data_ptr() if f in state else None  # noqa: E731
    a.live = _plane_ptrs(state, "", split_sw)
    a.nsw = ptr("nsw")
    for w in range(W):
        a.mb[w], a.ob[w] = ptr(f"mb{w}"), ptr(f"ob{w}")
    a.ob_recv = ptr("ob_recv")
    if snapshots:
        a.snap_taken = ptr("snap_taken")
        a.snap = _plane_ptrs(state, "snap_", split_sw)
    a.scalars, a.msg_counts = ptr("scalars"), ptr("msg_counts")
    a.tr, a.tr_len, a.status = tr.data_ptr(), tr_len.data_ptr(), \
        status.data_ptr()
    return a


def stream_run(config: SystemConfig, state: Dict[str, torch.Tensor],
               tr: torch.Tensor, tr_len: torch.Tensor, *, block: int,
               k: int, window: int, n_seg: int, max_calls: int, gate: bool,
               snapshots: bool, packed: bool = False) -> torch.Tensor:
    """Run every system of ``state`` through all ``n_seg`` windows of
    ``tr`` [N, n_seg*window, B], updating the carried planes in place.
    Returns the [1, B] int32 per-lane stall plane (its block's flag).

    CPU tensors run the plain version; CUDA tensors launch the kernel,
    which takes at most ``MAX_NODES`` nodes."""
    fields = fields_of(config, snapshots, packed)
    b = tr_len.shape[-1]
    if block < 1 or block > MAX_BLOCK or b % block:
        raise ValueError(
            f"block={block} must divide the {b} lanes and be at most "
            f"{MAX_BLOCK} (one thread per system)")
    _check_planes(config, state, tr, tr_len, fields, snapshots,
                  n_seg * window, packed)
    kw = dict(block=block, k=k, window=window, n_seg=n_seg,
              max_calls=max_calls, gate=gate, snapshots=snapshots,
              packed=packed)
    dev = tr.device
    if dev.type == "cpu":
        new, status = stream_run_plain(config, state, tr, tr_len, **kw)
        for f in fields:
            state[f].copy_(new[f])
        return status
    if dev.type != "cuda":
        raise ValueError(f"no stream_run for device {dev}")
    check_kernel_bound(config)
    status = torch.empty((1, b), dtype=torch.int32, device=dev)
    args = _kernel_args(config, state, tr, tr_len, status, **kw)
    STREAM_RUN.launch(args, dev)
    return status
