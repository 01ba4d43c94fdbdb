"""The CUDA kernels: their build, their binding, their launch counts
and, for the fast path, the dispatch between each and its plain version.

Two kernels share the cycle in ``csrc/cycle.cuh``:

* ``csrc/stream_run.cu``, the streamed run (``stream=True``): one
  launch drives the whole run;
* ``csrc/call_run.cu``, the per-call kernel (``stream=False``): one
  launch is one call of up to ``k`` cycles in one trace window, driven
  from the host by ``ops/call_run.py:run_windows``.

A third library, ``csrc/micro_kernels.cu`` (:data:`MICRO`), holds the
five op-pattern micro-kernels that ``scripts/micro_kernels.py`` drives.
A fourth, ``csrc/node_cycle.cu`` (:data:`NODE_CYCLE`), holds the four
kernels of K1's node-sharded cycle; its entries, each with its own
launch count (:class:`KernelEntry`), are ``ops/node_cycle.py``'s.
Two more (:data:`ABLATE_KERNELS`) are the two fast-path sources built
again with ``-DHPA2_ABLATE``: K1's ablation variant inside each, a
deliberately wrong cycle with named stages stubbed out at run time
(``ops/cycle.py:ABLATE_STAGES``), for timing only
(``scripts/perf_sweep.py --ablate``).  They are not on the main path,
so they stay out of :data:`KERNELS`.

Each is compiled by ``nvcc`` for ``sm_90a`` into a shared library with a
plain C interface under ``hpa2_tpu_torch/build/`` at first use (the
builds run at once), and loaded with ``ctypes``.  A library's name
carries a hash of its sources and flags, so an edited source is rebuilt
and a stale build is never loaded.  The two fast-path libraries hold
their kernel instantiated for node bounds 8, 21 and 64, each with int32
or packed planes, and report ``sizeof(Args)``, which must equal the
ctypes mirror's.

Their launch geometry (:func:`launch_geometry`): each system runs on
:func:`threads_per_system` threads (2, 8 or 16 by the node bound), one
per node rank; a CTA has at most :data:`MAX_CTA` threads, so it runs
at most 256, 64 or 32 systems at once, in rounds when it holds more; a
lane block of ``block`` systems is one thread-block cluster of at most
:data:`MAX_CLUSTER` CTAs.

:func:`stream_run` and :func:`call_run` are the entries the engine
calls.  On CPU tensors they run the plain PyTorch version
(``ops/stream_run.py``, ``ops/call_run.py``); on CUDA tensors they
launch the kernel or raise.  Either way the carried planes are updated
in place.  :data:`HOST_SYNCS` counts the device values the engines read
back to the host, and :data:`CALLS` the wrappers' calls.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.ops.layout import (
    TORCH_DTYPES, _mb_layout, _scalar_layout, _sharer_words, _split_sw,
    fields_of, packed_plane_dtypes, state_dtypes, state_shapes,
)
from hpa2_tpu_torch.ops.call_run import call_plain
from hpa2_tpu_torch.ops.cycle import ablate_mask
from hpa2_tpu_torch.ops.stream_run import stream_run_plain

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

#: the header every kernel source includes
SHARED_SOURCES = ("cycle.cuh",)
#: builds and launch counts are shared by the threads of logical ranks
#: (``parallel/comm.py:LocalComm``)
_LOCK = threading.RLock()
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: threads a CTA of the fast-path kernels (kMaxCta in csrc/cycle.cuh)
MAX_CTA = 512
#: threads any CTA may have (a CUDA limit); a lane block of the
#: micro-kernels is one CTA, one thread a lane
MAX_CTA_THREADS = 1024
#: CTAs a lane block: one thread-block cluster, above 8 CTAs of a
#: non-portable size (kMaxCluster)
MAX_CLUSTER = 16
#: the widest system of the largest compiled node bound (kMaxNodes)
MAX_NODES = 64
#: message and sharer words of that bound's frame (kMaxW, kMaxSW)
MAX_WORDS = 5
MAX_SHARER_WORDS = 3

#: the largest lane block the card takes at each node bound (2, 8 and
#: 16 threads a system): one cluster of MAX_CLUSTER CTAs of 256, 64 and
#: 32 systems a round, in as many rounds as a CTA's dynamic shared
#: memory allows (``Shared<MAXN>::bytes`` in csrc/cycle.cuh grows by
#: 29,696, 9,088 and 7,296 B a round from 74,760, 45,320 and 99,464 B,
#: against the 232,448 B a CTA may opt into): 5, 20 and 18 rounds.
#: Measured by ``scripts/block_limits.py`` on an NVIDIA H100 80GB HBM3
#: (700 W): at each bound, unpacked and packed, the card accepts the
#: launch of that block (223,240, 227,080 and 230,792 B a CTA, one CTA
#: an SM, at least one cluster at once) and refuses one more round.
#: The plain versions take any block that divides the lanes.
MAX_LANE_BLOCK = {8: 20480, 21: 20480, 64: 9216}

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
            "n", "c", "m", "cap", "W", "SW", "b", "bb", "cl", "per_cta",
            "rounds", "group", "window",
            "n_seg", "t_pad", "seg", "k", "max_calls", "gate", "snapshots",
            "nack", "eager_write", "flush_old_fill", "recv_packed", "packed",
            "cmeta_u16", "dmeta_u16")]
        + [("f_word", ctypes.c_int32 * len(_FIELDS)),
           ("f_off", ctypes.c_int32 * len(_FIELDS)),
           ("f_width", ctypes.c_int32 * len(_FIELDS))]
        + [(f, ctypes.c_int32) for f in (
            "count_mask", "off_wait", "off_pw", "off_pc", "pc_mask",
            "ablate")]
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


def _source_hash(sources: Tuple[str, ...],
                 defines: Tuple[str, ...] = ()) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + defines).encode())
    for name in sources:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


class CudaKernel:
    """One kernel library: its build and binding, and its launch count.

    The entry takes ``params`` (ctypes types), then the device index and
    the stream, and returns a CUDA error code.  With a ``mirror``, the
    library's ``hpa2_args_size()`` must equal that structure's size.
    ``launches`` counts kernel launches and nothing else; the plain
    version never touches it.  ``loads`` counts loads of the library
    (one a process).  ``defines`` are extra ``-D`` flags of its build."""

    def __init__(self, name: str, source: str, entry: str, replaces: str,
                 *, headers: Tuple[str, ...] = SHARED_SOURCES,
                 params: Tuple = (ctypes.POINTER(Args),),
                 mirror: Optional[type] = Args,
                 defines: Tuple[str, ...] = ()) -> None:
        self.name = name
        self.source = f"hpa2_tpu_torch/csrc/{source}"
        self.replaces = replaces
        self.entry = entry
        self.launches = 0
        self.loads = 0
        self.build_log = ""
        self._sources = (source,) + headers
        self._params = params
        self._mirror = mirror
        self._defines = tuple(f"-D{d}" for d in defines)
        self._lib: Optional[ctypes.CDLL] = None
        self._path: Optional[Path] = None
        self._proc: Optional[subprocess.Popen] = None

    def library_path(self) -> Path:
        digest = _source_hash(self._sources, self._defines)
        return BUILD_DIR / f"libhpa2_{self.name}_{digest}.so"

    def _tmp_path(self) -> Path:
        return self.library_path().with_suffix(f".{os.getpid()}.tmp")

    def start_build(self) -> None:
        """Start ``nvcc`` on this kernel's source unless it is built,
        loaded or being built; :meth:`build` waits for it."""
        if self._lib is not None or self._proc is not None \
                or self.library_path().exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cmd = [find_nvcc(), *NVCC_FLAGS, *self._defines, "-o",
               str(self._tmp_path()),
               str(CSRC_DIR / self._sources[0])]
        self._proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)

    def build(self) -> Path:
        """Compile the library unless this source's build exists; load
        it.  Returns the library's path."""
        if self._lib is not None:  # hashing the sources costs ~0.1 ms
            return self._path
        with _LOCK:
            return self._build()

    def _build(self) -> Path:
        if self._lib is not None:
            return self._path
        path = self.library_path()
        self.start_build()
        log = BUILD_DIR / (path.stem + ".log")
        if self._proc is not None:
            proc, self._proc = self._proc, None
            self.build_log = proc.communicate()[0]
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {self.source} ({proc.returncode}):\n"
                    f"{self.build_log}")
            log.write_text(self.build_log)
            os.replace(self._tmp_path(), path)
        else:
            self.build_log = log.read_text() if log.exists() else ""
        lib = ctypes.CDLL(str(path))
        if self.entry is not None:
            fn = getattr(lib, self.entry)
            fn.argtypes = [*self._params, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
        if self._mirror is not None:
            lib.hpa2_args_size.argtypes = []
            lib.hpa2_args_size.restype = ctypes.c_int
            size = lib.hpa2_args_size()
            if size != ctypes.sizeof(self._mirror):
                raise RuntimeError(
                    f"hpa2::Args is {size} bytes but the ctypes mirror is "
                    f"{ctypes.sizeof(self._mirror)}: kernels.Args is out "
                    "of date")
        self._lib, self._path = lib, path
        self.loads += 1
        return path

    def launch(self, *args, device: torch.device) -> None:
        """Launch on ``device``'s current stream with ``args`` (as the
        entry's ``params``); raises if the launch is refused."""
        self.build()
        _launch(self, getattr(self._lib, self.entry), args, device)

    def occupancy(self, args: Args, *, device: torch.device) -> Dict[str, int]:
        """What the card makes of a launch with ``args`` (a fast-path
        kernel): CTAs an SM holds, clusters the card holds at once, and
        a CTA's dynamic shared memory and threads.  Launches nothing."""
        self.build()
        out = (ctypes.c_int * 4)()
        fn = self._lib.hpa2_occupancy
        fn.argtypes = [ctypes.POINTER(Args), ctypes.c_int,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        with torch.cuda.device(device):
            err = fn(ctypes.byref(args), device.index or 0, out)
        if err != 0:
            raise RuntimeError(
                f"{self.name} occupancy query failed: CUDA error {err}")
        return dict(ctas_per_sm=out[0], clusters=out[1], smem=out[2],
                    threads=out[3], cl=args.cl)


class KernelEntry:
    """One kernel of a library that holds several (:data:`NODE_CYCLE`):
    its entry, its ``params`` (ctypes types; the device index and the
    stream follow) and its own launch count, which counts launches and
    nothing else."""

    def __init__(self, lib: CudaKernel, name: str, entry: str,
                 replaces: str, params: Tuple) -> None:
        self.lib = lib
        self.name = name
        self.entry = entry
        self.replaces = replaces
        self.source = lib.source
        self.launches = 0
        self._params = params
        self._fn = None

    def launch(self, *args, device: torch.device) -> None:
        """Launch on ``device``'s current stream; raises if the launch is
        refused."""
        if self._fn is None:
            self.lib.build()
            fn = getattr(self.lib._lib, self.entry)
            fn.argtypes = [*self._params, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._fn = fn
        _launch(self, self._fn, args, device)


def _launch(kern, fn, args, device: torch.device) -> None:
    """``fn(*args, device index, stream)`` on ``device``'s current
    stream; raises if the launch is refused, else counts it on
    ``kern``."""
    stream = torch.cuda.current_stream(device).cuda_stream
    # the entry makes ``device`` current (cudaSetDevice); the guard
    # gives PyTorch's current device back afterwards, so a launch on
    # another card of a data mesh leaves the caller's device as it was
    with torch.cuda.device(device):
        err = fn(*args, device.index or 0, stream)
    if err != 0:
        raise RuntimeError(
            f"{kern.name} kernel launch failed: CUDA error {err}")
    with _LOCK:
        kern.launches += 1


class WrapperCalls:
    """Calls of :func:`stream_run` and :func:`call_run`, counted at the
    wrapper, so that the plain versions on the CPU and the kernels on
    the card count alike (on the card each call is one launch, so the
    counts equal the libraries' ``launches``)."""

    def __init__(self) -> None:
        self.stream_run = 0
        self.call_run = 0


class HostSyncs:
    """Count of the device values the engines read back to the host
    (each is a host sync on the card): ``count`` over the process,
    :attr:`mine` this thread's (a logical rank's, under
    ``parallel/comm.py:LocalComm``)."""

    def __init__(self) -> None:
        self.count = 0
        self._tls = threading.local()

    @property
    def mine(self) -> int:
        return getattr(self._tls, "count", 0)

    def read(self, x: torch.Tensor):
        """``x`` on the host, counted: ``x.item()`` for a scalar tensor,
        else a numpy copy."""
        with _LOCK:
            self.count += 1
        self._tls.count = self.mine + 1
        return x.item() if x.dim() == 0 else x.cpu().numpy()


STREAM_RUN = CudaKernel("stream_run", "stream_run.cu", "hpa2_stream_run",
                        "hpa2_tpu/ops/pallas_engine.py:2244")
CALL_RUN = CudaKernel("call_run", "call_run.cu", "hpa2_call_run",
                      "hpa2_tpu/ops/pallas_engine.py:2027")

#: every kernel of the fast path
KERNELS = (STREAM_RUN, CALL_RUN)

#: K1's ablation variant inside K2 and K3 (``pallas_engine.py:545-547``,
#: stubs at :688, :1123, :1281, :1649): the same sources built with
#: ``-DHPA2_ABLATE``, int32 and packed planes at node bounds 8, 21 and
#: 64, the stubbed stages a runtime mask (``Args.ablate``).  Timing
#: tools only.
STREAM_RUN_ABLATE = CudaKernel(
    "stream_run_ablate", "stream_run.cu", "hpa2_stream_run_ablate",
    "hpa2_tpu/ops/pallas_engine.py:545", defines=("HPA2_ABLATE",))
CALL_RUN_ABLATE = CudaKernel(
    "call_run_ablate", "call_run.cu", "hpa2_call_run_ablate",
    "hpa2_tpu/ops/pallas_engine.py:545", defines=("HPA2_ABLATE",))
ABLATE_KERNELS = (STREAM_RUN_ABLATE, CALL_RUN_ABLATE)

#: the op-pattern micro-kernels (``scripts/micro_kernels.py:micro_run``):
#: pattern index, the mb/mem/rows/cnt planes, lanes, iterations, block
MICRO = CudaKernel(
    "micro_kernels", "micro_kernels.cu", "hpa2_micro_run",
    "scripts/micro_kernels.py:33", headers=("micro_kernels.cuh",),
    params=(ctypes.c_int,) + (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 3,
    mirror=None)

#: K1's node-sharded cycle (``ops/node_cycle.py``): four entries, N1-N4,
#: each instantiated for node bounds 8, 21 and 64 (int32 and packed
#: planes where it touches them), and the wide family's four entries for
#: wider systems (``node_*_wide``: message and sharer words at run time)
NODE_CYCLE = CudaKernel(
    "node_cycle", "node_cycle.cu", None, "hpa2_tpu/ops/pallas_engine.py:559",
    headers=("node_cycle.cuh",) + SHARED_SOURCES, params=())

#: every library, in the order :func:`build_all` builds them
LIBRARIES = KERNELS + ABLATE_KERNELS + (MICRO, NODE_CYCLE)

HOST_SYNCS = HostSyncs()
CALLS = WrapperCalls()


def check_kernel_bound(config: SystemConfig) -> None:
    """Raise unless the kernel's largest node bound holds ``config``
    (the plain version has no bound)."""
    if config.num_procs > MAX_NODES:
        raise ValueError(
            f"num_procs={config.num_procs} exceeds the CUDA kernel's node "
            f"bound of {MAX_NODES} (a system's shared-memory records and "
            "its message words in registers are sized by the bound at "
            "compile time); run it on the CPU with device='cpu'")


def node_bound(config: SystemConfig) -> int:
    """The node bound whose instantiation runs ``config`` (8, 21 or
    64; ``node_bound`` in csrc/cycle.cuh)."""
    n = config.num_procs
    return 8 if n <= 8 else (21 if n <= 21 else MAX_NODES)


def check_block(config: SystemConfig, block: int) -> None:
    """Raise unless the card takes lane blocks of ``block`` systems at
    ``config``'s node bound (:data:`MAX_LANE_BLOCK`)."""
    most = MAX_LANE_BLOCK[node_bound(config)]
    if block > most:
        raise ValueError(
            f"block={block} exceeds the {most} lanes a lane block takes "
            f"on the card at the {node_bound(config)}-node bound (one "
            "cluster, as many rounds a CTA as its shared memory holds); "
            "the plain version (device='cpu') takes any divisor of the "
            "lanes")


def threads_per_system(config: SystemConfig) -> int:
    """Threads the kernels spread one system over (Bound<MAXN>::T in
    csrc/cycle.cuh): 2 up to 8 nodes, 8 up to 21, 16 above (split sharer
    planes); thread t owns nodes t, t+T, ..."""
    n = config.num_procs
    return 2 if n <= 8 else (8 if n <= 21 else 16)


def launch_geometry(block: int, threads: int,
                    max_group: Optional[int] = None):
    """``(cl, per_cta, rounds, group)`` of a lane block of ``block``
    systems of ``threads`` threads each: ``cl`` CTAs (one cluster, at
    most :data:`MAX_CLUSTER`), none empty, each holding ``per_cta``
    systems and running them in ``rounds`` rounds of ``group`` systems,
    at most ``max_group`` (default: a full CTA, :data:`MAX_CTA`
    threads)."""
    most = MAX_CTA // threads
    max_group = most if max_group is None else max_group
    if not 1 <= max_group <= most:
        raise ValueError(f"max_group={max_group} outside 1..{most}")
    cl = min(MAX_CLUSTER, -(-block // max_group))
    per_cta = -(-block // cl)
    cl = -(-block // per_cta)
    rounds = -(-per_cta // max_group)
    return cl, per_cta, rounds, -(-per_cta // rounds)


def geometry_args(config: SystemConfig, *, lanes: int, block: int,
                  packed: bool = False,
                  max_group: Optional[int] = None) -> Args:
    """The fields of a launch's ``Args`` that pick its instantiation and
    geometry (for :meth:`CudaKernel.occupancy`)."""
    a = Args()
    a.n, a.W = config.num_procs, _mb_layout(config)[1]
    a.SW, a.cap = _sharer_words(config), config.msg_buffer_size
    a.b, a.bb, a.packed = lanes, block, packed
    a.cl, a.per_cta, a.rounds, a.group = launch_geometry(
        block, threads_per_system(config), max_group)
    return a


def build_all() -> None:
    """Build every library, all compilers started at once."""
    for k in LIBRARIES:
        k.start_build()
    for k in LIBRARIES:
        k.build()


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
    # (a system wider than MAX_NODES has more planes than the arrays
    # hold: the wide node kernels reach them through pointer tables of
    # their own, ops/node_cycle.py:WideArgs)
    for w in range(min(split_sw, MAX_SHARER_WORDS)):
        p.dirs[w] = state[f"{prefix}dirs{w}"].data_ptr()
    return p


def _kernel_args(config: SystemConfig, state, tr, tr_len, status, *,
                 block, k, window, n_seg, max_calls, gate,
                 snapshots, packed=False, seg=0,
                 max_group: Optional[int] = None) -> Args:
    layout, W = _mb_layout(config)
    slsc = _scalar_layout(config, window)
    sem = config.semantics
    split_sw = _split_sw(config)
    a = Args()
    a.n, a.c, a.m = config.num_procs, config.cache_size, config.mem_size
    a.cap, a.W = config.msg_buffer_size, W
    a.SW = _sharer_words(config)
    a.b, a.bb = tr_len.shape[1], block
    a.cl, a.per_cta, a.rounds, a.group = launch_geometry(
        block, threads_per_system(config), max_group)
    a.window, a.n_seg, a.t_pad, a.seg = window, n_seg, tr.shape[1], seg
    a.k, a.max_calls, a.gate, a.snapshots = k, max_calls, gate, snapshots
    a.nack = sem.intervention_miss_policy == "nack"
    a.eager_write = sem.eager_write_request_memory
    a.flush_old_fill = sem.flush_invack_fills_old_value
    a.recv_packed = "recv" in layout
    a.packed = packed
    if packed:
        u16 = {f: d.itemsize == 2
               for f, d in packed_plane_dtypes(config).items()}
        a.cmeta_u16, a.dmeta_u16 = u16["cmetaw"], u16["dmetaw"]
    for i, f in enumerate(_FIELDS):
        a.f_word[i], a.f_off[i], a.f_width[i] = layout.get(f, (0, 0, 0))
    for f in ("count_mask", "off_wait", "off_pw", "off_pc", "pc_mask"):
        setattr(a, f, slsc[f])
    ptr = lambda f: state[f].data_ptr() if f in state else None  # noqa: E731
    a.live = _plane_ptrs(state, "", split_sw)
    a.nsw = ptr("nsw")
    for w in range(min(W, MAX_WORDS)):
        a.mb[w], a.ob[w] = ptr(f"mb{w}"), ptr(f"ob{w}")
    a.ob_recv = ptr("ob_recv")
    if snapshots:
        a.snap_taken = ptr("snap_taken")
        a.snap = _plane_ptrs(state, "snap_", split_sw)
    a.scalars, a.msg_counts = ptr("scalars"), ptr("msg_counts")
    a.tr, a.tr_len = tr.data_ptr(), tr_len.data_ptr()
    a.status = None if status is None else status.data_ptr()
    return a


def _ablation_kernel(kern: CudaKernel, ablate: frozenset) -> CudaKernel:
    """The library a launch on the card takes: ``kern``, or with
    ``ablate`` its ablation variant."""
    if not ablate:
        return kern
    return STREAM_RUN_ABLATE if kern is STREAM_RUN else CALL_RUN_ABLATE


def _check_launch(config, state, tr, tr_len, *, block, window, n_seg,
                  snapshots, packed) -> None:
    b = tr_len.shape[-1]
    if block < 1 or b % block:
        raise ValueError(f"block={block} must divide the {b} lanes")
    _check_planes(config, state, tr, tr_len,
                  fields_of(config, snapshots, packed), snapshots,
                  n_seg * window, packed)
    dev = tr.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel for device {dev}")
    if dev.type == "cuda":
        check_kernel_bound(config)
        check_block(config, block)


def stream_run(config: SystemConfig, state: Dict[str, torch.Tensor],
               tr: torch.Tensor, tr_len: torch.Tensor, *, block: int,
               k: int, window: int, n_seg: int, max_calls: int, gate: bool,
               snapshots: bool, packed: bool = False,
               ablate: frozenset = frozenset()) -> torch.Tensor:
    """Run every system of ``state`` through all ``n_seg`` windows of
    ``tr`` [N, n_seg*window, B], updating the carried planes in place.
    Returns the [1, B] int32 per-lane stall plane (its block's flag).

    CPU tensors run the plain version; CUDA tensors launch the kernel,
    which takes at most ``MAX_NODES`` nodes and lane blocks of at most
    ``MAX_LANE_BLOCK`` systems.  A non-empty ``ablate`` (a set of
    ``ops/cycle.py:ABLATE_STAGES``) runs the deliberately wrong ablated
    cycle: on the card the ablation kernel, on the CPU the plain version
    with the same stubs."""
    _check_launch(config, state, tr, tr_len, block=block, window=window,
                  n_seg=n_seg, snapshots=snapshots, packed=packed)
    kw = dict(block=block, k=k, window=window, n_seg=n_seg,
              max_calls=max_calls, gate=gate, snapshots=snapshots,
              packed=packed)
    CALLS.stream_run += 1
    dev = tr.device
    if dev.type == "cpu":
        new, status = stream_run_plain(config, state, tr, tr_len,
                                       ablate=ablate, **kw)
        for f in fields_of(config, snapshots, packed):
            state[f].copy_(new[f])
        return status
    kern = _ablation_kernel(STREAM_RUN, ablate)
    b = tr_len.shape[-1]
    status = torch.empty((1, b), dtype=torch.int32, device=dev)
    args = _kernel_args(config, state, tr, tr_len, status, **kw)
    args.ablate = ablate_mask(ablate)
    kern.launch(ctypes.byref(args), device=dev)
    return status


def call_run(config: SystemConfig, state: Dict[str, torch.Tensor],
             tr: torch.Tensor, tr_len: torch.Tensor, *, seg: int,
             block: int, k: int, window: int, gate: bool, snapshots: bool,
             packed: bool = False, ablate: frozenset = frozenset()) -> None:
    """One call of up to ``k`` cycles of every lane block in trace window
    ``seg`` of ``tr`` [N, n_seg*window, B], updating the carried planes
    in place.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (asynchronously, on the current stream), which takes at most
    ``MAX_NODES`` nodes.  ``ablate`` as in :func:`stream_run`."""
    if window < 1 or tr.shape[1] % window:
        raise ValueError(
            f"the trace plane's {tr.shape[1]} rows are not whole windows "
            f"of {window}")
    n_seg = tr.shape[1] // window
    if not 0 <= seg < n_seg:
        raise ValueError(f"window {seg} outside 0..{n_seg - 1}")
    _check_launch(config, state, tr, tr_len, block=block, window=window,
                  n_seg=n_seg, snapshots=snapshots, packed=packed)
    kw = dict(block=block, k=k, window=window, gate=gate,
              snapshots=snapshots, packed=packed)
    CALLS.call_run += 1
    if tr.device.type == "cpu":
        new = call_plain(config, state, tr, tr_len, seg=seg, ablate=ablate,
                         **kw)
        for f in fields_of(config, snapshots, packed):
            state[f].copy_(new[f])
        return
    kern = _ablation_kernel(CALL_RUN, ablate)
    args = _kernel_args(config, state, tr, tr_len, None, n_seg=n_seg,
                        max_calls=0, seg=seg, **kw)
    args.ablate = ablate_mask(ablate)
    kern.launch(ctypes.byref(args), device=tr.device)
