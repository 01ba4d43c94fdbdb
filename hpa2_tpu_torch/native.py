"""ctypes binding to the repo's C++/OpenMP engine (``native/src/``): the
port's own counterpart of ``hpa2_tpu/native.py`` (l.1-197), with the
same C API (``native/src/capi.cpp``: ``hpa2_run_dir``,
``hpa2_bench_random``, ``hpa2_probe_transition``).

The engine is the OpenMP baseline the bench compares against and a
third lockstep oracle beside the spec engine.  It runs on the host.

**Its own build.**  The port never runs ``make -C native`` and never
loads ``native/build/``, which the JAX package's binding builds and
loads: the two packages' tests run in parallel workers and would race
on one build.  At first use it compiles ``native/src/{sim,io,capi}.cpp``
with ``g++ -std=c++17 -O2 -fopenmp -fPIC -shared`` into
``hpa2_tpu_torch/build/native/libhpa2sim_<digest>.so``, named by a hash
of the sources and flags.  A worker compiles into a file of its own and
renames it into place, so parallel first uses do not race either.  A
failed build raises ``NativeError``.  :func:`ensure_sanitized` builds the
engine's command-line program (``native/src/main.cpp``) the same way
with AddressSanitizer and UndefinedBehaviorSanitizer, for
``hpa2_tpu_torch/scripts/run_static.sh``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional

from hpa2_tpu_torch.config import SystemConfig

_REPO_ROOT = Path(__file__).resolve().parent.parent
NATIVE_SRC = _REPO_ROOT / "native" / "src"
BUILD_DIR = Path(__file__).resolve().parent / "build" / "native"
SOURCES = ("sim.cpp", "io.cpp", "capi.cpp")
HEADERS = ("sim.hpp",)
CXX_FLAGS = ("-std=c++17", "-O2", "-fopenmp", "-fPIC", "-shared")
#: the ASan+UBSan build of the CLI (``native/Makefile``'s ``asan``)
SAN_SOURCES = ("sim.cpp", "io.cpp", "main.cpp")
SAN_FLAGS = ("-std=c++17", "-O1", "-g", "-fno-omit-frame-pointer",
             "-fopenmp", "-fsanitize=address,undefined",
             "-fno-sanitize-recover=undefined")


class Hpa2Result(ctypes.Structure):
    _fields_ = [
        ("instructions", ctypes.c_ulonglong),
        ("messages", ctypes.c_ulonglong),
        ("cycles", ctypes.c_ulonglong),
        ("seconds", ctypes.c_double),
        ("ok", ctypes.c_int),
        ("error", ctypes.c_char * 256),
    ]


class NativeError(RuntimeError):
    pass


def _digest(flags, sources) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    for name in sources + HEADERS:
        h.update(name.encode())
        h.update((NATIVE_SRC / name).read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where this checkout's sources build to (a digest of the sources
    and the flags names the file, so a stale build is never loaded)."""
    return BUILD_DIR / f"libhpa2sim_{_digest(CXX_FLAGS, SOURCES)}.so"


def sanitized_path() -> Path:
    """Where the ASan+UBSan build of the engine's CLI goes."""
    return BUILD_DIR / f"hpa2sim_asan_{_digest(SAN_FLAGS, SAN_SOURCES)}"


def _compile(path: Path, flags, sources, force: bool) -> str:
    """``g++ flags sources -o path`` unless ``path`` exists (or
    ``force``), into a file of this process renamed into place."""
    if path.exists() and not force:
        return str(path)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *flags, *(str(NATIVE_SRC / s) for s in sources),
           "-o", str(tmp)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise NativeError(f"cannot run g++ to build the native engine: {e}")
    if proc.returncode != 0:
        raise NativeError(
            f"g++ failed on native/src ({proc.returncode}):\n"
            f"{proc.stderr[-4000:]}")
    os.replace(tmp, path)
    return str(path)


def ensure_built(force: bool = False) -> str:
    """Compile the library unless this source's build exists (or
    ``force``); returns its path.  Raises ``NativeError`` if g++
    fails."""
    return _compile(library_path(), CXX_FLAGS, SOURCES, force)


def ensure_sanitized(force: bool = False) -> str:
    """Compile the engine's command-line program with AddressSanitizer
    and UndefinedBehaviorSanitizer (``make -C native asan``'s flags) into
    this package's build folder; returns its path.  Raises
    ``NativeError`` if g++ fails, as it does where the sanitizers'
    runtime is missing."""
    return _compile(sanitized_path(), SAN_FLAGS, SAN_SOURCES, force)


_lib = None


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(ensure_built())
        lib.hpa2_run_dir.restype = ctypes.c_int
        lib.hpa2_run_dir.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_int, ctypes.c_ulonglong, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(Hpa2Result),
        ]
        lib.hpa2_bench_random.restype = ctypes.c_int
        lib.hpa2_bench_random.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_ulonglong, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(Hpa2Result),
        ]
        lib.hpa2_probe_transition.restype = ctypes.c_int
        lib.hpa2_probe_transition.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        ]
        _lib = lib
    return _lib


def _check_config(config: SystemConfig) -> None:
    if config.num_procs > 64:
        raise NativeError(
            "native backend supports up to 64 nodes (single-word sharer "
            "mask); use the JAX backend beyond"
        )
    if config.messages_per_cycle != 1:
        raise NativeError(
            "the native backend drains one message per node per cycle "
            "(lockstep) / free-runs (omp); messages_per_cycle > 1 runs "
            "on the spec engine"
        )


def _sem_flags(config: SystemConfig) -> int:
    """Semantics bitmask of the C API (``capi.cpp`` apply_sem_flags);
    bit 0 is the 0/1 'robust' encoding of older callers."""
    sem = config.semantics
    return (
        (1 if sem.intervention_miss_policy == "nack" else 0)
        | (2 if sem.eager_write_request_memory else 0)
        | (4 if sem.flush_invack_fills_old_value else 0)
        | (8 if sem.overloaded_evict_shared_notify else 0)
    )


def run_trace_dir(
    config: SystemConfig,
    trace_dir: str,
    out_dir: str,
    mode: str = "lockstep",
    replay_path: Optional[str] = None,
    candidates: bool = False,
    final_dump: bool = False,
    max_cycles: int = 100_000_000,
    threads: int = 0,
    record_order_path: Optional[str] = None,
    msg_trace_path: Optional[str] = None,
) -> Hpa2Result:
    """Run the native engine on a trace directory; it writes the
    reference-format dump files into ``out_dir``.  ``mode="omp"`` is the
    free-running thread-per-node mode (nondeterministic interleavings),
    ``"lockstep"`` the deterministic schedule of the spec engine.
    ``record_order_path`` writes the executed issue interleaving
    (DEBUG_INSTR lines, replayable), ``msg_trace_path`` the per-message
    DEBUG_MSG log."""
    _check_config(config)
    lib = _load()
    res = Hpa2Result()
    rc = lib.hpa2_run_dir(
        trace_dir.encode(), out_dir.encode(),
        1 if mode == "omp" else 0,
        config.num_procs, config.cache_size, config.mem_size,
        config.msg_buffer_size, config.max_instr_num,
        _sem_flags(config),
        (replay_path or "").encode(), int(candidates), int(final_dump),
        max_cycles, threads, (record_order_path or "").encode(),
        (msg_trace_path or "").encode(),
        ctypes.byref(res),
    )
    if rc != 0 or not res.ok:
        raise NativeError(res.error.decode() or "native run failed")
    return res


def probe_transition(config: SystemConfig, probe_in) -> list:
    """Stage and run one transition on the native engine: ``probe_in``
    is the packed 22-slot scenario of ``hpa2_tpu/analysis/extract.py``
    (``_native_packed``); returns the raw output block (8 header slots
    and 5 a emission)."""
    _check_config(config)
    lib = _load()
    if len(probe_in) != 22:
        raise NativeError(f"probe input must be 22 slots, got {len(probe_in)}")
    in_arr = (ctypes.c_longlong * 22)(*probe_in)
    out_cap = 8 + 5 * 8
    out_arr = (ctypes.c_longlong * out_cap)()
    rc = lib.hpa2_probe_transition(
        config.num_procs, config.cache_size, config.mem_size,
        config.msg_buffer_size, _sem_flags(config),
        in_arr, out_arr, out_cap,
    )
    if rc != 0:
        raise NativeError(f"native probe failed (rc={rc})")
    return list(out_arr)


def bench_random(
    config: SystemConfig,
    instrs_per_core: int,
    seed: int = 0,
    mode: str = "omp",
    threads: int = 0,
) -> Hpa2Result:
    """Synthetic uniform-random benchmark (traces drawn natively);
    returns the counters and the wall time."""
    _check_config(config)
    lib = _load()
    res = Hpa2Result()
    rc = lib.hpa2_bench_random(
        1 if mode == "omp" else 0,
        config.num_procs, config.cache_size, config.mem_size,
        config.msg_buffer_size, instrs_per_core, seed,
        _sem_flags(config),
        threads, ctypes.byref(res),
    )
    if rc != 0 or not res.ok:
        raise NativeError(res.error.decode() or "native bench failed")
    return res
