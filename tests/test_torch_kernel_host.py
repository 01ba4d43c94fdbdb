"""The CUDA kernel's logic, compiled for the host, against the plain
PyTorch version.

``csrc/cycle.cuh`` is ``__host__ __device__`` code, so ``g++`` builds
the same cycle and run loop into a throwaway shared library (under the
ignored ``hpa2_tpu_torch/build/``) that works on CPU tensors through the
kernel's own argument block.  The library is test tooling only; the
engine never reaches it.  Planes and the stall plane must agree bit for
bit with ``ops/cycle.py``, ``ops/stream_run.py`` and the per-call
kernel's ``ops/call_run.py``, at every node bound the kernels are built
for (8, 21 and 64: split sharer planes above 21 nodes) and with packed
planes."""

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from hpa2_tpu_torch.config import Semantics, SystemConfig
from hpa2_tpu_torch.convert import state_from_numpy
from hpa2_tpu_torch.ops import kernels
from hpa2_tpu_torch.ops.call_run import call_plain
from hpa2_tpu_torch.ops.cycle import build_cycle
from hpa2_tpu_torch.ops.layout import (
    _init_state, _pack_traces, _scalar_layout, fields_of,
)
from hpa2_tpu_torch.ops.stream_run import stream_run_plain
from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays

# the same MAXN dispatch as csrc/stream_run.cu
SHIM = r"""
#include "cycle.cuh"
template <int MAXN, bool PACKED> void cycle_lanes(const hpa2::Args* a, int seg) {
  for (int l = 0; l < a->b; ++l) hpa2::run_cycle<MAXN, PACKED>(*a, l, seg);
}
template <int MAXN, bool PACKED> void stream_blocks(const hpa2::Args* a) {
  for (int l0 = 0; l0 < a->b; l0 += a->bb)
    hpa2::stream_lanes<MAXN, PACKED>(*a, l0, l0 + a->bb);
}
template <int MAXN, bool PACKED> void call_blocks(const hpa2::Args* a) {
  for (int l0 = 0; l0 < a->b; l0 += a->bb)
    hpa2::call_lanes<MAXN, PACKED>(*a, l0, l0 + a->bb);
}
// what: 0 one cycle of every lane, 1 the streamed run, 2 one call
template <int MAXN, bool PACKED> void run_as(const hpa2::Args* a, int seg, int what) {
  if (what == 0) cycle_lanes<MAXN, PACKED>(a, seg);
  else if (what == 1) stream_blocks<MAXN, PACKED>(a);
  else call_blocks<MAXN, PACKED>(a);
}
template <int MAXN> void run(const hpa2::Args* a, int seg, int what) {
  a->packed ? run_as<MAXN, true>(a, seg, what) : run_as<MAXN, false>(a, seg, what);
}
void dispatch(const hpa2::Args* a, int seg, int what) {
  if (a->n <= 8) run<8>(a, seg, what);
  else if (a->n <= 21) run<21>(a, seg, what);
  else run<64>(a, seg, what);
}
extern "C" int hpa2_args_size() { return (int)sizeof(hpa2::Args); }
extern "C" int hpa2_host_cycle(const hpa2::Args* a, int seg) {
  dispatch(a, seg, 0);
  return 0;
}
extern "C" int hpa2_host_stream_run(const hpa2::Args* a) {
  dispatch(a, 0, 1);
  return 0;
}
extern "C" int hpa2_host_call_run(const hpa2::Args* a) {
  dispatch(a, a->seg, 2);
  return 0;
}
"""
#: (num_procs, cache_size, mem_size) of the wide geometries: SW = 1, 2, 3
SPLIT22, SPLIT33, SPLIT64 = (22, 2, 4), (33, 4, 8), (64, 2, 4)


@pytest.fixture(scope="module")
def host_lib():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    h = hashlib.sha256(SHIM.encode())
    h.update((kernels.CSRC_DIR / "cycle.cuh").read_bytes())
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = kernels.BUILD_DIR / f"host_check_{h.hexdigest()[:16]}.so"
    if not so.exists():
        src = so.with_suffix(".cpp")
        src.write_text(SHIM)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(
            [gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
             f"-I{kernels.CSRC_DIR}", "-o", str(tmp), str(src)],
            check=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.hpa2_host_cycle.argtypes = [ctypes.POINTER(kernels.Args),
                                    ctypes.c_int]
    lib.hpa2_host_stream_run.argtypes = [ctypes.POINTER(kernels.Args)]
    lib.hpa2_host_call_run.argtypes = [ctypes.POINTER(kernels.Args)]
    return lib


def _setup(n, cap, robust, b, t, seed, snapshots, window, geom=None,
           packed=False):
    sem = Semantics().robust() if robust else Semantics()
    c, m = (geom or (n, 4, 16))[1:]
    cfg = SystemConfig(num_procs=n, msg_buffer_size=cap, semantics=sem,
                       cache_size=c, mem_size=m)
    op, addr, val, length = gen_uniform_random_arrays(cfg, b, t, seed=seed)
    n_seg = -(-t // window)
    tr = _pack_traces(cfg, op, addr, val, length)
    tr = np.pad(tr, ((0, 0), (0, n_seg * window - t), (0, 0)))
    state = state_from_numpy(_init_state(cfg, b, snapshots, packed), "cpu")
    return (cfg, state, torch.from_numpy(tr),
            torch.from_numpy(np.ascontiguousarray(length.T)), n_seg)


def test_host_args_size_matches_mirror(host_lib):
    assert host_lib.hpa2_args_size() == ctypes.sizeof(kernels.Args)


@pytest.mark.parametrize(
    "n,cap,robust,snapshots,geom,packed,cycles",
    [(4, 16, True, True, None, False, 300),
     (4, 4, False, False, None, False, 300),
     (8, 4, True, False, None, False, 300),
     (8, 32, False, True, None, False, 300),
     (4, 16, True, True, None, True, 300),
     (8, 4, True, False, (8, 2, 8), True, 300),
     (22, 16, True, True, SPLIT22, False, 150),
     (22, 4, True, True, SPLIT22, True, 150),
     (33, 32, True, False, SPLIT33, False, 100),
     (64, 16, True, True, SPLIT64, False, 60)],
)
def test_host_cycle_matches_plain(host_lib, n, cap, robust, snapshots, geom,
                                  packed, cycles):
    cfg, state, tr, tr_len, _ = _setup(n, cap, robust, b=4, t=24, seed=n,
                                       snapshots=snapshots, window=24,
                                       geom=geom, packed=packed)
    fields = fields_of(cfg, snapshots, packed)
    plain = build_cycle(cfg, snapshots, packed)
    host = {f: v.clone() for f, v in state.items()}
    status = torch.zeros((1, 4), dtype=torch.int32)
    args = kernels._kernel_args(
        cfg, host, tr, tr_len, status, block=4, k=1, window=24, n_seg=1,
        max_calls=1, gate=False, snapshots=snapshots, packed=packed)
    cur = state
    for i in range(cycles):
        out = plain({**cur, "tr": tr, "tr_len": tr_len})
        cur = {f: out[f] for f in fields}
        host_lib.hpa2_host_cycle(ctypes.byref(args), 0)
        for f in fields:
            assert torch.equal(host[f], cur[f]), f"cycle {i}, plane {f!r}"
    assert int(cur["scalars"][1].sum()) > 0


@pytest.mark.parametrize(
    "n,cap,robust,window,t,gate,snapshots,max_calls,geom,packed",
    [
        (8, 16, True, 8, 20, True, False, 10_000, None, False),
        (8, 16, True, 32, 32, False, True, 10_000, None, False),
        (4, 8, True, 3, 12, True, False, 10_000, None, False),
        (4, 16, False, 16, 16, True, True, 6, None, False),  # drop: stalls
        (8, 16, True, 8, 20, True, False, 10_000, None, True),
        (22, 16, True, 5, 12, True, False, 10_000, SPLIT22, True),
        (33, 32, True, 6, 6, True, True, 10_000, SPLIT33, False),
    ],
)
def test_host_stream_run_matches_plain(host_lib, n, cap, robust, window, t,
                                       gate, snapshots, max_calls, geom,
                                       packed):
    b, block, k = 8, 2, 16
    if n > 21:
        b = 4
    cfg, state, tr, tr_len, n_seg = _setup(n, cap, robust, b, t, seed=7,
                                           snapshots=snapshots,
                                           window=window, geom=geom,
                                           packed=packed)
    kw = dict(block=block, k=k, window=window, n_seg=n_seg,
              max_calls=max_calls, gate=gate, snapshots=snapshots,
              packed=packed)
    want, want_status = stream_run_plain(cfg, state, tr, tr_len, **kw)
    host = {f: v.clone() for f, v in state.items()}
    status = torch.full((1, b), -1, dtype=torch.int32)
    args = kernels._kernel_args(cfg, host, tr, tr_len, status, **kw)
    host_lib.hpa2_host_stream_run(ctypes.byref(args))
    for f in fields_of(cfg, snapshots, packed):
        assert torch.equal(host[f], want[f]), f"plane {f!r}"
    assert torch.equal(status, want_status)
    if robust:
        assert not status.any()
        assert int(host["scalars"][1].sum()) == int(tr_len.sum())
    else:
        assert status.any()


@pytest.mark.parametrize(
    "n,cap,robust,window,t,gate,snapshots,geom,packed",
    [
        (4, 16, True, 24, 24, True, True, None, False),
        (4, 16, True, 24, 24, False, True, None, False),
        (8, 16, True, 7, 20, False, False, None, False),
        (8, 4, True, 8, 24, True, False, None, False),   # backpressure
        (4, 16, False, 12, 12, True, True, None, False),  # drop semantics
        (8, 16, True, 8, 16, True, False, None, True),
        (22, 16, True, 5, 10, True, True, SPLIT22, False),
        (33, 32, True, 6, 6, False, False, SPLIT33, True),
    ],
)
def test_host_call_matches_plain(host_lib, n, cap, robust, window, t, gate,
                                 snapshots, geom, packed):
    """Calls of the per-call kernel in every window, with the host loop's
    pc clear at each window base, against ``call_plain``."""
    b, block, k = 8, 2, 12
    if n > 21:
        b = 4
    cfg, state, tr, tr_len, n_seg = _setup(n, cap, robust, b, t, seed=n + 3,
                                           snapshots=snapshots,
                                           window=window, geom=geom,
                                           packed=packed)
    fields = fields_of(cfg, snapshots, packed)
    slsc = _scalar_layout(cfg, window)
    pc_clear = ~(slsc["pc_mask"] << slsc["off_pc"])
    host = {f: v.clone() for f, v in state.items()}
    want = {f: v.clone() for f, v in state.items()}
    kw = dict(block=block, k=k, window=window, gate=gate,
              snapshots=snapshots, packed=packed)
    for seg in range(n_seg):
        host["nsw"].bitwise_and_(pc_clear)
        want["nsw"].bitwise_and_(pc_clear)
        args = kernels._kernel_args(cfg, host, tr, tr_len, None, n_seg=n_seg,
                                    max_calls=0, seg=seg, **kw)
        for call in range(3):
            want.update(call_plain(cfg, want, tr, tr_len, seg=seg, **kw))
            host_lib.hpa2_host_call_run(ctypes.byref(args))
            for f in fields:
                assert torch.equal(host[f], want[f]), \
                    f"window {seg}, call {call}, plane {f!r}"
    assert int(host["scalars"][1].sum()) > 0
