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
planes.  Each lane block runs as the card runs it: a cluster of CTAs,
each system spread over ``kernels.threads_per_system`` threads, phase by
phase; small ``max_group`` values split small blocks over several CTAs
and rounds."""

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
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

# the same MAXN dispatch as csrc/stream_run.cu; each lane block runs on
# a host team (every CTA and thread of its cluster, phase by phase)
SHIM = r"""
#include "cycle.cuh"
// what: 0 one cycle of every lane, 1 the streamed run, 2 one call
template <int MAXN, bool PACKED> void run_as(const hpa2::Args* a, int seg, int what) {
  for (int blk = 0; blk < a->b / a->bb; ++blk) {
    hpa2::HostTeam<MAXN> tm(*a, blk);
    if (what == 0) hpa2::cycle_block<MAXN, PACKED>(*a, tm, seg);
    else if (what == 1) hpa2::stream_block<MAXN, PACKED>(*a, tm);
    else hpa2::call_block<MAXN, PACKED>(*a, tm);
  }
}
template <int MAXN> void run(const hpa2::Args* a, int seg, int what) {
  a->packed ? run_as<MAXN, true>(a, seg, what) : run_as<MAXN, false>(a, seg, what);
}
int dispatch(const hpa2::Args* a, int seg, int what) {
  const int bound = hpa2::node_bound(*a);
  if (bound == 8) run<8>(a, seg, what);
  else if (bound == 21) run<21>(a, seg, what);
  else if (bound == 64) run<64>(a, seg, what);
  return bound == 0;  // refused, as the launch would be
}
extern "C" int hpa2_args_size() { return (int)sizeof(hpa2::Args); }
extern "C" int hpa2_host_cycle(const hpa2::Args* a, int seg) {
  return dispatch(a, seg, 0);
}
extern "C" int hpa2_host_stream_run(const hpa2::Args* a) {
  return dispatch(a, 0, 1);
}
extern "C" int hpa2_host_call_run(const hpa2::Args* a) {
  return dispatch(a, a->seg, 2);
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
        assert host_lib.hpa2_host_cycle(ctypes.byref(args), 0) == 0
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
    assert host_lib.hpa2_host_stream_run(ctypes.byref(args)) == 0
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
            assert host_lib.hpa2_host_call_run(ctypes.byref(args)) == 0
            for f in fields:
                assert torch.equal(host[f], want[f]), \
                    f"window {seg}, call {call}, plane {f!r}"
    assert int(host["scalars"][1].sum()) > 0


def test_launch_geometry_covers_every_block():
    """Every block size the card takes (up to ``MAX_LANE_BLOCK`` at the
    node bound of ``threads`` threads a system) gets at most 16 CTAs,
    none empty, whose rounds of at most ``max_group`` systems cover the
    block; the largest is one cluster of 16 full CTAs."""
    for bound, threads in ((8, 2), (21, 8), (64, 16)):
        most = kernels.MAX_LANE_BLOCK[bound]
        rounds = most // (kernels.MAX_CLUSTER * (kernels.MAX_CTA // threads))
        assert kernels.launch_geometry(most, threads) == (
            kernels.MAX_CLUSTER, most // kernels.MAX_CLUSTER, rounds,
            kernels.MAX_CTA // threads)
        for max_group in (1, 2, 3, 7, None):
            for block in range(1, most + 1):
                cl, per_cta, rounds, group = kernels.launch_geometry(
                    block, threads, max_group)
                assert 1 <= cl <= kernels.MAX_CLUSTER, (block, max_group)
                assert 1 <= group * threads <= kernels.MAX_CTA
                assert group <= (max_group or group)
                assert cl * per_cta >= block > (cl - 1) * per_cta
                assert rounds * group >= per_cta > (rounds - 1) * group
    assert kernels.launch_geometry(512, 8) == (8, 64, 1, 64)
    assert kernels.launch_geometry(1024, 8) == (16, 64, 1, 64)
    assert kernels.launch_geometry(512, 2) == (2, 256, 1, 256)
    assert kernels.launch_geometry(512, 16) == (16, 32, 1, 32)
    assert kernels.launch_geometry(1024, 16) == (16, 64, 2, 32)


def test_host_refuses_a_bad_geometry(host_lib):
    cfg, state, tr, tr_len, n_seg = _setup(8, 16, True, 16, 8, seed=1,
                                           snapshots=False, window=8)
    args = kernels._kernel_args(
        cfg, state, tr, tr_len, torch.zeros((1, 16), dtype=torch.int32),
        block=16, k=8, window=8, n_seg=n_seg, max_calls=4, gate=True,
        snapshots=False)
    args.cl = kernels.MAX_CLUSTER + 1
    assert host_lib.hpa2_host_stream_run(ctypes.byref(args)) == 1


#: (num_procs, cache_size, mem_size) of a system on the 21-node bound
MID12 = (12, 4, 8)


@pytest.mark.parametrize(
    "n,geom,packed,what,block,max_group,snapshots,cap,max_calls",
    [
        # a block over 4 CTAs of 2 systems; CTA 0 idle from the start
        (8, None, False, "stream", 8, 2, True, 16, 10_000),
        (8, None, True, "call", 8, 3, True, 16, 0),
        # two rounds a CTA (20 systems on 7 CTAs of 3, rounds of 2)
        (8, None, False, "stream", 20, 2, False, 16, 10_000),
        # a lane block above 1,024: 16 CTAs of 80 systems, 5 rounds each
        (8, None, False, "stream", 1280, 16, False, 16, 10_000),
        (12, MID12, False, "stream", 6, 2, True, 16, 10_000),
        (12, MID12, True, "call", 6, 1, False, 16, 0),
        (64, SPLIT64, False, "stream", 4, 1, True, 16, 10_000),
        (64, SPLIT64, True, "call", 4, 2, True, 16, 0),
        # mailboxes longer than 32 slots settle cycle by cycle
        (8, None, False, "call", 8, 2, False, 48, 0),
        # 4 mailbox slots and a short budget: blocks stall
        (8, None, False, "stream", 8, 2, False, 4, 2),
        (8, None, True, "stream", 8, 1, True, 4, 3),
    ],
)
def test_host_team_matches_plain(host_lib, n, geom, packed, what, block,
                                 max_group, snapshots, cap, max_calls):
    """Lane blocks split over several CTAs (and rounds) of the card's
    layout against the plain versions.  In every other block the first
    CTA's systems are idle from the start (``tr_len`` 0): they run only
    because their block's gate is open, and with snapshots on their
    first cycle takes their snapshots (phase D); ragged windows (the
    last window ends early).  Planes and (streamed) the stall plane."""
    b, t, window, k = 2 * block, (6 if n > 21 else 12), 5, 16
    cfg, state, tr, tr_len, n_seg = _setup(n, cap, True, b, t, seed=n + b,
                                           snapshots=snapshots,
                                           window=window, geom=geom,
                                           packed=packed)
    per_cta = kernels.launch_geometry(
        block, kernels.threads_per_system(cfg), max_group)[1]
    assert per_cta < block  # the block spans several CTAs
    # block 0's first CTA idle; with the short budget, all of block 0
    idle = block if cap == 4 else per_cta
    tr_len[:, :idle] = 0
    fields = fields_of(cfg, snapshots, packed)
    host = {f: v.clone() for f, v in state.items()}
    if what == "stream":
        kw = dict(block=block, k=k, window=window, n_seg=n_seg,
                  max_calls=max_calls, gate=True, snapshots=snapshots,
                  packed=packed)
        want, want_status = stream_run_plain(cfg, state, tr, tr_len, **kw)
        status = torch.full((1, b), -1, dtype=torch.int32)
        args = kernels._kernel_args(cfg, host, tr, tr_len, status,
                                    max_group=max_group, **kw)
        assert host_lib.hpa2_host_stream_run(ctypes.byref(args)) == 0
        assert torch.equal(status, want_status)
        if cap == 4:  # the budget runs out on the busy block only
            assert status[0, block:].all() and not status[0, :block].any()
        else:
            assert not status.any()
    else:
        slsc = _scalar_layout(cfg, window)
        pc_clear = ~(slsc["pc_mask"] << slsc["off_pc"])
        want = {f: v.clone() for f, v in state.items()}
        kw = dict(block=block, k=k, window=window, gate=True,
                  snapshots=snapshots, packed=packed)
        for seg in range(n_seg):
            host["nsw"].bitwise_and_(pc_clear)
            want["nsw"].bitwise_and_(pc_clear)
            want.update(call_plain(cfg, want, tr, tr_len, seg=seg, **kw))
            args = kernels._kernel_args(cfg, host, tr, tr_len, None,
                                        n_seg=n_seg, max_calls=0, seg=seg,
                                        max_group=max_group, **kw)
            assert host_lib.hpa2_host_call_run(ctypes.byref(args)) == 0
    for f in fields:
        assert torch.equal(host[f], want[f]), f"plane {f!r}"
    if snapshots:  # idle systems snapshot iff their block's gate opened
        assert bool(host["snap_taken"][:, :per_cta].all()) == (cap != 4)
    assert int(host["scalars"][0, :per_cta].sum()) == 0
    assert int(host["scalars"][1].sum()) > 0
