"""K1's ablation variant on the port: the plain ablated cycle against the
JAX package's, and the kernel's own ablatable code against the plain
version.

An ablated cycle (``build_cycle(ablate=)``, ``pallas_engine.py:545-547``)
stubs out named stages to attribute a cycle's time on the card: it is
wrong by design, never quiesces, and ends at its call budget with
``StallError``.  It is still deterministic, so:

* ``CudaEngine(device="cpu", _ablate=...)`` (the plain versions) equals
  the interpreted ``PallasEngine(_ablate=...)`` in every carried plane
  after both raise, streamed and per-call, for each single stage and
  for all three, at 4 nodes, and for one set at 22 nodes (split planes);
  so does ``packed=True`` (u8/u16 cache and directory planes) at 8 and
  22 nodes;
* the host build of ``csrc/cycle.cuh``'s ablatable path (``ABL`` true,
  the stubs picked by ``Args::ablate``) equals the plain ablated version
  at node bounds 8, 21 and 64 for every single stage, streamed and per
  call, with int32 and with packed planes;
* an unknown stage raises, and the default instantiations are not the
  ablation libraries."""

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from hpa2_tpu.utils.trace import gen_uniform_random_arrays as jgen
from hpa2_tpu_torch.convert import state_from_numpy, state_to_numpy
from hpa2_tpu_torch.ops import kernels
from hpa2_tpu_torch.ops.call_run import call_plain
from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
from hpa2_tpu_torch.ops.cycle import (
    ABLATE_STAGES, ablate_mask, ablate_set, build_cycle,
)
from hpa2_tpu_torch.ops.layout import (
    StallError, _init_state, _pack_traces, _scalar_layout, fields_of,
)
from hpa2_tpu_torch.ops.stream_run import stream_run_plain
from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays
from torch_pairs import IGNORE_PLTPU_ANY, config_pair, run_both
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings(IGNORE_PLTPU_ANY)

SETS = [frozenset({"phase_a"}), frozenset({"phase_b"}),
        frozenset({"deliver"}), frozenset(ABLATE_STAGES)]


def _ids(x):
    return "+".join(sorted(x)) if isinstance(x, frozenset) else str(x)


@pytest.mark.parametrize("stream", [True, False], ids=["stream", "call"])
@pytest.mark.parametrize("ablate", SETS, ids=_ids)
def test_ablated_plain_equals_interpreted_pallas(ablate, stream):
    """4 nodes x 8 systems x 16 instructions, ``max_cycles=32``: both
    engines stall with the same message and every carried plane agrees
    bit for bit."""
    jcfg, tcfg = config_pair(True, num_procs=4, msg_buffer_size=16)
    arrays = jgen(jcfg, 8, 16, seed=11)
    _, ce, stall = run_both(jcfg, tcfg, arrays, max_cycles=32,
                            stream=stream, block=8, cycles_per_call=8,
                            snapshots=False, _ablate=ablate)
    assert stall is not None  # an ablated run never quiesces
    if "phase_b" in ablate:
        assert int(ce.state["scalars"][1].sum()) == 0  # nothing issued
    else:
        assert int(ce.state["scalars"][1].sum()) > 0
    if "deliver" in ablate:
        assert int(ce.state["scalars"][2].sum()) == 0  # nothing delivered
        assert not any(ce.state[f].any() for f in ce.state
                       if f.startswith("ob") and f != "ob_recv")


def test_ablated_plain_equals_interpreted_pallas_split():
    """22 nodes (the split sharer planes of the 64-node bound): phase A
    stubbed, so the heads that phase B's sends fill are popped
    unhandled."""
    jcfg, tcfg = config_pair(True, num_procs=22, cache_size=2, mem_size=4,
                             msg_buffer_size=16)
    arrays = jgen(jcfg, 4, 8, seed=5)
    _, ce, stall = run_both(jcfg, tcfg, arrays, max_cycles=16, block=4,
                            cycles_per_call=8, snapshots=False,
                            _ablate=frozenset({"phase_a"}))
    assert stall is not None
    assert int(ce.state["scalars"][2].sum()) > 0  # messages were sent


@pytest.mark.parametrize("stream", [True, False], ids=["stream", "call"])
@pytest.mark.parametrize("ablate", SETS, ids=_ids)
def test_packed_ablated_plain_equals_interpreted_pallas(ablate, stream):
    """Packed planes, 8 nodes x 8 systems x 12 instructions,
    ``max_cycles=24``: the packed ablated cycle (widen, the stubbed
    int32 cycle, narrow) equals the interpreted packed JAX kernel's in
    every carried plane, and stalls alike."""
    jcfg, tcfg = config_pair(True, num_procs=8, msg_buffer_size=16)
    arrays = jgen(jcfg, 8, 12, seed=13)
    _, ce, stall = run_both(jcfg, tcfg, arrays, max_cycles=24,
                            stream=stream, block=8, cycles_per_call=8,
                            snapshots=False, packed=True, _ablate=ablate)
    assert stall is not None
    assert "cvalw" in ce.state and "cachew" not in ce.state
    assert (int(ce.state["scalars"][1].sum()) == 0) == ("phase_b" in ablate)


@pytest.mark.parametrize("stream", [True, False], ids=["stream", "call"])
def test_packed_ablated_plain_equals_interpreted_pallas_split(stream):
    """Packed planes at 22 nodes (split sharer planes): delivery
    stubbed, so every send vanishes."""
    jcfg, tcfg = config_pair(True, num_procs=22, cache_size=2, mem_size=4,
                             msg_buffer_size=16)
    arrays = jgen(jcfg, 4, 8, seed=6)
    _, ce, stall = run_both(jcfg, tcfg, arrays, max_cycles=16,
                            stream=stream, block=4, cycles_per_call=8,
                            snapshots=False, packed=True,
                            _ablate=frozenset({"deliver"}))
    assert stall is not None
    assert "dirs0" in ce.state and "dmemw" in ce.state
    assert int(ce.state["scalars"][2].sum()) == 0


def test_ablated_run_is_deterministic():
    """Two ablated runs give the same planes, and the ablated planes
    differ from the default run's."""
    _, tcfg = config_pair(True, num_procs=4, msg_buffer_size=16)
    arrays = gen_uniform_random_arrays(tcfg, 8, 16, seed=3)
    planes = []
    for ablate in (frozenset({"phase_a"}), frozenset({"phase_a"}),
                   frozenset()):
        eng = CudaEngine(tcfg, *arrays, device="cpu", block=8,
                         cycles_per_call=8, snapshots=False,
                         _ablate=ablate)
        if ablate:
            with pytest.raises(StallError):
                eng.run(max_cycles=32)
        else:
            eng.run()
        planes.append(state_to_numpy(eng.state))
    for f in planes[0]:
        np.testing.assert_array_equal(planes[0][f], planes[1][f], f)
    assert any(not np.array_equal(planes[0][f], planes[2][f])
               for f in planes[0])


def test_unknown_stage_raises():
    _, tcfg = config_pair(True, num_procs=4, msg_buffer_size=16)
    arrays = gen_uniform_random_arrays(tcfg, 2, 4, seed=0)
    for bad in ({"phase_c"}, {"deliver", "handlers"}):
        with pytest.raises(ValueError, match="phase_a, phase_b, deliver"):
            CudaEngine(tcfg, *arrays, device="cpu", _ablate=frozenset(bad))
        with pytest.raises(ValueError, match="unknown ablation stage"):
            build_cycle(tcfg, False, False, frozenset(bad))
    assert ablate_mask({"phase_a", "deliver"}) == 5
    assert ablate_set(["phase_b"]) == frozenset({"phase_b"})


def test_ablation_libraries_stay_off_the_main_path():
    assert not set(kernels.ABLATE_KERNELS) & set(kernels.KERNELS)
    assert set(kernels.ABLATE_KERNELS) <= set(kernels.LIBRARIES)
    for kern, base in zip(kernels.ABLATE_KERNELS, kernels.KERNELS):
        assert kern.library_path() != base.library_path()
        assert kern.entry == base.entry + "_ablate"
        assert kern._defines == ("-DHPA2_ABLATE",)
        assert kernels._ablation_kernel(base, frozenset({"deliver"})) \
            is kern
        assert kernels._ablation_kernel(base, frozenset()) is base


# the ablatable instantiations of csrc/stream_run.cu and call_run.cu
# (ABL true, int32 or packed planes), run on host teams as the card runs a
# lane block
SHIM = r"""
#include "cycle.cuh"
template <int MAXN, bool PACKED> void run_as(const hpa2::Args* a, int what) {
  for (int blk = 0; blk < a->b / a->bb; ++blk) {
    hpa2::HostTeam<MAXN> tm(*a, blk);
    if (what == 1) hpa2::stream_block<MAXN, PACKED, true>(*a, tm);
    else hpa2::call_block<MAXN, PACKED, true>(*a, tm);
  }
}
template <int MAXN> void run_as(const hpa2::Args* a, int what) {
  if (a->packed) run_as<MAXN, true>(a, what);
  else run_as<MAXN, false>(a, what);
}
int dispatch(const hpa2::Args* a, int what) {
  const int bound = hpa2::node_bound(*a);
  if (bound == 0) return 1;
  if (bound == 8) run_as<8>(a, what);
  else if (bound == 21) run_as<21>(a, what);
  else run_as<64>(a, what);
  return 0;
}
extern "C" int hpa2_args_size() { return (int)sizeof(hpa2::Args); }
extern "C" int hpa2_host_stream_run_ablate(const hpa2::Args* a) {
  return dispatch(a, 1);
}
extern "C" int hpa2_host_call_run_ablate(const hpa2::Args* a) {
  return dispatch(a, 2);
}
"""


@pytest.fixture(scope="module")
def ablate_lib():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    h = hashlib.sha256(SHIM.encode())
    h.update((kernels.CSRC_DIR / "cycle.cuh").read_bytes())
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = kernels.BUILD_DIR / f"host_ablate_{h.hexdigest()[:16]}.so"
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
    for fn in (lib.hpa2_host_stream_run_ablate, lib.hpa2_host_call_run_ablate):
        fn.argtypes = [ctypes.POINTER(kernels.Args)]
    assert lib.hpa2_args_size() == ctypes.sizeof(kernels.Args)
    return lib


#: (num_procs, cache_size, mem_size) at each node bound
BOUNDS = {8: (8, 4, 16), 21: (12, 4, 8), 64: (33, 4, 8)}


def host_vs_plain(lib, bound, stage, what, packed):
    """A lane block over two CTAs (``max_group``), two windows, a budget
    of two calls: the host-built ablatable kernel and the plain ablated
    version give the same planes (and, streamed, the same stall plane,
    every block stalled).  Phase A alone starts from planes a default run
    has filled, so that its mailboxes hold messages to pop."""
    n, c, m = BOUNDS[bound]
    _, cfg = config_pair(True, num_procs=n, cache_size=c, mem_size=m,
                         msg_buffer_size=16)
    b, block, t, window, k = 4, 2, 6, 3, 8
    op, addr, val, length = gen_uniform_random_arrays(cfg, b, t, seed=bound)
    n_seg = t // window
    tr = torch.from_numpy(_pack_traces(cfg, op, addr, val, length))
    tr_len = torch.from_numpy(np.ascontiguousarray(length.T))
    state = state_from_numpy(_init_state(cfg, b, False, packed), "cpu")
    fields = fields_of(cfg, False, packed)
    ablate = frozenset({stage})
    if stage == "phase_a":  # a few default cycles fill the mailboxes
        state = dict(stream_run_plain(
            cfg, state, tr, tr_len, block=block, k=4, window=window,
            n_seg=1, max_calls=1, gate=False, snapshots=False,
            packed=packed)[0])
        assert int((state["nsw"] & 0xFF).sum()) > 0
    host = {f: v.clone() for f, v in state.items()}
    max_group = 1
    if what == "stream":
        kw = dict(block=block, k=k, window=window, n_seg=n_seg,
                  max_calls=2, gate=True, snapshots=False, packed=packed)
        want, want_status = stream_run_plain(cfg, state, tr, tr_len,
                                             ablate=ablate, **kw)
        status = torch.full((1, b), -1, dtype=torch.int32)
        args = kernels._kernel_args(cfg, host, tr, tr_len, status,
                                    max_group=max_group, **kw)
        args.ablate = ablate_mask(ablate)
        assert lib.hpa2_host_stream_run_ablate(ctypes.byref(args)) == 0
        assert torch.equal(status, want_status)
        assert bool(status.all())
    else:
        slsc = _scalar_layout(cfg, window)
        pc_clear = ~(slsc["pc_mask"] << slsc["off_pc"])
        want = {f: v.clone() for f, v in state.items()}
        kw = dict(block=block, k=k, window=window, gate=True,
                  snapshots=False, packed=packed)
        for seg in range(n_seg):
            host["nsw"].bitwise_and_(pc_clear)
            want["nsw"].bitwise_and_(pc_clear)
            want.update(call_plain(cfg, want, tr, tr_len, seg=seg,
                                   ablate=ablate, **kw))
            args = kernels._kernel_args(cfg, host, tr, tr_len, None,
                                        n_seg=n_seg, max_calls=0, seg=seg,
                                        max_group=max_group, **kw)
            args.ablate = ablate_mask(ablate)
            assert lib.hpa2_host_call_run_ablate(ctypes.byref(args)) == 0
    for f in fields:
        assert torch.equal(host[f], want[f]), f"plane {f!r}"
    assert int(host["scalars"][0].sum()) > 0  # cycles ran


@pytest.mark.parametrize("what", ["stream", "call"])
@pytest.mark.parametrize("stage", list(ABLATE_STAGES))
@pytest.mark.parametrize("bound", list(BOUNDS))
def test_host_ablate_matches_plain(ablate_lib, bound, stage, what):
    """int32 planes (:func:`host_vs_plain`)."""
    host_vs_plain(ablate_lib, bound, stage, what, packed=False)


@pytest.mark.parametrize("what", ["stream", "call"])
@pytest.mark.parametrize("stage", list(ABLATE_STAGES))
@pytest.mark.parametrize("bound", list(BOUNDS))
def test_host_ablate_packed_matches_plain(ablate_lib, bound, stage, what):
    """Packed planes (u8 values, u8/u16 metadata; split sharer words at
    bound 64): the ``PACKED`` ablatable instantiations
    (:func:`host_vs_plain`)."""
    host_vs_plain(ablate_lib, bound, stage, what, packed=True)


def test_host_ablate_refuses_packed(ablate_lib):
    """The ablatable entries refuse a packed launch the kernel cannot
    take, as the default ones do: a lane block that does not divide the
    lanes."""
    _, cfg = config_pair(True, num_procs=4, msg_buffer_size=16)
    op, addr, val, length = gen_uniform_random_arrays(cfg, 2, 4, seed=1)
    tr = torch.from_numpy(_pack_traces(cfg, op, addr, val, length))
    tr_len = torch.from_numpy(np.ascontiguousarray(length.T))
    state = state_from_numpy(_init_state(cfg, 2, False, True), "cpu")
    args = kernels._kernel_args(
        cfg, state, tr, tr_len, torch.zeros((1, 2), dtype=torch.int32),
        block=2, k=8, window=4, n_seg=1, max_calls=1, gate=True,
        snapshots=False, packed=True)
    args.ablate = ablate_mask({"deliver"})
    args.bb = 3
    assert ablate_lib.hpa2_host_stream_run_ablate(ctypes.byref(args)) == 1
    assert ablate_lib.hpa2_host_call_run_ablate(ctypes.byref(args)) == 1
