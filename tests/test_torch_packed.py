"""Packed planes (``packed=True``: ``cachew`` stored as ``cvalw`` u8 +
``cmetaw`` u8/u16, ``dirw`` as ``dmemw`` u8 + ``dmetaw`` u8/u16) on the
port's engine on the CPU, which runs the kernel's plain version,
against ``hpa2_tpu.ops.pallas_engine.PallasEngine`` with ``stream=True``
and ``packed=True`` in the Pallas interpreter, and against the port's
own unpacked run.

Every carried plane (with its narrow type), the stall status, the
counters and the dumps must agree bit for bit."""

import numpy as np
import pytest

from hpa2_tpu.ops import pallas_engine as jpe
from hpa2_tpu.utils.trace import gen_uniform_random_arrays
from hpa2_tpu_torch.convert import state_from_numpy, state_to_numpy
from hpa2_tpu_torch.ops import layout
from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
from torch_pairs import IGNORE_PLTPU_ANY, config_pair, dicts, run_both
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

pytestmark = pytest.mark.filterwarnings(IGNORE_PLTPU_ANY)

#: (num_procs, cache_size, mem_size, msg_buffer_size) -> cmetaw, dmetaw
GEOMETRIES = [
    ((4, 2, 8, 16), (np.uint8, np.uint8)),      # 32 addresses
    ((4, 4, 16, 16), (np.uint16, np.uint8)),
    ((8, 4, 16, 16), (np.uint16, np.uint16)),   # 8 sharer bits
    ((14, 2, 4, 16), (np.uint8, np.uint16)),
    ((22, 2, 4, 16), (np.uint16, np.uint8)),    # split: state-only meta
    ((64, 2, 4, 16), (np.uint16, np.uint8)),
]


@pytest.mark.parametrize("geom,meta", GEOMETRIES)
def test_packed_layout_matches(geom, meta):
    n, c, m, cap = geom
    jcfg, tcfg = config_pair(True, num_procs=n, cache_size=c, mem_size=m,
                             msg_buffer_size=cap)
    dt = layout.packed_plane_dtypes(tcfg)
    assert dt == jpe.packed_plane_dtypes(jcfg)
    assert (dt["cmetaw"], dt["dmetaw"]) == tuple(map(np.dtype, meta))
    for snapshots in (False, True):
        assert layout.state_shapes(tcfg, snapshots, True) == \
            jpe.state_shapes(jcfg, snapshots, True)
        assert layout.state_dtypes(tcfg, snapshots, True) == \
            jpe.state_dtypes(jcfg, snapshots, True)
        assert layout.fields_of(tcfg, snapshots, True) == jpe._state_fields(
            jpe._mb_layout(jcfg)[1], snapshots,
            "recv" in jpe._mb_layout(jcfg)[0],
            jpe._sharer_words(jcfg) if jpe._split_mode(jcfg) else 0, True)
        got = layout._init_state(tcfg, 2, snapshots, packed=True)
        want = jpe._init_state(jcfg, 2, snapshots, packed=True)
        assert set(got) == set(want)
        for f in want:
            assert got[f].dtype == want[f].dtype, f
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        back = state_to_numpy(state_from_numpy(got, "cpu"))
        assert {f: v.dtype for f, v in back.items()} == \
            {f: v.dtype for f, v in got.items()}


def test_split_join_roundtrip_matches():
    jcfg, tcfg = config_pair(True, num_procs=4)
    rng = np.random.default_rng(0)
    c, m = tcfg.cache_size, tcfg.mem_size
    cachew = (rng.integers(0, 4, (4, c, 16))
              | (rng.integers(0, 256, (4, c, 16)) << 2)
              | (rng.integers(0, tcfg.num_addresses + 1, (4, c, 16)) << 10)
              ).astype(np.int32)
    dirw = (rng.integers(0, 256, (4, m, 16))
            | (rng.integers(0, 4, (4, m, 16)) << 8)
            | (rng.integers(0, 1 << 4, (4, m, 16)) << 10)).astype(np.int32)
    planes = layout._split_word_planes_np(tcfg, cachew, dirw)
    want = jpe._split_word_planes_np(jcfg, cachew, dirw)
    for f in want:
        assert planes[f].dtype == want[f].dtype
        np.testing.assert_array_equal(planes[f], want[f])
    cw, dw = layout._join_word_planes_np(*(planes[f] for f in (
        "cvalw", "cmetaw", "dmemw", "dmetaw")))
    np.testing.assert_array_equal(cw, cachew)
    np.testing.assert_array_equal(dw, dirw)


def test_unpackable_geometry_refused():
    _, tcfg = config_pair(True, num_procs=4, mem_size=4096)
    arrays = gen_uniform_random_arrays(tcfg, 2, 4, seed=0)
    with pytest.raises(ValueError, match="packed=False"):
        CudaEngine(tcfg, *arrays, block=2, packed=True, device="cpu")


def _same_types(ce, pe):
    for f, v in state_to_numpy(ce.state).items():
        assert v.dtype == np.asarray(pe.state[f]).dtype, f


def _joined_equal(packed, unpacked):
    """The packed engine's planes, joined, equal the unpacked run's."""
    for pre in ("", "snap_") if packed._snapshots else ("",):
        cw, dw = packed._word_planes(pre)
        np.testing.assert_array_equal(cw, unpacked._plane(f"{pre}cachew"))
        np.testing.assert_array_equal(dw, unpacked._plane(f"{pre}dirw"))
    for f, v in unpacked.state.items():
        if not f.endswith(("cachew", "dirw")):
            assert np.array_equal(packed._plane(f), v.numpy()), f


@pytest.mark.parametrize("n,c,m,seed", [(4, 2, 8, 2), (6, 4, 16, 3)])
def test_packed_snapshots_match_pallas(n, c, m, seed):
    jcfg, tcfg = config_pair(True, num_procs=n, cache_size=c, mem_size=m,
                             msg_buffer_size=16)
    arrays = gen_uniform_random_arrays(jcfg, 4, 16, seed=seed)
    kw = dict(block=2, cycles_per_call=32, snapshots=True)
    pe, ce, stall = run_both(jcfg, tcfg, arrays, packed=True, **kw)
    assert stall is None
    _same_types(ce, pe)
    assert ce.stats() == pe.stats()
    un = CudaEngine(tcfg, *arrays, device="cpu", **kw).run()
    _joined_equal(ce, un)
    for b in range(4):
        assert dicts(ce.system_snapshots(b)) == dicts(pe.system_snapshots(b))
        assert dicts(ce.system_snapshots(b)) == dicts(un.system_snapshots(b))
        assert dicts(ce.system_final_dumps(b)) == dicts(
            un.system_final_dumps(b))


def test_packed_windowed_8_nodes_matches_pallas():
    jcfg, tcfg = config_pair(True, num_procs=8, msg_buffer_size=16)
    arrays = gen_uniform_random_arrays(jcfg, 4, 20, seed=5)
    pe, ce, stall = run_both(jcfg, tcfg, arrays, packed=True, block=2,
                             cycles_per_call=32, snapshots=False,
                             trace_window=8)
    assert stall is None
    _same_types(ce, pe)
    assert ce.stats() == pe.stats()
    assert ce.instructions == 4 * 8 * 20


def test_packed_split_22_nodes_matches_pallas():
    """Packed planes on a split-plane system
    (``tests/test_packed_planes.py``'s 22-node case)."""
    jcfg, tcfg = config_pair(True, num_procs=22, cache_size=2, mem_size=4,
                             msg_buffer_size=16)
    arrays = gen_uniform_random_arrays(jcfg, 2, 12, seed=4)
    kw = dict(block=2, cycles_per_call=32, snapshots=False, trace_window=5,
              gate=False)
    pe, ce, stall = run_both(jcfg, tcfg, arrays, max_cycles=400_000,
                             packed=True, **kw)
    assert stall is None
    _same_types(ce, pe)
    un = CudaEngine(tcfg, *arrays, device="cpu", **kw).run(400_000)
    _joined_equal(ce, un)
    for b in range(2):
        assert dicts(ce.system_final_dumps(b)) == dicts(
            un.system_final_dumps(b))
        assert dicts(ce.system_final_dumps(b)) == dicts(
            pe.system_final_dumps(b))
