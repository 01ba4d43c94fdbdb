"""The port's state layout, trace packing, dump decoding, trace
generation and dump text against the JAX package's, at node counts
1, 4, 8 and 21, mailbox depths 4, 16 and 256 and several windows."""

import numpy as np
import pytest

from hpa2_tpu.ops import pallas_engine as jpe
from hpa2_tpu.utils import dump as jdump
from hpa2_tpu.utils import trace as jtrace
from hpa2_tpu_torch.convert import state_from_numpy
from hpa2_tpu_torch.ops import layout
from hpa2_tpu_torch.utils import dump, trace
from torch_pairs import config_pair
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

GEOMETRIES = [(n, cap) for n in (1, 4, 8, 21) for cap in (4, 16, 256)]


@pytest.mark.parametrize("n,cap", GEOMETRIES)
def test_layouts_and_initial_state(n, cap):
    jcfg, tcfg = config_pair(True, num_procs=n, msg_buffer_size=cap)
    assert layout._mb_layout(tcfg) == jpe._mb_layout(jcfg)
    for snapshots in (False, True):
        assert layout.state_shapes(tcfg, snapshots) == jpe.state_shapes(
            jcfg, snapshots)
        assert layout.state_dtypes(tcfg, snapshots) == jpe.state_dtypes(
            jcfg, snapshots)
        got = layout._init_state(tcfg, 3, snapshots)
        want = jpe._init_state(jcfg, 3, snapshots)
        assert set(got) == set(want)
        for f in want:
            assert got[f].dtype == want[f].dtype
            np.testing.assert_array_equal(got[f], want[f], err_msg=f)
        W = layout._mb_layout(tcfg)[1]
        recv = "recv" in layout._mb_layout(tcfg)[0]
        assert layout._state_fields(W, snapshots, recv) == jpe._state_fields(
            W, snapshots, recv)
    for window in (1, 7, 32, 128, 1000, 1 << 20):
        try:
            want = jpe._scalar_layout(jcfg, window)
        except ValueError:
            with pytest.raises(ValueError, match="trace_window"):
                layout._scalar_layout(tcfg, window)
            continue
        assert layout._scalar_layout(tcfg, window) == want


@pytest.mark.parametrize("n,cap", [(4, 16), (8, 4), (21, 256)])
def test_deferred_valid_matches(n, cap):
    jcfg, tcfg = config_pair(True, num_procs=n, msg_buffer_size=cap)
    lay, W = jpe._mb_layout(jcfg)
    rng = np.random.default_rng(n)
    st = {f"ob{w}": rng.integers(0, 1 << 31, (n, 5, 6), dtype=np.int32)
          for w in range(W)}
    if "recv" not in lay:
        st["ob_recv"] = rng.integers(-1, n, (n, 5, 6), dtype=np.int32)
    got = layout.deferred_valid(tcfg, state_from_numpy(st, "cpu"))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jpe.deferred_valid(jcfg, st)))


@pytest.mark.parametrize("n,t", [(1, 5), (4, 32), (8, 20), (21, 9)])
def test_trace_generation_and_packing(n, t):
    jcfg, tcfg = config_pair(True, num_procs=n, msg_buffer_size=16)
    got = trace.gen_uniform_random_arrays(tcfg, 5, t, seed=n + t)
    want = jtrace.gen_uniform_random_arrays(jcfg, 5, t, seed=n + t)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    op, addr, val, length = got
    length = length.copy()
    length[0, 0] = t // 2        # ragged: padding must be zero
    np.testing.assert_array_equal(
        layout._pack_traces(tcfg, op, addr, val, length),
        jpe._pack_traces(jcfg, op, addr, val, length))
    bad = addr.copy()
    bad[0, 0, 0] = tcfg.num_addresses
    with pytest.raises(ValueError, match="out of range"):
        layout._pack_traces(tcfg, op, bad, val, length)


@pytest.mark.parametrize("n,m", [(4, 16), (8, 16), (21, 4)])
def test_decode_and_format_dumps(n, m):
    jcfg, tcfg = config_pair(True, num_procs=n, mem_size=m, cache_size=4)
    rng = np.random.default_rng(n)
    b, c = 3, 4
    na = tcfg.num_addresses
    cachew = (rng.integers(0, 4, (n, c, b))
              | rng.integers(0, 256, (n, c, b)) << layout._CW_VAL_SHIFT
              | rng.integers(0, na + 1, (n, c, b)) << layout._CW_ADDR_SHIFT
              ).astype(np.int32)
    dirw = (rng.integers(0, 256, (n, m, b))
            | rng.integers(0, 3, (n, m, b)) << layout._DW_STATE_SHIFT
            | rng.integers(0, 1 << n, (n, m, b)) << layout._DW_SH_SHIFT
            ).astype(np.int32)
    for s in range(b):
        got = layout.decode_dumps(tcfg, cachew, dirw, s)
        want = jpe.decode_dumps(jcfg, cachew, dirw, s)
        assert [d.__dict__ for d in got] == [d.__dict__ for d in want]
        for g, w in zip(got, want):
            text = dump.format_processor_state(g, tcfg)
            assert text == jdump.format_processor_state(w, jcfg)
            if tcfg.parity_compatible:
                back = dump.parse_processor_dump(text)
                assert back.__dict__ == jdump.parse_processor_dump(
                    text).__dict__
                assert back.memory == g.memory
                assert back.cache_addr == g.cache_addr


def test_trace_dir_parsing(tmp_path):
    jcfg, tcfg = config_pair(False)
    lines = ["RD 0x1F", "", "WR 3c 300", "rd 0x01"]
    (tmp_path / "core_0.txt").write_text("\n".join(lines[:3]) + "\n")
    for i in (1, 2, 3):
        (tmp_path / f"core_{i}.txt").write_text(f"WR 0x{i:02X} {i}\n")
    got = trace.load_trace_dir(str(tmp_path), tcfg)
    want = jtrace.load_trace_dir(str(tmp_path), jcfg)
    assert [[(i.op, i.address, i.value) for i in tr] for tr in got] == [
        [(i.op, i.address, i.value) for i in tr] for tr in want]
    assert got[0][1].value == 300 % 256
    for mod in (trace, jtrace):
        with pytest.raises(ValueError, match="malformed"):
            mod.parse_core_trace("\n".join(lines))
    a_got = trace.traces_to_arrays(tcfg, [got, got])
    a_want = jtrace.traces_to_arrays(jcfg, [want, want])
    for g, w in zip(a_got, a_want):
        np.testing.assert_array_equal(g, w)
