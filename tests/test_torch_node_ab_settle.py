"""N1 (``node_ab``: gather, protocol, write) and N4 (``node_settle``:
gather, settle, snapshot rows and lane rows) on the CPU: their phase
bodies (``csrc/node_cycle.cuh``: ``n1_phase``, ``n4_phase``) built with
g++ and run a CTA at a time, phase by phase over all 256 threads, the
shared tile filled with garbage first (``tests/torch_node_host.py``),
each launch held bit for bit against its plain version
(``node_cycle.ab_plain``, ``settle_plain``) on the same inputs, every
plane of the rank compared.

The inputs are a rank's block of a whole system's planes at sampled
cycles of a plain run (the node cycle's plain stages over one rank,
cycle by cycle), so they hold what real traffic leaves: blocked nodes
with deferred slots, full mailboxes, INV slots, nodes that finish in the
cycle with snapshots on, and nodes busy again after their snapshot.  N4 also takes its acceptance rows with
receivers refusing at random (point slots not accepted, INV receivers
dropped from the accepted set).  Geometries: 8 nodes over 2 ranks, 12
packed, 22 split, 64 over 2 (both ranks), 64 over 4, 16 shards, and 48
mailbox slots; 8 lanes a launch and 5 (N1's 32 lanes a CTA and N4's 4:
N1's clusters of node tiles from one CTA to 8, ragged tiles of lanes and
of node rows).  And a whole node-sharded run
through the host kernels, packed with snapshots on, against the JAX
package's ``NodeShardedPallasEngine``."""

import functools
import itertools
import types

import numpy as np
import pytest
import torch

import torch_node_host
from hpa2_tpu_torch.config import Semantics, SystemConfig
from hpa2_tpu_torch.ops import node_cycle
from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
from hpa2_tpu_torch.ops.layout import _scalar_layout, field
from hpa2_tpu_torch.parallel.sharding import _node_local
from hpa2_tpu_torch.utils.trace import gen_uniform_random_arrays
from torch_pairs import IGNORE_PLTPU_ANY, config_pair
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

I32 = torch.int32
CPU = torch.device("cpu")
LANES = 8                 # lanes of the runs
WIDTHS = (8, 5)           # lanes a launch
SAMPLES = 7               # sampled cycles a run

#: nodes, shards, packed planes, mailbox slots, instructions a core
CASES = {
    "8 nodes over 2": (8, 2, False, 4, 8),
    "12 nodes packed over 2": (12, 2, True, 4, 8),
    "22 nodes split over 2": (22, 2, False, 4, 8),
    "64 nodes over 2": (64, 2, False, 4, 4),
    "64 nodes over 4": (64, 4, False, 4, 4),
    "16 shards": (64, 16, False, 4, 4),
    "48 mailbox slots": (8, 2, False, 48, 16),
}


@pytest.fixture(scope="module")
def host():
    lib = torch_node_host.build()
    if lib is None:
        pytest.skip("g++ is not installed")
    return torch_node_host.HostLauncher(lib)


def _cfg(n, cap):
    return SystemConfig(num_procs=n, msg_buffer_size=cap,
                        semantics=Semantics().robust())


def _cycle(cfg, d, me, packed):
    """The node cycle of rank ``me`` of ``d`` (a stand-in for the node
    group: only its size and rank are read here)."""
    return node_cycle.NodeCycle(cfg, True, packed,
                                types.SimpleNamespace(size=d, rank=me), d)


def _clone(s):
    return {f: v.clone() for f, v in s.items()}


def _features(nc, s, cap):
    """What a whole-system state before N1 holds: a blocked node (a
    deferred slot), a full mailbox."""
    recvs = node_cycle._ob_recvs(nc, s)
    inv = [field(nc.layout, [s[f"ob{w}"][:, 2] for w in range(nc.W)], f)
           for f in node_cycle._sharer_fields(nc)]
    blocked = any(bool((recvs[k] >= 0).any()) for k in (0, 1, 3, 4)) or any(
        bool((x != 0).any()) for x in inv)
    mask = _scalar_layout(nc.config, s["tr"].shape[1])["count_mask"]
    return {"blocked": blocked, "full": bool(((s["nsw"] & mask) == cap).any())}


def _hot_arrays(cfg, t, seed):
    """Traces of ``t`` instructions a core, 30% writes, half of them on
    four hot blocks (so that lines are shared, and written: INV fans)."""
    rng = np.random.default_rng(seed)
    n, m = cfg.num_procs, cfg.mem_size
    shape = (LANES, n, t)
    op = (rng.random(shape) < 0.3).astype(np.int32)
    hot = rng.choice(n * m, 4, replace=False)
    addr = np.where(rng.random(shape) < 0.5, rng.choice(hot, shape),
                    rng.integers(0, n * m, shape)).astype(np.int32)
    val = rng.integers(0, 256, shape, dtype=np.int32)
    return op, addr, val, np.full((LANES, n), t, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _run(n, packed, cap, t):
    """A whole system's plain run (the node cycle's plain stages over one
    rank, snapshots on), up to quiescence: the states before N1 and
    before N4 (with N4's acceptance rows and counters) of up to
    ``SAMPLES`` cycles, the first to show each feature first, and the
    features seen."""
    cfg = _cfg(n, cap)
    eng = CudaEngine(cfg, *_hot_arrays(cfg, t, n + cap), block=LANES,
                     packed=packed,
                     snapshots=True, device="cpu")
    s = {f: v.clone() for f, v in eng.state.items()}
    s["tr"], s["tr_len"] = eng._tr_full, eng._tr_len_full
    w = s["tr"].shape[1]
    mask = _scalar_layout(cfg, w)["count_mask"]
    nc = _cycle(cfg, 1, 0, packed)
    fs = torch.zeros((6, LANES), dtype=I32)
    seen, picks = {}, []
    for cyc in range(400):
        feats = _features(nc, s, cap)
        before_ab = _clone(s)
        upd, payload, cnt = node_cycle.ab_plain(nc, s, 0, w)
        s.update(upd)
        upd, fbs = node_cycle.deliver_plain(nc, s, [payload], [0])
        s.update(upd)
        before_settle = _clone(s)
        upd, gsum, _ = node_cycle.settle_plain(nc, s, fbs[0], cnt, fs, 0, w)
        feats["inv"] = bool((fbs[0][1:, 2:3 * n:3] != 0).any())
        feats["snapshot"] = bool((upd["snap_taken"] != s["snap_taken"]).any())
        # a node whose snapshot was taken, busy again (mail for a home)
        feats["revisited"] = bool(((s["snap_taken"] != 0) & (
            (s["nsw"] & mask) != 0)).any())
        s.update(upd)
        new = [f for f, v in feats.items() if v and f not in seen]
        seen.update({f: cyc for f in new})
        if (new or cyc in (1, 7)) and len(picks) < SAMPLES:
            picks.append((before_ab, before_settle, fbs[0], cnt))
        if int(gsum[0].max()) == 0:  # the end activity: quiescent
            break
    return picks, seen


def _local_acc(acc, n, nl, me):
    """Rank ``me``'s columns of a whole system's acceptance rows, in its
    local candidate order."""
    cols = [0] * (5 * nl)
    for s in range(nl):
        for k in range(5):
            g = me * nl + s
            local = s * 3 + k if k < 3 else 3 * nl + s * 2 + (k - 3)
            cols[local] = g * 3 + k if k < 3 else 3 * n + g * 2 + (k - 3)
    return acc[:, cols].contiguous()


def _refused(acc, rng):
    """``acc`` with receivers refusing at random: half the point slots
    not accepted, every INV receiver dropped with odds 1/2 (the count
    its accepted set's popcount)."""
    out = acc.clone()
    j, b = acc.shape[1:]
    nl = j // 5
    point = np.ones(j, dtype=bool)
    point[0:3 * nl][2::3] = False
    drop = torch.from_numpy(point[:, None] & (rng.random((j, b)) < 0.5))
    out[0] = torch.where(drop, 0, out[0])
    inv = slice(2, 3 * nl, 3)
    keep = torch.from_numpy(rng.integers(-2**31, 2**31, out[1:, inv].shape)
                            .astype(np.int32))
    out[1:, inv] = out[1:, inv] & keep
    bits = out[1:, inv].to(torch.int64)
    out[0, inv] = sum(((bits >> b) & 1).sum(0) for b in range(31)).to(I32)
    return out


def _held(got_s, before, upd):
    """Every plane of the rank after the kernel equals the plain
    version's (the planes it changes) or the input's (the rest)."""
    for f, v in got_s.items():
        want = upd.get(f, before[f])
        assert torch.equal(v, want), f


@pytest.mark.parametrize("case", list(CASES))
def test_ab_and_settle_launches_equal_plain(host, monkeypatch, case):
    """Every host launch of N1 and N4 over 8 lanes and over 5, on a
    rank's block of a real run's planes at
    sampled cycles: N1's payload, counters and every plane; N4's SUM and
    MAX rows and
    every plane (acceptance as delivered, and with refusals), bit for
    bit against ``ab_plain`` and ``settle_plain``.  The samples hold an
    INV slot, a node that finishes in the cycle and one busy again after
    its snapshot; those of the 4-slot runs a blocked node and a full
    mailbox."""
    n, d, packed, cap, t = CASES[case]
    picks, seen = _run(n, packed, cap, t)
    for f in ("inv", "snapshot", "revisited") + (("blocked", "full")
                                                 if cap == 4 else ()):
        assert f in seen, (f, seen)
    cfg, nl = _cfg(n, cap), n // d
    rng = np.random.default_rng(n + d)
    monkeypatch.setattr(node_cycle, "HOST_LAUNCHER", host)
    launches = dict(host.launches)
    for me in range(d):
        nc = _cycle(cfg, d, me, packed)
        for (s_ab, s_settle, acc, cnt), b in itertools.product(picks,
                                                               WIDTHS):
            lanes = slice(0, b)
            s1 = _node_local(s_ab, me, nl, lanes, CPU)
            w = s1["tr"].shape[1]
            upd, want_p, want_c = node_cycle.ab_plain(nc, _clone(s1), 0, w)
            s4 = _node_local(s_settle, me, nl, lanes, CPU)
            fs = torch.from_numpy(rng.integers(0, 1 << 20, (6, b))
                                  .astype(np.int32))
            cnt_b = cnt[:, lanes].contiguous()
            accs = [_local_acc(acc[..., lanes], n, nl, me)]
            accs.append(_refused(accs[0], rng))
            want4 = [node_cycle.settle_plain(nc, _clone(s4), a, cnt_b, fs, 0,
                                             w) for a in accs]
            got = _clone(s1)
            payload, counts = nc.node_ab(got, 0, w)
            assert torch.equal(payload, want_p)
            assert torch.equal(counts, want_c)
            _held(got, s1, upd)
            for a, (upd4, want_s, want_m) in zip(accs, want4):
                got = _clone(s4)
                gsum, gmax = nc.node_settle(got, a, cnt_b, fs, 0, w)
                assert torch.equal(gsum, want_s)
                assert torch.equal(gmax, want_m)
                _held(got, s4, upd4)
    per = d * len(picks) * len(WIDTHS)
    assert host.launches["node_ab"] - launches["node_ab"] == per
    assert host.launches["node_settle"] - launches["node_settle"] == 2 * per


def test_plans_take_the_lanes_asked_for(host):
    """N1's plan (64 nodes over one shard, 4 mailbox slots: 44 rows a
    pair and 3 x 5 for the rotation) takes kAbLanes = 32 lanes a CTA and
    128 / 32 node rows, the lanes' node tiles a cluster of 16; N4's takes
    kSettleLanes = 4 lanes over every node row.  A long mailbox halves
    N1's lanes until the tile fits in a cluster of at most 16 (64 nodes
    over 2 shards, 256 slots: 16 lanes of 2 node rows); N4's tile holds
    no mailbox slot (4,096 slots: still 4 lanes); a mailbox that no
    lane a CTA fits is refused."""
    import ctypes

    x = node_cycle.NodeArgs()
    x.a.n, x.a.c, x.a.m, x.a.W, x.a.SW = 64, 4, 16, 5, 3
    out = (ctypes.c_int * 4)()
    # what, shards, mailbox slots: lanes, tile bytes, node rows, cluster
    for what, shards, cap, want in (
            (0, 1, 4, (32, 4 * 32 * (59 * 4 + 7), 4, 16)),
            (2, 1, 4, (4, 4 * 4 * (25 * 64 + 18 + 14), 64, 1)),
            (0, 2, 256, (16, 4 * 16 * (1319 * 2 + 7), 2, 16)),
            (2, 2, 4096, (4, 4 * 4 * (25 * 32 + 18 + 14), 32, 1))):
        x.a.cap, x.nl, x.shards, x.me = cap, 64 // shards, shards, 0
        assert host.lib.hpa2_host_node_plan(ctypes.byref(x), what, out) == 0
        assert tuple(out) == want, (what, shards, cap, tuple(out))
    x.a.cap, x.nl, x.shards = 8192, 32, 2
    assert host.lib.hpa2_host_node_plan(ctypes.byref(x), 0, out) != 0


@functools.lru_cache(maxsize=None)
def _jax_packed():
    import jax

    from hpa2_tpu.parallel.sharding import NodeShardedPallasEngine

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    jcfg, tcfg = config_pair(True, num_procs=12)
    arrays = gen_uniform_random_arrays(tcfg, 4, 10, seed=5)
    ref = NodeShardedPallasEngine(jcfg, *arrays, node_shards=2, packed=True,
                                  snapshots=True, cycles_per_call=16).run()
    return tcfg, arrays, ref


@pytest.mark.filterwarnings(IGNORE_PLTPU_ANY)
def test_host_kernel_run_packed_snapshots_equals_jax(host, monkeypatch):
    """12 nodes over 2 logical ranks, packed planes, snapshots on, every
    node kernel run by its host build and held against its plain
    version: every plane (the snapshot planes too), the cycle, the
    messages and ``stats()`` equal JAX ``NodeShardedPallasEngine``'s."""
    from hpa2_tpu_torch.parallel import NodeShardedCudaEngine, make_mesh

    tcfg, arrays, ref = _jax_packed()
    monkeypatch.setattr(node_cycle, "HOST_LAUNCHER", host)
    before = dict(host.launches)
    eng = NodeShardedCudaEngine(
        tcfg, *arrays, mesh=make_mesh(node_shards=2, device="cpu",
                                      local=True),
        cycles_per_call=16, packed=True, snapshots=True,
        _check_calls=1_000).run()
    for f, v in ref.state.items():
        assert np.array_equal(np.asarray(v), eng.state[f].numpy()), f
    assert any(f.startswith("snap_") for f in ref.state)
    assert eng.cycle == ref.cycle and eng.messages == ref.messages
    assert eng.stats() == ref.stats()
    for name in ("node_ab", "node_settle"):
        assert host.launches[name] > before[name]
        for st in eng.rank_stats:
            assert st["checked"][name] == [st["launches"][name], 0], name


def test_args_are_built_once_a_window(monkeypatch):
    """``NodeCycle._args`` builds a stage's NodeArgs once for a window,
    a segment and the planes' storage, patches ``scalars`` every launch,
    and builds anew when a plane is replaced or the window changes."""
    from hpa2_tpu_torch.ops import kernels

    picks, _ = _run(8, False, 4, 8)
    s = _node_local(picks[0][0], 0, 4, slice(None), CPU)
    nc = _cycle(_cfg(8, 4), 2, 0, False)
    built = []
    real = kernels._kernel_args
    monkeypatch.setattr(kernels, "_kernel_args",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    w = s["tr"].shape[1]
    x = nc._args("node_ab", s, 0, w)
    s["scalars"] = s["scalars"] + 1
    y = nc._args("node_ab", s, 0, w)
    assert x is y and len(built) == 1
    assert y.a.scalars == s["scalars"].data_ptr() and y.a.msg_counts is None
    nc._args("node_settle", s, 0, w)
    s["nsw"] = s["nsw"].clone()
    z = nc._args("node_ab", s, 0, w)
    assert z.a.nsw == s["nsw"].data_ptr() and len(built) == 3
    nc._args("node_ab", s, 0, w // 2)
    assert len(built) == 4
