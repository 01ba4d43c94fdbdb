"""The wide family of the node kernels (``csrc/node_cycle.cuh``: N1's
and N2's phase bodies ``n1w_phase``, ``node_ab<TileWords>``,
``n2w_flags_phase``, ``n2w_place_phase``, N3's and N4's ``w3``/``w4``
item bodies; the entries ``node_*_wide`` of ``ops/node_cycle.py``) on the
CPU: their bodies built with g++ and run a CTA at a time phase by phase
(N1, N2) or an item at a time (N3, N4), launch after launch
(``tests/torch_node_host.py``), each launch held bit for bit against its
plain version on the same inputs, at 96 nodes over 2 ranks and 160 over
4, where a rank's first node falls inside a 31-bit sharer word (96 / 2
= 48 and 160 / 4 = 40 are no multiples of 31):

* N1 and N4 on a rank's block of a real run's planes at sampled cycles
  (as ``test_torch_node_ab_settle.py`` samples them: INV slots, blocked
  nodes, full mailboxes, snapshots), N4 with receivers refusing at
  random;
* N2 and N3 on random entry blocks (``test_torch_node_redesign.py``'s:
  point and fan entries, both phases, receivers with no room and with
  room for one, overflowing buffers, ``hier``'s combining count).

And a whole node-sharded run at 96 nodes over 2 logical ranks through
the wide kernels' host build (every launch also held against its plain
version) against JAX ``NodeShardedPallasEngine`` (planes, cycle,
counters, ``stats()``, dumps) and the spec engine (dumps); the
profiler's attribution of the wide entries' CUDA kernels; and
``gpu_session``'s ``--measure-nodeshard`` child against the
``cycle="tensor"`` run (``compare`` 2, the ``nodeshard4096`` step's
check) at 96 nodes over 2 gloo ranks."""

import dataclasses
import functools
import itertools
import types

import numpy as np
import pytest
import torch

import torch_node_host
from hpa2_tpu_torch.ops import exchange, node_cycle
from hpa2_tpu_torch.parallel.sharding import _node_local
from hpa2_tpu_torch.ops.cuda_engine import CudaEngine
from hpa2_tpu_torch.ops.layout import _scalar_layout
from test_torch_node_ab_settle import (
    _cfg, _clone, _cycle as _one_rank, _features, _held, _hot_arrays,
    _local_acc, _refused,
)
from test_torch_node_redesign import (
    _assert_bucket_equal, _block, _dests, _rank_state, _rng,
)
from torch_pairs import IGNORE_PLTPU_ANY, config_pair, dicts, traces_of
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
LANES = 5

#: nodes, shards, mailbox slots, instructions a core (the N1/N4 samples)
WIDE = {"96 nodes over 2": (96, 2, 4, 4), "160 nodes over 4": (160, 4, 4, 3)}


@pytest.fixture(scope="module")
def host():
    lib = torch_node_host.build()
    if lib is None:
        pytest.skip("g++ is not installed")
    return torch_node_host.HostLauncher(lib)


def _cycle(n, d, me, cap=4, snapshots=True, mode="a2a"):
    cfg = dataclasses.replace(_cfg(n, cap), exchange_mode=mode)
    return node_cycle.NodeCycle(cfg, snapshots, False,
                                types.SimpleNamespace(size=d, rank=me), d)


@functools.lru_cache(maxsize=None)
def _run(n, cap, t):
    """A whole system's plain run (the node cycle's plain stages over one
    rank, snapshots on) up to the cycle by which its samples show an INV
    slot, a snapshot, a blocked node and a full mailbox: the states
    before N1 and before N4 (with N4's acceptance rows and counters) of
    the first cycle to show each feature and of cycle 1, and the
    features seen (``test_torch_node_ab_settle.py:_run``, cut short)."""
    cfg = _cfg(n, cap)
    eng = CudaEngine(cfg, *_hot_arrays(cfg, t, n + cap), block=8,
                     snapshots=True, device="cpu")
    s = {f: v.clone() for f, v in eng.state.items()}
    s["tr"], s["tr_len"] = eng._tr_full, eng._tr_len_full
    w = s["tr"].shape[1]
    nc = _one_rank(cfg, 1, 0, False)
    fs = torch.zeros((6, 8), dtype=torch.int32)
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
        s.update(upd)
        new = [f for f, v in feats.items() if v and f not in seen]
        seen.update({f: cyc for f in new})
        if new or cyc == 1:
            picks.append((before_ab, before_settle, fbs[0], cnt))
        if len(seen) == 4 or int(gsum[0].max()) == 0:
            break
    return picks, seen


def test_rank_boundaries_fall_inside_sharer_words():
    """The geometries are wide (the wide entries), and a rank's node
    range starts inside a sharer word."""
    for n, d, _, _ in WIDE.values():
        nc = _cycle(n, d, 1)
        assert nc.wide and nc.entries == node_cycle.WIDE_KERNELS
        assert nc.SW == -(-n // 31) and nc.W == 2 + nc.SW
        assert any((p * (n // d)) % 31 for p in range(1, d))


@pytest.mark.parametrize("case", list(WIDE))
def test_wide_ab_and_settle_equal_plain(host, monkeypatch, case):
    """Every host launch of the wide N1 and N4 over 5 lanes, on each
    rank's block of sampled cycles of a real run: N1's payload,
    counters and every plane, N4's SUM and MAX rows and every plane
    (acceptance as delivered, and with refusals), bit for bit."""
    n, d, cap, t = WIDE[case]
    picks, seen = _run(n, cap, t)
    for f in ("inv", "snapshot", "blocked", "full"):
        assert f in seen, (f, seen)
    nl = n // d
    rng = np.random.default_rng(n + d)
    monkeypatch.setattr(node_cycle, "HOST_LAUNCHER", host)
    launches = dict(host.launches)
    lanes = slice(0, LANES)
    for me, (s_ab, s_settle, acc, cnt) in itertools.product(range(d),
                                                            picks):
        nc = _cycle(n, d, me, cap)
        s1 = _node_local(s_ab, me, nl, lanes, CPU)
        w = s1["tr"].shape[1]
        upd, want_p, want_c = node_cycle.ab_plain(nc, _clone(s1), 0, w)
        got = _clone(s1)
        payload, counts = nc.node_ab(got, 0, w)
        assert torch.equal(payload, want_p)
        assert torch.equal(counts, want_c)
        _held(got, s1, upd)
        s4 = _node_local(s_settle, me, nl, lanes, CPU)
        fs = torch.from_numpy(rng.integers(0, 1 << 20, (6, LANES))
                              .astype(np.int32))
        cnt_b = cnt[:, lanes].contiguous()
        a0 = _local_acc(acc[..., lanes], n, nl, me)
        for a in (a0, _refused(a0, rng)):
            upd4, want_s, want_m = node_cycle.settle_plain(
                nc, _clone(s4), a, cnt_b, fs, 0, w)
            got = _clone(s4)
            gsum, gmax = nc.node_settle(got, a, cnt_b, fs, 0, w)
            assert torch.equal(gsum, want_s)
            assert torch.equal(gmax, want_m)
            _held(got, s4, upd4)
    per = d * len(picks)
    assert host.launches["node_ab_wide"] - launches["node_ab_wide"] == per
    assert (host.launches["node_settle_wide"]
            - launches["node_settle_wide"]) == 2 * per
    assert host.launches["node_ab"] == launches["node_ab"]


def _bucket_once(host, monkeypatch, nc, blocks, dests, k, combine, rng):
    """The wide N2's host build and ``exchange.bucket`` on the same
    blocks and running telemetry: (kernel buffers, sels, telemetry),
    (plain ...)."""
    b = blocks[0].shape[-1]
    fs0 = torch.from_numpy(rng.integers(0, 50, (len(exchange.FSTATS), b))
                           .astype(np.int32))
    monkeypatch.setattr(node_cycle, "HOST_LAUNCHER", host)
    nc.bucketer.stats_init(blocks[0])
    nc.bucketer.fsbuf.copy_(fs0)
    fs = dict(zip(exchange.FSTATS, nc.bucketer.fsbuf.unbind(0)))
    before = host.launches["node_bucket_wide"]
    out, sels = nc.bucketer(fs, blocks, dests, k, nc.me, combine)
    assert host.launches["node_bucket_wide"] == before + 1
    fs_plain = dict(zip(exchange.FSTATS, fs0.clone().unbind(0)))
    want_out, want_sels = nc.bucketer.plain(fs_plain, blocks, dests, k,
                                            nc.me, combine)
    want_fs = torch.stack([fs_plain[f] for f in exchange.FSTATS])
    return (out, sels, nc.bucketer.fsbuf), (want_out, want_sels, want_fs)


@pytest.mark.parametrize("kind", ("a2a", "a2a tight", "hier outer"))
@pytest.mark.parametrize("case", list(WIDE))
def test_wide_bucket_equals_exchange_bucket(host, monkeypatch, case, kind):
    """One wide N2 launch a schedule's bucketing step: buffers, every
    entry's slot and the six telemetry rows, bit for bit."""
    n, d, _, _ = WIDE[case]
    mode = "hier" if kind == "hier outer" else "a2a"
    nc = _cycle(n, d, 1, snapshots=False, mode=mode)
    rng = _rng("wide", case, kind)
    j0 = 5 * nc.nl
    blocks = [_block(nc, rng, j0, local=0.2)]
    k = 3 if kind == "a2a tight" else j0
    if kind == "hier outer":
        k = j0 - 3
        blocks += [_block(nc, rng, k, local=0.2) for _ in range(2)]
    got, want = _bucket_once(host, monkeypatch, nc, blocks,
                             _dests(nc, kind, blocks), k,
                             kind != "a2a tight", rng)
    _assert_bucket_equal(got, want)
    if kind == "a2a tight":
        ovf = got[2][exchange.FSTATS.index("overflow")]
        assert int(ovf.sum()) > 0


@pytest.mark.parametrize("case", list(WIDE))
def test_wide_deliver_equals_deliver_plain(host, monkeypatch, case):
    """One wide N3 launch over the payload and D - 1 received buffers in
    arrival order: mailboxes, nsw and every feedback row, bit for bit;
    the receiver with no room takes nothing, the one with room for one
    takes one."""
    n, d, _, _ = WIDE[case]
    nc = _cycle(n, d, d - 1, snapshots=False)
    rng = _rng("wide deliver", case)
    s = _rank_state(nc, rng)
    k = 5 * nc.nl - 2
    blocks = [_block(nc, rng, 5 * nc.nl, local=0.7)] + [
        _block(nc, rng, k, local=0.7) for _ in range(d - 1)]
    origins = [nc.me] + [(nc.me - r) % d for r in range(1, d)]
    monkeypatch.setattr(node_cycle, "HOST_LAUNCHER", host)
    s_kern = _clone(s)
    fbs = nc.node_deliver(s_kern, blocks, origins)
    upd, want = node_cycle.deliver_plain(nc, s, blocks, origins)
    for a, b in zip(fbs, want):
        assert torch.equal(a, b)
    for f, v in upd.items():
        assert torch.equal(s_kern[f], v), f
    mask = _scalar_layout(nc.config, 8)["count_mask"]
    took = (s_kern["nsw"] & mask) - (s["nsw"] & mask)
    assert int(took[0].max()) == 0 and int(took[1].min()) == 1


@functools.lru_cache(maxsize=None)
def _wide_run():
    """96 nodes x 4 systems x 6 instructions over 2 shards: JAX
    ``NodeShardedPallasEngine`` and the arrays."""
    import jax

    from hpa2_tpu.parallel.sharding import NodeShardedPallasEngine
    from hpa2_tpu.utils.trace import gen_uniform_random_arrays

    if len(jax.devices()) < 2:
        pytest.skip("needs 2 virtual devices")
    jcfg, tcfg = config_pair(True, num_procs=96, msg_buffer_size=8)
    arrays = gen_uniform_random_arrays(jcfg, 4, 6, seed=3)
    ref = NodeShardedPallasEngine(jcfg, *arrays, node_shards=2,
                                  cycles_per_call=16).run()
    return jcfg, tcfg, arrays, ref


@pytest.mark.filterwarnings(IGNORE_PLTPU_ANY)
def test_wide_host_kernel_run_equals_jax_and_spec(host, monkeypatch):
    """The node-sharded fast path at 96 nodes over 2 logical ranks, every
    cycle's node stages run by the wide kernels' host build and the
    first call's launches held against their plain versions: every
    plane, the cycle, the counters, ``stats()`` and every system's dumps
    equal JAX ``NodeShardedPallasEngine``'s, and the final dumps the
    spec engine's."""
    from hpa2_tpu.models.spec_engine import SpecEngine
    from hpa2_tpu_torch.parallel import NodeShardedCudaEngine, make_mesh

    jcfg, tcfg, arrays, ref = _wide_run()
    monkeypatch.setattr(node_cycle, "HOST_LAUNCHER", host)
    before = dict(host.launches)
    eng = NodeShardedCudaEngine(
        tcfg, *arrays, mesh=make_mesh(node_shards=2, device="cpu",
                                      local=True),
        cycles_per_call=16, _check_calls=1).run()
    for f, v in ref.state.items():
        assert np.array_equal(np.asarray(v), eng.state[f].numpy()), f
    assert eng.cycle == ref.cycle and eng.messages == ref.messages
    assert eng.stats() == ref.stats()
    for b in range(ref.b):
        assert dicts(eng.system_final_dumps(b)) == dicts(
            ref.system_final_dumps(b))
        spec = SpecEngine(jcfg, traces_of(*arrays, b, 96))
        spec.run(max_cycles=50_000)
        assert dicts(eng.system_final_dumps(b)) == dicts(spec.final_dumps())
    for e in node_cycle.WIDE_KERNELS:
        assert host.launches[e.name] > before[e.name], e.name
        for st in eng.rank_stats:
            assert st["checked"][e.name][1] == 0
            assert st["checked"][e.name][0] >= 1
    for e in node_cycle.NODE_KERNELS:
        assert host.launches[e.name] == before[e.name]


def test_profile_names_the_wide_launches():
    """``NodeProfile``'s attribution: each wide entry's launches by their
    kernel names, none of them a register kernel's."""
    from hpa2_tpu_torch.parallel.sharding import _is_node_kernel

    names = {
        "node_ab": "void (anonymous namespace)::node_ab_kernel<64, false>"
                   "(hpa2::NodeArgs, hpa2::NodePlan)",
        "node_ab_wide": "(anonymous namespace)::node_ab_wide_kernel"
                        "(hpa2::WideArgs)",
        "node_bucket_wide": "(anonymous namespace)::"
                            "node_bucket_wide_scatter_kernel(...)",
        "node_deliver_wide": "node_deliver_wide_take_kernel(...)",
        "node_settle_wide": "node_settle_wide_lane_kernel(...)",
    }
    for e in node_cycle.ALL_NODE_KERNELS:
        got = {k for k, v in names.items() if _is_node_kernel(e, v)}
        assert got == ({e.name} if e.name in names else set()), e.name


def test_measure_nodeshard_against_the_tensor_cycle(capsys):
    """``--measure-nodeshard ... compare 2`` (``nodeshard4096``'s check)
    at 96 nodes over 2 gloo ranks: the line records the tensor cycle's
    run and the planes' equality, and the child exits 0."""
    import json

    from hpa2_tpu_torch.scripts import gpu_session

    assert gpu_session.main(["--measure-nodeshard", "96", "2", "2", "2",
                             "4", "8", "8", "0", "2", "2", "-1", "0",
                             "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["bit_exact"] is True and rec["cycle"] == "kernel"
    assert rec["tensor_cycles"] == rec["cycles"] > 0
    assert rec["instructions"] == 96 * 2 * 2
