"""N2 (``node_bucket``: hit flags, a scan by words and popcounts, a
scatter) and N3 (``node_deliver``: every entry's receiver set once, a
receiver's ranks by words, every feedback word written once) on the CPU:
their phase bodies (``csrc/node_cycle.cuh``: ``n2_phase``, ``n3_phase``)
built with g++ and run a CTA at a time, phase by phase
(``tests/torch_node_host.py``), each launch held bit for bit against its
plain version (``exchange.bucket``, ``node_cycle.deliver_plain``) on the
same random inputs: a few lanes, entry counts that are no multiple of
the kernels' 32-entry words, receivers with no room and with room for
one offered entries of both phases, buffers that overflow, ``hier``'s
combining count, 16 shards, split sharer words that a rank's nodes
straddle, packed planes.  And a whole node-sharded run through the host
kernels against the JAX package's ``NodeShardedPallasEngine``."""

import dataclasses
import functools
import types
import zlib

import numpy as np
import pytest
import torch

import torch_node_host
from hpa2_tpu_torch.config import Semantics, SystemConfig
from hpa2_tpu_torch.ops import exchange, node_cycle
from hpa2_tpu_torch.ops.cycle import TRANSIENTS
from hpa2_tpu_torch.ops.exchange import Dest
from hpa2_tpu_torch.ops.layout import _SPLIT_BPW, _init_state, _scalar_layout
from hpa2_tpu_torch.parallel.sharding import _node_local
from torch_pairs import IGNORE_PLTPU_ANY, config_pair
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

I32 = torch.int32
CPU = torch.device("cpu")
LANES = 5          # lanes a launch: fewer than a CTA's tile of 8
CAP = 4            # mailbox slots

#: geometries: nodes, shards, this rank, packed planes
GEOMETRIES = {
    "8 nodes over 2": (8, 2, 1, False),
    "12 nodes packed over 2": (12, 2, 0, True),
    "22 nodes over 2": (22, 2, 1, False),
    "64 nodes over 2, rank 0": (64, 2, 0, False),
    "64 nodes over 2, rank 1": (64, 2, 1, False),
    "16 shards": (64, 16, 7, False),
}


@pytest.fixture(scope="module")
def host():
    lib = torch_node_host.build()
    if lib is None:
        pytest.skip("g++ is not installed")
    return torch_node_host.HostLauncher(lib)


def _cycle(geom, mode="a2a"):
    """A node cycle of rank ``me`` of the geometry (a stand-in for the
    node group: only its size and rank are read here)."""
    n, d, me, packed = GEOMETRIES[geom]
    cfg = SystemConfig(num_procs=n, msg_buffer_size=CAP,
                       semantics=Semantics().robust(), exchange_mode=mode)
    return node_cycle.NodeCycle(cfg, False, packed,
                                types.SimpleNamespace(size=d, rank=me), d)


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _block(nc, rng, j, b=LANES, local=0.5):
    """A random entry block [R, j, b]: point entries (``local`` of them
    to this rank's nodes), INV entries with a fan mask over the system's
    gids, empty entries; phase flags of both kinds in any order, and
    combining keys from a small range (so that keys repeat)."""
    W, SW, n = nc.W, nc.SW, nc.n
    kind = rng.choice(3, (j, b), p=[0.55, 0.3, 0.15])
    lo = nc.me * nc.nl
    recv = np.where(rng.random((j, b)) < local,
                    rng.integers(lo, lo + nc.nl, (j, b)),
                    rng.integers(0, n, (j, b)))
    out = np.zeros((nc.R, j, b), dtype=np.int64)
    out[:W] = rng.integers(-2**31, 2**31, (W, j, b))
    gbits = rng.random((n, j, b)) < 0.3
    for w in range(SW):
        word = np.zeros((j, b), dtype=np.int64)
        for t in range(_SPLIT_BPW):
            g = w * _SPLIT_BPW + t
            if g < n:
                word |= gbits[g].astype(np.int64) << t
        out[W + w] = np.where(kind == 1, word, 0)
    out[W + SW] = np.where(kind == 0, recv + 1, 0)
    out[W + SW + 1] = rng.integers(0, 2, (j, b))
    out[W + SW + 2] = np.where(kind == 0, rng.integers(0, 6, (j, b)), 0)
    return torch.from_numpy(out.astype(np.int32))


def _dests(nc, kind, blocks):
    """The destinations of one launch, as ``exchange.forward`` makes
    them under each schedule (``hier``'s inner and outer rounds with the
    source telemetry)."""
    d, me = nc.shards, nc.me
    stats = [Dest(0, ((me + r) % d,), False, True, (me + r) % d)
             for r in range(1, d)]
    if kind in ("a2a", "a2a tight"):
        return [Dest(0, (p,) if p != me else (), True, p != me, p)
                for p in range(d)]
    if kind == "pairwise":
        peer = (me + 1) % d
        return [Dest(0, (peer,), True, True, peer)]
    if kind == "hier inner":
        # the shards of every outer group at one inner index, compacted
        # together; the telemetry over the peers
        half = tuple(p for p in range(d) if p % 2 != me % 2) or (
            (me + 1) % d,)
        return [Dest(0, half, True, False, half[0])] + stats
    # hier outer: every pool block to one target, combining counted;
    # when the inner tier has one shard the source telemetry rides along
    # (forward's first outer round): stat-only destinations, whose hits
    # are not shipped and so not combinable
    tgt = (me + 1) % d
    first = exchange.make_plan(d, "hier").di == 1
    return [Dest(b, (tgt,), True, False, tgt)
            for b in range(len(blocks))] + (stats if first else [])


def _bucket_once(host, monkeypatch, nc, blocks, dests, k, combine, rng):
    """N2's host build and ``exchange.bucket`` on the same blocks and
    the same running telemetry ``fs0``: (kernel buffers, sels,
    telemetry), (plain ...), ``fs0``."""
    b = blocks[0].shape[-1]
    fs0 = torch.from_numpy(rng.integers(0, 50, (len(exchange.FSTATS), b))
                           .astype(np.int32))
    monkeypatch.setattr(node_cycle, "HOST_LAUNCHER", host)
    nc.bucketer.stats_init(blocks[0])
    nc.bucketer.fsbuf.copy_(fs0)
    fs = dict(zip(exchange.FSTATS, nc.bucketer.fsbuf.unbind(0)))
    before = host.launches["node_bucket"]
    out, sels = nc.bucketer(fs, blocks, dests, k, nc.me, combine)
    assert host.launches["node_bucket"] == before + 1
    fs_plain = dict(zip(exchange.FSTATS, fs0.clone().unbind(0)))
    want_out, want_sels = nc.bucketer.plain(fs_plain, blocks, dests, k,
                                            nc.me, combine)
    want_fs = torch.stack([fs_plain[f] for f in exchange.FSTATS])
    return ((out, sels, nc.bucketer.fsbuf), (want_out, want_sels, want_fs),
            fs0)


def _assert_bucket_equal(got, want):
    out, sels, fs = got
    want_out, want_sels, want_fs = want
    assert torch.equal(out, want_out)
    assert len(sels) == len(want_sels)
    for a, b in zip(sels, want_sels):
        assert a.dtype == b.dtype == torch.int64 and torch.equal(a, b)
    for i, f in enumerate(exchange.FSTATS):
        assert torch.equal(fs[i], want_fs[i]), f


BUCKET_KINDS = ("a2a", "a2a tight", "pairwise", "hier inner", "hier outer")


@pytest.mark.parametrize("kind", BUCKET_KINDS)
@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_bucket_launch_equals_exchange_bucket(host, monkeypatch, geom,
                                              kind):
    """One N2 launch a schedule's bucketing step: the buffers (the tail
    past the last hit zeroed), every entry's slot (k when not shipped)
    and the six telemetry rows (sent, high-water, multicast savings,
    combining, overflow and the worst-overflow word), bit for bit."""
    nc = _cycle(geom, {"a2a tight": "a2a", "hier inner": "hier",
                       "hier outer": "hier"}.get(kind, kind))
    rng = _rng(geom, kind)
    j0 = 5 * nc.nl
    payload = _block(nc, rng, j0, local=0.2)
    blocks = [payload]
    k = j0
    if kind == "a2a tight":
        k = 3                                    # k < J: overflow
    if kind == "hier outer":
        k = max(1, j0 - 3)
        blocks += [_block(nc, rng, k, local=0.2) for _ in range(2)]
    dests = _dests(nc, kind, blocks)
    combine = kind in ("hier outer", "a2a")
    got, want, _ = _bucket_once(host, monkeypatch, nc, blocks, dests, k,
                                combine, rng)
    _assert_bucket_equal(got, want)
    if kind == "a2a tight":
        fs = got[2]
        assert int(fs[exchange.FSTATS.index("overflow")].sum()) > 0
        assert int(fs[exchange.FSTATS.index("ovf_diag")].max()) >> 16 > 3


def test_bucket_combining_counts_a_key_over_two_destinations(
        host, monkeypatch):
    """``hier``'s combining count on a crafted lane of an outer round
    (two pool blocks, one compacting destination each, 20 and 7
    entries): key 5 shipped once to each destination and key 9 twice to
    one add two duplicates; key 9 on an entry that is not shipped, a key
    past ``nkeys`` and key 0 add nothing."""
    nc = _cycle("8 nodes over 2", "hier")
    W, SW = nc.W, nc.SW
    blocks = [torch.zeros((nc.R, 20, LANES), dtype=I32),
              torch.zeros((nc.R, 7, LANES), dtype=I32)]
    lo = nc.me * nc.nl                  # gids 0..3 lie on the target
    for blk, j, gid, key in (
            (0, 0, 0, 5), (1, 3, 1, 5),    # key 5 to two destinations
            (0, 4, 2, 9), (0, 19, 3, 9),   # key 9 twice to one
            (0, 6, lo + 1, 9),             # not shipped: this rank's node
            (0, 7, 0, nc.nkeys + 1), (1, 6, 2, 0)):
        blocks[blk][:W, j, 0] = 1000 + j
        blocks[blk][W + SW, j, 0] = gid + 1
        blocks[blk][W + SW + 2, j, 0] = key
    dests = _dests(nc, "hier outer", blocks)
    got, want, fs0 = _bucket_once(host, monkeypatch, nc, blocks, dests, 20,
                                  True, _rng("combining"))
    _assert_bucket_equal(got, want)
    comb = exchange.FSTATS.index("combined")
    assert int(got[2][comb, 0]) - int(fs0[comb, 0]) == 2
    assert torch.equal(got[2][comb, 1:], fs0[comb, 1:])


def _rank_state(nc, rng, b=LANES):
    """A rank's planes with random mailboxes and mailbox counts: row 0
    full (room 0), row 1 with room for one, the others random; the
    other nsw fields random too."""
    cfg = nc.config
    s = _node_local(_init_state(cfg, b, False, nc.packed), nc.me, nc.nl,
                    slice(None), CPU)
    s["tr"] = torch.zeros((nc.nl, 8, b), dtype=I32)
    s["tr_len"] = torch.zeros((nc.nl, b), dtype=I32)
    for f in TRANSIENTS:
        s[f] = torch.zeros((1, b), dtype=I32)
    mask = _scalar_layout(cfg, 8)["count_mask"]
    count = rng.integers(0, CAP + 1, (nc.nl, b))
    count[0] = CAP
    count[1] = CAP - 1
    upper = rng.integers(0, 2**20, (nc.nl, b)) * (mask + 1)
    s["nsw"] = torch.from_numpy((count | upper).astype(np.int32))
    for w in range(nc.W):
        s[f"mb{w}"] = torch.from_numpy(rng.integers(
            -2**31, 2**31, (nc.nl, CAP, b)).astype(np.int32))
    return s


@pytest.mark.parametrize("geom", list(GEOMETRIES))
def test_deliver_launch_equals_deliver_plain(host, monkeypatch, geom):
    """One N3 launch over the payload and D - 1 received buffers in the
    exchange's arrival order (not origin order): the mailboxes, nsw and
    every block's feedback rows (accepted count, accepted receivers'
    bits in the split words) bit for bit; the receiver with no room
    takes nothing, the one with room for one takes the first entry
    addressed to it in the global (phase, origin, index) order."""
    nc = _cycle(geom)
    rng = _rng(geom)
    s = _rank_state(nc, rng)
    k = max(1, 5 * nc.nl - 2)
    blocks = [_block(nc, rng, 5 * nc.nl, local=0.7)] + [
        _block(nc, rng, k, local=0.7) for _ in range(nc.shards - 1)]
    origins = [nc.me] + [(nc.me - r) % nc.shards
                         for r in range(1, nc.shards)]
    monkeypatch.setattr(node_cycle, "HOST_LAUNCHER", host)
    before = host.launches["node_deliver"]
    s_kern = {f: v.clone() for f, v in s.items()}
    fbs = nc.node_deliver(s_kern, blocks, origins)
    assert host.launches["node_deliver"] == before + 1
    upd, want = node_cycle.deliver_plain(nc, s, blocks, origins)
    assert len(fbs) == len(want)
    for a, b in zip(fbs, want):
        assert torch.equal(a, b)
    for f, v in upd.items():
        assert torch.equal(s_kern[f], v), f
    mask = _scalar_layout(nc.config, 8)["count_mask"]
    got = (s_kern["nsw"] & mask) - (s["nsw"] & mask)
    assert int(got[0].max()) == 0 and int(got[1].max()) <= 1
    # every lane's row 1 was offered entries, and took one
    assert int(got[1].min()) == 1
    fb = torch.cat([f[0] for f in fbs], 0)
    assert int(fb.sum()) == int(got.sum()) > 0


def _hot_arrays(config, b, t, seed):
    """Traces whose reads crowd onto four blocks (homes on three of the
    four ranks), so that ``hier``'s outer links carry READ requests of
    one address together: a combining count above 0."""
    rng = np.random.default_rng(seed)
    n, m = config.num_procs, config.mem_size
    shape = (b, n, t)
    op = (rng.random(shape) < 0.2).astype(np.int32)
    addr = rng.choice(np.array([7 * m + 3, 6 * m + 5, m + 2, 3 * m + 1],
                               dtype=np.int32), shape)
    val = rng.integers(0, 256, shape, dtype=np.int32)
    return op, addr, val, np.full((b, n), t, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _jax_hier():
    import jax

    from hpa2_tpu.parallel.sharding import NodeShardedPallasEngine

    if len(jax.devices()) < 4:
        pytest.skip("needs 4 virtual devices")
    jcfg, tcfg = config_pair(True, num_procs=8)
    jcfg = dataclasses.replace(jcfg, exchange_mode="hier")
    tcfg = dataclasses.replace(tcfg, exchange_mode="hier")
    arrays = _hot_arrays(jcfg, 4, 8, seed=1)
    ref = NodeShardedPallasEngine(jcfg, *arrays, node_shards=4,
                                  cycles_per_call=16).run()
    return tcfg, arrays, ref


@pytest.mark.filterwarnings(IGNORE_PLTPU_ANY)
def test_host_kernel_run_equals_jax_node_sharded(host, monkeypatch):
    """8 nodes over 4 logical ranks under ``hier`` (inner and outer
    rounds, the combining count), every node kernel run by its host
    build and held against its plain version: every plane, the cycle,
    the counters and ``stats()`` equal JAX ``NodeShardedPallasEngine``'s
    on the same mesh size."""
    from hpa2_tpu_torch.parallel import NodeShardedCudaEngine, make_mesh

    tcfg, arrays, ref = _jax_hier()
    monkeypatch.setattr(node_cycle, "HOST_LAUNCHER", host)
    before = dict(host.launches)
    eng = NodeShardedCudaEngine(
        tcfg, *arrays, mesh=make_mesh(node_shards=4, device="cpu",
                                      local=True),
        cycles_per_call=16, _check_calls=1_000).run()
    for f, v in ref.state.items():
        assert np.array_equal(np.asarray(v), eng.state[f].numpy()), f
    assert eng.cycle == ref.cycle and eng.messages == ref.messages
    assert eng.stats() == ref.stats()
    assert eng.stats()["exchange_combined"] > 0
    assert eng.stats()["exchange_multicast_saved"] > 0
    for name in ("node_bucket", "node_deliver"):
        assert host.launches[name] > before[name]
        for st in eng.rank_stats:
            assert st["checked"][name] == [st["launches"][name], 0], name
