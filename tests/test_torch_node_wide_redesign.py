"""The wide family's N1 (``node_ab_wide``) and N2 (``node_bucket_wide``)
as tiled kernels (``csrc/node_cycle.cuh``: ``n1w_phase`` over a tile of
(node row, lane) pairs, a warp a pair's protocol body over the pairs'
sets in the tile; ``n2w_flags_phase`` and ``n2w_place_phase``: flag words
built in the tile, a CTA-wide scan, the buffers written whole) on the
CPU: their phase bodies built with g++ and run a CTA at a time, phase by
phase over every thread (``tests/torch_node_host.py``; the tile starts
as garbage, and the host build runs a warp as its lane 0 over every
word of a set), each launch held bit for bit against its plain version
(``ab_plain``, ``exchange.bucket``) on the same inputs, at 96 nodes over
2 ranks and 160 over 4 (a rank's first node inside a 31-bit sharer
word), 5 lanes, so that tiles end mid-tile:

* N1 on a rank's block of sampled cycles of a real run
  (``test_torch_node_wide.py``'s), with the planned tile, the plan's
  smallest (one pair a CTA) and the pairs' sets in the scratch;
* N2 on random entry blocks under ``a2a``, ``a2a`` with overflowing
  buffers and ``hier``'s outer round (the combining count), with the
  planned lane tile, the smallest (one lane a tile) and 8 lanes (the
  16-byte stores);
* the plans at the node axis's geometry (4,096 nodes x 8 lanes over 4
  ranks) and at 256 x 256."""

import ctypes
import itertools

import numpy as np
import pytest
import torch

import torch_node_host
from hpa2_tpu_torch.ops import exchange, kernels, node_cycle
from hpa2_tpu_torch.parallel.sharding import _node_local
from test_torch_node_ab_settle import _clone, _held
from test_torch_node_redesign import _assert_bucket_equal, _block, _dests, _rng
from test_torch_node_wide import WIDE, _bucket_once, _cycle, _run
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

CPU = torch.device("cpu")
LANES = 5
#: the card's lanes a tile of the wide N2 (kWideBucketLanes)
BUCKET_LANES = 32


@pytest.fixture(scope="module")
def host():
    lib = torch_node_host.build()
    if lib is None:
        pytest.skip("g++ is not installed")
    launcher = torch_node_host.HostLauncher(lib)
    yield launcher
    lib.hpa2_host_wide_limits(node_cycle.WIDE_AB_SMEM, BUCKET_LANES)


def _limits(host, smem=None, lanes=BUCKET_LANES):
    host.lib.hpa2_host_wide_limits(
        node_cycle.WIDE_AB_SMEM if smem is None else smem, lanes)


def _stride(sw):
    return (node_cycle.WIDE_SETS * sw) | 1


def _tables(sw):
    """Bytes of the plane tables' copy in N1w's tile (mb, ob, dirs)."""
    return 8 * (2 * (2 + sw) + sw)


def _pair_tile(sw):
    """Bytes of N1w's tile of one pair (tables, scalar rows, sums, sets)."""
    return _tables(sw) + 4 * (node_cycle.WIDE_AB_ROWS + node_cycle.AB_COUNTS
                              + _stride(sw))


def _wide_args(n, d, b):
    """A rank's WideArgs for the plans only (no plane behind them)."""
    nc = _cycle(n, d, 1, snapshots=False)
    tr = torch.zeros((nc.nl, 2, b), dtype=torch.int32)
    x = node_cycle.NodeArgs()
    planes = {f"dirs{w}": tr for w in range(kernels.MAX_SHARER_WORDS)}
    x.a = kernels._kernel_args(
        nc.config, planes, tr, tr[:, 0], None, block=1, k=0, window=2,
        n_seg=1, max_calls=0, gate=False, snapshots=False)
    x.me, x.nl, x.shards = nc.me, nc.nl, d
    y = node_cycle.WideArgs()
    y.x = x
    return nc, y


def _ab_plan(host, y):
    out = (ctypes.c_int * 5)()
    assert host.lib.hpa2_host_wide_ab_plan(ctypes.byref(y), out) == 0
    return dict(zip(("pairs", "stride", "global", "smem", "ctas"), out))


def _bucket_plan(host, nc, b):
    """N2w's plan of an a2a step of ``nc``'s rank over ``b`` lanes."""
    j = 5 * nc.nl
    y = node_cycle.WideBucketArgs()
    x = y.x
    x.n, x.nl, x.W, x.SW, x.b, x.k = nc.n, nc.nl, nc.W, nc.SW, b, j
    x.ndest, x.nkeys, x.me = nc.shards, nc.nkeys, nc.me
    x.blen[0] = j
    for p in range(nc.shards):
        x.dflags[p] = 1 | (2 if p != nc.me else 0)
        y.dwlo[p], y.dwhi[p] = 0, nc.SW - 1
    out = (ctypes.c_int * 7)()
    assert host.lib.hpa2_host_wide_bucket_plan(ctypes.byref(y), out) == 0
    return dict(zip(("lanes", "lane_tiles", "chunk", "steps", "flags_ctas",
                     "place_ctas", "slots"), out))


def test_plans_fill_the_card_at_the_node_axis_geometry(host):
    """At 4,096 nodes x 8 lanes over 4 ranks N1w's tile holds 16 pairs
    and the plane tables (73,560 B, two an SM by the launch bounds): 512
    CTAs of 8 warps, so that the 132 SMs hold two each; N2w's tiles are
    the 8 lanes: a flags CTA a flag word (640), and 4 x 160 chunks of 32
    slots plus one fold CTA.  At 256 x 256 a tile holds 32 pairs, and a
    place CTA 24 slots (its chunk at least 16,384 words).  The wrapper's
    scratch agrees with the plan: none while one pair's sets fit the
    tile."""
    _limits(host)
    nc, y = _wide_args(4096, 4, 8)
    assert (nc.SW, nc.W) == (133, 135)
    pl = _ab_plan(host, y)
    assert pl == dict(pairs=16, stride=1065, smem=73560, ctas=512,
                      **{"global": 0})
    assert pl["ctas"] >= 132 and 2 * pl["smem"] <= 227 * 1024
    assert node_cycle.wide_ab_scratch(nc.SW) == 0
    assert _bucket_plan(host, nc, 8) == dict(
        lanes=8, lane_tiles=1, chunk=32, steps=5, flags_ctas=640,
        place_ctas=1 + 4 * 160, slots=32)
    nc, y = _wide_args(256, 4, 256)
    assert _ab_plan(host, y)["pairs"] == 32
    assert _ab_plan(host, y)["ctas"] == 64 * 256 // 32
    assert _bucket_plan(host, nc, 256) == dict(
        lanes=32, lane_tiles=8, chunk=8, steps=3, flags_ctas=4 * 10 * 32,
        place_ctas=8 + 4 * 14 * 8, slots=24)


def test_scratch_follows_the_plan(host, monkeypatch):
    """Sets too wide for one pair's tile go to the scratch, in the plan
    and in the wrapper alike; the scalar tile then shrinks to fit;
    without the scratch the plan refuses."""
    nc, y = _wide_args(160, 4, LANES)
    limit = _pair_tile(nc.SW) - 4
    _limits(host, limit)
    monkeypatch.setattr(node_cycle, "WIDE_AB_SMEM", limit)
    assert node_cycle.wide_ab_scratch(nc.SW) == _stride(nc.SW)
    assert host.lib.hpa2_host_wide_ab_plan(ctypes.byref(y),
                                           (ctypes.c_int * 5)()) == 1
    work = torch.zeros(4, dtype=torch.int32)
    y.work = work.data_ptr()
    pl = _ab_plan(host, y)
    scalar, tab = 4 * (node_cycle.WIDE_AB_ROWS + node_cycle.AB_COUNTS), \
        _tables(nc.SW)
    want = max(tp for tp in (1, 2, 4, 8, 16, 32)
               if tab + tp * scalar <= limit)
    assert pl["global"] == 1 and pl["pairs"] == want < 32
    assert pl["smem"] == tab + want * scalar
    _limits(host)


def test_tile_words_set_operations(host):
    """``TileWords``'s set operations (the protocol body's words in N1w)
    against numpy on random sets of 1-9 words, sparse and dense, members
    anywhere: any, the lowest member, the member count, a member test,
    a one-member set, x & ~y, x | y, a copy, zero."""
    rng = np.random.default_rng(19)
    for sw in (1, 2, 5, 9):
        for density in (0.02, 0.3):
            bits = (rng.random((2, sw, 31)) < density).astype(np.int64)
            x, y = (bits << np.arange(31)).sum(2).astype(np.int32)
            for p in (-1, 0, int(rng.integers(0, 31 * sw)), 31 * sw):
                out = np.zeros(4 + 5 * sw, dtype=np.int32)
                host.lib.hpa2_host_tile_words(
                    sw, x.ctypes.data, y.ctypes.data, p, out.ctypes.data)
                members = np.flatnonzero(bits[0].reshape(-1))
                want_bit = np.zeros(sw, dtype=np.int32)
                if 0 <= p < 31 * sw:
                    want_bit[p // 31] = 1 << (p % 31)
                assert out[0] == np.bitwise_or.reduce(x)
                assert out[1] == (members[0] if len(members) else -1)
                assert out[2] == len(members)
                assert out[3] == (0 <= p < 31 * sw and p in members)
                sets = out[4:].reshape(5, sw)
                for got, want in zip(sets, (want_bit, x & ~y, x | y, x,
                                            np.zeros(sw, np.int32))):
                    assert np.array_equal(got, want)


#: N1w's tiles: (lanes, the tile's bytes from one pair's): the plan's
#: over 5 lanes (tiles end mid-node) and over 8 (a tile whole nodes: the
#: payload and outbox rows a node-major run), one pair a CTA, the sets in
#: the scratch
AB_TILES = {"planned": (LANES, None), "8 lanes, whole nodes": (8, None),
            "one pair a CTA": (LANES, 0), "sets in the scratch": (LANES, -4)}


@pytest.mark.parametrize("tile", list(AB_TILES))
@pytest.mark.parametrize("case", list(WIDE))
def test_wide_ab_tiles_equal_plain(host, monkeypatch, case, tile):
    """Every N1w host launch, on each rank's block of the sampled cycles
    (INV slots, blocked nodes, full mailboxes): the payload, the
    counters and every plane, bit for bit."""
    n, d, cap, t = WIDE[case]
    picks, seen = _run(n, cap, t)
    assert {"inv", "blocked", "full"} <= set(seen), seen
    nl = n // d
    sw = _cycle(n, d, 0, cap).SW
    lanes, extra = AB_TILES[tile]
    smem = None if extra is None else _pair_tile(sw) + extra
    _limits(host, smem)
    if smem is not None:
        monkeypatch.setattr(node_cycle, "WIDE_AB_SMEM", smem)
    monkeypatch.setattr(node_cycle, "HOST_LAUNCHER", host)
    before = host.launches["node_ab_wide"]
    try:
        for me, (s_ab, _, _, _) in itertools.product(range(d), picks):
            nc = _cycle(n, d, me, cap)
            s1 = _node_local(s_ab, me, nl, slice(0, lanes), CPU)
            w = s1["tr"].shape[1]
            upd, want_p, want_c = node_cycle.ab_plain(nc, _clone(s1), 0, w)
            got = _clone(s1)
            payload, counts = nc.node_ab(got, 0, w)
            assert torch.equal(payload, want_p)
            assert torch.equal(counts, want_c)
            _held(got, s1, upd)
            assert (nc._work is not None) == (tile == "sets in the scratch")
            if nc._work is not None:
                # each pair's own rows of the scratch: its INV slot's
                # sharer words staged there (set kSetInv = 0)
                inv = torch.stack([s1[f"ob{2 + j}"][:, 2]
                                   for j in range(nc.SW)], -1)
                assert torch.equal(nc._work[:, :nc.SW],
                                   inv.reshape(-1, nc.SW))
    finally:
        _limits(host)
    assert host.launches["node_ab_wide"] - before == d * len(picks)


#: N2w's lane tiles: (lanes a launch, lanes a tile at most)
BUCKET_TILES = {"planned": (LANES, BUCKET_LANES), "one lane a tile":
                (LANES, 1), "8 lanes, 16-byte stores": (8, BUCKET_LANES)}


@pytest.mark.parametrize("tile", list(BUCKET_TILES))
@pytest.mark.parametrize("kind", ("a2a", "a2a tight", "hier outer"))
@pytest.mark.parametrize("case", list(WIDE))
def test_wide_bucket_tiles_equal_plain(host, monkeypatch, case, kind, tile):
    """One N2w launch a schedule's bucketing step: every buffer (hits and
    the zeroed tail), every entry's slot and the six telemetry rows, bit
    for bit; a tight buffer overflows."""
    n, d, _, _ = WIDE[case]
    b, lanes = BUCKET_TILES[tile]
    nc = _cycle(n, d, 1, snapshots=False,
                mode="hier" if kind == "hier outer" else "a2a")
    rng = _rng("wide redesign", case, kind, tile)
    j0 = 5 * nc.nl
    blocks = [_block(nc, rng, j0, b=b, local=0.2)]
    k = 3 if kind == "a2a tight" else j0
    if kind == "hier outer":
        k = j0 - 3
        blocks += [_block(nc, rng, k, b=b, local=0.2) for _ in range(2)]
    _limits(host, lanes=lanes)
    try:
        got, want = _bucket_once(host, monkeypatch, nc, blocks,
                                 _dests(nc, kind, blocks), k,
                                 kind != "a2a tight", rng)
    finally:
        _limits(host)
    _assert_bucket_equal(got, want)
    if kind == "a2a tight":
        assert int(got[2][exchange.FSTATS.index("overflow")].sum()) > 0
    else:
        assert int((got[0] != 0).sum()) > 0
