"""The targeted cross-shard message exchange of the node axis: the port
of ``hpa2_tpu/ops/exchange.py``.

Under node sharding each rank holds a contiguous block of ``n_local =
num_procs // node_shards`` nodes, and phase C (delivery) is the only
place where nodes talk across blocks.  Each rank buckets its send
candidates by destination shard (point sends by ``recv // n_local``,
INV multicasts by which shards hold fan-mask bits), compacts each
bucket in candidate order (:func:`compact`), and moves the buckets on
the schedule of ``SystemConfig.exchange_mode`` (:func:`make_plan`,
:func:`forward`, :func:`feedback`): ``pairwise`` rounds of ppermute,
one batched ``a2a``, a log-depth ``butterfly``, or the two-tier
``hier``.  The receiver ranks every entry in the single-device
candidate order from its origin tag (:func:`ordered_rank`), so the
sharded engine is bit-identical to the single-device one whatever the
arrival order.

Where the port departs from the JAX code, and why:

* **Collectives.**  ``axis_name`` becomes a ``parallel/comm.py:NodeComm``
  (``ppermute`` -> ``batch_isend_irecv``, ``all_to_all`` ->
  ``all_to_all_single``), and the shard id ``me`` is this process's
  rank, a Python int: so origins are host ints, and the
  ``origins[b'] < origins[b]`` gates of :func:`ordered_rank` are
  Python branches.
* **Compaction by scatter.**  The JAX ``compact`` places entries with a
  one-hot ``einsum`` and returns the one-hot ``sel``; CUDA has no
  integer matmul, so here each entry is scattered to its slot (a trash
  slot ``k`` takes the rest) and ``sel`` is each candidate's slot.
  Exactly one candidate lands in a slot, so the words are the same.
* **uint32 words as int32 bits** (``ops/bits.py``): the range masks are
  int32 tensors with the bits of JAX's uint32 words; ``_ones_below``
  builds them in int64, where ``1 << 32`` is exact, so ``bpw == 32``
  needs no special case.
* **Trailing axes.**  As in JAX a payload is ``[R, J, ...]``; the
  batched step passes the batch as the trailing axis.
"""

from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch

from hpa2_tpu_torch.ops import bits

I32 = torch.int32

# rank sentinel for invalid entries: larger than any mailbox capacity
# but far from i32 overflow when compared against count2 + rank
RANK_INVALID = 1 << 30

EXCHANGE_MODES = ("pairwise", "a2a", "butterfly", "hier")


def fwd_perm(d: int, r: int) -> List[Tuple[int, int]]:
    """Round-``r`` forward permutation: shard i sends to (i+r) % d."""
    return [(i, (i + r) % d) for i in range(d)]


def rev_perm(d: int, r: int) -> List[Tuple[int, int]]:
    """Feedback permutation for round ``r``: shard i sends back to
    (i-r) % d, the shard whose buffer it received in :func:`fwd_perm`."""
    return [(i, (i - r) % d) for i in range(d)]


def origin_of_round(me: int, d: int, r: int) -> int:
    """The origin shard of the buffer received in round r."""
    return (me - r) % d


def _ones_below(k, bpw: int) -> torch.Tensor:
    """int64 mask of the low ``clip(k, 0, bpw)`` bits (``k`` an int or
    an integer tensor)."""
    kk = torch.as_tensor(k, dtype=torch.int64).clamp(0, bpw)
    return (torch.ones_like(kk) << kk) - 1


def range_mask_words(lo, hi, nwords: int, bpw: int) -> torch.Tensor:
    """Per-word masks (int32 bits of uint32 words) selecting mask bits
    whose *global* node id falls in [lo, hi): word ``w`` covers ids
    [w*bpw, w*bpw + bpw)."""
    return bits.i32(torch.stack([
        _ones_below(torch.as_tensor(hi) - w * bpw, bpw)
        & ~_ones_below(torch.as_tensor(lo) - w * bpw, bpw)
        for w in range(nwords)
    ]))


def compact(dest: torch.Tensor, payload: torch.Tensor, k: int):
    """Order-preserving compaction along the candidate axis.

    ``dest``: [J, ...] bool/int destination mask; ``payload``:
    [R, J, ...] entry rows.  Returns ``(buf [R, k, ...], sel [J, ...]
    int64, overflow [...] int32)``: ``sel`` each candidate's buffer
    entry, ``k`` where it was not shipped (reused to scatter the
    acceptance feedback back onto candidates), ``overflow`` the
    candidates that did not fit ``k`` entries (0 when ``k`` is the
    capacity-exact bound)."""
    db = dest if dest.dtype == torch.bool else dest != 0
    d = db.to(I32)
    pos = torch.cumsum(d, dim=0, dtype=I32) - d
    slot = torch.where(db & (pos < k), pos, k).to(torch.int64)
    r = payload.shape[0]
    ext = torch.zeros((r, k + 1) + tuple(payload.shape[2:]),
                      dtype=payload.dtype, device=payload.device)
    ext.scatter_(1, slot[None].expand_as(payload), payload)
    overflow = (db & (pos >= k)).sum(dim=0, dtype=I32)
    return ext[:, :k], slot, overflow


def uncompact(fb: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Scatter per-entry feedback rows [R, k, ...] back onto the
    candidate axis through the saved placement ``sel`` (:func:`compact`'s)
    -> [R, J, ...]."""
    r = fb.shape[0]
    ext = torch.cat([fb, torch.zeros_like(fb[:, :1])], dim=1)
    return ext.gather(1, sel[None].expand((r,) + tuple(sel.shape)))


def ordered_rank(v_a: torch.Tensor, v_b: torch.Tensor, bounds: Sequence[int],
                 origins: Sequence[int], axis: int = 1) -> torch.Tensor:
    """Global delivery rank per entry over origin-ordered blocks.

    ``v_a``/``v_b``: masks of valid phase-A / phase-B entries over the
    concatenated entry axis ``axis`` (blocks are the contiguous slices
    ``bounds[b]:bounds[b+1]``, in any physical order); ``origins``: one
    shard id per block.  The global candidate order is every A entry
    ascending (origin, in-block index), then every B entry likewise,
    which is the single-device candidate grid's order.  Returns each
    entry's 0-based position among the valid entries in that order
    (``RANK_INVALID`` where neither mask is set): the sharded
    replacement for the single-device ``cumsum(valid) - valid``."""
    va = v_a.to(I32)
    vb = v_b.to(I32)
    cum_a = torch.cumsum(va, dim=axis, dtype=I32)
    cum_b = torch.cumsum(vb, dim=axis, dtype=I32)
    nb = len(bounds) - 1

    def at(c, idx):
        return c.narrow(axis, idx, 1)

    base_a, base_b, cnt_a, cnt_b = [], [], [], []
    for b in range(nb):
        s, e = bounds[b], bounds[b + 1]
        ba = at(cum_a, s - 1) if s else torch.zeros_like(at(cum_a, 0))
        bb_ = at(cum_b, s - 1) if s else torch.zeros_like(at(cum_b, 0))
        base_a.append(ba)
        base_b.append(bb_)
        cnt_a.append(at(cum_a, e - 1) - ba)
        cnt_b.append(at(cum_b, e - 1) - bb_)
    total_a = at(cum_a, bounds[-1] - 1)

    adj_a, adj_b = [], []
    for b in range(nb):
        off_a = -base_a[b]
        off_b = -base_b[b]
        for b2 in range(nb):
            if b2 != b and int(origins[b2]) < int(origins[b]):
                off_a = off_a + cnt_a[b2]
                off_b = off_b + cnt_b[b2]
        shape = list(v_a.shape)
        shape[axis] = bounds[b + 1] - bounds[b]
        adj_a.append(off_a.expand(shape))
        adj_b.append(off_b.expand(shape))
    adj_a = torch.cat(adj_a, dim=axis)
    adj_b = torch.cat(adj_b, dim=axis)

    rank_a = cum_a - va + adj_a
    rank_b = cum_b - vb + adj_b + total_a
    return torch.where(va != 0, rank_a,
                       torch.where(vb != 0, rank_b, RANK_INVALID))


# ======================================================================
# Transport plans: how the destination buckets move.  Delivery needs
# only that every (origin, destination) pair has exactly one route,
# because ordered_rank rebuilds the global order from the origin ids;
# the arrival order is the plan's and does not matter.  Feedback rows
# are sums (bit words from disjoint receivers never collide), so the
# hier relays add what comes back from different outer rounds.
# ======================================================================


class Plan(NamedTuple):
    """Static description of one exchange schedule."""

    mode: str
    d: int
    di: int  # hier inner-tier size (1 for flat modes)
    do: int  # hier outer-tier size (== d for flat modes)


def _auto_inner(d: int) -> int:
    """Largest divisor of ``d`` not above sqrt(d) (1 when d is prime)."""
    best = 1
    f = 1
    while f * f <= d:
        if d % f == 0:
            best = f
        f += 1
    return best


def make_plan(d: int, mode: str = "pairwise", inner: int = 0) -> Plan:
    """Validate and normalize an exchange plan for ``d`` node shards.

    ``inner`` only matters for ``hier``: the inner-tier size (0 = auto,
    the largest divisor of ``d`` <= sqrt(d)).  ``butterfly`` needs a
    power-of-two shard count; ``a2a``/``pairwise`` work for any ``d``."""
    if mode not in EXCHANGE_MODES:
        raise ValueError(
            f"unknown exchange_mode {mode!r}; expected one of "
            f"{EXCHANGE_MODES}"
        )
    if d < 1:
        raise ValueError(f"node shard count {d} must be >= 1")
    if mode == "butterfly" and (d & (d - 1)) != 0:
        raise ValueError(
            f"exchange_mode='butterfly' needs a power-of-two shard "
            f"count, got {d}; use 'a2a' (any D) or 'hier'"
        )
    di, do = 1, d
    if mode == "hier":
        di = inner or _auto_inner(d)
        if di < 1 or d % di != 0:
            raise ValueError(
                f"exchange_inner={inner} does not divide node "
                f"shards={d}"
            )
        do = d // di
    return Plan(mode=mode, d=d, di=di, do=do)


def plan_collectives(plan: Plan) -> dict:
    """Per-cycle cross-shard collectives of a plan (forward + feedback;
    the stacked counter SUM and telemetry MAX are extra and mode-free).
    Keys: ``ppermute``, ``all_to_all``."""
    d = plan.d
    if d <= 1:
        return {"ppermute": 0, "all_to_all": 0}
    if plan.mode == "pairwise":
        return {"ppermute": 2 * (d - 1), "all_to_all": 0}
    if plan.mode == "a2a":
        return {"ppermute": 0, "all_to_all": 2}
    if plan.mode == "butterfly":
        return {"ppermute": 2 * (d.bit_length() - 1), "all_to_all": 0}
    return {"ppermute": 2 * (plan.di + plan.do - 2), "all_to_all": 0}


#: the telemetry rows of :func:`forward`, in the order of the node
#: kernels' ``[6, ...]`` stats block (``csrc/node_cycle.cuh``, ``FS_*``)
FSTATS = ("sent", "hwm", "mc_saved", "combined", "overflow", "ovf_diag")


class Dest(NamedTuple):
    """One destination of a bucketing step: entries of block ``block``
    bound for any shard of ``shards`` (empty: none); ``compact`` puts
    them in a k-slot buffer, ``stat`` counts them in the source
    telemetry (``sent``, ``hwm``, ``mc_saved``); ``dst`` names the
    destination in the overflow word."""

    block: int
    shards: Tuple[int, ...]
    compact: bool
    stat: bool
    dst: int


def _ovf_note(fs: dict, ovf, demand, src: int, dst: int) -> None:
    """Fold one compaction's overflow into the running stats: count,
    and a packed max-demand event word ``demand<<16 | src<<8 | dst``."""
    fs["overflow"] = fs["overflow"] + ovf
    word = (demand.clamp(max=0xFFFF) << 16) | ((src % 256) << 8) | (dst % 256)
    fs["ovf_diag"] = torch.maximum(fs["ovf_diag"],
                                   torch.where(ovf > 0, word, 0))


def bucket(fs: dict, blocks: Sequence[torch.Tensor], dests: Sequence[Dest],
           k: int, src: int, dest_of: Callable, fan_of: Optional[Callable],
           ckey_row: Optional[int] = None, nkeys: int = 0):
    """One bucketing step, as plain tensor code: every destination of
    ``dests`` over its block (``dest_of(block, shards)`` -> bool [J,
    ...]), the stat ones counted (entries, high-water, and the unicast
    slots a mask-less INV fan-out would have cost, ``fan - 1`` a shipped
    entry with ``fan_of(block, peer)``), the compacting ones compacted
    in candidate order (:func:`compact`, with the overflow bookkeeping
    when ``k`` cannot hold the block), and with ``ckey_row`` the
    combining count over the compacting ones (what an in-network
    combiner would have merged: ``hier``'s outer links).  Updates
    ``fs``; returns the buffers ``[P, R, k, ...]`` and placements of the
    P compacting destinations, in order."""
    bufs, sels, cnt = [], [], None
    for dest in dests:
        blk = blocks[dest.block]
        mask = dest_of(blk, dest.shards)
        if dest.stat:
            dcount = mask.sum(dim=0, dtype=I32)
            fs["sent"] = fs["sent"] + dcount
            fs["hwm"] = torch.maximum(fs["hwm"], dcount)
            if fan_of is not None:
                fan = fan_of(blk, dest.shards[0])
                fs["mc_saved"] = fs["mc_saved"] + torch.where(
                    mask, (fan - 1).clamp(min=0), 0).sum(dim=0, dtype=I32)
        if not dest.compact:
            continue
        buf, sel, ovf = compact(mask, blk, k)
        if k < int(blk.shape[1]):
            demand = mask.sum(dim=0, dtype=I32)
            fs["hwm"] = torch.maximum(fs["hwm"], demand)
            _ovf_note(fs, ovf, demand, src, dest.dst)
        bufs.append(buf)
        sels.append(sel)
        if ckey_row is not None and nkeys > 0:
            # tier-boundary combining, modeled: the duplicates still
            # ship, the counter reports what an in-network combiner
            # would have merged on the outer links
            key = blk[ckey_row]
            kk = torch.arange(1, nkeys + 1, dtype=I32,
                              device=key.device).reshape(
                (nkeys,) + (1,) * key.dim())
            c = ((key[None] == kk) & mask[None]).sum(dim=1, dtype=I32)
            cnt = c if cnt is None else cnt + c
    if cnt is not None:
        fs["combined"] = fs["combined"] + (cnt - 1).clamp(min=0).sum(
            dim=0, dtype=I32)
    return torch.stack(bufs), sels


class FnBucketer:
    """The bucketing of :func:`forward` from a ``dest_fn(block, peer)``
    and a ``fan_fn(block, peer)``, as plain tensor code (the general
    engine's exchange and the tests'); a shard set's mask is the OR of
    its shards'."""

    def __init__(self, dest_fn: Callable, fan_fn: Optional[Callable],
                 ckey_row: Optional[int] = None, nkeys: int = 0):
        self.dest_fn, self.fan_fn = dest_fn, fan_fn
        self.ckey_row, self.nkeys = ckey_row, nkeys

    def stats_init(self, payload: torch.Tensor) -> dict:
        z = torch.zeros(payload.shape[2:], dtype=I32, device=payload.device)
        return dict.fromkeys(FSTATS, z)

    def dest_of(self, blk, shards):
        m = torch.zeros(blk.shape[1:], dtype=torch.bool, device=blk.device)
        for p in shards:
            m = m | self.dest_fn(blk, p)
        return m

    def __call__(self, fs, blocks, dests, k, src, combine=False):
        return bucket(fs, blocks, dests, k, src, self.dest_of, self.fan_fn,
                      self.ckey_row if combine else None, self.nkeys)


def forward(plan: Plan, comm, me: int, payload: torch.Tensor,
            dest_fn: Optional[Callable], k: int,
            fan_fn: Optional[Callable] = None,
            ckey_row: Optional[int] = None, nkeys: int = 0,
            bucketer=None):
    """Run the plan's forward exchange over ``comm`` (a ``NodeComm``).

    ``payload``: [R, J0, ...] candidate rows; ``dest_fn(block, peer)``
    -> bool [J, ...] destination mask; ``k``: entries per exchange
    buffer; ``fan_fn(block, peer)`` -> int32 [J, ...] receivers of an
    entry within ``peer`` (the multicast-savings counter);
    ``ckey_row``/``nkeys``: the payload row holding the combining key
    (0 = not combinable, else key+1) and the key space (``hier`` only).
    ``bucketer`` replaces the three: a callable ``(fs, blocks, dests, k,
    src, combine) -> (bufs [P, R, k, ...], sels)`` with a
    ``stats_init(payload)`` (the node cycle's, which launches the N2
    kernel on the card); each schedule makes one bucketing step a
    compaction round (one for all peers under ``a2a`` and
    ``butterfly``), the source telemetry in its first.

    Returns ``(bufs, origins, ctx, fstats)``: the received [R, k, ...]
    blocks, one origin shard id per block with the local block's ``me``
    first (feed both to :func:`ordered_rank`), the feedback context, and
    the telemetry (``sent``, ``hwm``, ``mc_saved``, ``combined``,
    ``overflow``, ``ovf_diag``, int32 of the payload's trailing shape)."""
    d = plan.d
    if bucketer is None:
        bucketer = FnBucketer(dest_fn, fan_fn, ckey_row, nkeys)
    fs = bucketer.stats_init(payload)
    if d <= 1:
        return [], [me], (plan.mode, []), fs
    combine = ckey_row is not None and nkeys > 0
    # the source telemetry over the D-1 peer buckets
    stats = [Dest(0, ((me + r) % d,), False, True, (me + r) % d)
             for r in range(1, d)]
    if plan.mode == "pairwise":
        bufs, sels, origins = [], [], [me]
        for rnd in range(1, d):
            peer = (me + rnd) % d
            out, sel = bucketer(fs, [payload],
                                [Dest(0, (peer,), True, True, peer)], k, me)
            bufs.append(comm.ppermute(out[0], fwd_perm(d, rnd)))
            sels.append(sel[0])
            origins.append(origin_of_round(me, d, rnd))
        return bufs, origins, ("pairwise", sels), fs

    if plan.mode == "a2a":
        # one destination-major bucket stack, one all_to_all: received
        # block b arrives from shard b.  The self block is empty;
        # rolling the stack by -(me+1) parks it last, so the receiver
        # processes d-1 real blocks, as in pairwise
        out, sels = bucketer(fs, [payload], [
            Dest(0, (p,) if p != me else (), True, p != me, p)
            for p in range(d)], k, me)
        recv = comm.all_to_all(out)
        recv = torch.roll(recv, -(me + 1), dims=0)
        bufs = [recv[b] for b in range(d - 1)]
        origins = [me] + [(me + 1 + b) % d for b in range(d - 1)]
        return bufs, origins, ("a2a", sels), fs

    if plan.mode == "butterfly":
        # XOR fold: bucket rel holds entries for shard me ^ rel; stage
        # s ships every odd cell to partner i ^ 2^s (one stacked
        # ppermute); after log2(D) stages the surviving cell holds D
        # blocks, block b from shard me ^ b.  rel 0 (self) is a zero
        # block that is never compacted and dropped at the end
        stages = d.bit_length() - 1
        zero_block = torch.zeros(
            (payload.shape[0], k) + tuple(payload.shape[2:]),
            dtype=payload.dtype, device=payload.device)
        out, sel = bucketer(fs, [payload], [
            Dest(0, (me ^ rel,), True, True, me ^ rel)
            for rel in range(1, d)], k, me)
        blocks, sels = [zero_block] + list(out), [None] + list(sel)
        cells = [[b] for b in blocks]
        for s in range(stages):
            perm = [(i, i ^ (1 << s)) for i in range(d)]
            ship = torch.stack([torch.stack(cells[2 * t + 1])
                                for t in range(len(cells) // 2)])
            got = comm.ppermute(ship, perm)
            cells = [cells[2 * t] + [got[t, b] for b in range(1 << s)]
                     for t in range(len(cells) // 2)]
        bufs = cells[0][1:]
        origins = [me] + [me ^ b for b in range(1, d)]
        return bufs, origins, ("butterfly", sels), fs

    # hier: origin -> relay -> destination, the relay in the origin's
    # outer group at the destination's inner index.  Inner round r
    # ships everything bound for inner index (me_i + r); the relay pool
    # (local payload + the Di-1 inner arrivals) is then re-bucketed per
    # outer round, so the outer links carry each entry once per
    # destination group.  The first step carries the source telemetry
    di, do = plan.di, plan.do
    me_i = me % di
    me_o = me // di

    inner_sels, bufs, origins = [], [], [me]
    for r in range(1, di):
        ti = (me_i + r) % di
        out, sel = bucketer(fs, [payload], [
            Dest(0, tuple(o * di + ti for o in range(do)), True, False,
                 me_o * di + ti)] + stats, k, me)
        stats = []
        perm = [(o * di + i, o * di + (i + r) % di)
                for o in range(do) for i in range(di)]
        bufs.append(comm.ppermute(out[0], perm))
        inner_sels.append(sel[0])
        origins.append(me_o * di + (me_i - r) % di)
    pool = [payload] + list(bufs)  # entries bound for inner index me_i

    outer_sels = []
    for r in range(1, do):
        tgt = ((me_o + r) % do) * di + me_i
        out, sels_r = bucketer(fs, pool, [
            Dest(b, (tgt,), True, False, tgt) for b in range(len(pool))]
            + stats, k, me, combine=combine)
        stats = []
        perm = [(o * di + i, ((o + r) % do) * di + i)
                for o in range(do) for i in range(di)]
        got = comm.ppermute(out, perm)
        og = (me_o - r) % do
        for q in range(di):
            bufs.append(got[q])
            origins.append(og * di + (me_i if q == 0 else (me_i - q) % di))
        outer_sels.append(sels_r)
    return bufs, origins, ("hier", (inner_sels, outer_sels, plan)), fs


def feedback(plan: Plan, comm, fb_blocks: List[torch.Tensor], ctx):
    """Route additive acceptance rows back to the senders.

    ``fb_blocks``: one [R2, k, ...] feedback slice per received block, in
    :func:`forward`'s block order.  Returns the [R2, J0, ...]
    contribution to the local candidate axis (add it to the local
    feedback slice), or 0 when nothing came from elsewhere."""
    mode, saved = ctx
    d = plan.d
    if d <= 1 or not fb_blocks:
        return 0
    if mode == "pairwise":
        acc = None
        for i, (fb, sel) in enumerate(zip(fb_blocks, saved)):
            c = uncompact(comm.ppermute(fb, rev_perm(d, i + 1)), sel)
            acc = c if acc is None else acc + c
        return acc
    if mode == "a2a":
        # undo forward's roll: block r answers the sender at
        # (me+1+r) % d, so rolling by +(me+1) puts each chunk at its
        # destination-major position (the zero pad lands on self)
        pad = torch.zeros_like(fb_blocks[0])
        out = torch.roll(torch.stack(list(fb_blocks) + [pad], dim=0),
                         comm.rank + 1, dims=0)
        ret = comm.all_to_all(out)
        acc = None
        for b in range(d):
            c = uncompact(ret[b], saved[b])
            acc = c if acc is None else acc + c
        return acc
    if mode == "butterfly":
        stages = d.bit_length() - 1
        # forward dropped the inert rel-0 block; restore its slot so
        # the reverse fold sees the full d-cell structure
        cells = [[torch.zeros_like(fb_blocks[0])] + list(fb_blocks)]
        for s in reversed(range(stages)):
            half = 1 << s
            perm = [(i, i ^ (1 << s)) for i in range(d)]
            ship = torch.stack([torch.stack(c[half:]) for c in cells])
            got = comm.ppermute(ship, perm)
            nxt = []
            for t, c in enumerate(cells):
                nxt.append(c[:half])
                nxt.append([got[t, b] for b in range(half)])
            cells = nxt
        acc = None
        for rel in range(1, d):
            c = uncompact(cells[rel][0], saved[rel])
            acc = c if acc is None else acc + c
        return acc
    # hier: reverse the outer rounds first (relay feedback scattered
    # onto the pool blocks; contributions for one inner buffer from
    # different outer rounds add), then the inner rounds
    inner_sels, outer_sels, p = saved
    di, do = p.di, p.do
    nb_inner = di - 1
    fb_inner = list(fb_blocks[:nb_inner])
    local_acc = None
    idx = nb_inner
    for ri, r in enumerate(range(1, do)):
        perm = [(o * di + i, ((o - r) % do) * di + i)
                for o in range(do) for i in range(di)]
        ret = comm.ppermute(torch.stack(fb_blocks[idx:idx + di]), perm)
        idx += di
        for q in range(di):
            c = uncompact(ret[q], outer_sels[ri][q])
            if q == 0:
                local_acc = c if local_acc is None else local_acc + c
            else:
                fb_inner[q - 1] = fb_inner[q - 1] + c
    for ri, r in enumerate(range(1, di)):
        perm = [(o * di + i, o * di + (i - r) % di)
                for o in range(do) for i in range(di)]
        c = uncompact(comm.ppermute(fb_inner[ri], perm), inner_sels[ri])
        local_acc = c if local_acc is None else local_acc + c
    return local_acc
