"""One lockstep cycle of the fast path as plain PyTorch tensor code.

This is the plain version of the cycle body that the CUDA kernel
(``csrc/cycle.cuh``) runs per system, and it is what a CPU tensor runs
on.  It translates ``hpa2_tpu/ops/pallas_engine.py:build_cycle``: every
op works on whole ``[N, ..., B]`` planes, one system per lane, and the
result is bit for bit the JAX cycle's.

With ``axis_name`` (a ``parallel/comm.py`` node group) and ``shards``
:func:`build_cycle` returns K1's node-sharded variant instead
(``ops/node_cycle.py``), whose phases A and B are :func:`build_phase_ab`
over the rank's node rows.  Sharer sets are lists of SW word tensors
(one word in the directory word up to 21 nodes, split ``dirs{w}``
planes beyond); packed planes are widened to the int32 words at cycle
entry and narrowed at exit.

Per cycle:

* phase A: every node that is not blocked by a deferred send handles
  the head of its mailbox (the mailbox rotates left by one, so the
  popped head lands in the vacated tail slot);
* phase B: eligible nodes issue their next trace instruction;
* phase C: the five candidate slots of every node are delivered in
  (phase, sender, slot) order while the receiver has queue space; a
  rejected send defers to the sender's outbox, which blocks the sender
  until it is delivered;
* phase D: dump-at-local-completion snapshots;
* counters.

``ablate`` (timing only, ``scripts/perf_sweep.py --ablate``) stubs out
named stages as ``build_cycle(ablate=)`` does in the JAX package
(``pallas_engine.py:545-547``): the cycle is then deliberately wrong,
and serves to attribute a cycle's time to its stages on the card
(:data:`ABLATE_STAGES`).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.models.protocol import INVALID_ADDR, MsgType
from hpa2_tpu_torch.ops.layout import (
    _CW_ADDR_SHIFT, _CW_VAL_SHIFT, _DS, _DU, _DW_SH_SHIFT,
    _DW_STATE_SHIFT, _E, _EM, _I, _M, _NO_MSG, _NSCALAR, _NSLOTS,
    _NTYPES, _PACKED_CACHE, _PACKED_DIR, _S, _SC_OVERFLOW,
    _SPLIT_BPW,
    _TR_ADDR_SHIFT, _ADDR_MASK, TORCH_DTYPES, _check_geometry,
    _check_semantics, _mb_layout, _scalar_layout, _sharer_words,
    _split_mode, deferred_valid, field, packed_plane_dtypes,
)

I32 = torch.int32

#: the cycle stages an ablated cycle may stub out, and their bits in the
#: kernels' ``Args::ablate`` mask (``kAblate*`` in csrc/cycle.cuh):
#: ``phase_a`` pops every mailbox head but handles none
#: (pallas_engine.py:688), ``phase_b`` lets no node issue (:1123), and
#: ``deliver`` delivers no candidate, the sends vanishing without
#: deferral (:1281, :1649)
ABLATE_STAGES = {"phase_a": 1, "phase_b": 2, "deliver": 4}

#: the [1, B] rows the node-sharded cycle carries beside the planes (JAX
#: ``parallel/sharding.py:_PALLAS_TRANSIENTS``): the SUM of the end-of-
#: cycle activity over the node group (the quiescence gate and the next
#: cycle's ``_SC_CYCLE`` increment), cumulative cross-shard entries,
#: the sticky exchange-overflow flag, the slot high-water mark, the
#: multicast and combining savings, and the two packed worst-overflow
#: words (``demand<<16 | src<<8 | dst`` and ``demand<<16 | cycle``)
TRANSIENTS = ("activeg", "xmsgs", "exchov",
              "exchhw", "exchmc", "exchcb", "exchdg", "exchdc")


def ablate_set(names) -> frozenset:
    """``names`` as a frozenset of :data:`ABLATE_STAGES`; an unknown name
    raises ``ValueError`` (the JAX package ignores one silently)."""
    names = frozenset(names)
    unknown = sorted(names - set(ABLATE_STAGES))
    if unknown:
        raise ValueError(
            f"unknown ablation stage(s) {unknown}: the stages are "
            f"{', '.join(ABLATE_STAGES)}")
    return names


def ablate_mask(names) -> int:
    """The ``Args::ablate`` bits of the stages ``names``."""
    return sum(ABLATE_STAGES[x] for x in ablate_set(names))


def _popcount(x: torch.Tensor) -> torch.Tensor:
    """popcount of 32-bit patterns (SWAR in int64)."""
    u = x.to(torch.int64) & 0xFFFFFFFF
    u = u - ((u >> 1) & 0x55555555)
    u = (u & 0x33333333) + ((u >> 2) & 0x33333333)
    u = (u + (u >> 4)) & 0x0F0F0F0F
    return (((u * 0x01010101) & 0xFFFFFFFF) >> 24).to(I32)


def _find_owner(x: torch.Tensor) -> torch.Tensor:
    """Lowest set bit index of a mask; -1 when empty."""
    u = x.to(torch.int64) & 0xFFFFFFFF
    pos = _popcount((u & -u) - 1)
    return torch.where(u == 0, torch.full_like(pos, -1), pos)


def _bit(proc: torch.Tensor) -> torch.Tensor:
    """One-hot mask for node id(s); negative -> 0."""
    one = torch.ones_like(proc)
    return torch.where(proc >= 0, one << proc.clamp(0, 31),
                       torch.zeros_like(proc))


def _test_bit(mask: torch.Tensor, proc: torch.Tensor) -> torch.Tensor:
    return ((mask >> proc.clamp(0, 31)) & 1) == 1


def _isum(x: torch.Tensor, dim) -> torch.Tensor:
    return x.to(I32).sum(dim, dtype=I32)


def _widen_cache(cvalw, cmetaw) -> torch.Tensor:
    """Packed cache planes -> the cachew word."""
    cv, cm = cvalw.to(I32), cmetaw.to(I32)
    return (cm & 3) | (cv << _CW_VAL_SHIFT) | ((cm >> 2) << _CW_ADDR_SHIFT)


def _narrow_cache(cachew, meta_dtype):
    """The cachew word -> (cvalw, cmetaw)."""
    return (((cachew >> _CW_VAL_SHIFT) & 0xFF).to(torch.uint8),
            ((cachew & 3) | ((cachew >> _CW_ADDR_SHIFT) << 2)).to(meta_dtype))


def _widen_dir(dmemw, dmetaw) -> torch.Tensor:
    """Packed directory planes -> the dirw word."""
    dm, dmt = dmemw.to(I32), dmetaw.to(I32)
    return dm | ((dmt & 3) << _DW_STATE_SHIFT) | ((dmt >> 2) << _DW_SH_SHIFT)


def _narrow_dir(dirw, meta_dtype):
    """The dirw word -> (dmemw, dmetaw)."""
    return ((dirw & 0xFF).to(torch.uint8),
            (((dirw >> _DW_STATE_SHIFT) & 3)
             | ((dirw >> _DW_SH_SHIFT) << 2)).to(meta_dtype))


def build_phase_ab(config: SystemConfig, ablate: frozenset = frozenset()):
    """Phases A and B of the cycle for ``config`` as a function ``(s,
    gids) -> dict``: every node row of the state dict ``s`` (int32
    planes, ``tr``/``tr_len`` the trace window) handles its mailbox head
    and issues one instruction; ``gids`` [rows, B] are the rows' node
    ids (a node shard's rows start at its first node's id).  Returns
    the cache and directory planes after both phases, the mailbox with
    the heads popped (``qdata``), the node words' parts, the counters'
    masks, and the five candidate slots (``slots5``: receiver and wire
    words without the sender field; ``words5``: with it) with the INV
    slot's receiver set and address, deferred slots merged back in."""
    ablate = ablate_set(ablate)
    n, c, m = config.num_procs, config.cache_size, config.mem_size
    sem = config.semantics
    nack = sem.intervention_miss_policy == "nack"
    layout, W = _mb_layout(config)
    recv_packed = "recv" in layout
    split = _split_mode(config)
    SW = _sharer_words(config)
    sh_mask = (1 << min(n, _SPLIT_BPW)) - 1

    def dec(words, name):
        return field(layout, words, name)

    def ab(s: Dict[str, torch.Tensor], gids: torch.Tensor) -> dict:
        dev = s["nsw"].device
        nl, bb = s["nsw"].shape
        zero = torch.zeros((nl, bb), dtype=I32, device=dev)
        neg1 = torch.full((nl, bb), -1, dtype=I32, device=dev)
        false = torch.zeros((nl, bb), dtype=torch.bool, device=dev)

        def read(arr, idx):  # [N, X, B] at [N, B] -> [N, B]
            return torch.gather(arr, 1, idx.long()[:, None, :]).squeeze(1)

        def write(arr, idx, mask, val):
            ix = idx.long()[:, None, :]
            old = torch.gather(arr, 1, ix).squeeze(1)
            return arr.scatter(1, ix, torch.where(mask, val, old)[:, None, :])

        def where(mask, a, b):
            return torch.where(mask, a, b)

        dv = deferred_valid(config, s)                      # [N, 5, B]
        blocked = _isum(dv, 1) > 0

        slsc = _scalar_layout(config, s["tr"].shape[1])
        nsw_in = s["nsw"]
        mb_count_in = nsw_in & slsc["count_mask"]
        waiting_in = (nsw_in >> slsc["off_wait"]) & 1
        pw_in = (nsw_in >> slsc["off_pw"]) & slsc["pw_mask"]
        pc_in = (nsw_in >> slsc["off_pc"]) & slsc["pc_mask"]

        # ===== phase A: handle one message per node ==================
        has_msg = (mb_count_in > 0) & ~blocked
        heads = [s[f"mb{w}"][:, 0, :] for w in range(W)]
        mt = where(has_msg, dec(heads, "type"), torch.full_like(zero, _NO_MSG))
        if "phase_a" in ablate:  # the head is popped, no handler acts
            mt = torch.full_like(zero, _NO_MSG)
        snd = dec(heads, "sender")
        sr = dec(heads, "second") - 1
        a = dec(heads, "addr")
        aux = dec(heads, "aux")
        v = aux & 0xFF

        qdata = [
            where(has_msg[:, None, :], torch.roll(s[f"mb{w}"], -1, 1),
                  s[f"mb{w}"])
            for w in range(W)
        ]
        count2 = mb_count_in - has_msg.to(I32)

        home = torch.div(a, m, rounding_mode="floor")
        blk = torch.remainder(a, m)
        ci = torch.remainder(a, c)
        is_home = gids == home
        is_second = gids == sr

        cw = read(s["cachew"], ci)
        line_state = cw & 3
        line_val = (cw >> _CW_VAL_SHIFT) & 0xFF
        line_addr = ((cw >> _CW_ADDR_SHIFT) & _ADDR_MASK) - 1
        dw = read(s["dirw"], blk)
        mem_blk = dw & 0xFF
        ds = (dw >> _DW_STATE_SHIFT) & 3
        pw = pw_in

        # sharer sets as SW-word lists; every helper reduces to the
        # single-word op when SW == 1
        if split:
            dshw = [read(s[f"dirs{w}"], blk) for w in range(SW)]
        else:
            dshw = [(dw >> _DW_SH_SHIFT) & sh_mask]

        def sv_bit(proc):
            """One-hot sharer vector of node id(s); negative -> 0."""
            if SW == 1:
                return [_bit(proc)]
            return [
                _bit(where((proc >= w * _SPLIT_BPW)
                           & (proc < (w + 1) * _SPLIT_BPW),
                           proc - w * _SPLIT_BPW, neg1))
                for w in range(SW)
            ]

        def sv_test(sv, proc):
            if SW == 1:
                return _test_bit(sv[0], proc)
            hit = torch.zeros_like(proc)
            for w in range(SW):
                b = proc - w * _SPLIT_BPW
                vw = (sv[w] >> b.clamp(0, _SPLIT_BPW - 1)) & 1
                hit = hit | where((b >= 0) & (b < _SPLIT_BPW), vw,
                                  torch.zeros_like(vw))
            return hit == 1

        def sv_count(sv):
            cnt = _popcount(sv[0])
            for w in range(1, SW):
                cnt = cnt + _popcount(sv[w])
            return cnt

        def sv_owner(sv):
            """Lowest set bit across the words."""
            own = _find_owner(sv[SW - 1])
            if SW > 1:
                own = where(own >= 0, own + (SW - 1) * _SPLIT_BPW, own)
            for w in range(SW - 2, -1, -1):
                own = where(sv[w] != 0,
                            _find_owner(sv[w]) + w * _SPLIT_BPW, own)
            return own

        def sv_where(mask, x, y):
            return [where(mask, x[w], y[w]) for w in range(SW)]

        line_match = line_addr == a
        line_me = (line_state == _M) | (line_state == _E)
        owner = sv_owner(dshw)
        owner_is_snd = owner == snd
        snd_bitw = sv_bit(snd)

        def slot():
            return {"recv": neg1, "w": [zero] * W}

        def pack(type_, addr, aux=None, second=None, shr=None):
            """Wire words with the sender field left zero; ``shr`` is a
            sharer vector (the ``shr{w}`` fields in split mode, the aux
            union otherwise)."""
            vals = {"type": type_, "addr": addr}
            if shr is not None:
                if split:
                    vals.update({f"shr{w}": shr[w] for w in range(SW)})
                else:
                    aux = shr[0]
            if aux is not None:
                vals["aux"] = aux
            if second is not None:
                vals["second"] = second + 1
            out = []
            for w in range(W):
                acc = zero
                const = 0
                for name, x in vals.items():
                    ww, off, _ = layout[name]
                    if ww != w:
                        continue
                    if isinstance(x, int):
                        const |= x << off
                    else:
                        acc = acc | (x << off)
                out.append(acc | const if const else acc)
            return out

        def put(sl, mask, recv, words):
            sl["recv"] = where(mask, recv, sl["recv"])
            sl["w"] = [where(mask, words[w], sl["w"][w]) for w in range(W)]

        def evict_msg(sl, mask, l_addr, l_val, l_state):
            vv = mask & (l_addr != INVALID_ADDR) & (l_state != _I)
            sane = l_addr.clamp(min=0)
            et = where(
                l_state == _M,
                torch.full_like(zero, int(MsgType.EVICT_MODIFIED)),
                torch.full_like(zero, int(MsgType.EVICT_SHARED)),
            )
            put(sl, vv, torch.div(sane, m, rounding_mode="floor"),
                pack(et, sane, aux=l_val))
            return vv

        sA0, sA1 = slot(), slot()
        inv_shw = [zero] * SW
        inv_addr = zero

        nl_addr, nl_val, nl_state = line_addr, line_val, line_state
        upd_line = false
        nd_state, nd_shw = ds, list(dshw)
        upd_dir = false
        mem_write = false
        mem_val = mem_blk
        waiting = waiting_in

        def typ(t):
            return mt == int(t)

        def const(x):
            return torch.full_like(zero, x)

        # --- READ_REQUEST ---------------------------------------------
        mk = typ(MsgType.READ_REQUEST) & is_home
        du, dss, dem = ds == _DU, ds == _DS, ds == _EM
        reply_mask = mk & (du | dss | (dem & owner_is_snd))
        excl = du | (dem & owner_is_snd)
        put(sA0, reply_mask, snd,
            pack(int(MsgType.REPLY_RD), a,
                 aux=mem_blk | where(excl, const(256), zero)))
        fwd = mk & dem & ~owner_is_snd
        put(sA0, fwd, owner, pack(int(MsgType.WRITEBACK_INT), a, second=snd))
        upd_dir = upd_dir | (mk & (du | dss | fwd))
        nd_state = where(mk & du, const(_EM), nd_state)
        nd_state = where(fwd, const(_DS), nd_state)
        nd_shw = sv_where(mk & du, snd_bitw, nd_shw)
        nd_shw = sv_where(mk & (dss | fwd),
                          [x | y for x, y in zip(nd_shw, snd_bitw)], nd_shw)

        # --- REPLY_RD -------------------------------------------------
        mk = typ(MsgType.REPLY_RD)
        ev_replyrd = evict_msg(
            sA0, mk & ~line_match, line_addr, line_val, line_state
        )
        upd_line = upd_line | mk
        nl_addr = where(mk, a, nl_addr)
        nl_val = where(mk, v, nl_val)
        nl_state = where(
            mk, where((aux >> 8) & 1 == 1, const(_E), const(_S)), nl_state
        )
        waiting = where(mk, zero, waiting)

        # --- WRITEBACK_INT --------------------------------------------
        mk = typ(MsgType.WRITEBACK_INT)
        ok = mk & line_match & line_me
        flush_w = pack(int(MsgType.FLUSH), a, aux=line_val, second=sr)
        put(sA0, ok, home, flush_w)
        put(sA1, ok & (sr != home), sr, flush_w)
        upd_line = upd_line | ok
        nl_state = where(ok, const(_S), nl_state)
        if nack:
            put(sA0, mk & ~(line_match & line_me), home,
                pack(int(MsgType.NACK), a, second=sr))

        # --- FLUSH ----------------------------------------------------
        mk = typ(MsgType.FLUSH)
        mem_write = mem_write | (mk & is_home)
        mem_val = where(mk & is_home, v, mem_val)
        rq = mk & is_second
        ev_flush = evict_msg(
            sA0, rq & ~line_match, line_addr, line_val, line_state
        )
        upd_line = upd_line | rq
        nl_addr = where(rq, a, nl_addr)
        nl_val = where(rq, v, nl_val)
        nl_state = where(rq, const(_S), nl_state)
        waiting = where(rq, zero, waiting)

        # --- UPGRADE --------------------------------------------------
        mk = typ(MsgType.UPGRADE) & is_home
        reply_shw = [where(mk & (ds == _DS), x & ~y, zero)
                     for x, y in zip(dshw, snd_bitw)]
        put(sA0, mk, snd, pack(int(MsgType.REPLY_ID), a, shr=reply_shw))
        upd_dir = upd_dir | mk
        nd_state = where(mk, const(_EM), nd_state)
        nd_shw = sv_where(mk, snd_bitw, nd_shw)

        # --- REPLY_ID -------------------------------------------------
        mk = typ(MsgType.REPLY_ID)
        fill = mk & line_match & (line_state != _M)
        upd_line = upd_line | fill
        nl_val = where(fill, pw, nl_val)
        nl_state = where(fill, const(_M), nl_state)
        fan = mk & line_match
        if split:
            msg_shw = [dec(heads, f"shr{w}") for w in range(SW)]
        else:
            msg_shw = [aux]
        self_bitw = sv_bit(gids)
        inv_shw = sv_where(fan, [x & ~y for x, y in zip(msg_shw, self_bitw)],
                           inv_shw)
        inv_addr = where(fan, a, inv_addr)
        waiting = where(mk, zero, waiting)

        # --- INV ------------------------------------------------------
        mk = typ(MsgType.INV)
        inv_applied = mk & line_match & (
            (line_state == _S) | (line_state == _E)
        )
        upd_line = upd_line | inv_applied
        nl_state = where(inv_applied, const(_I), nl_state)

        # --- WRITE_REQUEST --------------------------------------------
        mk = typ(MsgType.WRITE_REQUEST) & is_home
        if sem.eager_write_request_memory:
            mem_write = mem_write | mk
            mem_val = where(mk, v, mem_val)
        put(sA0, mk & (du | (dem & owner_is_snd)), snd,
            pack(int(MsgType.REPLY_WR), a))
        put(sA0, mk & dss, snd,
            pack(int(MsgType.REPLY_ID), a,
                 shr=[x & ~y for x, y in zip(dshw, snd_bitw)]))
        wr_fwd = mk & dem & ~owner_is_snd
        put(sA0, wr_fwd, owner,
            pack(int(MsgType.WRITEBACK_INV), a, second=snd))
        upd_dir = upd_dir | (mk & (du | dss | wr_fwd))
        nd_state = where(mk & (du | dss), const(_EM), nd_state)
        nd_shw = sv_where(mk & (du | dss | wr_fwd), snd_bitw, nd_shw)

        # --- REPLY_WR -------------------------------------------------
        mk = typ(MsgType.REPLY_WR)
        upd_line = upd_line | mk
        nl_addr = where(mk, a, nl_addr)
        nl_val = where(mk, pw, nl_val)
        nl_state = where(mk, const(_M), nl_state)
        waiting = where(mk, zero, waiting)

        # --- WRITEBACK_INV --------------------------------------------
        mk = typ(MsgType.WRITEBACK_INV)
        ok = mk & line_match & line_me
        invack_w = pack(int(MsgType.FLUSH_INVACK), a, aux=line_val,
                        second=sr)
        put(sA0, ok, home, invack_w)
        put(sA1, ok & (sr != home), sr, invack_w)
        upd_line = upd_line | ok
        nl_state = where(ok, const(_I), nl_state)
        if nack:
            put(sA0, mk & ~(line_match & line_me), home,
                pack(int(MsgType.NACK), a, aux=1, second=sr))

        # --- FLUSH_INVACK ---------------------------------------------
        mk = typ(MsgType.FLUSH_INVACK)
        hm = mk & is_home
        mem_write = mem_write | hm
        mem_val = where(hm, v, mem_val)
        upd_dir = upd_dir | hm
        nd_state = where(hm, const(_EM), nd_state)
        sr_bitw = sv_bit(sr)
        nd_shw = sv_where(hm, sr_bitw, nd_shw)
        rq = mk & is_second
        upd_line = upd_line | rq
        nl_addr = where(rq, a, nl_addr)
        nl_val = where(
            rq, v if sem.flush_invack_fills_old_value else pw, nl_val
        )
        nl_state = where(rq, const(_M), nl_state)
        waiting = where(rq, zero, waiting)

        # --- EVICT_SHARED (home role) ---------------------------------
        mk = typ(MsgType.EVICT_SHARED) & is_home & sv_test(dshw, snd)
        after = [x & ~y for x, y in zip(dshw, snd_bitw)]
        cnt = sv_count(after)
        upd_dir = upd_dir | mk
        nd_shw = sv_where(mk, after, nd_shw)
        nd_state = where(mk & (cnt == 0), const(_DU), nd_state)
        upg = mk & (cnt == 1) & (ds == _DS)
        nd_state = where(upg, const(_EM), nd_state)
        put(sA0, upg, sv_owner(after),
            pack(int(MsgType.UPGRADE_NOTIFY), a))

        # --- UPGRADE_NOTIFY -------------------------------------------
        mk = typ(MsgType.UPGRADE_NOTIFY) & (snd == home)
        hit_un = mk & line_match & (line_state == _S)
        upd_line = upd_line | hit_un
        nl_state = where(hit_un, const(_E), nl_state)

        # --- EVICT_MODIFIED -------------------------------------------
        mk = typ(MsgType.EVICT_MODIFIED) & is_home
        mem_write = mem_write | mk
        mem_val = where(mk, v, mem_val)
        drop = mk & (ds == _EM) & sv_test(dshw, snd)
        upd_dir = upd_dir | drop
        nd_state = where(drop, const(_DU), nd_state)
        nd_shw = sv_where(drop, [zero] * SW, nd_shw)

        # --- NACK re-serve (robust mode) ------------------------------
        if nack:
            mk = typ(MsgType.NACK) & is_home
            rd = mk & (aux == 0)
            wr = mk & (aux != 0)
            upd_dir = upd_dir | mk
            nd_state = where(rd, const(_DS), nd_state)
            nd_state = where(wr, const(_EM), nd_state)
            nd_shw = sv_where(rd, [x | y for x, y in zip(nd_shw, sr_bitw)],
                              nd_shw)
            nd_shw = sv_where(wr, sr_bitw, nd_shw)
            put(sA0, rd, sr, pack(int(MsgType.REPLY_RD), a, aux=mem_blk))
            put(sA0, wr, sr, pack(int(MsgType.REPLY_WR), a))

        # apply phase-A updates: one word write per structure
        cw_val = (
            nl_state | (nl_val << _CW_VAL_SHIFT)
            | ((nl_addr + 1) << _CW_ADDR_SHIFT)
        )
        cachew = write(s["cachew"], ci, upd_line, cw_val)
        new_mem = where(mem_write, mem_val, mem_blk)
        new_ds = where(upd_dir, nd_state, ds)
        new_shw = sv_where(upd_dir, nd_shw, dshw)
        dw_val = new_mem | (new_ds << _DW_STATE_SHIFT)
        if split:
            dirsp = [write(s[f"dirs{w}"], blk, upd_dir, new_shw[w])
                     for w in range(SW)]
        else:
            dw_val = dw_val | (new_shw[0] << _DW_SH_SHIFT)
            dirsp = []
        dirw = write(s["dirw"], blk, mem_write | upd_dir, dw_val)

        # ===== phase B: instruction issue ============================
        tr_len = s["tr_len"]
        elig = (
            (count2 == 0) & (waiting == 0) & ~blocked & (pc_in < tr_len)
        )
        if "phase_b" in ablate:  # no node issues
            elig = false
        t_dim = s["tr"].shape[1]
        wi = read(s["tr"], pc_in.clamp(max=t_dim - 1))
        op = wi & 1
        iv = (wi >> 1) & 0xFF
        ia = wi >> _TR_ADDR_SHIFT
        ci2 = torch.remainder(ia, c)
        home2 = torch.div(ia, m, rounding_mode="floor")

        cw2 = read(cachew, ci2)
        l2_state = cw2 & 3
        l2_val = (cw2 >> _CW_VAL_SHIFT) & 0xFF
        l2_addr = ((cw2 >> _CW_ADDR_SHIFT) & _ADDR_MASK) - 1
        hit = (l2_addr == ia) & (l2_state != _I)
        is_rd = elig & (op == 0)
        is_wr = elig & (op == 1)

        sB0, sB1 = slot(), slot()
        rm = is_rd & ~hit
        wm = is_wr & ~hit
        ev_issue = evict_msg(sB0, rm | wm, l2_addr, l2_val, l2_state)
        put(sB1, rm, home2, pack(int(MsgType.READ_REQUEST), ia))
        put(sB1, wm, home2, pack(int(MsgType.WRITE_REQUEST), ia, aux=iv))
        wh_me = is_wr & hit & ((l2_state == _M) | (l2_state == _E))
        wh_s = is_wr & hit & (l2_state == _S)
        put(sB1, wh_s, home2, pack(int(MsgType.UPGRADE), ia))

        pending_write = where(is_wr, iv, pw_in)
        waiting = where(rm | wm | wh_s, const(1), waiting)

        i_upd = rm | wm | wh_me | wh_s
        n2_addr = where(rm | wm, ia, l2_addr)
        n2_val = where(rm | wm, zero, where(wh_me | wh_s, iv, l2_val))
        n2_state = where(
            rm | wm, const(_I), where(wh_me | wh_s, const(_M), l2_state)
        )
        cw2_val = (
            n2_state | (n2_val << _CW_VAL_SHIFT)
            | ((n2_addr + 1) << _CW_ADDR_SHIFT)
        )
        cachew = write(cachew, ci2, i_upd, cw2_val)
        pc = pc_in + elig.to(I32)

        # deferred sends merge back into their candidate slots as
        # already-packed words (blocked nodes made no fresh sends)
        def merge_slot(sl, k):
            pv = dv[:, k, :] != 0
            words = [s[f"ob{w}"][:, k, :] for w in range(W)]
            old_recv = (
                dec(words, "recv") - 1 if recv_packed
                else s["ob_recv"][:, k, :]
            )
            sl["recv"] = where(pv, old_recv, sl["recv"])
            sl["w"] = [where(pv, words[w], sl["w"][w]) for w in range(W)]

        merge_slot(sA0, 0)
        merge_slot(sA1, 1)
        pend_inv = dv[:, 2, :] != 0
        ob2 = [s[f"ob{w}"][:, 2, :] for w in range(W)]
        if split:
            ob2_shw = [dec(ob2, f"shr{w}") for w in range(SW)]
        else:
            ob2_shw = [dec(ob2, "aux")]
        inv_shw = sv_where(pend_inv, ob2_shw, inv_shw)
        inv_addr = where(pend_inv, dec(ob2, "addr"), inv_addr)
        merge_slot(sB0, 3)
        merge_slot(sB1, 4)

        # ===== phase C: deterministic delivery =======================
        sinv = {"recv": neg1, "w": pack(int(MsgType.INV), inv_addr)}
        slots5 = (sA0, sA1, sinv, sB0, sB1)
        sender_w, sender_off, _ = layout["sender"]
        base_sender = gids << sender_off
        words5 = [
            [
                sl["w"][w] | base_sender if w == sender_w else sl["w"][w]
                for w in range(W)
            ]
            for sl in slots5
        ]

        return dict(
            cachew=cachew, dirw=dirw, dirsp=dirsp, qdata=qdata,
            count2=count2, waiting=waiting, waiting_in=waiting_in,
            pending_write=pending_write, pc=pc, pc_in=pc_in, elig=elig,
            mb_count_in=mb_count_in, tr_len=tr_len, dv=dv,
            rh=is_rd & hit, rm=rm, wh=is_wr & hit, wm=wm,
            ev=ev_replyrd | ev_flush | ev_issue, inv_applied=inv_applied,
            slots5=slots5, words5=words5, inv_shw=inv_shw,
            inv_addr=inv_addr, sv_test=sv_test)

    return ab


def build_cycle(config: SystemConfig, snapshots: bool = True,
                packed: bool = False, ablate: frozenset = frozenset(),
                axis_name=None, shards: int = 1,
                exchange_slots: Optional[int] = None,
                cycle: str = "kernel"):
    """The cycle function ``state dict -> state dict`` for ``config``.
    The dict holds the carried planes plus ``tr`` [N, T, B] (the trace
    window) and ``tr_len`` [N, B].  ``ablate`` names stubbed stages
    (:data:`ABLATE_STAGES`); an ablated cycle is wrong by design.

    ``axis_name`` (this rank's ``parallel/comm.py`` node group) with
    ``shards > 1`` builds K1's node-sharded variant (JAX
    ``pallas_engine.py:545-620``) instead: ``ops/node_cycle.py:
    NodeCycle``, four kernels on the card (``cycle="tensor"``: their
    plain versions there too) around the targeted exchange, called as
    ``cycle(s, seg)`` on this rank's block of the planes with the whole
    trace plane; ``exchange_slots`` caps a peer's exchange buffer
    (default the capacity-exact ``5 * n_local``, which cannot
    overflow)."""
    ablate = ablate_set(ablate)
    _check_geometry(config)
    _check_semantics(config)
    if axis_name is not None and not hasattr(axis_name, "all_reduce"):
        raise ValueError(
            f"axis_name={axis_name!r}: the port's node axis is a "
            "parallel/comm.py NodeComm (this rank's node group), not a "
            "mesh axis name")
    if axis_name is not None and shards > 1:
        if ablate:
            raise ValueError("--ablate is single-node-shard only")
        from hpa2_tpu_torch.ops.node_cycle import NodeCycle

        return NodeCycle(config, snapshots, packed, axis_name, shards,
                         exchange_slots, cycle)
    n, cap = config.num_procs, config.msg_buffer_size
    layout, W = _mb_layout(config)
    recv_packed = "recv" in layout
    split = _split_mode(config)
    SW = _sharer_words(config)
    phase_ab = build_phase_ab(config, ablate)

    def dec(words, name):
        return field(layout, words, name)

    def cycle(s: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        dev = s["nsw"].device
        bb = s["nsw"].shape[1]
        zero = torch.zeros((n, bb), dtype=I32, device=dev)
        neg1 = torch.full((n, bb), -1, dtype=I32, device=dev)
        iota_n = torch.arange(n, dtype=I32, device=dev)[:, None].expand(
            n, bb)

        def where(mask, a, b):
            return torch.where(mask, a, b)

        v = phase_ab(s, iota_n)
        cachew, dirw, dirsp, qdata = (v["cachew"], v["dirw"], v["dirsp"],
                                      v["qdata"])
        count2, waiting, pending_write, pc = (
            v["count2"], v["waiting"], v["pending_write"], v["pc"])
        waiting_in, pc_in, mb_count_in, tr_len, dv = (
            v["waiting_in"], v["pc_in"], v["mb_count_in"], v["tr_len"],
            v["dv"])
        slots5, words5, inv_shw, sv_test = (
            v["slots5"], v["words5"], v["inv_shw"], v["sv_test"])
        sA0, sA1 = slots5[0], slots5[1]
        elig = v["elig"]
        slsc = _scalar_layout(config, s["tr"].shape[1])

        mbs = qdata
        acc = zero                       # running enqueue offset
        acc_masks = [[zero] * n for _ in range(_NSLOTS)]
        # the deliver stub walks no candidate: nothing is accepted
        senders = range(0 if "deliver" in ablate else n)

        def enqueue(mbs, acc, valid, words_r):
            pos = count2 + acc
            accepted = valid & (pos < cap)
            ix = pos.clamp(max=cap - 1).long()[:, None, :]
            mbs = [
                mbs[w].scatter(1, ix, where(
                    accepted, words_r[w].expand(n, bb),
                    torch.gather(mbs[w], 1, ix).squeeze(1))[:, None, :])
                for w in range(W)
            ]
            return mbs, acc + accepted.to(I32), accepted

        # a sender's three phase-A slots are receiver-disjoint, so
        # they deliver as one candidate (the word a per-receiver
        # select)
        for sender in senders:
            vA0 = iota_n == sA0["recv"][sender][None, :]
            vA1 = iota_n == sA1["recv"][sender][None, :]
            vInv = sv_test(
                [x[sender][None, :].expand(n, bb) for x in inv_shw],
                iota_n)
            wsel = [
                where(vA1, words5[1][w][sender][None, :],
                      where(vInv, words5[2][w][sender][None, :],
                            words5[0][w][sender][None, :]))
                for w in range(W)
            ]
            mbs, acc, accepted = enqueue(mbs, acc, vA0 | vA1 | vInv,
                                         wsel)
            acc_masks[0][sender] = (vA0 & accepted).to(I32)
            acc_masks[1][sender] = (vA1 & accepted).to(I32)
            acc_masks[2][sender] = (vInv & accepted).to(I32)
        for sender in senders:
            for k in (3, 4):
                valid = iota_n == slots5[k]["recv"][sender][None, :]
                words_r = [words5[k][w][sender][None, :]
                           for w in range(W)]
                mbs, acc, accepted = enqueue(mbs, acc, valid, words_r)
                acc_masks[k][sender] = accepted.to(I32)

        # [S(sender), 5, R(receiver), B]
        accs = torch.stack(
            [torch.stack(acc_masks[k], 0) for k in range(_NSLOTS)], 1
        )
        dcount = _isum(accs, 2)                        # [S, 5, B]
        # the INV remainder: the fan-out mask minus accepted
        # receivers
        remaining = []
        for w in range(SW):
            lo = w * _SPLIT_BPW
            hi = min(n, lo + _SPLIT_BPW)
            rbit = torch.arange(hi - lo, dtype=I32,
                                device=dev)[None, :, None]
            remaining.append(
                inv_shw[w] & ~_isum(accs[:, 2, lo:hi] << rbit, 1))

        rem_any = remaining[0]
        for w in range(1, SW):
            rem_any = rem_any | remaining[w]

        md = _isum(dcount, (0, 1))                             # [B]
        type_arr = torch.stack(
            [dec(words5[k], "type") for k in range(_NSLOTS)], 1
        )                                                      # [S, 5, B]
        mc = torch.zeros((_NTYPES, bb), dtype=I32, device=dev)
        mc.scatter_add_(0, type_arr.reshape(-1, bb).long(),
                        dcount.reshape(-1, bb))

        rej = [
            ((dcount[:, k, :] == 0) & (slots5[k]["recv"] >= 0)).to(I32)
            for k in (0, 1, 3, 4)
        ]
        # non-deferred slots write a zero word, so deferred_valid() of
        # the next cycle is exact
        defer5 = [rej[0], rej[1], (rem_any != 0).to(I32), rej[2], rej[3]]
        recvs5 = [sl["recv"] for sl in slots5]
        rem_fields = (
            [(f"shr{w}", remaining[w]) for w in range(SW)] if split
            else [("aux", remaining[0])]
        )
        ob_new = []
        for w in range(W):
            ws = [words5[k][w] for k in range(_NSLOTS)]
            for fname, rw in rem_fields:
                fw, foff, _ = layout[fname]
                if fw == w:
                    ws[2] = ws[2] | (rw << foff)
            if recv_packed and w == layout["recv"][0]:
                recv_off = layout["recv"][1]
                ws = [
                    wk | ((recvs5[k] + 1) << recv_off)
                    for k, wk in enumerate(ws)
                ]
            ws = [where(defer5[k] != 0, wk, zero) for k, wk in enumerate(ws)]
            ob_new.append(torch.stack(ws, 1))
        if "deliver" in ablate:
            # sends vanish without deferral: the outbox is cleared and
            # no node is blocked
            z5 = torch.zeros((n, _NSLOTS, bb), dtype=I32, device=dev)
            ob_new = [z5] * W
            defer5 = [zero] * _NSLOTS
        blocked_next = (
            defer5[0] + defer5[1] + defer5[2] + defer5[3] + defer5[4]
        ) > 0

        mb_count3 = count2 + acc
        ov_inc = _isum(mb_count3 > cap, 0).clamp(max=1)

        out = {
            "cachew": cachew, "dirw": dirw,
            "nsw": (
                mb_count3
                | (waiting << slsc["off_wait"])
                | (pending_write << slsc["off_pw"])
                | (pc << slsc["off_pc"])
            ),
            "tr": s["tr"], "tr_len": s["tr_len"],
        }
        if not recv_packed:
            out["ob_recv"] = torch.stack(
                [where(defer5[k] != 0, recvs5[k], neg1)
                 for k in range(_NSLOTS)], 1
            )
        for w in range(len(dirsp)):
            out[f"dirs{w}"] = dirsp[w]
        for w in range(W):
            out[f"mb{w}"] = mbs[w]
            out[f"ob{w}"] = ob_new[w]

        # ===== phase D: dump-at-local-completion snapshots ===========
        if snapshots:
            done_node = (
                (pc >= tr_len) & (waiting == 0) & (mb_count3 == 0)
                & ~blocked_next
            )
            taken = s["snap_taken"] != 0
            s2 = (done_node & ~taken)[:, None, :]
            out["snap_taken"] = (taken | done_node).to(I32)
            out["snap_cachew"] = where(s2, cachew, s["snap_cachew"])
            out["snap_dirw"] = where(s2, dirw, s["snap_dirw"])
            for w in range(len(dirsp)):
                out[f"snap_dirs{w}"] = where(s2, dirsp[w],
                                             s[f"snap_dirs{w}"])

        # ===== counters ==============================================
        def row(x):
            return _isum(x, 0)

        sc = s["scalars"]
        # a lane accrues a cycle only while it has outstanding work
        # at cycle start, so the count does not depend on the gate
        lane_active = (
            _isum((s["tr_len"] - pc_in).clamp(min=0), 0)
            + _isum(waiting_in, 0)
            + _isum(mb_count_in, 0)
            + _isum(dv, (0, 1))
        )
        inc = torch.stack([
            lane_active.clamp(max=1), row(elig), md, ov_inc,
            row(v["rh"]), row(v["rm"]), row(v["wh"]), row(v["wm"]),
            row(v["ev"]), row(v["inv_applied"]),
        ], 0)
        row_sc = torch.arange(_NSCALAR, device=dev)[:, None]
        # the overflow row is sticky (max), every other row accumulates
        out["scalars"] = where(row_sc == _SC_OVERFLOW,
                               torch.maximum(sc, inc), sc + inc)
        out["msg_counts"] = s["msg_counts"] + mc
        return out

    if not packed:
        return cycle

    pdt = {f: TORCH_DTYPES[d] for f, d in packed_plane_dtypes(config).items()}
    prefixes = [""] + (["snap_"] if snapshots else [])

    def packed_cycle(s: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The same cycle over the narrow planes, widened at entry and
        narrowed at exit (lossless both ways)."""
        wide = dict(s)
        for pre in prefixes:
            wide[f"{pre}cachew"] = _widen_cache(
                *(wide.pop(pre + f) for f in _PACKED_CACHE))
            wide[f"{pre}dirw"] = _widen_dir(
                *(wide.pop(pre + f) for f in _PACKED_DIR))
        out = cycle(wide)
        for pre in prefixes:
            out[f"{pre}cvalw"], out[f"{pre}cmetaw"] = _narrow_cache(
                out.pop(f"{pre}cachew"), pdt["cmetaw"])
            out[f"{pre}dmemw"], out[f"{pre}dmetaw"] = _narrow_dir(
                out.pop(f"{pre}dirw"), pdt["dmetaw"])
        return out

    return packed_cycle
