"""The lockstep cycle of the general engine: handle -> issue -> deliver
-> snapshot, the port of ``hpa2_tpu/ops/step.py``.

Semantics are exactly the JAX step's (``build_step``, l.173), which are
the spec engine's: every node handles at most one message a cycle (the
13 handler bodies are masked updates merged by type), each cycle's
outgoing messages form a fixed candidate grid ordered by (phase,
sender, slot), an exclusive prefix sum per receiver assigns mailbox
positions, candidates that do not fit defer to the sender's outbox,
and a node that finishes snapshots its planes.  Link faults, topology
delays, the directory formats and the protocol variants are
Python-time branches (l.239-290), so a fault-free, ideal, MESI/full
build runs none of their ops.

Where the port departs from the JAX code, and why:

* **An explicit batch axis.**  The JAX step is written for one system
  and vmapped (``hpa2_tpu/ops/engine.py:437-441``).  Here every tensor
  is ``[B, N, ...]`` and one system is ``B = 1``: ``torch.func.vmap``
  fails on in-place ops and on some indexing, and it would hide the
  shapes the card needs.  Per-system reductions (``jnp.sum`` over the
  node axis of one system) are reductions over every axis but the
  first.
* **uint32 words as int32 bits.**  Sharer words and PRNG keys are int32
  tensors with the bits of the JAX uint32 words (``ops/bits.py``,
  ``ops/prng.py``); a word read as a number is widened to int64 first,
  where ``>>`` is logical.
* **int32 reductions.**  ``torch.sum``/``cumsum`` of int32 return int64
  where ``jnp`` keeps int32, so every counter and prefix sum passes
  ``dtype=torch.int32``.
* **Gathers, not one-hot sums.**  ``_gather_n`` (l.86-108) is a one-hot
  reduction, a TPU workaround; the port uses ``torch.gather``, whose
  indices are in range here by construction (cache index, block,
  clamped pc).  The one place an index can fall outside (the combining
  table's addresses of non-read candidates) is clamped to a neutral
  entry.  Mailbox placement (l.1260-1306, a bf16 byte-plane matmul on
  the MXU) is one ``scatter`` of every accepted candidate to its slot,
  the rejected ones to a trash slot past the end.
* **No integer matmuls.**  CUDA has none, so the faults' same-sender
  stall (an int32 ``einsum``, l.1154-1161) is a float32 product of 0/1
  matrices, exact at any size this engine takes.
* **The drop draw.**  ``floor(log(u) / log(p))`` in float32 depends on
  the device's ``log``.  The port compares ``u`` with thresholds
  (:func:`failure_thresholds`) computed on the host from the float32
  formula, so the CPU and the card count the same retransmissions as
  the JAX step does on the CPU.
* **Control flow on the card.**  ``lax.cond`` between fast-forward and
  lockstep (``build_elided_body``, l.1886) and the ``while_loop`` of
  ``build_run`` (l.1916) become the runs of :class:`Run`: on the CPU a
  host loop; on the card a captured CUDA graph of ``chunk`` gated steps
  (``state = where(go, step(state), state)``), so the host reads the
  loop condition once a chunk.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from hpa2_tpu_torch.config import SystemConfig
from hpa2_tpu_torch.models.protocol import MsgType
from hpa2_tpu_torch.ops import bits, prng
from hpa2_tpu_torch.ops.state import (
    MB_ADDR,
    MB_SECOND,
    MB_SENDER,
    MB_SHARERS,
    MB_TYPE,
    MB_VALUE,
    SimState,
)
from hpa2_tpu_torch.protocols.compiler import (
    ProtocolPlanes, planes_for, state_in,
)
from hpa2_tpu_torch.protocols.directory import group_mask_words, parse_format

I32 = torch.int32

_INVALID_ADDR = -1
_NO_MSG = -1
_INV = int(MsgType.INV)
_N_TYPES = len(MsgType)


def _gather(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr [B, N, K], idx [B, N] -> [B, N] (one element per row)."""
    return arr.gather(2, idx.to(torch.int64).unsqueeze(-1)).squeeze(-1)


def _gather_w(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """arr [B, N, K, W], idx [B, N] -> [B, N, W]."""
    i = idx.to(torch.int64)[:, :, None, None].expand(
        arr.shape[0], arr.shape[1], 1, arr.shape[3])
    return arr.gather(2, i).squeeze(2)


def _count(mask: torch.Tensor) -> torch.Tensor:
    """Per-system count of a [B, ...] bool mask -> [B] int32."""
    return mask.reshape(mask.shape[0], -1).sum(dim=1, dtype=I32)


def failure_thresholds(p: float, max_retries: int) -> torch.Tensor:
    """Ascending float32 thresholds ``t`` of the retransmission count:
    ``min(floor(log(u) / log(p)), max_retries)`` (float32, the JAX step,
    l.1137-1143) equals the number of thresholds ``>= u`` for every
    float32 ``u`` in ``[1e-37, 1)``.

    The formula is monotone in ``u``, so ``count >= k`` holds exactly for
    ``u`` at or below some float32 ``t_k``.  Each ``t_k`` is found on the
    host by evaluating the float32 formula (CPU ``log``, which agrees
    with XLA's on the CPU) over a window of float32 values around
    ``p**k``; a ``k`` no ``u >= 1e-37`` reaches gets -1."""
    lo_u = np.float32(1e-37)
    log_p = torch.log(torch.tensor(p, dtype=torch.float32))
    half = 1 << 16
    out = []
    for k in range(1, max_retries + 1):
        center = np.float32(p ** k)
        if center < lo_u / 2:
            out.append(-1.0)
            continue
        c_bits = int(np.array(center, np.float32).view(np.int32))
        cand = np.arange(c_bits - half, c_bits + half + 1, dtype=np.int64)
        cand = cand[(cand >= np.array(lo_u).view(np.int32))
                    & (cand < np.array(np.float32(1.0)).view(np.int32))]
        if len(cand) == 0:  # the whole window lies below 1e-37
            out.append(-1.0)
            continue
        u = torch.from_numpy(cand.astype(np.int32)).view(torch.float32)
        cnt = torch.floor(torch.log(u) / log_p)
        ok = (cnt >= k).numpy()
        # ok must be a prefix of the ascending window, ending inside it
        edge = int(ok.sum())
        if not (ok[:edge].all() and not ok[edge:].any()):
            raise RuntimeError(
                f"retransmission count is not monotone near {p}**{k}")
        if edge == 0 and cand[0] > np.array(lo_u).view(np.int32):
            raise RuntimeError(f"threshold window misses {p}**{k}")
        if edge == len(cand) and cand[-1] + 1 < np.array(
                np.float32(1.0)).view(np.int32):
            raise RuntimeError(f"threshold window misses {p}**{k}")
        out.append(float(u[edge - 1]) if edge else -1.0)
    return torch.tensor(sorted(out), dtype=torch.float32)


class _SendSlots:
    """One point-message slot per sender per phase: ``[B, N]`` fields
    and ``[B, N, W]`` sharer words."""

    def __init__(self, like: torch.Tensor, w: int):
        b, n = like.shape
        self.valid = torch.zeros_like(like, dtype=torch.bool)
        self.recv = torch.zeros_like(like)
        self.type = torch.full_like(like, _NO_MSG)
        self.addr = torch.zeros_like(like)
        self.value = torch.zeros_like(like)
        self.sharers = torch.zeros((b, n, w), dtype=I32, device=like.device)
        self.second = torch.full_like(like, -1)

    def put(self, mask, recv, type_, addr, value=None, sharers=None,
            second=None):
        """Masked write into the slot (types are mutually exclusive per
        cycle, so masks never overlap)."""
        self.valid = self.valid | mask
        self.recv = torch.where(mask, recv, self.recv)
        self.type = torch.where(mask, type_, self.type)
        self.addr = torch.where(mask, addr, self.addr)
        if value is not None:
            self.value = torch.where(mask, value, self.value)
        if sharers is not None:
            self.sharers = torch.where(mask[..., None], sharers,
                                       self.sharers)
        if second is not None:
            self.second = torch.where(mask, second, self.second)


def _evict_msg(slots, mask, line_addr, line_val, line_state, mem_size, P):
    """handleCacheReplacement (assignment.c:742-773) as a masked send:
    EVICT_SHARED for clean victims, EVICT_MODIFIED (with value) for the
    protocol's dirty states (``P.dirty_evict_states``)."""
    victim_valid = mask & (line_addr != _INVALID_ADDR) & (line_state != P.I)
    home = line_addr.clamp(min=0) // mem_size
    is_mod = state_in(line_state, P.dirty_evict_states, P.n_cache_states)
    slots.put(
        victim_valid,
        recv=home,
        type_=torch.where(is_mod, int(MsgType.EVICT_MODIFIED),
                          int(MsgType.EVICT_SHARED)).to(I32),
        addr=line_addr,
        value=line_val,
    )
    return victim_valid


def _word0(flag, w: int, like: torch.Tensor) -> torch.Tensor:
    """[B, N, W] words carrying ``flag`` (an int or a [B, N] tensor) in
    word 0 (a REPLY_RD flag), the rest zero."""
    out = torch.zeros(like.shape + (w,), dtype=I32, device=like.device)
    out[..., 0] = flag
    return out


def build_step(
    config: SystemConfig,
    replay: bool = False,
    axis_name: Optional[str] = None,
    shards: int = 1,
    planes: Optional[ProtocolPlanes] = None,
):
    """Build the batched step ``step(st: SimState) -> SimState``.

    Node sharding (``axis_name``, ``shards > 1``) is ROADMAP queue 1
    item 4 and raises here."""
    if axis_name is not None or shards != 1:
        raise ValueError(
            "node sharding is not ported yet (ROADMAP queue 1 item 4); "
            "build the single-shard step")
    n = config.num_procs
    c = config.cache_size
    m = config.mem_size
    w = config.sharer_words
    cap = config.msg_buffer_size
    sem = config.semantics
    P = planes if planes is not None else planes_for(config.protocol, sem)
    NC = P.n_cache_states
    _M, _I = P.M, P.I
    _EM, _DS, _DU, _SO = P.EM, P.DS, P.DU, P.SO
    if len(P.reply_rd_fill) != 2:
        raise ValueError(
            f"the {P.protocol} table compiles to "
            f"{len(P.reply_rd_fill)} REPLY_RD fill kinds; the kernel "
            "lowering needs exactly two (a flag-selected pair)"
        )
    dir_kind, dir_param = parse_format(config.directory_format, n)
    if sem.overloaded_evict_shared_notify:
        raise ValueError(
            "the general engine implements fixture semantics only; the "
            "overloaded EVICT_SHARED notify (HEAD quirk) is available "
            "in the JAX package's Python spec engine"
        )
    if config.messages_per_cycle != 1:
        raise ValueError(
            "the general engine drains one message per node per cycle; "
            "messages_per_cycle > 1 runs on the JAX package's spec engine"
        )
    nack = sem.intervention_miss_policy == "nack"
    fault = config.fault
    fault_on = fault.enabled  # static: fault-free builds add zero ops
    drop_p = float(fault.drop)
    j0 = 5 * n

    ic = config.interconnect
    topo_on = ic.enabled
    if topo_on:
        if replay:
            raise ValueError(
                "replay mode supports the ideal topology only"
            )
        from hpa2_tpu_torch.interconnect.topology import build_topology

        topo = build_topology(ic.topology, n, ic.hop_latency)
        send_np = np.concatenate(
            [np.repeat(np.arange(n), 3), np.repeat(np.arange(n), 2)]
        )
        paths_np = topo.path_mat[send_np]  # [J0, N, L] bool
        if paths_np.shape[2] == 0:  # linkless (n == 1): keep L >= 1
            paths_np = np.zeros((5 * n, n, 1), dtype=bool)
        base_np = np.maximum(topo.base_lat[send_np], 1).astype(np.int32)
        n_links = paths_np.shape[2]
        mb_deliver = 5 + w  # deliver-at column (after sharer words)

    if dir_kind == "limited":
        _all_int = (1 << n) - 1
        all_words = [(_all_int >> (32 * i)) & 0xFFFFFFFF for i in range(w)]
    elif dir_kind == "coarse":
        gm_np = group_mask_words(dir_param, n, w, 32)

    # static per-candidate tables of the flat grid: A grid (3 slots a
    # node, node-major) then B grid (2 slots a node)
    sender_np = np.concatenate(
        [np.repeat(np.arange(n), 3), np.repeat(np.arange(n), 2)]
    ).astype(np.int32)
    is_inv_np = np.concatenate(
        [np.tile([False, False, True], n), np.zeros(2 * n, bool)]
    )
    # candidate j precedes k on one sender's edge (the grid id is the
    # flat index on one shard)
    gid = np.arange(j0)
    same_sender_np = (sender_np[:, None] == sender_np[None, :]) & (
        gid[:, None] > gid[None, :]
    )

    @functools.lru_cache(maxsize=8)
    def consts(device):
        d = torch.device(device)
        t = lambda a, dt=I32: torch.as_tensor(a).to(dtype=dt, device=d)
        out = dict(
            node_ids=torch.arange(n, dtype=I32, device=d),
            sender=t(sender_np),
            is_inv=t(is_inv_np, torch.bool),
            slot_c=torch.arange(c, dtype=I32, device=d),
            slot_m=torch.arange(m, dtype=I32, device=d),
            node_bits=bits.bit_mask(torch.arange(n, device=d), w),
            slot_is_inv=t([False, False, True, False, False], torch.bool),
        )
        if fault_on:
            app = np.ones((n, j0), bool)
            if fault.edge_sender != -1:
                app &= (sender_np == fault.edge_sender)[None, :]
            if fault.edge_receiver != -1:
                app &= (np.arange(n) == fault.edge_receiver)[:, None]
            out["applies"] = t(app, torch.bool)
            out["same_sender_t"] = t(same_sender_np.T, torch.float32)
            if 0.0 < drop_p < 1.0:
                out["thresholds"] = failure_thresholds(
                    drop_p, fault.max_retries).to(d)
            for name, p in (("p_dup", fault.duplicate),
                            ("p_reo", fault.reorder),
                            ("p_del", fault.delay)):
                out[name] = torch.tensor(float(p), dtype=torch.float32,
                                         device=d)
        if topo_on:
            out["paths"] = t(paths_np, torch.bool)
            out["base"] = t(base_np)
        if dir_kind == "limited":
            out["all_words"] = bits.words_i32(all_words).to(d)
        elif dir_kind == "coarse":
            out["gm"] = t(gm_np)
        return out

    def step(st: SimState) -> SimState:
        K = consts(st.pc.device)
        node_ids = K["node_ids"]
        bsz = st.pc.shape[0]
        W = torch.where
        # nodes with deferred sends are blocked: no handle, no issue
        blocked = st.ob_valid.any(dim=2)

        # ============== phase A: handle one message per node ==========
        hm = st.mb_data[:, :, 0, :]
        has_msg = (st.mb_count > 0) & ~blocked
        if topo_on:
            has_msg = has_msg & (hm[..., mb_deliver] <= st.cycle[:, None])
        mt = W(has_msg, hm[..., MB_TYPE], _NO_MSG)
        snd = hm[..., MB_SENDER]
        a = hm[..., MB_ADDR].clamp(min=0)
        v = hm[..., MB_VALUE]
        msh = hm[..., MB_SHARERS:MB_SHARERS + w]
        sr = hm[..., MB_SECOND]

        # consume the head: shift the queue down one slot
        qdata = W(has_msg[:, :, None, None],
                  torch.roll(st.mb_data, -1, dims=2), st.mb_data)
        mb_count2 = st.mb_count - has_msg.to(I32)

        home = a // m
        blk = a % m
        ci = a % c
        is_home = node_ids == home
        is_second = node_ids == sr

        line_addr = _gather(st.cache_addr, ci)
        line_val = _gather(st.cache_val, ci)
        line_state = _gather(st.cache_state, ci)
        ds = _gather(st.dir_state, blk)
        dsh = _gather_w(st.dir_sharers, blk)
        mem_blk = _gather(st.mem, blk)
        pw = st.pending_write

        if P.has_owner_plane:
            dow = _gather(st.dir_owner, blk)

        line_match = line_addr == a
        owner = bits.find_owner(dsh)
        owner_is_snd = owner == snd
        snd_bit = bits.bit_mask(snd, w)

        def fanout(base):
            """REPLY_ID fan-out through the directory-format lens:
            (sharers minus requester) in, (mask, overflowed) out."""
            if dir_kind == "full":
                return base, None
            if dir_kind == "limited":
                over = bits.popcount(base) > dir_param
                allm = K["all_words"] & ~snd_bit
                return W(over[..., None], allm, base), over
            gm = K["gm"]  # [G, W] disjoint group masks
            hasg = ((base[:, :, None, :] & gm) != 0).any(dim=3)  # [B,N,G]
            # disjoint masks: the summed words are an exact OR
            spread = bits.i32(
                W(hasg[..., None], gm.to(torch.int64), 0).sum(dim=2))
            return spread & ~snd_bit, None

        sA0 = _SendSlots(st.pc, w)
        sA1 = _SendSlots(st.pc, w)
        inv_valid = torch.zeros_like(has_msg)
        inv_sharers = torch.zeros_like(msh)
        inv_addr = torch.zeros_like(st.pc)

        nl_addr, nl_val, nl_state = line_addr, line_val, line_state
        upd_line = torch.zeros_like(has_msg)
        nd_state, nd_sharers = ds, dsh
        if P.has_owner_plane:
            nd_owner = dow
        upd_dir = torch.zeros_like(has_msg)
        over_inc = (
            torch.zeros_like(st.cycle) if dir_kind == "limited" else None
        )
        mem_write = torch.zeros_like(has_msg)
        mem_val = mem_blk
        waiting = st.waiting

        def typ(t):
            return mt == int(t)

        # --- READ_REQUEST (home only; assignment.c:188-236) ----------
        mk = typ(MsgType.READ_REQUEST) & is_home
        du, dss, dem = ds == _DU, ds == _DS, ds == _EM
        excl = du | (dem & owner_is_snd)
        if P.has_so:
            dso = ds == _SO
            so_self = mk & dso & (dow == snd)
            so_fwd = mk & dso & (dow != snd)
            reply_mask = mk & (du | dss | (dem & owner_is_snd)) | so_self
            fwd = (mk & dem & ~owner_is_snd) | so_fwd
            fwd_to = W(so_fwd, dow, owner)
        elif P.has_fwd:
            live_f = dss & (dow >= 0) & (dow != snd)
            reply_mask = mk & (du | (dss & ~live_f) | (dem & owner_is_snd))
            fwd = mk & ((dem & ~owner_is_snd) | live_f)
            fwd_to = W(mk & live_f, dow, owner)
        else:
            reply_mask = mk & (du | dss | (dem & owner_is_snd))
            fwd = mk & dem & ~owner_is_snd
            fwd_to = owner
        excl_flag = W(excl, P.rr_u_flag, P.rr_s_flag).to(I32)
        sA0.put(
            reply_mask, recv=snd, type_=int(MsgType.REPLY_RD), addr=a,
            value=mem_blk, sharers=_word0(excl_flag, w, st.pc),
        )
        sA0.put(
            fwd, recv=fwd_to, type_=int(MsgType.WRITEBACK_INT), addr=a,
            second=snd,
        )
        upd_dir = upd_dir | (mk & (du | dss | fwd))
        nd_state = W(mk & du, _EM, nd_state)
        if P.has_so:
            upd_dir = upd_dir | so_self
            nd_state = W(fwd, _SO, nd_state)
            nd_state = W(so_self, _DS, nd_state)
            nd_owner = W(mk & dem & ~owner_is_snd, owner, nd_owner)
            nd_owner = W(so_self, -1, nd_owner)
        else:
            nd_state = W(fwd, _DS, nd_state)
            if P.has_fwd:
                nd_owner = W(
                    mk & ((dss & (dow != snd)) | (dem & ~owner_is_snd)),
                    snd, nd_owner,
                )
        nd_sharers = W((mk & du)[..., None], snd_bit, nd_sharers)
        share_join = mk & (dss | fwd)
        if P.has_so:
            share_join = share_join | so_self
        nd_sharers = W(share_join[..., None], nd_sharers | snd_bit,
                       nd_sharers)

        # --- REPLY_RD (assignment.c:238-247) -------------------------
        mk = typ(MsgType.REPLY_RD)
        ev = mk & ~line_match
        ev_replyrd = _evict_msg(sA0, ev, line_addr, line_val, line_state,
                                m, P)
        upd_line = upd_line | mk
        nl_addr = W(mk, a, nl_addr)
        nl_val = W(mk, v, nl_val)
        (_, rd_lo_fill), (rd_hi_flag, rd_hi_fill) = P.reply_rd_fill
        nl_state = W(
            mk,
            W(msh[..., 0] == rd_hi_flag, rd_hi_fill, rd_lo_fill).to(I32),
            nl_state,
        )
        waiting = W(mk, False, waiting)

        # --- WRITEBACK_INT (assignment.c:249-271) --------------------
        mk = typ(MsgType.WRITEBACK_INT)
        resp = state_in(line_state, P.wbint_resp_states, NC)
        ok = mk & line_match & resp
        if P.fwd_count_states:
            c2c = ok & state_in(line_state, P.fwd_count_states, NC)
            ok_home = ok & ~c2c
            second_mask = (ok_home & (sr != home)) | c2c
            fwd_inc = _count(c2c)
        else:
            ok_home = ok
            second_mask = ok & (sr != home)
            fwd_inc = None
        sA0.put(
            ok_home, recv=home, type_=int(MsgType.FLUSH), addr=a,
            value=line_val, second=sr,
        )
        sA1.put(
            second_mask, recv=sr, type_=int(MsgType.FLUSH), addr=a,
            value=line_val, second=sr,
        )
        upd_line = upd_line | ok
        nl_state = W(ok, P.wbint_next_state, nl_state)
        if nack:
            sA0.put(
                mk & ~(line_match & resp), recv=home,
                type_=int(MsgType.NACK), addr=a, second=sr,
            )

        # --- FLUSH (assignment.c:273-296) ----------------------------
        mk = typ(MsgType.FLUSH)
        mem_write = mem_write | (mk & is_home)
        mem_val = W(mk & is_home, v, mem_val)
        rq = mk & is_second
        ev = rq & ~line_match
        ev_flush = _evict_msg(sA0, ev, line_addr, line_val, line_state, m, P)
        upd_line = upd_line | rq
        nl_addr = W(rq, a, nl_addr)
        nl_val = W(rq, v, nl_val)
        nl_state = W(rq, P.flush_fill_state, nl_state)
        waiting = W(rq, False, waiting)

        # --- UPGRADE (home only; assignment.c:298-328) ---------------
        mk = typ(MsgType.UPGRADE) & is_home
        if P.has_so:
            trk = (ds == _DS) | (ds == _SO)
        else:
            trk = ds == _DS
        up_fan, up_over = fanout(dsh & ~snd_bit)
        reply_sh = W((mk & trk)[..., None], up_fan, 0)
        sA0.put(
            mk, recv=snd, type_=int(MsgType.REPLY_ID), addr=a,
            sharers=reply_sh,
        )
        upd_dir = upd_dir | mk
        nd_state = W(mk, _EM, nd_state)
        nd_sharers = W(mk[..., None], snd_bit, nd_sharers)
        if P.has_owner_plane:
            nd_owner = W(mk & trk, -1, nd_owner)
        if over_inc is not None:
            over_inc = over_inc + _count(mk & trk & up_over)

        # --- REPLY_ID (assignment.c:330-364) -------------------------
        mk = typ(MsgType.REPLY_ID)
        fill = mk & line_match & (line_state != _M)
        upd_line = upd_line | fill
        nl_val = W(fill, pw, nl_val)
        nl_state = W(fill, _M, nl_state)
        fan = mk & line_match
        inv_valid = inv_valid | fan
        inv_sharers = W(fan[..., None], msh & ~K["node_bits"], inv_sharers)
        inv_addr = W(fan, a, inv_addr)
        waiting = W(mk, False, waiting)

        # --- INV (assignment.c:366-373) ------------------------------
        mk = typ(MsgType.INV)
        inv_applied = mk & line_match & state_in(line_state, P.inv_states,
                                                 NC)
        upd_line = upd_line | inv_applied
        nl_state = W(inv_applied, _I, nl_state)

        # --- WRITE_REQUEST (home only; assignment.c:375-435) ---------
        mk = typ(MsgType.WRITE_REQUEST) & is_home
        if sem.eager_write_request_memory:
            mem_write = mem_write | mk
            mem_val = W(mk, v, mem_val)
        du, dss, dem = ds == _DU, ds == _DS, ds == _EM
        if P.has_so:
            dss = dss | (ds == _SO)
        wr_reply = mk & (du | (dem & owner_is_snd))
        sA0.put(wr_reply, recv=snd, type_=int(MsgType.REPLY_WR), addr=a)
        wr_id = mk & dss
        wr_fan, wr_over = fanout(dsh & ~snd_bit)
        sA0.put(
            wr_id, recv=snd, type_=int(MsgType.REPLY_ID), addr=a,
            sharers=wr_fan,
        )
        wr_fwd = mk & dem & ~owner_is_snd
        sA0.put(
            wr_fwd, recv=owner, type_=int(MsgType.WRITEBACK_INV), addr=a,
            second=snd,
        )
        upd_dir = upd_dir | (mk & (du | dss | wr_fwd))
        nd_state = W(mk & (du | dss), _EM, nd_state)
        nd_sharers = W((mk & (du | dss | wr_fwd))[..., None], snd_bit,
                       nd_sharers)
        if P.has_owner_plane:
            nd_owner = W(wr_id, -1, nd_owner)
        if over_inc is not None:
            over_inc = over_inc + _count(wr_id & wr_over)

        # --- REPLY_WR (assignment.c:437-449) -------------------------
        mk = typ(MsgType.REPLY_WR)
        upd_line = upd_line | mk
        nl_addr = W(mk, a, nl_addr)
        nl_val = W(mk, pw, nl_val)
        nl_state = W(mk, _M, nl_state)
        waiting = W(mk, False, waiting)

        # --- WRITEBACK_INV (assignment.c:451-473) --------------------
        mk = typ(MsgType.WRITEBACK_INV)
        wbinv_resp = state_in(line_state, P.wbinv_resp_states, NC)
        ok = mk & line_match & wbinv_resp
        sA0.put(
            ok, recv=home, type_=int(MsgType.FLUSH_INVACK), addr=a,
            value=line_val, second=sr,
        )
        sA1.put(
            ok & (sr != home), recv=sr, type_=int(MsgType.FLUSH_INVACK),
            addr=a, value=line_val, second=sr,
        )
        upd_line = upd_line | ok
        nl_state = W(ok, _I, nl_state)
        if nack:
            sA0.put(
                mk & ~(line_match & wbinv_resp), recv=home,
                type_=int(MsgType.NACK), addr=a,
                sharers=_word0(1, w, st.pc), second=sr,
            )

        # --- FLUSH_INVACK (assignment.c:475-496) ---------------------
        mk = typ(MsgType.FLUSH_INVACK)
        hmk = mk & is_home
        mem_write = mem_write | hmk
        mem_val = W(hmk, v, mem_val)
        upd_dir = upd_dir | hmk
        nd_state = W(hmk, _EM, nd_state)
        nd_sharers = W(hmk[..., None], bits.bit_mask(sr, w), nd_sharers)
        if P.has_owner_plane:
            nd_owner = W(hmk, -1, nd_owner)
        rq = mk & is_second
        upd_line = upd_line | rq
        nl_addr = W(rq, a, nl_addr)
        fill_val = v if sem.flush_invack_fills_old_value else pw
        nl_val = W(rq, fill_val, nl_val)
        nl_state = W(rq, _M, nl_state)
        waiting = W(rq, False, waiting)

        # --- EVICT_SHARED (home role; assignment.c:498-521) ----------
        mk = typ(MsgType.EVICT_SHARED) & is_home & bits.test_bit(dsh, snd)
        after = dsh & ~snd_bit
        cnt = bits.popcount(after)
        upd_dir = upd_dir | mk
        nd_sharers = W(mk[..., None], after, nd_sharers)
        nd_state = W(mk & (cnt == 0), _DU, nd_state)
        if P.has_so:
            es_trk = (ds == _DS) | (ds == _SO)
        else:
            es_trk = ds == _DS
        upg = mk & (cnt == 1) & es_trk
        nd_state = W(upg, _EM, nd_state)
        survivor = bits.find_owner(after)
        sA0.put(
            upg, recv=survivor, type_=int(MsgType.UPGRADE_NOTIFY), addr=a,
        )
        if P.has_so:
            nd_owner = W(mk & (ds == _SO) & (cnt <= 1), -1, nd_owner)
        elif P.has_fwd:
            nd_owner = W(mk & (ds == _DS) & ((cnt <= 1) | (dow == snd)),
                         -1, nd_owner)

        # --- UPGRADE_NOTIFY (fixture-semantics notify) ---------------
        mk = typ(MsgType.UPGRADE_NOTIFY) & (snd == home)
        hit = mk & line_match
        for _frm, _to in P.notify_pairs:
            pm = hit & (line_state == _frm)
            upd_line = upd_line | pm
            nl_state = W(pm, _to, nl_state)

        # --- EVICT_MODIFIED (home only; assignment.c:541-561) --------
        mk = typ(MsgType.EVICT_MODIFIED) & is_home
        mem_write = mem_write | mk
        mem_val = W(mk, v, mem_val)
        drop = mk & (ds == _EM) & bits.test_bit(dsh, snd)
        upd_dir = upd_dir | drop
        nd_state = W(drop, _DU, nd_state)
        nd_sharers = W(drop[..., None], 0, nd_sharers)
        if P.has_so:
            somod = mk & (ds == _SO) & (dow == snd)
            so_after = dsh & ~snd_bit
            upd_dir = upd_dir | somod
            nd_sharers = W(somod[..., None], so_after, nd_sharers)
            nd_state = W(
                somod,
                W(bits.popcount(so_after) == 0, _DU, _DS).to(I32),
                nd_state,
            )
            nd_owner = W(somod, -1, nd_owner)

        # --- NACK (robust mode re-serve) -----------------------------
        if nack:
            mk = typ(MsgType.NACK) & is_home
            rd = mk & (msh[..., 0] == 0)
            wr = mk & (msh[..., 0] != 0)
            sr_bit = bits.bit_mask(sr, w)
            upd_dir = upd_dir | mk
            nd_state = W(rd, _DS, nd_state)
            nd_state = W(wr, _EM, nd_state)
            nd_sharers = W(rd[..., None], nd_sharers | sr_bit, nd_sharers)
            nd_sharers = W(wr[..., None], sr_bit, nd_sharers)
            if P.has_owner_plane:
                if P.has_fwd:
                    nd_owner = W(rd, sr, nd_owner)
                else:
                    nd_owner = W(rd, -1, nd_owner)
                nd_owner = W(wr, -1, nd_owner)
            if P.nack_rd_flag:
                sA0.put(
                    rd, recv=sr, type_=int(MsgType.REPLY_RD), addr=a,
                    value=mem_blk,
                    sharers=_word0(P.nack_rd_flag, w, st.pc),
                )
            else:
                sA0.put(
                    rd, recv=sr, type_=int(MsgType.REPLY_RD), addr=a,
                    value=mem_blk,
                )
            sA0.put(wr, recv=sr, type_=int(MsgType.REPLY_WR), addr=a)

        if P.has_owner_plane:
            xfer_inc = _count((nd_owner != dow) & (nd_owner >= 0))
        else:
            xfer_inc = None

        # scatter phase-A updates back into the SoA planes
        lmask = (K["slot_c"] == ci[..., None]) & upd_line[..., None]
        cache_addr = W(lmask, nl_addr[..., None], st.cache_addr)
        cache_val = W(lmask, nl_val[..., None], st.cache_val)
        cache_state = W(lmask, nl_state[..., None], st.cache_state)

        blk_hot = K["slot_m"] == blk[..., None]
        dmask = blk_hot & upd_dir[..., None]
        dir_state = W(dmask, nd_state[..., None], st.dir_state)
        dir_sharers = W(dmask[..., None], nd_sharers[:, :, None, :],
                        st.dir_sharers)
        if P.has_owner_plane:
            dir_owner = W(dmask, nd_owner[..., None], st.dir_owner)
        else:
            dir_owner = st.dir_owner
        mem = W(blk_hot & mem_write[..., None], mem_val[..., None], st.mem)

        # ============== phase B: instruction issue ====================
        elig = (mb_count2 == 0) & ~waiting & ~blocked & (st.pc < st.tr_len)
        if replay:
            lo = st.order_node.shape[1]
            pos = st.order_pos.clamp(max=lo - 1).to(torch.int64)
            cur = st.order_node.gather(1, pos[:, None])
            elig = elig & (node_ids == cur) & (
                st.order_pos < st.order_len)[:, None]

        pcc = st.pc.clamp(max=st.tr_op.shape[2] - 1)
        op = _gather(st.tr_op, pcc)
        ia = _gather(st.tr_addr, pcc)
        iv = _gather(st.tr_val, pcc)
        ci2 = ia % c
        home2 = ia // m

        l2_addr = _gather(cache_addr, ci2)
        l2_val = _gather(cache_val, ci2)
        l2_state = _gather(cache_state, ci2)
        hit = (l2_addr == ia) & (l2_state != _I)
        is_rd = elig & (op == 0)
        is_wr = elig & (op == 1)

        sB0 = _SendSlots(st.pc, w)
        sB1 = _SendSlots(st.pc, w)

        rm = is_rd & ~hit
        wm = is_wr & ~hit
        ev_issue = _evict_msg(sB0, rm | wm, l2_addr, l2_val, l2_state, m, P)
        sB1.put(rm, recv=home2, type_=int(MsgType.READ_REQUEST), addr=ia)
        sB1.put(
            wm, recv=home2, type_=int(MsgType.WRITE_REQUEST), addr=ia,
            value=iv,
        )
        wh_me = is_wr & hit & state_in(l2_state, P.silent_write_states, NC)
        wh_s = is_wr & hit & state_in(l2_state, P.upgrade_write_states, NC)
        sB1.put(wh_s, recv=home2, type_=int(MsgType.UPGRADE), addr=ia)

        pending_write = W(is_wr, iv, st.pending_write)
        waiting = waiting | rm | wm | wh_s

        i_upd = rm | wm | wh_me | wh_s
        miss = rm | wm
        wset = wh_me | wh_s
        n2_addr = W(miss, ia, l2_addr)
        n2_val = W(miss, 0, W(wset, iv, l2_val))
        n2_state = W(miss, _I, W(wset, _M, l2_state))
        l2mask = (K["slot_c"] == ci2[..., None]) & i_upd[..., None]
        cache_addr = W(l2mask, n2_addr[..., None], cache_addr)
        cache_val = W(l2mask, n2_val[..., None], cache_val)
        cache_state = W(l2mask, n2_state[..., None], cache_state)

        pc = st.pc + elig.to(I32)
        if replay:
            order_pos = st.order_pos + elig.any(dim=1).to(I32)
        else:
            order_pos = st.order_pos

        # merge deferred sends back into their candidate-grid slots
        def _merge_pending(slots, k):
            pv = st.ob_valid[..., k]
            slots.valid = slots.valid | pv
            slots.recv = W(pv, st.ob_recv[..., k], slots.recv)
            slots.type = W(pv, st.ob_type[..., k], slots.type)
            slots.addr = W(pv, st.ob_addr[..., k], slots.addr)
            slots.value = W(pv, st.ob_value[..., k], slots.value)
            slots.second = W(pv, st.ob_second[..., k], slots.second)
            slots.sharers = W(pv[..., None], st.ob_sharers[:, :, k],
                              slots.sharers)

        _merge_pending(sA0, 0)
        _merge_pending(sA1, 1)
        pend_inv = st.ob_valid[..., 2]
        inv_valid = inv_valid | pend_inv
        inv_sharers = W(pend_inv[..., None], st.ob_sharers[:, :, 2],
                        inv_sharers)
        inv_addr = W(pend_inv, st.ob_addr[..., 2], inv_addr)
        _merge_pending(sB0, 3)
        _merge_pending(sB1, 4)

        # ============== phase C: deterministic delivery ===============
        # the candidate grid as [B, N, 5] fields (slots A0, A1, AINV,
        # B0, B1) and as the flat [B, J] order: phase A (sender-major,
        # 3 slots) then phase B (2 slots)
        slots5 = (sA0, sA1, None, sB0, sB1)

        def grid(name, inv_val):
            return torch.stack(
                [inv_val if s is None else getattr(s, name) for s in slots5],
                dim=2)

        def flat(g):
            lead = g.shape[:2]
            rest = g.shape[3:]
            return torch.cat(
                [g[:, :, :3].reshape((lead[0], 3 * lead[1]) + rest),
                 g[:, :, 3:].reshape((lead[0], 2 * lead[1]) + rest)], dim=1)

        zero_n = torch.zeros_like(st.pc)
        g_valid = grid("valid", inv_valid)
        g_recv = grid("recv", torch.full_like(st.pc, -1))
        g_type = grid("type", torch.full_like(st.pc, _INV))
        g_addr = grid("addr", inv_addr)
        g_value = grid("value", zero_n)
        g_second = grid("second", zero_n)
        g_sharers = grid("sharers", torch.zeros_like(inv_sharers))
        f_valid = flat(g_valid)
        f_recv = flat(g_recv)
        f_type = flat(g_type)
        f_addr = flat(g_addr)
        f_value = flat(g_value)
        f_second = flat(g_second)
        f_sharers = flat(g_sharers)            # [B, J, W]
        is_inv = K["is_inv"]                   # [J]
        sender = K["sender"]                   # [J]
        j = j0
        # INV fan masks ride the A grid's slot 2 (zero elsewhere)
        zw = torch.zeros_like(inv_sharers)
        mask_loc = flat(torch.stack(
            [zw, zw, inv_sharers, zw, zw], dim=2))
        pv_loc = f_valid & ~is_inv
        comb = mask_loc | f_sharers

        point_valid = f_valid & ~is_inv                      # [B, J]
        inv_mask_j = W(is_inv[:, None], comb, 0)             # [B, J, W]
        r_word = (node_ids // 32).to(torch.int64)
        r_bit = (node_ids % 32).to(torch.int64)
        inv_hit = ((bits.u32(inv_mask_j[:, :, r_word]) >> r_bit) & 1
                   ).bool().transpose(1, 2)                  # [B, N, J]
        valid_rj = (
            point_valid[:, None, :]
            & (f_recv[:, None, :] == node_ids[None, :, None])
        ) | inv_hit

        # -- link-layer fault injection (static no-op when fault-free) -
        if fault_on:
            keys = prng.split(st.rng_key, 5)                 # [B, 5, 2]
            k_drop, k_dup, k_reo, k_del = (keys[:, i] for i in range(4))
            rng_key = keys[:, 4]
            applies = K["applies"]                           # [N, J]
            if drop_p <= 0.0:
                failures = torch.zeros_like(valid_rj, dtype=I32)
            elif drop_p >= 1.0:
                failures = torch.full_like(valid_rj, fault.max_retries,
                                           dtype=I32)
            else:
                u = prng.uniform(k_drop, (n, j), minval=1e-37, maxval=1.0)
                thr = K["thresholds"]
                failures = (thr.shape[0] - torch.searchsorted(
                    thr, u.contiguous(), side="left")).to(I32)
            failures = W(applies & valid_rj, failures, 0)
            wire_fail = failures >= fault.max_retries
            # a candidate stalls behind a failed earlier one of its
            # sender (float 0/1 product: CUDA has no integer matmul)
            behind = torch.matmul(wire_fail.to(torch.float32),
                                  K["same_sender_t"])
            wire_stall = wire_fail | (behind > 0)
            valid_ok = valid_rj & ~wire_stall
        else:
            rng_key = st.rng_key
            valid_ok = valid_rj

        # capacity backpressure: accept valid candidates in global order
        # until the receiver's mailbox is full; the rest defer
        vok = valid_ok.to(I32)
        offs = torch.cumsum(vok, dim=2, dtype=I32) - vok
        avail = (cap - mb_count2).clamp(min=0)
        accept_rj = valid_ok & (offs < avail[..., None])
        delivered = accept_rj.sum(dim=2, dtype=I32)

        # -- interconnect delays (static no-op for the ideal topology) -
        zero_b = torch.zeros_like(st.cycle)
        if topo_on:
            paths_c = K["paths"]                             # [J, N, L]
            base_c = K["base"]                               # [J, N]
            acc_jr = accept_rj.transpose(1, 2)               # [B, J, N]
            use = acc_jr[..., None] & paths_c                # [B, J, N, L]
            contrib = use
            mc_saved_inc = comb_inc = zero_b
            if ic.multicast:
                u_i = use.to(I32)
                prior_r = torch.cumsum(u_i, dim=2, dtype=I32) - u_i
                saved = use & is_inv[:, None, None] & (prior_r > 0)
                contrib = contrib & ~saved
                mc_saved_inc = _count(saved)
            if ic.combining:
                jidx = torch.arange(j, dtype=torch.int64,
                                    device=st.pc.device)
                acc_any = acc_jr.any(dim=2)
                is_read = acc_any & (f_type == int(MsgType.READ_REQUEST))
                aidx = W(is_read, f_addr, 0).to(torch.int64)
                tbl = torch.full((bsz, n * m), j, dtype=torch.int64,
                                 device=st.pc.device).scatter_reduce(
                    1, aidx, W(is_read, jidx, j), reduce="amin")
                merged_rd = is_read & (tbl.gather(1, aidx) != jidx)
                contrib = contrib & ~merged_rd[..., None, None]
                comb_inc = _count(merged_rd)
            c_flat = contrib.reshape(bsz, j * n, n_links).to(I32)
            prefix = torch.cumsum(c_flat, dim=1, dtype=I32) - c_flat
            pen_flat = (
                (prefix // ic.link_bandwidth)
                * use.reshape(bsz, j * n, n_links).to(I32)
            ).sum(dim=2, dtype=I32)
            penalty = pen_flat.reshape(bsz, j, n)            # [B, J, N]
            deliver_rj = (st.cycle[:, None, None] + base_c + penalty
                          ).transpose(1, 2)                  # [B, N, J]
            load_l = c_flat.sum(dim=1, dtype=I32)            # [B, L]
            link_traversals = st.link_traversals + load_l
            link_max_load = torch.maximum(st.link_max_load, load_l)
            topo_delay_inc = W(acc_jr, base_c - 1 + penalty, 0).reshape(
                bsz, -1).sum(dim=1, dtype=I32)
        else:
            link_traversals = st.link_traversals
            link_max_load = st.link_max_load
            topo_delay_inc = mc_saved_inc = comb_inc = zero_b

        # place every accepted candidate at its slot count2 + offs (at
        # most one a slot); the rest go to a trash slot past the end
        fmat = torch.cat(
            [f_type[..., None], sender.expand(bsz, j)[..., None],
             f_addr[..., None], f_value[..., None], f_second[..., None],
             f_sharers], dim=2)                              # [B, J, F]
        nf = fmat.shape[2] + (1 if topo_on else 0)
        src = fmat[:, None].expand(bsz, n, j, fmat.shape[2])
        if topo_on:
            src = torch.cat([src, deliver_rj[..., None]], dim=3)
        pos = mb_count2[..., None] + offs                    # [B, N, J]
        slot = W(accept_rj, pos, cap).to(torch.int64)
        ext = torch.cat(
            [qdata, torch.zeros_like(qdata[:, :, :1])], dim=2)
        ext = ext.scatter(2, slot[..., None].expand(bsz, n, j, nf),
                          src.contiguous())
        mb_data = ext[:, :, :cap]
        mb_count3 = mb_count2 + delivered
        ov_now = (mb_count3 > cap).any(dim=1)

        # -- acceptance feedback to the senders -----------------------
        acc_j = accept_rj.sum(dim=1, dtype=I32)              # [B, J]
        # INV candidates read their accepted receivers' bits back: the
        # disjoint one-hot words summed are an exact OR
        acc_inv = accept_rj[:, :, 2:3 * n:3]                 # [B, Nr, Ns]
        delivered_inv = bits.i32(W(
            acc_inv[..., None], K["node_bits"].to(torch.int64)[:, None, :],
            0).sum(dim=1))                                   # [B, Ns, W]
        rejected_pt = pv_loc & (acc_j == 0)
        rejA = rejected_pt[:, :3 * n].reshape(bsz, n, 3)
        rejB = rejected_pt[:, 3 * n:].reshape(bsz, n, 2)
        rem_inv = inv_sharers & ~delivered_inv
        ob_valid = torch.stack(
            [rejA[..., 0], rejA[..., 1], (rem_inv != 0).any(dim=2),
             rejB[..., 0], rejB[..., 1]], dim=2)
        ob_sharers = W(K["slot_is_inv"][:, None], rem_inv[:, :, None, :],
                       g_sharers)
        blocked_next = ob_valid.any(dim=2)
        instr_inc = _count(elig)
        msgs_inc = _count(delivered)
        rd_hit_inc = _count(is_rd & hit)
        rd_miss_inc = _count(rm)
        wr_hit_inc = _count(is_wr & hit)
        wr_miss_inc = _count(wm)
        ev_inc = _count(ev_replyrd | ev_flush | ev_issue)
        inv_inc = _count(inv_applied)
        # sends by transaction type: the fan-out count of each candidate
        # bucketed by its type (rejected candidates count 0)
        mc_inc = torch.zeros((bsz, _N_TYPES), dtype=I32,
                             device=st.pc.device).scatter_add(
            1, f_type.clamp(min=0).to(torch.int64), acc_j)
        handled_cnt = _count(has_msg)

        # fault-layer counters (stay exactly zero when fault-free)
        retrans_inc = dup_inc = reo_inc = del_inc = wstall_inc = zero_b
        if fault_on:
            retrans_inc = W(accept_rj, failures, 0).reshape(
                bsz, -1).sum(dim=1, dtype=I32)
            wstall_inc = _count(valid_rj & wire_stall)

            def _event_cnt(key, p, name):
                if p <= 0.0:
                    return zero_b
                uu = prng.uniform(key, (n, j))
                return _count(accept_rj & applies & (uu < K[name]))

            dup_inc = _event_cnt(k_dup, float(fault.duplicate), "p_dup")
            reo_inc = _event_cnt(k_reo, float(fault.reorder), "p_reo")
            del_inc = _event_cnt(k_del, float(fault.delay), "p_del")
        overflow = st.overflow | ov_now

        # watchdog progress: an instruction retired or a mailbox drained
        progressed = (instr_inc > 0) | (handled_cnt > 0)
        last_progress = W(progressed, st.cycle, st.last_progress)

        # ============== phase D: dump-at-local-completion =============
        done_node = (
            (pc >= st.tr_len) & ~waiting & (mb_count3 == 0) & ~blocked_next
        )
        snap_now = done_node & ~st.snap_taken
        s2 = snap_now[..., None]
        s3 = snap_now[..., None, None]
        if P.has_owner_plane:
            snap_dir_owner = W(s2, dir_owner, st.snap_dir_owner)
        else:
            snap_dir_owner = st.snap_dir_owner

        return SimState(
            cache_addr=cache_addr,
            cache_val=cache_val,
            cache_state=cache_state,
            mem=mem,
            dir_state=dir_state,
            dir_sharers=dir_sharers,
            dir_owner=dir_owner,
            mb_data=mb_data,
            mb_count=mb_count3,
            pc=pc,
            waiting=waiting,
            pending_write=pending_write,
            ob_valid=ob_valid,
            ob_recv=g_recv,
            ob_type=g_type,
            ob_addr=g_addr,
            ob_value=g_value,
            ob_second=g_second,
            ob_sharers=ob_sharers,
            tr_op=st.tr_op,
            tr_addr=st.tr_addr,
            tr_val=st.tr_val,
            tr_len=st.tr_len,
            order_node=st.order_node,
            order_pos=order_pos,
            order_len=st.order_len,
            snap_taken=st.snap_taken | done_node,
            snap_mem=W(s2, mem, st.snap_mem),
            snap_dir_state=W(s2, dir_state, st.snap_dir_state),
            snap_dir_sharers=W(s3, dir_sharers, st.snap_dir_sharers),
            snap_dir_owner=snap_dir_owner,
            snap_cache_addr=W(s2, cache_addr, st.snap_cache_addr),
            snap_cache_val=W(s2, cache_val, st.snap_cache_val),
            snap_cache_state=W(s2, cache_state, st.snap_cache_state),
            cycle=st.cycle + 1,
            n_instr=st.n_instr + instr_inc,
            n_msgs=st.n_msgs + msgs_inc,
            overflow=overflow,
            n_read_hits=st.n_read_hits + rd_hit_inc,
            n_read_miss=st.n_read_miss + rd_miss_inc,
            n_write_hits=st.n_write_hits + wr_hit_inc,
            n_write_miss=st.n_write_miss + wr_miss_inc,
            n_evictions=st.n_evictions + ev_inc,
            n_invalidations=st.n_invalidations + inv_inc,
            msg_counts=st.msg_counts + mc_inc,
            rng_key=rng_key,
            last_progress=last_progress,
            n_retrans=st.n_retrans + retrans_inc,
            n_dup_filtered=st.n_dup_filtered + dup_inc,
            n_reorder_fixed=st.n_reorder_fixed + reo_inc,
            n_delays=st.n_delays + del_inc,
            n_wire_stalls=st.n_wire_stalls + wstall_inc,
            link_traversals=link_traversals,
            link_max_load=link_max_load,
            n_topo_delay=st.n_topo_delay + topo_delay_inc,
            n_multicast_saved=st.n_multicast_saved + mc_saved_inc,
            n_combined=st.n_combined + comb_inc,
            n_elided=st.n_elided,
            n_multi_hit=st.n_multi_hit,
            n_forwards=(
                st.n_forwards if fwd_inc is None
                else st.n_forwards + fwd_inc
            ),
            n_owner_xfer=(
                st.n_owner_xfer if xfer_inc is None
                else st.n_owner_xfer + xfer_inc
            ),
            n_dir_overflow=(
                st.n_dir_overflow if over_inc is None
                else st.n_dir_overflow + over_inc
            ),
            n_exch_sent=st.n_exch_sent,
            n_exch_hwm=st.n_exch_hwm,
            n_exch_mc_saved=st.n_exch_mc_saved,
            n_exch_combined=st.n_exch_combined,
        )

    return step


def quiescent(st: SimState) -> torch.Tensor:
    """Per-system quiescence [B]: traces exhausted, nobody waiting,
    mailboxes and outboxes empty, and the replay schedule consumed."""
    done = (
        (st.pc >= st.tr_len).all(dim=1)
        & (~st.waiting).all(dim=1)
        & (st.mb_count == 0).all(dim=1)
        & (~st.ob_valid).reshape(st.ob_valid.shape[0], -1).all(dim=1)
    )
    replay_done = (st.order_len < 0) | (st.order_pos >= st.order_len)
    return done & replay_done


# ===================== event-driven cycle elision =====================
#
# A cycle is elidable when no node can act differently from "retire a
# silent cache hit or idle" (``hpa2_tpu/ops/step.py:1595-1624``): then
# one fast-forward advances every system across the next j cycles at
# once.  Bit-exactness (dumps, cycle counts, every stat) is the contract.

# static trace-window bound for the multi-hit scan
_ELISION_WINDOW = 64
# "no event" distance marker; every real candidate is far smaller
_FAR = np.iinfo(np.int32).max


def _issuers(st: SimState, blocked: torch.Tensor) -> torch.Tensor:
    """Nodes that would issue an instruction this cycle (phase-B
    eligibility for a cycle in which no message is handled)."""
    return (
        (st.mb_count == 0) & ~st.waiting & ~blocked & (st.pc < st.tr_len)
    )


def _hit_window(config: SystemConfig, st: SimState):
    """Per-node silent-hit scan over the next ``_ELISION_WINDOW`` trace
    entries -> (op, ia, iv, run_len) with run_len the prefix length of
    entries that retire without any remote-visible transition."""
    c = config.cache_size
    P = planes_for(config.protocol, config.semantics)
    t = st.tr_op.shape[2]
    lw = min(_ELISION_WINDOW, t)
    karr = torch.arange(lw, dtype=I32, device=st.pc.device)
    pos = st.pc[..., None] + karr
    idx = pos.clamp(max=t - 1).to(torch.int64)
    op = st.tr_op.gather(2, idx)
    ia = st.tr_addr.gather(2, idx)
    iv = st.tr_val.gather(2, idx)
    ci = (ia % c).to(torch.int64)
    tag = st.cache_addr.gather(2, ci)
    stt = st.cache_state.gather(2, ci)
    is_w = op == 1
    silent = (
        (pos < st.tr_len[..., None])
        & (tag == ia)
        & torch.where(
            is_w,
            state_in(stt, P.silent_write_states, P.n_cache_states),
            state_in(stt, P.read_hit_states, P.n_cache_states),
        )
    )
    run_len = torch.cumprod(silent.to(I32), dim=2, dtype=I32).sum(
        dim=2, dtype=I32)
    return op, ia, iv, run_len


def build_propose(config: SystemConfig, max_cycles: int = 1_000_000,
                  watchdog_cycles: int = 0):
    """Build ``propose(st) -> [B, 3N + 2] int32`` candidate distances
    (``hpa2_tpu/ops/step.py:build_propose``, l.1692): the minimum over
    every entry of every system is the number of cycles one
    fast-forward may skip (0: run the lockstep step).  Per node: must
    step (0 when blocked or a head is deliverable now), the topology
    gate (head ``deliver_at - cycle``) and the issuer's silent-hit run;
    per system: the watchdog and ``max_cycles`` boundaries."""
    w = config.sharer_words
    topo_on = config.interconnect.enabled
    mb_deliver = 5 + w

    def propose(st: SimState) -> torch.Tensor:
        far = torch.full_like(st.pc, _FAR)
        blocked = st.ob_valid.any(dim=2)
        has_mail = st.mb_count > 0
        if topo_on:
            head_at = st.mb_data[:, :, 0, mb_deliver]
            ready_now = has_mail & (head_at <= st.cycle[:, None])
            gate = torch.where(has_mail & ~ready_now,
                               head_at - st.cycle[:, None], far)
        else:
            ready_now = has_mail
            gate = far
        issuer = _issuers(st, blocked)
        _, _, _, run_len = _hit_window(config, st)
        must = torch.where(blocked | ready_now, 0, far)
        hits = torch.where(issuer, run_len, far)
        if watchdog_cycles:
            gap = st.last_progress + watchdog_cycles - st.cycle
            # issuers advance last_progress every elided cycle, and a
            # system already past its boundary idles unchanged either
            # way: both propose no constraint
            wd = torch.where(issuer.any(dim=1) | (gap < 1), _FAR, gap)
        else:
            wd = torch.full_like(st.cycle, _FAR)
        capc = max_cycles - st.cycle
        return torch.cat([must, gate, hits, wd[:, None], capc[:, None]],
                         dim=1)

    return propose


def replay_splits(key: torch.Tensor, j, bound: Optional[int] = None):
    """The carried key after ``j`` per-cycle splits (each keeps
    ``split(k, 5)[4]``).  ``j`` an int: ``j`` host-side iterations.
    ``j`` a device scalar: ``bound`` iterations, the ``i``-th applied
    where ``i < j`` (the caller keeps ``j <= bound``)."""
    if bound is None:
        for _ in range(int(j)):
            key = prng.split_last(key, 5)
        return key
    for i in range(bound):
        key = torch.where(i < j, prng.split_last(key, 5), key)
    return key


def build_fast_forward(config: SystemConfig, key_bound: Optional[int] = None):
    """Build ``fast_forward(st, j) -> SimState``: advance ``j >= 1``
    provably silent cycles (``j <= min(propose(st))``) in one device
    step (``hpa2_tpu/ops/step.py:build_fast_forward``, l.1757).  Issuers
    retire exactly j silent hits each, everyone else idles; write hits
    apply last-write-wins per cache slot; under faults the key replays
    the j per-cycle splits (``replay_splits``; ``key_bound`` as
    there).  ``j`` is one jump shared by the whole batch."""
    fault_on = config.fault.enabled
    c = config.cache_size
    P = planes_for(config.protocol, config.semantics)

    def fast_forward(st: SimState, j) -> SimState:
        blocked = st.ob_valid.any(dim=2)  # all-false given j >= 1
        issuer = _issuers(st, blocked)
        op, ia, iv, _ = _hit_window(config, st)
        lw = op.shape[2]
        karr = torch.arange(lw, dtype=I32, device=st.pc.device)
        in_run = issuer[..., None] & (karr < j)
        is_w = in_run & (op == 1)
        slot_hot = (ia % c)[..., None] == torch.arange(
            c, dtype=I32, device=st.pc.device)
        wslot = is_w[..., None] & slot_hot               # [B, N, L, C]
        k1 = (karr + 1)[:, None]
        lastk = torch.where(wslot, k1, 0).amax(dim=2)    # [B, N, C]
        wrote = lastk > 0
        wval = torch.where(k1 == lastk[:, :, None, :], iv[..., None],
                           0).sum(dim=2, dtype=I32)
        cache_val = torch.where(wrote, wval, st.cache_val)
        cache_state = torch.where(wrote, P.M, st.cache_state)
        lastw = torch.where(is_w, karr + 1, 0).amax(dim=2)
        pwval = torch.where((karr + 1) == lastw[..., None], iv, 0).sum(
            dim=2, dtype=I32)
        pending_write = torch.where(lastw > 0, pwval, st.pending_write)

        retired = _count(in_run)
        rd_inc = _count(in_run & (op == 0))
        wr_inc = _count(is_w)
        any_issuer = issuer.any(dim=1)
        pc = st.pc + issuer.to(I32) * j
        cycle = st.cycle + j
        last_progress = torch.where(any_issuer, cycle - 1,
                                    st.last_progress)
        if fault_on:
            rng_key = replay_splits(st.rng_key, j, key_bound)
        else:
            rng_key = st.rng_key
        done_node = (
            (pc >= st.tr_len) & ~st.waiting & (st.mb_count == 0) & ~blocked
        )
        snap_now = done_node & ~st.snap_taken
        s2 = snap_now[..., None]
        s3 = snap_now[..., None, None]
        return st._replace(
            cache_val=cache_val,
            cache_state=cache_state,
            pending_write=pending_write,
            pc=pc,
            snap_taken=st.snap_taken | done_node,
            snap_mem=torch.where(s2, st.mem, st.snap_mem),
            snap_dir_state=torch.where(s2, st.dir_state, st.snap_dir_state),
            snap_dir_sharers=torch.where(s3, st.dir_sharers,
                                         st.snap_dir_sharers),
            snap_cache_addr=torch.where(s2, st.cache_addr,
                                        st.snap_cache_addr),
            snap_cache_val=torch.where(s2, cache_val, st.snap_cache_val),
            snap_cache_state=torch.where(s2, cache_state,
                                         st.snap_cache_state),
            cycle=cycle,
            n_instr=st.n_instr + retired,
            n_read_hits=st.n_read_hits + rd_inc,
            n_write_hits=st.n_write_hits + wr_inc,
            rng_key=rng_key,
            last_progress=last_progress,
            n_elided=st.n_elided + j - 1,
            n_multi_hit=st.n_multi_hit + retired,
        )

    return fast_forward


def build_elided_body(config: SystemConfig, max_cycles: int = 1_000_000,
                      watchdog_cycles: int = 0):
    """The event-driven loop body (``hpa2_tpu/ops/step.py:1886``) as a
    host branch: one reduction picks the jump shared by every system of
    the batch (the JAX body's ``batched=True`` form; a batch of one is
    its unbatched form), read on the host, then a fast-forward or a
    lockstep step."""
    step = build_step(config)
    propose = build_propose(config, max_cycles, watchdog_cycles)
    ff = build_fast_forward(config)

    def body(st: SimState) -> SimState:
        j = int(propose(st).min())
        return ff(st, j) if j > 0 else step(st)

    return body


def _select(sel: torch.Tensor, new: SimState, old: SimState) -> SimState:
    """``where(sel, new, old)`` field by field (``sel`` a 0-dim bool);
    fields ``new`` passed through unchanged are not copied."""
    return SimState(*(
        o if nw is o else torch.where(sel, nw, o) for nw, o in zip(new, old)
    ))


#: flag a chunk leaves for the host: the loop ended, it goes on, or a
#: fast-forward needs more key splits than a chunk replays
_DONE, _LIVE, _HOST_FF = 0, 1, 2


class Run:
    """Run a batch of systems to quiescence: the ``lax.while_loop`` of
    ``hpa2_tpu/ops/step.py:build_run`` (l.1916) and of
    ``hpa2_tpu/ops/engine.py:build_batched_run`` (l.416), which are one
    loop here (a single system is a batch of one).

    The loop condition is batch-global: some system live, every system
    under ``max_cycles``, no overflow and, with ``watchdog_cycles``, some
    live system that progressed within the window.  With
    ``config.elide`` (and no replay) the body is the event-driven one:
    one jump shared by the batch, the minimum of every system's
    proposal.

    On the CPU the loop runs on the host, one branch a cycle.  On the
    card it runs as chunks: one captured CUDA graph holds ``chunk``
    gated steps, each ``state = where(go, body(state), state)`` with
    ``go`` the loop condition on the device, so steps past the loop's
    end change nothing; under elision each step computes both the
    fast-forward and the lockstep step and keeps one.  The host reads
    one flag a chunk (``kernels.HOST_SYNCS``).  A fast-forward under
    faults replays its key splits in the graph up to ``key_bound``; a
    longer jump stops the chunk's steps and runs on the host.
    ``launches_per_chunk`` holds the kernels the last capture recorded
    and ``chunks`` the graph replays of the last run."""

    #: gated steps a captured graph holds
    chunk = 16

    def __init__(self, config: SystemConfig, replay: bool = False,
                 max_cycles: int = 1_000_000, watchdog_cycles: int = 0,
                 key_bound: int = 4):
        self.config = config
        self.max_cycles = max_cycles
        self.watchdog_cycles = watchdog_cycles
        self.key_bound = key_bound
        self.elide = config.elide and not replay
        self.fault_on = config.fault.enabled
        self.step = build_step(config, replay=replay)
        # the host's loop body: the elided one branches on the host
        self.body = self.step
        if self.elide:
            self.propose = build_propose(config, max_cycles, watchdog_cycles)
            self.body = build_elided_body(config, max_cycles,
                                          watchdog_cycles)
            self._ff_bounded = build_fast_forward(
                config, key_bound=key_bound if self.fault_on else None)
        self._graphs = {}
        self.launches_per_chunk = 0
        self.chunks = 0

    def cond(self, st: SimState) -> torch.Tensor:
        live = ~quiescent(st)
        go = (
            live.any()
            & (st.cycle < self.max_cycles).all()
            & ~st.overflow.any()
        )
        if self.watchdog_cycles:
            fresh = (st.cycle - st.last_progress) < self.watchdog_cycles
            go = go & (live & fresh).any()
        return go

    def __call__(self, st: SimState) -> SimState:
        if st.pc.is_cuda:
            return self._run_graphed(st)
        while bool(self.cond(st)):
            st = self.body(st)
        return st

    def gated(self, st: SimState):
        """One loop iteration with no host read: (state, need) where
        ``need`` (None without faults under elision) marks a jump too
        long for the in-graph key replay, which then leaves the state
        as it was."""
        go = self.cond(st)
        if not self.elide:
            return _select(go, self.step(st), st), None
        j = self.propose(st).min()
        jump = j > 0
        sel_ff = go & jump
        need = None
        if self.fault_on:
            need = sel_ff & (j > self.key_bound)
            sel_ff = sel_ff & ~need
        stepped = _select(go & ~jump, self.step(st), st)
        return _select(sel_ff, self._ff_bounded(st, j), stepped), need

    def advance_chunk(self, st: SimState, steps: int):
        """``steps`` gated iterations -> (state, flag): ``_DONE`` when the
        loop condition is false after them, ``_LIVE`` when it holds,
        ``_HOST_FF`` when a jump waits for the host (a waiting jump
        recurs at every later step of the chunk, unchanged)."""
        need_any = None
        for _ in range(steps):
            st, need = self.gated(st)
            if need is not None:
                need_any = need if need_any is None else need_any | need
        flag = self.cond(st).to(I32)
        if need_any is not None:
            flag = torch.where(need_any, _HOST_FF, flag)
        return st, flag

    def _capture(self, st: SimState):
        from torch.utils._python_dispatch import TorchDispatchMode

        class _Ops(TorchDispatchMode):
            """Counts the ops the capture records (one kernel each)."""

            count = 0

            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                if not func.is_view:
                    _Ops.count += 1
                return func(*args, **(kwargs or {}))

        static = SimState(*(x.clone() for x in st))
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            # warm-up: constants, cuBLAS and the allocator, before capture
            self.advance_chunk(SimState(*(x.clone() for x in st)), 1)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        flag = torch.zeros((), dtype=I32, device=st.pc.device)
        with torch.cuda.graph(graph):
            with _Ops():
                out, f = self.advance_chunk(static, self.chunk)
                for s, o in zip(static, out):
                    if o is not s:
                        s.copy_(o)
                flag.copy_(f)
        self.launches_per_chunk = _Ops.count
        return graph, static, flag

    def prepare(self, st: SimState) -> None:
        """Capture the chunk graph for ``st``'s shapes now, so that the
        first run at those shapes only replays it (no-op on the CPU)."""
        if st.pc.is_cuda:
            self._graph_for(st)

    def _graph_for(self, st: SimState):
        key = (st.pc.device, tuple(tuple(x.shape) for x in st))
        if key not in self._graphs:
            self._graphs[key] = self._capture(st)
        return self._graphs[key]

    def _run_graphed(self, st: SimState) -> SimState:
        from hpa2_tpu_torch.ops.kernels import HOST_SYNCS

        graph, static, flag = self._graph_for(st)
        for s, x in zip(static, st):
            s.copy_(x)
        self.chunks = 0
        while True:
            graph.replay()
            self.chunks += 1
            v = HOST_SYNCS.read(flag)
            if v == _DONE:
                break
            if v == _HOST_FF:
                HOST_SYNCS.count += 1  # the body reads the jump
                for s, o in zip(static, self.body(static)):
                    if o is not s:
                        s.copy_(o)
        return SimState(*(x.clone() for x in static))


@functools.lru_cache(maxsize=64)
def build_run(config: SystemConfig, replay: bool = False,
              max_cycles: int = 1_000_000, watchdog_cycles: int = 0) -> Run:
    """The run-to-quiescence loop, cached per (config, replay,
    max_cycles, watchdog_cycles) so engines reuse its captured graphs
    (``hpa2_tpu/ops/step.py:build_run``)."""
    return Run(config, replay=replay, max_cycles=max_cycles,
               watchdog_cycles=watchdog_cycles)
