// K1's node-sharded cycle: the rank-local work of one cycle of a node
// shard, as four kernels between the exchange's collectives.
//
// Replaces: the node-sharded variant of hpa2_tpu/ops/pallas_engine.py:
// build_cycle (l.559-575 and the exchange branch l.1355-1590), which JAX
// runs as XLA under shard_map because collectives cannot run inside a
// Mosaic kernel.  On the card the collectives stay NCCL calls outside the
// kernels (ops/exchange.py: forward, feedback) and the work between them
// is these four kernels, each with its plain PyTorch version in
// hpa2_tpu_torch/ops/node_cycle.py (the same seams):
//
//   N1 node_ab      phases A and B of the rank's nl node rows (node_ab
//                   below, with global ids me * nl + i), the mailbox
//                   head popped, the fresh sends staged in the outbox, and
//                   the exchange payload [W + SW + 3, 5 nl, B] written in
//                   the global candidate order (A grid sender-major
//                   [A0, A1, INV], then B grid [B0, B1]): the wire words,
//                   the INV fan-mask words, recv + 1, the phase-A flag and
//                   the combining key;
//   N2 node_bucket  order-preserving compaction of payload blocks into the
//                   k-slot buffers of destination shard sets, with the
//                   source telemetry (sent, high-water, multicast savings,
//                   overflow, the worst-overflow word) and, under hier,
//                   the combining count (shipped combinable entries minus
//                   distinct keys, per lane, from a key bitmap): hit
//                   flags, an exclusive scan by words and popcounts, a
//                   scatter, a CTA a tile of lanes and every destination;
//   N3 node_deliver every receiver takes the entries it holds in the
//                   global (phase, origin, index) order while its queue
//                   has room: each entry's local receiver set once, a
//                   receiver's ranks by words and popcounts, and the
//                   accepted count and bits of every entry written once
//                   into its feedback rows [1 + SW, J, B];
//   N4 node_settle  the senders once the feedback is back: delivered slots
//                   cleared, the rest deferred (the INV slot keeps the
//                   receivers that did not accept), the phase-D snapshots,
//                   and the rank's rows of the one stacked SUM and the one
//                   stacked MAX of the cycle.
//
// Planes are the rank's block, lane-last [nl, ..., B], int32 or packed
// narrow, and updated in place.  None of the four needs a cluster or a
// gate.  N1 and N4: a CTA holds `group` lanes x `tpl` threads a lane (tid
// = t * group + g, so a warp reads neighbouring lanes of one node row),
// thread t owns node rows t, t + tpl, ...; per-lane sums go through
// shared memory.  N2 and N3: a CTA holds a tile of lanes and its threads
// cover (entry, lane), lane fastest; each is a sequence of phase bodies
// over a shared tile with a barrier between them (n2_phase, n3_phase),
// which the host build runs phase by phase over every thread of a CTA.
//
// What bounds them on an H100: each is a pass over the rank's planes and
// the exchange blocks, a few KB a lane, so bytes over 3.35 TB/s give a few
// microseconds at 1,024 lanes.  N1 and N4 are bound in practice by the
// dependent loads of a node's chain; N2 and N3 read every entry's header
// once, in parallel, and do their scans in shared memory.
#pragma once

#include "cycle.cuh"

namespace hpa2 {

constexpr int kMaxShards = 16;  // node shards the kernels take
constexpr int kNodeCta = 256;   // threads a CTA
constexpr int kABCount = 7;     // N1's counters: instr, rh, rm, wh, wm, ev, inv
// the exchange telemetry rows (ops/exchange.py FSTATS)
enum { FS_SENT = 0, FS_HWM, FS_MC, FS_COMB, FS_OVF, FS_DIAG, kFStats };
// N4's rows of the stacked SUM: end activity, sent, exchange overflow,
// mailbox overflow, instructions, delivered, rh, rm, wh, wm, ev, inv,
// per-type deliveries, multicast savings, combining
enum { G_ACTIVE = 0, G_SENT, G_XOVF, G_OVINC, G_INSTR, G_MD, G_RH,
       G_MC = 12, G_MCSAVED = G_MC + kNTypes, G_COMB, kSumRows };
enum { M_HWM = 0, M_DIAG, M_DC, kMaxRows };
// N1's per-lane partial sums and N4's, in shared memory
enum { R_ACTIVE = 0, R_OVINC, R_MD, R_MC, kSettleRed = R_MC + kNTypes };
// a destination's flags (N2): compact into a buffer, count in the stats
enum { kDestCompact = 1, kDestStat = 2 };

// What N1, N3 and N4 take: the planes of the rank's block and the layout
// (Args; n is the whole system's), and the exchange tensors.  Mirrored
// field for field by hpa2_tpu_torch/ops/node_cycle.py:NodeArgs.
struct NodeArgs {
  Args a;
  int32_t me, nl, shards, tpl, group, nblk;
  int32_t* payload;              // [W + SW + 3, 5 nl, B]  N1 out
  int32_t* cnt;                  // [7, B]                N1 out, N4 in
  const int32_t* blk[kMaxShards];  // N3: entry blocks [R, blen, B] in origin order
  int32_t* fb[kMaxShards];         //     their feedback rows [1 + SW, blen, B]
  int32_t blen[kMaxShards];
  const int32_t* acc;            // [1 + SW, 5 nl, B]     N4: accepted counts, bits
  const int32_t* fs;             // [6, B]                N4: exchange telemetry
  int32_t* gsum;                 // [29, B]               N4 out
  int32_t* gmax;                 // [3, B]                N4 out
};

// What N2 takes: blocks, destinations (a shard set, as a bit set, and the
// union of the set's node-range masks), and a buffer and placement for
// each compacting one.  Mirrored by ops/node_cycle.py:BucketArgs.
struct BucketArgs {
  int32_t n, nl, W, SW, b, k, ndest, combine, nkeys, me;
  int32_t* fs;                   // [6, B] in/out
  const int32_t* blk[kMaxShards];
  int32_t blen[kMaxShards];
  int32_t dblk[kMaxShards], dset[kMaxShards], dflags[kMaxShards],
      ddst[kMaxShards];
  int32_t dmask[kMaxShards][kMaxSW];
  int32_t* buf[kMaxShards];      // [R, k, B]
  int64_t* sel[kMaxShards];      // [blen, B]: slot, or k when not shipped
};

// the node bound whose instantiation holds the system (0: none)
HPA2_HD int node_kernel_bound(const Args& a) {
  const int bound = a.n <= 8 ? 8 : (a.n <= 21 ? 21 : kMaxNodes);
  const bool ok = bound == 8 ? fits<8>(a) : bound == 21 ? fits<21>(a)
                                                       : fits<kMaxNodes>(a);
  return ok && a.cap >= 1 ? bound : 0;
}

HPA2_HD bool node_geometry_ok(const NodeArgs& x) {
  return x.nl >= 1 && x.shards >= 1 && x.shards <= kMaxShards &&
         x.nl * x.shards == x.a.n && x.me >= 0 && x.me < x.shards &&
         x.tpl >= 1 && x.group >= 1 && x.tpl * x.group <= kNodeCta &&
         x.nblk >= 0 && x.nblk <= kMaxShards;
}

// column of node row s's slot k in the local candidate order
HPA2_HD int cand_col(int nl, int s, int k) {
  return k < 3 ? s * 3 + k : 3 * nl + s * 2 + (k - 3);
}

// element (row, col) of a [rows, cols, B] block at lane l
HPA2_HD size_t blk_at(int row, int cols, int col, int b, int l) {
  return ((size_t)row * (size_t)cols + (size_t)col) * (size_t)b + (size_t)l;
}

// ===== phases A and B of one node =====================================
// The per-node body of cycle.cuh:phase_ab (its handler switch and issue,
// line for line), with the node's plane row i and its global id gid
// apart, and what it leaves returned instead of published in a lane
// block's shared memory.  It is a copy: K2 and K3 calling it through
// this interface raised their spills (the packed bound-8 and bound-21
// instantiations from 8 to 40 bytes, over the ceiling the
// pallas-cycle-body contract pins), so phase_ab keeps its own body until
// the register work of ROADMAP queue 2 item 3.
//
// NodeAB is what the body leaves of one node: its candidates (the fresh
// sends of slots 0, 1, 3 and 4, sender field zero, or a blocked node's
// deferred receivers), its INV receiver set, its nsw word before
// deliveries, and what the counters take.
template <int MAXN>
struct NodeAB {
  Slot<Bound<MAXN>::W> sl[4];
  int drecv[4];
  int32_t ish[Bound<MAXN>::SW];
  int inv_addr;
  int32_t dv2, nswp;
  bool blocked, has_msg, elig, ev, inv_applied, rh, rm, wh, wm;
};

// Node row i of lane l handles its mailbox head, in slot 0 (A), and
// issues one instruction (B).  The planes are addressed by the row i; the
// node's global id gid is what the home, second-party and sender tests
// and the REPLY_ID fan's own bit compare (a node shard's rows start at
// its first node's id).  Its cache and directory rows are updated in
// place; its mailbox is only read (the caller pops the head) and its
// outbox not written.
template <int MAXN, bool PACKED>
HPA2_HD void node_ab(const Args& a, const int l, const int i, const int gid,
                     const int seg, NodeAB<MAXN>& o) {
  constexpr int KW = Bound<MAXN>::W, KSW = Bound<MAXN>::SW;
  constexpr bool SPLIT = Bound<MAXN>::SPLIT;
  const int n = a.n, c = a.c, m = a.m, W = a.W;
  const int32_t sh_mask = (int32_t)((1u << (n < kSplitBpw ? n : kSplitBpw)) - 1u);
  int32_t tmp[KW];

  const int32_t nswv = HPA2_AT(a.nsw, i);
  const int mbc = nswv & a.count_mask;
  const int wt_in = (nswv >> a.off_wait) & 1;
  const int pw = (nswv >> a.off_pw) & 0xFF;
  const int pc = (nswv >> a.off_pc) & a.pc_mask;
  const int tl = window_len(a, l, i, seg);
  // deferred slots: receivers of 0, 1, 3, 4, and the INV slot's set
  int drecv[4];
  int32_t ow2[KW], ish[KSW];
  bool blocked = false;
  int32_t dv2 = 0;
  HPA2_UNROLL for (int q = 0; q < 4; ++q) {
    drecv[q] = deferred_recv(a, l, i, one_slot(q));
    blocked = blocked || drecv[q] != -1;
  }
  deferred_inv<MAXN>(a, l, i, ow2);
  msg_sharers<MAXN>(a, ow2, ish);
  HPA2_UNROLL for (int w = 0; w < KSW; ++w) dv2 |= ish[w];
  dv2 = dv2 != 0;
  blocked = blocked || dv2;
  int inv_addr = dv2 ? fget<KW>(a, ow2, F_ADDR) : 0;

  Slot<KW> sl[4];  // slots 0, 1, 3, 4
  HPA2_UNROLL for (int q = 0; q < 4; ++q) {
    sl[q].recv = -1;
    HPA2_UNROLL for (int w = 0; w < KW; ++w) sl[q].w[w] = 0;
  }
  Slot<KW>& sA0 = sl[0];
  Slot<KW>& sA1 = sl[1];
  Slot<KW>& sB0 = sl[2];
  Slot<KW>& sB1 = sl[3];

  // ===== phase A: handle the mailbox head ==========================
  // (a blocked node handles nothing; its sends are its deferred ones)
  const bool has_msg = mbc > 0 && !blocked;
  int wt = wt_in;
  bool ev = false, inv_applied = false;
  if (has_msg) {
    // the head sits in slot 0; the caller pops it
    int32_t head[KW];
    HPA2_UNROLL for (int w = 0; w < KW; ++w)
      head[w] = w < W ? HPA2_AT(a.mb[w], i * a.cap) : 0;
    const int mt = fget<KW>(a, head, F_TYPE);
    const int snd = fget<KW>(a, head, F_SENDER);
    const int sr = fget<KW>(a, head, F_SECOND) - 1;
    const int ad = fget<KW>(a, head, F_ADDR);
    const int aux = fget<KW>(a, head, F_AUX);
    const int v = aux & 0xFF;

    const int home = ad / m, blk = ad % m, ci = ad % c;
    const bool is_home = gid == home, is_second = gid == sr;
    const int32_t cw = cw_ld<PACKED>(a, a.live, l, i * c + ci);
    const int line_state = cw & 3;
    const int line_val = (cw >> kCwValShift) & 0xFF;
    const int line_addr = ((cw >> kCwAddrShift) & kAddrMask) - 1;
    const int32_t dw = dw_ld<PACKED>(a, a.live, l, i * m + blk);
    const int mem_blk = dw & 0xFF;
    const int ds = (dw >> kDwStateShift) & 3;
    // the home's sharer set of the block
    int32_t dsh[KSW];
    if (SPLIT) {
      HPA2_UNROLL for (int w = 0; w < KSW; ++w)
        dsh[w] = w < a.SW ? HPA2_AT(a.live.dirs[w], i * m + blk) : 0;
    } else {
      dsh[0] = (dw >> kDwShShift) & sh_mask;
    }
    const bool line_match = line_addr == ad;
    const bool line_me = line_state == ST_M || line_state == ST_E;
    const int owner = sv_owner<KSW>(dsh);
    const bool owner_is_snd = owner == snd;
    int32_t snd_bit[KSW];
    sv_bit<KSW>(snd_bit, snd);
    const bool du = ds == D_U, dss = ds == D_S, dem = ds == D_EM;

    int nl_addr = line_addr, nl_val = line_val, nl_state = line_state;
    bool upd_line = false, upd_dir = false, mem_write = false;
    int nd_state = ds;
    int32_t nd_sh[KSW], sv[KSW];
    HPA2_UNROLL for (int w = 0; w < KSW; ++w) nd_sh[w] = dsh[w];
    int mem_val = mem_blk;

    // evict the line (l_addr, l_val, l_state) into slot s
    auto evict = [&](Slot<KW>& s, int l_addr, int l_val,
                     int l_state) -> bool {
      if (l_addr == -1 || l_state == ST_I) return false;
      pack<MAXN>(a, tmp, l_state == ST_M ? EVICT_MODIFIED : EVICT_SHARED,
                 l_addr, l_val, true, -2);
      put(s, l_addr / m, tmp);
      return true;
    };

    switch (mt) {
      case READ_REQUEST:
        if (is_home) {
          if (du || dss || (dem && owner_is_snd)) {
            const bool excl = du || (dem && owner_is_snd);
            pack<MAXN>(a, tmp, REPLY_RD, ad, mem_blk | (excl ? 256 : 0), true, -2);
            put(sA0, snd, tmp);
          }
          const bool fwd = dem && !owner_is_snd;
          if (fwd) {
            pack<MAXN>(a, tmp, WRITEBACK_INT, ad, 0, false, snd);
            put(sA0, owner, tmp);
          }
          if (du || dss || fwd) upd_dir = true;
          if (du) nd_state = D_EM;
          if (fwd) nd_state = D_S;
          HPA2_UNROLL for (int w = 0; w < KSW; ++w) {
            if (du) nd_sh[w] = snd_bit[w];
            if (dss || fwd) nd_sh[w] |= snd_bit[w];
          }
        }
        break;
      case REPLY_RD:
        if (!line_match) ev = evict(sA0, line_addr, line_val, line_state);
        upd_line = true;
        nl_addr = ad;
        nl_val = v;
        nl_state = ((aux >> 8) & 1) ? ST_E : ST_S;
        wt = 0;
        break;
      case WRITEBACK_INT:
        if (line_match && line_me) {
          pack<MAXN>(a, tmp, FLUSH, ad, line_val, true, sr);
          put(sA0, home, tmp);
          if (sr != home) put(sA1, sr, tmp);
          upd_line = true;
          nl_state = ST_S;
        } else if (a.nack) {
          pack<MAXN>(a, tmp, NACK, ad, 0, false, sr);
          put(sA0, home, tmp);
        }
        break;
      case FLUSH:
        if (is_home) {
          mem_write = true;
          mem_val = v;
        }
        if (is_second) {
          if (!line_match) ev = evict(sA0, line_addr, line_val, line_state);
          upd_line = true;
          nl_addr = ad;
          nl_val = v;
          nl_state = ST_S;
          wt = 0;
        }
        break;
      case UPGRADE:
        if (is_home) {
          HPA2_UNROLL for (int w = 0; w < KSW; ++w)
            sv[w] = ds == D_S ? (dsh[w] & ~snd_bit[w]) : 0;
          pack<MAXN>(a, tmp, REPLY_ID, ad, 0, false, -2, sv);
          put(sA0, snd, tmp);
          upd_dir = true;
          nd_state = D_EM;
          HPA2_UNROLL for (int w = 0; w < KSW; ++w) nd_sh[w] = snd_bit[w];
        }
        break;
      case REPLY_ID:
        if (line_match && line_state != ST_M) {
          upd_line = true;
          nl_val = pw;
          nl_state = ST_M;
        }
        if (line_match) {
          int32_t self_bit[KSW];
          sv_bit<KSW>(self_bit, gid);
          msg_sharers<MAXN>(a, head, sv);
          HPA2_UNROLL for (int w = 0; w < KSW; ++w)
            ish[w] = sv[w] & ~self_bit[w];
          inv_addr = ad;
        }
        wt = 0;
        break;
      case INV:
        if (line_match && (line_state == ST_S || line_state == ST_E)) {
          inv_applied = true;
          upd_line = true;
          nl_state = ST_I;
        }
        break;
      case WRITE_REQUEST:
        if (is_home) {
          if (a.eager_write) {
            mem_write = true;
            mem_val = v;
          }
          if (du || (dem && owner_is_snd)) {
            pack<MAXN>(a, tmp, REPLY_WR, ad, 0, false, -2);
            put(sA0, snd, tmp);
          }
          if (dss) {
            HPA2_UNROLL for (int w = 0; w < KSW; ++w)
              sv[w] = dsh[w] & ~snd_bit[w];
            pack<MAXN>(a, tmp, REPLY_ID, ad, 0, false, -2, sv);
            put(sA0, snd, tmp);
          }
          const bool wr_fwd = dem && !owner_is_snd;
          if (wr_fwd) {
            pack<MAXN>(a, tmp, WRITEBACK_INV, ad, 0, false, snd);
            put(sA0, owner, tmp);
          }
          if (du || dss || wr_fwd) {
            upd_dir = true;
            HPA2_UNROLL for (int w = 0; w < KSW; ++w) nd_sh[w] = snd_bit[w];
          }
          if (du || dss) nd_state = D_EM;
        }
        break;
      case REPLY_WR:
        upd_line = true;
        nl_addr = ad;
        nl_val = pw;
        nl_state = ST_M;
        wt = 0;
        break;
      case WRITEBACK_INV:
        if (line_match && line_me) {
          pack<MAXN>(a, tmp, FLUSH_INVACK, ad, line_val, true, sr);
          put(sA0, home, tmp);
          if (sr != home) put(sA1, sr, tmp);
          upd_line = true;
          nl_state = ST_I;
        } else if (a.nack) {
          pack<MAXN>(a, tmp, NACK, ad, 1, true, sr);
          put(sA0, home, tmp);
        }
        break;
      case FLUSH_INVACK:
        if (is_home) {
          mem_write = true;
          mem_val = v;
          upd_dir = true;
          nd_state = D_EM;
          sv_bit<KSW>(nd_sh, sr);
        }
        if (is_second) {
          upd_line = true;
          nl_addr = ad;
          nl_val = a.flush_old_fill ? v : pw;
          nl_state = ST_M;
          wt = 0;
        }
        break;
      case EVICT_SHARED:
        if (is_home && sv_test<KSW>(dsh, snd)) {
          HPA2_UNROLL for (int w = 0; w < KSW; ++w) sv[w] = dsh[w] & ~snd_bit[w];
          const int cnt = sv_count<KSW>(sv);
          upd_dir = true;
          HPA2_UNROLL for (int w = 0; w < KSW; ++w) nd_sh[w] = sv[w];
          if (cnt == 0) nd_state = D_U;
          if (cnt == 1 && ds == D_S) {
            nd_state = D_EM;
            pack<MAXN>(a, tmp, UPGRADE_NOTIFY, ad, 0, false, -2);
            put(sA0, sv_owner<KSW>(sv), tmp);
          }
        }
        break;
      case UPGRADE_NOTIFY:
        if (snd == home && line_match && line_state == ST_S) {
          upd_line = true;
          nl_state = ST_E;
        }
        break;
      case EVICT_MODIFIED:
        if (is_home) {
          mem_write = true;
          mem_val = v;
          if (ds == D_EM && sv_test<KSW>(dsh, snd)) {
            upd_dir = true;
            nd_state = D_U;
            HPA2_UNROLL for (int w = 0; w < KSW; ++w) nd_sh[w] = 0;
          }
        }
        break;
      case NACK:
        if (a.nack && is_home) {
          upd_dir = true;
          sv_bit<KSW>(sv, sr);
          if (aux == 0) {
            nd_state = D_S;
            HPA2_UNROLL for (int w = 0; w < KSW; ++w) nd_sh[w] |= sv[w];
            pack<MAXN>(a, tmp, REPLY_RD, ad, mem_blk, true, -2);
          } else {
            nd_state = D_EM;
            HPA2_UNROLL for (int w = 0; w < KSW; ++w) nd_sh[w] = sv[w];
            pack<MAXN>(a, tmp, REPLY_WR, ad, 0, false, -2);
          }
          put(sA0, sr, tmp);
        }
        break;
      default:
        break;
    }

    if (upd_line)
      cw_st<PACKED>(a, a.live, l, i * c + ci,
            nl_state | (nl_val << kCwValShift) | ((nl_addr + 1) << kCwAddrShift));
    if (mem_write || upd_dir) {
      const int new_mem = mem_write ? mem_val : mem_blk;
      const int new_ds = upd_dir ? nd_state : ds;
      int32_t dwv = new_mem | (new_ds << kDwStateShift);
      if (!SPLIT) dwv |= (upd_dir ? nd_sh[0] : dsh[0]) << kDwShShift;
      dw_st<PACKED>(a, a.live, l, i * m + blk, dwv);
    }
    if (SPLIT && upd_dir)
      HPA2_UNROLL for (int w = 0; w < KSW; ++w)
        if (w < a.SW) HPA2_AT(a.live.dirs[w], i * m + blk) = nd_sh[w];
  }
  const int count2 = mbc - (has_msg ? 1 : 0);

  // ===== phase B: instruction issue ================================
  const bool elig = count2 == 0 && wt == 0 && !blocked && pc < tl;
  int pending = pw;
  bool ev_issue = false;
  o.rh = o.rm = o.wh = o.wm = false;
  if (elig) {
    const int32_t wi =
        HPA2_AT(a.tr, i * a.t_pad + seg * a.window + pc);
    const int op = wi & 1, iv = (wi >> 1) & 0xFF, ia = wi >> kTrAddrShift;
    const int ci2 = ia % c, home2 = ia / m;
    const int32_t cw2 = cw_ld<PACKED>(a, a.live, l, i * c + ci2);
    const int l2_state = cw2 & 3;
    const int l2_val = (cw2 >> kCwValShift) & 0xFF;
    const int l2_addr = ((cw2 >> kCwAddrShift) & kAddrMask) - 1;
    const bool hit = l2_addr == ia && l2_state != ST_I;
    const bool is_rd = op == 0, is_wr = op == 1;
    const bool rm = is_rd && !hit, wm = is_wr && !hit;
    if ((rm || wm) && l2_addr != -1 && l2_state != ST_I) {  // evict
      pack<MAXN>(a, tmp, l2_state == ST_M ? EVICT_MODIFIED : EVICT_SHARED,
                 l2_addr, l2_val, true, -2);
      put(sB0, l2_addr / m, tmp);
      ev_issue = true;
    }
    if (rm) {
      pack<MAXN>(a, tmp, READ_REQUEST, ia, 0, false, -2);
      put(sB1, home2, tmp);
    }
    if (wm) {
      pack<MAXN>(a, tmp, WRITE_REQUEST, ia, iv, true, -2);
      put(sB1, home2, tmp);
    }
    const bool wh_me = is_wr && hit && (l2_state == ST_M || l2_state == ST_E);
    const bool wh_s = is_wr && hit && l2_state == ST_S;
    if (wh_s) {
      pack<MAXN>(a, tmp, UPGRADE, ia, 0, false, -2);
      put(sB1, home2, tmp);
    }
    if (is_wr) pending = iv;
    if (rm || wm || wh_s) wt = 1;
    if (rm || wm || wh_me || wh_s) {
      const int n2_addr = (rm || wm) ? ia : l2_addr;
      const int n2_val = (rm || wm) ? 0 : iv;
      const int n2_state = (rm || wm) ? ST_I : ST_M;
      cw_st<PACKED>(a, a.live, l, i * c + ci2,
            n2_state | (n2_val << kCwValShift) | ((n2_addr + 1) << kCwAddrShift));
    }
    o.rh = is_rd && hit;
    o.rm = rm;
    o.wh = is_wr && hit;
    o.wm = wm;
  }
  o.ev = ev || ev_issue;
  o.inv_applied = inv_applied;
  o.elig = elig;
  o.has_msg = has_msg;
  o.blocked = blocked;
  o.inv_addr = inv_addr;
  o.dv2 = dv2;
  o.nswp = count2 | (wt << a.off_wait) | (pending << a.off_pw) |
           ((pc + (elig ? 1 : 0)) << a.off_pc);
  HPA2_UNROLL for (int q = 0; q < 4; ++q) {
    o.drecv[q] = drecv[q];
    o.sl[q] = sl[q];
  }
  HPA2_UNROLL for (int w = 0; w < KSW; ++w) o.ish[w] = ish[w];
}

// ===== N1: phases A and B of node row i of lane l =====================
// The head is read from slot 0 and popped by rotating the mailbox left by
// one (the reference's rotation).  A free node's fresh sends are staged
// in its outbox with the sender and (packed) recv fields, as the words
// N4 keeps if they are not delivered; a blocked node's deferred slots
// are there already.  The INV slot holds the INV word with its receiver
// set.  The payload columns are the words the reference offers.
template <int MAXN, bool PACKED>
HPA2_HD void n1_node(const NodeArgs& x, const int l, const int i,
                     uint32_t* red, const int stride) {
  constexpr int KW = Bound<MAXN>::W, KSW = Bound<MAXN>::SW;
  constexpr bool SPLIT = Bound<MAXN>::SPLIT;
  const Args& a = x.a;
  const int W = a.W, SW = a.SW, nl = x.nl, j0 = 5 * nl;
  const int gid = x.me * nl + i;
  const int snd_word = a.f_word[F_SENDER], snd_off = a.f_off[F_SENDER];
  const int recv_w = a.f_word[F_RECV], recv_off = a.f_off[F_RECV];
  const int sh_f0 = SPLIT ? F_SHR0 : F_AUX;

  NodeAB<MAXN> o;
  node_ab<MAXN, PACKED>(a, l, i, gid, a.seg, o);
  if (o.has_msg) settle_mailbox<MAXN>(a, l, i, 1);
  HPA2_AT(a.nsw, i) = o.nswp;

  auto put_col = [&](int k, const int32_t* w, int recv_p1, const int32_t* mask,
                     int key) {
    const int col = cand_col(nl, i, k);
    HPA2_UNROLL for (int q = 0; q < KW; ++q)
      if (q < W) x.payload[blk_at(q, j0, col, a.b, l)] = w[q];
    HPA2_UNROLL for (int q = 0; q < KSW; ++q)
      if (q < SW) x.payload[blk_at(W + q, j0, col, a.b, l)] = mask[q];
    x.payload[blk_at(W + SW, j0, col, a.b, l)] = recv_p1;
    x.payload[blk_at(W + SW + 1, j0, col, a.b, l)] = k < 3;
    x.payload[blk_at(W + SW + 2, j0, col, a.b, l)] = key;
  };
  int32_t zmask[KSW];
  HPA2_UNROLL for (int q = 0; q < KSW; ++q) zmask[q] = 0;

  HPA2_UNROLL for (int q = 0; q < 4; ++q) {
    const int k = one_slot(q), row = i * kNSlots + k;
    int32_t w[KW];
    const int r = o.blocked ? o.drecv[q] : o.sl[q].recv;
    HPA2_UNROLL for (int j = 0; j < KW; ++j) {
      const int32_t base = o.blocked ? (j < W ? HPA2_AT(a.ob[j], row) : 0)
                                     : o.sl[q].w[j];
      w[j] = base | (j == snd_word ? gid << snd_off : 0);
    }
    if (!o.blocked && r >= 0) {
      HPA2_UNROLL for (int j = 0; j < KW; ++j)
        if (j < W)
          HPA2_AT(a.ob[j], row) =
              w[j] | (a.recv_packed && j == recv_w ? (r + 1) << recv_off : 0);
      if (!a.recv_packed) HPA2_AT(a.ob_recv, row) = r;
    }
    const int key = r >= 0 && fget<KW>(a, w, F_TYPE) == READ_REQUEST
                        ? fget<KW>(a, w, F_ADDR) + 1 : 0;
    put_col(k, w, r + 1, zmask, key);
  }
  // the INV slot: the word offered, and in the outbox with its set
  int32_t w2[KW];
  inv_word<MAXN>(a, w2, gid, o.inv_addr);
  put_col(2, w2, 0, o.ish, 0);
  int32_t inv_any = 0;
  HPA2_UNROLL for (int q = 0; q < KSW; ++q) inv_any |= o.ish[q];
  if (inv_any)
    HPA2_UNROLL for (int q = 0; q < KSW; ++q)
      if (q < (SPLIT ? SW : 1)) fput<KW>(a, w2, sh_f0 + q, o.ish[q]);
  HPA2_UNROLL for (int j = 0; j < KW; ++j)
    if (j < W) HPA2_AT(a.ob[j], i * kNSlots + 2) = inv_any ? w2[j] : 0;

  const bool inc[kABCount] = {o.elig, o.rh, o.rm, o.wh, o.wm, o.ev,
                              o.inv_applied};
  HPA2_UNROLL for (int j = 0; j < kABCount; ++j)
    if (inc[j]) sh_add(&red[j * stride], 1);
}

// ===== helpers of N2 and N3 ============================================
// A shared-memory OR of a 64-bit receiver set made by several threads,
// and its popcount.
HPA2_HD void sh_or64(uint64_t* p, uint64_t v) {
#ifdef __CUDA_ARCH__
  atomicOr(reinterpret_cast<unsigned long long*>(p), (unsigned long long)v);
#else
  *p |= v;
#endif
}

HPA2_HD int popc64(uint64_t x) {
#ifdef __CUDA_ARCH__
  return __popcll((unsigned long long)x);
#else
  return __builtin_popcountll((unsigned long long)x);
#endif
}

// dynamic shared memory a CTA may take (an H100's opt-in limit)
constexpr int kNodeSmem = 227 * 1024;

// ===== N2: order-preserving compaction, a CTA a tile of lanes ==========
// A CTA owns G lanes (kBucketLanes, fewer when hier's key bitmap asks
// for it) and every destination of the launch.  Its threads cover
// (entry, lane) with the lane fastest, so a warp reads 4 entries x 8
// neighbouring lanes of a row: whole 32-byte sectors.  Each destination's
// entries are padded to a multiple of 32, one flag word a 32 of them.
// Four phases, a barrier between them:
//   0 zero the tile;
//   1 flags: every (destination, entry, lane) tests bucket_hit and sets
//     its bit in the lane's flag word; a stat destination's hit adds its
//     multicast savings to the lane's sum; under hier a compacting
//     destination's hit with a key sets the key's bit in the lane's
//     bitmap (nkeys bits) and counts one;
//   2 scan: a (destination, lane) walks its <= 5 flag words once, each
//     word's popcount its part of the exclusive prefix (the scan within a
//     word is a popcount of the bits below); the bitmap's popcounts are
//     the lane's distinct keys;
//   3 scatter: a hit whose slot is below k copies its R rows, every entry
//     writes its sel, the slots past the last hit are zeroed, and thread
//     g folds lane g's telemetry into fs once (the CTA owns the lane: no
//     atomics in global memory).
constexpr int kBucketLanes = 4;
constexpr int kN2Phases = 4;

// N2's launch geometry, from the arguments (bucket_plan)
struct BucketPlan {
  int32_t G;                      // lanes a CTA
  int32_t nw;                     // flag words a lane, every destination
  int32_t nkw;                    // key-bitmap words a lane (hier), else 0
  int32_t smem;                   // bytes of the shared tile
  int32_t woff[kMaxShards + 1];   // each destination's first flag word
};

// the plan of a launch, false when the kernel does not take it (the
// bitmap of every G does not fit)
HPA2_HD bool bucket_plan(const BucketArgs& x, BucketPlan& pl, int max_smem) {
  if (x.ndest < 1 || x.ndest > kMaxShards || x.b < 1 || x.k < 1 ||
      x.SW < 1 || x.SW > kMaxSW || x.nl < 1 || x.nkeys < 0)
    return false;
  int w = 0;
  for (int p = 0; p < x.ndest; ++p) {
    if (x.dblk[p] < 0 || x.dblk[p] >= kMaxShards) return false;
    pl.woff[p] = w;
    w += (x.blen[x.dblk[p]] + 31) / 32;
  }
  pl.woff[x.ndest] = w;
  pl.nw = w;
  pl.nkw = x.combine ? (x.nkeys + 31) / 32 : 0;
  for (int G = kBucketLanes; G >= 1; G /= 2) {
    const long long bytes =
        4LL * G * (2LL * pl.nw + x.ndest + 3 + pl.nkw);
    if (bytes <= max_smem) {
      pl.G = G;
      pl.smem = (int32_t)bytes;
      return true;
    }
  }
  return false;
}

// N2's shared tile: word arrays [rows][G]
struct BucketTile {
  uint32_t *bits, *base, *tot, *mc, *comb, *distinct, *keys;
  HPA2_HD BucketTile(const BucketArgs& x, const BucketPlan& pl,
                     uint32_t* sh) {
    const int G = pl.G;
    bits = sh;                       // [nw][G] hit flags
    base = bits + pl.nw * G;         // [nw][G] hits before the word
    tot = base + pl.nw * G;          // [ndest][G] hits
    mc = tot + x.ndest * G;          // [G] multicast savings
    comb = mc + G;                   // [G] shipped combinable entries
    distinct = comb + G;             // [G] distinct keys among them
    keys = distinct + G;             // [nkw][G] key bitmap
  }
};

// entry j of block e (J entries) goes to destination p: its point
// receiver lies in one of the set's shards, or its fan mask meets the
// set's node range
HPA2_HD bool bucket_hit(const BucketArgs& x, const int32_t* __restrict__ e,
                        int J, int j, int l, int p) {
  const int q = e[blk_at(x.W + x.SW, J, j, x.b, l)] - 1;
  if (q >= 0 && q < x.n && ((x.dset[p] >> (q / x.nl)) & 1)) return true;
  for (int w = 0; w < x.SW; ++w)
    if (e[blk_at(x.W + w, J, j, x.b, l)] & x.dmask[p][w]) return true;
  return false;
}

// the destination whose flag words hold word w
HPA2_HD int bucket_dest_of(const BucketArgs& x, const BucketPlan& pl,
                           int w) {
  int p = 0;
  while (p + 1 < x.ndest && w >= pl.woff[p + 1]) ++p;
  return p;
}

// phase ph of thread tid (of kNodeCta) of CTA cta
HPA2_HD void n2_phase(const BucketArgs& x, const BucketPlan& pl, int ph,
                      int cta, int tid, uint32_t* sh) {
  constexpr int T = kNodeCta;
  const int G = pl.G, k = x.k, R = x.W + x.SW + 3;
  const int l0 = cta * G;
  const BucketTile s(x, pl, sh);
  if (ph == 0) {
    const int words = pl.smem / 4;
    for (int i = tid; i < words; i += T) sh[i] = 0;
    return;
  }
  if (ph == 1) {
    const int krow = x.W + x.SW + 2;
    for (int idx = tid; idx < pl.nw * 32 * G; idx += T) {
      const int g = idx % G, e = idx / G, l = l0 + g;
      const int p = bucket_dest_of(x, pl, e >> 5);
      const int j = e - pl.woff[p] * 32, J = x.blen[x.dblk[p]];
      if (l >= x.b || j >= J) continue;
      const int32_t* __restrict__ blk = x.blk[x.dblk[p]];
      if (!bucket_hit(x, blk, J, j, l, p)) continue;
      sh_or(reinterpret_cast<int32_t*>(&s.bits[(e >> 5) * G + g]),
            (int32_t)(1u << (e & 31)));
      const int flags = x.dflags[p];
      if (flags & kDestStat) {
        int pop = 0;
        for (int w = 0; w < x.SW; ++w)
          pop += popc(blk[blk_at(x.W + w, J, j, x.b, l)] & x.dmask[p][w]);
        if (pop > 1) sh_add(&s.mc[g], (uint32_t)(pop - 1));
      }
      if (x.combine && (flags & kDestCompact)) {
        const int key = blk[blk_at(krow, J, j, x.b, l)];
        if (key >= 1 && key <= x.nkeys) {
          sh_add(&s.comb[g], 1);
          sh_or(reinterpret_cast<int32_t*>(&s.keys[((key - 1) >> 5) * G + g]),
                (int32_t)(1u << ((key - 1) & 31)));
        }
      }
    }
    return;
  }
  if (ph == 2) {
    for (int idx = tid; idx < x.ndest * G; idx += T) {
      const int g = idx % G, p = idx / G;
      uint32_t run = 0;
      for (int w = pl.woff[p]; w < pl.woff[p + 1]; ++w) {
        s.base[w * G + g] = run;
        run += (uint32_t)popc((int32_t)s.bits[w * G + g]);
      }
      s.tot[p * G + g] = run;
    }
    for (int idx = tid; idx < pl.nkw * G; idx += T) {
      const int c = popc((int32_t)s.keys[idx]);
      if (c) sh_add(&s.distinct[idx % G], (uint32_t)c);
    }
    return;
  }
  // ph == 3: the scatter, the tails, the telemetry
  for (int idx = tid; idx < pl.nw * 32 * G; idx += T) {
    const int g = idx % G, e = idx / G, l = l0 + g;
    const int p = bucket_dest_of(x, pl, e >> 5);
    const int j = e - pl.woff[p] * 32, J = x.blen[x.dblk[p]];
    if (l >= x.b || j >= J || !(x.dflags[p] & kDestCompact)) continue;
    const int w = e >> 5, bit = e & 31;
    const uint32_t word = s.bits[w * G + g];
    int64_t slot = k;
    if ((word >> bit) & 1) {
      const int pos = (int)s.base[w * G + g] +
                      popc((int32_t)(word & ((1u << bit) - 1u)));
      if (pos < k) {
        const int32_t* __restrict__ blk = x.blk[x.dblk[p]];
        int32_t* __restrict__ buf = x.buf[p];
        for (int r = 0; r < R; ++r)
          buf[blk_at(r, k, pos, x.b, l)] = blk[blk_at(r, J, j, x.b, l)];
        slot = pos;
      }
    }
    x.sel[p][(size_t)j * x.b + l] = slot;
  }
  for (int idx = tid; idx < x.ndest * k * G; idx += T) {
    const int g = idx % G, slot = (idx / G) % k, p = idx / (G * k);
    const int l = l0 + g;
    if (l >= x.b || !(x.dflags[p] & kDestCompact) ||
        slot < (int)s.tot[p * G + g])
      continue;
    int32_t* __restrict__ buf = x.buf[p];
    for (int r = 0; r < R; ++r) buf[blk_at(r, k, slot, x.b, l)] = 0;
  }
  for (int g = tid; g < G; g += T) {
    const int l = l0 + g;
    if (l >= x.b) continue;
    int32_t* fs = x.fs;
    auto at = [&](int row) -> int32_t& { return fs[(size_t)row * x.b + l]; };
    int32_t sent = at(FS_SENT), hwm = at(FS_HWM), ovf = at(FS_OVF),
            diag = at(FS_DIAG);
    for (int p = 0; p < x.ndest; ++p) {
      const int32_t t = (int32_t)s.tot[p * G + g];
      const int flags = x.dflags[p];
      if ((flags & kDestCompact) && k < x.blen[x.dblk[p]]) {
        hwm = t > hwm ? t : hwm;
        if (t > k) {
          ovf += t - k;
          const int32_t word = (int32_t)(
              ((uint32_t)(t < 0xFFFF ? t : 0xFFFF) << 16) |
              ((uint32_t)(x.me & 255) << 8) | (uint32_t)(x.ddst[p] & 255));
          diag = word > diag ? word : diag;
        }
      }
      if (flags & kDestStat) {
        sent += t;
        hwm = t > hwm ? t : hwm;
      }
    }
    at(FS_SENT) = sent;
    at(FS_HWM) = hwm;
    at(FS_OVF) = ovf;
    at(FS_DIAG) = diag;
    at(FS_MC) += (int32_t)s.mc[g];
    if (x.combine) at(FS_COMB) += (int32_t)(s.comb[g] - s.distinct[g]);
  }
}

// ===== N3: entry-parallel delivery, a CTA a tile of lanes ==============
// A CTA owns G lanes (kDeliverLanes) and every entry the rank holds: J
// entries, the blocks concatenated in origin order, so that within a
// phase the concatenation is the global (origin, index) order.  An
// entry's local receiver set is nl bits (nl <= 64): its point receiver,
// or its fan mask's bits of this rank's nodes (the words, at most three,
// that hold gids me * nl .. me * nl + nl - 1).  Five phases, a barrier
// between them:
//   0 zero the tile;
//   1 sets: every (entry, lane) reads its recv + 1, phase flag and mask
//     words once, and sets the entry's bit in the flag word of each of
//     its receivers, the phase-A or the phase-B word of its 32 entries;
//   2 scan: a (receiver, lane) walks its flag words once, the A words
//     then the B words, each word's base its exclusive prefix in the
//     global order, so a receiver's rank of an entry is the base plus
//     the popcount of the bits below; it takes min(room, total)
//     entries, and writes nsw once;
//   3 accept: a (32 entries, receiver, lane) takes the first set bits of
//     its words whose rank is below the room left, copies each one's W
//     words into the mailbox slot count2 + rank, and ORs the receiver
//     into the entry's accepted set;
//   4 feedback: every (entry, lane) writes its 1 + SW feedback rows once:
//     the popcount of its accepted set, and the set shifted into each
//     split word (no atomics in global memory, no zeroed rows before).
constexpr int kDeliverLanes = 4;
constexpr int kN3Phases = 5;

// N3's launch geometry, from the arguments (deliver_plan)
struct DeliverPlan {
  int32_t G;                      // lanes a CTA
  int32_t J;                      // entries, every block
  int32_t nch;                    // flag words of a receiver a phase
  int32_t smem;                   // bytes of the shared tile
  int32_t boff[kMaxShards + 1];   // each block's first entry
};

// the plan of a launch that node_geometry_ok took, false when the tile
// of every G does not fit
HPA2_HD bool deliver_plan(const NodeArgs& x, DeliverPlan& pl, int max_smem) {
  int J = 0;
  for (int b = 0; b < x.nblk; ++b) {
    pl.boff[b] = J;
    J += x.blen[b];
  }
  pl.boff[x.nblk] = J;
  pl.J = J;
  pl.nch = (J + 31) / 32;
  for (int G = kDeliverLanes; G >= 1; G /= 2) {
    const long long bytes =
        8LL * J * G + 4LL * G * (4LL * pl.nch * x.nl + x.nl);
    if (bytes <= max_smem) {
      pl.G = G;
      pl.smem = (int32_t)bytes;
      return true;
    }
  }
  return false;
}

// N3's shared tile: the accepted sets [J][G] (64-bit, first), then word
// arrays [rows][G]
struct DeliverTile {
  uint64_t* acc;
  uint32_t *wa, *wb, *ba, *bb, *c2;
  HPA2_HD DeliverTile(const NodeArgs& x, const DeliverPlan& pl, void* sh) {
    const int G = pl.G, rows = pl.nch * x.nl * G;
    acc = static_cast<uint64_t*>(sh);  // [J][G] accepted receivers
    wa = reinterpret_cast<uint32_t*>(acc + (size_t)pl.J * G);
    wb = wa + rows;                    // [nch][nl][G] phase A / B flags
    ba = wb + rows;
    bb = ba + rows;                    // [nch][nl][G] exclusive ranks
    c2 = bb + rows;                    // [nl][G] count2
  }
};

// the block that holds entry e
HPA2_HD int deliver_block_of(const NodeArgs& x, const DeliverPlan& pl,
                             int e) {
  int b = 0;
  while (b + 1 < x.nblk && e >= pl.boff[b + 1]) ++b;
  return b;
}

// phase ph of thread tid (of kNodeCta) of CTA cta
HPA2_HD void n3_phase(const NodeArgs& x, const DeliverPlan& pl, int ph,
                      int cta, int tid, void* sh) {
  constexpr int T = kNodeCta;
  const Args& a = x.a;
  const int G = pl.G, nl = x.nl, W = a.W, SW = a.SW, cap = a.cap;
  const int lo = x.me * nl, l0 = cta * G;
  const DeliverTile s(x, pl, sh);
  if (ph == 0) {
    uint32_t* w = reinterpret_cast<uint32_t*>(sh);
    const int words = pl.smem / 4;
    for (int i = tid; i < words; i += T) w[i] = 0;
    return;
  }
  if (ph == 1) {
    const uint64_t nl_mask = nl < 64 ? (1ull << nl) - 1ull : ~0ull;
    const int w_lo = lo / kSplitBpw, w_hi = (lo + nl - 1) / kSplitBpw;
    for (int idx = tid; idx < pl.J * G; idx += T) {
      const int g = idx % G, e = idx / G, l = l0 + g;
      if (l >= a.b) continue;
      const int b = deliver_block_of(x, pl, e);
      const int j = e - pl.boff[b], J = x.blen[b];
      const int32_t* __restrict__ blk = x.blk[b];
      uint64_t set = 0;
      const int q = blk[blk_at(W + SW, J, j, a.b, l)] - 1 - lo;
      if (q >= 0 && q < nl) set = 1ull << q;
      for (int w = w_lo; w <= w_hi && w < SW; ++w) {
        const uint64_t m =
            (uint32_t)blk[blk_at(W + w, J, j, a.b, l)] & 0x7FFFFFFFu;
        const int off = w * kSplitBpw - lo;  // local row of the word's bit 0
        set |= off >= 0 ? (off < 64 ? m << off : 0ull) : m >> -off;
      }
      set &= nl_mask;
      if (!set) continue;
      uint32_t* flag = blk[blk_at(W + SW + 1, J, j, a.b, l)] != 0 ? s.wa
                                                                  : s.wb;
      const int c = e >> 5;
      const uint32_t bit = 1u << (e & 31);
      while (set) {
        const int i = popc64((set & (~set + 1ull)) - 1ull);
        set &= set - 1ull;
        sh_or(reinterpret_cast<int32_t*>(&flag[(c * nl + i) * G + g]),
              (int32_t)bit);
      }
    }
    return;
  }
  if (ph == 2) {
    for (int idx = tid; idx < nl * G; idx += T) {
      const int g = idx % G, i = idx / G, l = l0 + g;
      if (l >= a.b) continue;
      const int32_t nswv = HPA2_AT(a.nsw, i);
      const int count2 = nswv & a.count_mask;
      s.c2[i * G + g] = (uint32_t)count2;
      int run = 0;
      for (int c = 0; c < pl.nch; ++c) {
        const int at = (c * nl + i) * G + g;
        s.ba[at] = (uint32_t)run;
        run += popc((int32_t)s.wa[at]);
      }
      for (int c = 0; c < pl.nch; ++c) {
        const int at = (c * nl + i) * G + g;
        s.bb[at] = (uint32_t)run;
        run += popc((int32_t)s.wb[at]);
      }
      const int room = cap - count2;
      const int acc = room <= 0 ? 0 : (room < run ? room : run);
      if (acc) HPA2_AT(a.nsw, i) = nswv + acc;
    }
    return;
  }
  if (ph == 3) {
    for (int idx = tid; idx < pl.nch * nl * G; idx += T) {
      const int g = idx % G, i = (idx / G) % nl, c = idx / (G * nl);
      const int l = l0 + g;
      if (l >= a.b) continue;
      const int at = (c * nl + i) * G + g;
      const int count2 = (int)s.c2[i * G + g];
      for (int ph2 = 0; ph2 < 2; ++ph2) {
        uint32_t word = ph2 == 0 ? s.wa[at] : s.wb[at];
        int rank = (int)(ph2 == 0 ? s.ba[at] : s.bb[at]);
        while (word && count2 + rank < cap) {
          const int e = c * 32 + find_owner((int32_t)word);
          word &= word - 1u;
          const int b = deliver_block_of(x, pl, e);
          const int j = e - pl.boff[b], J = x.blen[b];
          const int32_t* __restrict__ blk = x.blk[b];
          const int slot = count2 + rank;
          HPA2_UNROLL for (int w = 0; w < kMaxW; ++w)
            if (w < W) HPA2_AT(a.mb[w], i * cap + slot) =
                blk[blk_at(w, J, j, a.b, l)];
          sh_or64(&s.acc[(size_t)e * G + g], 1ull << i);
          ++rank;
        }
      }
    }
    return;
  }
  // ph == 4: the feedback rows
  for (int idx = tid; idx < pl.J * G; idx += T) {
    const int g = idx % G, e = idx / G, l = l0 + g;
    if (l >= a.b) continue;
    const int b = deliver_block_of(x, pl, e);
    const int j = e - pl.boff[b], J = x.blen[b];
    int32_t* __restrict__ fb = x.fb[b];
    const uint64_t set = s.acc[(size_t)e * G + g];
    fb[blk_at(0, J, j, a.b, l)] = popc64(set);
    for (int w = 0; w < SW; ++w) {
      const int off = lo - w * kSplitBpw;  // bit of local row 0 in word w
      const uint64_t v = off >= 0 ? (off < 64 ? set << off : 0ull)
                                  : (-off < 64 ? set >> -off : 0ull);
      fb[blk_at(1 + w, J, j, a.b, l)] = (int32_t)(v & 0x7FFFFFFFull);
    }
  }
}

// ===== N4: sender row s of lane l ======================================
template <int MAXN, bool PACKED>
HPA2_HD void n4_node(const NodeArgs& x, const int l, const int s,
                     uint32_t* red, const int stride) {
  constexpr int KW = Bound<MAXN>::W, KSW = Bound<MAXN>::SW;
  constexpr bool SPLIT = Bound<MAXN>::SPLIT;
  const Args& a = x.a;
  const int W = a.W, nl = x.nl, j0 = 5 * nl, c = a.c, m = a.m;
  const int gid = x.me * nl + s;
  const int type_w = a.f_word[F_TYPE], type_off = a.f_off[F_TYPE];
  const int32_t type_mask = (int32_t)((1u << a.f_width[F_TYPE]) - 1u);
  const int sh_f0 = SPLIT ? F_SHR0 : F_AUX;
  auto acc = [&](int row, int k) -> int32_t {
    return x.acc[blk_at(row, j0, cand_col(nl, s, k), a.b, l)];
  };

  uint32_t md = 0, ndefer = 0;
  bool blocked_next = false;
  HPA2_UNROLL for (int q = 0; q < 4; ++q) {
    const int k = one_slot(q), row = s * kNSlots + k;
    const int r = deferred_recv(a, l, s, k);
    if (r < 0) continue;
    const int32_t d = acc(0, k);
    if (d) {
      const int t = (HPA2_AT(a.ob[type_w], row) >> type_off) & type_mask;
      md += d;
      if (t < kNTypes) sh_add(&red[(R_MC + t) * stride], d);
      HPA2_UNROLL for (int w = 0; w < KW; ++w)
        if (w < W) HPA2_AT(a.ob[w], row) = 0;
      if (!a.recv_packed) HPA2_AT(a.ob_recv, row) = -1;
    } else {
      blocked_next = true;
      ++ndefer;
    }
  }
  // the INV slot: the receivers that did not accept stay in its set
  int32_t w2[KW], sv[KSW];
  deferred_inv<MAXN>(a, l, s, w2);
  msg_sharers<MAXN>(a, w2, sv);
  int32_t sv_any = 0;
  HPA2_UNROLL for (int w = 0; w < KSW; ++w) sv_any |= sv[w];
  if (sv_any) {
    int32_t rem[KSW], rem_any = 0;
    HPA2_UNROLL for (int w = 0; w < KSW; ++w) {
      rem[w] = w < a.SW ? sv[w] & ~acc(1 + w, 2) : 0;  // [1 + SW, ...] rows
      rem_any |= rem[w];
    }
    const int32_t dinv = acc(0, 2);
    if (dinv) {
      md += dinv;
      sh_add(&red[(R_MC + INV) * stride], dinv);
    }
    int32_t nw[KW];
    inv_word<MAXN>(a, nw, gid, fget<KW>(a, w2, F_ADDR));
    HPA2_UNROLL for (int j = 0; j < KSW; ++j)
      if (j < (SPLIT ? a.SW : 1)) fput<KW>(a, nw, sh_f0 + j, rem[j]);
    HPA2_UNROLL for (int w = 0; w < KW; ++w)
      if (w < W) HPA2_AT(a.ob[w], s * kNSlots + 2) = rem_any ? nw[w] : 0;
    if (rem_any) {
      blocked_next = true;
      ++ndefer;
    }
  }

  const int32_t nswf = HPA2_AT(a.nsw, s);
  const int count3 = nswf & a.count_mask;
  const int wt = (nswf >> a.off_wait) & 1;
  const int pc = (nswf >> a.off_pc) & a.pc_mask;
  const int tl = window_len(a, l, s, a.seg);
  // ===== phase D: dump-at-local-completion snapshots ===============
  if (a.snapshots) {
    const bool done = pc >= tl && wt == 0 && count3 == 0 && !blocked_next;
    const bool taken = HPA2_AT(a.snap_taken, s) != 0;
    if (done && !taken)
      copy_rows<MAXN, PACKED>(a, l, s * c, (s + 1) * c, s * m, (s + 1) * m);
    HPA2_AT(a.snap_taken, s) = (taken || done) ? 1 : 0;
  }
  const uint32_t active =
      (uint32_t)(tl > pc ? tl - pc : 0) + wt + count3 + ndefer;
  if (active) sh_add(&red[R_ACTIVE * stride], active);
  if (count3 > a.cap) sh_add(&red[R_OVINC * stride], 1);
  if (md) sh_add(&red[R_MD * stride], md);
}

// N4's per-lane rows, once every node of the lane is settled
HPA2_HD void n4_lane(const NodeArgs& x, const int l, const uint32_t* red,
                     const int stride) {
  const Args& a = x.a;
  auto fs = [&](int row) { return x.fs[(size_t)row * a.b + l]; };
  auto cnt = [&](int row) { return x.cnt[(size_t)row * a.b + l]; };
  auto g = [&](int row, int32_t v) { x.gsum[(size_t)row * a.b + l] = v; };
  g(G_ACTIVE, (int32_t)red[R_ACTIVE * stride]);
  g(G_SENT, fs(FS_SENT));
  g(G_XOVF, fs(FS_OVF) > 1 ? 1 : fs(FS_OVF));
  g(G_OVINC, red[R_OVINC * stride] ? 1 : 0);
  g(G_INSTR, cnt(0));
  g(G_MD, (int32_t)red[R_MD * stride]);
  for (int j = 1; j < kABCount; ++j) g(G_MD + j, cnt(j));
  for (int t = 0; t < kNTypes; ++t)
    g(G_MC + t, (int32_t)red[(R_MC + t) * stride]);
  g(G_MCSAVED, fs(FS_MC));
  g(G_COMB, fs(FS_COMB));
  const int32_t dg = fs(FS_DIAG);
  x.gmax[(size_t)M_HWM * a.b + l] = fs(FS_HWM);
  x.gmax[(size_t)M_DIAG * a.b + l] = dg;
  x.gmax[(size_t)M_DC * a.b + l] =
      dg > 0 ? (int32_t)((dg & ~0xFFFF) | (HPA2_AT(a.scalars, SC_CYCLE) & 0xFFFF))
             : 0;
}

}  // namespace hpa2
