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
// These four are instantiated at node bounds 8, 21 and 64; a wider
// system runs the wide family (below: the same stages, its words at run
// time, N1 the same protocol body).
//
// Planes are the rank's block, lane-last [nl, ..., B], int32 or packed
// narrow, and updated in place.  None of the four needs a cluster or a
// gate.  Each kernel's CTA holds a tile of lanes and its threads cover
// (work item, lane), lane fastest, so a warp reads neighbouring lanes of
// a row; each is a sequence of phase bodies over a shared tile with a
// barrier between them (n1_phase, n2_phase, n3_phase, n4_phase), which
// the host build runs phase by phase over every thread of a CTA.
//
// What bounds them on an H100: each is a pass over the rank's planes and
// the exchange blocks, a few KB a lane, so bytes over 3.35 TB/s give a few
// microseconds at 1,024 lanes.  In practice a chain of dependent loads
// bounds a thread: N1 and N4 gather every independent word of a node at
// once before the one thread a node that runs its protocol or settles it
// (N1's then walks only the trace word and the cache and directory
// rows), and write their outputs a word a thread; N2 and N3 read every
// entry's header once, in parallel, and do their scans in shared memory.
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
  int32_t me, nl, shards;
  int32_t nblk;
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
// apart, the words N1's gather phase staged fed in as arguments, and
// what it leaves returned instead of published in a lane block's shared
// memory.  It is a copy: K2 and K3 calling it through this interface
// raised their spills (the packed bound-8 and bound-21 instantiations
// from 8 to 40 bytes, over the ceiling the pallas-cycle-body contract
// pins), so phase_ab keeps its own body until the register work of
// ROADMAP queue 2 item 3.
//
// The body is generic over its words V, which holds the sharer sets and
// message words and does every operation on them:
//   RegWords<MAXN>  (node bounds 8, 21, 64) arrays indexed at compile
//                   time only, so they stay in registers;
//   WideWords       (the wide family, any n above 64; int32 planes, split
//                   mode) SW = ceil(n / 31) and W = 2 + SW are run-time
//                   values: a sharer set is a row of SW words of the
//                   pair's scratch in global memory (word j at j * P,
//                   the launch's pairs P apart, so a warp's accesses to
//                   a word coalesce) and a message is its two header
//                   words and a reference to the set its shr{w} fields
//                   carry (none: zero), so that no word vector has to
//                   live in registers.
// A message refers to its set where RegWords copies it: the body changes
// no set after packing it into a message.
//
// NodeIn is what the gather phase staged of one node: its nsw word and
// window length, the receivers of its deferred slots 0, 1, 3 and 4, its
// INV slot's words and its mailbox head's words (zero past W).
// NodeAB is what the body leaves of one node: its candidates (the fresh
// sends of slots 0, 1, 3 and 4, sender field zero, or a blocked node's
// deferred receivers), its INV receiver set, its nsw word before
// deliveries, and what the counters take.
template <int MAXN>
struct RegWords {
  static constexpr int KW = Bound<MAXN>::W, KSW = Bound<MAXN>::SW;
  static constexpr bool SPLIT = Bound<MAXN>::SPLIT;
  using Set = int32_t[KSW];
  using Msg = int32_t[KW];
  using SlotT = Slot<KW>;
  HPA2_HD void bind(Set&, int) const {}
  HPA2_HD void sharers(const Args& a, const Msg& w, Set& s) const {
    msg_sharers<MAXN>(a, w, s);
  }
  HPA2_HD int field(const Args& a, const Msg& w, int f) const {
    return fget<KW>(a, w, f);
  }
  HPA2_HD void pack(const Args& a, Msg& w, int type, int addr, int aux,
                    bool has_aux, int second) const {
    hpa2::pack<MAXN>(a, w, type, addr, aux, has_aux, second);
  }
  HPA2_HD void pack(const Args& a, Msg& w, int type, int addr, int aux,
                    bool has_aux, int second, const Set& shr) const {
    hpa2::pack<MAXN>(a, w, type, addr, aux, has_aux, second, shr);
  }
  HPA2_HD void put(SlotT& s, int recv, const Msg& w) const {
    hpa2::put(s, recv, w);
  }
  HPA2_HD void clear(SlotT& s) const {
    s.recv = -1;
    HPA2_UNROLL for (int w = 0; w < KW; ++w) s.w[w] = 0;
  }
  // the home's sharer set of directory row `row` (word dw)
  HPA2_HD void load_dir(const Args& a, int l, int row, int32_t dw,
                        int32_t sh_mask, Set& d) const {
    if (SPLIT) {
      HPA2_UNROLL for (int w = 0; w < KSW; ++w)
        d[w] = w < a.SW ? HPA2_AT(a.live.dirs[w], row) : 0;
    } else {
      d[0] = (dw >> kDwShShift) & sh_mask;
    }
  }
  HPA2_HD void store_dir(const Args& a, int l, int row, const Set& d) const {
    HPA2_UNROLL for (int w = 0; w < KSW; ++w)
      if (w < a.SW) HPA2_AT(a.live.dirs[w], row) = d[w];
  }
  HPA2_HD int32_t word0(const Set& s) const { return s[0]; }
  HPA2_HD int32_t any(const Set& s) const {
    int32_t v = 0;
    HPA2_UNROLL for (int w = 0; w < KSW; ++w) v |= s[w];
    return v;
  }
  HPA2_HD int owner(const Set& s) const { return sv_owner<KSW>(s); }
  HPA2_HD int count(const Set& s) const { return sv_count<KSW>(s); }
  HPA2_HD bool test(const Set& s, int p) const { return sv_test<KSW>(s, p); }
  HPA2_HD void bit(Set& s, int p) const { sv_bit<KSW>(s, p); }
  HPA2_HD void zero(Set& d) const {
    HPA2_UNROLL for (int w = 0; w < KSW; ++w) d[w] = 0;
  }
  HPA2_HD void copy(Set& d, const Set& s) const {
    HPA2_UNROLL for (int w = 0; w < KSW; ++w) d[w] = s[w];
  }
  HPA2_HD void or_in(Set& d, const Set& s) const {
    HPA2_UNROLL for (int w = 0; w < KSW; ++w) d[w] |= s[w];
  }
  // d = x & ~y
  HPA2_HD void and_not(Set& d, const Set& x, const Set& y) const {
    HPA2_UNROLL for (int w = 0; w < KSW; ++w) d[w] = x[w] & ~y[w];
  }
};

// The wide family's loops over a run-time count of words: ld(j) for each
// of n words, kWideBatch loads in flight before their stores st(j, v)
// (a loop that stores between its loads would wait on every load, the
// compiler not knowing the two apart).  A store of a batch may overwrite
// a word a later load of the same batch has read already, never one a
// later batch reads, as long as st(j) writes no word ld(j') reads for
// j' > j + kWideBatch (the mailbox rotation: st(s) writes slot s, ld(s)
// reads slot s + 1).
constexpr int kWideBatch = 16;

template <class Ld, class St>
HPA2_HD void wide_each(int n, Ld ld, St st) {
  for (int j0 = 0; j0 < n; j0 += kWideBatch) {
    int32_t v[kWideBatch];
    HPA2_UNROLL for (int u = 0; u < kWideBatch; ++u)
      if (j0 + u < n) v[u] = ld(j0 + u);
    HPA2_UNROLL for (int u = 0; u < kWideBatch; ++u)
      if (j0 + u < n) st(j0 + u, v[u]);
  }
}

// an OR of ld(j) over n words, kWideBatch loads in flight
template <class Ld>
HPA2_HD int32_t wide_or(int n, Ld ld) {
  int32_t acc = 0;
  for (int j0 = 0; j0 < n; j0 += kWideBatch)
    HPA2_UNROLL for (int u = 0; u < kWideBatch; ++u)
      if (j0 + u < n) acc |= ld(j0 + u);
  return acc;
}

// the wide family's scratch rows a pair: its INV slot's and its mailbox
// head's staged sets, then the body's
enum { kSetInv = 0, kSetHead, kSetIsh, kSetDsh, kSetNdsh, kSetSv, kSetSnd,
       kSetSelf, kWideSets };

struct WideWords {
  static constexpr bool SPLIT = true;
  struct Set {
    int32_t* p;
  };
  struct Msg {
    int32_t h[2];                 // header words 0 and 1
    const int32_t* set;           // its shr{w} words (stride P), or null
  };
  struct SlotT {
    int recv;
    Msg m;
  };
  int SW;
  size_t P;                       // the scratch's stride: pairs a launch
  int32_t* base;                  // this pair's scratch word 0
  int32_t* const* dirs;           // [SW] live sharer planes
  HPA2_HD void bind(Set& s, int k) const {
    s.p = base + (size_t)k * SW * P;
  }
  // field f of a header (the wide layout keeps every field but shr{w}
  // in words 0 and 1)
  HPA2_HD static int hget(const Args& a, const int32_t* h, int f) {
    return ((a.f_word[f] == 0 ? h[0] : h[1]) >> a.f_off[f]) &
           (int32_t)((1u << a.f_width[f]) - 1u);
  }
  HPA2_HD static void hput(const Args& a, int32_t* h, int f, int32_t v) {
    if (a.f_word[f] == 0)
      h[0] |= v << a.f_off[f];
    else
      h[1] |= v << a.f_off[f];
  }
  HPA2_HD void sharers(const Args&, const Msg& w, Set& s) const {
    if (w.set == nullptr) {
      zero(s);
      return;
    }
    wide_each(SW, [&](int j) { return w.set[j * P]; },
              [&](int j, int32_t v) { s.p[j * P] = v; });
  }
  HPA2_HD int field(const Args& a, const Msg& w, int f) const {
    return hget(a, w.h, f);
  }
  HPA2_HD void pack(const Args& a, Msg& w, int type, int addr, int aux,
                    bool has_aux, int second) const {
    w.h[0] = w.h[1] = 0;
    w.set = nullptr;
    hput(a, w.h, F_TYPE, type);
    hput(a, w.h, F_ADDR, addr);
    if (has_aux) hput(a, w.h, F_AUX, aux);
    if (second >= -1) hput(a, w.h, F_SECOND, second + 1);
  }
  HPA2_HD void pack(const Args& a, Msg& w, int type, int addr, int aux,
                    bool has_aux, int second, const Set& shr) const {
    pack(a, w, type, addr, aux, has_aux, second);
    w.set = shr.p;
  }
  HPA2_HD void put(SlotT& s, int recv, const Msg& w) const {
    s.recv = recv;
    s.m = w;
  }
  HPA2_HD void clear(SlotT& s) const {
    s.recv = -1;
    s.m.h[0] = s.m.h[1] = 0;
    s.m.set = nullptr;
  }
  HPA2_HD void load_dir(const Args& a, int l, int row, int32_t, int32_t,
                        Set& d) const {
    wide_each(SW, [&](int j) { return HPA2_AT(dirs[j], row); },
              [&](int j, int32_t v) { d.p[j * P] = v; });
  }
  HPA2_HD void store_dir(const Args& a, int l, int row, const Set& d) const {
    wide_each(SW, [&](int j) { return d.p[j * P]; },
              [&](int j, int32_t v) { HPA2_AT(dirs[j], row) = v; });
  }
  HPA2_HD int32_t word0(const Set& s) const { return s.p[0]; }
  HPA2_HD int32_t any(const Set& s) const {
    return wide_or(SW, [&](int j) { return s.p[j * P]; });
  }
  HPA2_HD int owner(const Set& s) const {
    for (int j0 = 0; j0 < SW; j0 += kWideBatch) {
      int32_t v[kWideBatch];
      HPA2_UNROLL for (int u = 0; u < kWideBatch; ++u)
        v[u] = j0 + u < SW ? s.p[(j0 + u) * P] : 0;
      HPA2_UNROLL for (int u = 0; u < kWideBatch; ++u)
        if (v[u] != 0) return find_owner(v[u]) + (j0 + u) * kSplitBpw;
    }
    return -1;
  }
  HPA2_HD int count(const Set& s) const {
    int c = 0;
    for (int j0 = 0; j0 < SW; j0 += kWideBatch)
      HPA2_UNROLL for (int u = 0; u < kWideBatch; ++u)
        if (j0 + u < SW) c += popc(s.p[(j0 + u) * P]);
    return c;
  }
  HPA2_HD bool test(const Set& s, int p) const {
    if (p < 0 || p >= SW * kSplitBpw) return false;
    return ((s.p[(size_t)(p / kSplitBpw) * P] >> (p % kSplitBpw)) & 1) == 1;
  }
  HPA2_HD void bit(Set& s, int p) const {
    for (int j = 0; j < SW; ++j) {
      const int q = p - j * kSplitBpw;
      s.p[j * P] = q >= 0 && q < kSplitBpw ? (int32_t)(1u << q) : 0;
    }
  }
  HPA2_HD void zero(Set& d) const {
    for (int j = 0; j < SW; ++j) d.p[j * P] = 0;
  }
  HPA2_HD void copy(Set& d, const Set& s) const {
    if (d.p != s.p)
      wide_each(SW, [&](int j) { return s.p[j * P]; },
                [&](int j, int32_t v) { d.p[j * P] = v; });
  }
  HPA2_HD void or_in(Set& d, const Set& s) const {
    wide_each(SW, [&](int j) { return d.p[j * P] | s.p[j * P]; },
              [&](int j, int32_t v) { d.p[j * P] = v; });
  }
  HPA2_HD void and_not(Set& d, const Set& x, const Set& y) const {
    wide_each(SW, [&](int j) { return x.p[j * P] & ~y.p[j * P]; },
              [&](int j, int32_t v) { d.p[j * P] = v; });
  }
};

template <class V>
struct NodeIn {
  int32_t nsw;
  int tl;
  int drecv[4];
  typename V::Msg inv;
  typename V::Msg head;
};

template <class V>
struct NodeAB {
  typename V::SlotT sl[4];
  int drecv[4];
  typename V::Set ish;
  int inv_addr;
  int32_t dv2, nswp;
  bool blocked, has_msg, elig, ev, inv_applied, rh, rm, wh, wm;
};

// Node row i of lane l handles its mailbox head, in slot 0 (A), and
// issues one instruction (B).  The planes are addressed by the row i; the
// node's global id gid is what the home, second-party and sender tests
// and the REPLY_ID fan's own bit compare (a node shard's rows start at
// its first node's id).  Its cache and directory rows are updated in
// place; its mailbox, nsw and outbox are not touched (the caller pops
// the head and writes the rest).  WideWords's o.ish is bound by the
// caller to the pair's kSetIsh row.
template <class V, bool PACKED>
HPA2_HD void node_ab(const Args& a, const V& v, const int l, const int i,
                     const int gid, const int seg, const NodeIn<V>& in,
                     NodeAB<V>& o) {
  using Set = typename V::Set;
  using Msg = typename V::Msg;
  using SlotT = typename V::SlotT;
  constexpr bool SPLIT = V::SPLIT;
  const int n = a.n, c = a.c, m = a.m;
  const int32_t sh_mask = (int32_t)((1u << (n < kSplitBpw ? n : kSplitBpw)) - 1u);
  Msg tmp;

  const int32_t nswv = in.nsw;
  const int mbc = nswv & a.count_mask;
  const int wt_in = (nswv >> a.off_wait) & 1;
  const int pw = (nswv >> a.off_pw) & 0xFF;
  const int pc = (nswv >> a.off_pc) & a.pc_mask;
  const int tl = in.tl;
  // deferred slots: receivers of 0, 1, 3, 4, and the INV slot's set
  int drecv[4];
  Set ish;
  v.bind(ish, kSetIsh);
  bool blocked = false;
  int32_t dv2 = 0;
  HPA2_UNROLL for (int q = 0; q < 4; ++q) {
    drecv[q] = in.drecv[q];
    blocked = blocked || drecv[q] != -1;
  }
  v.sharers(a, in.inv, ish);
  dv2 = v.any(ish);
  dv2 = dv2 != 0;
  blocked = blocked || dv2;
  int inv_addr = dv2 ? v.field(a, in.inv, F_ADDR) : 0;

  SlotT sl[4];  // slots 0, 1, 3, 4
  HPA2_UNROLL for (int q = 0; q < 4; ++q) v.clear(sl[q]);
  SlotT& sA0 = sl[0];
  SlotT& sA1 = sl[1];
  SlotT& sB0 = sl[2];
  SlotT& sB1 = sl[3];

  // ===== phase A: handle the mailbox head ==========================
  // (a blocked node handles nothing; its sends are its deferred ones)
  const bool has_msg = mbc > 0 && !blocked;
  int wt = wt_in;
  bool ev = false, inv_applied = false;
  if (has_msg) {
    // the head sits in slot 0; the caller pops it
    const Msg& head = in.head;
    const int mt = v.field(a, head, F_TYPE);
    const int snd = v.field(a, head, F_SENDER);
    const int sr = v.field(a, head, F_SECOND) - 1;
    const int ad = v.field(a, head, F_ADDR);
    const int aux = v.field(a, head, F_AUX);
    const int val = aux & 0xFF;

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
    Set dsh;
    v.bind(dsh, kSetDsh);
    v.load_dir(a, l, i * m + blk, dw, sh_mask, dsh);
    const bool line_match = line_addr == ad;
    const bool line_me = line_state == ST_M || line_state == ST_E;
    const int owner = v.owner(dsh);
    const bool owner_is_snd = owner == snd;
    Set snd_bit;
    v.bind(snd_bit, kSetSnd);
    v.bit(snd_bit, snd);
    const bool du = ds == D_U, dss = ds == D_S, dem = ds == D_EM;

    int nl_addr = line_addr, nl_val = line_val, nl_state = line_state;
    bool upd_line = false, upd_dir = false, mem_write = false;
    int nd_state = ds;
    Set nd_sh, sv;
    v.bind(nd_sh, kSetNdsh);
    v.bind(sv, kSetSv);
    v.copy(nd_sh, dsh);
    int mem_val = mem_blk;

    // evict the line (l_addr, l_val, l_state) into slot s
    auto evict = [&](SlotT& s, int l_addr, int l_val,
                     int l_state) -> bool {
      if (l_addr == -1 || l_state == ST_I) return false;
      v.pack(a, tmp, l_state == ST_M ? EVICT_MODIFIED : EVICT_SHARED,
             l_addr, l_val, true, -2);
      v.put(s, l_addr / m, tmp);
      return true;
    };

    switch (mt) {
      case READ_REQUEST:
        if (is_home) {
          if (du || dss || (dem && owner_is_snd)) {
            const bool excl = du || (dem && owner_is_snd);
            v.pack(a, tmp, REPLY_RD, ad, mem_blk | (excl ? 256 : 0), true, -2);
            v.put(sA0, snd, tmp);
          }
          const bool fwd = dem && !owner_is_snd;
          if (fwd) {
            v.pack(a, tmp, WRITEBACK_INT, ad, 0, false, snd);
            v.put(sA0, owner, tmp);
          }
          if (du || dss || fwd) upd_dir = true;
          if (du) nd_state = D_EM;
          if (fwd) nd_state = D_S;
          if (du) v.copy(nd_sh, snd_bit);
          if (dss || fwd) v.or_in(nd_sh, snd_bit);
        }
        break;
      case REPLY_RD:
        if (!line_match) ev = evict(sA0, line_addr, line_val, line_state);
        upd_line = true;
        nl_addr = ad;
        nl_val = val;
        nl_state = ((aux >> 8) & 1) ? ST_E : ST_S;
        wt = 0;
        break;
      case WRITEBACK_INT:
        if (line_match && line_me) {
          v.pack(a, tmp, FLUSH, ad, line_val, true, sr);
          v.put(sA0, home, tmp);
          if (sr != home) v.put(sA1, sr, tmp);
          upd_line = true;
          nl_state = ST_S;
        } else if (a.nack) {
          v.pack(a, tmp, NACK, ad, 0, false, sr);
          v.put(sA0, home, tmp);
        }
        break;
      case FLUSH:
        if (is_home) {
          mem_write = true;
          mem_val = val;
        }
        if (is_second) {
          if (!line_match) ev = evict(sA0, line_addr, line_val, line_state);
          upd_line = true;
          nl_addr = ad;
          nl_val = val;
          nl_state = ST_S;
          wt = 0;
        }
        break;
      case UPGRADE:
        if (is_home) {
          if (ds == D_S)
            v.and_not(sv, dsh, snd_bit);
          else
            v.zero(sv);
          v.pack(a, tmp, REPLY_ID, ad, 0, false, -2, sv);
          v.put(sA0, snd, tmp);
          upd_dir = true;
          nd_state = D_EM;
          v.copy(nd_sh, snd_bit);
        }
        break;
      case REPLY_ID:
        if (line_match && line_state != ST_M) {
          upd_line = true;
          nl_val = pw;
          nl_state = ST_M;
        }
        if (line_match) {
          Set self_bit;
          v.bind(self_bit, kSetSelf);
          v.bit(self_bit, gid);
          v.sharers(a, head, sv);
          v.and_not(ish, sv, self_bit);
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
            mem_val = val;
          }
          if (du || (dem && owner_is_snd)) {
            v.pack(a, tmp, REPLY_WR, ad, 0, false, -2);
            v.put(sA0, snd, tmp);
          }
          if (dss) {
            v.and_not(sv, dsh, snd_bit);
            v.pack(a, tmp, REPLY_ID, ad, 0, false, -2, sv);
            v.put(sA0, snd, tmp);
          }
          const bool wr_fwd = dem && !owner_is_snd;
          if (wr_fwd) {
            v.pack(a, tmp, WRITEBACK_INV, ad, 0, false, snd);
            v.put(sA0, owner, tmp);
          }
          if (du || dss || wr_fwd) {
            upd_dir = true;
            v.copy(nd_sh, snd_bit);
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
          v.pack(a, tmp, FLUSH_INVACK, ad, line_val, true, sr);
          v.put(sA0, home, tmp);
          if (sr != home) v.put(sA1, sr, tmp);
          upd_line = true;
          nl_state = ST_I;
        } else if (a.nack) {
          v.pack(a, tmp, NACK, ad, 1, true, sr);
          v.put(sA0, home, tmp);
        }
        break;
      case FLUSH_INVACK:
        if (is_home) {
          mem_write = true;
          mem_val = val;
          upd_dir = true;
          nd_state = D_EM;
          v.bit(nd_sh, sr);
        }
        if (is_second) {
          upd_line = true;
          nl_addr = ad;
          nl_val = a.flush_old_fill ? val : pw;
          nl_state = ST_M;
          wt = 0;
        }
        break;
      case EVICT_SHARED:
        if (is_home && v.test(dsh, snd)) {
          v.and_not(sv, dsh, snd_bit);
          const int cnt = v.count(sv);
          upd_dir = true;
          v.copy(nd_sh, sv);
          if (cnt == 0) nd_state = D_U;
          if (cnt == 1 && ds == D_S) {
            nd_state = D_EM;
            v.pack(a, tmp, UPGRADE_NOTIFY, ad, 0, false, -2);
            v.put(sA0, v.owner(sv), tmp);
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
          mem_val = val;
          if (ds == D_EM && v.test(dsh, snd)) {
            upd_dir = true;
            nd_state = D_U;
            v.zero(nd_sh);
          }
        }
        break;
      case NACK:
        if (a.nack && is_home) {
          upd_dir = true;
          v.bit(sv, sr);
          if (aux == 0) {
            nd_state = D_S;
            v.or_in(nd_sh, sv);
            v.pack(a, tmp, REPLY_RD, ad, mem_blk, true, -2);
          } else {
            nd_state = D_EM;
            v.copy(nd_sh, sv);
            v.pack(a, tmp, REPLY_WR, ad, 0, false, -2);
          }
          v.put(sA0, sr, tmp);
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
      if (!SPLIT) dwv |= (upd_dir ? v.word0(nd_sh) : v.word0(dsh)) << kDwShShift;
      dw_st<PACKED>(a, a.live, l, i * m + blk, dwv);
    }
    if (SPLIT && upd_dir) v.store_dir(a, l, i * m + blk, nd_sh);
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
      v.pack(a, tmp, l2_state == ST_M ? EVICT_MODIFIED : EVICT_SHARED,
             l2_addr, l2_val, true, -2);
      v.put(sB0, l2_addr / m, tmp);
      ev_issue = true;
    }
    if (rm) {
      v.pack(a, tmp, READ_REQUEST, ia, 0, false, -2);
      v.put(sB1, home2, tmp);
    }
    if (wm) {
      v.pack(a, tmp, WRITE_REQUEST, ia, iv, true, -2);
      v.put(sB1, home2, tmp);
    }
    const bool wh_me = is_wr && hit && (l2_state == ST_M || l2_state == ST_E);
    const bool wh_s = is_wr && hit && l2_state == ST_S;
    if (wh_s) {
      v.pack(a, tmp, UPGRADE, ia, 0, false, -2);
      v.put(sB1, home2, tmp);
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
  v.copy(o.ish, ish);
}

// ===== N1 and N4: a CTA a tile of lanes ================================
// Each kernel is a sequence of phase bodies over a CTA's shared tile of
// word rows, a barrier between phases; the tile holds a row's words for
// every (node row, lane) pair of the CTA, the lane fastest.
//
//   N1 (n1_phase): a CTA holds G lanes (kAbLanes, fewer when the tile
//   does not fit) of NR node rows, one thread a pair, so each of a
//   warp's accesses to a plane row is a row segment of 32 lanes (one
//   128-byte line); the lanes' NT node tiles are a cluster, which sums
//   the counters.
//                  0 gather: every load of a pair that depends on no
//                    other load, in flight together: nsw, the window
//                    length (tr_len), the four deferred receivers, the
//                    INV slot's and the mailbox head's W words; the
//                    counters zeroed;
//                  1 protocol: a pair with mail loads its mailbox slots
//                    1 .. cap - 1 into the tile (the rotation's reads,
//                    kRotBatch in flight); then runs node_ab on the
//                    staged words (its own dependent loads: the trace
//                    word, the cache and directory rows; a blocked node's
//                    deferred words) and leaves in the tile its
//                    candidates with the sender field, their receivers
//                    and combining keys, the INV word and receiver set;
//                    nsw and the counters' sums;
//                  2 write, after the cluster's barrier, stores only: the
//                    node tile 0 of the lanes writes their counters,
//                    summed over the cluster's tiles (distributed shared
//                    memory); every pair its mailbox rotation (every cap
//                    slot moves, stale ones too, so the planes stay the
//                    JAX package's), its payload words and its outbox;
//   N4 (n4_phase): a CTA holds G lanes (kSettleLanes, fewer when the
//   tile does not fit) of every node row; its threads are workers of the pairs, the threads beyond
//   one a pair parts of a pair's work (node_workers).
//                  0 gather: the acceptance words of the node's five
//                    candidates, the four receivers and their type words,
//                    the INV slot's words, nsw, the window length and
//                    snap_taken; the sums zeroed;
//                  1 settle, with no load of its own: a thread a (node
//                    row, lane) clears the delivered slots, keeps the
//                    rest and the INV remainder, decides phase D (flags a
//                    snapshot in the tile) and adds its sums; the
//                    threads with no node row load the lane inputs (the
//                    telemetry, the counters, the cycle);
//                  2 the parts of a flagged pair copy its node's cache
//                    and directory rows to the snapshot planes, and a
//                    thread a (row, lane) writes the lane's rows of the
//                    stacked SUM and MAX once.
//
// Every tile word a phase reads was written by an earlier phase of the
// same CTA, or of its cluster (the host build starts the tiles as
// garbage to show it).
constexpr int kN1Phases = 3;
constexpr int kN4Phases = 3;

// N1's and N4's launch geometry (ab_plan, settle_plan).  A CTA holds G
// lanes of NR node rows; N4's the lanes' every node row (NR = nl, NT =
// 1), N1's NT node tiles of NR rows, the cluster that holds one tile of
// lanes.
struct NodePlan {
  int32_t G;                      // lanes a CTA
  int32_t smem;                   // bytes of the shared tile
  int32_t NR;                     // node rows a CTA
  int32_t NT;                     // N1: node tiles, CTAs a cluster
};

// N1: lanes a CTA at most (a warp's row segment: one 128-byte line),
// threads a CTA at most, and CTAs a cluster at most (non-portable above
// 8); N4: lanes a CTA at most.  A card sweep of both (PERF.md) put 32
// first for N1 and 4 for N4.
constexpr int kAbLanes = 32;
constexpr int kAbCta = 128;
constexpr int kAbCluster = 16;
constexpr int kSettleLanes = 4;

// tile r of this CTA's cluster (rank `rank`, tiles of `words` words): on
// the card the peer's shared memory through distributed shared memory,
// in the host build the cluster's tiles side by side
HPA2_HD const int32_t* cluster_tile(int32_t* sh, int rank, int r,
                                    int words) {
#ifdef __CUDA_ARCH__
  return cooperative_groups::this_cluster().map_shared_rank(sh, r);
#else
  return sh + (long)(r - rank) * words;
#endif
}

// N1's tile rows: staged by the gather (NSW .. HEAD), then the protocol's
// (RECV is overwritten with each slot's receiver, INV with the INV word
// offered, its sharer fields clear), then (cap - 1) x W rows MB: slots 1
// .. cap - 1 of each mailbox word plane of a node with mail, loaded
// beside the protocol for the rotation (mb_rows)
template <int MAXN>
struct AbTile {
  static constexpr int KW = Bound<MAXN>::W, KSW = Bound<MAXN>::SW;
  static constexpr int NSW = 0, TL = 1, RECV = 2, INV = RECV + 4,
                       HEAD = INV + KW, SLOT = HEAD + KW,
                       ISH = SLOT + 4 * KW, KEY = ISH + KSW, FLAGS = KEY + 4,
                       MB = FLAGS + 1, kStaged = SLOT;
  // the tile's rows a (node row, lane) pair
  HPA2_HD static int rows(const Args& a) { return MB + (a.cap - 1) * a.W; }
};
enum { kFlagMsg = 1, kFlagBlocked = 2, kFlagInv = 4 };

// N4's tile rows: staged by the gather (ACC .. TYPE: TYPE + q the word
// of slot q's candidate that holds its type), then SNAP (a snapshot now)
// by the settle; after the rows, a lane's sums [kSettleRed][G] and its
// lane inputs [kLaneIn][G]: its exchange telemetry, counters and cycle
template <int MAXN>
struct SettleTile {
  static constexpr int KW = Bound<MAXN>::W, KSW = Bound<MAXN>::SW;
  static constexpr int ACC = 0, MASK = ACC + 5, RECV = MASK + KSW,
                       INV = RECV + 4, NSW = INV + KW, TL = NSW + 1,
                       TAKEN = TL + 1, TYPE = TAKEN + 1, SNAP = TYPE + 4,
                       kRows = SNAP + 1, kStaged = SNAP;
};
enum { LI_FS = 0, LI_CNT = LI_FS + kFStats, LI_CYCLE = LI_CNT + kABCount,
       kLaneIn };

// the plan of a launch that node_geometry_ok took: `rows` tile rows a
// node row and lane and `red` sums a lane, `lanes` lanes a CTA at most
// (halved while the tile does not fit); false when not even one lane a
// CTA fits
HPA2_HD bool node_plan(const NodeArgs& x, int rows, int red, int lanes,
                       NodePlan& pl, int max_smem) {
  for (int G = lanes; G >= 1; G /= 2) {
    const long long bytes = 4LL * G * ((long long)rows * x.nl + red);
    if (bytes <= max_smem) {
      pl.G = G;
      pl.smem = (int32_t)bytes;
      pl.NR = x.nl;
      pl.NT = 1;
      return true;
    }
  }
  return false;
}

// N1's plan: G lanes a CTA (kAbLanes) and NR = kAbCta / G node rows (at
// most nl, fewer while the tile does not fit), NT = ceil(nl / NR) CTAs a
// cluster; while the tile does not fit or the cluster would pass
// kAbCluster, G is halved (a long mailbox: NR grows back as G falls);
// false when not even one lane a CTA does
template <int MAXN>
HPA2_HD bool ab_plan(const NodeArgs& x, NodePlan& pl, int max_smem) {
  const long long rows = AbTile<MAXN>::rows(x.a);
  for (int G = kAbLanes; G >= 1; G /= 2) {
    int NR = kAbCta / G < x.nl ? kAbCta / G : x.nl;
    while (NR > 1 && 4LL * G * (rows * NR + kABCount) > max_smem) NR /= 2;
    const long long bytes = 4LL * G * (rows * NR + kABCount);
    const int NT = (x.nl + NR - 1) / NR;
    if (bytes <= max_smem && NT <= kAbCluster) {
      pl.G = G;
      pl.NR = NR;
      pl.NT = NT;
      pl.smem = (int32_t)bytes;
      return true;
    }
  }
  return false;
}

// N1's CTAs: the lanes' tiles, each a cluster of NT node tiles
HPA2_HD int ab_ctas(const NodeArgs& x, const NodePlan& pl) {
  return (x.a.b + pl.G - 1) / pl.G * pl.NT;
}

template <int MAXN>
HPA2_HD bool settle_plan(const NodeArgs& x, NodePlan& pl, int max_smem) {
  return node_plan(x, SettleTile<MAXN>::kRows, kSettleRed + kLaneIn,
                   kSettleLanes, pl, max_smem);
}

// N4's threads as workers of its NG = nl * G (node row, lane) pairs:
// pair p = i * G + g (lane fastest, so a warp's threads take
// neighbouring lanes of a row), P parts of the CTA's threads a pair (P =
// kNodeCta / NG, 1 when NG >= kNodeCta).  f(i, g, l, p, part, P) for
// each pair of a lane below b and each part; a thread derives its pair
// once and strides over its work by P, so the loops of a phase divide by
// nothing but constants.
template <class F>
HPA2_HD void node_workers(int tid, int G, int nl, int l0, int b, F f) {
  const int NG = nl * G, P = NG >= kNodeCta ? 1 : kNodeCta / NG;
  for (int it = tid; it < NG * P; it += kNodeCta) {
    const int p = it % NG, part = it / NG;
    const int g = p % G, l = l0 + g;
    if (l < b) f(p / G, g, l, p, part, P);
  }
}

// A worker's share of the gather: rows part, part + P, ... of the ROWS
// staged rows of its pair (ld(r) the word of row r), kGatherBatch loads
// issued before any of their stores into the tile column `col` (rows NG
// words apart).
constexpr int kGatherBatch = 16;

template <int ROWS, class Ld>
HPA2_HD void gather_rows(int part, int P, int NG, int32_t* col, Ld ld) {
  for (int r0 = part; r0 < ROWS; r0 += kGatherBatch * P) {
    int32_t v[kGatherBatch];
    HPA2_UNROLL for (int u = 0; u < kGatherBatch; ++u) {
      const int r = r0 + u * P;
      v[u] = r < ROWS ? ld(r) : 0;
    }
    HPA2_UNROLL for (int u = 0; u < kGatherBatch; ++u) {
      const int r = r0 + u * P;
      if (r < ROWS) col[r * NG] = v[u];
    }
  }
}

// mailbox words a thread of N1's protocol phase keeps in flight for the
// rotation
constexpr int kRotBatch = 32;

// ===== N1: phase ph of thread tid of CTA cta ==========================
// A CTA holds the G lanes of tile cta / NT and the NR node rows of tile
// cta % NT (its rank in the cluster of the lanes' NT CTAs), a thread a
// (node row, lane) pair, the lane fastest: so each of a warp's loads and
// stores is a row segment of 32 lanes (one 128-byte line at G = 32).
// The head is read from slot 0 and popped by rotating the mailbox left by
// one (the reference's rotation).  A free node's fresh sends are staged
// in its outbox with the sender and (packed) recv fields, as the words
// N4 keeps if they are not delivered; a blocked node's deferred slots
// are there already.  The INV slot holds the INV word with its receiver
// set.  The payload columns are the words the reference offers.
template <int MAXN, bool PACKED>
HPA2_HD void n1_phase(const NodeArgs& x, const NodePlan& pl, int ph,
                      int cta, int tid, int32_t* sh) {
  using Tl = AbTile<MAXN>;
  constexpr int KW = Tl::KW, KSW = Tl::KSW;
  constexpr bool SPLIT = Bound<MAXN>::SPLIT;
  const Args& a = x.a;
  const int G = pl.G, nl = x.nl, W = a.W, SW = a.SW, cap = a.cap;
  const int NP = pl.NR * G;                 // pairs (threads) a CTA
  const int rank = cta % pl.NT, il = tid / G, g = tid % G;
  const int i = rank * pl.NR + il, l = cta / pl.NT * G + g;
  const bool mine = tid < NP && i < nl && l < a.b;
  int32_t* col = sh + tid;
  auto at = [&](int row) -> int32_t& { return col[row * NP]; };
  uint32_t* red = reinterpret_cast<uint32_t*>(sh + Tl::rows(a) * NP);
  if (ph == 0) {
    for (int j = tid; j < kABCount * G; j += NP) red[j] = 0;
    if (!mine) return;
    gather_rows<Tl::kStaged>(0, 1, NP, col, [&](int r) -> int32_t {
      if (r == Tl::NSW) return HPA2_AT(a.nsw, i);
      if (r == Tl::TL) return window_len(a, l, i, a.seg);
      if (r < Tl::INV) return deferred_recv(a, l, i, one_slot(r - Tl::RECV));
      const int w = r < Tl::HEAD ? r - Tl::INV : r - Tl::HEAD;
      if (w >= W) return 0;
      return r < Tl::HEAD ? HPA2_AT(a.ob[w], i * kNSlots + 2)
                          : HPA2_AT(a.mb[w], i * cap);
    });
    return;
  }
  if (ph == 1) {
    if (!mine) return;
    // the rotation's reads: slots 1 .. cap - 1 of the W planes of a node
    // with mail into the rows MB, kRotBatch in flight
    const int rot = (cap - 1) * W;
    if (at(Tl::NSW) & a.count_mask)
      for (int c0 = 0; c0 < rot; c0 += kRotBatch) {
        int32_t v[kRotBatch];
        HPA2_UNROLL for (int u = 0; u < kRotBatch; ++u) {
          const int c = c0 + u;  // plane c / (cap - 1), slot c % .. + 1
          if (c < rot)
            v[u] = HPA2_AT(a.mb[c / (cap - 1)], i * cap + c % (cap - 1) + 1);
        }
        HPA2_UNROLL for (int u = 0; u < kRotBatch; ++u)
          if (c0 + u < rot) at(Tl::MB + c0 + u) = v[u];
      }
    const int snd_word = a.f_word[F_SENDER], snd_off = a.f_off[F_SENDER];
    const int gid = x.me * nl + i;
    using V = RegWords<MAXN>;
    NodeIn<V> in;
    in.nsw = at(Tl::NSW);
    in.tl = at(Tl::TL);
    HPA2_UNROLL for (int q = 0; q < 4; ++q) in.drecv[q] = at(Tl::RECV + q);
    HPA2_UNROLL for (int w = 0; w < KW; ++w) {
      in.inv[w] = at(Tl::INV + w);
      in.head[w] = at(Tl::HEAD + w);
    }
    NodeAB<V> o;
    node_ab<V, PACKED>(a, V{}, l, i, gid, a.seg, in, o);
    HPA2_AT(a.nsw, i) = o.nswp;
    // the candidates of slots 0, 1, 3, 4: a blocked node's deferred
    // words (in its outbox), else its fresh sends; the sender set
    HPA2_UNROLL for (int q = 0; q < 4; ++q) {
      const int r = o.blocked ? o.drecv[q] : o.sl[q].recv;
      int32_t w[KW];
      HPA2_UNROLL for (int j = 0; j < KW; ++j) {
        const int32_t base =
            o.blocked ? (j < W ? HPA2_AT(a.ob[j], i * kNSlots + one_slot(q)) : 0)
                      : o.sl[q].w[j];
        w[j] = base | (j == snd_word ? gid << snd_off : 0);
        at(Tl::SLOT + q * KW + j) = w[j];
      }
      at(Tl::RECV + q) = r;
      at(Tl::KEY + q) = r >= 0 && fget<KW>(a, w, F_TYPE) == READ_REQUEST
                            ? fget<KW>(a, w, F_ADDR) + 1 : 0;
    }
    // the INV word offered (its sharer fields clear) and its set
    int32_t w2[KW], inv_any = 0;
    inv_word<MAXN>(a, w2, gid, o.inv_addr);
    HPA2_UNROLL for (int j = 0; j < KW; ++j) at(Tl::INV + j) = w2[j];
    HPA2_UNROLL for (int q = 0; q < KSW; ++q) {
      at(Tl::ISH + q) = o.ish[q];
      inv_any |= o.ish[q];
    }
    at(Tl::FLAGS) = (o.has_msg ? kFlagMsg : 0) | (o.blocked ? kFlagBlocked : 0) |
                    (inv_any ? kFlagInv : 0);
    const bool inc[kABCount] = {o.elig, o.rh, o.rm, o.wh, o.wm, o.ev,
                                o.inv_applied};
    HPA2_UNROLL for (int j = 0; j < kABCount; ++j)
      if (inc[j]) sh_add(&red[j * G + g], 1);
    return;
  }
  // ph == 2, after the cluster's barrier: the tile's first CTA writes the
  // lanes' counters, summed over the cluster's tiles ...
  if (rank == 0)
    for (int j = tid; j < kABCount * G; j += NP) {
      const int lj = cta / pl.NT * G + j % G;
      if (lj >= a.b) continue;
      uint32_t sum = 0;
      for (int r = 0; r < pl.NT; ++r)
        sum += reinterpret_cast<const uint32_t*>(
            cluster_tile(sh, rank, r, pl.smem / 4) + Tl::rows(a) * NP)[j];
      x.cnt[(size_t)(j / G) * a.b + lj] = (int32_t)sum;
    }
  if (!mine) return;
  // ... and every thread its pair's stores: the mailbox rotated (slot s
  // takes slot s + 1's word, the last slot the head; every cap slot
  // moves, stale ones too, so the planes stay the JAX package's), the
  // payload rows [W + SW + 3, 5 nl, B] in the candidate order and the
  // outbox
  const int flags = at(Tl::FLAGS);
  if (flags & kFlagMsg)
    for (int w = 0; w < W; ++w) {
      int32_t* q = a.mb[w] + (size_t)i * cap * a.b + l;
      for (int s = 0; s < cap; ++s)
        q[(size_t)s * a.b] =
            at(s < cap - 1 ? Tl::MB + w * (cap - 1) + s : Tl::HEAD + w);
    }
  const int R = W + SW + 3, j0 = 5 * nl;
  HPA2_UNROLL for (int k = 0; k < 5; ++k) {
    const int q = k < 2 ? k : k - 1;  // slot k's candidate (k != 2)
    int32_t* pc = x.payload + (size_t)cand_col(nl, i, k) * a.b + l;
    const size_t rs = (size_t)j0 * a.b;  // a payload row
    for (int r = 0; r < W; ++r)
      pc[r * rs] = at(k == 2 ? Tl::INV + r : Tl::SLOT + q * KW + r);
    for (int r = 0; r < SW; ++r)
      pc[(W + r) * rs] = k == 2 ? at(Tl::ISH + r) : 0;
    pc[(W + SW) * rs] = k == 2 ? 0 : at(Tl::RECV + q) + 1;
    pc[(W + SW + 1) * rs] = k < 3;
    pc[(R - 1) * rs] = k == 2 ? 0 : at(Tl::KEY + q);
  }
  // the outbox: a free node's sends with the recv field (or ob_recv),
  // and every node's INV slot with its receiver set
  const int recv_w = a.f_word[F_RECV], recv_off = a.f_off[F_RECV];
  const int sh_f0 = SPLIT ? F_SHR0 : F_AUX;
  HPA2_UNROLL for (int k = 0; k < 5; ++k) {
    const int row = i * kNSlots + k;
    if (k == 2) {
      HPA2_UNROLL for (int j = 0; j < KW; ++j) {
        if (j >= W) continue;
        int32_t v = 0;
        if (flags & kFlagInv) {
          v = at(Tl::INV + j);
          HPA2_UNROLL for (int q = 0; q < KSW; ++q)
            if (q < (SPLIT ? SW : 1) && a.f_word[sh_f0 + q] == j)
              v |= at(Tl::ISH + q) << a.f_off[sh_f0 + q];
        }
        HPA2_AT(a.ob[j], row) = v;
      }
      continue;
    }
    const int q = k < 2 ? k : k - 1;
    const int r = at(Tl::RECV + q);
    if ((flags & kFlagBlocked) || r < 0) continue;
    HPA2_UNROLL for (int j = 0; j < KW; ++j)
      if (j < W)
        HPA2_AT(a.ob[j], row) =
            at(Tl::SLOT + q * KW + j) |
            (a.recv_packed && j == recv_w ? (r + 1) << recv_off : 0);
    if (!a.recv_packed) HPA2_AT(a.ob_recv, row) = r;
  }
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

// ===== N4: phase ph of thread tid (of kNodeCta) of CTA cta =============
// lane input `row` (LI_*) of lane l
HPA2_HD int32_t n4_lane_in(const NodeArgs& x, int l, int row) {
  const Args& a = x.a;
  if (row < LI_CNT) return x.fs[(size_t)(row - LI_FS) * a.b + l];
  if (row < LI_CYCLE) return x.cnt[(size_t)(row - LI_CNT) * a.b + l];
  return HPA2_AT(a.scalars, SC_CYCLE);
}

// row `row` of a lane's rows of the stacked SUM (row < kSumRows) and
// MAX, from its sums `red` and its lane inputs `in` (rows G words apart)
HPA2_HD int32_t n4_lane_row(int row, const uint32_t* red, const int32_t* in,
                            int G) {
  auto fs = [&](int r) { return in[(LI_FS + r) * G]; };
  auto cnt = [&](int r) { return in[(LI_CNT + r) * G]; };
  auto rd = [&](int r) { return (int32_t)red[r * G]; };
  if (row >= kSumRows) {
    const int32_t dg = fs(FS_DIAG);
    switch (row - kSumRows) {
      case M_HWM: return fs(FS_HWM);
      case M_DIAG: return dg;
      default:
        return dg > 0 ? (int32_t)((dg & ~0xFFFF) | (in[LI_CYCLE * G] & 0xFFFF))
                      : 0;
    }
  }
  if (row >= G_MC && row < G_MC + kNTypes) return rd(R_MC + row - G_MC);
  if (row > G_MD && row < G_MD + kABCount) return cnt(row - G_MD);
  switch (row) {
    case G_ACTIVE: return rd(R_ACTIVE);
    case G_SENT: return fs(FS_SENT);
    case G_XOVF: return fs(FS_OVF) > 1 ? 1 : fs(FS_OVF);
    case G_OVINC: return rd(R_OVINC) ? 1 : 0;
    case G_INSTR: return cnt(0);
    case G_MD: return rd(R_MD);
    case G_MCSAVED: return fs(FS_MC);
    default: return fs(FS_COMB);  // G_COMB
  }
}

template <int MAXN, bool PACKED>
HPA2_HD void n4_phase(const NodeArgs& x, const NodePlan& pl, int ph,
                      int cta, int tid, int32_t* sh) {
  using Tl = SettleTile<MAXN>;
  constexpr int T = kNodeCta, KW = Tl::KW, KSW = Tl::KSW;
  constexpr bool SPLIT = Bound<MAXN>::SPLIT;
  const Args& a = x.a;
  const int G = pl.G, nl = x.nl, W = a.W, SW = a.SW, c = a.c, m = a.m;
  const int l0 = cta * G, NG = nl * G, j0 = 5 * nl;
  uint32_t* red = reinterpret_cast<uint32_t*>(sh + Tl::kRows * NG);
  int32_t* lane_in = sh + Tl::kRows * NG + kSettleRed * G;
  if (ph == 0) {
    const int type_w = a.f_word[F_TYPE];
    node_workers(tid, G, nl, l0, a.b,
                 [&](int s, int, int l, int p, int part, int P) {
      gather_rows<Tl::kStaged>(part, P, NG, sh + p, [&](int r) -> int32_t {
        if (r < Tl::MASK)  // slot k's accepted count
          return x.acc[blk_at(0, j0, cand_col(nl, s, r - Tl::ACC), a.b, l)];
        if (r < Tl::RECV) {  // the INV slot's accepted bits, word w
          const int w = r - Tl::MASK;
          return w < SW ? x.acc[blk_at(1 + w, j0, cand_col(nl, s, 2), a.b, l)]
                        : 0;
        }
        if (r < Tl::INV) return deferred_recv(a, l, s, one_slot(r - Tl::RECV));
        if (r < Tl::NSW) {
          const int w = r - Tl::INV;
          return w < W ? HPA2_AT(a.ob[w], s * kNSlots + 2) : 0;
        }
        if (r == Tl::NSW) return HPA2_AT(a.nsw, s);
        if (r == Tl::TL) return window_len(a, l, s, a.seg);
        if (r == Tl::TAKEN) return a.snapshots ? HPA2_AT(a.snap_taken, s) : 0;
        return HPA2_AT(a.ob[type_w], s * kNSlots + one_slot(r - Tl::TYPE));
      });
    });
    for (int j = tid; j < kSettleRed * G; j += T) red[j] = 0;
    return;
  }
  if (ph == 1) {
    // the lane inputs, by the threads with no node row to settle (all
    // of them after their settles when there are none)
    const int t0 = NG < T ? NG : 0;
    for (int j = tid - t0; j >= 0 && j < kLaneIn * G; j += T - t0) {
      const int l = l0 + j % G;
      if (l < a.b) lane_in[j] = n4_lane_in(x, l, j / G);
    }
    const int type_off = a.f_off[F_TYPE];
    const int32_t type_mask = (int32_t)((1u << a.f_width[F_TYPE]) - 1u);
    const int sh_f0 = SPLIT ? F_SHR0 : F_AUX;
    for (int p = tid; p < NG; p += T) {
      const int g = p % G, s = p / G, l = l0 + g;
      if (l >= a.b) continue;
      int32_t* col = sh + p;
      auto at = [&](int row) -> int32_t& { return col[row * NG]; };
      const int gid = x.me * nl + s;
      uint32_t md = 0, ndefer = 0;
      bool blocked_next = false;
      HPA2_UNROLL for (int q = 0; q < 4; ++q) {
        const int k = one_slot(q), row = s * kNSlots + k;
        const int r = at(Tl::RECV + q);
        if (r < 0) continue;
        const int32_t d = at(Tl::ACC + k);
        if (d) {
          const int t = (at(Tl::TYPE + q) >> type_off) & type_mask;
          md += d;
          if (t < kNTypes) sh_add(&red[(R_MC + t) * G + g], d);
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
      HPA2_UNROLL for (int w = 0; w < KW; ++w) w2[w] = at(Tl::INV + w);
      msg_sharers<MAXN>(a, w2, sv);
      int32_t sv_any = 0;
      HPA2_UNROLL for (int w = 0; w < KSW; ++w) sv_any |= sv[w];
      if (sv_any) {
        int32_t rem[KSW], rem_any = 0;
        HPA2_UNROLL for (int w = 0; w < KSW; ++w) {
          rem[w] = w < SW ? sv[w] & ~at(Tl::MASK + w) : 0;
          rem_any |= rem[w];
        }
        const int32_t dinv = at(Tl::ACC + 2);
        if (dinv) {
          md += dinv;
          sh_add(&red[(R_MC + INV) * G + g], dinv);
        }
        int32_t nw[KW];
        inv_word<MAXN>(a, nw, gid, fget<KW>(a, w2, F_ADDR));
        HPA2_UNROLL for (int j = 0; j < KSW; ++j)
          if (j < (SPLIT ? SW : 1)) fput<KW>(a, nw, sh_f0 + j, rem[j]);
        HPA2_UNROLL for (int w = 0; w < KW; ++w)
          if (w < W) HPA2_AT(a.ob[w], s * kNSlots + 2) = rem_any ? nw[w] : 0;
        if (rem_any) {
          blocked_next = true;
          ++ndefer;
        }
      }
      const int32_t nswf = at(Tl::NSW);
      const int count3 = nswf & a.count_mask;
      const int wt = (nswf >> a.off_wait) & 1;
      const int pc = (nswf >> a.off_pc) & a.pc_mask;
      const int tl = at(Tl::TL);
      // ===== phase D: dump-at-local-completion snapshots ===============
      bool snap = false;
      if (a.snapshots) {
        const bool done = pc >= tl && wt == 0 && count3 == 0 && !blocked_next;
        const bool taken = at(Tl::TAKEN) != 0;
        snap = done && !taken;
        HPA2_AT(a.snap_taken, s) = (taken || done) ? 1 : 0;
      }
      at(Tl::SNAP) = snap;
      const uint32_t active =
          (uint32_t)(tl > pc ? tl - pc : 0) + wt + count3 + ndefer;
      if (active) sh_add(&red[R_ACTIVE * G + g], active);
      if (count3 > a.cap) sh_add(&red[R_OVINC * G + g], 1);
      if (md) sh_add(&red[R_MD * G + g], md);
    }
    return;
  }
  // ph == 2: a snapshot's rows (cache rows, then directory rows), a
  // worker's share of a flagged node's ...
  if (a.snapshots)
    node_workers(tid, G, nl, l0, a.b,
                 [&](int s, int, int l, int p, int part, int P) {
      if (!sh[Tl::SNAP * NG + p]) return;
      for (int r = part; r < c + m; r += P) {
        if (r < c)
          copy_rows<MAXN, PACKED>(a, l, s * c + r, s * c + r + 1, 0, 0);
        else
          copy_rows<MAXN, PACKED>(a, l, 0, 0, s * m + r - c,
                                  s * m + r - c + 1);
      }
    });
  // ... and the lane's rows of the stacked SUM and MAX
  for (int idx = tid; idx < (kSumRows + kMaxRows) * G; idx += T) {
    const int g = idx % G, row = idx / G, l = l0 + g;
    if (l >= a.b) continue;
    const int32_t v = n4_lane_row(row, red + g, lane_in + g, G);
    if (row < kSumRows)
      x.gsum[(size_t)row * a.b + l] = v;
    else
      x.gmax[(size_t)(row - kSumRows) * a.b + l] = v;
  }
}

// ===== the wide family: N1-N4 above kMaxNodes nodes ====================
// Systems wider than the widest register instantiation (the node axis
// exists for them: 4,096 nodes over four ranks is SW = 133 sharer words
// and W = 135 message words).  Split mode and int32 planes always
// (packed planes hold at most 14 nodes).  W and SW are run-time values;
// the word planes are reached through pointer tables in device memory
// (WideArgs: mb, ob, dirs), so Args and the register kernels' argument
// blocks keep their size.  Each kernel is a grid over the launch's work
// items, one thread an item, the lane fastest (so a warp's accesses to a
// plane row coalesce at any lane count), and no item reads what another
// item of the same launch writes: the sums that cross items are integer
// atomics into zeroed rows of global memory, and a step that needs every
// item's result is a launch of its own.
//   N1 node_ab_wide     two launches: an item a (node row, lane) pair:
//                       the gather of its nsw, window length, deferred
//                       receivers and staged INV and head sets (scratch
//                       rows kSetInv, kSetHead), node_ab<WideWords> (the
//                       one protocol body), and its stores: nsw, the
//                       payload's R rows of its five candidates, the
//                       outbox, whether it popped its head (the scratch's
//                       last row); its counters added to cnt; then
//                       rotate, an item a (word plane, pair): the popped
//                       mailboxes rotated in place, a plane's slots in
//                       flight together;
//   N2 node_bucket_wide three launches: flags (an item a (destination,
//                       entry, lane): the hit test over the destination's
//                       nonzero mask words only, the multicast savings,
//                       hier's keys, a key counted distinct by the item
//                       whose OR set its bit), scan (an item a
//                       (destination, lane): its flag words' exclusive
//                       prefix and total), scatter (an item an (entry,
//                       lane), a (destination, slot, lane) past the hits,
//                       or a lane's telemetry fold);
//   N3 node_deliver_wide two launches: sets (an item an (entry, lane):
//                       its local receivers' flag bits, a point receiver
//                       and its fan mask's words of this rank's nodes,
//                       and in a receiver's summary words the bit of each
//                       flag word it set), take (an item a (receiver,
//                       lane): its A then B flag words that are not zero,
//                       found from its summary words, in the global order
//                       while its queue has room, each taken entry's words
//                       into the mailbox and its feedback count and bit
//                       added);
//   N4 node_settle_wide two launches: settle (an item a (node row, lane):
//                       delivered slots cleared, the rest and the INV
//                       remainder kept, phase D, its sums added) and lane
//                       (an item a (row, lane) of the stacked SUM and
//                       MAX).
// threads a CTA of the wide kernels: 64, so that the 8,192 (node row,
// lane) items of a 4,096-node rank of 8 lanes are 128 CTAs, one an SM
constexpr int kWideCta = 64;

// What the wide family's N1, N3 and N4 take besides NodeArgs (whose
// x.a's word-plane arrays hold the first planes only).  Mirrored by
// ops/node_cycle.py:WideArgs.
struct WideArgs {
  NodeArgs x;
  int32_t* const* mb;            // [W] mailbox word planes
  int32_t* const* ob;            // [W] outbox word planes
  int32_t* const* dirs;          // [SW] live sharer planes
  int32_t* const* sdirs;         // [SW] snapshot sharer planes (snapshots)
  int32_t* work;                 // N1: [kWideSets * SW + 1, nl * B] scratch
  uint32_t* red;                 // N4: [kSettleRed, B] sums, zeroed
  uint32_t* wa;                  // N3: [nch + nsup, nl, B] phase-A flags
  uint32_t* wb;                  //     and phase-B flags, zeroed
};

// What the wide N2 takes besides BucketArgs (whose dmask is unused).
// Mirrored by ops/node_cycle.py:WideBucketArgs.
struct WideBucketArgs {
  BucketArgs x;
  const int32_t* dmask;          // [ndest, SW] a destination's node mask
  int32_t dwlo[kMaxShards];      // its first and last nonzero mask words
  int32_t dwhi[kMaxShards];
  uint32_t* bits;                // [nw, B] hit flags, zeroed
  uint32_t* base;                // [nw, B] hits before the word
  uint32_t* tot;                 // [ndest, B] hits
  uint32_t* lane;                // [3, B] multicast savings, shipped
                                 // combinable entries, distinct keys; zeroed
  uint32_t* keys;                // [nkw, B] key bitmap, zeroed
};

// *p |= v; true when no bit of v was set before (one caller a bit)
HPA2_HD bool or_was_clear(uint32_t* p, uint32_t v) {
#ifdef __CUDA_ARCH__
  return (atomicOr(reinterpret_cast<unsigned int*>(p), v) & v) == 0;
#else
  const uint32_t old = *p;
  *p |= v;
  return (old & v) == 0;
#endif
}

// the wide family takes the launch: a geometry node_geometry_ok takes,
// more than kMaxNodes nodes in int32 planes, and the split layout it is
// written for (every field but shr{w} in words 0 and 1, shr{j} all of
// word 2 + j)
HPA2_HD bool wide_ok(const NodeArgs& x) {
  const Args& a = x.a;
  if (!node_geometry_ok(x) || a.n <= kMaxNodes || a.packed || a.cap < 1 ||
      a.SW != (a.n + kSplitBpw - 1) / kSplitBpw || a.W != 2 + a.SW)
    return false;
  for (int f = 0; f < F_SHR0; ++f)
    if (a.f_word[f] < 0 || a.f_word[f] > 1) return false;
  return a.f_word[F_SHR0] == 2 && a.f_off[F_SHR0] == 0 &&
         a.f_width[F_SHR0] == kSplitBpw;
}

// ===== N1 wide: an item a (node row, lane) pair ========================
HPA2_HD void w1_item(const WideArgs& y, size_t item) {
  const NodeArgs& x = y.x;
  const Args& a = x.a;
  const int nl = x.nl, W = a.W, SW = a.SW, cap = a.cap;
  const size_t P = (size_t)nl * a.b;
  if (item >= P) return;
  const int i = (int)(item / a.b), l = (int)(item % a.b);
  const int gid = x.me * nl + i;
  using V = WideWords;
  const V v{SW, P, y.work + item, y.dirs};
  // the gather: the INV slot's and the mailbox head's header words, and
  // their sharer words staged in the scratch
  NodeIn<V> in;
  const int32_t nswv = HPA2_AT(a.nsw, i);
  in.nsw = nswv;
  in.tl = window_len(a, l, i, a.seg);
  HPA2_UNROLL for (int q = 0; q < 4; ++q)
    in.drecv[q] = deferred_recv(a, l, i, one_slot(q));
  V::Set sinv, shead;
  v.bind(sinv, kSetInv);
  v.bind(shead, kSetHead);
  const int row2 = i * kNSlots + 2;
  in.inv.h[0] = HPA2_AT(y.ob[0], row2);
  in.inv.h[1] = HPA2_AT(y.ob[1], row2);
  wide_each(SW, [&](int j) { return HPA2_AT(y.ob[2 + j], row2); },
            [&](int j, int32_t v) { sinv.p[j * P] = v; });
  in.inv.set = sinv.p;
  const bool mail = (nswv & a.count_mask) != 0;
  in.head.h[0] = mail ? HPA2_AT(y.mb[0], i * cap) : 0;
  in.head.h[1] = mail ? HPA2_AT(y.mb[1], i * cap) : 0;
  if (mail)
    wide_each(SW, [&](int j) { return HPA2_AT(y.mb[2 + j], i * cap); },
              [&](int j, int32_t v) { shead.p[j * P] = v; });
  in.head.set = mail ? shead.p : nullptr;
  NodeAB<V> o;
  v.bind(o.ish, kSetIsh);
  node_ab<V, false>(a, v, l, i, gid, a.seg, in, o);
  HPA2_AT(a.nsw, i) = o.nswp;

  // the payload's R rows of the five candidates: a blocked node's
  // deferred words (in its outbox), else its fresh sends, with the
  // sender field; the INV word offered (its sharer fields clear) with
  // its set in the mask rows
  const int snd_off = a.f_off[F_SENDER];
  const int32_t inv_any = v.any(o.ish);
  V::Msg winv;
  v.pack(a, winv, INV, o.inv_addr, 0, false, -2);
  V::hput(a, winv.h, F_SENDER, gid);
  const int R = W + SW + 3;
  const size_t rs = (size_t)5 * nl * a.b;  // a payload row
  int recv[5];
  HPA2_UNROLL for (int k = 0; k < 5; ++k) {
    int32_t* pc = x.payload + (size_t)cand_col(nl, i, k) * a.b + l;
    if (k == 2) {
      pc[0] = winv.h[0];
      pc[rs] = winv.h[1];
      for (int j = 0; j < SW; ++j) pc[(2 + j) * rs] = 0;
      wide_each(SW, [&](int j) { return o.ish.p[j * P]; },
                [&](int j, int32_t v) { pc[(W + j) * rs] = v; });
      pc[(W + SW) * rs] = 0;
      pc[(W + SW + 1) * rs] = 1;
      pc[(R - 1) * rs] = 0;
      continue;
    }
    const int q = k < 2 ? k : k - 1, slot = one_slot(q);
    const V::SlotT& sq = o.sl[q];
    const int r = o.blocked ? o.drecv[q] : sq.recv;
    recv[k] = r;
    auto word = [&](int j) -> int32_t {
      const int32_t w =
          o.blocked ? HPA2_AT(y.ob[j], i * kNSlots + slot)
          : j < 2   ? (j == 0 ? sq.m.h[0] : sq.m.h[1])
          : sq.m.set != nullptr ? sq.m.set[(j - 2) * P] : 0;
      return j == a.f_word[F_SENDER] ? w | gid << snd_off : w;
    };
    const int32_t h[2] = {word(0), word(1)};
    wide_each(W, word, [&](int j, int32_t w) { pc[j * rs] = w; });
    for (int j = 0; j < SW; ++j) pc[(W + j) * rs] = 0;
    pc[(W + SW) * rs] = r + 1;
    pc[(W + SW + 1) * rs] = k < 3;
    pc[(R - 1) * rs] = r >= 0 && V::hget(a, h, F_TYPE) == READ_REQUEST
                           ? V::hget(a, h, F_ADDR) + 1 : 0;
  }
  // the mailbox is rotated by w1_rotate
  y.work[(size_t)kWideSets * SW * P + item] = o.has_msg;
  // the outbox: every node's INV slot with its receiver set, a free
  // node's sends with the recv field (or ob_recv)
  wide_each(W,
            [&](int j) -> int32_t {
              return !inv_any ? 0
                     : j < 2  ? (j == 0 ? winv.h[0] : winv.h[1])
                              : o.ish.p[(j - 2) * P];
            },
            [&](int j, int32_t v) { HPA2_AT(y.ob[j], row2) = v; });
  const int recv_w = a.f_word[F_RECV], recv_off = a.f_off[F_RECV];
  HPA2_UNROLL for (int k = 0; k < 5; ++k) {
    if (k == 2) continue;
    const int q = k < 2 ? k : k - 1, r = recv[k];
    if (o.blocked || r < 0) continue;
    const V::SlotT& sq = o.sl[q];
    const int row = i * kNSlots + k;
    wide_each(W,
              [&](int j) -> int32_t {
                int32_t w = j < 2 ? (j == 0 ? sq.m.h[0] : sq.m.h[1])
                            : sq.m.set != nullptr ? sq.m.set[(j - 2) * P] : 0;
                if (j == a.f_word[F_SENDER]) w |= gid << snd_off;
                if (a.recv_packed && j == recv_w) w |= (r + 1) << recv_off;
                return w;
              },
              [&](int j, int32_t w) { HPA2_AT(y.ob[j], row) = w; });
    if (!a.recv_packed) HPA2_AT(a.ob_recv, row) = r;
  }
  const bool inc[kABCount] = {o.elig, o.rh, o.rm, o.wh, o.wm, o.ev,
                              o.inv_applied};
  HPA2_UNROLL for (int j = 0; j < kABCount; ++j)
    if (inc[j])
      sh_add(reinterpret_cast<uint32_t*>(&x.cnt[(size_t)j * a.b + l]), 1);
}

// N1's launch 2, an item a (word plane w, pair): items W * nl * B.  A
// pair that popped its head rotates mailbox plane w in place (every cap
// slot moves, stale ones too, so the planes stay the JAX package's).
HPA2_HD void w1_rotate(const WideArgs& y, size_t item) {
  const NodeArgs& x = y.x;
  const Args& a = x.a;
  const size_t P = (size_t)x.nl * a.b;
  if (item >= P * a.W) return;
  const size_t p = item % P;
  if (!y.work[(size_t)kWideSets * a.SW * P + p]) return;
  const int w = (int)(item / P), i = (int)(p / a.b), l = (int)(p % a.b);
  const int cap = a.cap;
  int32_t* q = y.mb[w] + (size_t)i * cap * a.b + l;
  const int32_t head = q[0];
  wide_each(cap - 1, [&](int s) { return q[(size_t)(s + 1) * a.b]; },
            [&](int s, int32_t v) { q[(size_t)s * a.b] = v; });
  q[(size_t)(cap - 1) * a.b] = head;
}

// ===== N2 wide =========================================================
// the plan of a launch: each destination's flag words (woff, nw) and the
// key bitmap's words (nkw); false when the kernels do not take it
HPA2_HD bool wide_bucket_plan(const WideBucketArgs& y, BucketPlan& pl) {
  const BucketArgs& x = y.x;
  if (x.ndest < 1 || x.ndest > kMaxShards || x.b < 1 || x.k < 1 ||
      x.SW < 1 || x.nl < 1 || x.nkeys < 0 || x.W != 2 + x.SW)
    return false;
  int w = 0;
  for (int p = 0; p < x.ndest; ++p) {
    if (x.dblk[p] < 0 || x.dblk[p] >= kMaxShards || y.dwlo[p] < 0 ||
        y.dwhi[p] >= x.SW)
      return false;
    pl.woff[p] = w;
    w += (x.blen[x.dblk[p]] + 31) / 32;
  }
  pl.woff[x.ndest] = w;
  pl.nw = w;
  pl.nkw = x.combine ? (x.nkeys + 31) / 32 : 0;
  pl.G = 1;
  pl.smem = 0;
  return true;
}

// launch 1, an item a (flag-word entry e, lane): items nw * 32 * B
HPA2_HD void w2_flags(const WideBucketArgs& y, const BucketPlan& pl,
                      size_t item) {
  const BucketArgs& x = y.x;
  const int l = (int)(item % x.b);
  const int e = (int)(item / x.b);
  if (e >= pl.nw * 32) return;
  const int p = bucket_dest_of(x, pl, e >> 5);
  const int j = e - pl.woff[p] * 32, J = x.blen[x.dblk[p]];
  if (j >= J) return;
  const int32_t* __restrict__ blk = x.blk[x.dblk[p]];
  const int32_t* dm = y.dmask + (size_t)p * x.SW;
  const int q = blk[blk_at(x.W + x.SW, J, j, x.b, l)] - 1;
  bool hit = q >= 0 && q < x.n && ((x.dset[p] >> (q / x.nl)) & 1);
  int pop = 0;
  for (int w = y.dwlo[p]; w <= y.dwhi[p]; ++w) {
    const int32_t mw = blk[blk_at(x.W + w, J, j, x.b, l)] & dm[w];
    hit = hit || mw != 0;
    pop += popc(mw);
  }
  if (!hit) return;
  sh_or(reinterpret_cast<int32_t*>(&y.bits[(size_t)(e >> 5) * x.b + l]),
        (int32_t)(1u << (e & 31)));
  const int flags = x.dflags[p];
  if ((flags & kDestStat) && pop > 1) sh_add(&y.lane[l], (uint32_t)(pop - 1));
  if (x.combine && (flags & kDestCompact)) {
    const int key = blk[blk_at(x.W + x.SW + 2, J, j, x.b, l)];
    if (key >= 1 && key <= x.nkeys) {
      sh_add(&y.lane[x.b + l], 1);
      if (or_was_clear(&y.keys[(size_t)((key - 1) >> 5) * x.b + l],
                       1u << ((key - 1) & 31)))
        sh_add(&y.lane[2 * x.b + l], 1);
    }
  }
}

// launch 2, an item a (destination, lane): items ndest * B
HPA2_HD void w2_scan(const WideBucketArgs& y, const BucketPlan& pl,
                     size_t item) {
  const BucketArgs& x = y.x;
  const int l = (int)(item % x.b), p = (int)(item / x.b);
  if (p >= x.ndest) return;
  uint32_t run = 0;
  for (int w = pl.woff[p]; w < pl.woff[p + 1]; ++w) {
    const size_t at = (size_t)w * x.b + l;
    y.base[at] = run;
    run += (uint32_t)popc((int32_t)y.bits[at]);
  }
  y.tot[(size_t)p * x.b + l] = run;
}

// launch 3, an item an (entry, lane) (nw * 32 * B), then a (destination,
// slot, lane) (ndest * k * B), then a lane (B)
HPA2_HD size_t w2_scatter_items(const BucketArgs& x, const BucketPlan& pl) {
  return ((size_t)pl.nw * 32 + (size_t)x.ndest * x.k + 1) * x.b;
}

HPA2_HD void w2_scatter(const WideBucketArgs& y, const BucketPlan& pl,
                        size_t item) {
  const BucketArgs& x = y.x;
  const int k = x.k, R = x.W + x.SW + 3;
  const size_t n_ent = (size_t)pl.nw * 32 * x.b;
  const size_t n_tail = (size_t)x.ndest * k * x.b;
  if (item < n_ent) {
    const int l = (int)(item % x.b), e = (int)(item / x.b);
    const int p = bucket_dest_of(x, pl, e >> 5);
    const int j = e - pl.woff[p] * 32, J = x.blen[x.dblk[p]];
    if (j >= J || !(x.dflags[p] & kDestCompact)) return;
    const int bit = e & 31;
    const size_t at = (size_t)(e >> 5) * x.b + l;
    const uint32_t word = y.bits[at];
    int64_t slot = k;
    if ((word >> bit) & 1) {
      const int pos = (int)y.base[at] + popc((int32_t)(word & ((1u << bit) - 1u)));
      if (pos < k) {
        const int32_t* __restrict__ blk = x.blk[x.dblk[p]];
        int32_t* __restrict__ buf = x.buf[p];
        for (int r = 0; r < R; ++r)
          buf[blk_at(r, k, pos, x.b, l)] = blk[blk_at(r, J, j, x.b, l)];
        slot = pos;
      }
    }
    x.sel[p][(size_t)j * x.b + l] = slot;
    return;
  }
  item -= n_ent;
  if (item < n_tail) {
    const int l = (int)(item % x.b);
    const int slot = (int)((item / x.b) % k), p = (int)(item / ((size_t)x.b * k));
    if (!(x.dflags[p] & kDestCompact) ||
        slot < (int)y.tot[(size_t)p * x.b + l])
      return;
    int32_t* __restrict__ buf = x.buf[p];
    for (int r = 0; r < R; ++r) buf[blk_at(r, k, slot, x.b, l)] = 0;
    return;
  }
  item -= n_tail;
  if (item >= (size_t)x.b) return;
  // the lane's telemetry folded into fs once
  const int l = (int)item;
  int32_t* fs = x.fs;
  auto at = [&](int row) -> int32_t& { return fs[(size_t)row * x.b + l]; };
  int32_t sent = at(FS_SENT), hwm = at(FS_HWM), ovf = at(FS_OVF),
          diag = at(FS_DIAG);
  for (int p = 0; p < x.ndest; ++p) {
    const int32_t t = (int32_t)y.tot[(size_t)p * x.b + l];
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
  at(FS_MC) += (int32_t)y.lane[l];
  if (x.combine)
    at(FS_COMB) += (int32_t)(y.lane[x.b + l] - y.lane[2 * x.b + l]);
}

// ===== N3 wide =========================================================
// the plan of a launch that wide_ok took: the entries (J, each block's
// first, boff) and the flag words a receiver a phase (nch); after them a
// phase's (nch + 31) / 32 summary words a receiver, bit u of summary
// word s set when flag word 32 s + u is not zero
HPA2_HD bool wide_deliver_plan(const NodeArgs& x, DeliverPlan& pl) {
  int J = 0;
  for (int b = 0; b < x.nblk; ++b) {
    pl.boff[b] = J;
    J += x.blen[b];
  }
  pl.boff[x.nblk] = J;
  pl.J = J;
  pl.nch = (J + 31) / 32;
  pl.G = 1;
  pl.smem = 0;
  return J >= 1;
}

// launch 1, an item an (entry, lane): items J * B
HPA2_HD void w3_sets(const WideArgs& y, const DeliverPlan& pl, size_t item) {
  const NodeArgs& x = y.x;
  const Args& a = x.a;
  const int nl = x.nl, W = a.W, SW = a.SW;
  const int l = (int)(item % a.b), e = (int)(item / a.b);
  if (e >= pl.J) return;
  const int lo = x.me * nl;
  const int b = deliver_block_of(x, pl, e);
  const int j = e - pl.boff[b], J = x.blen[b];
  const int32_t* __restrict__ blk = x.blk[b];
  uint32_t* flag = blk[blk_at(W + SW + 1, J, j, a.b, l)] != 0 ? y.wa : y.wb;
  const int c = e >> 5, sup = pl.nch + (c >> 5);
  const int32_t bit = (int32_t)(1u << (e & 31));
  auto mark = [&](int i) {
    sh_or(reinterpret_cast<int32_t*>(&flag[((size_t)c * nl + i) * a.b + l]),
          bit);
    sh_or(reinterpret_cast<int32_t*>(&flag[((size_t)sup * nl + i) * a.b + l]),
          (int32_t)(1u << (c & 31)));
  };
  const int q = blk[blk_at(W + SW, J, j, a.b, l)] - 1 - lo;
  if (q >= 0 && q < nl) mark(q);
  const int w_hi = (lo + nl - 1) / kSplitBpw;
  for (int w = lo / kSplitBpw; w <= w_hi && w < SW; ++w) {
    int32_t m = blk[blk_at(W + w, J, j, a.b, l)] & 0x7FFFFFFF;
    while (m) {
      const int i = w * kSplitBpw + find_owner(m) - lo;
      m &= m - 1;
      if (i >= 0 && i < nl) mark(i);
    }
  }
}

// launch 2, an item a (receiver, lane): items nl * B
HPA2_HD void w3_take(const WideArgs& y, const DeliverPlan& pl, size_t item) {
  const NodeArgs& x = y.x;
  const Args& a = x.a;
  const int nl = x.nl, W = a.W, cap = a.cap;
  const int l = (int)(item % a.b), i = (int)(item / a.b);
  if (i >= nl) return;
  const int gid = x.me * nl + i;
  const int32_t nswv = HPA2_AT(a.nsw, i);
  const int count2 = nswv & a.count_mask, room = cap - count2;
  int rank = 0;
  auto take = [&](int e) {
    const int b = deliver_block_of(x, pl, e);
    const int j = e - pl.boff[b], J = x.blen[b];
    const int32_t* __restrict__ blk = x.blk[b];
    const int slot = count2 + rank;
    wide_each(W, [&](int w) { return blk[blk_at(w, J, j, a.b, l)]; },
              [&](int w, int32_t v) { HPA2_AT(y.mb[w], i * cap + slot) = v; });
    int32_t* fb = x.fb[b];
    sh_add(reinterpret_cast<uint32_t*>(&fb[blk_at(0, J, j, a.b, l)]), 1);
    sh_or(&fb[blk_at(1 + gid / kSplitBpw, J, j, a.b, l)],
          (int32_t)(1u << (gid % kSplitBpw)));
    ++rank;
  };
  // the summary words kWideBatch at a time, their loads in flight
  // together; then only the flag words they mark
  const int nsup = (pl.nch + 31) / 32;
  for (int ph = 0; ph < 2 && rank < room; ++ph) {
    const uint32_t* flag = ph == 0 ? y.wa : y.wb;
    for (int s0 = 0; s0 < nsup && rank < room; s0 += kWideBatch) {
      uint32_t sups[kWideBatch];
      HPA2_UNROLL for (int u = 0; u < kWideBatch; ++u)
        sups[u] = s0 + u < nsup
            ? flag[((size_t)(pl.nch + s0 + u) * nl + i) * a.b + l] : 0u;
      HPA2_UNROLL for (int u = 0; u < kWideBatch; ++u) {
        uint32_t m = sups[u];
        while (m && rank < room) {
          const int c = (s0 + u) * 32 + find_owner((int32_t)m);
          m &= m - 1u;
          uint32_t word = flag[((size_t)c * nl + i) * a.b + l];
          while (word && rank < room) {
            take(c * 32 + find_owner((int32_t)word));
            word &= word - 1u;
          }
        }
      }
    }
  }
  if (rank) HPA2_AT(a.nsw, i) = nswv + rank;
}

// ===== N4 wide =========================================================
// launch 1, an item a (node row, lane) pair: items nl * B
HPA2_HD void w4_item(const WideArgs& y, size_t item) {
  const NodeArgs& x = y.x;
  const Args& a = x.a;
  const int nl = x.nl, W = a.W, SW = a.SW, c = a.c, m = a.m;
  if (item >= (size_t)nl * a.b) return;
  const int s = (int)(item / a.b), l = (int)(item % a.b);
  const int gid = x.me * nl + s, j0 = 5 * nl;
  uint32_t* red = y.red;
  auto add = [&](int row, uint32_t v) {
    if (v) sh_add(&red[(size_t)row * a.b + l], v);
  };
  const int type_w = a.f_word[F_TYPE], type_off = a.f_off[F_TYPE];
  const int32_t type_mask = (int32_t)((1u << a.f_width[F_TYPE]) - 1u);
  uint32_t md = 0, ndefer = 0;
  bool blocked_next = false;
  HPA2_UNROLL for (int q = 0; q < 4; ++q) {
    const int k = one_slot(q), row = s * kNSlots + k;
    const int r = deferred_recv(a, l, s, k);
    if (r < 0) continue;
    const int32_t d = x.acc[blk_at(0, j0, cand_col(nl, s, k), a.b, l)];
    if (d) {
      const int t = (HPA2_AT(y.ob[type_w], row) >> type_off) & type_mask;
      md += d;
      if (t < kNTypes) add(R_MC + t, d);
      for (int w = 0; w < W; ++w) HPA2_AT(y.ob[w], row) = 0;
      if (!a.recv_packed) HPA2_AT(a.ob_recv, row) = -1;
    } else {
      blocked_next = true;
      ++ndefer;
    }
  }
  // the INV slot: the receivers that did not accept stay in its set
  const int row2 = s * kNSlots + 2, col2 = cand_col(nl, s, 2);
  int32_t rem_any = 0;
  const int32_t sv_any =
      wide_or(SW, [&](int j) { return HPA2_AT(y.ob[2 + j], row2); });
  if (sv_any) {
    wide_each(SW,
              [&](int j) {
                return HPA2_AT(y.ob[2 + j], row2) &
                       ~x.acc[blk_at(1 + j, j0, col2, a.b, l)];
              },
              [&](int j, int32_t rem) {
                HPA2_AT(y.ob[2 + j], row2) = rem;
                rem_any |= rem;
              });
    const int32_t dinv = x.acc[blk_at(0, j0, col2, a.b, l)];
    if (dinv) {
      md += dinv;
      add(R_MC + INV, dinv);
    }
    int32_t h[2] = {HPA2_AT(y.ob[0], row2), HPA2_AT(y.ob[1], row2)};
    const int addr = WideWords::hget(a, h, F_ADDR);
    h[0] = h[1] = 0;
    WideWords::hput(a, h, F_TYPE, INV);
    WideWords::hput(a, h, F_ADDR, addr);
    WideWords::hput(a, h, F_SENDER, gid);
    HPA2_AT(y.ob[0], row2) = rem_any ? h[0] : 0;
    HPA2_AT(y.ob[1], row2) = rem_any ? h[1] : 0;
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
    HPA2_AT(a.snap_taken, s) = (taken || done) ? 1 : 0;
    if (done && !taken) {
      copy_rows<8, false>(a, l, s * c, s * c + c, s * m, s * m + m);
      for (int r = s * m; r < s * m + m; ++r)
        wide_each(SW, [&](int j) { return HPA2_AT(y.dirs[j], r); },
                  [&](int j, int32_t v) { HPA2_AT(y.sdirs[j], r) = v; });
    }
  }
  add(R_ACTIVE, (uint32_t)(tl > pc ? tl - pc : 0) + wt + count3 + ndefer);
  add(R_OVINC, count3 > a.cap ? 1 : 0);
  add(R_MD, md);
}

// launch 2, an item a (row, lane) of the stacked SUM and MAX: items
// (kSumRows + kMaxRows) * B
HPA2_HD void w4_lane(const WideArgs& y, size_t item) {
  const NodeArgs& x = y.x;
  const int b = x.a.b;
  if (item >= (size_t)(kSumRows + kMaxRows) * b) return;
  const int l = (int)(item % b), row = (int)(item / b);
  uint32_t red[kSettleRed];
  int32_t in[kLaneIn];
  for (int r = 0; r < kSettleRed; ++r) red[r] = y.red[(size_t)r * b + l];
  for (int r = 0; r < kLaneIn; ++r) in[r] = n4_lane_in(x, l, r);
  const int32_t v = n4_lane_row(row, red, in, 1);
  if (row < kSumRows)
    x.gsum[(size_t)row * b + l] = v;
  else
    x.gmax[(size_t)(row - kSumRows) * b + l] = v;
}

}  // namespace hpa2
