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
//   TileWords       (the wide family, any n above 64; int32 planes, split
//                   mode) SW = ceil(n / 31) and W = 2 + SW are run-time
//                   values: a sharer set is SW consecutive words of the
//                   pair's sets in N1w's shared tile, and a warp runs
//                   the pair, each lane a set operation's words j, j +
//                   32, ... (the reads of a set, any, owner and count,
//                   warp reductions); a message is its two header words
//                   and a reference to the set its shr{w} fields carry
//                   (none: zero), so that no word vector has to live in
//                   registers.
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

// wide_each over the words j0, j0 + step, ... below n (a thread's share
// of a loop its CTA or warp splits), kStrideBatch loads in flight: few,
// since a thread takes few words of each such loop and every unrolled
// load costs its instructions whether it runs or not
constexpr int kStrideBatch = 4;

template <class Ld, class St>
HPA2_HD void strided_each(int j0, int step, int n, Ld ld, St st) {
  for (int b0 = j0; b0 < n; b0 += step * kStrideBatch) {
    int32_t v[kStrideBatch];
    HPA2_UNROLL for (int u = 0; u < kStrideBatch; ++u)
      if (b0 + u * step < n) v[u] = ld(b0 + u * step);
    HPA2_UNROLL for (int u = 0; u < kStrideBatch; ++u)
      if (b0 + u * step < n) st(b0 + u * step, v[u]);
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

// the wide family's sets a pair: its INV slot's and its mailbox head's,
// staged by N1w's gather, then the body's
enum { kSetInv = 0, kSetHead, kSetIsh, kSetDsh, kSetNdsh, kSetSv, kSetSnd,
       kSetSelf, kWideSets };

// A warp runs a pair of N1w (TileWords): on the card, this thread's lane
// and the lanes' stride over a set's words, a barrier of the warp, and
// reductions over its lanes.  The host build runs a warp as one thread
// (lane 0, stride 1: every word), so the same partition of a set's words
// and the same body run there; only the reductions' hardware differs.
HPA2_HD int warp_lane() {
#ifdef __CUDA_ARCH__
  return (int)(threadIdx.x & 31u);
#else
  return 0;
#endif
}

HPA2_HD int warp_step() {
#ifdef __CUDA_ARCH__
  return 32;
#else
  return 1;
#endif
}

HPA2_HD void warp_sync() {
#ifdef __CUDA_ARCH__
  __syncwarp();
#endif
}

HPA2_HD uint32_t warp_or(uint32_t v) {
#ifdef __CUDA_ARCH__
  return __reduce_or_sync(0xFFFFFFFFu, v);
#else
  return v;
#endif
}

HPA2_HD int warp_add(int v) {
#ifdef __CUDA_ARCH__
  return __reduce_add_sync(0xFFFFFFFFu, v);
#else
  return v;
#endif
}

HPA2_HD int warp_min(int v) {
#ifdef __CUDA_ARCH__
  return __reduce_min_sync(0xFFFFFFFFu, v);
#else
  return v;
#endif
}

struct TileWords {
  static constexpr bool SPLIT = true;
  struct Set {
    int32_t* p;
  };
  struct Msg {
    int32_t h[2];                 // header words 0 and 1
    const int32_t* set;           // its shr{w} words, or null
  };
  struct SlotT {
    int recv;
    Msg m;
  };
  int SW;
  int32_t* base;                  // this pair's set 0 (set k SW words on)
  int32_t* const* dirs;           // [SW] live sharer planes (N1w: the
                                  // tile's copy of the table)
  // f(j) for this lane's words of a set, then the warp's barrier, so that
  // a later read of another lane's word sees what f wrote
  template <class F>
  HPA2_HD void each(F f) const {
    for (int j = warp_lane(); j < SW; j += warp_step()) f(j);
    warp_sync();
  }
  HPA2_HD void bind(Set& s, int k) const { s.p = base + k * SW; }
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
    const int32_t* src = w.set;
    each([&](int j) { s.p[j] = src[j]; });
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
    strided_each(warp_lane(), warp_step(), SW,
                 [&](int j) { return HPA2_AT(dirs[j], row); },
                 [&](int j, int32_t v) { d.p[j] = v; });
    warp_sync();
  }
  HPA2_HD void store_dir(const Args& a, int l, int row, const Set& d) const {
    each([&](int j) { HPA2_AT(dirs[j], row) = d.p[j]; });
  }
  HPA2_HD int32_t word0(const Set& s) const { return s.p[0]; }
  HPA2_HD int32_t any(const Set& s) const {
    uint32_t v = 0;
    for (int j = warp_lane(); j < SW; j += warp_step()) v |= (uint32_t)s.p[j];
    return (int32_t)warp_or(v);
  }
  // the lowest member: the warp's first nonzero word
  HPA2_HD int owner(const Set& s) const {
    int first = SW;
    for (int j = warp_lane(); j < SW; j += warp_step())
      if (s.p[j] != 0) {
        first = j;
        break;
      }
    first = warp_min(first);
    return first < SW ? find_owner(s.p[first]) + first * kSplitBpw : -1;
  }
  HPA2_HD int count(const Set& s) const {
    int c = 0;
    for (int j = warp_lane(); j < SW; j += warp_step()) c += popc(s.p[j]);
    return warp_add(c);
  }
  HPA2_HD bool test(const Set& s, int p) const {
    if (p < 0 || p >= SW * kSplitBpw) return false;
    return ((s.p[p / kSplitBpw] >> (p % kSplitBpw)) & 1) == 1;
  }
  HPA2_HD void bit(Set& s, int p) const {
    each([&](int j) {
      const int q = p - j * kSplitBpw;
      s.p[j] = q >= 0 && q < kSplitBpw ? (int32_t)(1u << q) : 0;
    });
  }
  HPA2_HD void zero(Set& d) const {
    each([&](int j) { d.p[j] = 0; });
  }
  HPA2_HD void copy(Set& d, const Set& s) const {
    if (d.p != s.p) each([&](int j) { d.p[j] = s.p[j]; });
  }
  HPA2_HD void or_in(Set& d, const Set& s) const {
    each([&](int j) { d.p[j] |= s.p[j]; });
  }
  HPA2_HD void and_not(Set& d, const Set& x, const Set& y) const {
    each([&](int j) { d.p[j] = x.p[j] & ~y.p[j]; });
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
// the head and writes the rest).  TileWords's o.ish is bound by the
// caller to the pair's kSetIsh set.
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
// blocks keep their size.
//   N1 node_ab_wide     one launch, a CTA a tile of TP consecutive (node
//                       row, lane) pairs (pair i * B + l, the lanes
//                       fastest, as the planes are laid out), phases
//                       over a shared tile (n1w_phase): the CTA's threads
//                       split every word loop over (word, pair), so that
//                       each access is a coalesced run of the tile's
//                       pairs (the gather, the payload rows, the outbox,
//                       the mailbox rotation); a warp runs a pair's
//                       protocol body,
//                       node_ab<TileWords> (the one protocol body), its
//                       lanes splitting every set operation over the
//                       pair's sets in the tile (wide_ab_plan: TP from
//                       SW; sets that do not fit even one pair a tile
//                       go to the scratch y.work);
//   N2 node_bucket_wide two launches, a CTA of 256 threads a tile of LB
//                       lanes (wide_bucket_plan): flags (a CTA
//                       kWideFlagWords flag words of every lane of its
//                       tile, each (entry, lane)'s hit tested once, the
//                       words built by shared ORs and written whole,
//                       with the lane sums
//                       of the multicast savings and hier's combining
//                       count), then place (a CTA a chunk of S slots and
//                       S entries of one compacting destination: a
//                       CTA-wide scan of the lanes' flag-word popcounts,
//                       each entry's slot, each slot's entry, and the
//                       chunk of the [R, k, B] buffer written whole, hits
//                       and zeroed tail alike, in 16-byte stores; and a
//                       CTA a lane tile folding the telemetry);
//   N3 node_deliver_wide two launches, a thread a work item: sets (an
//                       item an (entry, lane): its local receivers' flag
//                       bits, a point receiver and its fan mask's words
//                       of this rank's nodes, and in a receiver's summary
//                       words the bit of each flag word it set), take (an
//                       item a (receiver, lane): its A then B flag words
//                       that are not zero, found from its summary words,
//                       in the global order while its queue has room,
//                       each taken entry's words into the mailbox and its
//                       feedback count and bit added);
//   N4 node_settle_wide two launches, a thread a work item: settle (an
//                       item a (node row, lane): delivered slots cleared,
//                       the rest and the INV remainder kept, phase D, its
//                       sums added) and lane (an item a (row, lane) of
//                       the stacked SUM and MAX).
// In N3's and N4's launches no item reads what another item of the same
// launch writes: the sums that cross items are integer atomics into
// zeroed rows of global memory, and a step that needs every item's
// result is a launch of its own.
// threads a CTA of N3's and N4's launches
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
  int32_t* work;                 // N1: [nl * B, stride] the pairs' sets
                                 // when even one pair's miss the tile
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
  uint32_t* bits;                // [nw, B] hit flags (every word written)
  uint32_t* part;                // [nwt, 3, B] a flags CTA's lane sums:
                                 // multicast savings, shipped combinable
                                 // entries, distinct keys
  uint32_t* keys;                // [nkw, B] key bitmap, zeroed (hier)
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

// ===== N1 wide: a CTA a tile of pairs ==================================
// A CTA holds TP consecutive (node row, lane) pairs, p = i * B + l, of
// the launch's nl * B; five phases over its shared tile, a barrier
// between them:
//   0 gather: the pairs' words that depend on no other load, over (row,
//     pair): nsw, the window length, the four deferred receivers, the
//     INV slot's and the mailbox head's header words; the counters'
//     sums zeroed;
//   1 gather the sets, over (word, pair): the INV slot's sharer words,
//     and the mailbox head's of a pair with mail;
//   2 protocol, a warp a pair: node_ab<TileWords> on the staged words
//     (its own dependent loads, the trace word, the cache and directory
//     rows, by the whole warp), then the pair's candidates (receivers,
//     header words, the set each refers to, combining keys), its INV
//     word offered, its flags and counters into the tile, and nsw;
//   3 write, stores only, over (word, pair): the payload's R rows of the
//     five candidates in the global order (a blocked node's deferred
//     words from its outbox), the outbox (every node's INV slot with its
//     receiver set, a free node's sends with the sender and recv
//     fields), the mailbox of a pair that popped its head rotated (slot
//     s takes slot s + 1's word, the last slot the head: every cap slot
//     moves, stale ones too, so the planes stay the JAX package's; a
//     word is stored where it changes); the counters summed by lane in
//     the tile;
//   4 the counters added into cnt (zeroed), a lane's sum once a CTA.
// Every tile word a phase reads was written by an earlier phase (the
// host build starts the tile as garbage to show it).
constexpr int kN1wPhases = 5;
constexpr int kWideAbCta = 256;         // threads a CTA: 8 warps
constexpr int kWideAbLgPairs = 5;       // log2 of the pairs a CTA at most
// the tile a CTA at most: two CTAs an SM (the launch bounds' registers
// allow two)
constexpr int kWideAbSmem = 100 * 1024;

// N1w's scalar rows, [kW1Rows][TP] (the pairs fastest): staged by the
// gather (NSW .. HEADH), then the protocol's: RECV each candidate's
// receiver, INVH the INV word offered, SLH a free node's sends' header
// words, SET the set their shr{w} words are (-1: none), KEY their
// combining keys, FLAGS kFlag* and the counters from bit kW1Count
enum { W1_NSW = 0, W1_TL, W1_RECV, W1_INVH = W1_RECV + 4,
       W1_HEADH = W1_INVH + 2, W1_SLH = W1_HEADH + 2, W1_SET = W1_SLH + 8,
       W1_KEY = W1_SET + 4, W1_FLAGS = W1_KEY + 4, kW1Rows };
constexpr int kW1Count = 3;

// N1w's launch geometry (wide_ab_plan)
struct WideAbPlan {
  int32_t TP;                     // pairs a CTA, a power of 2
  int32_t lg;                     // log2(TP)
  int32_t stride;                 // words a pair's sets: kWideSets * SW,
                                  // odd, so that a warp's accesses to
                                  // word j of its pairs hit distinct banks
  int32_t global;                 // the sets in y.work, not the tile
  int32_t tab;                    // the tile holds a copy of the plane
                                  // tables mb, ob, dirs (2 W + SW pointers)
  int32_t smem;                   // bytes of the shared tile
};

// the plan of a launch that wide_ok took: the largest TP (at most
// 1 << kWideAbLgPairs) whose tile (the plane tables, scalar rows, counter
// sums, sets) fits max_smem; when not even one pair's does, the largest
// whose tables, scalar rows and sums do, the sets in the scratch y.work;
// then the same without the tables (false without a scratch)
HPA2_HD bool wide_ab_plan(const WideArgs& y, WideAbPlan& pl, int max_smem) {
  if (!wide_ok(y.x)) return false;
  const Args& a = y.x.a;
  pl.stride = (kWideSets * a.SW) | 1;
  const long long tab = 8LL * (2 * a.W + a.SW);
  for (int mode = 0; mode < 3; ++mode)
    for (int lg = kWideAbLgPairs; lg >= 0; --lg) {
      const long long bytes = (mode < 2 ? tab : 0) + 4LL * (1 << lg) *
          (kW1Rows + kABCount + (mode ? 0LL : (long long)pl.stride));
      if (bytes <= max_smem && (mode == 0 || y.work != nullptr)) {
        pl.TP = 1 << lg;
        pl.lg = lg;
        pl.global = mode > 0;
        pl.tab = mode < 2;
        pl.smem = (int32_t)bytes;
        return true;
      }
    }
  return false;
}

HPA2_HD int wide_ab_ctas(const NodeArgs& x, const WideAbPlan& pl) {
  const long long pairs = (long long)x.nl * x.a.b;
  return (int)((pairs + pl.TP - 1) >> pl.lg);
}

// phase ph of thread tid (of kWideAbCta) of CTA cta.  Outside the
// protocol a thread keeps one pair, t = tid % TP, and takes its rows rg,
// rg + NRG, ... (rg = tid / TP, NRG = kWideAbCta / TP), so that a warp's
// accesses to a row are the tile's consecutive pairs
HPA2_HD void n1w_phase(const WideArgs& y, const WideAbPlan& pl, int ph,
                       int cta, int tid, int32_t* sh) {
  constexpr int T = kWideAbCta;
  const NodeArgs& x = y.x;
  const Args& a = x.a;
  const int TP = pl.TP, lg = pl.lg, nl = x.nl, W = a.W, SW = a.SW;
  const int cap = a.cap, b = a.b;
  const size_t np = (size_t)nl * b, p0 = (size_t)cta << lg;
  // the tile: the plane tables' copy (8-byte words first), the scalar
  // rows, the counter sums, the sets
  int32_t** tab = reinterpret_cast<int32_t**>(sh);
  sh += pl.tab ? 2 * (2 * W + SW) : 0;
  int32_t* const* mbt = pl.tab ? tab : y.mb;
  int32_t* const* obt = pl.tab ? tab + W : y.ob;
  int32_t* const* dirt = pl.tab ? tab + 2 * W : y.dirs;
  uint32_t* red = reinterpret_cast<uint32_t*>(sh + kW1Rows * TP);
  int32_t* sets = pl.global ? y.work + p0 * pl.stride
                            : sh + (kW1Rows + kABCount) * TP;
  auto at = [&](int row, int t) -> int32_t& { return sh[row * TP + t]; };
  auto set = [&](int t, int k) -> int32_t* {
    return sets + (size_t)t * pl.stride + (size_t)k * SW;
  };
  if (ph == 2) {
    const int warp = tid / 32, lane = tid % 32;
#ifndef __CUDA_ARCH__
    if (lane) return;  // the host build runs a warp as its lane 0
#endif
    using V = TileWords;
    for (int t = warp; t < TP; t += T / 32) {
      const size_t p = p0 + t;
      if (p >= np) break;
      const int i = (int)(p / b), l = (int)(p % b), gid = x.me * nl + i;
      const V v{SW, set(t, 0), dirt};
      NodeIn<V> in;
      in.nsw = at(W1_NSW, t);
      in.tl = at(W1_TL, t);
      HPA2_UNROLL for (int q = 0; q < 4; ++q) in.drecv[q] = at(W1_RECV + q, t);
      const bool mail = (in.nsw & a.count_mask) != 0;
      HPA2_UNROLL for (int w = 0; w < 2; ++w) {
        in.inv.h[w] = at(W1_INVH + w, t);
        in.head.h[w] = mail ? at(W1_HEADH + w, t) : 0;
      }
      in.inv.set = set(t, kSetInv);
      in.head.set = mail ? set(t, kSetHead) : nullptr;
      NodeAB<V> o;
      v.bind(o.ish, kSetIsh);
      node_ab<V, false>(a, v, l, i, gid, a.seg, in, o);
      const int32_t inv_any = v.any(o.ish);
      if (lane) continue;
      HPA2_AT(a.nsw, i) = o.nswp;
      // the candidates of slots 0, 1, 3, 4: a blocked node's deferred
      // words (in its outbox, read by the write phase), else its fresh
      // sends
      HPA2_UNROLL for (int q = 0; q < 4; ++q) {
        const int r = o.blocked ? o.drecv[q] : o.sl[q].recv;
        int32_t h[2];
        int sref = -1;
        if (o.blocked) {
          HPA2_UNROLL for (int w = 0; w < 2; ++w)
            h[w] = HPA2_AT(obt[w], i * kNSlots + one_slot(q));
        } else {
          h[0] = o.sl[q].m.h[0];
          h[1] = o.sl[q].m.h[1];
          if (o.sl[q].m.set != nullptr)
            sref = (int)((o.sl[q].m.set - v.base) / SW);
        }
        at(W1_RECV + q, t) = r;
        at(W1_SLH + 2 * q, t) = h[0];
        at(W1_SLH + 2 * q + 1, t) = h[1];
        at(W1_SET + q, t) = sref;
        at(W1_KEY + q, t) = r >= 0 && V::hget(a, h, F_TYPE) == READ_REQUEST
                                ? V::hget(a, h, F_ADDR) + 1 : 0;
      }
      // the INV word offered (its sharer fields clear); its set stays in
      // the pair's kSetIsh
      int32_t hi[2] = {0, 0};
      V::hput(a, hi, F_TYPE, INV);
      V::hput(a, hi, F_ADDR, o.inv_addr);
      V::hput(a, hi, F_SENDER, gid);
      at(W1_INVH, t) = hi[0];
      at(W1_INVH + 1, t) = hi[1];
      const bool inc[kABCount] = {o.elig, o.rh, o.rm, o.wh, o.wm, o.ev,
                                  o.inv_applied};
      int flags = (o.has_msg ? kFlagMsg : 0) | (o.blocked ? kFlagBlocked : 0) |
                  (inv_any ? kFlagInv : 0);
      HPA2_UNROLL for (int j = 0; j < kABCount; ++j)
        if (inc[j]) flags |= 1 << (kW1Count + j);
      at(W1_FLAGS, t) = flags;
    }
    return;
  }
  if (ph == 4) {
    // a lane's sums into cnt once
    const int nslot = b >= TP ? TP : b;
    for (int idx = tid; idx < kABCount * nslot; idx += T) {
      const int s = idx % nslot, j = idx / nslot;
      const uint32_t v = red[j * TP + s];
      if (!v) continue;
      const int l = b >= TP ? (int)((p0 + s) % b) : s;
      sh_add(reinterpret_cast<uint32_t*>(&x.cnt[(size_t)j * b + l]), v);
    }
    return;
  }
  if (ph == 0) {
    for (int j = tid; j < kABCount * TP; j += T) red[j] = 0;
    if (pl.tab)
      for (int j = tid; j < 2 * W + SW; j += T)
        tab[j] = j < W ? y.mb[j] : j < 2 * W ? y.ob[j - W] : y.dirs[j - 2 * W];
  }
  const int R = W + SW + 3;
  const size_t rs = (size_t)5 * nl * b;   // a payload row
  const int snd_w = a.f_word[F_SENDER], snd_off = a.f_off[F_SENDER];
  const int recv_w = a.f_word[F_RECV], recv_off = a.f_off[F_RECV];
  // ph 3's words (words 0 and 1 hold every field but shr{w}, so the
  // sender and recv fields are theirs): word r of pair t's candidate k
  // in the payload (a blocked node's deferred words from its outbox)
  auto pay = [&](int t, int i, int l, int k, int r) -> int32_t {
    if (k == 2)
      return r < 2 ? at(W1_INVH + r, t)
             : r < W ? 0
             : r < W + SW ? set(t, kSetIsh)[r - W]
             : r == W + SW + 1 ? 1 : 0;
    const int q = k < 2 ? k : k - 1;
    if (r >= W)
      return r < W + SW ? 0
             : r == W + SW ? at(W1_RECV + q, t) + 1
             : r == W + SW + 1 ? (k < 3 ? 1 : 0) : at(W1_KEY + q, t);
    int32_t v;
    if (at(W1_FLAGS, t) & kFlagBlocked) {
      v = HPA2_AT(obt[r], i * kNSlots + k);
    } else if (r < 2) {
      v = at(W1_SLH + 2 * q + r, t);
    } else {
      const int sref = at(W1_SET + q, t);
      v = sref >= 0 ? set(t, sref)[r - 2] : 0;
    }
    return r == snd_w ? v | (x.me * nl + i) << snd_off : v;
  };
  // whether pair t's outbox slot k takes new words (every node's INV
  // slot; a free node's sends), and its word j
  auto obset = [&](int t, int k) -> bool {
    return k == 2 || (!(at(W1_FLAGS, t) & kFlagBlocked) &&
                      at(W1_RECV + (k < 2 ? k : k - 1), t) >= 0);
  };
  auto obw = [&](int t, int i, int k, int j) -> int32_t {
    if (k == 2)
      return !(at(W1_FLAGS, t) & kFlagInv) ? 0
             : j < 2 ? at(W1_INVH + j, t) : set(t, kSetIsh)[j - 2];
    const int q = k < 2 ? k : k - 1, sref = at(W1_SET + q, t);
    int32_t v = j < 2 ? at(W1_SLH + 2 * q + j, t)
                : sref >= 0 ? set(t, sref)[j - 2] : 0;
    if (j == snd_w) v |= (x.me * nl + i) << snd_off;
    if (a.recv_packed && j == recv_w)
      v |= (at(W1_RECV + q, t) + 1) << recv_off;
    return v;
  };
  // ph 3 with a tile of whole nodes (TP a multiple of b): a row of the
  // tile's payload is two runs, its A grid's 3 TP words (node, slot,
  // lane) and its B grid's 2 TP, and a row of its outbox one run of 5 TP
  // (node, slot, lane), so a thread takes a word of the run and every
  // upr-th row, and a warp stores whole lines
  const bool whole = TP % b == 0;
  if (ph == 3 && whole) {
    const int units = 5 * TP, upr = T / units, u = tid % units;
    const int r0 = tid / units, i0 = (int)(p0 / b), lu = u % b;
    if (r0 < upr) {
      const int c = (u < 3 * TP ? u : u - 3 * TP) / b;
      const int k = u < 3 * TP ? c % 3 : 3 + c % 2;
      const int tu = (u < 3 * TP ? c / 3 : c / 2) * b + lu;
      const size_t col = u < 3 * TP ? (size_t)3 * i0 + c
                                    : (size_t)3 * nl + 2 * (size_t)i0 + c;
      if (p0 + tu < np) {
        const int iu = i0 + tu / b;
        int32_t* pc = x.payload + col * b + lu;
        strided_each(r0, upr, R, [&](int r) { return pay(tu, iu, lu, k, r); },
                     [&](int r, int32_t v) { pc[r * rs] = v; });
      }
      const int c2 = u / b, k2 = c2 % 5, t2 = c2 / 5 * b + lu;
      if (p0 + t2 < np && obset(t2, k2)) {
        const int i2 = i0 + t2 / b;
        strided_each(r0, upr, W, [&](int j) { return obw(t2, i2, k2, j); },
                     [&](int j, int32_t v) {
                       obt[j][(size_t)(i2 * kNSlots + k2) * b + lu] = v;
                     });
      }
    }
  }
  // phases 0, 1 and 3: this thread's pair and rows
  const int t = tid & (TP - 1), rg = tid >> lg, NRG = T >> lg;
  const size_t p = p0 + t;
  if (p >= np) return;
  const int i = (int)(p / b), l = (int)(p % b);
  if (ph == 0) {
    strided_each(rg, NRG, W1_SLH, [&](int r) -> int32_t {
      if (r == W1_NSW) return HPA2_AT(a.nsw, i);
      if (r == W1_TL) return window_len(a, l, i, a.seg);
      if (r < W1_INVH) return deferred_recv(a, l, i, one_slot(r - W1_RECV));
      if (r < W1_HEADH) return HPA2_AT(y.ob[r - W1_INVH], i * kNSlots + 2);
      return HPA2_AT(y.mb[r - W1_HEADH], i * cap);
    }, [&](int r, int32_t v) { at(r, t) = v; });
    return;
  }
  if (ph == 1) {
    int32_t* inv = set(t, kSetInv);
    strided_each(rg, NRG, SW,
                 [&](int j) { return HPA2_AT(obt[2 + j], i * kNSlots + 2); },
                 [&](int j, int32_t v) { inv[j] = v; });
    if (at(W1_NSW, t) & a.count_mask) {
      int32_t* head = set(t, kSetHead);
      strided_each(rg, NRG, SW,
                   [&](int j) { return HPA2_AT(mbt[2 + j], i * cap); },
                   [&](int j, int32_t v) { head[j] = v; });
    }
    return;
  }
  // ph == 3: stores only
  const int flags = at(W1_FLAGS, t);
  if (!whole) {
    // the payload rows of the five candidates and the outbox, this
    // pair's rows
    HPA2_UNROLL for (int k = 0; k < 5; ++k) {
      int32_t* pc = x.payload + (size_t)cand_col(nl, i, k) * b + l;
      strided_each(rg, NRG, R, [&](int r) { return pay(t, i, l, k, r); },
                   [&](int r, int32_t v) { pc[r * rs] = v; });
      if (obset(t, k))
        strided_each(rg, NRG, W, [&](int j) { return obw(t, i, k, j); },
                     [&](int j, int32_t v) {
                       HPA2_AT(obt[j], i * kNSlots + k) = v;
                     });
    }
  }
  if (!a.recv_packed && rg == 0 && !(flags & kFlagBlocked))
    HPA2_UNROLL for (int q = 0; q < 4; ++q) {
      const int r = at(W1_RECV + q, t);
      if (r >= 0) HPA2_AT(a.ob_recv, i * kNSlots + one_slot(q)) = r;
    }
  // the mailbox of a pair that popped its head, a word plane a row:
  // slot s takes slot s + 1's word, the last slot the head; every slot
  // is read and moved, and a word is stored where it changes (the old
  // words are the ones read, and the head's)
  if (flags & kFlagMsg)
    for (int w = rg; w < W; w += NRG) {
      int32_t* mq = mbt[w] + (size_t)i * cap * b + l;
      const int32_t head =
          w < 2 ? at(W1_HEADH + w, t) : set(t, kSetHead)[w - 2];
      int32_t prev = head;              // the old word of slot s0 - 1
      for (int s0 = 1; s0 < cap; s0 += kWideBatch) {
        int32_t v[kWideBatch];
        HPA2_UNROLL for (int u = 0; u < kWideBatch; ++u)
          if (s0 + u < cap) v[u] = mq[(size_t)(s0 + u) * b];
        HPA2_UNROLL for (int u = 0; u < kWideBatch; ++u)
          if (s0 + u < cap) {
            if (v[u] != prev) mq[(size_t)(s0 + u - 1) * b] = v[u];
            prev = v[u];
          }
      }
      if (head != prev) mq[(size_t)(cap - 1) * b] = head;
    }
  // the counters, summed by lane: a slot a pair while the tile's pairs
  // are of distinct lanes (b >= TP), else a slot a lane
  if (rg == 0) {
    const int slot = b >= TP ? t : l;
    HPA2_UNROLL for (int j = 0; j < kABCount; ++j)
      if ((flags >> (kW1Count + j)) & 1) sh_add(&red[j * TP + slot], 1);
  }
}

// ===== N2 wide: flags, then place ======================================
// Two launches, a CTA of kWideBucketCta threads a tile of LB lanes
// (wide_bucket_plan), threads over (item, lane) with the lane fastest:
//   flags, a CTA kWideFlagWords flag word of its lanes (the flag words
//   of every destination concatenated, woff), three phases:
//     0 zero the tile;
//     1 every (entry, lane) of its words tests bucket_hit once (the
//       destination's nonzero mask words only) and ORs its bit into the
//       lane's flag word in the tile; a stat destination's hit adds its
//       multicast savings to the lane's sum; under hier a compacting
//       destination's hit with a key counts one and sets the key's bit
//       in the lane's bitmap (global, zeroed; a key counted distinct by
//       the thread whose OR set its bit);
//     2 the flag words and the lane sums written whole (bits, part);
//   place, a CTA (after the NLT fold CTAs) a chunk of S slots and S
//   entries of one compacting destination p and lane tile (S a multiple
//   of NC, at least kWidePlaceWords words of the buffer where the slots
//   allow), 3 + steps phases:
//     0 a thread a (chunk of C flag words of p, lane): its popcount;
//     1 .. steps: a CTA-wide scan of the NC chunks' counts a lane (a
//       step a phase, doubling), the chunks' exclusive prefixes and the
//       lane's hits;
//     steps + 1: a thread (entries, lane) of the chunk, NC entries apart:
//       each one's slot (sel: the prefix of its chunk, the popcounts of
//       the words before it in the chunk, the bits below it; k when not
//       shipped); and (slots, lane): each one's entry, -1 past the
//       lane's hits (the chunk whose prefix holds it by a binary search,
//       then its words);
//     steps + 2: the chunk's slots of every row of buf written whole, an
//       entry's row word or zero, four lanes a 16-byte store where the
//       tile's lanes allow it;
//   a fold CTA sums its lanes' hits of every destination and the flags
//   CTAs' lane sums and folds them into fs once (the CTA owns the lane:
//   no atomics in global memory).
constexpr int kWideBucketCta = 256;
constexpr int kWideBucketLanes = 32;    // lanes a tile at most
constexpr int kWideFlagWords = 1;       // flag words a flags CTA
constexpr int kWideFlagLanes = 8;       // lanes a flags CTA at most
constexpr int kN2wFlagPhases = 3;
// words of a buffer a place CTA writes at least, where its slots allow
// (so that its prologue, a scan, is paid for)
constexpr int kWidePlaceWords = 16384;
// rows whose loads a thread of the place keeps in flight
constexpr int kPlaceRows = 4;

// N2w's launch geometry (wide_bucket_plan)
struct WideBucketPlan {
  int32_t nw;                     // flag words a lane, every destination
  int32_t nkw;                    // key-bitmap words a lane (hier), else 0
  int32_t woff[kMaxShards + 1];   // each destination's first flag word
  int32_t LB;                     // lanes a tile
  int32_t NLT;                    // lane tiles
  int32_t LBF, NLTF;              // lanes a flags CTA's tile, its tiles
  int32_t NC;                     // a place CTA's chunks of a lane's flag
                                  // words (kWideBucketCta / LB)
  int32_t S;                      // a place CTA's slots (and entries), a
                                  // multiple of NC and of G
  int32_t G;                      // slots a group: a 128-byte line of the
                                  // tile's lanes where 32 % LB == 0
  int32_t steps;                  // the scan's steps: ceil(log2(NC))
  int32_t nwt;                    // flags CTAs a lane tile
  int32_t coff[kMaxShards + 1];   // each destination's first place CTA
  int32_t smem1, smem2;           // bytes of the two launches' tiles
};

// the plan of a launch, false when the kernels do not take it; at most
// max_lanes lanes a tile (kWideBucketLanes on the card)
HPA2_HD bool wide_bucket_plan(const WideBucketArgs& y, WideBucketPlan& pl,
                              int max_lanes) {
  const BucketArgs& x = y.x;
  if (x.ndest < 1 || x.ndest > kMaxShards || x.b < 1 || x.k < 1 ||
      x.SW < 1 || x.nl < 1 || x.nkeys < 0 || x.W != 2 + x.SW ||
      max_lanes < 1)
    return false;
  int w = 0;
  for (int p = 0; p < x.ndest; ++p) {
    if (x.dblk[p] < 0 || x.dblk[p] >= kMaxShards || y.dwlo[p] < 0 ||
        y.dwhi[p] >= x.SW || x.blen[x.dblk[p]] < 1)
      return false;
    pl.woff[p] = w;
    w += (x.blen[x.dblk[p]] + 31) / 32;
  }
  pl.woff[x.ndest] = w;
  pl.nw = w;
  pl.nkw = x.combine ? (x.nkeys + 31) / 32 : 0;
  pl.LB = x.b < max_lanes ? x.b : max_lanes;
  pl.NLT = (x.b + pl.LB - 1) / pl.LB;
  pl.LBF = pl.LB < kWideFlagLanes ? pl.LB : kWideFlagLanes;
  pl.NLTF = (x.b + pl.LBF - 1) / pl.LBF;
  pl.NC = kWideBucketCta / pl.LB;
  if (pl.NC < 1) return false;
  pl.steps = 0;
  while ((1 << pl.steps) < pl.NC) ++pl.steps;
  pl.G = 32 % pl.LB == 0 && pl.NC % (32 / pl.LB) == 0 ? 32 / pl.LB : 1;
  const long long chunk = (long long)(x.W + x.SW + 3) * pl.LB * pl.NC;
  pl.S = pl.NC * (int)((kWidePlaceWords + chunk - 1) / chunk);
  pl.nwt = (pl.nw + kWideFlagWords - 1) / kWideFlagWords;
  long long c = pl.NLT;
  for (int p = 0; p < x.ndest; ++p) {
    pl.coff[p] = (int32_t)c;
    if (x.dflags[p] & kDestCompact) {
      const int J = x.blen[x.dblk[p]], span = J > x.k ? J : x.k;
      c += (long long)((span + pl.S - 1) / pl.S) * pl.NLT;
    }
  }
  if (c >= (1LL << 31)) return false;
  pl.coff[x.ndest] = (int32_t)c;
  pl.smem1 = 4 * pl.LBF * (kWideFlagWords + 3);
  const int rows2 = 3 * pl.NC + pl.S > x.ndest + 3 ? 3 * pl.NC + pl.S
                                                   : x.ndest + 3;
  pl.smem2 = 4 * pl.LB * rows2;
  return true;
}

// flags: phase ph of thread tid of CTA cta (word tile cta / NLTF, lane
// tile cta % NLTF); tile: bits [kWideFlagWords][LBF], sums [3][LBF]
HPA2_HD void n2w_flags_phase(const WideBucketArgs& y,
                             const WideBucketPlan& pl, int ph, int cta,
                             int tid, uint32_t* sh) {
  constexpr int T = kWideBucketCta, FW = kWideFlagWords;
  const BucketArgs& x = y.x;
  const int LB = pl.LBF, wt = cta / pl.NLTF, l0 = (cta % pl.NLTF) * LB;
  uint32_t* bits = sh;
  uint32_t* sums = sh + FW * LB;
  if (ph == 0) {
    for (int i = tid; i < (FW + 3) * LB; i += T) sh[i] = 0;
    return;
  }
  if (ph == 1) {
    for (int idx = tid; idx < 32 * FW * LB; idx += T) {
      const int g = idx % LB, e = idx / LB, l = l0 + g;
      const int w = wt * FW + (e >> 5);
      if (w >= pl.nw || l >= x.b) continue;
      int p = 0;
      while (p + 1 < x.ndest && w >= pl.woff[p + 1]) ++p;
      const int j = (w - pl.woff[p]) * 32 + (e & 31), J = x.blen[x.dblk[p]];
      if (j >= J) continue;
      const int32_t* __restrict__ blk = x.blk[x.dblk[p]];
      const int32_t* dm = y.dmask + (size_t)p * x.SW;
      const int q = blk[blk_at(x.W + x.SW, J, j, x.b, l)] - 1;
      bool hit = q >= 0 && q < x.n && ((x.dset[p] >> (q / x.nl)) & 1);
      int pop = 0;
      // the destination's nonzero mask words (no store between the
      // loads: they go out together)
      const int32_t* mrow = blk + blk_at(x.W, J, j, x.b, l);
      const size_t mstep = (size_t)J * x.b;
      for (int mw = y.dwlo[p]; mw <= y.dwhi[p]; ++mw) {
        const int32_t m = mrow[mw * mstep] & dm[mw];
        hit = hit || m != 0;
        pop += popc(m);
      }
      if (!hit) continue;
      sh_or(reinterpret_cast<int32_t*>(&bits[(e >> 5) * LB + g]),
            (int32_t)(1u << (e & 31)));
      const int flags = x.dflags[p];
      if ((flags & kDestStat) && pop > 1) sh_add(&sums[g], (uint32_t)(pop - 1));
      if (x.combine && (flags & kDestCompact)) {
        const int key = blk[blk_at(x.W + x.SW + 2, J, j, x.b, l)];
        if (key >= 1 && key <= x.nkeys) {
          sh_add(&sums[LB + g], 1);
          if (or_was_clear(&y.keys[(size_t)((key - 1) >> 5) * x.b + l],
                           1u << ((key - 1) & 31)))
            sh_add(&sums[2 * LB + g], 1);
        }
      }
    }
    return;
  }
  // ph == 2: the tile written whole
  for (int idx = tid; idx < FW * LB; idx += T) {
    const int g = idx % LB, w = wt * FW + idx / LB, l = l0 + g;
    if (w < pl.nw && l < x.b) y.bits[(size_t)w * x.b + l] = bits[idx];
  }
  for (int idx = tid; idx < 3 * LB; idx += T) {
    const int g = idx % LB, l = l0 + g;
    if (l < x.b) y.part[((size_t)wt * 3 + idx / LB) * x.b + l] = sums[idx];
  }
}

// a 16-byte group of words (its alignment lets a store of it be one
// vector store)
struct alignas(16) Words4 {
  int32_t v[4];
};

// place: phase ph of thread tid of CTA cta
HPA2_HD void n2w_place_phase(const WideBucketArgs& y,
                             const WideBucketPlan& pl, int ph, int cta,
                             int tid, uint32_t* sh) {
  constexpr int T = kWideBucketCta;
  const BucketArgs& x = y.x;
  const int LB = pl.LB, NC = pl.NC, k = x.k;
  if (cta < pl.NLT) {
    // a fold CTA: its lanes' hits of every destination [ndest][LB] and
    // the flags CTAs' lane sums [3][LB], then fs
    const int l0 = cta * LB;
    uint32_t* tot = sh;
    uint32_t* sums = sh + x.ndest * LB;
    if (ph == 0) {
      for (int i = tid; i < (x.ndest + 3) * LB; i += T) sh[i] = 0;
    } else if (ph == 1) {
      const int g = tid % LB, part = tid / LB, l = l0 + g;
      if (part >= NC || l >= x.b) return;
      for (int p = 0; p < x.ndest; ++p) {
        uint32_t c = 0;
        for (int w = pl.woff[p] + part; w < pl.woff[p + 1]; w += NC)
          c += (uint32_t)popc((int32_t)y.bits[(size_t)w * x.b + l]);
        if (c) sh_add(&tot[p * LB + g], c);
      }
      for (int i = 0; i < 3; ++i) {
        uint32_t c = 0;
        for (int wt = part; wt < pl.nwt; wt += NC)
          c += y.part[((size_t)wt * 3 + i) * x.b + l];
        if (c) sh_add(&sums[i * LB + g], c);
      }
    } else if (ph == 2) {
      for (int g = tid; g < LB; g += T) {
        const int l = l0 + g;
        if (l >= x.b) continue;
        int32_t* fs = x.fs;
        auto at = [&](int row) -> int32_t& { return fs[(size_t)row * x.b + l]; };
        int32_t sent = at(FS_SENT), hwm = at(FS_HWM), ovf = at(FS_OVF),
                diag = at(FS_DIAG);
        for (int p = 0; p < x.ndest; ++p) {
          const int32_t t = (int32_t)tot[p * LB + g];
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
        at(FS_MC) += (int32_t)sums[g];
        if (x.combine) at(FS_COMB) += (int32_t)(sums[LB + g] - sums[2 * LB + g]);
      }
    }
    return;
  }
  // a place CTA: destination p, its chunk ch, lane tile lt
  int p = 0;
  while (p + 1 < x.ndest && cta >= pl.coff[p + 1]) ++p;
  const int rel = cta - pl.coff[p], lt = rel % pl.NLT, ch = rel / pl.NLT;
  const int nch = (pl.coff[p + 1] - pl.coff[p]) / pl.NLT;  // chunks of p
  // the chunk's entries s0 .. s0 + S - 1; its slots in groups of G (a
  // line of its lanes), group ch, ch + nch, ... (S / G of them), so that
  // the lanes' hits, the slots below their counts, fall on many chunks
  const int l0 = lt * LB, s0 = ch * pl.S, G = pl.G;
  auto slot_of = [&](int m) { return (ch + m / G * nch) * G + m % G; };
  const int J = x.blen[x.dblk[p]], nwp = pl.woff[p + 1] - pl.woff[p];
  const int C = (nwp + NC - 1) / NC;              // flag words a chunk
  const uint32_t* fw = y.bits + (size_t)pl.woff[p] * x.b;  // p's words
  uint32_t* csum = sh;                            // [NC][LB] chunk counts
  uint32_t* scan = sh + NC * LB;                  // [2][NC][LB]
  int32_t* ent = reinterpret_cast<int32_t*>(sh + 3 * NC * LB);  // [S][LB]
  const int g = tid % LB, c = tid / LB, l = l0 + g;
  const bool mine = c < NC && l < x.b;
  if (ph == 0) {
    if (!mine) return;
    uint32_t n = 0;
    const int w1 = (c + 1) * C < nwp ? (c + 1) * C : nwp;
    for (int w = c * C; w < w1; ++w) n += (uint32_t)popc((int32_t)fw[(size_t)w * x.b + l]);
    csum[c * LB + g] = scan[c * LB + g] = n;
    return;
  }
  if (ph <= pl.steps) {
    if (!mine) return;
    const int d = 1 << (ph - 1);
    const uint32_t* in = scan + ((ph - 1) & 1) * NC * LB;
    uint32_t* out = scan + (ph & 1) * NC * LB;
    out[c * LB + g] = in[c * LB + g] + (c >= d ? in[(c - d) * LB + g] : 0u);
    return;
  }
  const uint32_t* incl = scan + (pl.steps & 1) * NC * LB;
  // the hits of lane g before chunk cc
  auto before = [&](int cc) -> int {
    return (int)(incl[cc * LB + g] - csum[cc * LB + g]);
  };
  if (ph == pl.steps + 1) {
    if (!mine) return;
    const int hits = (int)incl[(NC - 1) * LB + g];
    for (int m = c; m < pl.S; m += NC) {
      // entry j = s0 + m: its slot, when p compacts into a buffer
      const int j = s0 + m;
      if ((x.dflags[p] & kDestCompact) && j < J) {
        const int w = j >> 5, bit = j & 31;
        const uint32_t word = fw[(size_t)w * x.b + l];
        int64_t slot = k;
        if ((word >> bit) & 1) {
          const int cw = w / C;
          int pos = before(cw) + popc((int32_t)(word & ((1u << bit) - 1u)));
          for (int u = cw * C; u < w; ++u)
            pos += popc((int32_t)fw[(size_t)u * x.b + l]);
          if (pos < k) slot = pos;
        }
        x.sel[p][(size_t)j * x.b + l] = slot;
      }
      // slot s = slot_of(m): its entry (-1: zero)
      const int s = slot_of(m);
      int e = -1;
      if (s < k && s < hits) {
        int lo = 0, hi = NC - 1;          // the last chunk with before <= s
        while (lo < hi) {
          const int mid = (lo + hi + 1) / 2;
          if (before(mid) <= s) lo = mid; else hi = mid - 1;
        }
        int run = before(lo);
        const int w1 = (lo + 1) * C < nwp ? (lo + 1) * C : nwp;
        for (int w = lo * C; w < w1; ++w) {
          uint32_t wm = fw[(size_t)w * x.b + l];
          const int pc = popc((int32_t)wm);
          if (s < run + pc) {
            for (int u = s - run; u > 0; --u) wm &= wm - 1u;
            e = w * 32 + find_owner((int32_t)wm);
            break;
          }
          run += pc;
        }
      }
      ent[m * LB + g] = e;
    }
    return;
  }
  if (ph != pl.steps + 2) return;
  // the chunk's slots of every row of buf: a hit's row word, else zero
  const int ns = pl.S;
  const int R = x.W + x.SW + 3;
  const int32_t* __restrict__ blk = x.blk[x.dblk[p]];
  int32_t* __restrict__ buf = x.buf[p];
  const int nlb = x.b - l0 < LB ? x.b - l0 : LB;  // lanes of this tile
  const bool vec = nlb % 4 == 0 && l0 % 4 == 0 && x.b % 4 == 0 &&
                   ((size_t)buf & 15) == 0;
  // a unit: four lanes (vec) or one of a slot; a thread keeps its unit
  // and its entries across the rows it takes (rpt rows apart)
  const int L = vec ? 4 : 1, per_row = ns * (nlb / L);
  const size_t brow = (size_t)k * x.b, erow = (size_t)J * x.b;
  const int units = per_row < T ? per_row : T;
  const int rpt = per_row < T ? T / per_row : 1;   // rows at once
  if (tid >= units * rpt) return;
  const int r0 = tid / units;
  for (int u = tid % units; u < per_row; u += units) {
    const int si = u / (nlb / L), gl = (u - si * (nlb / L)) * L;
    const int s = slot_of(si);
    if (s >= k) continue;
    const int32_t* src[4];
    bool any = false;
    HPA2_UNROLL for (int q = 0; q < 4; ++q) {
      const int e = q < L ? ent[si * LB + gl + q] : -1;
      src[q] = e >= 0 ? blk + blk_at(0, J, e, x.b, l0 + gl + q) : nullptr;
      any = any || e >= 0;
    }
    int32_t* dst = buf + blk_at(0, k, s, x.b, l0 + gl);
    auto put = [&](int r, const Words4& v) {
      if (vec)
        *reinterpret_cast<Words4*>(dst + r * brow) = v;
      else
        dst[r * brow] = v.v[0];
    };
    if (!any) {
      const Words4 zero = {{0, 0, 0, 0}};
      for (int r = r0; r < R; r += rpt) put(r, zero);
      continue;
    }
    // a unit with hits: kPlaceRows rows' loads in flight before their
    // stores
    for (int rb = r0; rb < R; rb += rpt * kPlaceRows) {
      Words4 v[kPlaceRows];
      HPA2_UNROLL for (int u = 0; u < kPlaceRows; ++u)
        HPA2_UNROLL for (int q = 0; q < 4; ++q) {
          const int r = rb + u * rpt;
          v[u].v[q] = r < R && src[q] != nullptr ? src[q][r * erow] : 0;
        }
      HPA2_UNROLL for (int u = 0; u < kPlaceRows; ++u)
        if (rb + u * rpt < R) put(rb + u * rpt, v[u]);
    }
  }
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
    const int addr = TileWords::hget(a, h, F_ADDR);
    h[0] = h[1] = 0;
    TileWords::hput(a, h, F_TYPE, INV);
    TileWords::hput(a, h, F_ADDR, addr);
    TileWords::hput(a, h, F_SENDER, gid);
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
