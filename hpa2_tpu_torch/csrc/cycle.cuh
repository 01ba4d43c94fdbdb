// One lockstep cycle of a lane block of simulated systems, spread over
// T threads a system, and the two run loops around it, as scalar
// code over the lane-last planes.
//
// Replaces: hpa2_tpu/ops/pallas_engine.py:build_cycle (the cycle body,
// phases A-D and counters), :_make_stream_run.kernel (the whole-run
// loop: trace windows x while-to-quiescence x gated 8-cycle bursts;
// stream_block below) and :_build_call.kernel (one call of up to k
// gated cycles on one resident trace window; call_block below).
//
// The TPU kernel runs the cycle vectorised over a block of lanes and
// one-hot over nodes.  Here each system is spread over T threads (2, 8
// or 16 by the node bound, Bound<MAXN>::T): thread t owns nodes t, t+T,
// t+2T, ... of its system.  Every
// plane row a node touches in phases A, B and D is its own (its cache
// and directory rows, its mailbox, which only it pops and only it, as a
// receiver, appends to, its nsw word and its outbox slots), so a node's
// thread reads and writes them alone.  The one exchange inside a cycle
// is the set of candidate messages:
//
//   phase AB (per node, its owner): handle the mailbox head, issue one
//     instruction, stage the fresh sends' words in the node's own
//     outbox slots (a blocked node's deferred words are there already)
//     and publish each slot's receiver, the INV receiver set and the
//     node's new nsw word in shared memory;
//   phase C (per receiver, its owner): walk the candidates in the
//     reference's order (the phase-A candidate of senders 0..n-1, then
//     slots 3 and 4 of senders 0..n-1), accept while the queue has room
//     and copy the accepted words from the sender's outbox slot into
//     its own mailbox.  Acceptance depends only on the receiver's own
//     queue, so the walk is exact; each accepted candidate is flagged
//     for its sender (an INV bit by a shared-memory OR);
//   phase C2 (per sender, its owner): clear delivered outbox slots, keep
//     the undelivered ones, write nsw and take the phase-D snapshot.
//
// A CTA holds `group` systems x T threads, system-fast, so a warp holds
// one node rank of 32 neighbouring systems and its loads of a node-
// uniform row coalesce.  Phases are separated by __syncthreads (the
// host build runs each phase for every thread in turn).  A lane block
// (`bb` systems) is one thread-block cluster of `cl` <= 16 CTAs, each
// running its `per_cta` systems in `rounds` rounds of `group`; the lane
// block's decisions (gate, call budget, window advance, stall) are ORs
// over the whole cluster through distributed shared memory, and the
// hardware guarantees that a cluster's CTAs are co-resident.
//
// State that lives only inside a launch stays in shared memory: the
// per-system counters (added to the planes once a launch), a mask of
// the senders with candidates (phase C walks those only), whether each
// node's last cycle left deferred slots (their words are read only
// then), and each mailbox's ring head.  A mailbox is a ring inside a
// launch: popping the head advances the head index instead of moving
// cap - 1 words, and the launch ends by rotating every mailbox back to
// head 0, which is the reference's rotation applied once.
//
// The planes keep the JAX package's layout and bits exactly: element
// (row, lane) of a plane [R..., B] sits at row * B + lane.  Message
// words, the mailbox rotated so its head is at slot 0, the recv field
// of deferred outbox words, the nsw packing and the sticky overflow row
// are the Pallas planes bit for bit.  Wide systems (more than 21 nodes)
// keep their sharer sets in SW split planes dirs{w} of 31-bit words and
// carry them in shr{w} message fields (pallas_engine.py:_split_mode);
// packed planes (u8 values, u8/u16 meta) are widened as each word is
// loaded and narrowed as it is stored.
//
// What bounds it on an H100: per system and cycle a chain of dependent
// integer work and small gathers from L2.  The bytes a run must move
// take well under a millisecond at 3.35 TB/s.  The one-thread-per-system
// body took ~210 us a cycle at the 8-node headline (1.3 KB of per-node
// temporaries a thread in local memory, every node and every (sender,
// receiver) pair walked by one thread) and ~4.1 ms at 64 nodes.  This
// body cuts a thread's chain to its own nodes (4 at 8 nodes, 3 at 21,
// 4 at 64) and phase C to its own receivers, keeps per-node temporaries
// in registers (arrays indexed at compile time only) and the exchange in
// shared memory, and fills more SMs.  What bounds it now is the issue
// and memory work of the 16 warps an SM that 128 registers a thread
// allow, and at 64 nodes the 32 SMs that two lane blocks of 512 reach
// (PERF.md).
#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cooperative_groups.h>
#else
#include <vector>
#endif

// Everything is inlined into the kernel: an out-of-line cycle body
// takes a call frame.
#ifdef __CUDACC__
#define HPA2_HD __host__ __device__ __forceinline__
#define HPA2_UNROLL _Pragma("unroll")
#else
#define HPA2_HD inline
#define HPA2_UNROLL
#endif

namespace hpa2 {

constexpr int kNSlots = 5;
constexpr int kNScalar = 10;
constexpr int kNTypes = 15;
constexpr int kNCount = kNScalar + kNTypes;  // per-system counters
constexpr int kGate = 8;
constexpr int kMaxBlock = 1024;  // lanes a lane block
constexpr int kMaxCta = 512;     // threads a CTA
// CTAs a lane block: one cluster, above 8 CTAs of a non-portable size
constexpr int kMaxCluster = 16;
constexpr int kSplitBpw = 31;  // bits of a split sharer word
constexpr int kMaxNodes = 64;  // the widest instantiation
constexpr int kMaxSW = 3;      // sharer words at kMaxNodes
constexpr int kMaxW = 5;       // message words at kMaxNodes

// compile-time bounds of a node bound: split mode, message words W
// and sharer words SW (the sharer mask sits in the directory word up to
// 21 nodes; beyond, SW 31-bit shr{w} fields follow type..aux, which
// take at most two words).  The kernel runs a system on the
// instantiation of the smallest bound that holds it, so SPLIT is
// exactly the system's split mode.
// T threads a system (thread t owns nodes t, t+T, ...) and at most G
// systems a CTA at once: 2 and 256 up to 8 nodes, 8 and 64 up to 21,
// 16 and 32 beyond.  Fewer threads a system at 8 nodes make a lane
// block of 512 a cluster of 2 CTAs, so that the 8-node headline's 64
// blocks fit the card at once (66 such clusters do; 30 of 4 CTAs or 15
// of 8 ran in waves); more at 64 nodes put a lane block of 512 on 16
// SMs (8 with 8 threads a system).  A cluster above 8 CTAs is a
// non-portable size: the launch allows it, and refuses it where the
// card cannot schedule it.
template <int MAXN>
struct Bound {
  static constexpr bool SPLIT = MAXN > 21;
  static constexpr int SW = SPLIT ? (MAXN + kSplitBpw - 1) / kSplitBpw : 1;
  static constexpr int W = SPLIT ? 2 + SW : 3;
  static constexpr int T = SPLIT ? 16 : (MAXN <= 8 ? 2 : 8);
  static constexpr int G = kMaxCta / T;
};
static_assert(Bound<kMaxNodes>::SW == kMaxSW && Bound<kMaxNodes>::W == kMaxW,
              "Args arrays follow the widest instantiation");

// message fields; F_SHR0 + w is sharer word w (split mode only)
enum { F_TYPE = 0, F_SENDER, F_SECOND, F_ADDR, F_AUX, F_RECV, F_SHR0,
       kNFields = F_SHR0 + kMaxSW };
// message types (hpa2_tpu.models.protocol.MsgType)
enum {
  READ_REQUEST = 0, WRITE_REQUEST, REPLY_RD, REPLY_WR, REPLY_ID, INV,
  UPGRADE, WRITEBACK_INV, WRITEBACK_INT, FLUSH, FLUSH_INVACK,
  EVICT_SHARED, EVICT_MODIFIED, UPGRADE_NOTIFY, NACK
};
// cache and directory states
enum { ST_M = 0, ST_E = 1, ST_S = 2, ST_I = 3 };
enum { D_EM = 0, D_S = 1, D_U = 2 };
// scalar counter rows
enum {
  SC_CYCLE = 0, SC_INSTR, SC_MSGS, SC_OVERFLOW, SC_RH, SC_RM, SC_WH,
  SC_WM, SC_EV, SC_INV
};
constexpr int kTrAddrShift = 9;
constexpr int kDwStateShift = 8, kDwShShift = 10;
constexpr int kCwValShift = 2, kCwAddrShift = 10;
constexpr int kAddrMask = (1 << 21) - 1;
// a node's word in shared memory across cycles: its mailbox ring head,
// and whether the last cycle of this launch left it deferred slots
constexpr int kRingMask = (1 << 14) - 1;
constexpr int kKnown = 1 << 14, kDeferred = 1 << 15;
// the outbox slots with one receiver each (phase A: 0, 1; phase B: 3, 4)
HPA2_HD int one_slot(int q) { return q < 2 ? q : q + 1; }

// The cache and directory word planes of one role (live or snapshot):
// int32 words, or (packed) a u8 value plane and a u8/u16 meta plane.
// Mirrored by hpa2_tpu_torch/ops/kernels.py:WordPlanes.
struct WordPlanes {
  int32_t* cachew;               // [N, C, B] unpacked
  int32_t* dirw;                 // [N, M, B] unpacked
  uint8_t* cvalw;                // [N, C, B] packed: value byte
  void* cmetaw;                  // [N, C, B] packed: state | (addr+1)<<2
  uint8_t* dmemw;                // [N, M, B] packed: memory byte
  void* dmetaw;                  // [N, M, B] packed: dir state | sharers<<2
  int32_t* dirs[kMaxSW];         // [N, M, B] split sharer words
};

// Everything one launch needs.  Mirrored field for field by
// hpa2_tpu_torch/ops/kernels.py:Args.
struct Args {
  int32_t n, c, m, cap, W, SW;
  int32_t b, bb;                 // lanes, lanes per block
  // launch geometry (kernels.py:launch_geometry): CTAs a lane block (a
  // cluster), systems a CTA, rounds a CTA runs them in, systems a round
  int32_t cl, per_cta, rounds, group;
  int32_t window, n_seg, t_pad;  // trace window, windows, padded length
  int32_t seg;                   // the per-call kernel's window index
  int32_t k, max_calls, gate, snapshots;
  int32_t nack, eager_write, flush_old_fill, recv_packed;
  int32_t packed, cmeta_u16, dmeta_u16;  // meta planes u16 (else u8)
  int32_t f_word[kNFields], f_off[kNFields], f_width[kNFields];
  int32_t count_mask, off_wait, off_pw, off_pc, pc_mask;
  WordPlanes live, snap;         // snap: when snapshots
  int32_t* mb[kMaxW];            // [N, cap, B]
  int32_t* nsw;                  // [N, B]
  int32_t* ob[kMaxW];            // [N, 5, B]
  int32_t* ob_recv;              // [N, 5, B] when recv is not packed
  int32_t* snap_taken;           // [N, B]
  int32_t* scalars;              // [10, B]
  int32_t* msg_counts;           // [15, B]
  const int32_t* tr;             // [N, t_pad, B]
  const int32_t* tr_len;         // [N, B]
  int32_t* status;               // [1, B]
};

HPA2_HD int popc(int32_t x) {
#ifdef __CUDA_ARCH__
  return __popc((unsigned)x);
#else
  return __builtin_popcount((unsigned)x);
#endif
}

// lowest set bit index, -1 when empty
HPA2_HD int find_owner(int32_t x) {
#ifdef __CUDA_ARCH__
  return __ffs(x) - 1;
#else
  return x == 0 ? -1 : __builtin_ctz((unsigned)x);
#endif
}

HPA2_HD int clip31(int p) { return p < 0 ? 0 : (p > 31 ? 31 : p); }
HPA2_HD int32_t bit_of(int p) { return p >= 0 ? (int32_t)(1u << clip31(p)) : 0; }
HPA2_HD bool test_bit(int32_t mask, int p) { return ((mask >> clip31(p)) & 1) == 1; }

// Sharer sets as KSW words of 31 bits (pallas_engine.py:733-779); with
// one word each helper is the single-word op of the unsplit layout.
// Loops run over the compile-time KSW so the words stay in registers.
template <int KSW>
HPA2_HD void sv_bit(int32_t* out, int p) {
  if (KSW == 1) {
    out[0] = bit_of(p);
    return;
  }
  HPA2_UNROLL for (int w = 0; w < KSW; ++w) {
    const int q = p - w * kSplitBpw;
    out[w] = q >= 0 && q < kSplitBpw ? (int32_t)(1u << q) : 0;
  }
}

template <int KSW>
HPA2_HD bool sv_test(const int32_t* sv, int p) {
  if (KSW == 1) return test_bit(sv[0], p);
  bool hit = false;
  HPA2_UNROLL for (int w = 0; w < KSW; ++w) {
    const int q = p - w * kSplitBpw;
    if (q >= 0 && q < kSplitBpw) hit = ((sv[w] >> q) & 1) == 1;
  }
  return hit;
}

template <int KSW>
HPA2_HD int sv_count(const int32_t* sv) {
  int cnt = 0;
  HPA2_UNROLL for (int w = 0; w < KSW; ++w) cnt += popc(sv[w]);
  return cnt;
}

// the lowest set bit across the words; -1 when empty
template <int KSW>
HPA2_HD int sv_owner(const int32_t* sv) {
  int own = -1;
  HPA2_UNROLL for (int w = KSW - 1; w >= 0; --w)
    if (sv[w] != 0) own = find_owner(sv[w]) + w * kSplitBpw;
  return own;
}

// Launch geometry checks: `cl` CTAs of at most G systems cover the
// block, none empty, each running `per_cta` systems in `rounds` rounds
// of `group`.
template <int MAXN>
HPA2_HD bool geometry_ok(const Args& a) {
  return a.cl >= 1 && a.cl <= kMaxCluster && a.group >= 1 &&
         a.group <= Bound<MAXN>::G && a.rounds >= 1 && a.per_cta >= 1 &&
         a.cl * a.per_cta >= a.bb && (a.cl - 1) * a.per_cta < a.bb &&
         a.rounds * a.group >= a.per_cta &&
         (a.rounds - 1) * a.group < a.per_cta;
}

// the instantiation of node bound MAXN holds this system: its split
// mode is the bound's and its words fit the bound's registers
template <int MAXN>
HPA2_HD bool fits(const Args& a) {
  using B = Bound<MAXN>;
  return a.n >= 1 && a.n <= MAXN && (a.n > 21) == B::SPLIT && a.W >= 1 &&
         a.W <= B::W && a.SW >= 1 && a.SW <= B::SW;
}

// the smallest node bound that holds the system and takes its lane
// blocks and geometry, or 0 when none does (the launch is then refused)
HPA2_HD int node_bound(const Args& a) {
  const int bound = a.n <= 8 ? 8 : (a.n <= 21 ? 21 : kMaxNodes);
  const bool ok = bound == 8 ? fits<8>(a) && geometry_ok<8>(a)
                  : bound == 21 ? fits<21>(a) && geometry_ok<21>(a)
                                : fits<kMaxNodes>(a) && geometry_ok<kMaxNodes>(a);
  if (!ok || a.bb < 1 || a.bb > kMaxBlock || a.b % a.bb != 0 ||
      a.cap < 1 || a.cap > kRingMask)
    return 0;
  return bound;
}

// element (row, lane) of a lane-last plane
#define HPA2_AT(p, row) (p)[(size_t)(row) * (size_t)a.b + (size_t)l]

// Packed planes: a meta element is u8 or u16 by the geometry.
HPA2_HD int32_t meta_ld(const void* p, int u16, size_t i) {
  return u16 ? (int32_t)((const uint16_t*)p)[i] : (int32_t)((const uint8_t*)p)[i];
}

HPA2_HD void meta_st(void* p, int u16, size_t i, int32_t v) {
  if (u16)
    ((uint16_t*)p)[i] = (uint16_t)v;
  else
    ((uint8_t*)p)[i] = (uint8_t)v;
}

// cache word of row `row`: state | value<<2 | (addr+1)<<10, joined from
// the packed planes when packed (pallas_engine.py:_widen_cache)
template <bool PACKED>
HPA2_HD int32_t cw_ld(const Args& a, const WordPlanes& p, int l, int row) {
  const size_t i = (size_t)row * (size_t)a.b + (size_t)l;
  if (!PACKED) return p.cachew[i];
  const int32_t cm = meta_ld(p.cmetaw, a.cmeta_u16, i);
  return (cm & 3) | ((int32_t)p.cvalw[i] << kCwValShift) |
         ((cm >> 2) << kCwAddrShift);
}

template <bool PACKED>
HPA2_HD void cw_st(const Args& a, const WordPlanes& p, int l, int row,
                   int32_t v) {
  const size_t i = (size_t)row * (size_t)a.b + (size_t)l;
  if (!PACKED) {
    p.cachew[i] = v;
    return;
  }
  p.cvalw[i] = (uint8_t)((v >> kCwValShift) & 0xFF);
  meta_st(p.cmetaw, a.cmeta_u16, i, (v & 3) | ((v >> kCwAddrShift) << 2));
}

// directory word of row `row`: mem | state<<8 | sharers<<10 (no sharers
// in split mode), joined from the packed planes when packed
template <bool PACKED>
HPA2_HD int32_t dw_ld(const Args& a, const WordPlanes& p, int l, int row) {
  const size_t i = (size_t)row * (size_t)a.b + (size_t)l;
  if (!PACKED) return p.dirw[i];
  const int32_t dm = meta_ld(p.dmetaw, a.dmeta_u16, i);
  return (int32_t)p.dmemw[i] | ((dm & 3) << kDwStateShift) |
         ((dm >> 2) << kDwShShift);
}

template <bool PACKED>
HPA2_HD void dw_st(const Args& a, const WordPlanes& p, int l, int row,
                   int32_t v) {
  const size_t i = (size_t)row * (size_t)a.b + (size_t)l;
  if (!PACKED) {
    p.dirw[i] = v;
    return;
  }
  p.dmemw[i] = (uint8_t)(v & 0xFF);
  meta_st(p.dmetaw, a.dmeta_u16, i,
          ((v >> kDwStateShift) & 3) | ((v >> kDwShShift) << 2));
}

// copy cache rows [c_r0, c_r1) and directory rows [m_r0, m_r1) to the
// snapshot planes as stored (narrow planes copy as they are)
template <int MAXN, bool PACKED>
HPA2_HD void copy_rows(const Args& a, int l, int c_r0, int c_r1, int m_r0,
                       int m_r1) {
  const WordPlanes& s = a.live;
  const WordPlanes& d = a.snap;
  for (int r = c_r0; r < c_r1; ++r) {
    const size_t i = (size_t)r * (size_t)a.b + (size_t)l;
    if (!PACKED) {
      d.cachew[i] = s.cachew[i];
    } else {
      d.cvalw[i] = s.cvalw[i];
      meta_st(d.cmetaw, a.cmeta_u16, i, meta_ld(s.cmetaw, a.cmeta_u16, i));
    }
  }
  for (int r = m_r0; r < m_r1; ++r) {
    const size_t i = (size_t)r * (size_t)a.b + (size_t)l;
    if (!PACKED) {
      d.dirw[i] = s.dirw[i];
    } else {
      d.dmemw[i] = s.dmemw[i];
      meta_st(d.dmetaw, a.dmeta_u16, i, meta_ld(s.dmetaw, a.dmeta_u16, i));
    }
    if (Bound<MAXN>::SPLIT)
      HPA2_UNROLL for (int w = 0; w < Bound<MAXN>::SW; ++w)
        if (w < a.SW) d.dirs[w][i] = s.dirs[w][i];
  }
}

// Message words live in registers: word q of a KW-word message is
// picked and updated by unrolled selects, never by a runtime index.
template <int KW>
HPA2_HD int32_t word_at(const int32_t* w, int q) {
  int32_t x = 0;
  HPA2_UNROLL for (int j = 0; j < KW; ++j) if (j == q) x = w[j];
  return x;
}

template <int KW>
HPA2_HD int fget(const Args& a, const int32_t* w, int f) {
  return (word_at<KW>(w, a.f_word[f]) >> a.f_off[f]) &
         (int32_t)((1u << a.f_width[f]) - 1u);
}

template <int KW>
HPA2_HD void fput(const Args& a, int32_t* w, int f, int32_t v) {
  HPA2_UNROLL for (int j = 0; j < KW; ++j)
    if (j == a.f_word[f]) w[j] |= v << a.f_off[f];
}

// wire words (Bound<MAXN>::W of them) of one message, sender field
// left zero; second < -1 means "no second field"; shr, when given, is a
// sharer set: the shr{w} fields in split mode, the aux union otherwise
template <int MAXN>
HPA2_HD void pack(const Args& a, int32_t* w, int type, int addr, int aux,
                  bool has_aux, int second, const int32_t* shr = nullptr) {
  constexpr int KW = Bound<MAXN>::W;
  HPA2_UNROLL for (int i = 0; i < KW; ++i) w[i] = 0;
  fput<KW>(a, w, F_TYPE, type);
  fput<KW>(a, w, F_ADDR, addr);
  if (shr != nullptr) {
    if (Bound<MAXN>::SPLIT) {
      HPA2_UNROLL for (int j = 0; j < Bound<MAXN>::SW; ++j)
        if (j < a.SW) fput<KW>(a, w, F_SHR0 + j, shr[j]);
    } else {
      aux = shr[0];
      has_aux = true;
    }
  }
  if (has_aux) fput<KW>(a, w, F_AUX, aux);
  if (second >= -1) fput<KW>(a, w, F_SECOND, second + 1);
}

// the INV word of sender s for address addr
template <int MAXN>
HPA2_HD void inv_word(const Args& a, int32_t* w, int s, int addr) {
  pack<MAXN>(a, w, INV, addr, 0, false, -2);
  fput<Bound<MAXN>::W>(a, w, F_SENDER, s);
}

// the sharer set a message carries (shr{w} fields, or the aux union)
template <int MAXN>
HPA2_HD void msg_sharers(const Args& a, const int32_t* w, int32_t* sv) {
  constexpr int KW = Bound<MAXN>::W;
  if (Bound<MAXN>::SPLIT) {
    HPA2_UNROLL for (int j = 0; j < Bound<MAXN>::SW; ++j)
      sv[j] = j < a.SW ? fget<KW>(a, w, F_SHR0 + j) : 0;
  } else {
    sv[0] = fget<KW>(a, w, F_AUX);
  }
}

// decoded trace-window length of node i for window seg
HPA2_HD int window_len(const Args& a, int l, int i, int seg) {
  int t = HPA2_AT(a.tr_len, i) - seg * a.window;
  return t < 0 ? 0 : (t > a.window ? a.window : t);
}

// receiver of node i's deferred outbox slot k (k != 2), -1 when the
// slot holds nothing
HPA2_HD int deferred_recv(const Args& a, int l, int i, int k) {
  if (!a.recv_packed) return HPA2_AT(a.ob_recv, i * kNSlots + k);
  const int32_t w = HPA2_AT(a.ob[a.f_word[F_RECV]], i * kNSlots + k);
  return ((w >> a.f_off[F_RECV]) & (int32_t)((1u << a.f_width[F_RECV]) - 1u)) - 1;
}

// the words of node i's deferred INV slot
template <int MAXN>
HPA2_HD void deferred_inv(const Args& a, int l, int i, int32_t* w) {
  HPA2_UNROLL for (int q = 0; q < Bound<MAXN>::W; ++q)
    w[q] = q < a.W ? HPA2_AT(a.ob[q], i * kNSlots + 2) : 0;
}

// node i has outstanding work: instructions left in the window, a
// wait, queued messages or a deferred slot
template <int MAXN>
HPA2_HD bool node_work(const Args& a, int l, int i, int seg,
                       bool maybe_deferred) {
  const int32_t nswv = HPA2_AT(a.nsw, i);
  const int pc = (nswv >> a.off_pc) & a.pc_mask;
  if (window_len(a, l, i, seg) > pc || ((nswv >> a.off_wait) & 1) ||
      (nswv & a.count_mask))
    return true;
  if (!maybe_deferred) return false;
  bool dv = false;
  HPA2_UNROLL for (int q = 0; q < 4; ++q)
    dv = dv || deferred_recv(a, l, i, one_slot(q)) != -1;
  if (dv) return true;
  int32_t w[Bound<MAXN>::W], sv[Bound<MAXN>::SW];
  deferred_inv<MAXN>(a, l, i, w);
  msg_sharers<MAXN>(a, w, sv);
  int32_t any = 0;
  HPA2_UNROLL for (int j = 0; j < Bound<MAXN>::SW; ++j) any |= sv[j];
  return any != 0;
}

// What one node publishes to the others of its system in a cycle.
struct NodeRec {
  int16_t rcv[4];   // receivers of slots 0, 1, 3, 4 (-1: none)
  uint8_t got[4];   // the slot was delivered (set by its receiver)
  int32_t nswp;     // the node's new nsw word; receivers add deliveries
  int32_t inv_addr; // address of its INV slot
  int32_t dv2;      // its INV slot was deferred at cycle start
};

// A CTA's shared memory, as views for `group` system slots of `rounds`
// rounds: per (node, slot) records, INV receiver sets and accepted INV
// receivers, a per-slot "had work" flag, per (round, slot) counters and
// mailbox ring heads, and the cluster's reduction words.  Arrays are slot-fast, so the threads
// of a warp (one node rank of neighbouring systems) touch neighbouring
// words.
template <int MAXN>
struct Shared {
  static constexpr int KSW = Bound<MAXN>::SW;
  NodeRec* rec;       // [MAXN][group]
  int32_t* inv;       // [MAXN][KSW][group]
  int32_t* inv_acc;   // [MAXN][KSW][group]
  int32_t* active;    // [group]
  uint32_t* cnt;      // [rounds][kNCount][group]
  uint16_t* head;     // [rounds][MAXN][group] Lane::node_word
  // senders with a candidate in phase A's slots (0, 1, INV) and in
  // phase B's (3, 4), as 64-bit masks: [2 parities][2 passes][2][group]
  int32_t* sent;
  int32_t* flags;     // [2] the cluster reduction's words
  int group;

  HPA2_HD static size_t head_bytes(int group, int rounds) {
    return ((size_t)rounds * MAXN * group * sizeof(uint16_t) + 3) & ~(size_t)3;
  }
  HPA2_HD static size_t bytes(int group, int rounds) {
    return (size_t)group *
               (MAXN * sizeof(NodeRec) + 2 * MAXN * KSW * sizeof(int32_t) +
                sizeof(int32_t) + (size_t)rounds * kNCount * sizeof(uint32_t)) +
           head_bytes(group, rounds) + 8 * (size_t)group * sizeof(int32_t) +
           2 * sizeof(int32_t);
  }
  HPA2_HD void bind(void* base, int g, int rounds) {
    group = g;
    char* p = (char*)base;
    rec = (NodeRec*)p;
    p += (size_t)MAXN * g * sizeof(NodeRec);
    inv = (int32_t*)p;
    p += (size_t)MAXN * KSW * g * sizeof(int32_t);
    inv_acc = (int32_t*)p;
    p += (size_t)MAXN * KSW * g * sizeof(int32_t);
    active = (int32_t*)p;
    p += (size_t)g * sizeof(int32_t);
    cnt = (uint32_t*)p;
    p += (size_t)rounds * kNCount * g * sizeof(uint32_t);
    head = (uint16_t*)p;
    p += head_bytes(g, rounds);
    sent = (int32_t*)p;
    p += 8 * (size_t)g * sizeof(int32_t);
    flags = (int32_t*)p;
  }
};

// One thread's view of one system slot in one round: its lane, its node
// rank, and the shared views of the slot.
template <int MAXN>
struct Lane {
  int l, t, g, r;
  int par;  // parity of the cycle-round: which sender masks it uses
  bool valid;
  const Shared<MAXN>* sh;
  HPA2_HD NodeRec& rec(int i) const { return sh->rec[i * sh->group + g]; }
  HPA2_HD int32_t& inv(int i, int w) const {
    return sh->inv[(i * Shared<MAXN>::KSW + w) * sh->group + g];
  }
  HPA2_HD int32_t& inv_acc(int i, int w) const {
    return sh->inv_acc[(i * Shared<MAXN>::KSW + w) * sh->group + g];
  }
  HPA2_HD uint32_t& cnt(int c) const {
    return sh->cnt[(r * kNCount + c) * sh->group + g];
  }
  // word w of the mask of senders with a candidate in phase `pass`'s
  // slots (0: A, 1: B) this cycle-round
  HPA2_HD int32_t& sent(int pass, int w) const {
    return sh->sent[((par * 2 + pass) * 2 + w) * sh->group + g];
  }
  // node i's ring head and deferral flags (kRingMask, kKnown, kDeferred)
  HPA2_HD uint16_t& node_word(int i) const {
    return sh->head[(r * MAXN + i) * sh->group + g];
  }
  // whether node i may hold deferred outbox slots: unknown until a cycle
  // of this launch has run
  HPA2_HD bool maybe_deferred(int i) const {
    const int v = node_word(i);
    return !(v & kKnown) || (v & kDeferred);
  }
};

// The lane of slot g of round r in CTA `rank` of lane block `blk`.
template <int MAXN>
HPA2_HD Lane<MAXN> lane_of(const Args& a, const Shared<MAXN>* sh, int blk,
                           int rank, int tid, int r, int step) {
  Lane<MAXN> x;
  x.t = tid / a.group;
  x.g = tid % a.group;
  x.r = r;
  x.par = step & 1;
  x.sh = sh;
  const int q = r * a.group + x.g;
  const int sys = rank * a.per_cta + q;
  x.valid = q < a.per_cta && sys < a.bb;
  x.l = blk * a.bb + sys;
  return x;
}

// Shared-memory updates made by several threads of a system.
HPA2_HD void sh_add(uint32_t* p, uint32_t v) {
#ifdef __CUDA_ARCH__
  atomicAdd(p, v);
#else
  *p += v;
#endif
}

HPA2_HD void sh_or(int32_t* p, int32_t v) {
#ifdef __CUDA_ARCH__
  atomicOr(p, v);
#else
  *p |= v;
#endif
}

template <int KW>
struct Slot {
  int recv;
  int32_t w[KW];
};

template <int KW>
HPA2_HD void put(Slot<KW>& s, int recv, const int32_t* w) {
  s.recv = recv;
  HPA2_UNROLL for (int i = 0; i < KW; ++i) s.w[i] = w[i];
}

// ===== phase AB: every node of lane x.l that thread x.t owns ==========
// handles its mailbox head (A), issues one instruction (B), stages its
// fresh sends in its outbox slots and publishes them.
template <int MAXN, bool PACKED>
HPA2_HD void phase_ab(const Args& a, const Lane<MAXN>& x, const int seg) {
  constexpr int KW = Bound<MAXN>::W, KSW = Bound<MAXN>::SW;
  constexpr bool SPLIT = Bound<MAXN>::SPLIT;
  const int l = x.l;
  const int n = a.n, c = a.c, m = a.m, cap = a.cap, W = a.W;
  const int32_t sh_mask = (int32_t)((1u << (n < kSplitBpw ? n : kSplitBpw)) - 1u);
  const int snd_word = a.f_word[F_SENDER], snd_off = a.f_off[F_SENDER];

  bool lane_act = false;
  uint32_t n_instr = 0, n_rh = 0, n_rm = 0, n_wh = 0, n_wm = 0, n_ev = 0;
  uint32_t n_inv = 0;
  int32_t tmp[KW];

  for (int i = x.t; i < n; i += Bound<MAXN>::T) {
    const int32_t nswv = HPA2_AT(a.nsw, i);
    const int mbc = nswv & a.count_mask;
    const int wt_in = (nswv >> a.off_wait) & 1;
    const int pw = (nswv >> a.off_pw) & 0xFF;
    const int pc = (nswv >> a.off_pc) & a.pc_mask;
    const int tl = window_len(a, l, i, seg);
    // deferred slots: receivers of 0, 1, 3, 4, and the INV slot's set
    // (read only when the node's last cycle in this launch left some)
    int drecv[4] = {-1, -1, -1, -1};
    int32_t ow2[KW], ish[KSW];
    HPA2_UNROLL for (int w = 0; w < KW; ++w) ow2[w] = 0;
    HPA2_UNROLL for (int w = 0; w < KSW; ++w) ish[w] = 0;
    bool blocked = false;
    int32_t dv2 = 0;
    if (x.maybe_deferred(i)) {
      HPA2_UNROLL for (int q = 0; q < 4; ++q) {
        drecv[q] = deferred_recv(a, l, i, one_slot(q));
        blocked = blocked || drecv[q] != -1;
      }
      deferred_inv<MAXN>(a, l, i, ow2);
      msg_sharers<MAXN>(a, ow2, ish);
      HPA2_UNROLL for (int w = 0; w < KSW; ++w) dv2 |= ish[w];
      dv2 = dv2 != 0;
      blocked = blocked || dv2;
    }
    int inv_addr = dv2 ? fget<KW>(a, ow2, F_ADDR) : 0;
    lane_act = lane_act || tl > pc || wt_in || mbc || blocked;

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
      // pop the head: the ring advances, and the popped word stays in
      // its physical slot, now the logical tail (the reference's
      // rotation, settled once a launch by settle_mailbox)
      const int nw = x.node_word(i), h = nw & kRingMask;
      x.node_word(i) = (uint16_t)((nw & ~kRingMask) | (h + 1 == cap ? 0 : h + 1));
      int32_t head[KW];
      HPA2_UNROLL for (int w = 0; w < KW; ++w)
        head[w] = w < W ? HPA2_AT(a.mb[w], i * cap + h) : 0;
      const int mt = fget<KW>(a, head, F_TYPE);
      const int snd = fget<KW>(a, head, F_SENDER);
      const int sr = fget<KW>(a, head, F_SECOND) - 1;
      const int ad = fget<KW>(a, head, F_ADDR);
      const int aux = fget<KW>(a, head, F_AUX);
      const int v = aux & 0xFF;

      const int home = ad / m, blk = ad % m, ci = ad % c;
      const bool is_home = i == home, is_second = i == sr;
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
            sv_bit<KSW>(self_bit, i);
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
      n_instr += 1;
      n_rh += is_rd && hit;
      n_rm += rm;
      n_wh += is_wr && hit;
      n_wm += wm;
    }
    n_ev += ev || ev_issue;
    n_inv += inv_applied;

    // ===== publish ===================================================
    // A blocked node sends its deferred slots, whose words (sender and,
    // packed, recv fields included) are in its outbox already; a free
    // node has no deferred slot, so its outbox is empty and takes the
    // fresh sends' words, sender field set.
    NodeRec& rec = x.rec(i);
    HPA2_UNROLL for (int q = 0; q < 4; ++q) {
      int r = blocked ? drecv[q] : sl[q].recv;
      if (!blocked && r >= 0) {
        const int row = i * kNSlots + one_slot(q);
        HPA2_UNROLL for (int w = 0; w < KW; ++w)
          if (w < W)
            HPA2_AT(a.ob[w], row) =
                sl[q].w[w] | (w == snd_word ? i << snd_off : 0);
        if (!a.recv_packed) HPA2_AT(a.ob_recv, row) = r;
      }
      // receivers are nodes (< 64) or, for addresses outside the
      // system, values no node matches
      rec.rcv[q] = (int16_t)(r > 32767 ? 32767 : r);
      rec.got[q] = 0;
    }
    int32_t inv_any = 0;
    HPA2_UNROLL for (int w = 0; w < KSW; ++w) inv_any |= ish[w];
    const int32_t me = (int32_t)(1u << (i & 31));
    if (rec.rcv[0] >= 0 || rec.rcv[1] >= 0 || inv_any) sh_or(&x.sent(0, i >> 5), me);
    if (rec.rcv[2] >= 0 || rec.rcv[3] >= 0) sh_or(&x.sent(1, i >> 5), me);
    rec.nswp = count2 | (wt << a.off_wait) | (pending << a.off_pw) |
               ((pc + (elig ? 1 : 0)) << a.off_pc);
    rec.inv_addr = inv_addr;
    rec.dv2 = dv2;
    HPA2_UNROLL for (int w = 0; w < KSW; ++w) {
      x.inv(i, w) = ish[w];
      x.inv_acc(i, w) = 0;
    }
  }

  if (lane_act) x.sh->active[x.g] = 1;
  const uint32_t inc[] = {n_instr, n_rh, n_rm, n_wh, n_wm, n_ev, n_inv};
  const int row[] = {SC_INSTR, SC_RH, SC_RM, SC_WH, SC_WM, SC_EV, SC_INV};
  HPA2_UNROLL for (int j = 0; j < 7; ++j)
    if (inc[j]) sh_add(&x.cnt(row[j]), inc[j]);
}

// the lowest sender >= s0 with a candidate in phase `pass`'s slots, or -1
template <int MAXN>
HPA2_HD int next_sender(const Lane<MAXN>& x, int pass, int s0) {
  for (int w = s0 >> 5; w < (MAXN + 31) / 32; ++w) {
    uint32_t m = (uint32_t)x.sent(pass, w);
    if (w == s0 >> 5) m &= ~0u << (s0 & 31);
    if (m) return w * 32 + find_owner((int32_t)m);
  }
  return -1;
}

// ===== phase C: deterministic delivery, per receiver ==================
// Each receiver that thread x.t owns takes its candidates in the
// reference's order: the phase-A candidate of senders 0..n-1 (a
// sender's slots 0, 1 and INV are receiver-disjoint and deliver as one
// candidate, the word a per-receiver select), then slots 3 and 4 of
// senders 0..n-1.  It accepts while its queue has room.
template <int MAXN>
HPA2_HD void phase_c(const Args& a, const Lane<MAXN>& x) {
  constexpr int KW = Bound<MAXN>::W, KSW = Bound<MAXN>::SW;
  const int l = x.l, n = a.n, cap = a.cap, W = a.W, t = x.t;

  if (t == 0) {  // a lane accrues a cycle only while it had work
    if (x.sh->active[x.g]) x.cnt(SC_CYCLE) += 1;
    x.sh->active[x.g] = 0;
  }
  auto owns = [&](int r) -> bool {
    return r >= 0 && r < n && r % Bound<MAXN>::T == t;
  };
  // append to r's queue, if it has room, sender s's slot k (2: its INV)
  auto deliver = [&](int r, int s, int k) -> bool {
    NodeRec& rr = x.rec(r);
    const int pos = rr.nswp & a.count_mask;
    if (pos >= cap) return false;
    int slot = pos + (x.node_word(r) & kRingMask);
    if (slot >= cap) slot -= cap;
    int32_t w[KW];
    if (k == 2) {
      inv_word<MAXN>(a, w, s, x.rec(s).inv_addr);
    } else {  // every word loaded before any is stored (see phase A)
      HPA2_UNROLL for (int q = 0; q < KW; ++q)
        w[q] = q < W ? HPA2_AT(a.ob[q], s * kNSlots + k) : 0;
    }
    HPA2_UNROLL for (int q = 0; q < KW; ++q)
      if (q < W) HPA2_AT(a.mb[q], r * cap + slot) = w[q];
    rr.nswp += 1;
    return true;
  };

  // senders in increasing order, those with a candidate only
  for (int s = next_sender(x, 0, 0); s >= 0; s = next_sender(x, 0, s + 1)) {
    NodeRec& rs = x.rec(s);
    const int r0 = rs.rcv[0], r1 = rs.rcv[1];
    int32_t iv[KSW];
    int32_t inv_any = 0;
    HPA2_UNROLL for (int w = 0; w < KSW; ++w) {
      iv[w] = x.inv(s, w);
      inv_any |= iv[w];
    }
    if (inv_any == 0) {
      if (owns(r0) && deliver(r0, s, r1 == r0 ? 1 : 0)) {
        rs.got[0] = 1;
        if (r1 == r0) rs.got[1] = 1;
      }
      if (r1 != r0 && owns(r1) && deliver(r1, s, 1)) rs.got[1] = 1;
      continue;
    }
    for (int r = t; r < n; r += Bound<MAXN>::T) {
      const bool vA0 = r == r0, vA1 = r == r1;
      const bool vInv = sv_test<KSW>(iv, r);
      if (!(vA0 || vA1 || vInv)) continue;
      if (!deliver(r, s, vA1 ? 1 : (vInv ? 2 : 0))) continue;
      if (vA0) rs.got[0] = 1;
      if (vA1) rs.got[1] = 1;
      if (vInv)
        sh_or(&x.inv_acc(s, r / kSplitBpw), (int32_t)(1u << (r % kSplitBpw)));
    }
  }
  for (int s = next_sender(x, 1, 0); s >= 0; s = next_sender(x, 1, s + 1)) {
    NodeRec& rs = x.rec(s);
    HPA2_UNROLL for (int q = 2; q < 4; ++q) {
      const int r = rs.rcv[q];
      if (owns(r) && deliver(r, s, one_slot(q))) rs.got[q] = 1;
    }
  }
  bool ov = false;
  for (int r = t; r < n; r += Bound<MAXN>::T)
    ov = ov || (x.rec(r).nswp & a.count_mask) > cap;
  if (ov) sh_add(&x.cnt(SC_OVERFLOW), 1);
}

// ===== phase C2: every sender thread x.t owns ==========================
// clears its delivered slots, keeps the rest for the next cycle (and is
// then blocked), writes nsw, counts its deliveries by type and takes
// the phase-D snapshot.
template <int MAXN, bool PACKED>
HPA2_HD void phase_c2(const Args& a, const Lane<MAXN>& x, const int seg) {
  constexpr int KW = Bound<MAXN>::W, KSW = Bound<MAXN>::SW;
  constexpr bool SPLIT = Bound<MAXN>::SPLIT;
  const int l = x.l, n = a.n, c = a.c, m = a.m, W = a.W;
  const int recv_w = a.f_word[F_RECV], recv_off = a.f_off[F_RECV];
  const int type_w = a.f_word[F_TYPE], type_off = a.f_off[F_TYPE];
  const int32_t type_mask = (int32_t)((1u << a.f_width[F_TYPE]) - 1u);
  // the fields of the INV remainder: shr{w} in split mode, else aux
  const int rem_f0 = SPLIT ? F_SHR0 : F_AUX;

  if (x.t == 0)  // every receiver has read them (phase C)
    HPA2_UNROLL for (int j = 0; j < 4; ++j) x.sent(j >> 1, j & 1) = 0;
  for (int s = x.t; s < n; s += Bound<MAXN>::T) {
    const NodeRec& rs = x.rec(s);
    bool blocked_next = false;
    HPA2_UNROLL for (int q = 0; q < 4; ++q) {
      const int r = rs.rcv[q];
      if (r < 0) continue;
      const int row = s * kNSlots + one_slot(q);
      if (rs.got[q]) {
        const int t = (HPA2_AT(a.ob[type_w], row) >> type_off) & type_mask;
        sh_add(&x.cnt(SC_MSGS), 1);
        if (t < kNTypes) sh_add(&x.cnt(kNScalar + t), 1);
        HPA2_UNROLL for (int w = 0; w < KW; ++w)
          if (w < W) HPA2_AT(a.ob[w], row) = 0;
        if (!a.recv_packed) HPA2_AT(a.ob_recv, row) = -1;
      } else {
        blocked_next = true;
        if (a.recv_packed) HPA2_AT(a.ob[recv_w], row) |= (r + 1) << recv_off;
      }
    }
    // the INV slot: receivers that did not accept stay in its set
    int32_t rem[KSW];
    int32_t rem_any = 0;
    int dinv = 0;
    HPA2_UNROLL for (int w = 0; w < KSW; ++w) {
      const int32_t acc = x.inv_acc(s, w);
      rem[w] = x.inv(s, w) & ~acc;
      rem_any |= rem[w];
      dinv += popc(acc);
    }
    if (dinv) {
      sh_add(&x.cnt(SC_MSGS), dinv);
      sh_add(&x.cnt(kNScalar + INV), dinv);
    }
    if (rem_any || rs.dv2) {
      int32_t w2[KW];
      inv_word<MAXN>(a, w2, s, rs.inv_addr);
      HPA2_UNROLL for (int j = 0; j < KSW; ++j)
        if (j < (SPLIT ? a.SW : 1)) fput<KW>(a, w2, rem_f0 + j, rem[j]);
      HPA2_UNROLL for (int w = 0; w < KW; ++w)
        if (w < W) HPA2_AT(a.ob[w], s * kNSlots + 2) = rem_any ? w2[w] : 0;
      blocked_next = blocked_next || rem_any;
    }
    const int32_t nswf = rs.nswp;
    HPA2_AT(a.nsw, s) = nswf;
    x.node_word(s) = (uint16_t)((x.node_word(s) & kRingMask) | kKnown |
                                (blocked_next ? kDeferred : 0));

    // ===== phase D: dump-at-local-completion snapshots ===============
    if (a.snapshots) {
      const int pcv = (nswf >> a.off_pc) & a.pc_mask;
      const bool done = pcv >= window_len(a, l, s, seg) &&
                        ((nswf >> a.off_wait) & 1) == 0 &&
                        (nswf & a.count_mask) == 0 && !blocked_next;
      const bool taken = HPA2_AT(a.snap_taken, s) != 0;
      if (done && !taken)
        copy_rows<MAXN, PACKED>(a, l, s * c, (s + 1) * c, s * m, (s + 1) * m);
      HPA2_AT(a.snap_taken, s) = (taken || done) ? 1 : 0;
    }
  }
}

// ===== teams ===========================================================
// A team runs a lane block: on the card, the cluster of CTAs that holds
// it, each thread calling the team with its own lane; in the host build,
// every (CTA, thread) of the block in turn.  Either way:
//   each(r, f): f on every valid lane of round r, then a barrier;
//   all(f): f on every valid lane of every round, then a barrier;
//   any(f): whether f holds on some valid lane of the block (every
//     thread gets the answer; a barrier);
//   sync(): a barrier.
// The phases of a cycle are separated by barriers only where one
// thread reads what another wrote; phase C2 writes only its own
// nodes' planes and records, so the next phase AB follows it at once.

template <int MAXN, bool PACKED, class Team>
HPA2_HD void cycle(const Args& a, Team& tm, const int seg) {
  for (int r = 0; r < a.rounds; ++r) {
    tm.each(r, [&](const Lane<MAXN>& x) { phase_ab<MAXN, PACKED>(a, x, seg); });
    tm.each(r, [&](const Lane<MAXN>& x) { phase_c<MAXN>(a, x); });
    tm.each(r, [&](const Lane<MAXN>& x) { phase_c2<MAXN, PACKED>(a, x, seg); },
            false);
    // the next cycle-round's phase AB may run beside this phase C2, so
    // it marks its senders in the other parity's masks
    ++tm.step;
  }
}

// Rotate node i's mailbox left by h slots in every word plane, so that
// its ring head is slot 0 again: the planes as the reference leaves them.
template <int MAXN>
HPA2_HD void settle_mailbox(const Args& a, int l, int i, int h) {
  const int cap = a.cap;
  HPA2_UNROLL for (int w = 0; w < Bound<MAXN>::W; ++w) {
    if (w >= a.W) continue;
    int32_t* q = a.mb[w];
    if (cap <= 32) {  // the whole queue in registers, one round trip
      int32_t v[32];
      HPA2_UNROLL for (int j = 0; j < 32; ++j)
        if (j < cap) v[j] = HPA2_AT(q, i * cap + j);
      HPA2_UNROLL for (int j = 0; j < 32; ++j)
        if (j < cap) HPA2_AT(q, i * cap + (j >= h ? j - h : j - h + cap)) = v[j];
      continue;
    }
    // longer queues: rotate cycle by cycle (gcd(h, cap) cycles)
    int g = cap, r = h;
    while (r) {
      const int t = g % r;
      g = r;
      r = t;
    }
    for (int s0 = 0; s0 < g; ++s0) {
      const int32_t first = HPA2_AT(q, i * cap + s0);
      int j = s0;
      while (true) {
        int k = j + h;
        if (k >= cap) k -= cap;
        if (k == s0) break;
        HPA2_AT(q, i * cap + j) = HPA2_AT(q, i * cap + k);
        j = k;
      }
      HPA2_AT(q, i * cap + j) = first;
    }
  }
}

// Once a launch: settle the mailboxes and add the block's counters to
// the planes (the overflow row is sticky).
template <int MAXN, class Team>
HPA2_HD void write_back(const Args& a, Team& tm) {
  tm.sync();
  tm.all([&](const Lane<MAXN>& x) {
    const int l = x.l;
    for (int i = x.t; i < a.n; i += Bound<MAXN>::T) {
      const int h = x.node_word(i) & kRingMask;
      if (h) settle_mailbox<MAXN>(a, l, i, h);
    }
    for (int j = x.t; j < kNCount; j += Bound<MAXN>::T) {
      const uint32_t v = x.cnt(j);
      if (j == SC_OVERFLOW) {
        if (v && HPA2_AT(a.scalars, SC_OVERFLOW) < 1)
          HPA2_AT(a.scalars, SC_OVERFLOW) = 1;
      } else if (j < kNScalar) {
        HPA2_AT(a.scalars, j) = (int32_t)((uint32_t)HPA2_AT(a.scalars, j) + v);
      } else {
        HPA2_AT(a.msg_counts, j - kNScalar) =
            (int32_t)((uint32_t)HPA2_AT(a.msg_counts, j - kNScalar) + v);
      }
    }
  });
}

template <int MAXN, class Team>
HPA2_HD bool block_work(const Args& a, Team& tm, const int seg) {
  return tm.any([&](const Lane<MAXN>& x) {
    for (int i = x.t; i < a.n; i += Bound<MAXN>::T)
      if (node_work<MAXN>(a, x.l, i, seg, x.maybe_deferred(i))) return true;
    return false;
  });
}

// One cycle of a lane block (the host tests' single-cycle entry).
template <int MAXN, bool PACKED, class Team>
HPA2_HD void cycle_block(const Args& a, Team& tm, const int seg) {
  cycle<MAXN, PACKED>(a, tm, seg);
  write_back<MAXN>(a, tm);
}

// The streamed run of one lane block.  Decisions are the block's, so
// every thread of its cluster follows the same control flow.
template <int MAXN, bool PACKED, class Team>
HPA2_HD void stream_block(const Args& a, Team& tm) {
  // a call is ceil(k/8) gated bursts of 8 cycles, or one burst of k
  // cycles without the gate
  const int bursts = a.gate ? (a.k + kGate - 1) / kGate : 1;
  const int burst_len = a.gate ? kGate : a.k;
  int calls = 0;
  bool stalled = false;
  for (int seg = 0; seg < a.n_seg; ++seg) {
    // window base: every lane is quiescent, so pc restarts at 0
    tm.all([&](const Lane<MAXN>& x) {
      const int l = x.l;
      for (int i = x.t; i < a.n; i += Bound<MAXN>::T)
        HPA2_AT(a.nsw, i) &= ~(a.pc_mask << a.off_pc);
    });
    while (true) {
      // the call budget carries across windows
      if (!block_work<MAXN>(a, tm, seg) || calls >= a.max_calls) break;
      for (int g = 0; g < bursts; ++g) {
        // gate 0 opens: the loop test just found work; a closed gate
        // stays closed
        if (g > 0 && !block_work<MAXN>(a, tm, seg)) break;
        for (int j = 0; j < burst_len; ++j) cycle<MAXN, PACKED>(a, tm, seg);
      }
      ++calls;
    }
    stalled = block_work<MAXN>(a, tm, seg) || stalled;
  }
  write_back<MAXN>(a, tm);
  tm.all([&](const Lane<MAXN>& x) {
    const int l = x.l;
    if (x.t == 0) HPA2_AT(a.status, 0) = stalled;
  });
}

// One call of the per-call kernel on one lane block: up to k cycles in
// trace window a.seg, read in place from the whole [N, t_pad, B] trace
// plane.  With the gate, each of the ceil(k/8) bursts of 8 cycles runs
// only while the block has work (burst 0 is gated too: unlike the
// streamed run, the call does not know that the block is busy); without
// it, k cycles run straight.  The host loop (ops/call_run.py:
// run_windows) clears pc at window bases and decides, from the whole
// ensemble, whether another call is needed.
template <int MAXN, bool PACKED, class Team>
HPA2_HD void call_block(const Args& a, Team& tm) {
  const int seg = a.seg;
  if (!a.gate) {
    for (int j = 0; j < a.k; ++j) cycle<MAXN, PACKED>(a, tm, seg);
  } else {
    const int bursts = (a.k + kGate - 1) / kGate;
    for (int g = 0; g < bursts; ++g) {
      // a quiescent block stays quiescent
      if (!block_work<MAXN>(a, tm, seg)) break;
      for (int j = 0; j < kGate; ++j) cycle<MAXN, PACKED>(a, tm, seg);
    }
  }
  write_back<MAXN>(a, tm);
}

#ifdef __CUDACC__
// The card's team: this thread of a CTA of the lane block's cluster.
// The block's decisions are __syncthreads_or within the CTA, then an OR
// of the CTAs' words through distributed shared memory between two
// cluster barriers (double-buffered, so one barrier a decision).
template <int MAXN>
struct DeviceTeam {
  const Args& a;
  Shared<MAXN> sh;
  int tid, rank, blk, parity, step;

  __device__ DeviceTeam(const Args& args, void* smem) : a(args) {
    tid = threadIdx.x;
    rank = blockIdx.x % a.cl;
    blk = blockIdx.x / a.cl;
    parity = 0;
    step = 0;
    sh.bind(smem, a.group, a.rounds);
    const int words = (int)(Shared<MAXN>::bytes(a.group, a.rounds) / 4);
    for (int j = tid; j < words; j += blockDim.x) ((int32_t*)smem)[j] = 0;
    __syncthreads();
  }
  __device__ Lane<MAXN> lane(int r) const {
    return lane_of<MAXN>(a, &sh, blk, rank, tid, r, step);
  }
  template <class F>
  __device__ void each(int r, F&& f, bool barrier = true) {
    const Lane<MAXN> x = lane(r);
    if (x.valid) f(x);
    if (barrier) __syncthreads();
  }
  template <class F>
  __device__ void all(F&& f) {
    for (int r = 0; r < a.rounds; ++r) each(r, f, false);
    __syncthreads();
  }
  template <class F>
  __device__ bool any(F&& f) {
    int v = 0;
    for (int r = 0; r < a.rounds; ++r) {
      const Lane<MAXN> x = lane(r);
      if (x.valid && f(x)) v = 1;
    }
    v = __syncthreads_or(v);
    if (a.cl == 1) return v != 0;
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    if (tid == 0) sh.flags[parity] = v;
    cluster.sync();
    int u = 0;
    if (tid < a.cl) u = *cluster.map_shared_rank(&sh.flags[parity], tid);
    parity ^= 1;
    return __syncthreads_or(u) != 0;
  }
  __device__ void sync() { __syncthreads(); }
  // no CTA leaves while another may still read its shared memory
  __device__ void finish() {
    if (a.cl > 1) cooperative_groups::this_cluster().sync();
  }
};

// Launch `kernel` (one of the team kernels) with the block's geometry:
// b/bb clusters of cl CTAs of group x T threads, and the shared
// memory of the node bound MAXN.  A refused launch returns its error.
template <int MAXN>
cudaError_t launch_team(void (*kernel)(const Args), const Args& a,
                        cudaStream_t s) {
  const size_t smem = Shared<MAXN>::bytes(a.group, a.rounds);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.b / a.bb) * a.cl);
  cfg.blockDim = dim3(a.group * Bound<MAXN>::T);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// What the card makes of that launch: out[0] CTAs an SM can hold,
// out[1] clusters the card can hold at once, out[2] dynamic shared
// memory a CTA, out[3] threads a CTA.
template <int MAXN>
cudaError_t occupancy_team(void (*kernel)(const Args), const Args& a,
                           int* out) {
  const size_t smem = Shared<MAXN>::bytes(a.group, a.rounds);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err != cudaSuccess) return err;
  const int threads = a.group * Bound<MAXN>::T;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((a.b / a.bb) * a.cl);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.cl;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaOccupancyMaxActiveClusters(&out[1], kernel, &cfg);
  out[2] = (int)smem;
  out[3] = threads;
  return err;
}
#else
// The host build's team: runs each phase for every (CTA, thread) of the
// block in turn, with its own copy of each CTA's shared memory; its
// barriers are the phase boundaries and its OR is over the whole block,
// as the card's cluster reduction gives.
template <int MAXN>
struct HostTeam {
  const Args& a;
  int blk, step = 0;
  std::vector<std::vector<uint32_t>> mem;
  std::vector<Shared<MAXN>> sh;

  HostTeam(const Args& args, int block) : a(args), blk(block) {
    const size_t words = Shared<MAXN>::bytes(a.group, a.rounds) / 4 + 1;
    mem.assign(a.cl, std::vector<uint32_t>(words, 0));
    sh.resize(a.cl);
    for (int c = 0; c < a.cl; ++c) sh[c].bind(mem[c].data(), a.group, a.rounds);
  }
  template <class F>
  void each(int r, F&& f, bool = true) {
    for (int c = 0; c < a.cl; ++c)
      for (int tid = 0; tid < a.group * Bound<MAXN>::T; ++tid) {
        const Lane<MAXN> x = lane_of<MAXN>(a, &sh[c], blk, c, tid, r, step);
        if (x.valid) f(x);
      }
  }
  template <class F>
  void all(F&& f) {
    for (int r = 0; r < a.rounds; ++r) each(r, f);
  }
  template <class F>
  bool any(F&& f) {
    bool v = false;
    for (int r = 0; r < a.rounds; ++r)
      each(r, [&](const Lane<MAXN>& x) { v = f(x) || v; });
    return v;
  }
  void sync() {}
};
#endif

}  // namespace hpa2
