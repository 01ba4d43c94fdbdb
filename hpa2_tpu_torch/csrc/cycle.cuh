// One lockstep cycle of one simulated system, and the two run loops
// around it, as scalar code over the lane-last planes.
//
// Replaces: hpa2_tpu/ops/pallas_engine.py:build_cycle (the cycle body,
// phases A-D and counters), :_make_stream_run.kernel (the whole-run
// loop: trace windows x while-to-quiescence x gated 8-cycle bursts;
// stream_lanes below) and :_build_call.kernel (one call of up to k
// gated cycles on one resident trace window; call_lanes below).
//
// The TPU kernel runs the cycle vectorised over a block of lanes; here
// one thread runs one system, and the code is __host__ __device__ so
// that g++ builds the same logic for the CPU tests.  The planes keep
// the JAX package's layout and bits exactly: element (row, lane) of a
// plane [R..., B] sits at row * B + lane, so neighbouring threads touch
// neighbouring words.  Message words, the mailbox rotated so its head
// is at slot 0 (the popped head goes to the vacated tail slot), the
// recv field of deferred outbox words, the nsw packing and the sticky
// overflow row are the Pallas planes bit for bit.
//
// Wide systems (more than 21 nodes) keep their sharer sets in SW split
// planes dirs{w} of 31-bit words and carry them in shr{w} message fields
// (pallas_engine.py:_split_mode); packed planes (u8 values, u8/u16 meta)
// are widened to the int32 words as each word is loaded and narrowed as
// it is stored, which equals the TPU kernel's whole-plane widen at cycle
// entry and narrow at exit because the split is lossless.
//
// What bounds it on an H100: it is a long chain of dependent integer
// work and small gathers per system, with about 1.4 KB of state per
// system at the 8-node headline and 45 KB at 64 nodes.  The bytes a run
// must move (state once each way, traces once) take well under a
// millisecond at 3.35 TB/s, so the kernel is latency bound: each thread
// walks its own control flow and waits on its own loads (on an H100
// 80GB HBM3 at 700 W the 8-node headline takes ~145 ms against a
// 0.07 ms bytes bound, the 64-node run ~1.7 s against 0.033 ms, and
// more, smaller thread blocks gain 5-10%).  The design keeps the state
// in device memory in place (coalesced across the warp, reused from L1
// and L2 across cycles), keeps per-cycle temporaries in a fixed-size
// local frame sized by a compile-time node bound (8, 21 or 64: 1.3, 3.0
// and 12.5 KB a thread), and runs the whole run in one launch so there
// is no host round trip per window or call.
// The gate is a block-wide __syncthreads_or every 8 cycles.
#pragma once

#include <stddef.h>
#include <stdint.h>

// Everything is inlined into the kernel: an out-of-line cycle body
// takes a call frame and, at up to 21 nodes, half the registers.
#ifdef __CUDACC__
#define HPA2_HD __host__ __device__ __forceinline__
#else
#define HPA2_HD inline
#endif

namespace hpa2 {

constexpr int kNSlots = 5;
constexpr int kNScalar = 10;
constexpr int kNTypes = 15;
constexpr int kGate = 8;
constexpr int kMaxBlock = 1024;
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
template <int MAXN>
struct Bound {
  static constexpr bool SPLIT = MAXN > 21;
  static constexpr int SW = SPLIT ? (MAXN + kSplitBpw - 1) / kSplitBpw : 1;
  static constexpr int W = SPLIT ? 2 + SW : 3;
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

// Sharer sets as SW words of 31 bits (pallas_engine.py:733-779); with
// SW == 1 each helper is the single-word op of the unsplit layout.
HPA2_HD void sv_bit(int32_t* out, int p, int sw) {
  if (sw == 1) {
    out[0] = bit_of(p);
    return;
  }
  for (int w = 0; w < sw; ++w) {
    const int q = p - w * kSplitBpw;
    out[w] = q >= 0 && q < kSplitBpw ? (int32_t)(1u << q) : 0;
  }
}

HPA2_HD bool sv_test(const int32_t* sv, int p, int sw) {
  if (sw == 1) return test_bit(sv[0], p);
  for (int w = 0; w < sw; ++w) {
    const int q = p - w * kSplitBpw;
    if (q >= 0 && q < kSplitBpw) return ((sv[w] >> q) & 1) == 1;
  }
  return false;
}

HPA2_HD int sv_count(const int32_t* sv, int sw) {
  int cnt = 0;
  for (int w = 0; w < sw; ++w) cnt += popc(sv[w]);
  return cnt;
}

// the lowest set bit across the words; -1 when empty
HPA2_HD int sv_owner(const int32_t* sv, int sw) {
  for (int w = 0; w < sw; ++w)
    if (sv[w] != 0) return find_owner(sv[w]) + w * kSplitBpw;
  return -1;
}

// true on every thread of the block when the predicate holds on any
// lane of the block (the host build runs a whole block in one call)
HPA2_HD int block_any(int x) {
#ifdef __CUDA_ARCH__
  return __syncthreads_or(x);
#else
  return x;
#endif
}

// the instantiation of node bound MAXN holds this system: its split
// mode is the bound's and its words fit the bound's frame
template <int MAXN>
HPA2_HD bool fits(const Args& a) {
  using B = Bound<MAXN>;
  return a.n >= 1 && a.n <= MAXN && (a.n > 21) == B::SPLIT && a.W >= 1 &&
         a.W <= B::W && a.SW >= 1 && a.SW <= B::SW;
}

// the smallest node bound that holds the system and takes its lane
// blocks, or 0 when none does (the launch is then refused)
HPA2_HD int node_bound(const Args& a) {
  const int bound = a.n <= 8 ? 8 : (a.n <= 21 ? 21 : kMaxNodes);
  const bool ok = bound == 8 ? fits<8>(a)
                  : bound == 21 ? fits<21>(a) : fits<kMaxNodes>(a);
  if (!ok || a.bb < 1 || a.bb > kMaxBlock || a.b % a.bb != 0) return 0;
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
      for (int w = 0; w < a.SW; ++w) d.dirs[w][i] = s.dirs[w][i];
  }
}

HPA2_HD int fget(const Args& a, const int32_t* w, int f) {
  return (w[a.f_word[f]] >> a.f_off[f]) &
         (int32_t)((1u << a.f_width[f]) - 1u);
}

HPA2_HD void fput(const Args& a, int32_t* w, int f, int32_t v) {
  w[a.f_word[f]] |= v << a.f_off[f];
}

// wire words (Bound<MAXN>::W of them) of one message, sender field
// left zero; second < -1 means "no second field"; shr, when given, is a
// sharer set: the shr{w} fields in split mode, the aux union otherwise
template <int MAXN>
HPA2_HD void pack(const Args& a, int32_t* w, int type, int addr, int aux,
                  bool has_aux, int second, const int32_t* shr = nullptr) {
  for (int i = 0; i < Bound<MAXN>::W; ++i) w[i] = 0;
  fput(a, w, F_TYPE, type);
  fput(a, w, F_ADDR, addr);
  if (shr != nullptr) {
    if (Bound<MAXN>::SPLIT) {
      for (int j = 0; j < a.SW; ++j) fput(a, w, F_SHR0 + j, shr[j]);
    } else {
      aux = shr[0];
      has_aux = true;
    }
  }
  if (has_aux) fput(a, w, F_AUX, aux);
  if (second >= -1) fput(a, w, F_SECOND, second + 1);
}

// the INV slot's remaining receiver set is nonzero (the OR of the
// shr{w} fields in split mode, the aux union otherwise)
template <int MAXN>
HPA2_HD int inv_pending(const Args& a, const int32_t* w) {
  if (!Bound<MAXN>::SPLIT) return fget(a, w, F_AUX);
  int v = 0;
  for (int j = 0; j < a.SW; ++j) v |= fget(a, w, F_SHR0 + j);
  return v;
}

// the sharer set a message carries (shr{w} fields, or the aux union)
template <int MAXN>
HPA2_HD void msg_sharers(const Args& a, const int32_t* w, int32_t* sv) {
  if (Bound<MAXN>::SPLIT)
    for (int j = 0; j < a.SW; ++j) sv[j] = fget(a, w, F_SHR0 + j);
  else
    sv[0] = fget(a, w, F_AUX);
}

// decoded trace-window length of node i for window seg
HPA2_HD int window_len(const Args& a, int l, int i, int seg) {
  int t = HPA2_AT(a.tr_len, i) - seg * a.window;
  return t < 0 ? 0 : (t > a.window ? a.window : t);
}

// validity of the five deferred outbox slots of node i
template <int MAXN, int KW = Bound<MAXN>::W>
HPA2_HD int deferred(const Args& a, int l, int i, int32_t obw[kNSlots][KW],
                     bool dv[kNSlots]) {
  int cnt = 0;
  for (int k = 0; k < kNSlots; ++k) {
    for (int w = 0; w < KW; ++w)
      obw[k][w] = w < a.W ? HPA2_AT(a.ob[w], i * kNSlots + k) : 0;
    int v;
    if (k == 2)
      v = inv_pending<MAXN>(a, obw[k]);
    else if (a.recv_packed)
      v = fget(a, obw[k], F_RECV);
    else
      v = HPA2_AT(a.ob_recv, i * kNSlots + k) + 1;
    dv[k] = v != 0;
    cnt += dv[k];
  }
  return cnt;
}

// outstanding work of lane l: instructions left in the window, waiting
// nodes, queued messages and deferred slots
template <int MAXN>
HPA2_HD int lane_active(const Args& a, int l, int seg) {
  constexpr int KW = Bound<MAXN>::W;
  int act = 0;
  for (int i = 0; i < a.n; ++i) {
    int32_t nswv = HPA2_AT(a.nsw, i);
    int pc = (nswv >> a.off_pc) & a.pc_mask;
    int left = window_len(a, l, i, seg) - pc;
    act += (left > 0 ? left : 0) + ((nswv >> a.off_wait) & 1) +
           (nswv & a.count_mask);
    int32_t obw[kNSlots][KW];
    bool dv[kNSlots];
    act += deferred<MAXN>(a, l, i, obw, dv);
  }
  return act;
}

template <int KW>
struct Slot {
  int recv;
  int32_t w[KW];
};

template <int KW>
HPA2_HD void put(Slot<KW>& s, int recv, const int32_t* w) {
  s.recv = recv;
  for (int i = 0; i < KW; ++i) s.w[i] = w[i];
}

// one cycle of lane l in trace window seg (PACKED: the cache and
// directory words live in narrow planes)
template <int MAXN, bool PACKED>
HPA2_HD void run_cycle(const Args& a, const int l, const int seg) {
  constexpr int KW = Bound<MAXN>::W, KSW = Bound<MAXN>::SW;
  constexpr bool SPLIT = Bound<MAXN>::SPLIT;
  const int n = a.n, c = a.c, m = a.m, cap = a.cap, W = a.W;
  const int SW = SPLIT ? a.SW : 1;
  const int32_t sh_mask = (int32_t)((1u << (n < kSplitBpw ? n : kSplitBpw)) - 1u);

  Slot<KW> slot[MAXN][kNSlots];
  int32_t inv_sh[MAXN][KSW];
  int count2[MAXN], waiting[MAXN], pending[MAXN], pcv[MAXN], tl[MAXN];

  int lane_act = 0, n_instr = 0, n_rh = 0, n_rm = 0, n_wh = 0, n_wm = 0;
  int n_ev = 0, n_inv = 0;
  int32_t tmp[KW];

  for (int i = 0; i < n; ++i) {
    const int32_t nswv = HPA2_AT(a.nsw, i);
    const int mbc = nswv & a.count_mask;
    const int wt_in = (nswv >> a.off_wait) & 1;
    const int pw = (nswv >> a.off_pw) & 0xFF;
    const int pc = (nswv >> a.off_pc) & a.pc_mask;
    tl[i] = window_len(a, l, i, seg);
    int32_t obw[kNSlots][KW];
    bool dv[kNSlots];
    const int ndv = deferred<MAXN>(a, l, i, obw, dv);
    const bool blocked = ndv > 0;
    {
      int left = tl[i] - pc;
      lane_act += (left > 0 ? left : 0) + wt_in + mbc + ndv;
    }
    for (int k = 0; k < kNSlots; ++k) {
      slot[i][k].recv = -1;
      for (int w = 0; w < KW; ++w) slot[i][k].w[w] = 0;
    }
    Slot<KW>& sA0 = slot[i][0];
    Slot<KW>& sA1 = slot[i][1];
    Slot<KW>& sB0 = slot[i][3];
    Slot<KW>& sB1 = slot[i][4];

    // ===== phase A: handle the mailbox head ==========================
    const bool has_msg = mbc > 0 && !blocked;
    int32_t head[KW];
    for (int w = 0; w < KW; ++w) head[w] = 0;
    for (int w = 0; w < W; ++w) head[w] = HPA2_AT(a.mb[w], i * cap);
    const int mt = has_msg ? fget(a, head, F_TYPE) : -1;
    const int snd = fget(a, head, F_SENDER);
    const int sr = fget(a, head, F_SECOND) - 1;
    const int ad = fget(a, head, F_ADDR);
    const int aux = fget(a, head, F_AUX);
    const int v = aux & 0xFF;
    if (has_msg) {  // rotate left by one: the head lands in the tail slot
      for (int w = 0; w < W; ++w) {
        int32_t* q = a.mb[w];
        for (int j = 0; j < cap - 1; ++j)
          HPA2_AT(q, i * cap + j) = HPA2_AT(q, i * cap + j + 1);
        HPA2_AT(q, i * cap + cap - 1) = head[w];
      }
    }
    count2[i] = mbc - (has_msg ? 1 : 0);

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
    if (SPLIT)
      for (int w = 0; w < SW; ++w) dsh[w] = HPA2_AT(a.live.dirs[w], i * m + blk);
    else
      dsh[0] = (dw >> kDwShShift) & sh_mask;
    const bool line_match = line_addr == ad;
    const bool line_me = line_state == ST_M || line_state == ST_E;
    const int owner = sv_owner(dsh, SW);
    const bool owner_is_snd = owner == snd;
    int32_t snd_bit[KSW];
    sv_bit(snd_bit, snd, SW);
    const bool du = ds == D_U, dss = ds == D_S, dem = ds == D_EM;

    int nl_addr = line_addr, nl_val = line_val, nl_state = line_state;
    bool upd_line = false, upd_dir = false, mem_write = false;
    int nd_state = ds;
    int32_t nd_sh[KSW], sv[KSW];
    for (int w = 0; w < SW; ++w) nd_sh[w] = dsh[w];
    int mem_val = mem_blk;
    int wt = wt_in;
    int32_t* ish = inv_sh[i];
    for (int w = 0; w < KSW; ++w) ish[w] = 0;
    int inv_addr = 0;
    bool ev = false, inv_applied = false;

    // evict the line (l_addr, l_val, l_state) into slot s
    auto evict = [&](Slot<Bound<MAXN>::W>& s, int l_addr, int l_val,
                     int l_state) -> bool {
      if (l_addr == -1 || l_state == ST_I) return false;
      pack<MAXN>(a, tmp, l_state == ST_M ? EVICT_MODIFIED : EVICT_SHARED, l_addr,
                 l_val, true, -2);
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
          for (int w = 0; w < SW; ++w) {
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
          for (int w = 0; w < SW; ++w)
            sv[w] = ds == D_S ? (dsh[w] & ~snd_bit[w]) : 0;
          pack<MAXN>(a, tmp, REPLY_ID, ad, 0, false, -2, sv);
          put(sA0, snd, tmp);
          upd_dir = true;
          nd_state = D_EM;
          for (int w = 0; w < SW; ++w) nd_sh[w] = snd_bit[w];
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
          sv_bit(self_bit, i, SW);
          msg_sharers<MAXN>(a, head, sv);
          for (int w = 0; w < SW; ++w) ish[w] = sv[w] & ~self_bit[w];
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
            for (int w = 0; w < SW; ++w) sv[w] = dsh[w] & ~snd_bit[w];
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
            for (int w = 0; w < SW; ++w) nd_sh[w] = snd_bit[w];
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
          sv_bit(nd_sh, sr, SW);
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
        if (is_home && sv_test(dsh, snd, SW)) {
          for (int w = 0; w < SW; ++w) sv[w] = dsh[w] & ~snd_bit[w];
          const int cnt = sv_count(sv, SW);
          upd_dir = true;
          for (int w = 0; w < SW; ++w) nd_sh[w] = sv[w];
          if (cnt == 0) nd_state = D_U;
          if (cnt == 1 && ds == D_S) {
            nd_state = D_EM;
            pack<MAXN>(a, tmp, UPGRADE_NOTIFY, ad, 0, false, -2);
            put(sA0, sv_owner(sv, SW), tmp);
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
          if (ds == D_EM && sv_test(dsh, snd, SW)) {
            upd_dir = true;
            nd_state = D_U;
            for (int w = 0; w < SW; ++w) nd_sh[w] = 0;
          }
        }
        break;
      case NACK:
        if (a.nack && is_home) {
          upd_dir = true;
          sv_bit(sv, sr, SW);
          if (aux == 0) {
            nd_state = D_S;
            for (int w = 0; w < SW; ++w) nd_sh[w] |= sv[w];
            pack<MAXN>(a, tmp, REPLY_RD, ad, mem_blk, true, -2);
          } else {
            nd_state = D_EM;
            for (int w = 0; w < SW; ++w) nd_sh[w] = sv[w];
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
      for (int w = 0; w < SW; ++w) HPA2_AT(a.live.dirs[w], i * m + blk) = nd_sh[w];

    // ===== phase B: instruction issue ================================
    const bool elig = count2[i] == 0 && wt == 0 && !blocked && pc < tl[i];
    const int pcc = pc < a.window - 1 ? pc : a.window - 1;
    const int32_t wi =
        HPA2_AT(a.tr, i * a.t_pad + seg * a.window + pcc);
    const int op = wi & 1, iv = (wi >> 1) & 0xFF, ia = wi >> kTrAddrShift;
    const int ci2 = ia % c, home2 = ia / m;
    const int32_t cw2 = cw_ld<PACKED>(a, a.live, l, i * c + ci2);
    const int l2_state = cw2 & 3;
    const int l2_val = (cw2 >> kCwValShift) & 0xFF;
    const int l2_addr = ((cw2 >> kCwAddrShift) & kAddrMask) - 1;
    const bool hit = l2_addr == ia && l2_state != ST_I;
    const bool is_rd = elig && op == 0, is_wr = elig && op == 1;
    const bool rm = is_rd && !hit, wm = is_wr && !hit;
    bool ev_issue = false;
    if (rm || wm) ev_issue = evict(sB0, l2_addr, l2_val, l2_state);
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
    pending[i] = is_wr ? iv : pw;
    if (rm || wm || wh_s) wt = 1;
    if (rm || wm || wh_me || wh_s) {
      const int n2_addr = (rm || wm) ? ia : l2_addr;
      const int n2_val = (rm || wm) ? 0 : iv;
      const int n2_state = (rm || wm) ? ST_I : ST_M;
      cw_st<PACKED>(a, a.live, l, i * c + ci2,
            n2_state | (n2_val << kCwValShift) | ((n2_addr + 1) << kCwAddrShift));
    }
    pcv[i] = pc + (elig ? 1 : 0);
    waiting[i] = wt;

    n_instr += elig;
    n_rh += is_rd && hit;
    n_rm += rm;
    n_wh += is_wr && hit;
    n_wm += wm;
    n_ev += ev || ev_issue;
    n_inv += inv_applied;

    // deferred sends merge back as already-packed words (a blocked node
    // made no fresh sends above)
    for (int k = 0; k < kNSlots; ++k) {
      if (k == 2 || !dv[k]) continue;
      const int r = a.recv_packed ? fget(a, obw[k], F_RECV) - 1
                                  : HPA2_AT(a.ob_recv, i * kNSlots + k);
      put(slot[i][k], r, obw[k]);
    }
    if (dv[2]) {
      msg_sharers<MAXN>(a, obw[2], ish);
      inv_addr = fget(a, obw[2], F_ADDR);
    }
    pack<MAXN>(a, slot[i][2].w, INV, inv_addr, 0, false, -2);
    // the sender field is the node's own id
    for (int k = 0; k < kNSlots; ++k)
      slot[i][k].w[a.f_word[F_SENDER]] |= i << a.f_off[F_SENDER];
  }

  // ===== phase C: deterministic delivery ===========================
  int acc[MAXN];
  int dcnt[MAXN][kNSlots];
  int32_t inv_acc[MAXN][KSW];  // accepted INV receivers, as sharer words
  for (int i = 0; i < n; ++i) {
    acc[i] = 0;
    for (int w = 0; w < KSW; ++w) inv_acc[i][w] = 0;
    for (int k = 0; k < kNSlots; ++k) dcnt[i][k] = 0;
  }
  // accept word w for receiver r if its queue has space
  auto enqueue = [&](int r, const int32_t* w) -> bool {
    const int pos = count2[r] + acc[r];
    if (pos >= cap) return false;
    for (int j = 0; j < W; ++j) HPA2_AT(a.mb[j], r * cap + pos) = w[j];
    ++acc[r];
    return true;
  };
  // a sender's three phase-A slots are receiver-disjoint and deliver
  // as one candidate: the word is a per-receiver select
  for (int s = 0; s < n; ++s) {
    for (int r = 0; r < n; ++r) {
      const bool vA0 = r == slot[s][0].recv;
      const bool vA1 = r == slot[s][1].recv;
      const bool vInv = sv_test(inv_sh[s], r, SW);
      if (!(vA0 || vA1 || vInv)) continue;
      const int32_t* w = vA1 ? slot[s][1].w : (vInv ? slot[s][2].w : slot[s][0].w);
      if (!enqueue(r, w)) continue;
      dcnt[s][0] += vA0;
      dcnt[s][1] += vA1;
      if (vInv) {
        ++dcnt[s][2];
        inv_acc[s][r / kSplitBpw] |= (int32_t)(1u << (r % kSplitBpw));
      }
    }
  }
  for (int s = 0; s < n; ++s) {
    for (int k = 3; k < kNSlots; ++k) {
      const int r = slot[s][k].recv;
      if (r >= 0 && r < n && enqueue(r, slot[s][k].w)) ++dcnt[s][k];
    }
  }

  int md = 0, ov = 0;
  int mc[kNTypes];
  for (int t = 0; t < kNTypes; ++t) mc[t] = 0;
  const int recv_w = a.f_word[F_RECV], recv_off = a.f_off[F_RECV];
  // the fields of the INV remainder: shr{w} in split mode, else aux
  const int rem_f0 = SPLIT ? F_SHR0 : F_AUX;
  for (int s = 0; s < n; ++s) {
    int32_t remaining[KSW];
    int32_t rem_any = 0;
    for (int w = 0; w < SW; ++w) {
      remaining[w] = inv_sh[s][w] & ~inv_acc[s][w];
      rem_any |= remaining[w];
    }
    bool blocked_next = false;
    for (int k = 0; k < kNSlots; ++k) {
      const Slot<KW>& sl = slot[s][k];
      md += dcnt[s][k];
      const int t = fget(a, sl.w, F_TYPE);
      if (t < kNTypes) mc[t] += dcnt[s][k];
      const bool defer =
          k == 2 ? rem_any != 0 : (dcnt[s][k] == 0 && sl.recv >= 0);
      blocked_next = blocked_next || defer;
      for (int w = 0; w < W; ++w) {
        int32_t x = sl.w[w];
        if (k == 2)
          for (int j = 0; j < SW; ++j)
            if (w == a.f_word[rem_f0 + j]) x |= remaining[j] << a.f_off[rem_f0 + j];
        if (a.recv_packed && w == recv_w) x |= (sl.recv + 1) << recv_off;
        HPA2_AT(a.ob[w], s * kNSlots + k) = defer ? x : 0;
      }
      if (!a.recv_packed)
        HPA2_AT(a.ob_recv, s * kNSlots + k) = defer ? sl.recv : -1;
    }
    const int mbc3 = count2[s] + acc[s];
    ov = ov || mbc3 > cap;
    HPA2_AT(a.nsw, s) = mbc3 | (waiting[s] << a.off_wait) |
                        (pending[s] << a.off_pw) | (pcv[s] << a.off_pc);

    // ===== phase D: dump-at-local-completion snapshots ===============
    if (a.snapshots) {
      const bool done = pcv[s] >= tl[s] && waiting[s] == 0 && mbc3 == 0 &&
                        !blocked_next;
      const bool taken = HPA2_AT(a.snap_taken, s) != 0;
      if (done && !taken) copy_rows<MAXN, PACKED>(a, l, s * c, (s + 1) * c, s * m, (s + 1) * m);
      HPA2_AT(a.snap_taken, s) = (taken || done) ? 1 : 0;
    }
  }

  // ===== counters ==================================================
  // a lane accrues a cycle only while it had work at cycle start
  HPA2_AT(a.scalars, SC_CYCLE) += lane_act > 0 ? 1 : 0;
  HPA2_AT(a.scalars, SC_INSTR) += n_instr;
  HPA2_AT(a.scalars, SC_MSGS) += md;
  if (ov && HPA2_AT(a.scalars, SC_OVERFLOW) < 1)
    HPA2_AT(a.scalars, SC_OVERFLOW) = 1;
  HPA2_AT(a.scalars, SC_RH) += n_rh;
  HPA2_AT(a.scalars, SC_RM) += n_rm;
  HPA2_AT(a.scalars, SC_WH) += n_wh;
  HPA2_AT(a.scalars, SC_WM) += n_wm;
  HPA2_AT(a.scalars, SC_EV) += n_ev;
  HPA2_AT(a.scalars, SC_INV) += n_inv;
  for (int t = 0; t < kNTypes; ++t) HPA2_AT(a.msg_counts, t) += mc[t];
}

// The streamed run of lanes [l0, l1) of one lane block.  On the card
// each thread passes its own lane; the host build passes the whole
// block.  Decisions are taken per block, so every thread of a block
// follows the same control flow through the block_any reductions.
template <int MAXN, bool PACKED>
HPA2_HD void stream_lanes(const Args& a, const int l0, const int l1) {
  // a call is ceil(k/8) gated bursts of 8 cycles, or one burst of k
  // cycles without the gate
  const int bursts = a.gate ? (a.k + kGate - 1) / kGate : 1;
  const int burst_len = a.gate ? kGate : a.k;
  int calls = 0, stalled = 0;
  for (int seg = 0; seg < a.n_seg; ++seg) {
    // window base: every lane is quiescent, so pc restarts at 0
    for (int l = l0; l < l1; ++l)
      for (int i = 0; i < a.n; ++i)
        HPA2_AT(a.nsw, i) &= ~(a.pc_mask << a.off_pc);
    while (true) {
      int act = 0;
      for (int l = l0; l < l1; ++l) act |= lane_active<MAXN>(a, l, seg) != 0;
      // the call budget carries across windows
      if (!block_any(act) || calls >= a.max_calls) break;
      for (int g = 0; g < bursts; ++g) {
        if (g > 0) {  // gate 0 opens: the loop test just found work
          int open = 0;
          for (int l = l0; l < l1; ++l) open |= lane_active<MAXN>(a, l, seg) != 0;
          if (!block_any(open)) break;  // a closed gate stays closed
        }
        for (int j = 0; j < burst_len; ++j)
          for (int l = l0; l < l1; ++l) run_cycle<MAXN, PACKED>(a, l, seg);
      }
      ++calls;
    }
    int act = 0;
    for (int l = l0; l < l1; ++l) act |= lane_active<MAXN>(a, l, seg) != 0;
    stalled |= block_any(act);
  }
  for (int l = l0; l < l1; ++l) HPA2_AT(a.status, 0) = stalled;
}

// One call of the per-call kernel on lanes [l0, l1) of one lane block:
// up to k cycles in trace window a.seg, read in place from the whole
// [N, t_pad, B] trace plane.  With the gate, each of the ceil(k/8)
// bursts of 8 cycles runs only while the block has work (burst 0 is
// gated too: unlike the streamed run, the call does not know that the
// block is busy); without it, k cycles run straight.  The host loop
// (ops/call_run.py:run_windows) clears pc at window bases and decides,
// from the whole ensemble, whether another call is needed.
template <int MAXN, bool PACKED>
HPA2_HD void call_lanes(const Args& a, const int l0, const int l1) {
  const int seg = a.seg;
  if (!a.gate) {
    for (int j = 0; j < a.k; ++j)
      for (int l = l0; l < l1; ++l) run_cycle<MAXN, PACKED>(a, l, seg);
    return;
  }
  const int bursts = (a.k + kGate - 1) / kGate;
  for (int g = 0; g < bursts; ++g) {
    int act = 0;
    for (int l = l0; l < l1; ++l) act |= lane_active<MAXN>(a, l, seg) != 0;
    if (!block_any(act)) break;  // a quiescent block stays quiescent
    for (int j = 0; j < kGate; ++j)
      for (int l = l0; l < l1; ++l) run_cycle<MAXN, PACKED>(a, l, seg);
  }
}

}  // namespace hpa2
