// The per-lane bodies of the five op-pattern micro-kernels
// (micro_kernels.cu), as __host__ __device__ code so that g++ builds
// the same logic for the CPU tests.
//
// Each body is one iteration of one pattern of scripts/micro_kernels.py
// for one lane, over planes kept lane-last in device memory exactly as
// csrc/cycle.cuh keeps its state: element (row, lane) of a plane
// [R..., lanes] sits at row * lanes + lane.  An iteration reads the
// planes it uses and writes back the planes it changes, as a cycle of
// the streamed kernel reads and writes its state; per-lane temporaries
// stay in registers (every array below is indexed by compile-time
// constants once its loops are unrolled).  Sums that can overflow are
// taken in uint32_t and reinterpreted, which is the int32 wraparound of
// the JAX bodies without C++'s undefined signed overflow.
#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define MICRO_HD __host__ __device__ __forceinline__
#define MICRO_UNROLL _Pragma("unroll")
#else
#define MICRO_HD inline
#define MICRO_UNROLL
#endif

namespace micro {

// the script's shapes (scripts/micro_kernels.py:28-30)
constexpr int N = 8, CAP = 16, M = 16, J = 40;
constexpr int kReads = 6, kWrites = 3, kRowSteps = 100;
static_assert(N == 8, "deliver40 picks its receiver with & 7");

enum Pattern { EMPTY = 0, SCALAR_GATE, DELIVER40, RW_9X, ROWOPS300,
               kNPatterns };

// The planes of one launch; a pattern reads only the planes it names.
// Mirrored by hpa2_tpu_torch/scripts/micro_kernels.py:micro_run.
struct Planes {
  int32_t* mb;    // [N, CAP, lanes]
  int32_t* mem;   // [N, M, lanes]
  int32_t* rows;  // [N, lanes]
  int32_t* cnt;   // [N, lanes]
  int lanes;
};

// The compiler must assume x changed here, so the code that made x and
// the code that uses it are both kept.
MICRO_HD void opaque(uint32_t& x) { asm volatile("" : "+r"(x)); }

// empty: identity.  Each carry word is loaded and stored once, through
// an opaque register so neither access is dropped, and the K-iteration
// loop runs with only a compiler barrier in its body.  The carry is
// 264 words a lane, more than a thread's 255 registers, so it is not
// held across the loop.
MICRO_HD void pass_through(int32_t* plane, int rows, int lanes, int lane) {
  for (int i = 0; i < rows; ++i) {
    uint32_t v = (uint32_t)plane[i * lanes + lane];
    opaque(v);
    plane[i * lanes + lane] = (int32_t)v;
  }
}

MICRO_HD void empty_lane(const Planes& p, int lane, int iters) {
  for (int k = 0; k < iters; ++k) asm volatile("" ::: "memory");
  pass_through(p.mb, N * CAP, p.lanes, lane);
  pass_through(p.mem, N * M, p.lanes, lane);
  pass_through(p.rows, N, p.lanes, lane);
}

// scalar_gate: this lane's share of the block's active count, the sum of
// its rows and cnt (scripts/micro_kernels.py:93-96).  The caller sums it
// over the block and leaves the loop when the sum is 0; both branches of
// the JAX body's cond return the planes unchanged.
MICRO_HD uint32_t gate_lane(const Planes& p, int lane) {
  uint32_t s = 0;
  MICRO_UNROLL
  for (int n = 0; n < N; ++n)
    s += (uint32_t)p.rows[n * p.lanes + lane] +
         (uint32_t)p.cnt[n * p.lanes + lane];
  return s;
}

// deliver40: one iteration of phase C's mailbox write, 40 candidates
// (scripts/micro_kernels.py:101-117).  Candidate j from row j % 8 goes
// to receiver (r + j) & 7 when bit j & 3 of row (j + 1) % 8 is set and
// the receiver's count plus this iteration's accepted is under CAP.
// acc is indexed by a per-lane receiver; an unrolled compare over the 8
// receivers keeps it in registers.  A position below 0 (a negative
// count) is accepted and stores nothing, as the JAX one-hot does.
MICRO_HD void deliver_iter(const Planes& p, int lane) {
  const int L = p.lanes;
  int32_t rows[N], cnt[N], acc[N];
  MICRO_UNROLL
  for (int n = 0; n < N; ++n) {
    rows[n] = p.rows[n * L + lane];
    cnt[n] = p.cnt[n * L + lane];
    acc[n] = 0;
  }
  MICRO_UNROLL
  for (int j = 0; j < J; ++j) {
    const uint32_t r = (uint32_t)rows[j % N];
    const int recv = (int)((r + (uint32_t)j) & 7u);
    if (((rows[(j + 1) % N] >> (j & 3)) & 1) == 0) continue;
    int32_t c = 0, a = 0;
    MICRO_UNROLL
    for (int n = 0; n < N; ++n)
      if (n == recv) {
        c = cnt[n];
        a = acc[n];
      }
    const int32_t pos = (int32_t)((uint32_t)c + (uint32_t)a);
    if (pos >= CAP) continue;
    if (pos >= 0)
      p.mb[(recv * CAP + pos) * L + lane] = (int32_t)(r * 3u + (uint32_t)j);
    MICRO_UNROLL
    for (int n = 0; n < N; ++n) acc[n] += n == recv;
  }
  MICRO_UNROLL
  for (int n = 0; n < N; ++n)
    p.cnt[n * L + lane] = (int32_t)((uint32_t)cnt[n] + (uint32_t)acc[n]);
}

// rw_9x: one iteration of six one-hot reads and three one-hot writes per
// node (scripts/micro_kernels.py:122-136): out = row + the six words of
// mem[n] from (row + r) & 15, all read before any write; when out is
// even, out is written to mem[n] at (out + w) & 15; row = out & 127.
MICRO_HD void rw_iter(const Planes& p, int lane) {
  const int L = p.lanes;
  MICRO_UNROLL
  for (int n = 0; n < N; ++n) {
    int32_t* mem = p.mem + n * M * L + lane;
    const uint32_t row = (uint32_t)p.rows[n * L + lane];
    uint32_t out = row;
    MICRO_UNROLL
    for (int r = 0; r < kReads; ++r)
      out += (uint32_t)mem[((row + (uint32_t)r) & (M - 1)) * L];
    if ((out & 1u) == 0) {
      MICRO_UNROLL
      for (int w = 0; w < kWrites; ++w)
        mem[((out + (uint32_t)w) & (M - 1)) * L] = (int32_t)out;
    }
    p.rows[n * L + lane] = (int32_t)(out & 127u);
  }
}

// rowops300: one iteration of 100 dependent row steps per node
// (scripts/micro_kernels.py:141-148): y += x where x & 3 == p & 3, then
// x = (x * 5 + 1) & 1023.
MICRO_HD void rowops_iter(const Planes& p, int lane) {
  const int L = p.lanes;
  MICRO_UNROLL
  for (int n = 0; n < N; ++n) {
    uint32_t x = (uint32_t)p.rows[n * L + lane];
    uint32_t y = (uint32_t)p.cnt[n * L + lane];
    MICRO_UNROLL
    for (int s = 0; s < kRowSteps; ++s) {
      if ((x & 3u) == (uint32_t)(s & 3)) y += x;
      x = (x * 5u + 1u) & 1023u;
    }
    p.rows[n * L + lane] = (int32_t)x;
    p.cnt[n * L + lane] = (int32_t)y;
  }
}

// `iters` iterations of pattern P on one lane; every pattern but
// scalar_gate, whose loop needs the block's sum (micro_kernels.cu).
template <int P>
MICRO_HD void run_lane(const Planes& p, int lane, int iters) {
  static_assert(P != SCALAR_GATE, "scalar_gate reduces over the block");
  if (P == EMPTY)
    empty_lane(p, lane, iters);
  else
    for (int k = 0; k < iters; ++k) {
      if (P == DELIVER40)
        deliver_iter(p, lane);
      else if (P == RW_9X)
        rw_iter(p, lane);
      else
        rowops_iter(p, lane);
    }
}

}  // namespace micro
