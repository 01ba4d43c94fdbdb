// The five op-pattern micro-kernels: each runs `iters` iterations of one
// pattern of the cycle over lane-last int32 planes, one thread per lane
// and one CTA per block of lanes, so that the time of an iteration says
// what that pattern costs in the form the port's kernels use.
//
// Replaces: scripts/micro_kernels.py:bench (the TPU kernel, with the
// pattern bodies of its main() at :87-148).  The per-lane bodies live in
// micro_kernels.cuh.  The TPU kernel holds a [*, 256] block in VMEM and
// writes each pattern as one-hot [N, CAP, B] / [N, M, B] tensor ops, a
// Mosaic constraint; here the one-hot collapses to scalar code per lane,
// and the planes stay in device memory, updated in place and addressed
// plane[i * lanes + lane] as csrc/cycle.cuh addresses its state, so the
// numbers speak for the streamed kernel's access pattern.
//
// What bounds each pattern on an H100 (3.35 TB/s; 6.7e13 32-bit
// integer ops/s, the float32 rate, a fused op counted as two), at 8,192
// lanes and 256 iterations:
//   empty        bytes: the carry, 264 words a lane, is read and written
//                once (17.3 MB, ~5 us); what it measures is the launch,
//                that load and store, and the loop's overhead.
//   scalar_gate  operations: 16 adds a lane an iteration plus a block
//                reduction (warp __reduce_add_sync, shared memory and
//                one __syncthreads an iteration); its chain of barriers
//                is what a gated loop pays.
//   deliver40    operations: 40 candidates a lane an iteration, each a
//                few integer ops, an 8-way register select and at most
//                one scattered 4-byte store into the mailbox plane.
//   rw_9x        operations: 8 x (6 gathered loads, up to 3 scattered
//                stores, ~20 integer ops) a lane an iteration, each
//                gather a cache round trip that waits on its row's load.
//   rowops300    operations: 8 independent chains of 100 dependent
//                steps (~7 ops each) a lane an iteration.
// None is bound by bytes but empty: the planes are 1-17 MB and stay in
// L1/L2 across iterations.  Each thread runs its lane's chain alone, so
// latency, not either bound, is what the times show; one CTA of 8 warps
// on each of 32 (grid 32) or 128 (grid 128) SMs hides little of it.
// The design adds nothing to the patterns (no shared-memory staging, no
// warp per lane): the point is the cost of the port's own form.
//
// Plain C interface, bound with ctypes by hpa2_tpu_torch/ops/kernels.py
// and driven by hpa2_tpu_torch/scripts/micro_kernels.py:micro_run.  The
// entry allocates nothing and does not synchronise: it launches on the
// caller's stream and returns cudaGetLastError().
#include <cuda_runtime.h>

#include "micro_kernels.cuh"

namespace {

constexpr int kMaxBlock = 1024;

template <int P>
__global__ void __launch_bounds__(kMaxBlock)
    micro_kernel(const micro::Planes p, int iters) {
  micro::run_lane<P>(p, blockIdx.x * blockDim.x + threadIdx.x, iters);
}

// scalar_gate: every iteration the block sums its lanes' rows and cnt
// (warp reduction, then the warps' sums through shared memory) and
// leaves the loop when the sum is 0, as the streamed kernel leaves its
// loop when its gate closes.  The two buffers let one __syncthreads an
// iteration order the writes of iteration k + 2 after the reads of k.
__global__ void __launch_bounds__(kMaxBlock)
    scalar_gate_kernel(const micro::Planes p, int iters) {
  __shared__ uint32_t part[2][kMaxBlock / 32];
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  for (int k = 0; k < iters; ++k) {
    const uint32_t s = __reduce_add_sync(0xffffffffu, micro::gate_lane(p, lane));
    if ((threadIdx.x & 31) == 0) part[k & 1][warp] = s;
    __syncthreads();
    uint32_t active = 0;
    for (int w = 0; w < warps; ++w) active += part[k & 1][w];
    if (active == 0) break;
  }
}

}  // namespace

extern "C" int hpa2_micro_run(int pattern, void* mb, void* mem, void* rows,
                              void* cnt, int lanes, int iters, int block,
                              int device, void* stream) {
  if (pattern < 0 || pattern >= micro::kNPatterns || block < 32 ||
      block > kMaxBlock || block % 32 != 0 || lanes < block ||
      lanes % block != 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const micro::Planes p{(int32_t*)mb, (int32_t*)mem, (int32_t*)rows,
                        (int32_t*)cnt, lanes};
  const dim3 grid(lanes / block), threads(block);
  cudaStream_t s = (cudaStream_t)stream;
  switch (pattern) {
    case micro::EMPTY:
      micro_kernel<micro::EMPTY><<<grid, threads, 0, s>>>(p, iters);
      break;
    case micro::SCALAR_GATE:
      scalar_gate_kernel<<<grid, threads, 0, s>>>(p, iters);
      break;
    case micro::DELIVER40:
      micro_kernel<micro::DELIVER40><<<grid, threads, 0, s>>>(p, iters);
      break;
    case micro::RW_9X:
      micro_kernel<micro::RW_9X><<<grid, threads, 0, s>>>(p, iters);
      break;
    default:
      micro_kernel<micro::ROWOPS300><<<grid, threads, 0, s>>>(p, iters);
  }
  return (int)cudaGetLastError();
}
