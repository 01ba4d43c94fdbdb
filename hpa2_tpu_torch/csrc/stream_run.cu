// The streamed run kernel: one launch drives a whole run of the
// ensemble (trace windows x while-to-quiescence x gated 8-cycle
// bursts).  A lane block of bb systems is one thread-block cluster of
// up to 16 CTAs; each system is spread over 2, 8 or 16 threads by its
// node bound, one per node rank, so its nodes run phases A, B and D in
// parallel and phase C
// delivers per receiver (cycle.cuh).
//
// Replaces: hpa2_tpu/ops/pallas_engine.py:_make_stream_run.kernel (the
// TPU kernel, with hpa2_tpu/ops/pallas_engine.py:build_cycle as its
// cycle body).  The cycle and the run loop live in cycle.cuh; see the
// note there on what bounds this kernel and how its design answers.
// The run loop's decisions (the gate, the call budget, the window
// advance, the stall flag) are the lane block's, so they are ORs over
// the block's cluster; clusters are co-scheduled by the hardware, so
// none waits on a CTA that is not resident.
//
// Plain C interface, bound with ctypes by hpa2_tpu_torch/ops/kernels.py.
// The entry allocates nothing and does not synchronise: it launches on
// the caller's stream and returns the launch's error.  The kernel is
// instantiated for node bounds 8, 21 and 64 (split mode is the bound's),
// each with int32 or packed cache and directory planes; wider systems
// and geometries the kernel cannot take are refused.
//
// Built again with -DHPA2_ABLATE, the same source gives the
// streamed run's ablation variant (pallas_engine.py:build_cycle(ablate=),
// K1's stubs; cycle.cuh, kAblate*): a library and an entry of its own
// (hpa2_stream_run_ablate), int32 and packed planes at node bounds 8, 21 and
// 64, the stubbed stages picked at run time by Args::ablate.  An ablated run is
// wrong by design and serves timing only
// (hpa2_tpu_torch/scripts/perf_sweep.py).
#include <cuda_runtime.h>

#include "cycle.cuh"

namespace {

#ifndef HPA2_ABLATE
template <int MAXN, bool PACKED>
__global__ void __launch_bounds__(hpa2::kMaxCta)
    stream_run_kernel(const __grid_constant__ hpa2::Args a) {
  extern __shared__ int4 smem[];
  hpa2::DeviceTeam<MAXN> tm(a, smem);
  hpa2::stream_block<MAXN, PACKED>(a, tm);
  tm.finish();
}
#define HPA2_KERNEL stream_run_kernel
#else
// The ablatable instantiations (cycle.cuh, kAblate*): int32 or packed
// planes, the stubs picked at run time by Args::ablate.
template <int MAXN, bool PACKED>
__global__ void __launch_bounds__(hpa2::kMaxCta)
    stream_run_ablate_kernel(const __grid_constant__ hpa2::Args a) {
  extern __shared__ int4 smem[];
  hpa2::DeviceTeam<MAXN> tm(a, smem);
  hpa2::stream_block<MAXN, PACKED, true>(a, tm);
  tm.finish();
}
#define HPA2_KERNEL stream_run_ablate_kernel
#endif

template <int MAXN>
cudaError_t launch(const hpa2::Args& a, cudaStream_t s) {
  return hpa2::launch_team<MAXN>(
      a.packed ? HPA2_KERNEL<MAXN, true> : HPA2_KERNEL<MAXN, false>, a, s);
}

template <int MAXN>
cudaError_t occupancy(const hpa2::Args& a, int* out) {
  return hpa2::occupancy_team<MAXN>(
      a.packed ? HPA2_KERNEL<MAXN, true> : HPA2_KERNEL<MAXN, false>, a, out);
}

}  // namespace

// sizeof(Args), checked against the ctypes mirror at load
extern "C" int hpa2_args_size() { return (int)sizeof(hpa2::Args); }

#ifdef HPA2_ABLATE
#define HPA2_ENTRY hpa2_stream_run_ablate
#else
#define HPA2_ENTRY hpa2_stream_run
#endif

extern "C" int HPA2_ENTRY(const hpa2::Args* args, int device,
                               void* stream) {
  const hpa2::Args& a = *args;
  const int bound = hpa2::node_bound(a);
  if (bound == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (bound == 8) return (int)launch<8>(a, s);
  if (bound == 21) return (int)launch<21>(a, s);
  return (int)launch<hpa2::kMaxNodes>(a, s);
}

// The launch's occupancy on `device` (see occupancy_team): out[4].
extern "C" int hpa2_occupancy(const hpa2::Args* args, int device, int* out) {
  const hpa2::Args& a = *args;
  const int bound = hpa2::node_bound(a);
  if (bound == 0) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (bound == 8) return (int)occupancy<8>(a, out);
  if (bound == 21) return (int)occupancy<21>(a, out);
  return (int)occupancy<hpa2::kMaxNodes>(a, out);
}
