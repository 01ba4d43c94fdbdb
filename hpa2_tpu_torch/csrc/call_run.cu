// The per-call kernel: one launch advances every lane block by up to k
// cycles (gated every 8) in one trace window.  The host loop
// (hpa2_tpu_torch/ops/call_run.py:run_windows) launches it until the
// whole ensemble is quiescent, window by window.  A lane block of bb
// systems is one thread-block cluster of up to 16 CTAs, each system
// spread over 2, 8 or 16 threads by its node bound, one per node rank
// (cycle.cuh).
//
// Replaces: hpa2_tpu/ops/pallas_engine.py:_build_call.kernel (the TPU
// kernel of stream=False, with build_cycle as its body; _make_run is
// the loop around it).  The cycle and the call loop live in cycle.cuh
// (call_block); what bounds the cycle is noted there.  The gate of each
// burst, burst 0 included, is the lane block's: an OR over its cluster.
// Beyond the streamed kernel's costs, each call is one launch and one
// host read of the ensemble's quiescence, and the window barrier is
// global: every lane waits for the slowest block of the ensemble before
// pc restarts.  The window is read in place from the whole trace plane,
// so no window is copied.
//
// Plain C interface, bound with ctypes by hpa2_tpu_torch/ops/kernels.py.
// The entry allocates nothing and does not synchronise: it launches on
// the caller's stream and returns the launch's error.  Instantiated for
// node bounds 8, 21 and 64, each with int32 or packed planes.
#include <cuda_runtime.h>

#include "cycle.cuh"

namespace {

template <int MAXN, bool PACKED>
__global__ void __launch_bounds__(hpa2::kMaxCta)
    call_run_kernel(const __grid_constant__ hpa2::Args a) {
  extern __shared__ int4 smem[];
  hpa2::DeviceTeam<MAXN> tm(a, smem);
  hpa2::call_block<MAXN, PACKED>(a, tm);
  tm.finish();
}

template <int MAXN>
cudaError_t launch(const hpa2::Args& a, cudaStream_t s) {
  return hpa2::launch_team<MAXN>(
      a.packed ? call_run_kernel<MAXN, true> : call_run_kernel<MAXN, false>,
      a, s);
}

template <int MAXN>
cudaError_t occupancy(const hpa2::Args& a, int* out) {
  return hpa2::occupancy_team<MAXN>(
      a.packed ? call_run_kernel<MAXN, true> : call_run_kernel<MAXN, false>,
      a, out);
}

}  // namespace

// sizeof(Args), checked against the ctypes mirror at load
extern "C" int hpa2_args_size() { return (int)sizeof(hpa2::Args); }

extern "C" int hpa2_call_run(const hpa2::Args* args, int device,
                             void* stream) {
  const hpa2::Args& a = *args;
  const int bound = hpa2::node_bound(a);
  if (bound == 0 || a.seg < 0 || a.seg >= a.n_seg)
    return (int)cudaErrorInvalidValue;
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
