// The per-call kernel: one launch advances every lane block by up to k
// cycles (gated every 8) in one trace window, one CTA per lane block
// and one thread per simulated system.  The host loop
// (hpa2_tpu_torch/ops/call_run.py:run_windows) launches it until the
// whole ensemble is quiescent, window by window.
//
// Replaces: hpa2_tpu/ops/pallas_engine.py:_build_call.kernel (the TPU
// kernel of stream=False, with build_cycle as its body; _make_run is
// the loop around it).  The cycle and the call loop live in cycle.cuh
// (call_lanes); what bounds the cycle is noted there.  Beyond the
// streamed kernel's costs, each call is one launch and one host read of
// the ensemble's quiescence, and the window barrier is global: every
// lane waits for the slowest block of the ensemble before pc restarts.
// The window is read in place from the whole trace plane, so no window
// is copied.
//
// Plain C interface, bound with ctypes by hpa2_tpu_torch/ops/kernels.py.
// The entry allocates nothing and does not synchronise: it launches on
// the caller's stream and returns cudaGetLastError().  Instantiated for
// node bounds 8, 21 and 64, each with int32 or packed planes.
#include <cuda_runtime.h>

#include "cycle.cuh"

namespace {

template <int MAXN, bool PACKED>
__global__ void __launch_bounds__(hpa2::kMaxBlock)
    call_run_kernel(const hpa2::Args a) {
  const int l = blockIdx.x * a.bb + threadIdx.x;
  hpa2::call_lanes<MAXN, PACKED>(a, l, l + 1);
}

template <int MAXN>
void launch(const hpa2::Args& a, cudaStream_t s) {
  const dim3 grid(a.b / a.bb), block(a.bb);
  if (a.packed)
    call_run_kernel<MAXN, true><<<grid, block, 0, s>>>(a);
  else
    call_run_kernel<MAXN, false><<<grid, block, 0, s>>>(a);
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
  if (bound == 8)
    launch<8>(a, s);
  else if (bound == 21)
    launch<21>(a, s);
  else
    launch<hpa2::kMaxNodes>(a, s);
  return (int)cudaGetLastError();
}
