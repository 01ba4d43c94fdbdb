// The streamed run kernel: one launch drives a whole run of the
// ensemble (trace windows x while-to-quiescence x gated 8-cycle
// bursts), one CTA per lane block and one thread per simulated system.
//
// Replaces: hpa2_tpu/ops/pallas_engine.py:_make_stream_run.kernel (the
// TPU kernel, with hpa2_tpu/ops/pallas_engine.py:build_cycle as its
// cycle body).  The cycle and the run loop live in cycle.cuh; see the
// note there on what bounds this kernel and how its design answers.
//
// Plain C interface, bound with ctypes by hpa2_tpu_torch/ops/kernels.py.
// The entry allocates nothing and does not synchronise: it launches on
// the caller's stream and returns cudaGetLastError().  The kernel is
// instantiated for node bounds 8, 21 and 64 (the local frame grows with
// the bound; split mode is the bound's), each with int32 or packed
// cache and directory planes; wider systems are refused.
#include <cuda_runtime.h>

#include "cycle.cuh"

namespace {

template <int MAXN, bool PACKED>
__global__ void __launch_bounds__(hpa2::kMaxBlock)
    stream_run_kernel(const hpa2::Args a) {
  const int l = blockIdx.x * a.bb + threadIdx.x;
  hpa2::stream_lanes<MAXN, PACKED>(a, l, l + 1);
}

template <int MAXN>
void launch(const hpa2::Args& a, cudaStream_t s) {
  const dim3 grid(a.b / a.bb), block(a.bb);
  if (a.packed)
    stream_run_kernel<MAXN, true><<<grid, block, 0, s>>>(a);
  else
    stream_run_kernel<MAXN, false><<<grid, block, 0, s>>>(a);
}

}  // namespace

// sizeof(Args), checked against the ctypes mirror at load
extern "C" int hpa2_args_size() { return (int)sizeof(hpa2::Args); }

extern "C" int hpa2_stream_run(const hpa2::Args* args, int device,
                               void* stream) {
  const hpa2::Args& a = *args;
  const int bound = hpa2::node_bound(a);
  if (bound == 0) return (int)cudaErrorInvalidValue;
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
