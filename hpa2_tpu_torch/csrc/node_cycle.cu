// K1's node-sharded cycle as four kernels (node_cycle.cuh): N1 node_ab,
// N2 node_bucket, N3 node_deliver, N4 node_settle.  One rank launches
// them once a cycle each (N2 once a compaction round of its exchange
// schedule) on its own block of the planes, between the NCCL calls of
// ops/exchange.py.
//
// Replaces: the node-sharded variant of hpa2_tpu/ops/pallas_engine.py:
// build_cycle (l.559-575, the exchange branch l.1355-1590), which JAX
// runs as XLA under shard_map.  See node_cycle.cuh for what each kernel
// covers and what bounds it.
//
// Plain C interface, bound with ctypes by hpa2_tpu_torch/ops/kernels.py
// (the library) and hpa2_tpu_torch/ops/node_cycle.py (the entries).  An
// entry allocates nothing and does not synchronise: it launches on the
// caller's stream and returns the launch's error.  N1 and N4 are
// instantiated for node bounds 8, 21 and 64 (split mode is the bound's),
// each with int32 or packed planes; N3 for the three bounds; N2 takes any.
// A wider system, more than kMaxShards shards or a geometry the kernels
// do not take is refused.
#include <cuda_runtime.h>

#include "node_cycle.cuh"

namespace {

using hpa2::NodeArgs;
using hpa2::BucketArgs;

// thread t of lane g in this CTA: tid = t * group + g
struct NodeThread {
  int t, g, l;
  __device__ explicit NodeThread(const NodeArgs& x) {
    t = threadIdx.x / x.group;
    g = threadIdx.x % x.group;
    l = blockIdx.x * x.group + g;
  }
  __device__ bool lane_ok(const NodeArgs& x) const {
    return t < x.tpl && l < x.a.b;
  }
};

template <int MAXN, bool PACKED>
__global__ void __launch_bounds__(hpa2::kNodeCta)
    node_ab_kernel(const __grid_constant__ NodeArgs x) {
  __shared__ uint32_t red[hpa2::kABCount * hpa2::kNodeCta];
  const NodeThread th(x);
  for (int j = threadIdx.x; j < hpa2::kABCount * x.group; j += blockDim.x)
    red[(j / x.group) * hpa2::kNodeCta + j % x.group] = 0;
  __syncthreads();
  if (th.lane_ok(x))
    for (int i = th.t; i < x.nl; i += x.tpl)
      hpa2::n1_node<MAXN, PACKED>(x, th.l, i, &red[th.g], hpa2::kNodeCta);
  __syncthreads();
  if (th.t == 0 && th.l < x.a.b)
    for (int j = 0; j < hpa2::kABCount; ++j)
      x.cnt[(size_t)j * x.a.b + th.l] = (int32_t)red[j * hpa2::kNodeCta + th.g];
}

__global__ void __launch_bounds__(hpa2::kNodeCta)
    node_bucket_kernel(const __grid_constant__ BucketArgs x) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int p = (int)(idx / x.b), l = (int)(idx % x.b);
  if (p < x.ndest)
    hpa2::n2_dest(x, p, l);
  else if (p == x.ndest && x.combine)
    hpa2::n2_combine(x, l);
}

template <int MAXN>
__global__ void __launch_bounds__(hpa2::kNodeCta)
    node_deliver_kernel(const __grid_constant__ NodeArgs x) {
  const NodeThread th(x);
  if (th.lane_ok(x))
    for (int i = th.t; i < x.nl; i += x.tpl) hpa2::n3_node<MAXN>(x, th.l, i);
}

template <int MAXN, bool PACKED>
__global__ void __launch_bounds__(hpa2::kNodeCta)
    node_settle_kernel(const __grid_constant__ NodeArgs x) {
  __shared__ uint32_t red[hpa2::kSettleRed * hpa2::kNodeCta];
  const NodeThread th(x);
  for (int j = threadIdx.x; j < hpa2::kSettleRed * x.group; j += blockDim.x)
    red[(j / x.group) * hpa2::kNodeCta + j % x.group] = 0;
  __syncthreads();
  if (th.lane_ok(x))
    for (int s = th.t; s < x.nl; s += x.tpl)
      hpa2::n4_node<MAXN, PACKED>(x, th.l, s, &red[th.g], hpa2::kNodeCta);
  __syncthreads();
  if (th.t == 0 && th.l < x.a.b)
    hpa2::n4_lane(x, th.l, &red[th.g], hpa2::kNodeCta);
}

dim3 node_grid(const NodeArgs& x) {
  return dim3((x.a.b + x.group - 1) / x.group);
}

template <class K>
cudaError_t go(K kernel, dim3 grid, dim3 block, const NodeArgs& x,
               cudaStream_t s) {
  kernel<<<grid, block, 0, s>>>(x);
  return cudaGetLastError();
}

// the node bound of the launch, or 0 when the kernels do not take it
int bound_of(const NodeArgs& x) {
  if (!hpa2::node_geometry_ok(x)) return 0;
  return hpa2::node_kernel_bound(x.a);
}

template <int MAXN>
cudaError_t launch_ab(const NodeArgs& x, cudaStream_t s) {
  const dim3 block(x.tpl * x.group);
  return x.a.packed ? go(node_ab_kernel<MAXN, true>, node_grid(x), block, x, s)
                    : go(node_ab_kernel<MAXN, false>, node_grid(x), block, x, s);
}

template <int MAXN>
cudaError_t launch_settle(const NodeArgs& x, cudaStream_t s) {
  const dim3 block(x.tpl * x.group);
  return x.a.packed
             ? go(node_settle_kernel<MAXN, true>, node_grid(x), block, x, s)
             : go(node_settle_kernel<MAXN, false>, node_grid(x), block, x, s);
}

template <int MAXN>
cudaError_t launch_deliver(const NodeArgs& x, cudaStream_t s) {
  return go(node_deliver_kernel<MAXN>, node_grid(x), dim3(x.tpl * x.group),
            x, s);
}

#define HPA2_NODE_ENTRY(name, fn)                                        \
  extern "C" int name(const NodeArgs* args, int device, void* stream) {  \
    const NodeArgs& x = *args;                                           \
    const int bound = bound_of(x);                                       \
    if (bound == 0) return (int)cudaErrorInvalidValue;                   \
    cudaError_t err = cudaSetDevice(device);                             \
    if (err != cudaSuccess) return (int)err;                             \
    cudaStream_t s = (cudaStream_t)stream;                               \
    if (bound == 8) return (int)fn<8>(x, s);                             \
    if (bound == 21) return (int)fn<21>(x, s);                           \
    return (int)fn<hpa2::kMaxNodes>(x, s);                               \
  }

}  // namespace

// sizes of the argument blocks, checked against the ctypes mirrors
extern "C" int hpa2_args_size() { return (int)sizeof(hpa2::Args); }
extern "C" int hpa2_node_args_size() { return (int)sizeof(NodeArgs); }
extern "C" int hpa2_bucket_args_size() { return (int)sizeof(BucketArgs); }

HPA2_NODE_ENTRY(hpa2_node_ab, launch_ab)
HPA2_NODE_ENTRY(hpa2_node_deliver, launch_deliver)
HPA2_NODE_ENTRY(hpa2_node_settle, launch_settle)

extern "C" int hpa2_node_bucket(const BucketArgs* args, int device,
                                void* stream) {
  const BucketArgs& x = *args;
  if (x.ndest < 1 || x.ndest > hpa2::kMaxShards || x.b < 1 || x.k < 1 ||
      x.SW < 1 || x.SW > hpa2::kMaxSW || x.nl < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long threads = (long long)(x.ndest + (x.combine ? 1 : 0)) * x.b;
  const dim3 grid((unsigned)((threads + hpa2::kNodeCta - 1) / hpa2::kNodeCta));
  node_bucket_kernel<<<grid, hpa2::kNodeCta, 0, (cudaStream_t)stream>>>(x);
  return (int)cudaGetLastError();
}
