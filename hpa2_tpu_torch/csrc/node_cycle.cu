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
// each with int32 or packed planes; N2 and N3 are one kernel each, their
// geometry and shared tile sized at launch (bucket_plan, deliver_plan).
// A wider system, more than kMaxShards shards or a geometry the kernels
// do not take (a shared tile over kNodeSmem) is refused.
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

// N2: its four phases over the CTA's shared tile
__global__ void __launch_bounds__(hpa2::kNodeCta)
    node_bucket_kernel(const __grid_constant__ BucketArgs x,
                       const __grid_constant__ hpa2::BucketPlan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* sh = reinterpret_cast<uint32_t*>(smem);
#pragma unroll
  for (int ph = 0; ph < hpa2::kN2Phases; ++ph) {
    hpa2::n2_phase(x, pl, ph, blockIdx.x, threadIdx.x, sh);
    __syncthreads();
  }
}

// N3: its five phases over the CTA's shared tile
__global__ void __launch_bounds__(hpa2::kNodeCta)
    node_deliver_kernel(const __grid_constant__ NodeArgs x,
                        const __grid_constant__ hpa2::DeliverPlan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
#pragma unroll
  for (int ph = 0; ph < hpa2::kN3Phases; ++ph) {
    hpa2::n3_phase(x, pl, ph, blockIdx.x, threadIdx.x, smem);
    __syncthreads();
  }
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

// a kernel's shared tile above the default 48 KB needs the opt-in
template <class K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, hpa2::kNodeSmem);
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
HPA2_NODE_ENTRY(hpa2_node_settle, launch_settle)

extern "C" int hpa2_node_deliver(const NodeArgs* args, int device,
                                 void* stream) {
  const NodeArgs& x = *args;
  hpa2::DeliverPlan pl;
  if (bound_of(x) == 0 || !hpa2::deliver_plan(x, pl, hpa2::kNodeSmem))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(node_deliver_kernel);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((x.a.b + pl.G - 1) / pl.G));
  node_deliver_kernel<<<grid, hpa2::kNodeCta, pl.smem,
                        (cudaStream_t)stream>>>(x, pl);
  return (int)cudaGetLastError();
}

extern "C" int hpa2_node_bucket(const BucketArgs* args, int device,
                                void* stream) {
  const BucketArgs& x = *args;
  hpa2::BucketPlan pl;
  if (!hpa2::bucket_plan(x, pl, hpa2::kNodeSmem))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(node_bucket_kernel);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)((x.b + pl.G - 1) / pl.G));
  node_bucket_kernel<<<grid, hpa2::kNodeCta, pl.smem,
                       (cudaStream_t)stream>>>(x, pl);
  return (int)cudaGetLastError();
}
