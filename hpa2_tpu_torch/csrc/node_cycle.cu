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
// each with int32 or packed planes; N2 and N3 are one kernel each.  Every
// kernel's geometry and shared tile are sized at launch (ab_plan,
// bucket_plan, deliver_plan, settle_plan; hpa2_node_geometry reports
// them).  A wider system runs on the wide family (hpa2_node_*_wide: W
// and SW at run time; N1 and N2 phases over a shared tile, wide_ab_plan
// and wide_bucket_plan; N3 and N4 a thread a work item).  More than
// kMaxShards shards or a geometry the kernels do not take (a shared
// tile over kNodeSmem) is refused.
#include <cuda_runtime.h>

#include "node_cycle.cuh"

namespace {

using hpa2::NodeArgs;
using hpa2::BucketArgs;

// N1: its three phases over the CTA's shared tile; the write phase sums
// the counters over the cluster's tiles, so a cluster barrier comes
// before it, and after it (a tile lives until its cluster has read it).
// One CTA an SM at least: without it ptxas held every instantiation to
// 72-96 registers and spilled 4-76 bytes; with it 96-120, no spill (the
// tile's shared memory, not the registers, sets the CTAs an SM)
template <int MAXN, bool PACKED>
__global__ void __launch_bounds__(hpa2::kAbCta, 1)
    node_ab_kernel(const __grid_constant__ NodeArgs x,
                   const __grid_constant__ hpa2::NodePlan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* sh = reinterpret_cast<int32_t*>(smem);
#pragma unroll
  for (int ph = 0; ph < hpa2::kN1Phases; ++ph) {
    hpa2::n1_phase<MAXN, PACKED>(x, pl, ph, blockIdx.x, threadIdx.x, sh);
    if (ph == 0)
      __syncthreads();
    else
      cooperative_groups::this_cluster().sync();
  }
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

// N4: its three phases over the CTA's shared tile
template <int MAXN, bool PACKED>
__global__ void __launch_bounds__(hpa2::kNodeCta)
    node_settle_kernel(const __grid_constant__ NodeArgs x,
                       const __grid_constant__ hpa2::NodePlan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* sh = reinterpret_cast<int32_t*>(smem);
#pragma unroll
  for (int ph = 0; ph < hpa2::kN4Phases; ++ph) {
    hpa2::n4_phase<MAXN, PACKED>(x, pl, ph, blockIdx.x, threadIdx.x, sh);
    __syncthreads();
  }
}

// The wide family (node_cycle.cuh, above kMaxNodes nodes).  N1: its five
// phases over the CTA's shared tile, a warp a pair in the protocol phase;
// two CTAs an SM (the tile is planned for two)
__global__ void __launch_bounds__(hpa2::kWideAbCta, 2)
    node_ab_wide_kernel(const __grid_constant__ hpa2::WideArgs y,
                        const __grid_constant__ hpa2::WideAbPlan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* sh = reinterpret_cast<int32_t*>(smem);
#pragma unroll
  for (int ph = 0; ph < hpa2::kN1wPhases; ++ph) {
    hpa2::n1w_phase(y, pl, ph, blockIdx.x, threadIdx.x, sh);
    __syncthreads();
  }
}

// N2: flags (three phases), then place (steps + 3 phases: the scan's
// steps are the plan's)
__global__ void __launch_bounds__(hpa2::kWideBucketCta)
    node_bucket_wide_flags_kernel(
        const __grid_constant__ hpa2::WideBucketArgs y,
        const __grid_constant__ hpa2::WideBucketPlan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* sh = reinterpret_cast<uint32_t*>(smem);
#pragma unroll
  for (int ph = 0; ph < hpa2::kN2wFlagPhases; ++ph) {
    hpa2::n2w_flags_phase(y, pl, ph, blockIdx.x, threadIdx.x, sh);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(hpa2::kWideBucketCta)
    node_bucket_wide_place_kernel(
        const __grid_constant__ hpa2::WideBucketArgs y,
        const __grid_constant__ hpa2::WideBucketPlan pl) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* sh = reinterpret_cast<uint32_t*>(smem);
  for (int ph = 0; ph < pl.steps + 3; ++ph) {
    hpa2::n2w_place_phase(y, pl, ph, blockIdx.x, threadIdx.x, sh);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(hpa2::kWideCta)
    node_deliver_wide_sets_kernel(const __grid_constant__ hpa2::WideArgs y,
                                  const __grid_constant__ hpa2::DeliverPlan pl) {
  hpa2::w3_sets(y, pl, (size_t)blockIdx.x * blockDim.x + threadIdx.x);
}

__global__ void __launch_bounds__(hpa2::kWideCta)
    node_deliver_wide_take_kernel(const __grid_constant__ hpa2::WideArgs y,
                                  const __grid_constant__ hpa2::DeliverPlan pl) {
  hpa2::w3_take(y, pl, (size_t)blockIdx.x * blockDim.x + threadIdx.x);
}

__global__ void __launch_bounds__(hpa2::kWideCta)
    node_settle_wide_kernel(const __grid_constant__ hpa2::WideArgs y) {
  hpa2::w4_item(y, (size_t)blockIdx.x * blockDim.x + threadIdx.x);
}

__global__ void __launch_bounds__(hpa2::kWideCta)
    node_settle_wide_lane_kernel(const __grid_constant__ hpa2::WideArgs y) {
  hpa2::w4_lane(y, (size_t)blockIdx.x * blockDim.x + threadIdx.x);
}

// CTAs of kWideCta threads that cover `items` work items
unsigned wide_grid(size_t items) {
  return (unsigned)((items + hpa2::kWideCta - 1) / hpa2::kWideCta);
}

// a wide kernel's launch over `items` items on the caller's stream (none
// when there are none)
template <class... P, class... A>
cudaError_t wide_launch(void (*kernel)(P...), size_t items, void* stream,
                        const A&... args) {
  if (items == 0) return cudaSuccess;
  kernel<<<wide_grid(items), hpa2::kWideCta, 0, (cudaStream_t)stream>>>(
      args...);
  return cudaGetLastError();
}

// the work items of the wide family's main launch of kernel `which` (6
// N3's sets, 7 N4's settle), 0 when it refuses
size_t wide_items(int which, const void* args) {
  const auto& y = *static_cast<const hpa2::WideArgs*>(args);
  if (!hpa2::wide_ok(y.x)) return 0;
  if (which == 6) {
    hpa2::DeliverPlan pl;
    if (!hpa2::wide_deliver_plan(y.x, pl)) return 0;
    return (size_t)pl.J * y.x.a.b;
  }
  return (size_t)y.x.nl * y.x.a.b;
}

// nothing: a launch of a kernel's grid with no work, the floor under
// which no launch of that grid gets (hpa2_node_empty)
__global__ void node_empty_kernel() {}

// the node bound of the launch, or 0 when the kernels do not take it
int bound_of(const NodeArgs& x) {
  if (!hpa2::node_geometry_ok(x)) return 0;
  return hpa2::node_kernel_bound(x.a);
}

// a kernel's shared tile above the default 48 KB needs the opt-in
template <class K>
cudaError_t allow_smem(K kernel) {
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, hpa2::kNodeSmem);
}

// What a launch of N1 or N4 takes: its plan and its instantiation
template <int MAXN, bool AB>
bool node_launch(const NodeArgs& x, hpa2::NodePlan& pl,
                 void (*&kernel)(NodeArgs, hpa2::NodePlan)) {
  const bool ok = AB ? hpa2::ab_plan<MAXN>(x, pl, hpa2::kNodeSmem)
                     : hpa2::settle_plan<MAXN>(x, pl, hpa2::kNodeSmem);
  if (AB)
    kernel = x.a.packed ? node_ab_kernel<MAXN, true> : node_ab_kernel<MAXN, false>;
  else
    kernel = x.a.packed ? node_settle_kernel<MAXN, true>
                        : node_settle_kernel<MAXN, false>;
  return ok;
}

template <bool AB>
bool node_launch_of(const NodeArgs& x, hpa2::NodePlan& pl,
                    void (*&kernel)(NodeArgs, hpa2::NodePlan)) {
  const int bound = bound_of(x);
  if (bound == 8) return node_launch<8, AB>(x, pl, kernel);
  if (bound == 21) return node_launch<21, AB>(x, pl, kernel);
  if (bound == hpa2::kMaxNodes)
    return node_launch<hpa2::kMaxNodes, AB>(x, pl, kernel);
  return false;
}

// N1's launch: NT-CTA clusters of NR x G threads; N4's: CTAs of
// kNodeCta threads a tile of lanes
template <bool AB>
void node_config(const NodeArgs& x, const hpa2::NodePlan& pl,
                 cudaLaunchConfig_t& cfg, cudaLaunchAttribute* attr) {
  cfg = {};
  cfg.gridDim = dim3((unsigned)(AB ? hpa2::ab_ctas(x, pl)
                                   : (x.a.b + pl.G - 1) / pl.G));
  cfg.blockDim = dim3(AB ? pl.NR * pl.G : hpa2::kNodeCta);
  cfg.dynamicSmemBytes = pl.smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = AB ? pl.NT : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
}

template <class K>
cudaError_t prepare(K kernel, const hpa2::NodePlan& pl) {
  cudaError_t err = cudaSuccess;
  if (pl.smem > 48 * 1024) err = allow_smem(kernel);
  if (err == cudaSuccess && pl.NT > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

template <bool AB>
int launch_node(const NodeArgs& x, int device, void* stream) {
  hpa2::NodePlan pl;
  void (*kernel)(NodeArgs, hpa2::NodePlan) = nullptr;
  if (!node_launch_of<AB>(x, pl, kernel)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess) err = prepare(kernel, pl);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  node_config<AB>(x, pl, cfg, attr);
  cfg.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&cfg, kernel, x, pl);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

// sizes of the argument blocks, checked against the ctypes mirrors
extern "C" int hpa2_args_size() { return (int)sizeof(hpa2::Args); }
extern "C" int hpa2_node_args_size() { return (int)sizeof(NodeArgs); }
extern "C" int hpa2_bucket_args_size() { return (int)sizeof(BucketArgs); }

extern "C" int hpa2_node_ab(const NodeArgs* args, int device, void* stream) {
  return launch_node<true>(*args, device, stream);
}

extern "C" int hpa2_node_settle(const NodeArgs* args, int device,
                                void* stream) {
  return launch_node<false>(*args, device, stream);
}


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

extern "C" int hpa2_wide_args_size() { return (int)sizeof(hpa2::WideArgs); }
extern "C" int hpa2_wide_bucket_args_size() {
  return (int)sizeof(hpa2::WideBucketArgs);
}

// The wide family's entries: N1 one launch, N2 two, N3 two, N4 two, in
// order on the caller's stream; each refuses (cudaErrorInvalidValue) a
// launch the family does not take.  The rows they sum into (N1's cnt,
// hier's key bitmap of N2, N3's flags and feedback rows, N4's red) come
// zeroed.
extern "C" int hpa2_node_ab_wide(const hpa2::WideArgs* y, int device,
                                 void* stream) {
  hpa2::WideAbPlan pl;
  if (!hpa2::wide_ab_plan(*y, pl, hpa2::kWideAbSmem))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err == cudaSuccess && pl.smem > 48 * 1024)
    err = allow_smem(node_ab_wide_kernel);
  if (err != cudaSuccess) return (int)err;
  const int ctas = hpa2::wide_ab_ctas(y->x, pl);
  if (ctas > 0)
    node_ab_wide_kernel<<<ctas, hpa2::kWideAbCta, pl.smem,
                          (cudaStream_t)stream>>>(*y, pl);
  return (int)cudaGetLastError();
}

extern "C" int hpa2_node_bucket_wide(const hpa2::WideBucketArgs* y,
                                     int device, void* stream) {
  hpa2::WideBucketPlan pl;
  if (!hpa2::wide_bucket_plan(*y, pl, hpa2::kWideBucketLanes))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  if (pl.nwt > 0)
    node_bucket_wide_flags_kernel<<<pl.nwt * pl.NLTF, hpa2::kWideBucketCta,
                                    pl.smem1, st>>>(*y, pl);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  node_bucket_wide_place_kernel<<<pl.coff[y->x.ndest], hpa2::kWideBucketCta,
                                  pl.smem2, st>>>(*y, pl);
  return (int)cudaGetLastError();
}

extern "C" int hpa2_node_deliver_wide(const hpa2::WideArgs* y, int device,
                                      void* stream) {
  hpa2::DeliverPlan pl;
  if (!hpa2::wide_ok(y->x) || !hpa2::wide_deliver_plan(y->x, pl))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  const size_t b = y->x.a.b;
  if (err == cudaSuccess)
    err = wide_launch(node_deliver_wide_sets_kernel, (size_t)pl.J * b, stream,
                      *y, pl);
  if (err == cudaSuccess)
    err = wide_launch(node_deliver_wide_take_kernel, (size_t)y->x.nl * b,
                      stream, *y, pl);
  return (int)err;
}

extern "C" int hpa2_node_settle_wide(const hpa2::WideArgs* y, int device,
                                     void* stream) {
  if (!hpa2::wide_ok(y->x)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  const size_t b = y->x.a.b;
  if (err == cudaSuccess)
    err = wide_launch(node_settle_wide_kernel, (size_t)y->x.nl * b, stream,
                      *y);
  if (err == cudaSuccess)
    err = wide_launch(node_settle_wide_lane_kernel,
                      (size_t)(hpa2::kSumRows + hpa2::kMaxRows) * b, stream,
                      *y);
  return (int)err;
}

// The geometry of a launch of kernel `which` (0 N1, 1 N2, 2 N3, 3 N4;
// 4-7 the wide family's N1-N4, their main launch: N1's, N2's place,
// N3's sets, N4's settle)
// with `args` (a NodeArgs, a BucketArgs for N2; the wide family's
// WideArgs, WideBucketArgs): out = CTAs, threads a CTA, bytes of dynamic
// shared memory, lanes a CTA (N1w: pairs a CTA), CTAs an SM holds at
// once, CTAs a cluster.  Launches nothing; returns a CUDA error,
// cudaErrorInvalidValue when the kernel does not take the launch.
extern "C" int hpa2_node_geometry(int which, const void* args, int device,
                                  int* out) {
  const void* fn = nullptr;
  int ctas = 0, threads = hpa2::kNodeCta, G = 0, smem = 0, cl = 1;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (which == 4) {
    hpa2::WideAbPlan pl;
    if (!hpa2::wide_ab_plan(*static_cast<const hpa2::WideArgs*>(args), pl,
                            hpa2::kWideAbSmem))
      return (int)cudaErrorInvalidValue;
    fn = (const void*)node_ab_wide_kernel;
    threads = hpa2::kWideAbCta;
    ctas = hpa2::wide_ab_ctas(static_cast<const hpa2::WideArgs*>(args)->x, pl);
    G = pl.TP, smem = pl.smem;
    if (smem > 48 * 1024) err = allow_smem(node_ab_wide_kernel);
  } else if (which == 5) {
    hpa2::WideBucketPlan pl;
    if (!hpa2::wide_bucket_plan(*static_cast<const hpa2::WideBucketArgs*>(args),
                                pl, hpa2::kWideBucketLanes))
      return (int)cudaErrorInvalidValue;
    fn = (const void*)node_bucket_wide_place_kernel;
    threads = hpa2::kWideBucketCta;
    ctas = pl.coff[static_cast<const hpa2::WideBucketArgs*>(args)->x.ndest];
    G = pl.LB, smem = pl.smem2;
  } else if (which >= 6) {
    const void* fns[2] = {(const void*)node_deliver_wide_sets_kernel,
                          (const void*)node_settle_wide_kernel};
    const size_t items = which > 7 ? 0 : wide_items(which, args);
    if (items == 0) return (int)cudaErrorInvalidValue;
    fn = fns[which - 6];
    threads = hpa2::kWideCta;
    ctas = (int)wide_grid(items);
  } else if (which == 1) {
    const BucketArgs& x = *static_cast<const BucketArgs*>(args);
    hpa2::BucketPlan pl;
    if (!hpa2::bucket_plan(x, pl, hpa2::kNodeSmem))
      return (int)cudaErrorInvalidValue;
    fn = (const void*)node_bucket_kernel;
    G = pl.G, smem = pl.smem, ctas = (x.b + G - 1) / G;
    if (smem > 48 * 1024) err = allow_smem(node_bucket_kernel);
  } else if (which == 2) {
    const NodeArgs& x = *static_cast<const NodeArgs*>(args);
    hpa2::DeliverPlan pl;
    if (bound_of(x) == 0 || !hpa2::deliver_plan(x, pl, hpa2::kNodeSmem))
      return (int)cudaErrorInvalidValue;
    fn = (const void*)node_deliver_kernel;
    G = pl.G, smem = pl.smem, ctas = (x.a.b + G - 1) / G;
    if (smem > 48 * 1024) err = allow_smem(node_deliver_kernel);
  } else {
    const NodeArgs& x = *static_cast<const NodeArgs*>(args);
    hpa2::NodePlan pl;
    void (*kernel)(NodeArgs, hpa2::NodePlan) = nullptr;
    const bool ok = which == 0 ? node_launch_of<true>(x, pl, kernel)
                               : node_launch_of<false>(x, pl, kernel);
    if (!ok) return (int)cudaErrorInvalidValue;
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr[1];
    if (which == 0)
      node_config<true>(x, pl, cfg, attr);
    else
      node_config<false>(x, pl, cfg, attr);
    fn = (const void*)kernel;
    G = pl.G, smem = pl.smem, cl = (int)cfg.attrs[0].val.clusterDim.x;
    ctas = (int)cfg.gridDim.x, threads = (int)cfg.blockDim.x;
    err = prepare(kernel, pl);
  }
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = ctas;
  out[1] = threads;
  out[2] = smem;
  out[3] = G;
  out[4] = per_sm;
  out[5] = cl;
  return 0;
}

// An empty kernel launched as `ctas` CTAs of `threads` threads with
// `smem` bytes of dynamic shared memory on the caller's stream: what a
// launch of that grid costs the card with no work in it.
extern "C" int hpa2_node_empty(int ctas, int threads, int smem, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (smem > 48 * 1024) {
    err = allow_smem(node_empty_kernel);
    if (err != cudaSuccess) return (int)err;
  }
  node_empty_kernel<<<ctas, threads, smem, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
