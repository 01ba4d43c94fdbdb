"""The node kernels' bodies (``csrc/node_cycle.cuh``) built with g++ for
the host, and a launcher that runs them on CPU tensors.

Each entry loops over what the card runs in parallel: a CTA at a time,
its phases in order, each phase run by every thread of the CTA before
the next begins (the barrier between them on the card); within a phase
the threads share only ORs and sums that commute.  The shared tile
starts as garbage, as on the card, so a phase that reads what no
earlier phase wrote shows here.
Set ``hpa2_tpu_torch.ops.node_cycle.HOST_LAUNCHER`` to :func:`launcher`'s
result and a node-sharded run on the CPU goes through the kernels'
bodies as a run on the card goes through the kernels."""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

from hpa2_tpu_torch.ops import kernels
from hpa2_tpu_torch.ops import node_cycle as nc

SHIM = r"""
#include <vector>
#include "node_cycle.cuh"
using hpa2::NodeArgs;
using hpa2::BucketArgs;
// a phase-by-phase loop over clusters of `cl` CTAs of `threads` threads:
// phase ph of every thread of every CTA of the cluster before ph + 1,
// each CTA with its own tile of `smem` bytes (a multiple of 4), the
// cluster's side by side
template <class Phase>
void ctas(int ctas, int phases, size_t smem, Phase phase, int cl = 1,
          int threads = hpa2::kNodeCta) {
  std::vector<uint64_t> tiles((smem * cl + 7) / 8, 0xA5A5A5A5A5A5A5A5ull);
  for (int c0 = 0; c0 < ctas; c0 += cl)
    for (int ph = 0; ph < phases; ++ph)
      for (int cta = c0; cta < c0 + cl; ++cta)
        for (int tid = 0; tid < threads; ++tid)
          phase(ph, cta, tid,
                (void*)((char*)tiles.data() + (size_t)(cta - c0) * smem));
}
int deliver(const NodeArgs& x) {
  hpa2::DeliverPlan pl;
  if (!hpa2::deliver_plan(x, pl, hpa2::kNodeSmem)) return 1;
  ctas((x.a.b + pl.G - 1) / pl.G, hpa2::kN3Phases, pl.smem,
       [&](int ph, int cta, int tid, void* sh) {
         hpa2::n3_phase(x, pl, ph, cta, tid, sh);
       });
  return 0;
}
template <int MAXN, bool PACKED> int ab(const NodeArgs& x) {
  hpa2::NodePlan pl;
  if (!hpa2::ab_plan<MAXN>(x, pl, hpa2::kNodeSmem)) return 1;
  ctas(hpa2::ab_ctas(x, pl), hpa2::kN1Phases, pl.smem,
       [&](int ph, int cta, int tid, void* sh) {
         hpa2::n1_phase<MAXN, PACKED>(x, pl, ph, cta, tid, (int32_t*)sh);
       }, pl.NT, pl.NR * pl.G);
  return 0;
}
template <int MAXN, bool PACKED> int settle(const NodeArgs& x) {
  hpa2::NodePlan pl;
  if (!hpa2::settle_plan<MAXN>(x, pl, hpa2::kNodeSmem)) return 1;
  ctas((x.a.b + pl.G - 1) / pl.G, hpa2::kN4Phases, pl.smem,
       [&](int ph, int cta, int tid, void* sh) {
         hpa2::n4_phase<MAXN, PACKED>(x, pl, ph, cta, tid, (int32_t*)sh);
       });
  return 0;
}
// the plan of N1 (what 0) or N4 (2): out = lanes a CTA, tile bytes,
// node rows a CTA, CTAs a cluster
template <int MAXN> int plan(const NodeArgs& x, int what, int* out) {
  hpa2::NodePlan pl;
  const bool ok = what == 0 ? hpa2::ab_plan<MAXN>(x, pl, hpa2::kNodeSmem)
                            : hpa2::settle_plan<MAXN>(x, pl, hpa2::kNodeSmem);
  out[0] = pl.G, out[1] = pl.smem, out[2] = pl.NR, out[3] = pl.NT;
  return ok ? 0 : 1;
}
template <int MAXN> int go(const NodeArgs& x, int what, int* out) {
  if (out) return plan<MAXN>(x, what, out);
  if (what == 1) return deliver(x);
  if (what == 0) return x.a.packed ? ab<MAXN, true>(x) : ab<MAXN, false>(x);
  return x.a.packed ? settle<MAXN, true>(x) : settle<MAXN, false>(x);
}
int dispatch(const NodeArgs* x, int what, int* out = nullptr) {
  if (!hpa2::node_geometry_ok(*x)) return 1;
  const int bound = hpa2::node_kernel_bound(x->a);
  if (bound == 8) return go<8>(*x, what, out);
  if (bound == 21) return go<21>(*x, what, out);
  if (bound == 64) return go<64>(*x, what, out);
  return 1;  // refused, as the launch would be
}
extern "C" int hpa2_node_args_size() { return (int)sizeof(NodeArgs); }
extern "C" int hpa2_bucket_args_size() { return (int)sizeof(BucketArgs); }
extern "C" int hpa2_host_node_ab(const NodeArgs* x) { return dispatch(x, 0); }
extern "C" int hpa2_host_node_deliver(const NodeArgs* x) { return dispatch(x, 1); }
extern "C" int hpa2_host_node_settle(const NodeArgs* x) { return dispatch(x, 2); }
extern "C" int hpa2_host_node_plan(const NodeArgs* x, int what, int* out) {
  return dispatch(x, what, out);
}
// the wide family: N1 and N2 a CTA at a time, phase by phase (their plans
// at the limits hpa2_host_wide_limits sets: the card's unless a test
// forces smaller tiles); N3's and N4's launches their items in order,
// one launch after the other (their items share only integer ORs and
// sums, which commute)
static int g_wide_smem = hpa2::kWideAbSmem;
static int g_wide_lanes = hpa2::kWideBucketLanes;
extern "C" void hpa2_host_wide_limits(int smem, int lanes) {
  g_wide_smem = smem;
  g_wide_lanes = lanes;
}
template <class F>
void items(size_t n, F f) {
  for (size_t i = 0; i < n; ++i) f(i);
}
extern "C" int hpa2_wide_args_size() { return (int)sizeof(hpa2::WideArgs); }
extern "C" int hpa2_wide_bucket_args_size() {
  return (int)sizeof(hpa2::WideBucketArgs);
}
// N1w's plan: out = pairs a CTA, words a pair's sets, sets in the
// scratch, tile bytes, CTAs
extern "C" int hpa2_host_wide_ab_plan(const hpa2::WideArgs* y, int* out) {
  hpa2::WideAbPlan pl;
  if (!hpa2::wide_ab_plan(*y, pl, g_wide_smem)) return 1;
  out[0] = pl.TP, out[1] = pl.stride, out[2] = pl.global, out[3] = pl.smem;
  out[4] = hpa2::wide_ab_ctas(y->x, pl);
  return 0;
}
// N2w's plan: out = lanes a tile, lane tiles, chunks a place CTA, scan
// steps, flags CTAs, place CTAs (fold CTAs included), slots a place CTA
extern "C" int hpa2_host_wide_bucket_plan(const hpa2::WideBucketArgs* y,
                                          int* out) {
  hpa2::WideBucketPlan pl;
  if (!hpa2::wide_bucket_plan(*y, pl, g_wide_lanes)) return 1;
  out[0] = pl.LB, out[1] = pl.NLT, out[2] = pl.NC, out[3] = pl.steps;
  out[4] = pl.nwt * pl.NLTF, out[5] = pl.coff[y->x.ndest], out[6] = pl.S;
  return 0;
}
// TileWords's set operations on sets x and y of sw words (the warp of
// the host build): out = any(x), owner(x), count(x), test(x, p), then the
// sets bit(p), x & ~y, x | y, a copy of x, zero, sw words each
extern "C" void hpa2_host_tile_words(int sw, const int32_t* x,
                                     const int32_t* y, int p, int32_t* out) {
  std::vector<int32_t> sets(7 * (size_t)sw);
  const hpa2::TileWords v{sw, sets.data(), nullptr};
  hpa2::TileWords::Set s[7];
  for (int k = 0; k < 7; ++k) v.bind(s[k], k);
  for (int j = 0; j < sw; ++j) sets[j] = x[j], sets[sw + j] = y[j];
  out[0] = v.any(s[0]), out[1] = v.owner(s[0]), out[2] = v.count(s[0]);
  out[3] = v.test(s[0], p);
  v.bit(s[2], p);
  v.and_not(s[3], s[0], s[1]);
  v.copy(s[4], s[0]);
  v.or_in(s[4], s[1]);
  v.copy(s[5], s[0]);
  v.copy(s[6], s[0]);
  v.zero(s[6]);
  for (int k = 2; k < 7; ++k)
    for (int j = 0; j < sw; ++j) out[4 + (k - 2) * sw + j] = sets[k * sw + j];
}
extern "C" int hpa2_host_node_ab_wide(const hpa2::WideArgs* y) {
  hpa2::WideAbPlan pl;
  if (!hpa2::wide_ab_plan(*y, pl, g_wide_smem)) return 1;
  ctas(hpa2::wide_ab_ctas(y->x, pl), hpa2::kN1wPhases, pl.smem,
       [&](int ph, int cta, int tid, void* sh) {
         hpa2::n1w_phase(*y, pl, ph, cta, tid, (int32_t*)sh);
       }, 1, hpa2::kWideAbCta);
  return 0;
}
extern "C" int hpa2_host_node_bucket_wide(const hpa2::WideBucketArgs* y) {
  hpa2::WideBucketPlan pl;
  if (!hpa2::wide_bucket_plan(*y, pl, g_wide_lanes)) return 1;
  ctas(pl.nwt * pl.NLTF, hpa2::kN2wFlagPhases, pl.smem1,
       [&](int ph, int cta, int tid, void* sh) {
         hpa2::n2w_flags_phase(*y, pl, ph, cta, tid, (uint32_t*)sh);
       }, 1, hpa2::kWideBucketCta);
  ctas(pl.coff[y->x.ndest], pl.steps + 3, pl.smem2,
       [&](int ph, int cta, int tid, void* sh) {
         hpa2::n2w_place_phase(*y, pl, ph, cta, tid, (uint32_t*)sh);
       }, 1, hpa2::kWideBucketCta);
  return 0;
}
extern "C" int hpa2_host_node_deliver_wide(const hpa2::WideArgs* y) {
  hpa2::DeliverPlan pl;
  if (!hpa2::wide_ok(y->x) || !hpa2::wide_deliver_plan(y->x, pl)) return 1;
  const size_t b = y->x.a.b;
  items((size_t)pl.J * b, [&](size_t i) { hpa2::w3_sets(*y, pl, i); });
  items((size_t)y->x.nl * b, [&](size_t i) { hpa2::w3_take(*y, pl, i); });
  return 0;
}
extern "C" int hpa2_host_node_settle_wide(const hpa2::WideArgs* y) {
  if (!hpa2::wide_ok(y->x)) return 1;
  const size_t b = y->x.a.b;
  items((size_t)y->x.nl * b, [&](size_t i) { hpa2::w4_item(*y, i); });
  items((size_t)(hpa2::kSumRows + hpa2::kMaxRows) * b,
        [&](size_t i) { hpa2::w4_lane(*y, i); });
  return 0;
}
extern "C" int hpa2_host_node_bucket(const BucketArgs* x) {
  hpa2::BucketPlan pl;
  if (!hpa2::bucket_plan(*x, pl, hpa2::kNodeSmem)) return 1;
  ctas((x->b + pl.G - 1) / pl.G, hpa2::kN2Phases, pl.smem,
       [&](int ph, int cta, int tid, void* sh) {
         hpa2::n2_phase(*x, pl, ph, cta, tid, (uint32_t*)sh);
       });
  return 0;
}
"""


def build():
    """The host library (built once a source digest, under the ignored
    ``hpa2_tpu_torch/build/``), or None without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        return None
    h = hashlib.sha256(SHIM.encode())
    for name in ("node_cycle.cuh", "cycle.cuh"):
        h.update((kernels.CSRC_DIR / name).read_bytes())
    kernels.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so = kernels.BUILD_DIR / f"node_host_{h.hexdigest()[:16]}.so"
    if not so.exists():
        src = so.with_suffix(f".{os.getpid()}.cpp")
        src.write_text(SHIM)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run(
            [gxx, "-std=c++17", "-O1", "-shared", "-fPIC",
             f"-I{kernels.CSRC_DIR}", "-o", str(tmp), str(src)],
            check=True)
        os.replace(tmp, so)
        src.unlink()
    lib = ctypes.CDLL(str(so))
    for f in ("ab", "deliver", "settle"):
        fn = getattr(lib, f"hpa2_host_node_{f}")
        fn.argtypes = [ctypes.POINTER(nc.NodeArgs)]
    lib.hpa2_host_node_bucket.argtypes = [ctypes.POINTER(nc.BucketArgs)]
    for f in ("ab", "deliver", "settle"):
        getattr(lib, f"hpa2_host_node_{f}_wide").argtypes = [
            ctypes.POINTER(nc.WideArgs)]
    lib.hpa2_host_node_bucket_wide.argtypes = [
        ctypes.POINTER(nc.WideBucketArgs)]
    lib.hpa2_host_wide_ab_plan.argtypes = [ctypes.POINTER(nc.WideArgs),
                                           ctypes.POINTER(ctypes.c_int)]
    lib.hpa2_host_wide_bucket_plan.argtypes = [
        ctypes.POINTER(nc.WideBucketArgs), ctypes.POINTER(ctypes.c_int)]
    lib.hpa2_host_wide_limits.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.hpa2_host_tile_words.argtypes = [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p]
    lib.hpa2_host_node_plan.argtypes = [ctypes.POINTER(nc.NodeArgs),
                                        ctypes.c_int,
                                        ctypes.POINTER(ctypes.c_int)]
    return lib


class HostLauncher:
    """Runs a node kernel's host build on CPU tensors; counts launches
    by kernel."""

    def __init__(self, lib):
        self.lib = lib
        self.launches = {e.name: 0 for e in nc.ALL_NODE_KERNELS}
        self._lock = threading.Lock()

    def launch(self, entry, args, device) -> None:
        if getattr(self.lib, f"hpa2_host_{entry.name}")(
                ctypes.byref(args)) != 0:
            raise RuntimeError(f"{entry.name}: the host build refused")
        with self._lock:
            self.launches[entry.name] += 1


def rank_fast_host(job: dict) -> dict:
    """A ``NodeShardedCudaEngine``'s job on a gloo rank, its node kernels
    run by their host build."""
    from hpa2_tpu_torch.parallel.sharding import _rank_fast

    nc.HOST_LAUNCHER = HostLauncher(build())
    try:
        return _rank_fast(job)
    finally:
        nc.HOST_LAUNCHER = None


class HostRun:
    """A node-sharded fast-path engine for ``run_node_sharded`` whose
    ranks (gloo processes) run the node kernels' host build."""

    def __init__(self, engine):
        self.engine = engine
        self.mesh = engine.mesh

    def _job(self) -> dict:
        return dict(rank_fn=rank_fast_host, engine=self.engine)

    def _gather(self, blocks) -> None:
        self.engine._gather(blocks)

    def _check(self) -> None:
        self.engine._check()
