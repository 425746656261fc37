// Threaded-BVH walks of the PyTorch port (accel='bvh'), for Hopper
// (sm_90a).
//
// Replaces no Pallas kernel: the JAX package walks the BVH with XLA
// lax.while_loops,
//   bvh_closest  <- bvh/traverse.py:254 (traverse_closest_packed)
//   bvh_occluded <- bvh/traverse.py:309 (traverse_shadow_packed)
// Copied into eager PyTorch, one lock-step trip is tens of launches and a
// host read, and the loop takes as many trips as its worst ray; so each walk
// is one kernel here.
//
// What they compute, per ray: the cursor starts at the root (node 0) and
// steps cursor <- hit & inner ? first_child : miss until it reads -1. The
// slab test (csrc/walk_common.cuh) clamps tmin at 1e-4 and caps tmax at the
// current tfar. A leaf that is hit tests its prims first .. first + count - 1
// in order: bvh_closest keeps a prim where t < tfar strictly (so tfar
// tightens inside the leaf and the first of equal hits wins), starting from
// tfar0 or FLT_MAX; bvh_occluded stops at the first prim with t in [0, tfar),
// and a lane with tfar <= 0 (or NaN) does not walk. The walk of a ray
// depends on that ray alone, so one thread walking its ray to the end gives
// the bits of the JAX package's lock-step loop, whose trip count only
// decides when the whole loop stops. Both equal the plain versions
// (bvh/traverse.py) bit for bit: the rounding contract of walk_common.cuh.
//
// Layout: the node table is [N, 8] float32 (min.xyz, max.xyz,
// bitcast(first | count << 27), bitcast(miss)), two 16-byte loads a node;
// the any-hit walk's pair table is [I, 16] (below); the leaf rows are
// [P, 4] (one 16-byte load a sphere) or [T, 9] (nine loads a triangle).
//
// Bound on an H100: per ray the walk reads its node rows (32 B each) and
// leaf rows, most from L2 (the 1,000-sphere tree is 21 KB, the
// 81,920-triangle one 1.6 MB), and does a slab test per node (about 26
// FLOP) and a leaf test per prim (20 FLOP a sphere, about 50 a triangle).
// The least time is the larger of the ray bytes over the memory rate and
// the FLOP of this run's visits over the FP32 rate; chip_smoke.py computes
// it from the plain version's visit counts.
//
// Design of bvh_closest: a warp runs as long as its longest walk, and a
// warp whose lanes mix inner nodes and leaves waits for both. So
//   * persistent warps (Aila & Laine, "Understanding the Efficiency of Ray
//     Traversal on GPUs", HPG 2009): one wave of 128-thread blocks, each
//     lane starting on a ray of its own, then each warp taking rays from a
//     global counter (reset on the stream before the launch), lane by lane,
//     whenever a quarter of its lanes are idle;
//   * "while-while" stepping: the lanes step through inner nodes (two steps
//     a vote) until every active lane is parked at a hit leaf or done, then
//     the warp tests its leaves together;
//   * the node table in shared memory, staged once a block with cp.async,
//     where two blocks an SM can hold it whole (the field's 665 nodes, 21
//     KB); else (the mesh's 51,863 nodes, 1.66 MB) two __ldg loads a node.
//     The table is in depth-first order, so a prefix of it is no top of the
//     tree: it is staged whole or not at all.
// Each ray's walk is unchanged (the same threaded visit order, slab test
// and strict < at the leaf, the leaf's slab test against the tfar of its
// visit): only which warp walks which ray, and when, moves, so the bits do
// not.
//
// bvh_occluded, the pair walk. The any-hit bit does not depend on the
// order of the visits: tfar is fixed for the ray (it never tightens), the
// result is the OR of (ok & t < tfar & t >= 0) over the prims of every leaf
// reached, and the miss links skip exactly the subtree of a missed node, so
// a node is reached iff the slab test passes at every ancestor. The bit is
// therefore the OR over the leaves whose whole ancestor chain and own box
// pass the slab test, and any walk that runs the same slab arithmetic on
// the same float32 box bits gives it; stopping at the first occluder only
// shortens the walk. NaN slabs are per box, so they take part unchanged.
// (tests/test_torch_bvh.py holds a model of this walk's order to jitted
// JAX.) So the walk takes a row of the child-pair table a step
// (BVHArrays.pairs, bvh/traverse.py::pack_pairs): row j is the j-th inner
// node's two children side by side, each its threaded row (min.xyz,
// max.xyz, first | count << 27) with the last word the row of its own
// children (-1 for a leaf), 64 bytes read as four __ldg loads. A lane tests
// the root's own box (node 0 of the threaded table) and then, a row a step,
// both children's boxes; a hit leaf child is tested in that step (both
// leaves' prims in one loop); it goes down the first hit inner child and
// keeps the second on its column of a shared-memory stack (an entry a
// level: the most inner nodes on a root path less one), popped when no
// child goes down. The two slab tests of a step issue together and the
// chain of dependent row loads is half the threaded walk's; every step runs
// one body, so the lanes of a warp stay together whichever rows they are
// on. The sphere form is held to 32 registers (16 blocks an SM, as the
// threaded walk it replaced): rays that miss the root need the occupancy;
// the triangle form takes 54 (the threaded one took 48). Scheduling was measured and left out
// (PERF.md section 6): persistent warps with a ray counter and while-while
// stepping gained on the divergent field batches but lost on short walks
// and on coherent camera rays; staging the table lost to the per-block
// copy; a stackless pair walk in the threaded order ran two loop bodies
// and lost. This one kernel walks every BVH: a root that is a leaf is
// tested at once, and a tree deep enough that a block's stacks pass 48 KB
// raises the dynamic shared-memory limit. On a 100,000-sphere field's 2.1
// MB table, which no render path walks, the threaded walk it replaced was
// faster on some batches (PERF.md section 6).
// The bound: the operations of the plain version's node visits and leaf
// tests; the bytes of the ray (24 B) of each lane with tfar > 0 (no other
// lane reads it), tfar and the bit of every lane, the root's row, the pair
// table and the leaf rows.

#include "walk_common.cuh"

namespace {

using walk::Candidate;
using walk::Leaf;
using walk::Ray;
using walk::max_nan;
using walk::min_nan;

constexpr int kThreads = 128;
constexpr unsigned kCountShift = 27;
constexpr unsigned kFirstMask = (1u << kCountShift) - 1;

struct Node {
  float4 lo;  // min.xyz, max.x
  float4 hi;  // max.yz, first|count, miss
};

// bvh/traverse.py::_slab_from_row with m = 1/dir, n = p * m.
__device__ __forceinline__ bool slab(const Node& nd, const float m[3],
                                     const float n[3], float tfar) {
  const float mn[3] = {nd.lo.x, nd.lo.y, nd.lo.z};
  const float mx[3] = {nd.lo.w, nd.hi.x, nd.hi.y};
  float lo = __fmaf_rn(mn[0], m[0], -n[0]);
  float hi = __fmaf_rn(mx[0], m[0], -n[0]);
  float tmin = max_nan(min_nan(lo, hi), 1e-4f);
  float tmax = min_nan(tfar, max_nan(lo, hi));
#pragma unroll
  for (int k = 1; k < 3; ++k) {
    lo = __fmaf_rn(mn[k], m[k], -n[k]);
    hi = __fmaf_rn(mx[k], m[k], -n[k]);
    tmin = max_nan(tmin, min_nan(lo, hi));
    tmax = min_nan(tmax, max_nan(lo, hi));
  }
  return tmax >= tmin;
}

__device__ __forceinline__ Node load_node(const float* nodes, int cur) {
  const float4* row = reinterpret_cast<const float4*>(nodes) + 2 * cur;
  return Node{__ldg(row), __ldg(row + 1)};
}

__device__ __forceinline__ void coeffs(const Ray& r, float m[3], float n[3]) {
  m[0] = __fdiv_rn(1.0f, r.dx);
  m[1] = __fdiv_rn(1.0f, r.dy);
  m[2] = __fdiv_rn(1.0f, r.dz);
  n[0] = __fmul_rn(r.px, m[0]);
  n[1] = __fmul_rn(r.py, m[1]);
  n[2] = __fmul_rn(r.pz, m[2]);
}

struct Rays {
  const float* c[6];  // px, py, pz, dx, dy, dz
};

constexpr int kWalkThreads = 128;  // bvh_closest's blocks
constexpr int kRefillIdle = 8;  // idle lanes at which a warp takes new rays
constexpr unsigned kFullMask = 0xffffffffu;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// The closest walk of one ray in flight on a lane: its ray, slab
// coefficients, tfar and prim so far, the cursor, and the leaf it is parked
// at (leaf_count 0: none; the cursor then already holds the leaf's miss).
struct Walk {
  Ray r;
  float m[3], n[3];
  float tfar;
  int32_t prim;
  int cur, leaf_first, leaf_count;
};

template <bool kTriangles, bool kStaged>
__global__ void __launch_bounds__(kWalkThreads)
    closest_kernel(Rays rays, const float* tfar0, const float* nodes,
                   int n_nodes, const float* rows, int n_rays,
                   int* __restrict__ next_ray, float* tfar_out,
                   int32_t* prim_out) {
  extern __shared__ float4 staged[];
  if (kStaged) {
    const float4* table = reinterpret_cast<const float4*>(nodes);
    for (int k = threadIdx.x; k < 2 * n_nodes; k += kWalkThreads) {
      cp_async16(staged + k, table + k);
    }
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
  }
  const unsigned lane = threadIdx.x & 31u;
  const unsigned below = (1u << lane) - 1u;
  Walk w;
  int ray = -1;  // the lane's ray, -1 while idle
  auto start = [&](int i) {
    ray = i;
    w.r = walk::load_ray(rays.c, i);
    coeffs(w.r, w.m, w.n);
    w.tfar = tfar0 != nullptr ? tfar0[i] : FLT_MAX;
    w.prim = -1;
    w.cur = 0;
    w.leaf_count = 0;
  };
  // each lane's first ray is its own; the counter hands out the rest,
  // from the grid's lane count on
  const int lanes = gridDim.x * kWalkThreads;
  const int own = blockIdx.x * kWalkThreads + threadIdx.x;
  if (own < n_rays) start(own);
  bool more = lanes < n_rays;  // rays left at the counter (warp-uniform)
  while (true) {
    const unsigned idle = __ballot_sync(kFullMask, ray < 0);
    const int want = __popc(idle);
    if (more && want >= kRefillIdle) {
      int base = 0;
      if (lane == 0) base = lanes + atomicAdd(next_ray, want);
      base = __shfl_sync(kFullMask, base, 0);
      more = static_cast<long long>(base) + want < n_rays;
      const int i = base + __popc(idle & below);
      if (ray < 0 && i < n_rays) start(i);
    }
    if (__ballot_sync(kFullMask, ray >= 0) == 0) break;
    // inner nodes, until every active lane is parked at a leaf or done:
    // two steps a vote
    while (__any_sync(kFullMask, ray >= 0 && w.leaf_count == 0)) {
#pragma unroll
      for (int step = 0; step < 2; ++step) {
        if (ray >= 0 && w.leaf_count == 0) {
          const Node nd = kStaged ? Node{staged[2 * w.cur],
                                         staged[2 * w.cur + 1]}
                                  : load_node(nodes, w.cur);
          const bool hit = slab(nd, w.m, w.n, w.tfar);
          const unsigned fc = __float_as_uint(nd.hi.z);
          const int first = static_cast<int>(fc & kFirstMask);
          const int count = static_cast<int>(fc >> kCountShift);
          w.cur = (hit && count == 0) ? first : __float_as_int(nd.hi.w);
          if (hit && count > 0) {
            w.leaf_first = first;
            w.leaf_count = count;
          } else if (w.cur < 0) {
            tfar_out[ray] = w.tfar;
            prim_out[ray] = w.prim;
            ray = -1;
          }
        }
      }
    }
    // the parked leaves, together
    if (ray >= 0) {
      for (int s = 0; s < w.leaf_count; ++s) {
        const Candidate c = Leaf<kTriangles>::test(w.r, rows,
                                                   w.leaf_first + s);
        if (c.ok && c.t < w.tfar) {
          w.tfar = c.t;
          w.prim = w.leaf_first + s;
        }
      }
      w.leaf_count = 0;
      if (w.cur < 0) {
        tfar_out[ray] = w.tfar;
        prim_out[ray] = w.prim;
        ray = -1;
      }
    }
  }
}

// Whether a prim of the leaf `fa`, then of the leaf `fb` (each first |
// count << 27; 0: no leaf), lies at t in [0, tfar): one loop over both
// leaves' prims in order, stopping at the first.
template <bool kTriangles>
__device__ __forceinline__ bool leaves_occlude(const Ray& r,
                                               const float* rows, unsigned fa,
                                               unsigned fb, float tfar) {
  const int first_a = static_cast<int>(fa & kFirstMask);
  const int count_a = static_cast<int>(fa >> kCountShift);
  const int first_b = static_cast<int>(fb & kFirstMask) - count_a;
  const int count = count_a + static_cast<int>(fb >> kCountShift);
  for (int s = 0; s < count; ++s) {
    const int prim = s < count_a ? first_a + s : first_b + s;
    const Candidate c = Leaf<kTriangles>::test(r, rows, prim);
    if (c.ok && c.t < tfar && c.t >= 0.0f) return true;
  }
  return false;
}

// The pair walk: one ray a thread, a step a row of the pair table (both
// children of a node); the second inner child kept on the lane's column of
// a shared-memory stack. A root that is a leaf is tested at once, the
// table not read. Spheres are held to 32 registers (16 blocks an SM).
template <bool kTriangles>
__global__ void __launch_bounds__(kThreads, kTriangles ? 1 : 16)
    occluded_pairs_kernel(Rays rays, const float* tfar_in, const float* nodes,
                          const float* pairs, const float* rows, int n_rays,
                          uint8_t* occ_out) {
  extern __shared__ int stacks[];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  int* stack = stacks + threadIdx.x;  // entry k at stack[kThreads * k]
  const float tfar = tfar_in[i];
  bool occluded = false;
  if (tfar > 0.0f) {
    const Ray r = walk::load_ray(rays.c, i);
    float m[3], n[3];
    coeffs(r, m, n);
    const Node root = load_node(nodes, 0);
    if (slab(root, m, n, tfar)) {
      const unsigned rfc = __float_as_uint(root.hi.z);
      const bool leaf = (rfc >> kCountShift) != 0;
      int cur = leaf ? -1 : 0, sp = 0;  // the pair row to step next
      unsigned la = leaf ? rfc : 0u, lb = 0u;  // hit leaves to test
      while (true) {
        if ((la | lb) && leaves_occlude<kTriangles>(r, rows, la, lb, tfar)) {
          occluded = true;
          break;
        }
        if (cur < 0) break;
        const float4* row = reinterpret_cast<const float4*>(pairs) + 4 * cur;
        const Node a{__ldg(row), __ldg(row + 1)};
        const Node b{__ldg(row + 2), __ldg(row + 3)};
        const bool hit_a = slab(a, m, n, tfar);
        const bool hit_b = slab(b, m, n, tfar);
        const unsigned fa = __float_as_uint(a.hi.z);
        const unsigned fb = __float_as_uint(b.hi.z);
        const bool go_a = hit_a && (fa >> kCountShift) == 0;
        const bool go_b = hit_b && (fb >> kCountShift) == 0;
        la = hit_a && !go_a ? fa : 0u;
        lb = hit_b && !go_b ? fb : 0u;
        if (go_a) {
          if (go_b) stack[kThreads * sp++] = __float_as_int(b.hi.w);
          cur = __float_as_int(a.hi.w);
        } else if (go_b) {
          cur = __float_as_int(b.hi.w);
        } else {
          cur = sp == 0 ? -1 : stack[kThreads * --sp];
        }
      }
    }
  }
  occ_out[i] = occluded ? 1 : 0;
}

int blocks_for(int n_rays) { return (n_rays + kThreads - 1) / kThreads; }

// Launch bvh_closest's persistent grid: as many blocks as the card holds at
// once (capped at one block per 128 rays), the node table staged where two
// blocks an SM can hold it.
template <bool kTriangles>
cudaError_t launch_closest(const Rays& rays, const float* tfar0,
                           const float* nodes, int n_nodes, const float* rows,
                           int n_rays, int* next_ray, float* tfar_out,
                           int32_t* prim_out, cudaStream_t s) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const size_t table = static_cast<size_t>(n_nodes) * 2 * sizeof(float4);
  const bool stage = 2 * table <= static_cast<size_t>(optin);
  const void* fn = stage
      ? reinterpret_cast<const void*>(closest_kernel<kTriangles, true>)
      : reinterpret_cast<const void*>(closest_kernel<kTriangles, false>);
  const size_t smem = stage ? table : 0;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kWalkThreads,
                                                smem);
  const int wave = (per_sm > 0 ? per_sm : 1) * sms;
  const int wanted = (n_rays + kWalkThreads - 1) / kWalkThreads;
  const int blocks = wave < wanted ? wave : wanted;
  cudaMemsetAsync(next_ray, 0, sizeof(int), s);
  if (stage) {
    closest_kernel<kTriangles, true><<<blocks, kWalkThreads, smem, s>>>(
        rays, tfar0, nodes, n_nodes, rows, n_rays, next_ray, tfar_out,
        prim_out);
  } else {
    closest_kernel<kTriangles, false><<<blocks, kWalkThreads, 0, s>>>(
        rays, tfar0, nodes, n_nodes, rows, n_rays, next_ray, tfar_out,
        prim_out);
  }
  return cudaGetLastError();
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 = launched). `triangles` picks the leaf rows: 0 spheres [P, 4],
// 1 triangles [T, 9]. `tfar0` may be null (FLT_MAX). bvh_closest takes the
// node count and one int of device scratch (`next_ray`, the rays' counter,
// which it resets on the stream); `nodes` is 16-byte aligned.
extern "C" int bvh_closest(const float* px, const float* py, const float* pz,
                           const float* dx, const float* dy, const float* dz,
                           const float* tfar0, const float* nodes,
                           int n_nodes, const float* rows, int triangles,
                           int n_rays, int* next_ray, float* tfar_out,
                           int32_t* prim_out, void* stream) {
  if (n_rays > 0) {
    const Rays rays{{px, py, pz, dx, dy, dz}};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err =
        triangles ? launch_closest<true>(rays, tfar0, nodes, n_nodes, rows,
                                         n_rays, next_ray, tfar_out,
                                         prim_out, s)
                  : launch_closest<false>(rays, tfar0, nodes, n_nodes, rows,
                                          n_rays, next_ray, tfar_out,
                                          prim_out, s);
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// bvh_occluded takes the pair table `pairs` (16-byte aligned; not read
// where the root is a leaf) and its stacks' depth: `stack_depth` ints a
// thread of dynamic shared memory, the limit raised past 48 KB a block
// where a deep tree needs it (an error where the card's 227 KB cannot
// hold them).
extern "C" int bvh_occluded(const float* px, const float* py, const float* pz,
                            const float* dx, const float* dy, const float* dz,
                            const float* tfar, const float* nodes,
                            const float* pairs, int stack_depth,
                            const float* rows, int triangles, int n_rays,
                            uint8_t* occ_out, void* stream) {
  if (n_rays > 0) {
    const Rays rays{{px, py, pz, dx, dy, dz}};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int blocks = blocks_for(n_rays);
    const size_t smem = static_cast<size_t>(stack_depth) * kThreads * 4;
    const void* fn =
        triangles ? reinterpret_cast<const void*>(occluded_pairs_kernel<true>)
                  : reinterpret_cast<const void*>(occluded_pairs_kernel<false>);
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (triangles) {
      occluded_pairs_kernel<true><<<blocks, kThreads, smem, s>>>(
          rays, tfar, nodes, pairs, rows, n_rays, occ_out);
    } else {
      occluded_pairs_kernel<false><<<blocks, kThreads, smem, s>>>(
          rays, tfar, nodes, pairs, rows, n_rays, occ_out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
