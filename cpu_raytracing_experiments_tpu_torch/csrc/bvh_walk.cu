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
// the leaf rows are [P, 4] (one 16-byte load a sphere) or [T, 9] (nine
// loads a triangle).
//
// Bound on an H100: per ray the walk reads its node rows (32 B each) and
// leaf rows, most from L2 (the 1,000-sphere tree is 21 KB, the
// 81,920-triangle one 1.6 MB), and does a slab test per node (about 26
// FLOP) and a leaf test per prim (20 FLOP a sphere, about 50 a triangle).
// The least time is the larger of the ray bytes over the memory rate and
// the FLOP of this run's visits over the FP32 rate; chip_smoke.py computes
// it from the plain version's visit counts. Design: one ray a thread,
// 128-thread blocks, no shared memory; divergence within a warp (a warp
// runs as long as its longest walk) is what it does not address. A later
// redesign would sort rays by direction and origin, walk with persistent
// threads, and keep the top of the tree in shared memory.

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

template <bool kTriangles>
__global__ void __launch_bounds__(kThreads)
    closest_kernel(Rays rays, const float* tfar0, const float* nodes,
                   const float* rows, int n_rays, float* tfar_out,
                   int32_t* prim_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = walk::load_ray(rays.c, i);
  float m[3], n[3];
  coeffs(r, m, n);
  float tfar = tfar0 != nullptr ? tfar0[i] : FLT_MAX;
  int32_t prim_id = -1;
  int cur = 0;
  while (cur >= 0) {
    const Node nd = load_node(nodes, cur);
    const bool hit = slab(nd, m, n, tfar);
    const unsigned fc = __float_as_uint(nd.hi.z);
    const int first = static_cast<int>(fc & kFirstMask);
    const int count = static_cast<int>(fc >> kCountShift);
    if (hit && count > 0) {
      for (int s = 0; s < count; ++s) {
        const Candidate c = Leaf<kTriangles>::test(r, rows, first + s);
        if (c.ok && c.t < tfar) {
          tfar = c.t;
          prim_id = first + s;
        }
      }
    }
    cur = (hit && count == 0) ? first : __float_as_int(nd.hi.w);
  }
  tfar_out[i] = tfar;
  prim_out[i] = prim_id;
}

template <bool kTriangles>
__global__ void __launch_bounds__(kThreads)
    occluded_kernel(Rays rays, const float* tfar_in, const float* nodes,
                    const float* rows, int n_rays, uint8_t* occ_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  const float tfar = tfar_in[i];
  bool occluded = false;
  if (tfar > 0.0f) {
    const Ray r = walk::load_ray(rays.c, i);
    float m[3], n[3];
    coeffs(r, m, n);
    int cur = 0;
    while (cur >= 0 && !occluded) {
      const Node nd = load_node(nodes, cur);
      const bool hit = slab(nd, m, n, tfar);
      const unsigned fc = __float_as_uint(nd.hi.z);
      const int first = static_cast<int>(fc & kFirstMask);
      const int count = static_cast<int>(fc >> kCountShift);
      if (hit && count > 0) {
        for (int s = 0; s < count && !occluded; ++s) {
          const Candidate c = Leaf<kTriangles>::test(r, rows, first + s);
          occluded = c.ok && c.t < tfar && c.t >= 0.0f;
        }
      }
      cur = (hit && count == 0) ? first : __float_as_int(nd.hi.w);
    }
  }
  occ_out[i] = occluded ? 1 : 0;
}

int blocks_for(int n_rays) { return (n_rays + kThreads - 1) / kThreads; }

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 = launched). `triangles` picks the leaf rows: 0 spheres [P, 4],
// 1 triangles [T, 9]. `tfar0` may be null (FLT_MAX).
extern "C" int bvh_closest(const float* px, const float* py, const float* pz,
                           const float* dx, const float* dy, const float* dz,
                           const float* tfar0, const float* nodes,
                           const float* rows, int triangles, int n_rays,
                           float* tfar_out, int32_t* prim_out, void* stream) {
  if (n_rays > 0) {
    const Rays rays{{px, py, pz, dx, dy, dz}};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (triangles) {
      closest_kernel<true><<<blocks_for(n_rays), kThreads, 0, s>>>(
          rays, tfar0, nodes, rows, n_rays, tfar_out, prim_out);
    } else {
      closest_kernel<false><<<blocks_for(n_rays), kThreads, 0, s>>>(
          rays, tfar0, nodes, rows, n_rays, tfar_out, prim_out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int bvh_occluded(const float* px, const float* py, const float* pz,
                            const float* dx, const float* dy, const float* dz,
                            const float* tfar, const float* nodes,
                            const float* rows, int triangles, int n_rays,
                            uint8_t* occ_out, void* stream) {
  if (n_rays > 0) {
    const Rays rays{{px, py, pz, dx, dy, dz}};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (triangles) {
      occluded_kernel<true><<<blocks_for(n_rays), kThreads, 0, s>>>(
          rays, tfar, nodes, rows, n_rays, occ_out);
    } else {
      occluded_kernel<false><<<blocks_for(n_rays), kThreads, 0, s>>>(
          rays, tfar, nodes, rows, n_rays, occ_out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
