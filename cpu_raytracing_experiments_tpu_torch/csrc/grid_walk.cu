// Uniform-grid DDA walks of the PyTorch port (accel='grid'), for Hopper
// (sm_90a), with the dense battery over the grid's residual prims.
//
// Replaces no Pallas kernel: the JAX package walks the grid with XLA
// lax.while_loops and a dense residual battery,
//   grid_closest  <- bvh/grid.py:100 (traverse_grid_closest) and :215
//                    (_battery_closest)
//   grid_occluded <- bvh/grid.py:246 (traverse_grid_shadow)
// One lock-step trip is tens of launches and a host read in eager PyTorch,
// and the mesh's residual list (33,576 triangles at res=48) is thousands of
// [R, 512] blocks a call for the plain chunked battery; so each walk is one
// kernel, residual included.
//
// What they compute, per ray (bvh/grid.py): clip the ray to the grid's box,
// enter the cell of p + d * (t_enter + 1e-5), and step cell to cell
// (Amanatides-Woo), testing each cell's prims in slot order with the
// walks' leaf tests (csrc/walk_common.cuh). grid_closest keeps a prim where
// t < tfar strictly and stops once its best hit lies before the cell's exit
// (+1e-6) or it leaves the grid; then it runs the residual battery (the
// dense formulas of ops/intersect.py: the sphere candidate, or Baldwin-Weber
// on the residual triangles' planes, which the wrapper computes as the
// plain battery does), the first of the least t, which replaces the walk's
// hit where strictly closer. grid_occluded tests the residual first (a lane
// it occludes does not walk), then walks to its first hit with t in
// [0, tfar), stopping past tfar or out of the grid; a lane with tfar <= 0
// (or NaN) neither tests nor walks. A float cell coordinate converts to
// int32 truncating and saturating with NaN to 0 (XLA's convert, and
// __float2int_rz), then clips to [0, res - 1]. Both equal the plain
// versions bit for bit (the rounding contract of walk_common.cuh).
//
// Bound on an H100: per ray the walk reads its cells' id rows (64 B at
// K = 16) and the prims' rows, most from L2 (the res=32 sphere grid's table
// is 2 MiB, the mesh's res=48 table 6.75 MiB), and does about 40 FLOP a cell
// step plus a leaf test a slot (20 FLOP a sphere, about 50 a triangle); the
// residual battery adds about 40 FLOP per (ray, residual prim) pair. The
// least time is the larger of the ray bytes over the memory rate and this
// run's FLOP over the FP32 rate (chip_smoke.py counts them from the plain
// version). Design: one ray a thread, 128-thread blocks; the residual rows
// are read by every thread of a block in the same order (L1 broadcasts);
// neither is staged in shared memory, the first thing a redesign would do.

#include "walk_common.cuh"

namespace {

using walk::Candidate;
using walk::Leaf;
using walk::Ray;
using walk::dot3;
using walk::max_nan;
using walk::min_nan;

constexpr int kThreads = 128;
constexpr float kBig = 1e30f;

struct Rays {
  const float* c[6];  // px, py, pz, dx, dy, dz
};

struct Grid {
  const float* origin;     // [3]
  const float* inv_cell;   // [3]
  const float* cell_size;  // [3]
  const int32_t* cells;    // [res^3, K]
  const int32_t* count;    // [res^3]
  int res, k;
};

struct Residual {
  const int32_t* ids;   // [Rr] prim ids
  const float* planes;  // triangles: [Rr, 12] Baldwin-Weber planes
  int n;
};

// bvh/grid.py::_cell_index
__device__ __forceinline__ int cell_index(float x, int res) {
  x = x != x ? 0.0f : fminf(fmaxf(x, -1.0f), static_cast<float>(res));
  const int c = __float2int_rz(x);
  return min(max(c, 0), res - 1);
}

// The DDA state of one ray (bvh/grid.py::_setup).
struct Dda {
  int c[3], step[3];
  float tmax[3], tdelta[3];
  bool inside;
};

__device__ __forceinline__ Dda setup(const Grid& g, const Ray& r,
                                     bool shadow, float tfar) {
  const float p[3] = {r.px, r.py, r.pz};
  const float d[3] = {r.dx, r.dy, r.dz};
  float o[3], cs[3], inv[3], t0[3], t1[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = __ldg(g.origin + k);
    cs[k] = __ldg(g.cell_size + k);
    inv[k] = __ldg(g.inv_cell + k);
    const float hi = __fmaf_rn(cs[k], static_cast<float>(g.res), o[k]);
    const float dinv = __fdiv_rn(1.0f, d[k]);
    const float a = __fmul_rn(__fsub_rn(o[k], p[k]), dinv);
    const float b = __fmul_rn(__fsub_rn(hi, p[k]), dinv);
    t0[k] = min_nan(a, b);
    t1[k] = max_nan(a, b);
  }
  const float t_enter = max_nan(max_nan(t0[0], t0[1]), max_nan(t0[2], 0.0f));
  const float t_exit = min_nan(min_nan(t1[0], t1[1]), t1[2]);
  Dda s;
  s.inside = shadow ? (t_enter <= min_nan(t_exit, tfar) && tfar > 0.0f)
                    : t_enter <= t_exit;
  const float start = __fadd_rn(t_enter, 1e-5f);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    s.c[k] = cell_index(
        __fmul_rn(__fsub_rn(__fmaf_rn(d[k], start, p[k]), o[k]), inv[k]),
        g.res);
    s.step[k] = d[k] >= 0.0f ? 1 : -1;
    const float nb = __fmaf_rn(static_cast<float>(s.c[k] + (s.step[k] > 0)),
                               cs[k], o[k]);
    const bool moving = d[k] != 0.0f;
    s.tmax[k] = moving ? __fdiv_rn(__fsub_rn(nb, p[k]), d[k]) : kBig;
    s.tdelta[k] = moving ? fabsf(__fdiv_rn(cs[k], d[k])) : kBig;
  }
  return s;
}

// One DDA step; false once the ray leaves the grid.
__device__ __forceinline__ bool advance(Dda& s, int res) {
  const bool use_x = s.tmax[0] <= s.tmax[1] && s.tmax[0] <= s.tmax[2];
  const bool use_y = !use_x && s.tmax[1] <= s.tmax[2];
  const int k = use_x ? 0 : (use_y ? 1 : 2);
  s.c[k] += s.step[k];
  s.tmax[k] = __fadd_rn(s.tmax[k], s.tdelta[k]);
  return s.c[k] >= 0 && s.c[k] < res;
}

__device__ __forceinline__ int flat_cell(const Dda& s, int res) {
  const int f = (s.c[0] * res + s.c[1]) * res + s.c[2];
  return min(max(f, 0), res * res * res - 1);
}

__device__ __forceinline__ float exit_t(const Dda& s) {
  return min_nan(min_nan(s.tmax[0], s.tmax[1]), s.tmax[2]);
}

// The residual candidate of one prim: the dense batteries' formulas,
// FLT_MAX where the ray misses.
template <bool kTriangles>
struct Dense;

template <>
struct Dense<false> {  // ops/kernels/sphere_battery.py::sphere_candidates
  static __device__ __forceinline__ float t(const Ray& r, const float* rows,
                                            const Residual& res, int j) {
    const float4 s = __ldg(reinterpret_cast<const float4*>(rows) +
                           __ldg(res.ids + j));
    const Candidate c = walk::sphere_t(r, s);
    return c.ok ? c.t : FLT_MAX;
  }
};

template <>
struct Dense<true> {  // ops/kernels/cluster_traverse.py::_triangle_battery
  static __device__ __forceinline__ float t(const Ray& r, const float*,
                                            const Residual& res, int j) {
    const float4* pl = reinterpret_cast<const float4*>(res.planes) + 3 * j;
    const float4 a = __ldg(pl), b = __ldg(pl + 1), c = __ldg(pl + 2);
    // a = (n.xyz, d0), b = (f1.xyz, g1), c = (f2.xyz, g2)
    const float den = dot3(a.x, a.y, a.z, r.dx, r.dy, r.dz);
    const float num = __fsub_rn(a.w, dot3(a.x, a.y, a.z, r.px, r.py, r.pz));
    const float t = __fdiv_rn(num, den);
    const float qx = __fmaf_rn(t, r.dx, r.px);
    const float qy = __fmaf_rn(t, r.dy, r.py);
    const float qz = __fmaf_rn(t, r.dz, r.pz);
    const float u = __fadd_rn(dot3(b.x, b.y, b.z, qx, qy, qz), b.w);
    const float v = __fadd_rn(dot3(c.x, c.y, c.z, qx, qy, qz), c.w);
    const bool valid = fabsf(den) > 1e-12f && u >= 0.0f && v >= 0.0f &&
                       __fadd_rn(u, v) <= 1.0f && t > 1e-6f;
    return valid ? t : FLT_MAX;
  }
};

template <bool kTriangles>
__global__ void __launch_bounds__(kThreads)
    closest_kernel(Rays rays, const float* tfar0, Grid g, const float* rows,
                   Residual res, int n_rays, float* tfar_out,
                   int32_t* prim_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = walk::load_ray(rays.c, i);
  float tfar = tfar0 != nullptr ? tfar0[i] : FLT_MAX;
  int32_t prim_id = -1;
  Dda s = setup(g, r, false, tfar);
  bool active = s.inside;
  while (active) {
    const int cell = flat_cell(s, g.res);
    const int count = __ldg(g.count + cell);
    const int32_t* ids = g.cells + static_cast<long long>(cell) * g.k;
    for (int k = 0; k < g.k && k < count; ++k) {
      const int prim = __ldg(ids + k);
      if (prim < 0) continue;
      const Candidate c = Leaf<kTriangles>::test(r, rows, prim);
      if (c.ok && c.t < tfar) {
        tfar = c.t;
        prim_id = prim;
      }
    }
    const bool done = prim_id >= 0 && tfar <= __fadd_rn(exit_t(s), 1e-6f);
    active = advance(s, g.res) && !done;
  }
  // the residual battery: the first of the least t, replacing the walk's
  // hit where strictly closer
  float best = FLT_MAX;
  int arg = -1;
  for (int j = 0; j < res.n; ++j) {
    const float t = Dense<kTriangles>::t(r, rows, res, j);
    if (t < best) {
      best = t;
      arg = j;
    }
  }
  if (arg >= 0 && best < tfar) {
    tfar = best;
    prim_id = __ldg(res.ids + arg);
  }
  tfar_out[i] = tfar;
  prim_out[i] = prim_id;
}

template <bool kTriangles>
__global__ void __launch_bounds__(kThreads)
    occluded_kernel(Rays rays, const float* tfar_in, Grid g,
                    const float* rows, Residual res, int n_rays,
                    uint8_t* occ_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  const float tfar = tfar_in[i];
  const Ray r = walk::load_ray(rays.c, i);
  bool occluded = false;
  // residual first: some prim whose candidate is below FLT_MAX and tfar
  for (int j = 0; j < res.n && !occluded; ++j) {
    const float t = Dense<kTriangles>::t(r, rows, res, j);
    occluded = t < FLT_MAX && t < tfar && t >= 0.0f;
  }
  if (!occluded) {
    Dda s = setup(g, r, true, tfar);
    bool active = s.inside;
    while (active) {
      const int cell = flat_cell(s, g.res);
      const int count = __ldg(g.count + cell);
      const int32_t* ids = g.cells + static_cast<long long>(cell) * g.k;
      for (int k = 0; k < g.k && k < count && !occluded; ++k) {
        const int prim = __ldg(ids + k);
        if (prim < 0) continue;
        const Candidate c = Leaf<kTriangles>::test(r, rows, prim);
        occluded = c.ok && c.t < tfar && c.t >= 0.0f;
      }
      const bool past_far = exit_t(s) > tfar;
      active = advance(s, g.res) && !occluded && !past_far;
    }
  }
  occ_out[i] = occluded ? 1 : 0;
}

int blocks_for(int n_rays) { return (n_rays + kThreads - 1) / kThreads; }

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 = launched). `triangles`: 0 sphere rows [P, 4], 1 triangle rows
// [T, 9] (then `planes` is the residual's [Rr, 12] Baldwin-Weber table).
// `tfar0` may be null (FLT_MAX).
extern "C" int grid_closest(const float* px, const float* py, const float* pz,
                            const float* dx, const float* dy, const float* dz,
                            const float* tfar0, const float* origin,
                            const float* inv_cell, const float* cell_size,
                            const int32_t* cells, const int32_t* cell_count,
                            int res, int k, const float* rows, int triangles,
                            const int32_t* residual, const float* planes,
                            int n_residual, int n_rays, float* tfar_out,
                            int32_t* prim_out, void* stream) {
  if (n_rays > 0) {
    const Rays rays{{px, py, pz, dx, dy, dz}};
    const Grid g{origin, inv_cell, cell_size, cells, cell_count, res, k};
    const Residual rr{residual, planes, n_residual};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (triangles) {
      closest_kernel<true><<<blocks_for(n_rays), kThreads, 0, s>>>(
          rays, tfar0, g, rows, rr, n_rays, tfar_out, prim_out);
    } else {
      closest_kernel<false><<<blocks_for(n_rays), kThreads, 0, s>>>(
          rays, tfar0, g, rows, rr, n_rays, tfar_out, prim_out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int grid_occluded(const float* px, const float* py,
                             const float* pz, const float* dx,
                             const float* dy, const float* dz,
                             const float* tfar, const float* origin,
                             const float* inv_cell, const float* cell_size,
                             const int32_t* cells, const int32_t* cell_count,
                             int res, int k, const float* rows, int triangles,
                             const int32_t* residual, const float* planes,
                             int n_residual, int n_rays, uint8_t* occ_out,
                             void* stream) {
  if (n_rays > 0) {
    const Rays rays{{px, py, pz, dx, dy, dz}};
    const Grid g{origin, inv_cell, cell_size, cells, cell_count, res, k};
    const Residual rr{residual, planes, n_residual};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (triangles) {
      occluded_kernel<true><<<blocks_for(n_rays), kThreads, 0, s>>>(
          rays, tfar, g, rows, rr, n_rays, occ_out);
    } else {
      occluded_kernel<false><<<blocks_for(n_rays), kThreads, 0, s>>>(
          rays, tfar, g, rows, rr, n_rays, occ_out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
