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
// entry point that launches the walk and the residual battery as kernels.
//
// What they compute, per ray (bvh/grid.py): clip the ray to the grid's box,
// enter the cell of p + d * (t_enter + 1e-5), and step cell to cell
// (Amanatides-Woo), testing each cell's prims in slot order with the
// walks' leaf tests (csrc/walk_common.cuh). grid_closest keeps a prim where
// t < tfar strictly and stops once its best hit lies before the cell's exit
// (+1e-6) or it leaves the grid; then it runs the residual battery (the
// dense formulas of ops/intersect.py: the sphere candidate, its disc
// rounded as the plain battery's chunks round it, or Baldwin-Weber on the
// residual triangles' planes, which the wrapper computes as the plain
// battery does), the first of the least t, which replaces the walk's hit
// where strictly closer. grid_occluded tests the residual first (a lane it
// occludes does not walk), then walks to its first hit with t in [0, tfar),
// stopping past tfar or out of the grid; a lane with tfar <= 0 (or NaN)
// neither tests nor walks. A float cell coordinate converts to int32
// truncating and saturating with NaN to 0 (XLA's convert, and
// __float2int_rz), then clips to [0, res - 1]. Both equal the plain
// versions bit for bit (the rounding contract of walk_common.cuh).
//
// Bound on an H100: per ray the walk reads its cells' id rows (64 B at
// K = 16) and the prims' rows, most from L2 (the res=32 sphere grid's table
// is 2 MiB, the mesh's res=48 table 6.75 MiB), and does about 40 FLOP a cell
// step plus a leaf test a slot (20 FLOP a sphere, about 50 a triangle); the
// residual battery adds 20 (sphere) or 38 (triangle) operations per (ray,
// residual prim) pair, the any-hit form up to each lane's first occluder.
// The least time is the larger of the ray bytes over the memory rate and
// this run's operations over the FP32 rate (chip_smoke.py counts them from
// the plain version). With a residual list of thousands (the mesh's), the
// pairs are nearly all of it: 2^16 rays x 33,576 triangles are 2.2e9 pairs.
//
// Design. The walk: one ray a thread, 128-thread blocks (walk_kernel). The
// residual battery is a kernel of its own (residual_closest /
// residual_occluded): a block takes a tile of 512 rays, 4 a thread in
// registers, and one slice of the residual list, which it stages through
// shared memory in tiles of 128 rows (a triangle's three Baldwin-Weber
// float4 planes, or a sphere's float4) in a double-buffered ring filled by
// cp.async; every thread reads each staged row as a broadcast and tests it
// against its 4 rays, four independent chains that hide each other's
// latency. The wrapper splits the residual into S slices so that rays x
// slices fill the card when rays are few (residual_split in
// ops/kernels/grid_walk.py: at least 16 blocks an SM, slices of at least 4
// tiles). grid_closest runs the walk first and seeds each ray's residual
// search with the walk's tfar (a residual candidate at t >= tfar never
// replaces the walk's hit, so the bits are those of the unseeded search);
// with S > 1 each slice writes its (t, first index) and merge_kernel takes
// them in slice order with a strict `<`, the first of the least t.
// grid_occluded runs the residual first; each slice writes its OR, and the
// walk ORs the slices and walks only the lanes they leave; a block stops
// staging once all its rays are occluded or disabled (__syncthreads_or).
// Every pair's t comes from the same __fmaf_rn / __fdiv_rn sequence as the
// plain version's, and no pair is skipped. The walk's DDA state stays in
// registers (advance).
//
// What holds the battery (ptxas -v and the SASS): the inner loop issues
// about 42 instructions a triangle pair, 10 of them the correctly rounded
// division (MUFU.RCP, five FFMA, FCHK, and BSSY / BRA / BSYNC around its
// slow path); the bound counts 38 operations, 23 instructions with a
// multiply-add as one, so the pairs' issue alone is about twice the bound.
// Tried and dropped (PERF.md section 6): skipping the division where the
// plane crossing provably cannot beat the ray's best, per ray (a branch
// per ray splits the four rays' chains) and per warp (a vote: it skips
// some of the camera rays' triangles, none of incoherent rays', and is
// slower there); 2 and 8 rays a thread; a cap of 4 blocks an SM.

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
constexpr int kRpt = 4;                    // rays a thread of the battery
constexpr int kRayTile = kThreads * kRpt;  // rays a battery block
constexpr int kTile = 128;                 // residual rows a staged tile

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

// The residual list as its battery reads it: the prim ids and a table of
// float4 rows in residual order, one a sphere (cx, cy, cz, r^2) or three a
// triangle (the Baldwin-Weber planes (n, d0), (f1, g1), (f2, g2)).
struct Residual {
  const int32_t* ids;   // [Rr] prim ids
  const float4* table;  // [Rr, 1 or 3] rows
  int n;
  int unfused_from;  // spheres: the first row whose disc rounds b*b alone
  int slice;         // rows of a block's slice, a multiple of kTile
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

// One step along axis K.
template <int K>
__device__ __forceinline__ bool step_axis(Dda& s, int res) {
  s.c[K] += s.step[K];
  s.tmax[K] = __fadd_rn(s.tmax[K], s.tdelta[K]);
  return s.c[K] >= 0 && s.c[K] < res;
}

// One DDA step; false once the ray leaves the grid. The axis is chosen by
// branches, so that the state's arrays are indexed by constants and stay
// in registers (an index computed at run time puts them on the stack).
__device__ __forceinline__ bool advance(Dda& s, int res) {
  if (s.tmax[0] <= s.tmax[1] && s.tmax[0] <= s.tmax[2]) {
    return step_axis<0>(s, res);
  }
  if (s.tmax[1] <= s.tmax[2]) return step_axis<1>(s, res);
  return step_axis<2>(s, res);
}

__device__ __forceinline__ int flat_cell(const Dda& s, int res) {
  const int f = (s.c[0] * res + s.c[1]) * res + s.c[2];
  return min(max(f, 0), res * res * res - 1);
}

__device__ __forceinline__ float exit_t(const Dda& s) {
  return min_nan(min_nan(s.tmax[0], s.tmax[1]), s.tmax[2]);
}


// ---------------------------------------------------------------------------
// The walk: one ray a thread
// ---------------------------------------------------------------------------

// The walk's closest hit: prims of the cells the ray crosses, kept where
// strictly below tfar.
template <bool kTriangles>
__device__ __forceinline__ void walk_closest(const Grid& g, const float* rows,
                                             const Ray& r, float& tfar,
                                             int32_t& prim_id) {
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
}

// Whether a prim of the cells the ray crosses lies at t in [0, tfar).
template <bool kTriangles>
__device__ __forceinline__ bool walk_occluded(const Grid& g, const float* rows,
                                              const Ray& r, float tfar) {
  bool occluded = false;
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
  return occluded;
}

// grid_closest's walk: tfar_out / prim_out get the walk's hit (tfar0, or
// FLT_MAX where tfar0 is null, and -1 where none is closer).
template <bool kTriangles>
__global__ void __launch_bounds__(kThreads)
    walk_closest_kernel(Rays rays, const float* tfar0, Grid g,
                        const float* rows, int n_rays, float* tfar_out,
                        int32_t* prim_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  const Ray r = walk::load_ray(rays.c, i);
  float tfar = tfar0 != nullptr ? tfar0[i] : FLT_MAX;
  int32_t prim_id = -1;
  walk_closest<kTriangles>(g, rows, r, tfar, prim_id);
  tfar_out[i] = tfar;
  prim_out[i] = prim_id;
}

// grid_occluded's walk, over the lanes that no slice of the residual
// battery occluded (res_occ [slices, n_rays], null without a residual).
template <bool kTriangles>
__global__ void __launch_bounds__(kThreads)
    walk_occluded_kernel(Rays rays, const float* tfar, Grid g,
                         const float* rows, int n_rays,
                         const uint8_t* res_occ, int slices,
                         uint8_t* occ_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  bool occluded = false;
  for (int s = 0; s < slices && !occluded; ++s) {
    occluded = res_occ[static_cast<long long>(s) * n_rays + i] != 0;
  }
  if (!occluded) {
    occluded = walk_occluded<kTriangles>(g, rows, walk::load_ray(rays.c, i),
                                         tfar[i]);
  }
  occ_out[i] = occluded ? 1 : 0;
}

// ---------------------------------------------------------------------------
// The residual battery: 4 rays a thread against staged tiles of rows
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Start copying rows [start, start + n) of the table, W float4 a row, into
// `dst` (one cp.async group a thread).
template <int W>
__device__ __forceinline__ void stage_rows(float4* dst, const float4* table,
                                           int start, int n) {
  const float4* src = table + static_cast<long long>(start) * W;
  for (int q = threadIdx.x; q < n * W; q += kThreads) {
    cp_async16(dst + q, src + q);
  }
  cp_async_commit();
}

// The dense sphere candidate (ops/kernels/sphere_battery.py::
// sphere_candidates): the nearest root >= 0 where disc >= 0. kAlone rounds
// b*b on its own before adding it to disc, as the plain battery rounds a
// 5-8-wide chunk (core/fp.py::xla_fuses_sphere_bb).
template <bool kAlone>
__device__ __forceinline__ Candidate dense_sphere(const Ray& r, float4 s) {
  const float tx = __fsub_rn(s.x, r.px);
  const float ty = __fsub_rn(s.y, r.py);
  const float tz = __fsub_rn(s.z, r.pz);
  const float b = dot3(r.dx, r.dy, r.dz, tx, ty, tz);
  const float rest = __fsub_rn(s.w, dot3(tx, ty, tz, tx, ty, tz));
  const float disc = kAlone ? __fadd_rn(rest, __fmul_rn(b, b))
                            : __fmaf_rn(b, b, rest);
  const float sq = __fsqrt_rn(max_nan(disc, 0.0f));
  const float t_near = __fsub_rn(b, sq);
  const float t = t_near < 0.0f ? __fadd_rn(b, sq) : t_near;
  return Candidate{t, disc >= 0.0f && t >= 0.0f};
}

// The dense triangle candidate (ops/kernels/cluster_traverse.py::
// _triangle_battery) on a = (n, d0), b = (f1, g1), c = (f2, g2).
__device__ __forceinline__ Candidate dense_triangle(const Ray& r, float4 a,
                                                    float4 b, float4 c) {
  const float den = dot3(a.x, a.y, a.z, r.dx, r.dy, r.dz);
  const float num = __fsub_rn(a.w, dot3(a.x, a.y, a.z, r.px, r.py, r.pz));
  const float t = __fdiv_rn(num, den);
  const float qx = __fmaf_rn(t, r.dx, r.px);
  const float qy = __fmaf_rn(t, r.dy, r.py);
  const float qz = __fmaf_rn(t, r.dz, r.pz);
  const float u = __fadd_rn(dot3(b.x, b.y, b.z, qx, qy, qz), b.w);
  const float v = __fadd_rn(dot3(c.x, c.y, c.z, qx, qy, qz), c.w);
  return Candidate{t, fabsf(den) > 1e-12f && u >= 0.0f && v >= 0.0f &&
                          __fadd_rn(u, v) <= 1.0f && t > 1e-6f};
}

// The rays of this thread in a battery block: i0 + k * kThreads, k < kRpt.
__device__ __forceinline__ int battery_ray(int k) {
  return blockIdx.x * kRayTile + k * kThreads + threadIdx.x;
}

// Calls visit(tile, start, n) for each staged tile of the block's slice,
// tiles double-buffered and filled by cp.async. `more()` is called after
// each tile by every thread (a barrier itself, or after one): false stops
// the sweep.
template <int W, typename Visit, typename More>
__device__ __forceinline__ void sweep_slice(const Residual& res,
                                            float4 (*ring)[kTile * 3],
                                            Visit visit, More more) {
  const int j0 = blockIdx.y * res.slice;
  const int j1 = min(res.n, j0 + res.slice);
  const int tiles = (j1 - j0 + kTile - 1) / kTile;
  if (tiles > 0) stage_rows<W>(ring[0], res.table, j0, min(kTile, j1 - j0));
  for (int t = 0; t < tiles; ++t) {
    const int start = j0 + t * kTile;
    if (t + 1 < tiles) {
      stage_rows<W>(ring[(t + 1) & 1], res.table, start + kTile,
                    min(kTile, j1 - start - kTile));
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t has landed for every thread
    visit(ring[t & 1], start, min(kTile, j1 - start));
    // every thread is done with tile t before tile t + 2 takes its buffer
    if (!more()) break;
  }
  cp_async_wait<0>();
}

// The closest-hit battery over one slice: each ray's search starts from
// the walk's tfar (tfar_io; +inf as FLT_MAX, which the plain battery's
// misses equal and never beat), the first of the least t strictly below
// it. One slice: the hit replaces tfar_io / prim_io; else the slice's (t,
// first index or -1) go to part_t / part_arg [slices, n_rays].
template <bool kTriangles>
__global__ void __launch_bounds__(kThreads)
    residual_closest_kernel(Rays rays, Residual res, int n_rays,
                            float* tfar_io, int32_t* prim_io, float* part_t,
                            int32_t* part_arg) {
  __shared__ __align__(16) float4 ring[2][kTile * 3];
  Ray r[kRpt];
  float best[kRpt];
  int arg[kRpt];
#pragma unroll
  for (int k = 0; k < kRpt; ++k) {
    const int i = battery_ray(k);
    r[k] = Ray{};
    best[k] = 0.0f;  // a lane past n_rays: no candidate lies below 0
    arg[k] = -1;
    if (i < n_rays) {
      r[k] = walk::load_ray(rays.c, i);
      const float seed = tfar_io[i];
      best[k] = seed > FLT_MAX ? FLT_MAX : seed;
    }
  }
  auto visit = [&](const float4* tile, int start, int n) {
    if constexpr (kTriangles) {
      for (int j = 0; j < n; ++j) {
        const float4 a = tile[3 * j], b = tile[3 * j + 1],
                     c = tile[3 * j + 2];
#pragma unroll
        for (int k = 0; k < kRpt; ++k) {
          const Candidate h = dense_triangle(r[k], a, b, c);
          if (h.ok && h.t < best[k]) {  // strict: the first occurrence wins
            best[k] = h.t;
            arg[k] = start + j;
          }
        }
      }
    } else {
      const int fused = min(n, max(res.unfused_from - start, 0));
      for (int j = 0; j < fused; ++j) {
        const float4 s = tile[j];
#pragma unroll
        for (int k = 0; k < kRpt; ++k) {
          const Candidate h = dense_sphere<false>(r[k], s);
          if (h.ok && h.t < best[k]) {
            best[k] = h.t;
            arg[k] = start + j;
          }
        }
      }
      for (int j = fused; j < n; ++j) {
        const float4 s = tile[j];
#pragma unroll
        for (int k = 0; k < kRpt; ++k) {
          const Candidate h = dense_sphere<true>(r[k], s);
          if (h.ok && h.t < best[k]) {
            best[k] = h.t;
            arg[k] = start + j;
          }
        }
      }
    }
  };
  auto more = [] {
    __syncthreads();
    return true;
  };
  sweep_slice<kTriangles ? 3 : 1>(res, ring, visit, more);
#pragma unroll
  for (int k = 0; k < kRpt; ++k) {
    const int i = battery_ray(k);
    if (i >= n_rays) continue;
    if (gridDim.y == 1) {
      if (arg[k] >= 0) {
        tfar_io[i] = best[k];
        prim_io[i] = __ldg(res.ids + arg[k]);
      }
    } else {
      const long long o = static_cast<long long>(blockIdx.y) * n_rays + i;
      part_t[o] = best[k];
      part_arg[o] = arg[k];
    }
  }
}

// The slices' partial hits merged in slice order with a strict `<` (the
// first of the least t), replacing the walk's where closer.
__global__ void __launch_bounds__(kThreads)
    merge_kernel(int n_rays, int slices, const float* part_t,
                 const int32_t* part_arg, const int32_t* ids, float* tfar_io,
                 int32_t* prim_io) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rays) return;
  const float seed = tfar_io[i];
  float best = seed > FLT_MAX ? FLT_MAX : seed;
  int arg = -1;
  for (int s = 0; s < slices; ++s) {
    const long long o = static_cast<long long>(s) * n_rays + i;
    const int a = part_arg[o];
    if (a >= 0 && part_t[o] < best) {
      best = part_t[o];
      arg = a;
    }
  }
  if (arg >= 0) {
    tfar_io[i] = best;
    prim_io[i] = __ldg(ids + arg);
  }
}

// The any-hit battery over one slice: part_occ [slices, n_rays] gets
// whether a row of the slice has a candidate below FLT_MAX and tfar (every
// candidate is >= 0). A lane with tfar <= 0 or NaN never is; the block
// stops staging once none of its lanes is left (__syncthreads_or).
template <bool kTriangles>
__global__ void __launch_bounds__(kThreads)
    residual_occluded_kernel(Rays rays, const float* tfar, Residual res,
                             int n_rays, uint8_t* part_occ) {
  __shared__ __align__(16) float4 ring[2][kTile * 3];
  Ray r[kRpt];
  float tf[kRpt];
  bool hit[kRpt];
#pragma unroll
  for (int k = 0; k < kRpt; ++k) {
    const int i = battery_ray(k);
    r[k] = Ray{};
    tf[k] = 0.0f;
    hit[k] = false;
    if (i < n_rays) {
      r[k] = walk::load_ray(rays.c, i);
      tf[k] = tfar[i];
    }
  }
  auto occludes = [&](const Candidate& h, int k) {
    return h.ok && h.t < FLT_MAX && h.t < tf[k] && h.t >= 0.0f;
  };
  auto visit = [&](const float4* tile, int start, int n) {
    if constexpr (kTriangles) {
      for (int j = 0; j < n; ++j) {
        const float4 a = tile[3 * j], b = tile[3 * j + 1],
                     c = tile[3 * j + 2];
#pragma unroll
        for (int k = 0; k < kRpt; ++k) {
          if (occludes(dense_triangle(r[k], a, b, c), k)) hit[k] = true;
        }
      }
    } else {
      const int fused = min(n, max(res.unfused_from - start, 0));
      for (int j = 0; j < n; ++j) {
        const float4 s = tile[j];
#pragma unroll
        for (int k = 0; k < kRpt; ++k) {
          const Candidate h = j < fused ? dense_sphere<false>(r[k], s)
                                        : dense_sphere<true>(r[k], s);
          if (occludes(h, k)) hit[k] = true;
        }
      }
    }
  };
  auto more = [&] {
    bool left = false;
#pragma unroll
    for (int k = 0; k < kRpt; ++k) left = left || (tf[k] > 0.0f && !hit[k]);
    return __syncthreads_or(left) != 0;
  };
  if (more()) sweep_slice<kTriangles ? 3 : 1>(res, ring, visit, more);
#pragma unroll
  for (int k = 0; k < kRpt; ++k) {
    const int i = battery_ray(k);
    if (i < n_rays) {
      part_occ[static_cast<long long>(blockIdx.y) * n_rays + i] = hit[k];
    }
  }
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

template <bool kTriangles>
void launch_closest(Rays rays, const float* tfar0, Grid g, const float* rows,
                    Residual res, int slices, float* part_t,
                    int32_t* part_arg, int n_rays, float* tfar_out,
                    int32_t* prim_out, cudaStream_t s) {
  walk_closest_kernel<kTriangles><<<blocks_for(n_rays), kThreads, 0, s>>>(
      rays, tfar0, g, rows, n_rays, tfar_out, prim_out);
  if (res.n == 0) return;
  const dim3 grid((n_rays + kRayTile - 1) / kRayTile, slices);
  residual_closest_kernel<kTriangles><<<grid, kThreads, 0, s>>>(
      rays, res, n_rays, tfar_out, prim_out, part_t, part_arg);
  if (slices > 1) {
    merge_kernel<<<blocks_for(n_rays), kThreads, 0, s>>>(
        n_rays, slices, part_t, part_arg, res.ids, tfar_out, prim_out);
  }
}

template <bool kTriangles>
void launch_occluded(Rays rays, const float* tfar, Grid g, const float* rows,
                     Residual res, int slices, uint8_t* part_occ, int n_rays,
                     uint8_t* occ_out, cudaStream_t s) {
  if (res.n > 0) {
    const dim3 grid((n_rays + kRayTile - 1) / kRayTile, slices);
    residual_occluded_kernel<kTriangles><<<grid, kThreads, 0, s>>>(
        rays, tfar, res, n_rays, part_occ);
  }
  walk_occluded_kernel<kTriangles><<<blocks_for(n_rays), kThreads, 0, s>>>(
      rays, tfar, g, rows, n_rays, res.n > 0 ? part_occ : nullptr,
      res.n > 0 ? slices : 0, occ_out);
}

}  // namespace

// Each entry point launches on `stream` and returns cudaGetLastError()
// (0 = launched). `triangles`: 0 sphere rows [P, 4], 1 triangle rows
// [T, 9]. The residual: `residual` its prim ids, `table` its rows ([Rr, 4]
// spheres, [Rr, 12] triangle planes, 16-byte aligned), `unfused_from` the
// first sphere row whose disc rounds b*b alone; the battery takes it in
// `slices` slices of `slice_rows` rows (a multiple of 128) with scratch
// part_t / part_arg ([slices, n_rays], used where slices > 1) or part_occ
// ([slices, n_rays]). `tfar0` may be null (FLT_MAX).
extern "C" int grid_closest(const float* px, const float* py, const float* pz,
                            const float* dx, const float* dy, const float* dz,
                            const float* tfar0, const float* origin,
                            const float* inv_cell, const float* cell_size,
                            const int32_t* cells, const int32_t* cell_count,
                            int res, int k, const float* rows, int triangles,
                            const int32_t* residual, const float* table,
                            int n_residual, int unfused_from, int slices,
                            int slice_rows, float* part_t, int32_t* part_arg,
                            int n_rays, float* tfar_out, int32_t* prim_out,
                            void* stream) {
  if (n_rays > 0) {
    const Rays rays{{px, py, pz, dx, dy, dz}};
    const Grid g{origin, inv_cell, cell_size, cells, cell_count, res, k};
    const Residual rr{residual, reinterpret_cast<const float4*>(table),
                      n_residual, unfused_from, slice_rows};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (triangles) {
      launch_closest<true>(rays, tfar0, g, rows, rr, slices, part_t, part_arg,
                           n_rays, tfar_out, prim_out, s);
    } else {
      launch_closest<false>(rays, tfar0, g, rows, rr, slices, part_t,
                            part_arg, n_rays, tfar_out, prim_out, s);
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
                             const int32_t* residual, const float* table,
                             int n_residual, int unfused_from, int slices,
                             int slice_rows, uint8_t* part_occ, int n_rays,
                             uint8_t* occ_out, void* stream) {
  if (n_rays > 0) {
    const Rays rays{{px, py, pz, dx, dy, dz}};
    const Grid g{origin, inv_cell, cell_size, cells, cell_count, res, k};
    const Residual rr{residual, reinterpret_cast<const float4*>(table),
                      n_residual, unfused_from, slice_rows};
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (triangles) {
      launch_occluded<true>(rays, tfar, g, rows, rr, slices, part_occ, n_rays,
                            occ_out, s);
    } else {
      launch_occluded<false>(rays, tfar, g, rows, rr, slices, part_occ,
                             n_rays, occ_out, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
