// Clustered traversal of the PyTorch port, for Hopper (sm_90a): the per-tile
// cluster planner and the two cluster walks of the large-scene path
// (accel='pallas').
//
// Replaces the TPU kernels of the JAX package's
// ops/pallas/traverse_kernel.py:
//   cluster_plan     <- _make_plan_kernel(sort_in_kernel=True), the flat
//                       'ray' plan (driven by _plan_visits)
//   cluster_closest  <- _make_closest_kernel with _sphere_battery /
//                       _triangle_battery (driven by
//                       intersect_clustered_pallas)
//   cluster_occluded <- _make_shadow_kernel with _sphere_anyhit_battery /
//                       _triangle_anyhit_battery (driven by
//                       occluded_clustered_pallas)
//
// What they compute. Rays are cut into tiles of tile_r consecutive rays; one
// thread block works on one tile.
//   cluster_plan: for every cluster box, the least slab entry distance over
//   the tile's valid rays (FLT_MAX where no valid ray enters it before its
//   tfar), then the tile's entered clusters sorted front to back, the lowest
//   cluster id first among equal entries. Outputs the sorted entries, the
//   cluster ids in that order and their number nvis; positions at or past
//   nvis hold FLT_MAX and -1 and are never read.
//   cluster_closest: every valid ray's nearest primitive over the tile's
//   visit list, walked while the next entry is below the tile's exit bound
//   mx = max over valid lanes of min(current tfar, exit distance from the
//   root box). A candidate replaces the running hit only if strictly nearer,
//   so the first primitive in (visit order, slot order) keeps a tie. Returns
//   (tfar, cluster * K + slot), or (tfar0, -1).
//   cluster_occluded: whether any primitive lies at t in [0, tfar); lanes
//   with tfar <= 0 are invalid and never occluded; the walk ends when every
//   valid lane is occluded (mx drops to -FLT_MAX).
// Skipping a cluster whose entry is at or beyond mx cannot change a result,
// and a stale mx is only larger, so any refresh schedule gives the same
// output. These kernels refresh mx after every visit, which walks the fewest
// clusters.
//
// Rounding contract: bit-equal to the plain PyTorch versions in
// ops/kernels/cluster_traverse.py on the card, as in sphere_battery.cu:
// fma32 for the multiply-adds that XLA fuses in the JAX package, the _rn
// intrinsics (never contracted by nvcc) and IEEE division and square root
// for the rest. Build without --use_fast_math.
// NaN: jnp.minimum / torch.minimum propagate NaN and fminf does not. In the
// slab test a NaN (0 * inf: a zero direction component with the origin on
// that box face) reaches tmin and tmax whichever operand it starts in, and
// the comparison `tmax >= entry` is then false: the ray does not enter the
// box. So slab() uses fminf/fmaxf and reports separately whether any of the
// six products was NaN.
//
// Bound on an H100. The planner does tile_r x C slab tests per tile (about
// 25 operations each) and writes 8 bytes per (tile, cluster): operations
// bind it from a few hundred clusters on. The walks read each visited
// cluster's rows once per tile (16 B per sphere, 48 B per triangle) and do
// 20 (spheres) or about 35 (triangles) operations per (ray, primitive) pair,
// the multiply-adds among them in double: operations bind them.
//
// The simple design. Planner: the tile's rays (origin, 1/direction, tfar)
// are staged in shared memory; each thread owns clusters c, c + 256, ... and
// loops over the staged rays, which every thread reads at the same address
// (a broadcast). Entered clusters are compacted into 64-bit keys (entry bits
// << 32 | cluster id: entries are non-negative, so they order as unsigned
// integers) and sorted by a bitonic network in shared memory. Walks: one
// thread per ray with its ray in registers; the visited cluster's rows are
// staged in shared memory as float4 and read by broadcast; the exit bound is
// a block-wide max through warp shuffles. Warp-level culling inside a tile,
// several clusters per staging step and tensor-core batteries are later
// work.

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPlanThreads = 256;

// core/fp.py's fma: the product is exact in double, the sum rounds to
// double and then to float.
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(
      __fma_rn(static_cast<double>(a), static_cast<double>(b),
               static_cast<double>(c)));
}

// ax*bx + ay*by + az*bz as XLA contracts it: fma(z, z', fma(x, x', y*y')).
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return fma32(az, bz, fma32(ax, bx, __fmul_rn(ay, by)));
}

struct Ray {
  float px, py, pz, dx, dy, dz;
};

struct Slab {
  float tmin, tmax;
  bool nan;  // one of the six products was NaN: the box is not entered
};

// The slab test of _tile_entry_row / _root_exit_bound, with the ray's
// reciprocal direction (ix, iy, iz) computed by the caller.
__device__ __forceinline__ Slab slab(float lox, float loy, float loz,
                                     float hix, float hiy, float hiz,
                                     float px, float py, float pz, float ix,
                                     float iy, float iz) {
  const float ax = __fmul_rn(__fsub_rn(lox, px), ix);
  const float bx = __fmul_rn(__fsub_rn(hix, px), ix);
  const float ay = __fmul_rn(__fsub_rn(loy, py), iy);
  const float by = __fmul_rn(__fsub_rn(hiy, py), iy);
  const float az = __fmul_rn(__fsub_rn(loz, pz), iz);
  const float bz = __fmul_rn(__fsub_rn(hiz, pz), iz);
  Slab s;
  s.tmin = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz));
  s.tmax = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
  s.nan = (ax != ax) || (bx != bx) || (ay != ay) || (by != by) ||
          (az != az) || (bz != bz);
  return s;
}

// _root_exit_bound: the ray's exit distance from the root box, padded by
// 1e-5, or 0 where it misses the box.
__device__ __forceinline__ float root_exit(const float* __restrict__ root,
                                           const Ray& r) {
  const Slab s = slab(root[0], root[1], root[2], root[3], root[4], root[5],
                      r.px, r.py, r.pz, __fdiv_rn(1.0f, r.dx),
                      __fdiv_rn(1.0f, r.dy), __fdiv_rn(1.0f, r.dz));
  const bool hit = !s.nan && s.tmax >= fmaxf(s.tmin, 0.0f);
  return hit ? __fmul_rn(s.tmax, 1.00001f) : 0.0f;
}

// Max of v over the block, returned to every thread. s_red holds one float
// per warp.
__device__ __forceinline__ float block_max(float v, float* s_red) {
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  const int n_warps = (blockDim.x + 31) >> 5;
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = s_red[0];
  for (int w = 1; w < n_warps; ++w) m = fmaxf(m, s_red[w]);
  __syncthreads();  // s_red may be rewritten after this
  return m;
}

// ---------------------------------------------------------------------------
// cluster_plan
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kPlanThreads)
plan_kernel(const float* __restrict__ lox, const float* __restrict__ loy,
            const float* __restrict__ loz, const float* __restrict__ hix,
            const float* __restrict__ hiy, const float* __restrict__ hiz,
            const float* __restrict__ px, const float* __restrict__ py,
            const float* __restrict__ pz, const float* __restrict__ dx,
            const float* __restrict__ dy, const float* __restrict__ dz,
            const float* __restrict__ tf, const uint8_t* __restrict__ valid,
            int n_rays, int tile_r, int n_clusters, int n_keys,
            float* __restrict__ entry_out, int32_t* __restrict__ visit_out,
            int32_t* __restrict__ nvis_out) {
  extern __shared__ unsigned long long keys[];  // n_keys, then 7 ray rows
  float* rays = reinterpret_cast<float*>(keys + n_keys);
  float* spx = rays;
  float* spy = spx + tile_r;
  float* spz = spy + tile_r;
  float* six = spz + tile_r;
  float* siy = six + tile_r;
  float* siz = siy + tile_r;
  float* stf = siz + tile_r;
  __shared__ int s_count;

  const int tile = blockIdx.x;
  const int base = tile * tile_r;
  if (threadIdx.x == 0) s_count = 0;
  for (int i = threadIdx.x; i < tile_r; i += blockDim.x) {
    const int r = base + i;
    const bool ok = r < n_rays && valid[r] != 0;
    // an invalid lane never enters a box: entry >= 0 is never below tfar 0
    spx[i] = ok ? px[r] : 0.0f;
    spy[i] = ok ? py[r] : 0.0f;
    spz[i] = ok ? pz[r] : 0.0f;
    six[i] = ok ? __fdiv_rn(1.0f, dx[r]) : 1.0f;
    siy[i] = ok ? __fdiv_rn(1.0f, dy[r]) : 1.0f;
    siz[i] = ok ? __fdiv_rn(1.0f, dz[r]) : 1.0f;
    stf[i] = ok ? tf[r] : 0.0f;
  }
  __syncthreads();

  for (int c = threadIdx.x; c < n_clusters; c += blockDim.x) {
    const float lx = lox[c], ly = loy[c], lz = loz[c];
    const float hx = hix[c], hy = hiy[c], hz = hiz[c];
    float emin = FLT_MAX;
    for (int i = 0; i < tile_r; ++i) {
      const Slab s = slab(lx, ly, lz, hx, hy, hz, spx[i], spy[i], spz[i],
                          six[i], siy[i], siz[i]);
      const float entry = fmaxf(s.tmin, 0.0f);
      const bool hit = !s.nan && s.tmax >= entry && entry < stf[i];
      emin = fminf(emin, hit ? entry : FLT_MAX);
    }
    if (emin < FLT_MAX) {
      if (emin == 0.0f) emin = 0.0f;  // -0 would order last as an integer
      const int pos = atomicAdd(&s_count, 1);
      keys[pos] = (static_cast<unsigned long long>(__float_as_uint(emin))
                   << 32) | static_cast<unsigned int>(c);
    }
  }
  __syncthreads();
  const int n_vis = s_count;
  int n_sort = 1;
  while (n_sort < n_vis) n_sort <<= 1;
  for (int i = n_vis + threadIdx.x; i < n_sort; i += blockDim.x) {
    keys[i] = ~0ull;
  }
  __syncthreads();
  // bitonic sort, ascending: by entry, then by cluster id
  for (int k = 2; k <= n_sort; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n_sort; i += blockDim.x) {
        const int partner = i ^ j;
        if (partner > i) {
          const unsigned long long a = keys[i], b = keys[partner];
          const bool ascending = (i & k) == 0;
          if ((a > b) == ascending) {
            keys[i] = b;
            keys[partner] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  const size_t row = static_cast<size_t>(tile) * n_clusters;
  for (int i = threadIdx.x; i < n_clusters; i += blockDim.x) {
    const bool seen = i < n_vis;
    const unsigned long long key = seen ? keys[i] : 0ull;
    entry_out[row + i] =
        seen ? __uint_as_float(static_cast<unsigned int>(key >> 32)) : FLT_MAX;
    visit_out[row + i] =
        seen ? static_cast<int32_t>(key & 0xffffffffull) : -1;
  }
  if (threadIdx.x == 0) nvis_out[tile] = n_vis;
}

// ---------------------------------------------------------------------------
// Batteries: one ray against one staged primitive
// ---------------------------------------------------------------------------
// b = d . (c - p) and rsq - |c - p|^2 (sphere_battery.cu's pair_terms)
struct PairTerms {
  float b, rsq_minus_len2;
};

__device__ __forceinline__ PairTerms pair_terms(const Ray& r, float4 s) {
  const float tx = __fsub_rn(s.x, r.px);
  const float ty = __fsub_rn(s.y, r.py);
  const float tz = __fsub_rn(s.z, r.pz);
  const float b = dot3(r.dx, r.dy, r.dz, tx, ty, tz);
  const float len2 = dot3(tx, ty, tz, tx, ty, tz);
  return PairTerms{b, __fsub_rn(s.w, len2)};
}

// _sphere_battery: the near root, else the far root; FLT_MAX on a miss.
__device__ __forceinline__ float sphere_t(const Ray& r, float4 s) {
  const PairTerms pt = pair_terms(r, s);
  const float b = pt.b;
  const float disc = fma32(b, b, pt.rsq_minus_len2);
  const float sq = __fsqrt_rn(fmaxf(disc, 0.0f));
  const float t_near = __fsub_rn(b, sq);
  const float t = t_near < 0.0f ? __fadd_rn(b, sq) : t_near;
  return (disc >= 0.0f && t >= 0.0f) ? t : FLT_MAX;
}

// _sphere_anyhit_battery: the sqrt-free predicate. b*b has three uses, so
// it is not fused into disc.
__device__ __forceinline__ bool sphere_occludes(const Ray& r, float tf,
                                                float4 s) {
  const PairTerms pt = pair_terms(r, s);
  const float b = pt.b;
  const float bb = __fmul_rn(b, b);
  const float disc = __fadd_rn(pt.rsq_minus_len2, bb);
  const float e = __fsub_rn(b, tf);
  const float q = __fmul_rn(e, e);
  const bool near_ge0 = (b >= 0.0f) && (bb >= disc);
  const bool hit_near = (e < 0.0f) || (q < disc);
  const bool far_ge0 = (b >= 0.0f) || (bb <= disc);
  const bool hit_far = (e < 0.0f) && (disc < q);
  return disc >= 0.0f && (near_ge0 ? hit_near : (far_ge0 && hit_far));
}

// _triangle_battery (Baldwin-Weber planes): rows = (n, d0), (f1, g1),
// (f2, g2). u and v sum their three products as XLA contracts them and add
// g unfused.
__device__ __forceinline__ float triangle_t(const Ray& r, float4 n, float4 f1,
                                            float4 f2) {
  const float den = dot3(n.x, n.y, n.z, r.dx, r.dy, r.dz);
  const float num = __fsub_rn(n.w, dot3(n.x, n.y, n.z, r.px, r.py, r.pz));
  const float t = __fdiv_rn(num, den);
  const float qx = fma32(t, r.dx, r.px);
  const float qy = fma32(t, r.dy, r.py);
  const float qz = fma32(t, r.dz, r.pz);
  const float u = __fadd_rn(dot3(f1.x, f1.y, f1.z, qx, qy, qz), f1.w);
  const float v = __fadd_rn(dot3(f2.x, f2.y, f2.z, qx, qy, qz), f2.w);
  const bool valid = fabsf(den) > 1e-12f && u >= 0.0f && v >= 0.0f &&
                     __fadd_rn(u, v) <= 1.0f && t > 1e-6f;
  return valid ? t : FLT_MAX;
}

template <bool kTri>
__device__ __forceinline__ float prim_t(const Ray& r, const float4* rows,
                                        int k) {
  if (kTri) return triangle_t(r, rows[3 * k], rows[3 * k + 1], rows[3 * k + 2]);
  return sphere_t(r, rows[k]);
}

// Stage cluster c's rows (K prims of kRows float4 each) into shared memory.
template <bool kTri>
__device__ __forceinline__ void stage(float4* rows,
                                      const float4* __restrict__ table, int c,
                                      int k_prims) {
  const int n = k_prims * (kTri ? 3 : 1);
  const float4* src = table + static_cast<size_t>(c) * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) rows[k] = src[k];
}

__device__ __forceinline__ Ray load_ray(const float* px, const float* py,
                                        const float* pz, const float* dx,
                                        const float* dy, const float* dz,
                                        int i) {
  return Ray{px[i], py[i], pz[i], dx[i], dy[i], dz[i]};
}

// ---------------------------------------------------------------------------
// cluster_closest
// ---------------------------------------------------------------------------
template <bool kTri>
__global__ void closest_kernel(
    const int32_t* __restrict__ nvis, const int32_t* __restrict__ visit,
    const float* __restrict__ entry, const float* __restrict__ root,
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tf0, const uint8_t* __restrict__ valid,
    const float4* __restrict__ table, int n_rays, int n_clusters, int k_prims,
    float* __restrict__ tfar_out, int32_t* __restrict__ prim_out) {
  extern __shared__ float4 rows[];
  __shared__ float s_red[32];
  const int tile = blockIdx.x;
  const int i = tile * blockDim.x + threadIdx.x;
  const bool in_range = i < n_rays;
  const bool live = in_range && valid[i] != 0;
  Ray r{};
  float best = 0.0f;
  if (in_range) {
    r = load_ray(px, py, pz, dx, dy, dz, i);
    best = tf0[i];
  }
  const float bound = live ? fminf(best, root_exit(root, r)) : -FLT_MAX;
  float mx = block_max(bound, s_red);
  int32_t best_id = -1;
  const int n = nvis[tile];
  const size_t row = static_cast<size_t>(tile) * n_clusters;
  for (int j = 0; j < n; ++j) {
    if (!(entry[row + j] < mx)) break;  // uniform: mx is the block's
    const int c = visit[row + j];
    stage<kTri>(rows, table, c, k_prims);
    __syncthreads();
    if (live) {
      for (int k = 0; k < k_prims; ++k) {
        const float t = prim_t<kTri>(r, rows, k);
        if (t < best) {  // strict: the first occurrence keeps a tie
          best = t;
          best_id = c * k_prims + k;
        }
      }
    }
    // its two barriers also fence this visit's reads of `rows`
    mx = block_max(live ? fminf(best, bound) : -FLT_MAX, s_red);
  }
  if (in_range) {
    tfar_out[i] = best;
    prim_out[i] = best_id;
  }
}

// ---------------------------------------------------------------------------
// cluster_occluded
// ---------------------------------------------------------------------------
template <bool kTri>
__global__ void occluded_kernel(
    const int32_t* __restrict__ nvis, const int32_t* __restrict__ visit,
    const float* __restrict__ entry, const float* __restrict__ root,
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tfar, const float4* __restrict__ table,
    int n_rays, int n_clusters, int k_prims, uint8_t* __restrict__ occ_out) {
  extern __shared__ float4 rows[];
  __shared__ float s_red[32];
  const int tile = blockIdx.x;
  const int i = tile * blockDim.x + threadIdx.x;
  const bool in_range = i < n_rays;
  Ray r{};
  float tf = 0.0f;
  if (in_range) {
    r = load_ray(px, py, pz, dx, dy, dz, i);
    tf = tfar[i];
  }
  const bool live = in_range && tf > 0.0f;  // tfar <= 0 (or NaN): invalid
  const float bound = live ? fminf(tf, root_exit(root, r)) : -FLT_MAX;
  // the farthest a still-unoccluded lane can be hit: clusters entirely
  // beyond it cannot occlude
  float mx = block_max(bound, s_red);
  bool occ = false;
  const int n = nvis[tile];
  const size_t row = static_cast<size_t>(tile) * n_clusters;
  for (int j = 0; j < n; ++j) {
    if (!(entry[row + j] < mx)) break;
    const int c = visit[row + j];
    stage<kTri>(rows, table, c, k_prims);
    __syncthreads();
    if (live && !occ) {
      for (int k = 0; k < k_prims; ++k) {
        const bool hit = kTri ? prim_t<true>(r, rows, k) < tf
                              : sphere_occludes(r, tf, rows[k]);
        if (hit) {
          occ = true;
          break;
        }
      }
    }
    mx = block_max((live && !occ) ? bound : -FLT_MAX, s_red);
  }
  if (in_range) occ_out[i] = occ ? 1 : 0;
}

// Shared memory above 48 KB has to be asked for.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

}  // namespace

// C entry points, bound with ctypes. Each launches on `stream` and returns
// the first CUDA error (0 = launched). The wrappers in
// ops/kernels/cluster_traverse.py check shapes, types and sizes.
extern "C" int cluster_plan(
    const float* lox, const float* loy, const float* loz, const float* hix,
    const float* hiy, const float* hiz, const float* px, const float* py,
    const float* pz, const float* dx, const float* dy, const float* dz,
    const float* tf, const uint8_t* valid, int n_rays, int tile_r,
    int n_clusters, float* entry_out, int32_t* visit_out, int32_t* nvis_out,
    void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  int n_keys = 1;
  while (n_keys < n_clusters) n_keys <<= 1;
  const size_t shared = static_cast<size_t>(n_keys) * 8 +
                        static_cast<size_t>(tile_r) * 7 * sizeof(float);
  const cudaError_t err = allow_shared(plan_kernel, shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n_rays + tile_r - 1) / tile_r;
  plan_kernel<<<tiles, kPlanThreads, shared,
                static_cast<cudaStream_t>(stream)>>>(
      lox, loy, loz, hix, hiy, hiz, px, py, pz, dx, dy, dz, tf, valid, n_rays,
      tile_r, n_clusters, n_keys, entry_out, visit_out, nvis_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cluster_closest(
    const int32_t* nvis, const int32_t* visit, const float* entry,
    const float* root, const float* px, const float* py, const float* pz,
    const float* dx, const float* dy, const float* dz, const float* tf0,
    const uint8_t* valid, const float* table, int triangles, int n_rays,
    int tile_r, int n_clusters, int k_prims, float* tfar_out,
    int32_t* prim_out, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const size_t shared =
      static_cast<size_t>(k_prims) * (triangles ? 3 : 1) * sizeof(float4);
  auto kernel = triangles ? closest_kernel<true> : closest_kernel<false>;
  const cudaError_t err = allow_shared(kernel, shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n_rays + tile_r - 1) / tile_r;
  kernel<<<tiles, tile_r, shared, static_cast<cudaStream_t>(stream)>>>(
      nvis, visit, entry, root, px, py, pz, dx, dy, dz, tf0, valid,
      reinterpret_cast<const float4*>(table), n_rays, n_clusters, k_prims,
      tfar_out, prim_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cluster_occluded(
    const int32_t* nvis, const int32_t* visit, const float* entry,
    const float* root, const float* px, const float* py, const float* pz,
    const float* dx, const float* dy, const float* dz, const float* tfar,
    const float* table, int triangles, int n_rays, int tile_r, int n_clusters,
    int k_prims, uint8_t* occ_out, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const size_t shared =
      static_cast<size_t>(k_prims) * (triangles ? 3 : 1) * sizeof(float4);
  auto kernel = triangles ? occluded_kernel<true> : occluded_kernel<false>;
  const cudaError_t err = allow_shared(kernel, shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n_rays + tile_r - 1) / tile_r;
  kernel<<<tiles, tile_r, shared, static_cast<cudaStream_t>(stream)>>>(
      nvis, visit, entry, root, px, py, pz, dx, dy, dz, tfar,
      reinterpret_cast<const float4*>(table), n_rays, n_clusters, k_prims,
      occ_out);
  return static_cast<int>(cudaGetLastError());
}
