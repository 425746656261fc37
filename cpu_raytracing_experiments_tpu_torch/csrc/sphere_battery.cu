// Ray x sphere batteries of the PyTorch port, for Hopper (sm_90a).
//
// Replaces the TPU kernels of the JAX package:
//   sphere_closest  <- ops/pallas/sphere_kernel.py:_closest_kernel
//                      (driven by intersect_spheres_pallas)
//   sphere_occluded <- ops/pallas/sphere_kernel.py:_occluded_kernel
//                      (driven by occluded_spheres_pallas)
//
// What they compute. sphere_closest: per ray, the nearest sphere hit, taking
// the near root b - sqrt(disc), else the far root b + sqrt(disc); tfar =
// FLT_MAX and prim = -1 on a miss. Spheres are visited in index order with a
// strict `<`, so the first occurrence wins a tie, across staging chunks too.
// sphere_occluded: per ray, whether any sphere lies at t in [0, tfar), by the
// sqrt-free predicate of ops/intersect.py::_sphere_occluded_pairs; a lane
// with tfar <= 0 or NaN never occludes (the predicate is false there, so
// such lanes skip the loop).
//
// Rounding contract: both kernels equal the plain PyTorch versions in
// ops/kernels/sphere_battery.py bit for bit, on the card. PyTorch evaluates
// each elementwise op as its own kernel, rounded once, in the order the
// expression is written; the plain versions fuse the multiply-adds that XLA
// fuses in the JAX package, through core/fp.py's fma, which rounds once
// (the fma kernel of csrc/fma.cu on the card). This file evaluates the same
// operations in the same order: __fmaf_rn for those, and
// __fmul_rn/__fadd_rn/__fsub_rn, which nvcc never contracts, and IEEE
// __fsqrt_rn for the rest. Build without --use_fast_math.
//
// Bound on an H100. Per ray, closest reads 6 floats and writes tfar + prim
// (32 B); any-hit reads 7 floats and writes one byte (29 B). Per (ray, sphere)
// pair, closest does 19 FLOP and one sqrt, any-hit 19 FLOP, all in float32
// (the five or four multiply-adds among them as single-rounding FMAs). At
// the hero
// scene's 9 spheres the battery is bound by memory bytes (2^19 rays x 32 B =
// 16.8 MB, about 5 us at 3.35 TB/s); at 1000 spheres it is bound by FP32
// operations (262144 x 1000 pairs x 20 ops = 5.2 GFLOP, about 78 us at
// 67 TFLOP/s).
//
// sphere_closest: one ray a thread, its ray in registers. The sqrt and the
// root selection run only where disc >= 0 (false for NaN): the candidate
// elsewhere is FLT_MAX, which never passes the strict `<` against a best
// that starts at FLT_MAX, so skipping it changes no bit. Blocks stage the
// table through shared memory in chunks of 1024 spheres (16 KB) that the
// block's rays then read by broadcast (4 loads a sphere, against 15-30
// instructions a pair for each of the block's rays, so the table is not
// packed into 16-byte rows). The grid is at most one wave of blocks (the
// wrapper passes the card's SM count), grid-stride beyond it. Measured and
// dropped (PERF.md section 6): two and four rays a thread, slower at every
// shape (262,144 rays at 4 a thread are 15.5 warps an SM, too few to hide
// the pairs' latency); small tables read straight from device memory with
// no staging, faster only below the hero's 9 spheres.
//
// sphere_occluded: the same one-wave grid-stride grid of 128-thread blocks,
// one ray a thread. A table of one chunk (the hero's 9 spheres) is staged
// once a block, before its first trip, and read by every trip with no
// barrier; a larger one chunk by chunk, each trip, and a block stops
// staging once all its lanes are done (__syncthreads_or, reached by every
// thread on every trip). The pair tests disc >= 0 first, on a branch. The
// result is an OR over the table, so neither the order in which spheres are
// tested nor the pairs tested after a ray's first occluder change a bit:
// a lane sweeps a whole chunk, the loop unrolled 8 times with no exit test,
// and skips the chunks after the one where it found its occluder. A warp
// runs until its slowest lane is done in any case: the least work one ray
// a thread can do is the warp pairs (the sum over warps of 32 x the most
// pairs a lane of the warp needs), which chip_smoke.py reports beside the
// per-ray bound. Measured and dropped (PERF.md section 6): an exit test
// after every pair, every 8 or every 32 pairs, each lane's or the warp's
// (__any_sync); a warp-uniform branch on disc >= 0 (__any_sync); two rays a
// thread; the next trip's ray loaded before this one is tested; the loop
// unrolled 16 times (faster at 1000 spheres, slower at 9).

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 1024;  // spheres staged per pass: 1024 x 16 B = 16 KB

struct Ray {
  float px, py, pz, dx, dy, dz;
};

__device__ __forceinline__ Ray load_ray(const float* px, const float* py,
                                        const float* pz, const float* dx,
                                        const float* dy, const float* dz,
                                        int i) {
  return Ray{px[i], py[i], pz[i], dx[i], dy[i], dz[i]};
}

// core/fp.py's fma: a * b + c rounded once.
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// b = dx*tx + dy*ty + dz*tz and len2 = |t|^2 as XLA contracts a three-term
// dot product: fma(z, z', fma(x, x', y*y')).
struct PairTerms {
  float b, rsq_minus_len2;
};

__device__ __forceinline__ PairTerms pair_terms(const Ray& r, float4 s) {
  const float tx = __fsub_rn(s.x, r.px);
  const float ty = __fsub_rn(s.y, r.py);
  const float tz = __fsub_rn(s.z, r.pz);
  const float b = fma32(r.dz, tz, fma32(r.dx, tx, __fmul_rn(r.dy, ty)));
  const float len2 = fma32(tz, tz, fma32(tx, tx, __fmul_rn(ty, ty)));
  return PairTerms{b, __fsub_rn(s.w, len2)};
}

// Stage spheres [start, start + n) into shared memory; returns n.
__device__ __forceinline__ int stage(float4* tile, const float* cx,
                                     const float* cy, const float* cz,
                                     const float* rsq, int start,
                                     int n_prims) {
  const int n = min(kChunk, n_prims - start);
  for (int k = threadIdx.x; k < n; k += blockDim.x) {
    tile[k] = make_float4(cx[start + k], cy[start + k], cz[start + k],
                          rsq[start + k]);
  }
  return n;
}

constexpr int kClosestThreads = 128;
constexpr int kClosestBlocksPerSm = 2048 / kClosestThreads;  // one wave

// One sphere against the thread's ray: the nearest root >= 0 where
// disc >= 0, kept where strictly below the ray's best.
__device__ __forceinline__ void closest_pair(const Ray& r, float4 s, int id,
                                             float& best, int32_t& best_id) {
  const PairTerms pt = pair_terms(r, s);
  const float b = pt.b;
  const float disc = fma32(b, b, pt.rsq_minus_len2);
  if (disc >= 0.0f) {
    const float sq = __fsqrt_rn(fmaxf(disc, 0.0f));
    const float t_near = __fsub_rn(b, sq);
    const float t = t_near < 0.0f ? __fadd_rn(b, sq) : t_near;
    if (t >= 0.0f && t < best) {  // strict: the first occurrence wins
      best = t;
      best_id = id;
    }
  }
}

__global__ void __launch_bounds__(kClosestThreads)
closest_kernel(const float* __restrict__ px, const float* __restrict__ py,
               const float* __restrict__ pz, const float* __restrict__ dx,
               const float* __restrict__ dy, const float* __restrict__ dz,
               const float* __restrict__ cx, const float* __restrict__ cy,
               const float* __restrict__ cz, const float* __restrict__ rsq,
               int n_rays, int n_prims, float* __restrict__ tfar_out,
               int32_t* __restrict__ prim_out) {
  __shared__ float4 tile[kChunk];
  const int step = gridDim.x * blockDim.x;
  // block-uniform trip count: every thread reaches every barrier
  for (int i0 = blockIdx.x * blockDim.x; i0 < n_rays; i0 += step) {
    const int i = i0 + threadIdx.x;
    const bool live = i < n_rays;
    Ray r{};
    if (live) r = load_ray(px, py, pz, dx, dy, dz, i);
    float best = FLT_MAX;
    int32_t best_id = -1;
    for (int start = 0; start < n_prims; start += kChunk) {
      __syncthreads();  // the previous chunk has been read by every thread
      const int n = stage(tile, cx, cy, cz, rsq, start, n_prims);
      __syncthreads();
      if (!live) continue;
      for (int j = 0; j < n; ++j) {
        closest_pair(r, tile[j], start + j, best, best_id);
      }
    }
    if (live) {
      tfar_out[i] = best;
      prim_out[i] = best_id;
    }
  }
}

constexpr int kOccludedThreads = 128;
constexpr int kOccludedBlocksPerSm = 2048 / kOccludedThreads;  // one wave

// One pair of the any-hit predicate (ops/intersect.py's
// _sphere_occluded_pairs, sqrt-free): `hit` is set where the root the
// closest battery would select lies in [0, tf). Its first term, disc >= 0,
// is tested first, on a branch (false for NaN too), so a miss, most pairs
// of a large table, costs the same 12 operations as sphere_closest's.
__device__ __forceinline__ void test_pair(const Ray& r, float tf, float4 s,
                                          bool& hit) {
  const PairTerms pt = pair_terms(r, s);
  const float b = pt.b;
  // b*b has three uses here, so it is not fused into disc
  const float bb = __fmul_rn(b, b);
  const float disc = __fadd_rn(pt.rsq_minus_len2, bb);
  if (disc >= 0.0f) {
    const float e = __fsub_rn(b, tf);
    const float q = __fmul_rn(e, e);
    const bool near_ge0 = (b >= 0.0f) && (bb >= disc);
    const bool hit_near = (e < 0.0f) || (q < disc);
    const bool far_ge0 = (b >= 0.0f) || (bb <= disc);
    const bool hit_far = (e < 0.0f) && (disc < q);
    if (near_ge0 ? hit_near : (far_ge0 && hit_far)) hit = true;
  }
}

// Whether one of the n staged spheres occludes the ray. Every pair is
// tested: the result is an OR, so the pairs after the first occluder
// change no bit, and the loop carries no exit test.
__device__ __forceinline__ bool chunk_hit(const Ray& r, float tf,
                                          const float4* tile, int n) {
  bool hit = false;
#pragma unroll 8
  for (int j = 0; j < n; ++j) test_pair(r, tf, tile[j], hit);
  return hit;
}

__global__ void __launch_bounds__(kOccludedThreads)
occluded_kernel(const float* __restrict__ px, const float* __restrict__ py,
                const float* __restrict__ pz, const float* __restrict__ dx,
                const float* __restrict__ dy, const float* __restrict__ dz,
                const float* __restrict__ tfar, const float* __restrict__ cx,
                const float* __restrict__ cy, const float* __restrict__ cz,
                const float* __restrict__ rsq, int n_rays, int n_prims,
                uint8_t* __restrict__ occ_out) {
  __shared__ float4 tile[kChunk];
  const int step = gridDim.x * kOccludedThreads;
  // a table of one chunk is staged once for all the block's trips
  const bool resident = n_prims <= kChunk;
  if (resident) {
    stage(tile, cx, cy, cz, rsq, 0, n_prims);
    __syncthreads();
  }
  // block-uniform trip count: every thread reaches every barrier
  for (int i0 = blockIdx.x * kOccludedThreads; i0 < n_rays; i0 += step) {
    const int i = i0 + threadIdx.x;
    Ray r{};
    float tf = 0.0f;
    if (i < n_rays) {
      r = load_ray(px, py, pz, dx, dy, dz, i);
      tf = tfar[i];
    }
    // tfar <= 0 (or NaN) never occludes: the predicate is false there
    const bool valid = tf > 0.0f;
    bool todo = valid;
    if (resident) {
      if (todo && chunk_hit(r, tf, tile, n_prims)) todo = false;
    } else {
      for (int start = 0; start < n_prims; start += kChunk) {
        // also the barrier after the previous chunk's reads; a block
        // whose lanes are all done stops staging
        if (!__syncthreads_or(todo)) break;
        const int n = stage(tile, cx, cy, cz, rsq, start, n_prims);
        __syncthreads();
        if (todo && chunk_hit(r, tf, tile, n)) todo = false;
      }
    }
    if (i < n_rays) occ_out[i] = valid && !todo;
  }
}

}  // namespace

// C entry points, bound with ctypes. Each launches on `stream` and returns
// cudaGetLastError() (0 = launched).
// sphere_closest: `sms` is the card's SM count, which caps the grid at one
// wave.
extern "C" int sphere_closest(const float* px, const float* py,
                              const float* pz, const float* dx,
                              const float* dy, const float* dz,
                              const float* cx, const float* cy,
                              const float* cz, const float* rsq, int n_rays,
                              int n_prims, int sms, float* tfar_out,
                              int32_t* prim_out, void* stream) {
  if (sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays > 0) {
    const long long wanted =
        (static_cast<long long>(n_rays) + kClosestThreads - 1) /
        kClosestThreads;
    const long long cap = static_cast<long long>(kClosestBlocksPerSm) * sms;
    const int blocks = static_cast<int>(wanted < cap ? wanted : cap);
    closest_kernel<<<blocks, kClosestThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
        px, py, pz, dx, dy, dz, cx, cy, cz, rsq, n_rays, n_prims, tfar_out,
        prim_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// sphere_occluded: `sms` caps the grid at one wave, as sphere_closest's.
extern "C" int sphere_occluded(const float* px, const float* py,
                               const float* pz, const float* dx,
                               const float* dy, const float* dz,
                               const float* tfar, const float* cx,
                               const float* cy, const float* cz,
                               const float* rsq, int n_rays, int n_prims,
                               int sms, uint8_t* occ_out, void* stream) {
  if (sms < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n_rays > 0) {
    const long long wanted =
        (static_cast<long long>(n_rays) + kOccludedThreads - 1) /
        kOccludedThreads;
    const long long cap = static_cast<long long>(kOccludedBlocksPerSm) * sms;
    const int blocks = static_cast<int>(wanted < cap ? wanted : cap);
    occluded_kernel<<<blocks, kOccludedThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        px, py, pz, dx, dy, dz, tfar, cx, cy, cz, rsq, n_rays, n_prims,
        occ_out);
  }
  return static_cast<int>(cudaGetLastError());
}
