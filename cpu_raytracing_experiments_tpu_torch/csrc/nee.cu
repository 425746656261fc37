// Next-event estimation toward sphere lights in two launches, for Hopper
// (sm_90a): render/renderer.py::_next_event_estimation on the card where
// the closure is lambertian with MIS, the light is picked uniformly (or the
// scene has one light) and every light is a sphere.
//
// Replaces no Pallas kernel: it replaces XLA's fusion of the JAX package's
// render/renderer.py::_next_event_estimation for that policy. Eager PyTorch
// runs it as some hundred launches over the whole wavefront a bounce (the
// light table rebuilt, an int64 row gather of it, every Vec3 operation
// three launches, sin and cos each a round trip through float64 tensors);
// here one lane's NEE lives in registers:
//   nee_sphere   the uniform pick among the L lights, the light's row, the
//                self, inside-the-sphere and cone-below-the-hemisphere
//                tests, the cone sample (Sampling.hpp:220-239, the
//                small-angle switch and the shadow-epsilon pull-back),
//                to_local's z, the lambertian eval and pdf, the power
//                heuristic and the zero-radiance test; it writes l_dir
//                (zero where the sample is not ok), the shadow ray's tfar
//                (zero where not valid), valid and the shadow radiance
//                (zero where not valid), which the unchanged shadow query
//                (ops/intersect.py::occluded_scene) reads;
//   nee_combine  radiance + where(valid & ~occluded, shadow radiance, 0).
// The light table ([L, 8] float32: prim id, center, r^2, emission) is packed
// once per scene by the caller. A block stages it in shared memory up to
// kMaxStaged lights and reads it through the read-only cache above that.
//
// Bits: every output equals the plain path's on the card. Each operation is
// the one PyTorch's kernel performs: __fmaf_rn where the plain path calls
// core/fp.py's fma or its contractions (fp.dot3, sampling.to_local),
// __fmul_rn / __fadd_rn / __fsub_rn elsewhere (nvcc never contracts them),
// IEEE division and square root, sin and cos in float64 rounded once to
// float32 (fp.sin / fp.cos), clamp_min as PyTorch's (NaN kept, else fmaxf),
// and each Python float the plain path multiplies, divides or compares by
// rounded to float32 as PyTorch rounds a scalar operand. Build without
// --use_fast_math.
//
// Bound on an H100: bytes. A live lane reads its hit mask, prim id and
// is_tri (6 B), p_offset, the tangent quat's x, y, w, albedo and throughput
// (60 B) and its three draws (12 B), and writes 29 B; about a hundred float
// operations and two float64 sin / cos. A dead lane (no hit) reads its mask
// and writes zeros, 30 B. The design meets the bound: the lanes go in
// lanes.cuh's form (four a thread by 16-byte loads, 4-byte for the masks,
// and stores where aligned; one wave of blocks), a group whose four lanes
// are all dead skips its loads, and every intermediate stays in registers.

#include <cstdint>
#include <cuda_runtime.h>

#include "lanes.cuh"

namespace {

using lanes::load;
using lanes::store;

constexpr int kRow = 8;     // a light: prim id, center x y z, r^2, emission
constexpr int kMaxStaged = 1536;  // lights staged in 48 KiB of shared memory

// the Python floats of the plain path, rounded to float32 as PyTorch rounds
// a scalar operand
constexpr float kInvPi = static_cast<float>(0.3183098861837907);  // 1 / pi
constexpr float kInvTwoPi = static_cast<float>(0.15915494309189535);
constexpr float kTwoPi = static_cast<float>(6.283185307179586);
constexpr float kSmallCone = static_cast<float>(0.00068523);
constexpr float kTiny = static_cast<float>(1e-20);
constexpr float kPdfFloor = static_cast<float>(1e-6);
constexpr float kPullBack = static_cast<float>(1e-5);

// columns of nee_sphere's `cols`
enum SphereCol {
  kHit, kPrim, kIsTri,                 // uint8, int32, uint8
  kPx, kPy, kPz,                       // p_offset
  kTx, kTy, kTw,                       // the tangent quat (z == 0)
  kAx, kAy, kAz,                       // albedo
  kHx, kHy, kHz,                       // throughput
  kSphereCols
};
constexpr int kFloatCols = 12;  // kPx..kHz
// rows of nee_sphere's output
enum OutRow { kDx, kDy, kDz, kTfar, kRx, kRy, kRz, kOutRows };
// columns of nee_combine's `cols`
enum CombineCol {
  kRadX, kRadY, kRadZ, kShX, kShY, kShZ,  // float
  kValid, kOccluded,                      // uint8
  kCombineCols
};

struct SphereArgs {
  const uint8_t* hit;
  const int* prim;
  const uint8_t* is_tri;
  const float* f[kFloatCols];
  const float* draws;  // rows t, s, the selection draw
  long long draw_stride;
  const float* lights;  // [n_lights, kRow]
  int n_lights;
  float n_lights_f;  // float32(L), the pick's factor
  float inv_l;       // float32(1.0 / L), the selection pdf
  float* out;        // kOutRows rows of out_stride floats
  long long out_stride;
  uint8_t* valid;
};

struct CombineArgs {
  const float* f[6];  // radiance x y z, shadow radiance x y z
  const uint8_t* valid;
  const uint8_t* occluded;
  float* out;  // radiance x y z: 3 rows of out_stride floats
  long long out_stride;
};

struct Lane {
  float v[kOutRows];
  bool valid;
};

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// one live lane's NEE; `in` holds kFloatCols floats in SphereCol order less
// kPx, then the draws t, s, sel
template <bool kStaged>
__device__ __forceinline__ Lane shade(const SphereArgs& a, const float* table,
                                      bool is_tri, int prim,
                                      const float (&in)[kFloatCols],
                                      float t, float s, float sel) {
  Lane o = {{0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, false};
  const float px = in[kPx - kPx], py = in[kPy - kPx], pz = in[kPz - kPx];
  const float tx = in[kTx - kPx], ty = in[kTy - kPx], tw = in[kTw - kPx];
  // the uniform pick (Random.hpp:31-34): trunc(f * L), at most L - 1
  long long pick = static_cast<long long>(__fmul_rn(sel, a.n_lights_f));
  pick = pick < a.n_lights - 1 ? pick : a.n_lights - 1;
  pick = pick > 0 ? pick : 0;
  const float* row = table + pick * kRow;
  float4 r0, r1;
  if constexpr (kStaged) {
    r0 = reinterpret_cast<const float4*>(row)[0];
    r1 = reinterpret_cast<const float4*>(row)[1];
  } else {
    r0 = __ldg(reinterpret_cast<const float4*>(row));
    r1 = __ldg(reinterpret_cast<const float4*>(row) + 1);
  }
  const int light_prim = static_cast<int>(r0.x);
  const float r2 = r1.x;
  // wc = center - p_offset; |wc|^2 as fp.dot3 contracts it
  const float wx = __fsub_rn(r0.y, px), wy = __fsub_rn(r0.z, py),
              wz = __fsub_rn(r0.w, pz);
  const float d2 = __fmaf_rn(wz, wz, __fmaf_rn(wx, wx, __fmul_rn(wy, wy)));
  // self (Renderer.hpp:263), inside the sphere (:266)
  if ((!is_tri && light_prim == prim) || !(d2 > r2)) return o;
  const float dist = __fsqrt_rn(d2);
  // wc * (1 / max(dist, 1e-20)): the reciprocal, then the products
  const float inv = __fdiv_rn(1.0f, clamp_min(dist, kTiny));
  const float nx = __fmul_rn(wx, inv), ny = __fmul_rn(wy, inv),
              nz = __fmul_rn(wz, inv);
  const float stm2 = __fdiv_rn(r2, clamp_min(d2, kTiny));
  // the whole cone below the hemisphere (:270-273): to_local(fuse_xy).z
  const float temp_w =
      __fmul_rn(2.0f, __fmaf_rn(-tx, ny, __fmaf_rn(nx, ty, __fmul_rn(nz, tw))));
  const float n_dot_w = __fmaf_rn(temp_w, tw, -nz);
  if (n_dot_w < 0.0f && stm2 < __fmul_rn(n_dot_w, n_dot_w)) return o;
  // sampling.sample_direction_to_sphere
  const float ctm = __fsqrt_rn(clamp_min(__fsub_rn(1.0f, stm2), 0.0f));
  const float one_ctm = __fsub_rn(1.0f, ctm);
  const float pdf = __fdiv_rn(kInvTwoPi, clamp_min(one_ctm, kPdfFloor));
  const bool small = stm2 < kSmallCone;
  float cos_t = __fmaf_rn(-t, one_ctm, 1.0f);
  float sin_t = __fsqrt_rn(__fmul_rn(stm2, t));
  const float src = small ? sin_t : cos_t;
  const float invert = __fsqrt_rn(clamp_min(__fmaf_rn(-src, src, 1.0f), 0.0f));
  cos_t = small ? invert : cos_t;
  sin_t = small ? sin_t : invert;
  const float tmp = __fmul_rn(dist, sin_t);
  const float raw = __fmaf_rn(
      dist, cos_t, -__fsqrt_rn(clamp_min(__fmaf_rn(-tmp, tmp, r2), 0.0f)));
  const float l_dist =
      __fsub_rn(raw, clamp_min(__fmul_rn(raw, kPullBack), kPullBack));
  // spherical_to_cartesian: sin and cos through float64, as fp.sin / fp.cos
  const double phi = static_cast<double>(__fmul_rn(s, kTwoPi));
  const float cx = __fmul_rn(sin_t, __double2float_rn(cos(phi)));
  const float cy = __fmul_rn(sin_t, __double2float_rn(sin(phi)));
  const float cz = cos_t;
  // orthonormal_basis(wc) (Sampling.hpp:116-130)
  const float sign = signbit(nz) ? -1.0f : 1.0f;
  const float ba = __fdiv_rn(-1.0f, __fadd_rn(sign, nz));
  const float bb = __fmul_rn(__fmul_rn(nx, ny), ba);
  const float v2x = __fmaf_rn(__fmul_rn(__fmul_rn(sign, nx), nx), ba, 1.0f);
  const float v2y = __fmul_rn(sign, bb);
  const float v2z = __fmul_rn(-sign, nx);
  const float v3y = __fmaf_rn(__fmul_rn(ba, ny), ny, sign);
  // each lane of the world direction as fp.dot3 contracts it
  const float lx = __fmaf_rn(nx, cz, __fmaf_rn(v2x, cx, __fmul_rn(bb, cy)));
  const float ly = __fmaf_rn(ny, cz, __fmaf_rn(v2y, cx, __fmul_rn(v3y, cy)));
  const float lz = __fmaf_rn(nz, cz, __fmaf_rn(v2z, cx, __fmul_rn(-ny, cy)));
  o.v[kDx] = lx, o.v[kDy] = ly, o.v[kDz] = lz;
  // l_local.z: to_local with fma(v.z, t.w, v.x*t.y) inside
  const float temp_l =
      __fmul_rn(2.0f, __fmaf_rn(-tx, ly, __fmaf_rn(lz, tw, __fmul_rn(lx, ty))));
  const float llz = __fmaf_rn(temp_l, tw, -lz);
  // the lambertian eval's and pdf's INV_PI * max(l_local.z, 0)
  const float k = __fmul_rn(kInvPi, clamp_min(llz, 0.0f));
  // the power heuristic over f of the light pdf * (1 / L) and the pdf k
  const float lp = __fmul_rn(pdf, a.inv_l);
  const float w =
      __fdiv_rn(lp, clamp_min(__fmaf_rn(lp, lp, __fmul_rn(k, k)), kPdfFloor));
  float rad[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    // (emission * throughput) * (albedo * k), then * w
    const float em = c == 0 ? r1.y : c == 1 ? r1.z : r1.w;
    rad[c] = __fmul_rn(
        __fmul_rn(__fmul_rn(em, in[kHx - kPx + c]),
                  __fmul_rn(in[kAx - kPx + c], k)),
        w);
  }
  // below the hemisphere (:276); max_component() > 0 (:285), NaN false
  const bool any_nan = isnan(rad[0]) || isnan(rad[1]) || isnan(rad[2]);
  o.valid = llz >= 0.0f && !any_nan &&
            (rad[0] > 0.0f || rad[1] > 0.0f || rad[2] > 0.0f);
  if (o.valid) {
    o.v[kTfar] = l_dist;
    o.v[kRx] = rad[0], o.v[kRy] = rad[1], o.v[kRz] = rad[2];
  }
  return o;
}

// lanes [i0, i0 + kW): kW = lanes::kVector by 16-byte groups, or 1
template <int kW, bool kStaged>
__device__ __forceinline__ void sphere_lanes(const SphereArgs& a,
                                             const float* table,
                                             long long i0) {
  uint8_t hit[kW];
  load<kW>(a.hit, i0, hit);
  bool any = false;
#pragma unroll
  for (int j = 0; j < kW; ++j) any |= hit[j] != 0;
  float out[kOutRows][kW];
  uint8_t valid[kW];
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    valid[j] = 0;
#pragma unroll
    for (int k = 0; k < kOutRows; ++k) out[k][j] = 0.0f;
  }
  if (any) {
    int prim[kW];
    uint8_t tri[kW];
    float f[kFloatCols][kW], d[3][kW];
    load<kW>(a.prim, i0, prim);
    load<kW>(a.is_tri, i0, tri);
#pragma unroll
    for (int c = 0; c < kFloatCols; ++c) load<kW>(a.f[c], i0, f[c]);
#pragma unroll
    for (int k = 0; k < 3; ++k) load<kW>(a.draws + k * a.draw_stride, i0, d[k]);
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      if (!hit[j]) continue;
      float in[kFloatCols];
#pragma unroll
      for (int c = 0; c < kFloatCols; ++c) in[c] = f[c][j];
      const Lane o = shade<kStaged>(a, table, tri[j] != 0, prim[j], in,
                                    d[0][j], d[1][j], d[2][j]);
#pragma unroll
      for (int k = 0; k < kOutRows; ++k) out[k][j] = o.v[k];
      valid[j] = o.valid;
    }
  }
#pragma unroll
  for (int k = 0; k < kOutRows; ++k) {
    store<kW>(a.out + k * a.out_stride, i0, out[k]);
  }
  store<kW>(a.valid, i0, valid);
}

template <bool kStaged>
__global__ void __launch_bounds__(lanes::kThreads)
    nee_sphere_kernel(SphereArgs a, long long r, long long n_vec) {
  extern __shared__ float4 staged[];
  const float* table = a.lights;
  if constexpr (kStaged) {
    const float4* src = reinterpret_cast<const float4*>(a.lights);
    for (int i = threadIdx.x; i < a.n_lights * (kRow / 4); i += blockDim.x) {
      staged[i] = __ldg(src + i);
    }
    __syncthreads();
    table = reinterpret_cast<const float*>(staged);
  }
  lanes::each(r, n_vec, [&](auto w, long long i0) {
    sphere_lanes<decltype(w)::value, kStaged>(a, table, i0);
  });
}

template <int kW>
__device__ __forceinline__ void combine_lanes(const CombineArgs& a,
                                              long long i0) {
  uint8_t valid[kW], occ[kW];
  load<kW>(a.valid, i0, valid);
  load<kW>(a.occluded, i0, occ);
  bool any = false;
#pragma unroll
  for (int j = 0; j < kW; ++j) any |= valid[j] && !occ[j];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float rad[kW], sh[kW];
    load<kW>(a.f[c], i0, rad);
#pragma unroll
    for (int j = 0; j < kW; ++j) sh[j] = 0.0f;
    if (any) load<kW>(a.f[3 + c], i0, sh);
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      rad[j] = __fadd_rn(rad[j], valid[j] && !occ[j] ? sh[j] : 0.0f);
    }
    store<kW>(a.out + c * a.out_stride, i0, rad);
  }
}

__global__ void __launch_bounds__(lanes::kThreads)
    nee_combine_kernel(CombineArgs a, long long r, long long n_vec) {
  lanes::each(r, n_vec, [&](auto w, long long i0) {
    combine_lanes<decltype(w)::value>(a, i0);
  });
}

}  // namespace

// C entry points, bound with ctypes; each returns cudaGetLastError() (0 =
// launched) and takes r lanes on `stream` in lanes.cuh's form: n_vec
// 16-byte groups (the wrapper's choice), `sms` the card's SM count.
//
// nee_sphere: `cols` holds the kSphereCols column addresses in SphereCol
// order; `draws` the site's rows t, s and the selection draw, draw_stride
// floats apart; `lights` the [n_lights, 8] table (16-byte aligned); `out`
// the kOutRows rows (l_dir x y z, tfar, shadow radiance x y z), out_stride
// floats apart; `valid` one byte a lane.
extern "C" int nee_sphere(const unsigned long long* cols, const float* draws,
                          long long draw_stride, const float* lights,
                          int n_lights, float* out, long long out_stride,
                          unsigned char* valid, long long r, long long n_vec,
                          int sms, void* stream) {
  if (n_lights < 1 ||
      !lanes::form_ok(r, n_vec, {draw_stride, out_stride}, sms)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (r == 0) return static_cast<int>(cudaGetLastError());
  SphereArgs args{};
  args.hit = reinterpret_cast<const uint8_t*>(cols[kHit]);
  args.prim = reinterpret_cast<const int*>(cols[kPrim]);
  args.is_tri = reinterpret_cast<const uint8_t*>(cols[kIsTri]);
  for (int c = 0; c < kFloatCols; ++c) {
    args.f[c] = reinterpret_cast<const float*>(cols[kPx + c]);
  }
  args.draws = draws;
  args.draw_stride = draw_stride;
  args.lights = lights;
  args.n_lights = n_lights;
  args.n_lights_f = static_cast<float>(n_lights);
  args.inv_l = static_cast<float>(1.0 / static_cast<double>(n_lights));
  args.out = out;
  args.out_stride = out_stride;
  args.valid = valid;
  const int blocks = lanes::blocks(r, n_vec, sms);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_lights <= kMaxStaged) {
    const size_t smem = static_cast<size_t>(n_lights) * kRow * sizeof(float);
    nee_sphere_kernel<true>
        <<<blocks, lanes::kThreads, smem, st>>>(args, r, n_vec);
  } else {
    nee_sphere_kernel<false>
        <<<blocks, lanes::kThreads, 0, st>>>(args, r, n_vec);
  }
  return static_cast<int>(cudaGetLastError());
}

// nee_combine: `cols` holds the kCombineCols column addresses in CombineCol
// order (radiance x y z, shadow radiance x y z, valid, occluded); `out` the
// three rows of the new radiance, out_stride floats apart.
extern "C" int nee_combine(const unsigned long long* cols, float* out,
                           long long out_stride, long long r,
                           long long n_vec, int sms, void* stream) {
  if (!lanes::form_ok(r, n_vec, {out_stride}, sms)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (r == 0) return static_cast<int>(cudaGetLastError());
  CombineArgs args{};
  for (int c = 0; c < 6; ++c) {
    args.f[c] = reinterpret_cast<const float*>(cols[kRadX + c]);
  }
  args.valid = reinterpret_cast<const uint8_t*>(cols[kValid]);
  args.occluded = reinterpret_cast<const uint8_t*>(cols[kOccluded]);
  args.out = out;
  args.out_stride = out_stride;
  nee_combine_kernel<<<lanes::blocks(r, n_vec, sms), lanes::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(args, r, n_vec);
  return static_cast<int>(cudaGetLastError());
}
