// The lambertian hit shading of one bounce in two launches, for Hopper
// (sm_90a): render/renderer.py::bounce_step on the card where
// renderer.shade_kernel_path holds (the lambertian closure, the uniform
// light pick or at most one light, no triangle light, a constant sky, one
// bounce for the whole wavefront).
//
// Replaces no Pallas kernel: it replaces XLA's fusion of the JAX package's
// render/renderer.py::bounce_step around NEE for that policy. Eager PyTorch
// runs it as some hundred and fifty launches over the whole wavefront a
// bounce (every Vec3 operation three launches, gathers, wheres, rsqrt, sin
// and cos each a round trip through float64 tensors); here one lane's work
// lives in registers:
//   shade_frame  hit = alive & prim >= 0; the hit point, the sphere's normal
//                (rsqrt through float64) or the triangle's geometric normal,
//                the material id, the backface flip, tangent_space and the
//                scale-aware offset; it writes hit, p_offset, the tangent
//                quat's x, y and w (z is 0), the albedo and the material id,
//                which nee_sphere (csrc/nee.cu) and shade_tail read;
//   shade_tail   after nee_combine: the emissive hit with MIS (the sphere
//                pdf by the law of cosines, the power heuristic, bounce 0
//                and prev_delta unweighted), lambert_sample from the BSDF
//                site's draws, Russian roulette, to_world and lambert_pdf,
//                the constant sky under both sky_bug_compat branches, the
//                bounce cap, and the new PathState; the ray count (alive
//                lanes at entry plus NEE's shadow rays) summed in the kernel
//                into the new u32 ray_count.
// The scene's columns (spheres, triangles, materials, the 1x1 sky and its
// ambient tint) are read through their own pointers; nothing is packed.
//
// Bits: every output equals the plain path's on the card. Each operation is
// the one PyTorch's kernel performs: __fmaf_rn where the plain path calls
// core/fp.py's fma or its contractions (fp.fma3, fp.dot3, sampling.to_local
// with fuse_xy, to_world), __fmul_rn / __fadd_rn / __fsub_rn elsewhere (nvcc
// never contracts them), IEEE division and square root, rsqrt, sin and cos
// in float64 rounded once to float32 (fp.rsqrt, fp.sin, fp.cos), clamp_min
// and maximum as PyTorch's (NaN kept), and each Python float rounded to
// float32 as PyTorch rounds a scalar operand. The radiance keeps the plain
// path's order of adds: nee_combine's radiance, then the emission (0 where
// none), then the sky (0 where none). Build without --use_fast_math.
//
// Bound on an H100: bytes. shade_frame: a lane reads alive (1 B), an alive
// lane its prim id (4 B), a hit lane is_tri, tfar, p and d (29 B); it writes
// hit (1 B) and, for a hit lane, 40 B. shade_tail: a lane reads alive and
// hit (2 B), NEE's valid (1 B) and the state it carries (p, d, throughput,
// radiance, prev_pdf, prev_delta: 53 B), a hit lane the material id, the
// quat, p_offset and the three draws (40 B); it writes the new state (54 B).
// A hit lane moves 225 B over both, a dead lane 112 B: the new state is
// written anew, never in place into the one the caller holds. The scene's
// rows are gathers through the read-only cache. The lanes go in lanes.cuh's
// form (four a thread by 16-byte loads and stores where aligned, one wave
// of blocks); a group of four lanes none of which is alive reads its masks
// and its carried state only, and a group without a hit skips the hit
// lanes' columns.

#include <cstdint>
#include <cuda_runtime.h>

#include "lanes.cuh"

namespace {

using lanes::load;
using lanes::store;

// the Python floats of the plain path, rounded to float32 as PyTorch rounds
// a scalar operand
constexpr float kInvPi = static_cast<float>(0.3183098861837907);  // 1 / pi
constexpr float kInvTwoPi = static_cast<float>(0.15915494309189535);
constexpr float kTwoPi = static_cast<float>(6.283185307179586);
constexpr float kFltEpsilon = 1.1920928955078125e-07f;
// tangent_space's degenerate normal: n.z < -1 + 1.1920929e-7
constexpr float kDegenerate = static_cast<float>(-1.0 + 1.1920929e-7);
constexpr float kLenFloor = static_cast<float>(1e-30);
constexpr float kEpsScale = static_cast<float>(3e-5);
constexpr float kEpsFloor = static_cast<float>(1e-4);
constexpr float kTiny = static_cast<float>(1e-20);
constexpr float kPdfFloor = static_cast<float>(1e-6);
constexpr unsigned long long kMask32 = 0xFFFFFFFFull;

// the scene's columns, in the order of the `scene` address arrays
enum SceneCol {
  kSphereX, kSphereY, kSphereZ, kSphereR2,  // float [S]
  kSphereMat,                               // int32 [S]
  kTriNx, kTriNy, kTriNz,                   // float [T]; null without
  kTriMat,                                  // int32 [T]; triangles
  kAlbedoX, kAlbedoY, kAlbedoZ,             // float [M]
  kEmitX, kEmitY, kEmitZ,                   // float [M]
  kSkyR, kSkyG, kSkyB,                      // the 1x1 map's texel
  kAmbientX, kAmbientY, kAmbientZ,          // the sky's tint (0-d)
  kSceneCols
};

// columns of shade_frame's `cols`
enum FrameCol {
  kFAlive, kFPrim, kFIsTri,  // uint8, int32, uint8
  kFTfar,
  kFPx, kFPy, kFPz,
  kFDx, kFDy, kFDz,
  kFrameCols
};
constexpr int kFrameFloats = kFrameCols - kFTfar;
// rows of shade_frame's output
enum FrameRow { kOx, kOy, kOz, kQx, kQy, kQw, kAx, kAy, kAz, kFrameRows };

// columns of shade_tail's `cols`
enum TailCol {
  kAlive, kHit, kValid, kPrevDelta,  // uint8; kValid null without NEE
  kPrim, kIsTri, kTfar,              // read one lane at a time
  kMat,                              // int32, the frame's
  kTQx, kTQy, kTQw,                  // the frame's quat
  kTOx, kTOy, kTOz,                  // the frame's p_offset
  kPx, kPy, kPz, kDx, kDy, kDz,      // the state
  kHx, kHy, kHz,                     // throughput
  kRx, kRy, kRz,                     // radiance after NEE
  kPrevPdf,
  kRayCount,                         // int64, 0-d
  kTailCols
};
// rows of shade_tail's float output `out` (the radiance has its own)
enum TailRow { kNPx, kNPy, kNPz, kNDx, kNDy, kNDz, kNHx, kNHy, kNHz, kNPdf,
               kTailRows };
// shade_tail's flags
enum Flag : unsigned {
  kUseMis = 1,     // MIS weights the emission (mis, a light, bounce > 0)
  kRoulette = 2,   // policy.russian_roulette
  kSkyCompat = 4,  // policy.sky_bug_compat
  kLast = 8,       // bounce + 1 >= max_bounces: no lane goes on
};

struct FrameArgs {
  const uint8_t* alive;
  const int* prim;
  const uint8_t* is_tri;
  const float* f[kFrameFloats];  // tfar, p, d
  const void* scene[kSceneCols];
  uint8_t* hit;
  float* out;  // kFrameRows rows of out_stride floats
  long long out_stride;
  int* mat;
};

struct TailArgs {
  const void* c[kTailCols];
  const void* scene[kSceneCols];
  const float* draws;  // rows u, v, the roulette draw
  long long draw_stride;
  unsigned flags;
  float inv_l;  // float32(1 / L), the hit light's selection pdf
  float* out;   // kTailRows rows of out_stride floats
  long long out_stride;
  float* rad;   // the new radiance: 3 rows of rad_stride floats
  long long rad_stride;
  uint8_t* alive_out;
  uint8_t* prev_delta_out;
  long long* counts;  // the new ray_count, alive lanes, shadow rays
  unsigned long long* scratch;  // [3], zero between launches
};

__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// torch.maximum: a NaN operand is the result
__device__ __forceinline__ float maximum(float a, float b) {
  return isnan(a) ? a : isnan(b) ? b : fmaxf(a, b);
}

// Vec3.max_component: maximum(x, maximum(y, z))
__device__ __forceinline__ float max3(float x, float y, float z) {
  return maximum(x, maximum(y, z));
}

template <class T>
__device__ __forceinline__ T col(const void* const* cols, int k,
                                 long long i) {
  return __ldg(static_cast<const T*>(cols[k]) + i);
}

// ---------------------------------------------------------------------------
// shade_frame
// ---------------------------------------------------------------------------
struct Frame {
  float v[kFrameRows];
  int mat;
};

// one hit lane's frame; `f` holds tfar, p and d
__device__ __forceinline__ Frame frame(const void* const* scene, int prim,
                                       bool tri, const float (&f)[
                                           kFrameFloats]) {
  const float tfar = f[0];
  float h[3], n[3];
  // the hit point, fp.fma3(d, tfar, p)
#pragma unroll
  for (int c = 0; c < 3; ++c) h[c] = __fmaf_rn(f[4 + c], tfar, f[1 + c]);
  int mat;
  if (tri && scene[kTriNx] != nullptr) {
#pragma unroll
    for (int c = 0; c < 3; ++c) n[c] = col<float>(scene, kTriNx + c, prim);
    mat = col<int>(scene, kTriMat, prim);
  } else {
    // (hit - center).normalize(): |e|^2 as fp.dot3, rsqrt through float64;
    // a triangle lane of a scene without triangles takes sphere 0, as the
    // plain path's clamped gather does
    const int sphere = tri ? 0 : prim;
    float e[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      e[c] = __fsub_rn(h[c], col<float>(scene, kSphereX + c, sphere));
    }
    const float len2 =
        __fmaf_rn(e[2], e[2], __fmaf_rn(e[0], e[0], __fmul_rn(e[1], e[1])));
    const float inv = __double2float_rn(
        rsqrt(static_cast<double>(clamp_min(len2, kLenFloor))));
#pragma unroll
    for (int c = 0; c < 3; ++c) n[c] = __fmul_rn(e[c], inv);
    mat = col<int>(scene, kSphereMat, sphere);
  }
  // the backface flip: n.d >= 0 as fp.dot3 contracts it
  const float nd = __fmaf_rn(n[2], f[6],
                             __fmaf_rn(n[0], f[4], __fmul_rn(n[1], f[5])));
  if (nd >= 0.0f) {
#pragma unroll
    for (int c = 0; c < 3; ++c) n[c] = -n[c];
  }
  Frame o;
  // sampling.tangent_space (Sampling.hpp:150-159)
  const bool degenerate = n[2] < kDegenerate;
  const float s = __fsqrt_rn(
      clamp_min(__fmul_rn(2.0f, __fadd_rn(n[2], 1.0f)), kLenFloor));
  const float invs = __fdiv_rn(1.0f, s);
  o.v[kQx] = degenerate ? 0.0f : __fmul_rn(-n[1], invs);
  o.v[kQy] = degenerate ? 1.0f : __fmul_rn(n[0], invs);
  o.v[kQw] = degenerate ? 0.0f : __fmul_rn(s, 0.5f);
  // the scale-aware offset: fp.fma3(n, eps, hit)
  const float eps = clamp_min(
      __fmul_rn(kEpsScale,
                maximum(fabsf(h[0]), maximum(fabsf(h[1]), fabsf(h[2])))),
      kEpsFloor);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    o.v[kOx + c] = __fmaf_rn(n[c], eps, h[c]);
    o.v[kAx + c] = col<float>(scene, kAlbedoX + c, mat);
  }
  o.mat = mat;
  return o;
}

// lanes [i0, i0 + kW): kW = lanes::kVector by 16-byte groups, or 1
template <int kW>
__device__ __forceinline__ void frame_lanes(const FrameArgs& a,
                                            long long i0) {
  uint8_t alive[kW], hit[kW];
  load<kW>(a.alive, i0, alive);
  bool any_alive = false;
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    hit[j] = 0;
    any_alive |= alive[j] != 0;
  }
  bool any_hit = false;
  if (any_alive) {
    int prim[kW];
    load<kW>(a.prim, i0, prim);
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      hit[j] = alive[j] != 0 && prim[j] >= 0;
      any_hit |= hit[j] != 0;
    }
    if (any_hit) {
      uint8_t tri[kW];
      float f[kFrameFloats][kW], out[kFrameRows][kW];
      int mat[kW];
      load<kW>(a.is_tri, i0, tri);
#pragma unroll
      for (int c = 0; c < kFrameFloats; ++c) load<kW>(a.f[c], i0, f[c]);
#pragma unroll
      for (int j = 0; j < kW; ++j) {
        mat[j] = 0;
#pragma unroll
        for (int k = 0; k < kFrameRows; ++k) out[k][j] = 0.0f;
        if (!hit[j]) continue;
        float in[kFrameFloats];
#pragma unroll
        for (int c = 0; c < kFrameFloats; ++c) in[c] = f[c][j];
        const Frame o = frame(a.scene, prim[j], tri[j] != 0, in);
#pragma unroll
        for (int k = 0; k < kFrameRows; ++k) out[k][j] = o.v[k];
        mat[j] = o.mat;
      }
#pragma unroll
      for (int k = 0; k < kFrameRows; ++k) {
        store<kW>(a.out + k * a.out_stride, i0, out[k]);
      }
      store<kW>(a.mat, i0, mat);
    }
  }
  store<kW>(a.hit, i0, hit);
}

__global__ void __launch_bounds__(lanes::kThreads)
    shade_frame_kernel(FrameArgs a, long long r, long long n_vec) {
  lanes::each(r, n_vec, [&](auto w, long long i0) {
    frame_lanes<decltype(w)::value>(a, i0);
  });
}

// ---------------------------------------------------------------------------
// shade_tail
// ---------------------------------------------------------------------------
// The emitter's MIS weight at hit lane i (renderer._emissive_hit): the
// sphere pdf at the previous point by the law of cosines from tfar and the
// local view vector's z (to_local(fuse_xy=True) of -d), times the uniform
// pick's 1 / L, against prev_pdf by the power heuristic. A triangle lane
// takes sphere 0's radius, as the plain path's clamped gather does.
__device__ __forceinline__ float mis_weight(const TailArgs& a, long long i,
                                            float qx, float qy, float qw) {
  const int prim = col<int>(a.c, kPrim, i);
  const bool tri = col<uint8_t>(a.c, kIsTri, i) != 0;
  const float tfar = col<float>(a.c, kTfar, i);
  const float r2 = col<float>(a.scene, kSphereR2, tri ? 0 : prim);
  const float vx = -col<float>(a.c, kDx, i), vy = -col<float>(a.c, kDy, i),
              vz = -col<float>(a.c, kDz, i);
  const float temp =
      __fmul_rn(2.0f, __fmaf_rn(-qx, vy, __fmaf_rn(vx, qy, __fmul_rn(vz, qw))));
  const float n_dot_v = __fmaf_rn(temp, qw, -vz);
  const float cd2 = __fmaf_rn(
      tfar, __fmaf_rn(n_dot_v, __fmul_rn(2.0f, __fsqrt_rn(r2)), tfar), r2);
  // sampling.sphere_pdf, then cone_pdf
  const float stm2 = __fdiv_rn(r2, clamp_min(cd2, kTiny));
  const float ctm = __fsqrt_rn(clamp_min(__fsub_rn(1.0f, stm2), 0.0f));
  const float light_pdf = __fmul_rn(
      a.inv_l,
      __fdiv_rn(kInvTwoPi, clamp_min(__fsub_rn(1.0f, ctm), kPdfFloor)));
  // sampling.power_heuristic(prev_pdf, light_pdf)
  const float f = col<float>(a.c, kPrevPdf, i);
  const float f2 = __fmul_rn(f, f);
  return __fdiv_rn(f2,
                   clamp_min(__fmaf_rn(light_pdf, light_pdf, f2), kPdfFloor));
}

struct Next {
  float thr[3], dir[3], pdf, emit[3];
  bool on;  // the lane goes on to the next bounce
};

// hit lane i: the emission it adds and where its path goes
__device__ __forceinline__ Next hit_lane(const TailArgs& a, long long i,
                                         int mat, float qx, float qy,
                                         float qw, float u, float v, float rr,
                                         const float (&thr)[3]) {
  Next o;
  float em[3], alb[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    em[c] = col<float>(a.scene, kEmitX + c, mat);
    alb[c] = col<float>(a.scene, kAlbedoX + c, mat);
    o.emit[c] = 0.0f;
  }
  // the emissive hit (Renderer.hpp:319-353): (throughput * emission) * w
  if (max3(em[0], em[1], em[2]) > kFltEpsilon) {
    float w = 1.0f;
    if ((a.flags & kUseMis) && !col<uint8_t>(a.c, kPrevDelta, i)) {
      w = mis_weight(a, i, qx, qy, qw);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      o.emit[c] = __fmul_rn(__fmul_rn(thr[c], em[c]), w);
    }
  }
  // lambert_sample: cosine_hemisphere(u, v), sin and cos through float64
  const float sin_t = __fsqrt_rn(u);
  const float cos_t = __fsqrt_rn(clamp_min(__fsub_rn(1.0f, u), 0.0f));
  const double phi = static_cast<double>(__fmul_rn(v, kTwoPi));
  const float lx = __fmul_rn(sin_t, __double2float_rn(cos(phi)));
  const float ly = __fmul_rn(sin_t, __double2float_rn(sin(phi)));
  const float lz = cos_t;
  // the estimator is the albedo; Russian roulette (:357-404)
#pragma unroll
  for (int c = 0; c < 3; ++c) o.thr[c] = __fmul_rn(thr[c], alb[c]);
  bool kill = false;
  if (a.flags & kRoulette) {
    const float q = __fsub_rn(1.0f, max3(o.thr[0], o.thr[1], o.thr[2]));
    kill = rr < q;
    const float scale =
        __fdiv_rn(1.0f, clamp_min(__fsub_rn(1.0f, q), kFltEpsilon));
#pragma unroll
    for (int c = 0; c < 3; ++c) o.thr[c] = __fmul_rn(o.thr[c], scale);
  }
  // sampling.to_world and lambert_pdf
  const float temp = __fmul_rn(
      2.0f, __fmaf_rn(qx, ly, __fmaf_rn(lz, qw, -__fmul_rn(lx, qy))));
  o.dir[0] = __fmaf_rn(qy, temp, lx);
  o.dir[1] = __fmaf_rn(-qx, temp, ly);
  o.dir[2] = __fmaf_rn(temp, qw, -lz);
  o.pdf = __fmul_rn(kInvPi, clamp_min(lz, 0.0f));
  o.on = !kill && !(a.flags & kLast);
  return o;
}

template <int kW>
__device__ __forceinline__ void tail_lanes(const TailArgs& a,
                                           const float (&sky)[3],
                                           bool has_ambient, long long i0,
                                           unsigned& n_alive,
                                           unsigned& n_shadow) {
  auto in = [&](int k) { return static_cast<const float*>(a.c[k]); };
  uint8_t alive[kW], hit[kW];
  load<kW>(static_cast<const uint8_t*>(a.c[kAlive]), i0, alive);
  bool any_alive = false;
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    hit[j] = 0;
    any_alive |= alive[j] != 0;
    n_alive += alive[j] != 0;
  }
  if (any_alive) load<kW>(static_cast<const uint8_t*>(a.c[kHit]), i0, hit);
  if (a.c[kValid] != nullptr) {
    uint8_t valid[kW];
    load<kW>(static_cast<const uint8_t*>(a.c[kValid]), i0, valid);
#pragma unroll
    for (int j = 0; j < kW; ++j) n_shadow += valid[j] != 0;
  }
  float thr[3][kW];
#pragma unroll
  for (int c = 0; c < 3; ++c) load<kW>(in(kHx + c), i0, thr[c]);
  Next nx[kW];
  bool any_on = false, any_hit = false;
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    nx[j].on = false;
#pragma unroll
    for (int c = 0; c < 3; ++c) nx[j].emit[c] = 0.0f;
    any_hit |= hit[j] != 0;
  }
  if (any_hit) {
    int mat[kW];
    float q[3][kW], d[3][kW];
    load<kW>(static_cast<const int*>(a.c[kMat]), i0, mat);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      load<kW>(in(kTQx + c), i0, q[c]);
      load<kW>(a.draws + c * a.draw_stride, i0, d[c]);
    }
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      if (!hit[j]) continue;
      const float t[3] = {thr[0][j], thr[1][j], thr[2][j]};
      nx[j] = hit_lane(a, i0 + j, mat[j], q[0][j], q[1][j], q[2][j], d[0][j],
                       d[1][j], d[2][j], t);
      any_on |= nx[j].on;
    }
  }
  // the new state: the sampled ray where the lane goes on, else the old one
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float p[kW], o[kW];
    load<kW>(in(kPx + c), i0, p);
    if (any_on) {
      load<kW>(in(kTOx + c), i0, o);
#pragma unroll
      for (int j = 0; j < kW; ++j) p[j] = nx[j].on ? o[j] : p[j];
    }
    store<kW>(a.out + (kNPx + c) * a.out_stride, i0, p);
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float d[kW], h[kW];
    load<kW>(in(kDx + c), i0, d);
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      d[j] = nx[j].on ? nx[j].dir[c] : d[j];
      h[j] = nx[j].on ? nx[j].thr[c] : thr[c][j];
    }
    store<kW>(a.out + (kNDx + c) * a.out_stride, i0, d);
    store<kW>(a.out + (kNHx + c) * a.out_stride, i0, h);
  }
  {
    float pdf[kW];
    uint8_t delta[kW], on[kW];
    load<kW>(in(kPrevPdf), i0, pdf);
    load<kW>(static_cast<const uint8_t*>(a.c[kPrevDelta]), i0, delta);
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      pdf[j] = nx[j].on ? nx[j].pdf : pdf[j];
      delta[j] = nx[j].on ? 0 : delta[j];
      on[j] = nx[j].on;
    }
    store<kW>(a.out + kNPdf * a.out_stride, i0, pdf);
    store<kW>(a.prev_delta_out, i0, delta);
    store<kW>(a.alive_out, i0, on);
  }
  // the radiance: + the emission, then + the sky where a live lane missed
  // (Renderer.hpp:408-420; sky_bug_compat scales every channel by r)
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float rad[kW];
    load<kW>(in(kRx + c), i0, rad);
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      const bool sky_on = alive[j] && !hit[j] && has_ambient;
      const float t = (a.flags & kSkyCompat) ? thr[0][j] : thr[c][j];
      rad[j] = __fadd_rn(__fadd_rn(rad[j], nx[j].emit[c]),
                         sky_on ? __fmul_rn(t, sky[c]) : 0.0f);
    }
    store<kW>(a.rad + c * a.rad_stride, i0, rad);
  }
}

// The ray count: the block's alive lanes and shadow rays into the scratch
// sums; the last block to finish writes the new ray_count ((old + alive +
// shadow) mod 2^32, add32's) and both sums, and sets the scratch to zero.
__device__ __forceinline__ void count_rays(const TailArgs& a,
                                           unsigned n_alive,
                                           unsigned n_shadow) {
  __shared__ unsigned long long block[2];
  if (threadIdx.x == 0) block[0] = block[1] = 0;
  __syncthreads();
  n_alive = __reduce_add_sync(0xFFFFFFFFu, n_alive);
  n_shadow = __reduce_add_sync(0xFFFFFFFFu, n_shadow);
  if ((threadIdx.x & 31) == 0) {
    atomicAdd(&block[0], static_cast<unsigned long long>(n_alive));
    atomicAdd(&block[1], static_cast<unsigned long long>(n_shadow));
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned long long* s = a.scratch;
  atomicAdd(&s[0], block[0]);
  atomicAdd(&s[1], block[1]);
  __threadfence();
  if (atomicAdd(&s[2], 1ull) != gridDim.x - 1) return;
  const unsigned long long alive = atomicExch(&s[0], 0ull);
  const unsigned long long shadow = atomicExch(&s[1], 0ull);
  atomicExch(&s[2], 0ull);
  const unsigned long long old =
      static_cast<unsigned long long>(col<long long>(a.c, kRayCount, 0));
  a.counts[0] = static_cast<long long>((old + alive + shadow) & kMask32);
  a.counts[1] = static_cast<long long>(alive);
  a.counts[2] = static_cast<long long>(shadow);
}

__global__ void __launch_bounds__(lanes::kThreads)
    shade_tail_kernel(TailArgs a, long long r, long long n_vec) {
  // the sky's one texel times its tint, and Sky.has_ambient
  float sky[3], amb[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    amb[c] = col<float>(a.scene, kAmbientX + c, 0);
    sky[c] = __fmul_rn(col<float>(a.scene, kSkyR + c, 0), amb[c]);
  }
  const bool has_ambient = max3(amb[0], amb[1], amb[2]) > 0.0f;
  unsigned n_alive = 0, n_shadow = 0;
  lanes::each(r, n_vec, [&](auto w, long long i0) {
    tail_lanes<decltype(w)::value>(a, sky, has_ambient, i0, n_alive,
                                   n_shadow);
  });
  count_rays(a, n_alive, n_shadow);
}

bool scene_ok(const unsigned long long* scene) {
  for (int k = 0; k < kSceneCols; ++k) {
    const bool tri = k >= kTriNx && k <= kTriMat;
    if (!tri && scene[k] == 0) return false;
  }
  // the triangles' columns all or none
  const bool none = scene[kTriNx] == 0;
  for (int k = kTriNy; k <= kTriMat; ++k) {
    if ((scene[k] == 0) != none) return false;
  }
  return true;
}

}  // namespace

// C entry points, bound with ctypes; each returns cudaGetLastError() (0 =
// launched) and takes r lanes on `stream` in lanes.cuh's form: n_vec
// 16-byte groups (the wrapper's choice), `sms` the card's SM count. `scene`
// holds the kSceneCols column addresses in SceneCol order (the triangles'
// four null where the scene has none).
//
// shade_frame: `cols` holds the kFrameCols column addresses in FrameCol
// order; `out` the kFrameRows rows (p_offset x y z, the quat's x y w, albedo
// x y z), out_stride floats apart; `mat` the material id (int32) and `hit`
// one byte a lane. A lane without a hit writes only its hit byte.
extern "C" int shade_frame(const unsigned long long* cols,
                           const unsigned long long* scene, float* out,
                           long long out_stride, int* mat,
                           unsigned char* hit, long long r, long long n_vec,
                           int sms, void* stream) {
  if (!scene_ok(scene) || !lanes::form_ok(r, n_vec, {out_stride}, sms)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (r == 0) return static_cast<int>(cudaGetLastError());
  FrameArgs args{};
  args.alive = reinterpret_cast<const uint8_t*>(cols[kFAlive]);
  args.prim = reinterpret_cast<const int*>(cols[kFPrim]);
  args.is_tri = reinterpret_cast<const uint8_t*>(cols[kFIsTri]);
  for (int c = 0; c < kFrameFloats; ++c) {
    args.f[c] = reinterpret_cast<const float*>(cols[kFTfar + c]);
  }
  for (int k = 0; k < kSceneCols; ++k) {
    args.scene[k] = reinterpret_cast<const void*>(scene[k]);
  }
  args.hit = hit;
  args.out = out;
  args.out_stride = out_stride;
  args.mat = mat;
  shade_frame_kernel<<<lanes::blocks(r, n_vec, sms), lanes::kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(args, r, n_vec);
  return static_cast<int>(cudaGetLastError());
}

// shade_tail: `cols` holds the kTailCols column addresses in TailCol order
// (kValid null where no NEE ran); `draws` the BSDF site's rows u, v and the
// roulette draw, draw_stride floats apart; `flags` the Flag bits; `inv_l`
// float32(1 / L). Writes `out` (kTailRows rows: p, d, throughput, prev_pdf,
// out_stride floats apart), `rad` (3 rows, rad_stride apart), `alive_out`
// and `prev_delta_out` (a byte a lane), and `counts` (int64: the new
// ray_count, the alive lanes, the shadow rays). `scratch` is three int64
// zeros, left zero; launches that share it must not overlap.
extern "C" int shade_tail(const unsigned long long* cols,
                          const unsigned long long* scene,
                          const float* draws, long long draw_stride,
                          unsigned flags, float inv_l, float* out,
                          long long out_stride, float* rad,
                          long long rad_stride, unsigned char* alive_out,
                          unsigned char* prev_delta_out, long long* counts,
                          unsigned long long* scratch, long long r,
                          long long n_vec, int sms, void* stream) {
  if (!scene_ok(scene) || counts == nullptr || scratch == nullptr ||
      !lanes::form_ok(r, n_vec, {draw_stride, out_stride, rad_stride},
                      sms)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  TailArgs args{};
  for (int k = 0; k < kTailCols; ++k) {
    args.c[k] = reinterpret_cast<const void*>(cols[k]);
  }
  for (int k = 0; k < kSceneCols; ++k) {
    args.scene[k] = reinterpret_cast<const void*>(scene[k]);
  }
  args.draws = draws;
  args.draw_stride = draw_stride;
  args.flags = flags;
  args.inv_l = inv_l;
  args.out = out;
  args.out_stride = out_stride;
  args.rad = rad;
  args.rad_stride = rad_stride;
  args.alive_out = alive_out;
  args.prev_delta_out = prev_delta_out;
  args.counts = counts;
  args.scratch = scratch;
  // one block at least: the last block writes the counts, also of no lane
  const int blocks = lanes::blocks(r, n_vec, sms);
  shade_tail_kernel<<<blocks > 0 ? blocks : 1, lanes::kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(args, r, n_vec);
  return static_cast<int>(cudaGetLastError());
}
