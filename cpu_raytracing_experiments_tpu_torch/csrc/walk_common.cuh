// Device helpers shared by the BVH and grid walks (bvh_walk.cu,
// grid_walk.cu): the leaf tests and the min / max of XLA's CPU code.
//
// Rounding contract: each function equals its plain PyTorch form bit for bit
// on the card. PyTorch rounds every elementwise op on its own; the plain
// forms write out, with core/fp.py's fma, the multiply-adds that XLA
// contracts in the JAX package. Here those are __fmaf_rn, and every other
// product, sum and quotient is __fmul_rn / __fadd_rn / __fsub_rn /
// __fdiv_rn, which nvcc never contracts; square roots are __fsqrt_rn. Build
// without --use_fast_math.
//
// XLA's minimum and maximum (and torch.minimum / maximum / clamp_min)
// return NaN when either operand is NaN; fminf / fmaxf return the other
// operand. An axis-aligned ray whose origin is 0 on that axis has slab
// coefficient n = 0 * inf = NaN there and must miss every box, so the walks
// use the PTX min.NaN / max.NaN instructions (sm_80 and later).
#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace walk {

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// core/fp.py's dot3: fma(az, bz, fma(ax, bx, ay * by)).
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return __fmaf_rn(az, bz, __fmaf_rn(ax, bx, __fmul_rn(ay, by)));
}

struct Ray {
  float px, py, pz, dx, dy, dz;
};

__device__ __forceinline__ Ray load_ray(const float* const* r, int i) {
  return Ray{r[0][i], r[1][i], r[2][i], r[3][i], r[4][i], r[5][i]};
}

// A hit candidate of one prim: t and whether it counts.
struct Candidate {
  float t;
  bool ok;
};

// bvh/traverse.py::_sphere_t, the walks' leaf test (BVH.hpp:270-287).
__device__ __forceinline__ Candidate sphere_t(const Ray& r, float4 s) {
  const float tx = __fsub_rn(s.x, r.px);
  const float ty = __fsub_rn(s.y, r.py);
  const float tz = __fsub_rn(s.z, r.pz);
  const float b = dot3(r.dx, r.dy, r.dz, tx, ty, tz);
  const float disc = __fmaf_rn(b, b, __fsub_rn(s.w, dot3(tx, ty, tz, tx, ty,
                                                         tz)));
  const float sq = __fsqrt_rn(max_nan(disc, 0.0f));
  const float t_near = __fsub_rn(b, sq);
  const float t = t_near < 0.0f ? __fadd_rn(b, sq) : t_near;
  return Candidate{t, disc >= 0.0f && t >= 0.0f};
}

// Vec3.cross: (fma(y, oz, -(z*oy)), fma(z, ox, -(x*oz)), fma(x, oy, -(y*ox))).
__device__ __forceinline__ void cross(float x, float y, float z, float ox,
                                      float oy, float oz, float& cx,
                                      float& cy, float& cz) {
  cx = __fmaf_rn(y, oz, -__fmul_rn(z, oy));
  cy = __fmaf_rn(z, ox, -__fmul_rn(x, oz));
  cz = __fmaf_rn(x, oy, -__fmul_rn(y, ox));
}

// bvh/traverse.py::_moller_trumbore on a packed row (v0, e1, e2).
__device__ __forceinline__ Candidate triangle_t(const Ray& r, const float* w) {
  float hx, hy, hz, qx, qy, qz;
  cross(r.dx, r.dy, r.dz, w[6], w[7], w[8], hx, hy, hz);
  const float det = dot3(w[3], w[4], w[5], hx, hy, hz);
  const bool big = fabsf(det) > 1e-12f;
  const float inv_det = big ? __fdiv_rn(1.0f, det) : 0.0f;
  const float sx = __fsub_rn(r.px, w[0]);
  const float sy = __fsub_rn(r.py, w[1]);
  const float sz = __fsub_rn(r.pz, w[2]);
  const float u = __fmul_rn(dot3(sx, sy, sz, hx, hy, hz), inv_det);
  cross(sx, sy, sz, w[3], w[4], w[5], qx, qy, qz);
  const float v = __fmul_rn(dot3(r.dx, r.dy, r.dz, qx, qy, qz), inv_det);
  const float t = __fmul_rn(dot3(w[6], w[7], w[8], qx, qy, qz), inv_det);
  return Candidate{t, big && u >= 0.0f && v >= 0.0f &&
                          __fadd_rn(u, v) <= 1.0f && t > 1e-6f};
}

// The leaf tests on a row table: spheres [P, 4] (cx, cy, cz, r^2),
// triangles [T, 9] (v0, e1, e2).
template <bool kTriangles>
struct Leaf;

template <>
struct Leaf<false> {
  static __device__ __forceinline__ Candidate test(const Ray& r,
                                                   const float* rows,
                                                   int prim) {
    return sphere_t(r, __ldg(reinterpret_cast<const float4*>(rows) + prim));
  }
};

template <>
struct Leaf<true> {
  static __device__ __forceinline__ Candidate test(const Ray& r,
                                                   const float* rows,
                                                   int prim) {
    float w[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) w[k] = __ldg(rows + 9 * prim + k);
    return triangle_t(r, w);
  }
};

}  // namespace walk
