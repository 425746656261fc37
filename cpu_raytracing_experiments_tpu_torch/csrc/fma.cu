// The single-rounding float32 multiply-adds of the PyTorch port, for Hopper
// (sm_90a): out = a * b + c rounded once (__fmaf_rn), elementwise, and the
// contraction expressions of core/ that chain several of them, each in one
// launch.
//
// Replaces no TPU kernel: it is the card's form of core/fp.py::fma and of
// the expressions built from it, the multiply-adds that XLA contracts in
// the JAX package's elementwise code. PyTorch has no single-rounding fma on
// the card (addcmul rounds the product first), and the float64
// round-to-odd form of fp.fma_plain would take some fourteen launches.
//
// Two kernels:
//   flat_kernel<kOp>  every operand a contiguous array of the output's
//                     length, one value in device memory read by every lane
//                     (a 0-d tensor), or a value passed by the caller (a
//                     Python float). kOp is the expression:
//                       kFma      a*b + c                      (fp.fma)
//                       kDot3     fma(az, bz, fma(ax, bx, ay*by))  (fp.dot3)
//                       kFma3     fma(a_i, b, c_i), i = x, y, z    (fp.fma3)
//                       kToLocal  sampling.to_local's rotation by conj(T)
//                       kToLocalXY  the same, the other product of temp's
//                                 inner sum fused (to_local(fuse_xy=True))
//                       kToWorld  sampling.to_world's rotation by T
//                     Each rounds every product, sum and difference exactly
//                     where the PyTorch composition of fp.fma rounds it:
//                     __fmul_rn / __fadd_rn, which nvcc never contracts,
//                     and exact negations and doublings. Build without
//                     --use_fast_math.
//   strided_kernel    fp.fma over up to four dimensions of strided and
//                     broadcast operands (stride 0 on a broadcast
//                     dimension), for whatever the flat kernel does not take.
//
// Bound on an H100: bytes. kFma reads up to 12 bytes an element and writes
// 4 for 2 floating-point operations: 8.4 MB at 2^19 elements, 2.5 us at
// 3.35 TB/s; the fused forms read 24-28 and write 4-12 bytes an element.
// The flat kernel takes four consecutive elements a thread with 16-byte
// loads and stores where every array it steps through is 16-byte aligned
// (the wrapper's choice, passed as n_vec), the rest one element a thread;
// 32-bit indices below 2^31 elements; a grid of at most two waves of the
// card's SMs, grid-stride beyond that.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDims = 4;
constexpr int kMaxIn = 7;
constexpr int kMaxOut = 3;
constexpr int kBlocksPerSm = 2048 / kThreads;  // one wave

enum Op {
  kFma = 0,
  kDot3 = 1,
  kFma3 = 2,
  kToLocal = 3,
  kToWorld = 4,
  kToLocalXY = 5
};

// ---------------------------------------------------------------------------
// The flat kernel
// ---------------------------------------------------------------------------
struct FlatArgs {
  const float* in[kMaxIn];  // null: `value`
  float value[kMaxIn];
  unsigned stride_one;  // bit k: in[k] steps one element a lane, else in[k][0]
  float* out[kMaxOut];
};

template <int kOp>
struct Arity;
template <> struct Arity<kFma> { static constexpr int in = 3, out = 1; };
template <> struct Arity<kDot3> { static constexpr int in = 6, out = 1; };
template <> struct Arity<kFma3> { static constexpr int in = 7, out = 3; };
template <> struct Arity<kToLocal> { static constexpr int in = 6, out = 3; };
template <> struct Arity<kToWorld> { static constexpr int in = 6, out = 3; };
template <> struct Arity<kToLocalXY> { static constexpr int in = 6, out = 3; };

// The expression, on one element. Operands in the order of the wrapper:
//   kFma     a, b, c
//   kDot3    ax, ay, az, bx, by, bz
//   kFma3    ax, ay, az, b, cx, cy, cz
//   kToLocal, kToLocalXY, kToWorld  t.x, t.y, t.w, v.x, v.y, v.z  (t.z == 0)
template <int kOp>
__device__ __forceinline__ void eval(const float* x, float* y) {
  if constexpr (kOp == kFma) {
    y[0] = __fmaf_rn(x[0], x[1], x[2]);
  } else if constexpr (kOp == kDot3) {
    y[0] = __fmaf_rn(x[2], x[5],
                     __fmaf_rn(x[0], x[3], __fmul_rn(x[1], x[4])));
  } else if constexpr (kOp == kFma3) {
#pragma unroll
    for (int i = 0; i < 3; ++i) y[i] = __fmaf_rn(x[i], x[3], x[4 + i]);
  } else {
    const float tx = x[0], ty = x[1], tw = x[2];
    const float vx = x[3], vy = x[4], vz = x[5];
    if constexpr (kOp == kToLocal || kOp == kToLocalXY) {
      // temp = 2 * fma(-t.x, v.y, inner), inner = fma(v.z, t.w, v.x * t.y)
      // or, kToLocalXY, fma(v.x, t.y, v.z * t.w)
      const float inner = kOp == kToLocal
                              ? __fmaf_rn(vz, tw, __fmul_rn(vx, ty))
                              : __fmaf_rn(vx, ty, __fmul_rn(vz, tw));
      const float temp = __fmul_rn(2.0f, __fmaf_rn(-tx, vy, inner));
      y[0] = __fmaf_rn(-ty, temp, vx);
      y[1] = __fmaf_rn(tx, temp, vy);
      y[2] = __fmaf_rn(temp, tw, -vz);
    } else {
      // temp = 2 * fma(t.x, v.y, fma(v.z, t.w, -(v.x * t.y)))
      const float temp = __fmul_rn(
          2.0f, __fmaf_rn(tx, vy, __fmaf_rn(vz, tw, -__fmul_rn(vx, ty))));
      y[0] = __fmaf_rn(ty, temp, vx);
      y[1] = __fmaf_rn(-tx, temp, vy);
      y[2] = __fmaf_rn(temp, tw, -vz);
    }
  }
}

template <typename Index>
__device__ __forceinline__ float load1(const FlatArgs& a, int k, Index i) {
  if (a.in[k] == nullptr) return a.value[k];
  return __ldg(a.in[k] + ((a.stride_one >> k) & 1u ? i : Index(0)));
}

template <typename Index>
__device__ __forceinline__ float4 load4(const FlatArgs& a, int k, Index g) {
  if (a.in[k] == nullptr) {
    return make_float4(a.value[k], a.value[k], a.value[k], a.value[k]);
  }
  if ((a.stride_one >> k) & 1u) {
    return __ldg(reinterpret_cast<const float4*>(a.in[k]) + g);
  }
  const float v = __ldg(a.in[k]);
  return make_float4(v, v, v, v);
}

// Groups [0, n_vec) of four elements by 16-byte loads and stores, then the
// elements [4 n_vec, n) one a thread.
template <int kOp, typename Index>
__global__ void __launch_bounds__(kThreads)
flat_kernel(FlatArgs args, Index n, Index n_vec) {
  constexpr int kIn = Arity<kOp>::in, kOut = Arity<kOp>::out;
  const Index step = static_cast<Index>(gridDim.x) * blockDim.x;
  const Index first = static_cast<Index>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  for (Index g = first; g < n_vec; g += step) {
    float4 x4[kIn];
#pragma unroll
    for (int k = 0; k < kIn; ++k) x4[k] = load4(args, k, g);
    float y[4][kOut];
#pragma unroll
    for (int lane = 0; lane < 4; ++lane) {
      float x[kIn];
#pragma unroll
      for (int k = 0; k < kIn; ++k) {
        x[k] = lane == 0 ? x4[k].x : lane == 1 ? x4[k].y
             : lane == 2 ? x4[k].z : x4[k].w;
      }
      eval<kOp>(x, y[lane]);
    }
#pragma unroll
    for (int o = 0; o < kOut; ++o) {
      reinterpret_cast<float4*>(args.out[o])[g] =
          make_float4(y[0][o], y[1][o], y[2][o], y[3][o]);
    }
  }
  for (Index i = 4 * n_vec + first; i < n; i += step) {
    float x[kIn];
#pragma unroll
    for (int k = 0; k < kIn; ++k) x[k] = load1(args, k, i);
    float y[kOut];
    eval<kOp>(x, y);
#pragma unroll
    for (int o = 0; o < kOut; ++o) args.out[o][i] = y[o];
  }
}

template <int kOp>
void launch_flat(const FlatArgs& args, long long n, long long n_vec, int sms,
                 cudaStream_t stream) {
  const long long work = n_vec > n - 4 * n_vec ? n_vec : n - 4 * n_vec;
  const long long wanted = (work + kThreads - 1) / kThreads;
  const long long cap = 2ll * kBlocksPerSm * sms;
  const int blocks = static_cast<int>(wanted < cap ? wanted : cap);
  if (n < (1ll << 31)) {
    flat_kernel<kOp, unsigned><<<blocks, kThreads, 0, stream>>>(
        args, static_cast<unsigned>(n), static_cast<unsigned>(n_vec));
  } else {
    flat_kernel<kOp, long long><<<blocks, kThreads, 0, stream>>>(args, n,
                                                                 n_vec);
  }
}

// ---------------------------------------------------------------------------
// The strided kernel
// ---------------------------------------------------------------------------
// n / d and n % d for 0 <= n < 2^31 by a multiply-high and a shift (the
// round-up method of Granlund and Montgomery): a 32-bit division takes some
// twenty instructions, this takes three.
struct Divider {
  unsigned d, magic, shift;
};

Divider divider(unsigned d) {
  unsigned shift = 0;
  while (shift < 32 && (1ull << shift) < d) ++shift;
  const unsigned long long one = 1;
  return Divider{d,
                 static_cast<unsigned>(((one << 32) * ((one << shift) - d)) /
                                           d +
                                       1),
                 shift};
}

__device__ __forceinline__ unsigned quotient(const Divider& v, unsigned n) {
  return (__umulhi(n, v.magic) + n) >> v.shift;
}

// The output's shape, innermost last, padded in front with dimensions of
// size 1 to kMaxDims.
struct Shape {
  long long size[kMaxDims];
  Divider div[kMaxDims];
};

struct Operand {
  const float* ptr;  // null: the scalar `value`
  float value;
  long long stride[kMaxDims];
};

__device__ __forceinline__ float load(const Operand& x, const long long* idx) {
  if (x.ptr == nullptr) return x.value;
  long long off = 0;
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d) off += idx[d] * x.stride[d];
  return x.ptr[off];
}

// One element a thread. Below 2^31 elements the flat index splits by
// Divider, above by 64-bit division.
__global__ void __launch_bounds__(kThreads)
strided_kernel(Operand a, Operand b, Operand c, Shape shape, long long n,
               float* __restrict__ out) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    long long idx[kMaxDims];
    long long rest = i;
#pragma unroll
    for (int d = kMaxDims - 1; d > 0; --d) {
      long long q;
      if (n < (1ll << 31)) {
        q = quotient(shape.div[d], static_cast<unsigned>(rest));
      } else {
        q = rest / shape.size[d];
      }
      idx[d] = rest - q * shape.size[d];
      rest = q;
    }
    idx[0] = rest;
    out[i] = __fmaf_rn(load(a, idx), load(b, idx), load(c, idx));
  }
}

Operand operand(const float* ptr, float value, const long long* strides,
                int ndim) {
  Operand x{ptr, value, {}};
  for (int d = 0; d < kMaxDims; ++d) {
    const int src = d - (kMaxDims - ndim);
    x.stride[d] = src >= 0 ? strides[src] : 0;
  }
  return x;
}

}  // namespace

// C entry points, bound with ctypes. Each launches on `stream` and returns
// cudaGetLastError() (0 = launched).
//
// fma_flat: expression `op` (enum Op) over n elements. `ptrs` holds the
// kMaxIn operands' pointers (null: the operand is value[k], 0 where
// `value` is null) and then the kMaxOut outputs' pointers; bit k of
// `stride_one` says whether operand k steps one element a lane or is read
// at ptrs[k][0] by every lane. Elements [0, 4 n_vec) go by 16-byte groups:
// every stepped operand and every output must then be 16-byte aligned (the
// wrapper's check). `sms`, the card's SM count, caps the grid at two waves.
extern "C" int fma_flat(int op, const void* const* ptrs, const float* value,
                        unsigned stride_one, long long n, long long n_vec,
                        int sms, void* stream) {
  if (op < kFma || op > kToLocalXY || n_vec < 0 || 4 * n_vec > n ||
      sms < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  FlatArgs args{};
  for (int k = 0; k < kMaxIn; ++k) {
    args.in[k] = static_cast<const float*>(ptrs[k]);
    args.value[k] = value != nullptr ? value[k] : 0.0f;
  }
  args.stride_one = stride_one;
  for (int o = 0; o < kMaxOut; ++o) {
    args.out[o] = static_cast<float*>(const_cast<void*>(ptrs[kMaxIn + o]));
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kFma: launch_flat<kFma>(args, n, n_vec, sms, st); break;
    case kDot3: launch_flat<kDot3>(args, n, n_vec, sms, st); break;
    case kFma3: launch_flat<kFma3>(args, n, n_vec, sms, st); break;
    case kToLocal: launch_flat<kToLocal>(args, n, n_vec, sms, st); break;
    case kToLocalXY: launch_flat<kToLocalXY>(args, n, n_vec, sms, st); break;
    default: launch_flat<kToWorld>(args, n, n_vec, sms, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// fma_f32: the strided form. `sizes` holds the output's ndim sizes,
// `strides` 3 * ndim element strides (a's, then b's, then c's).
extern "C" int fma_f32(const float* a, float a_value, const float* b,
                       float b_value, const float* c, float c_value,
                       const long long* sizes, const long long* strides,
                       int ndim, long long n, float* out, void* stream) {
  if (ndim < 1 || ndim > kMaxDims) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  Shape shape{};
  for (int d = 0; d < kMaxDims; ++d) {
    const int src = d - (kMaxDims - ndim);
    shape.size[d] = src >= 0 ? sizes[src] : 1;
    // a size beyond 2^31 only occurs with n beyond it, which divides
    // by 64-bit division
    shape.div[d] = divider(static_cast<unsigned>(
        shape.size[d] < (1ll << 31) ? shape.size[d] : 1));
  }
  const long long blocks_needed = (n + kThreads - 1) / kThreads;
  // a grid-stride loop past 2^20 blocks
  const int blocks = static_cast<int>(
      blocks_needed < (1ll << 20) ? blocks_needed : (1ll << 20));
  strided_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      operand(a, a_value, strides, ndim),
      operand(b, b_value, strides + ndim, ndim),
      operand(c, c_value, strides + 2 * ndim, ndim), shape, n, out);
  return static_cast<int>(cudaGetLastError());
}
