// The single-rounding float32 fused multiply-add of the PyTorch port, for
// Hopper (sm_90a): out = a * b + c, rounded once (__fmaf_rn), elementwise
// with broadcasting.
//
// Replaces no TPU kernel: it is the card's form of core/fp.py::fma, the
// multiply-add that XLA contracts in the JAX package's elementwise code.
// PyTorch has no single-rounding fma on the card (addcmul rounds the
// product first), and the float64 round-to-odd form of fp.fma_plain would
// take some fourteen launches; this kernel takes one.
//
// Operands. Each of a, b, c is a float32 array read through up to four
// strides over the output's shape (stride 0 on a broadcast dimension), or,
// where its pointer is null, one value passed by the caller (a Python float
// of the wrapper). The wrapper (ops/kernels/fma.py) merges dimensions where
// it can; a contiguous elementwise call arrives with one dimension.
//
// Bound on an H100: bytes. Per element it reads up to 12 bytes and writes 4,
// for 2 floating-point operations: 16 MB and 8 MFLOP at 2^20 elements, about
// 5 us at 3.35 TB/s against 0.1 us at 67 TFLOP/s. One thread an element,
// consecutive threads on consecutive elements, so the reads and the write
// of the contiguous case coalesce.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDims = 4;

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
// size 1 to kDims.
template <int kDims>
struct Shape {
  long long size[kDims];
  Divider div[kDims];
};

template <int kDims>
struct Operand {
  const float* ptr;  // null: the scalar `value`
  float value;
  long long stride[kDims];
};

template <int kDims>
__device__ __forceinline__ float load(const Operand<kDims>& x,
                                      const long long* idx) {
  if (x.ptr == nullptr) return x.value;
  long long off = 0;
#pragma unroll
  for (int d = 0; d < kDims; ++d) off += idx[d] * x.stride[d];
  return x.ptr[off];
}

// kDims = 1: the flat call (every operand contiguous over the output, or a
// scalar); 4: strided and broadcast operands. Below 2^31 elements the flat
// index splits by Divider, above by 64-bit division.
template <int kDims>
__global__ void __launch_bounds__(kThreads)
fma_kernel(Operand<kDims> a, Operand<kDims> b, Operand<kDims> c,
           Shape<kDims> shape, long long n, float* __restrict__ out) {
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += step) {
    long long idx[kDims];
    long long rest = i;
#pragma unroll
    for (int d = kDims - 1; d > 0; --d) {
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

template <int kDims>
Operand<kDims> operand(const float* ptr, float value,
                       const long long* strides, int ndim) {
  Operand<kDims> x{ptr, value, {}};
  for (int d = 0; d < kDims; ++d) {
    const int src = d - (kDims - ndim);
    x.stride[d] = src >= 0 ? strides[src] : 0;
  }
  return x;
}

template <int kDims>
void launch(const float* a, float a_value, const float* b, float b_value,
            const float* c, float c_value, const long long* sizes,
            const long long* strides, int ndim, long long n, float* out,
            cudaStream_t stream) {
  Shape<kDims> shape{};
  for (int d = 0; d < kDims; ++d) {
    const int src = d - (kDims - ndim);
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
  fma_kernel<kDims><<<blocks, kThreads, 0, stream>>>(
      operand<kDims>(a, a_value, strides, ndim),
      operand<kDims>(b, b_value, strides + ndim, ndim),
      operand<kDims>(c, c_value, strides + 2 * ndim, ndim), shape, n, out);
}

}  // namespace

// C entry point, bound with ctypes: `sizes` holds the output's ndim sizes,
// `strides` 3 * ndim element strides (a's, then b's, then c's). Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int fma_f32(const float* a, float a_value, const float* b,
                       float b_value, const float* c, float c_value,
                       const long long* sizes, const long long* strides,
                       int ndim, long long n, float* out, void* stream) {
  if (ndim < 1 || ndim > kMaxDims) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ndim == 1) {
    launch<1>(a, a_value, b, b_value, c, c_value, sizes, strides, 1, n, out,
              st);
  } else {
    launch<kMaxDims>(a, a_value, b, b_value, c, c_value, sizes, strides,
                     ndim, n, out, st);
  }
  return static_cast<int>(cudaGetLastError());
}
