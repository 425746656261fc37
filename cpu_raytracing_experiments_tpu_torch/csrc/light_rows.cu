// The light-row reductions of power-proportional light selection, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves these reductions to XLA
// (render/renderer.py::_select_light, light_sampling='power': jnp.sum and
// jnp.cumsum over axis 1 of the [R, L] selection weights). The port needs
// them in XLA's summation order to select the same light, so they are
// written by hand, as csrc/fma.cu is for XLA's contractions.
//
// What it computes, for each row r of the float32 weights w [R, L]:
//   total[r] = the row sum, rounded as jitted jnp.sum(w, axis=1) rounds it
//              on XLA's CPU backend (core/fp.py::row_sum): up to 32 terms
//              left to right from 0; above that windows of 32, the padding
//              split in front (half, rounded down) and behind, each window
//              summed left to right, and the window sums reduced the same
//              way, level by level; with `fused` and L <= 32, rounded as
//              XLA sums a reduction fused with the producer of its terms
//              (core/fp.py::_vector_sum, the JAX renderer's emissive-hit
//              pdf): in lanes of 8 as LLVM vectorizes it;
// and, where the unit draws f [R] are given (selection):
//   sel[r]   = the number of j with cdf[r, j] <= f[r] * total[r], clipped to
//              [0, L - 1], where cdf is the running sum rounded as jitted
//              jnp.cumsum(w, axis=1) rounds it (core/fp.py::row_cumsum): up
//              to 16 terms left to right; above that blocks of 16 scanned
//              left to right, the block totals scanned the same way level by
//              level, and an entry is its in-block running sum plus the
//              running total of the blocks before its own;
//   p_sel[r] = w[r, sel[r]] / max(total[r], 1e-30) (NaN propagates).
// The cdf is never written: each row is read twice, once for the total and
// once for the running sums, which are compared with the target as they
// are formed. total and cdf[:, L - 1] are two different roundings; sel can
// reach L before the clip.
//
// Rounding contract: equal to the plain versions of
// ops/kernels/light_rows.py (core/fp.py's row_sum and row_cumsum) bit for
// bit. Every add is __fadd_rn, the one product __fmul_rn and the division
// __fdiv_rn, which nvcc never contracts or approximates. Build without
// --use_fast_math.
//
// Bound on an H100: memory bytes. A row is L floats read once (the second
// read of the row, and the gather, come from the cache or count against the
// kernel, not the bound) plus f, and 12 bytes written; about 3L float32
// operations a row (two sums and L compares), far below the byte time at
// 67 TFLOP/s. At the 326-light scene's 2^19 lanes that is 684 MB, 0.204 ms
// at 3.35 TB/s.
//
// Design: one thread a row, its level accumulators in registers or local
// memory (at most kMaxLevels levels: 32^8 terms), the row read left to
// right. A simple kernel that is right first: neighbouring threads read
// rows L floats apart, so a warp's loads are not coalesced.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSumBlock = 32;
constexpr int kScanBlock = 16;
constexpr int kMaxLevels = 8;
constexpr int kThreads = 128;

// Term counts of each level and, for the sum, the padding in front of each
// windowed level.
struct SumLevels {
  int count;
  long long n[kMaxLevels];
  int lo[kMaxLevels];
};

__device__ SumLevels sum_levels(long long n) {
  SumLevels s;
  s.count = 1;
  s.n[0] = n;
  while (s.n[s.count - 1] > kSumBlock && s.count < kMaxLevels) {
    const long long m = s.n[s.count - 1];
    const long long nb = (m + kSumBlock - 1) / kSumBlock;
    s.lo[s.count - 1] = static_cast<int>((nb * kSumBlock - m) / 2);
    s.n[s.count] = nb;
    ++s.count;
  }
  return s;
}

__device__ int scan_top(long long n) {
  int top = 0;
  while (n > kScanBlock && top < kMaxLevels - 1) {
    n = (n + kScanBlock - 1) / kScanBlock;
    ++top;
  }
  return top;
}

__device__ float row_sum(const float* row, long long L, const SumLevels& s) {
  float acc[kMaxLevels];
  long long pos[kMaxLevels];
  for (int m = 0; m < kMaxLevels; ++m) {
    acc[m] = 0.0f;
    pos[m] = 0;
  }
  const int top = s.count - 1;
  for (long long j = 0; j < L; ++j) {
    float v = row[j];
    int m = 0;
    while (true) {
      acc[m] = __fadd_rn(acc[m], v);
      const long long i = pos[m]++;
      if (m == top) break;
      if ((i + s.lo[m]) % kSumBlock != kSumBlock - 1 && i != s.n[m] - 1) break;
      v = acc[m];  // a window is complete: its sum is a term one level up
      acc[m] = 0.0f;
      ++m;
    }
  }
  return acc[top];
}

// The 8 lanes reduced as LLVM reduces a vector of 8 floats.
__device__ float lanes8(const float* b) {
  const float c0 = __fadd_rn(b[0], b[4]), c1 = __fadd_rn(b[1], b[5]);
  const float c2 = __fadd_rn(b[2], b[6]), c3 = __fadd_rn(b[3], b[7]);
  return __fadd_rn(__fadd_rn(c0, c2), __fadd_rn(c1, c3));
}

// A row of at most 32 terms summed in core/fp.py::_vector_sum's order.
__device__ float vector_sum(const float* row, int n) {
  float acc = 0.0f;
  if (n < 12) {
    for (int j = 0; j < n; ++j) acc = __fadd_rn(acc, row[j]);
    return acc;
  }
  float lanes[8];
  for (int i = 0; i < 8; ++i) lanes[i] = row[i];
  if (n < 16) {
    for (int i = 0; i < n - 8; ++i) lanes[i] = __fadd_rn(lanes[i], row[8 + i]);
    return lanes8(lanes);
  }
  if (n == 32) {
    for (int i = 0; i < 8; ++i) {
      lanes[i] = __fadd_rn(__fadd_rn(row[i], row[16 + i]),
                           __fadd_rn(row[8 + i], row[24 + i]));
    }
    return lanes8(lanes);
  }
  const int blocks = n / 8;
  for (int k = 1; k < blocks; ++k) {
    for (int i = 0; i < 8; ++i) lanes[i] = __fadd_rn(lanes[i], row[8 * k + i]);
  }
  acc = lanes8(lanes);
  for (int j = 8 * blocks; j < n; ++j) acc = __fadd_rn(acc, row[j]);
  return acc;
}

__global__ void light_rows_kernel(const float* __restrict__ w,
                                  const float* __restrict__ f, long long R,
                                  long long L, int fused,
                                  float* __restrict__ total_out,
                                  int32_t* __restrict__ sel_out,
                                  float* __restrict__ p_out) {
  const long long r =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (r >= R) return;
  const float* row = w + r * L;
  const float total = fused && L <= kSumBlock
                          ? vector_sum(row, static_cast<int>(L))
                          : row_sum(row, L, sum_levels(L));
  total_out[r] = total;
  if (f == nullptr) return;

  const float target = __fmul_rn(f[r], total);
  const int top = scan_top(L);
  float acc[kMaxLevels];  // in-block running sum of each level
  float before[kMaxLevels];  // running total of the blocks before the
                             // current block of each level
  int cnt[kMaxLevels];
  for (int m = 0; m < kMaxLevels; ++m) {
    acc[m] = 0.0f;
    before[m] = 0.0f;
    cnt[m] = 0;
  }
  long long count = 0;
  for (long long j = 0; j < L; ++j) {
    acc[0] = __fadd_rn(acc[0], row[j]);
    const float cdf = top == 0 ? acc[0] : __fadd_rn(acc[0], before[0]);
    count += cdf <= target;
    if (top == 0 || (++cnt[0] != kScanBlock && j != L - 1)) continue;
    // a block of 16 is complete: carry its total up the levels
    float t = acc[0];
    acc[0] = 0.0f;
    cnt[0] = 0;
    for (int m = 1;; ++m) {
      acc[m] = __fadd_rn(acc[m], t);
      if (m == top) {
        before[m - 1] = acc[m];
        break;
      }
      before[m - 1] = __fadd_rn(acc[m], before[m]);
      if (++cnt[m] != kScanBlock) break;
      t = acc[m];
      acc[m] = 0.0f;
      cnt[m] = 0;
    }
  }
  const long long sel = count < L - 1 ? count : L - 1;
  sel_out[r] = static_cast<int32_t>(sel);
  const float den = total < 1e-30f ? 1e-30f : total;  // NaN stays NaN
  p_out[r] = __fdiv_rn(row[sel], den);
}

}  // namespace

// light_rows: w [R, L] row-major float32; f [R] or null (then only total is
// written; sel_out and p_out may be null); fused != 0 selects the fused sum
// order. Returns cudaGetLastError().
extern "C" int light_rows(const float* w, const float* f, long long R,
                          long long L, int fused, float* total_out,
                          int32_t* sel_out, float* p_out, void* stream) {
  if (L < 1 || R < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (R > 0) {
    const long long blocks = (R + kThreads - 1) / kThreads;
    light_rows_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        w, f, R, L, fused, total_out, sel_out, p_out);
  }
  return static_cast<int>(cudaGetLastError());
}
