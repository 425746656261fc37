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
// Design: one thread a row, its adds in the order above, the row reaching
// the thread through shared memory (read from device memory by the thread
// itself, a warp's loads would be 4L bytes apart). A block is one warp and
// owns 32 consecutive rows:
//   * up to kFitL lights (the 326-light scene) the 32 rows, one contiguous
//     range of device memory, are copied into shared memory with cp.async
//     (16 B a lane where the range is 16-B aligned, 4 B copies otherwise)
//     and both passes read them there: device memory sees each row once, as
//     the bound counts it. The copy is flat, rows L floats apart, except
//     where L is a multiple of 8: there rows are L + 4 apart (row by row),
//     so that the 32 lanes reading one column share a bank 4 ways, not 8 to
//     32 (at 326 lights: 2 ways);
//   * above that (10,817 lights: 43 KB a row) each pass streams the rows in
//     double-buffered tiles of kCols columns: each row's segment as the
//     16-byte chunks that hold it (a warp reads 512 contiguous bytes), into
//     slots skewed so that lanes reading one column of rows of an odd
//     length do not share a bank. The second pass reads the rows again
//     from device memory: the blocks in flight stream far more than L2
//     holds between a block's two passes.
// The state of the levels that most terms touch (0 and 1: the running window
// sums, the in-block running sums and the totals before their blocks) is
// scalars in registers; the levels above, touched once in 1024 or 256
// terms, are arrays in the stack frame (SumLevels, ScanLevels). A pass runs
// a window (or a block) of adds at a time, with no test between them, a full
// one with all its terms loaded first.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kSumBlock = 32;
constexpr int kScanBlock = 16;
constexpr int kSumLevels = 7;   // 32^7 > 2^31 terms
constexpr int kScanLevels = 8;  // 16^8 > 2^31 terms
constexpr int kRows = 32;       // rows a block (one warp, a row a lane)
constexpr int kFitL = 380;      // most lights whose 32-row tile is staged
                                // whole (within 48 KB, padded)
constexpr int kCols = 64;       // columns of a streamed tile
constexpr int kChunks = kCols / 4 + 1;  // 16-byte chunks holding a row's
                                        // segment of a tile
constexpr int kSlot = 4 * kChunks;      // floats of a row's slot
constexpr int kBuf = kRows * kSlot + 16;  // floats of a streamed buffer

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

// A 16-byte copy of which only the first `bytes` are read, the rest zeros.
__device__ __forceinline__ void cp_async16_zfill(float* smem,
                                                 const float* gmem,
                                                 int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(bytes));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// The levels of a row reduction above the second, which a row touches once
// in 1024 (sum) or 256 (scan) terms: arrays indexed by the level at run
// time, in the thread's stack frame. The state of levels 0 and 1 is scalars
// in RowSum / RowScan, which hold only a pointer to these, so that it stays
// in registers.
struct SumLevels {
  float acc[kSumLevels];
  int pos[kSumLevels], n[kSumLevels], lo[kSumLevels];
};

struct ScanLevels {
  float acc[kScanLevels];     // in-block running sum of each level
  float before[kScanLevels];  // running total of the blocks before the
                              // current block of each level
  int cnt[kScanLevels];
};

// x[0 .. kN - 1] added to acc left to right, all loaded first.
template <int kN>
__device__ __forceinline__ float add_run(float acc, const float* x) {
  float v[kN];
#pragma unroll
  for (int q = 0; q < kN; ++q) v[q] = x[q];
#pragma unroll
  for (int q = 0; q < kN; ++q) acc = __fadd_rn(acc, v[q]);
  return acc;
}

// The row sum in XLA's windowed order (core/fp.py::row_sum): acc0 sums the
// current window of 32 terms (the padding lo0 in front of the first); a
// full window, or the last term, carries its sum up a level, where acc1
// sums the window sums in windows of their own, and so on.
struct RowSum {
  float acc0, acc1;
  int i0, n0, lo0, pos1, n1, lo1, top;
  SumLevels* up;

  __device__ RowSum(int L, SumLevels* levels) : up(levels) {
    top = 0;
    up->n[0] = L;
    up->lo[0] = 0;
    for (; up->n[top] > kSumBlock && top + 1 < kSumLevels; ++top) {
      const long long m = up->n[top];
      const long long nb = (m + kSumBlock - 1) / kSumBlock;
      up->lo[top] = static_cast<int>((nb * kSumBlock - m) / 2);
      up->n[top + 1] = static_cast<int>(nb);
      up->lo[top + 1] = 0;
    }
    for (int m = 2; m <= top; ++m) {
      up->acc[m] = 0.0f;
      up->pos[m] = 0;
    }
    acc0 = acc1 = 0.0f;
    i0 = pos1 = 0;
    n0 = L;
    lo0 = up->lo[0];
    n1 = top > 0 ? up->n[1] : 0;
    lo1 = top > 0 ? up->lo[1] : 0;
  }

  // Terms i0 .. i0 + n - 1 at x[0 .. n - 1], window by window.
  __device__ __forceinline__ void feed(const float* x, int n) {
    for (int k = 0; k < n;) {
      const int i = i0 + k;
      int end = n0;  // one past the last term of i's window
      if (top > 0) {
        const int w = i + kSumBlock - ((i + lo0) & (kSumBlock - 1));
        end = w < n0 ? w : n0;
      }
      const int m = end - i < n - k ? end - i : n - k;
      if (m == kSumBlock) {
        acc0 = add_run<kSumBlock>(acc0, x + k);
      } else {
#pragma unroll 4
        for (int q = 0; q < m; ++q) acc0 = __fadd_rn(acc0, x[k + q]);
      }
      k += m;
      if (top > 0 && i + m == end) {
        carry(acc0);  // a window is complete: its sum is a term one level up
        acc0 = 0.0f;
      }
    }
    i0 += n;
  }

  __device__ __forceinline__ void carry(float v) {
    acc1 = __fadd_rn(acc1, v);
    const int i = pos1++;
    if (top == 1 || (((i + lo1) & (kSumBlock - 1)) != kSumBlock - 1 &&
                     i != n1 - 1)) {
      return;
    }
    v = acc1;
    acc1 = 0.0f;
    for (int m = 2;; ++m) {
      up->acc[m] = __fadd_rn(up->acc[m], v);
      const int j = up->pos[m]++;
      if (m == top ||
          (((j + up->lo[m]) & (kSumBlock - 1)) != kSumBlock - 1 &&
           j != up->n[m] - 1)) {
        return;
      }
      v = up->acc[m];
      up->acc[m] = 0.0f;
    }
  }

  __device__ __forceinline__ float total() const {
    return top == 0 ? acc0 : top == 1 ? acc1 : up->acc[top];
  }
};

// The running sum in XLA's blocked order (core/fp.py::row_cumsum), compared
// with `target` as it forms: count = the entries <= target. acc0 is the
// running sum inside the current block of 16 and before0 the running total
// of the blocks before it; a full block (or the last entry) carries its
// total up a level, where acc1 / before1 / cnt1 scan the block totals in
// blocks of their own, and so on.
struct RowScan {
  float acc0, before0, acc1, before1, target;
  int j, last, count, cnt1, top;
  ScanLevels* up;

  __device__ RowScan(int L, float target_, ScanLevels* levels) : up(levels) {
    top = 0;
    for (int n = L; n > kScanBlock && top < kScanLevels - 1; ++top) {
      n = (n + kScanBlock - 1) / kScanBlock;
    }
    for (int m = 1; m <= top; ++m) {
      up->acc[m] = 0.0f;
      up->before[m] = 0.0f;
      up->cnt[m] = 0;
    }
    acc0 = before0 = acc1 = before1 = 0.0f;
    j = count = cnt1 = 0;
    last = L - 1;
    target = target_;
  }

  // Entries j .. j + n - 1 from the terms at x[0 .. n - 1], block by block.
  __device__ __forceinline__ void feed(const float* x, int n) {
    for (int k = 0; k < n;) {
      const int j0 = j + k;
      int end = last + 1;  // one past the last entry of j0's block
      if (top > 0) {
        const int b = (j0 & ~(kScanBlock - 1)) + kScanBlock;
        end = b < end ? b : end;
      }
      const int m = end - j0 < n - k ? end - j0 : n - k;
      if (top == 0) {
#pragma unroll 4
        for (int q = 0; q < m; ++q) {
          acc0 = __fadd_rn(acc0, x[k + q]);
          count += acc0 <= target;
        }
      } else if (m == kScanBlock) {
        float v[kScanBlock];
#pragma unroll
        for (int q = 0; q < kScanBlock; ++q) v[q] = x[k + q];
#pragma unroll
        for (int q = 0; q < kScanBlock; ++q) {
          acc0 = __fadd_rn(acc0, v[q]);
          count += __fadd_rn(acc0, before0) <= target;
        }
      } else {
#pragma unroll 4
        for (int q = 0; q < m; ++q) {
          acc0 = __fadd_rn(acc0, x[k + q]);
          count += __fadd_rn(acc0, before0) <= target;
        }
      }
      k += m;
      if (top > 0 && j0 + m == end) {
        carry(acc0);  // a block is complete: carry its total up the levels
        acc0 = 0.0f;
      }
    }
    j += n;
  }

  __device__ __forceinline__ void carry(float t) {
    acc1 = __fadd_rn(acc1, t);
    if (top == 1) {
      before0 = acc1;
      return;
    }
    before0 = __fadd_rn(acc1, before1);
    if (++cnt1 != kScanBlock) return;
    t = acc1;
    acc1 = 0.0f;
    cnt1 = 0;
    for (int m = 2;; ++m) {
      up->acc[m] = __fadd_rn(up->acc[m], t);
      if (m == top) {
        up->before[m - 1] = up->acc[m];
        break;
      }
      up->before[m - 1] = __fadd_rn(up->acc[m], up->before[m]);
      if (++up->cnt[m] != kScanBlock) break;
      t = up->acc[m];
      up->acc[m] = 0.0f;
      up->cnt[m] = 0;
    }
    before1 = up->before[1];
  }
};

// The 8 lanes reduced as LLVM reduces a vector of 8 floats.
__device__ __forceinline__ float lanes8(const float* b) {
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
#pragma unroll
  for (int i = 0; i < 8; ++i) lanes[i] = row[i];
  if (n < 16) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i < n - 8) lanes[i] = __fadd_rn(lanes[i], row[8 + i]);
    }
    return lanes8(lanes);
  }
  if (n == 32) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      lanes[i] = __fadd_rn(__fadd_rn(row[i], row[16 + i]),
                           __fadd_rn(row[8 + i], row[24 + i]));
    }
    return lanes8(lanes);
  }
  const int blocks = n / 8;
  for (int k = 1; k < blocks; ++k) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      lanes[i] = __fadd_rn(lanes[i], row[8 * k + i]);
    }
  }
  acc = lanes8(lanes);
  for (int j = 8 * blocks; j < n; ++j) acc = __fadd_rn(acc, row[j]);
  return acc;
}

// Where row q of a streamed tile starts in its buffer: rows 68 floats
// apart plus 4 more every 8 rows, so that the 32 lanes reading one column
// of rows of an odd length hit 32 banks (2 lanes a bank at L = 2 mod 4, 4
// at L = 0 mod 4).
__device__ __forceinline__ int slot(int q) {
  return q * kSlot + 4 * (q >> 3);
}

// One pass of a streamed block over its rows' L columns: tile k (columns
// k * kCols ..) is copied into buffer k % 2 while tile k - 1 is fed to `acc`
// (lane t feeds row t, if it has one). Where w is 16-byte aligned, each row
// segment is copied as the 16-byte chunks that hold it (a warp reads 512
// contiguous bytes; chunks past the end of w are filled with zeros from
// the bytes inside it) and starts `o` floats into its slot; else float by
// float.
template <typename Acc>
__device__ __forceinline__ void stream_pass(Acc& acc, float* buf,
                                            const float* tile0,
                                            const float* w_end, int rows,
                                            int L, bool aligned, bool live) {
  const int t = threadIdx.x;
  const int tiles = (L + kCols - 1) / kCols;
  auto start = [&](int q, int c0) {  // the segment's first float, aligned
    const float* a = tile0 + static_cast<long long>(q) * L + c0;
    return aligned ? reinterpret_cast<const float*>(
                         reinterpret_cast<uintptr_t>(a) & ~uintptr_t{15})
                   : a;
  };
  auto copy = [&](int k) {
    float* dst = buf + (k & 1) * kBuf;
    const int c0 = k * kCols;
    const int cw = L - c0 < kCols ? L - c0 : kCols;
    if (aligned) {
      for (int idx = t; idx < rows * kChunks; idx += kRows) {
        const int q = idx / kChunks, m = idx - q * kChunks;
        const float* al = start(q, c0);
        const int o = static_cast<int>(
            tile0 + static_cast<long long>(q) * L + c0 - al);
        if (4 * m < o + cw) {
          const float* src = al + 4 * m;
          const long long left = w_end - src;
          cp_async16_zfill(dst + slot(q) + 4 * m, src,
                           left >= 4 ? 16 : static_cast<int>(4 * left));
        }
      }
    } else {
      for (int q = 0; q < rows; ++q) {
        const float* src = tile0 + static_cast<long long>(q) * L + c0;
        for (int c = t; c < cw; c += kRows) {
          cp_async4(dst + slot(q) + c, src + c);
        }
      }
    }
    cp_async_commit();
  };
  copy(0);
  for (int k = 0; k < tiles; ++k) {
    if (k + 1 < tiles) {
      copy(k + 1);
    } else {
      cp_async_commit();  // an empty group: tile k is the one pending
    }
    cp_async_wait<1>();
    __syncthreads();
    if (live) {
      const int c0 = k * kCols;
      const float* a = tile0 + static_cast<long long>(t) * L + c0;
      acc.feed(buf + (k & 1) * kBuf + slot(t) +
                   static_cast<int>(a - start(t, c0)),
               L - c0 < kCols ? L - c0 : kCols);
    }
    __syncthreads();  // tile k is read before tile k + 2 lands there
  }
}

// `stride`: the floats between staged rows, L or (where L is a multiple of
// 8 and w 16-byte aligned) L + 4; `aligned`: whether w is 16-byte aligned.
template <bool kStream>
__global__ void __launch_bounds__(kRows)
    light_rows_kernel(const float* __restrict__ w,
                      const float* __restrict__ f, long long R, int L,
                      int stride, int aligned, int fused,
                      float* __restrict__ total_out,
                      int32_t* __restrict__ sel_out,
                      float* __restrict__ p_out) {
  extern __shared__ __align__(16) float smem[];
  const long long r0 = static_cast<long long>(blockIdx.x) * kRows;
  const int rows = R - r0 < kRows ? static_cast<int>(R - r0) : kRows;
  const int t = threadIdx.x;
  const bool live = t < rows;
  const long long r = r0 + t;
  const float* tile0 = w + r0 * L;
  const float* row = smem + t * stride;  // the staged row (kStream false)
  SumLevels sum_levels;
  ScanLevels scan_levels;
  float total;
  if (!kStream) {
    if (stride != L) {
      // rows padded to `stride`: each row's 16-byte chunks
      const int chunks = L / 4;
      for (int idx = t; idx < rows * chunks; idx += kRows) {
        const int q = idx / chunks, m = idx - q * chunks;
        cp_async16(smem + q * stride + 4 * m,
                   tile0 + static_cast<long long>(q) * L + 4 * m);
      }
    } else {
      // the 32 rows are one contiguous range: stage it whole
      const long long n = static_cast<long long>(rows) * L;
      long long head = 0;
      if (aligned) {
        head = n & ~3LL;
        for (long long k = 4LL * t; k < head; k += 4LL * kRows) {
          cp_async16(smem + k, tile0 + k);
        }
      }
      for (long long k = head + t; k < n; k += kRows) {
        cp_async4(smem + k, tile0 + k);
      }
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (!live) return;
    if (fused && L <= kSumBlock) {
      total = vector_sum(row, L);
    } else {
      RowSum sum(L, &sum_levels);
      sum.feed(row, L);
      total = sum.total();
    }
  } else {
    RowSum sum(L, &sum_levels);
    stream_pass(sum, smem, tile0, w + R * L, rows, L, aligned, live);
    total = sum.total();
  }
  if (live) total_out[r] = total;
  if (f == nullptr) return;

  RowScan scan(L, live ? __fmul_rn(f[r], total) : 0.0f, &scan_levels);
  if (!kStream) {
    scan.feed(row, L);
  } else {
    stream_pass(scan, smem, tile0, w + R * L, rows, L, aligned, live);
  }
  if (!live) return;
  const int sel = scan.count < L - 1 ? scan.count : L - 1;
  sel_out[r] = sel;
  const float den = total < 1e-30f ? 1e-30f : total;  // NaN stays NaN
  p_out[r] = __fdiv_rn(kStream ? w[r * L + sel] : row[sel], den);
}

}  // namespace

// light_rows: w [R, L] row-major float32 (L < 2^31); f [R] or null (then
// only total is written; sel_out and p_out may be null); fused != 0
// selects the fused sum order. Returns cudaGetLastError().
extern "C" int light_rows(const float* w, const float* f, long long R,
                          long long L, int fused, float* total_out,
                          int32_t* sel_out, float* p_out, void* stream) {
  if (L < 1 || L > 0x7fffffffLL || R < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R > 0) {
    const long long blocks = (R + kRows - 1) / kRows;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int l = static_cast<int>(L);
    const int aligned = (reinterpret_cast<uintptr_t>(w) & 15u) == 0;
    if (L <= kFitL) {
      const int stride = aligned && L % 8 == 0 ? l + 4 : l;
      light_rows_kernel<false><<<static_cast<unsigned>(blocks), kRows,
                                 kRows * stride * sizeof(float), s>>>(
          w, f, R, l, stride, aligned, fused, total_out, sel_out, p_out);
    } else {
      light_rows_kernel<true><<<static_cast<unsigned>(blocks), kRows,
                                2 * kBuf * sizeof(float), s>>>(
          w, f, R, l, l, aligned, fused, total_out, sel_out, p_out);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
