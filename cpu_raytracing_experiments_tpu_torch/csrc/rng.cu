// One site of the PyTorch port's counter RNG in one launch, for Hopper
// (sm_90a): core/rng.py::site_draws on the card.
//
// Replaces no Pallas kernel: it replaces XLA's fusion of the JAX package's
// core/rng.py at each site of render/renderer.py (_site_state and the draws
// after it, and the stratified camera jitter). Eager PyTorch holds every u32
// in an int64 tensor and runs a site as some 90 launches over the whole
// wavefront (a 32-bit product alone is six); here each lane's whole site is
// u32 arithmetic in registers:
//   counter = seed + offset                       (add32)
//   state   = hash_2d(accumulation, counter)      (Random.hpp:45-50)
//             then hash_u32(state) under `scramble` (Random.hpp:36-43)
//   row k   = the k-th of n sequential draws      (Random.hpp:10-18, :5)
//   rows 0, 1 = the stratified jitter under `jitter` (the draws still
//             advance the state for rows 2 and 3, as in the plain version)
// and only the n float32 rows (and the final state, where asked) are
// written. The accumulation index is one value for every lane or one a lane
// (the hero packs several passes into one wavefront); the offset is one
// value (2 * bounce [+ 1] of the masked loop) or one int32 a lane (the
// regeneration pool's per-lane bounce). The form follows the operands: a
// null pointer takes the value passed beside it.
//
// Bits: the integer hash is exact u32 arithmetic; a draw is
// __uint2float_rn(bits) * 2^-32, the rounding of PyTorch's int64 -> float32
// cast below 2^32 and an exact product; the jitter's product, sums and
// fmodf (exact; operands >= 0, where it equals torch.remainder) are
// __fmul_rn / __fadd_rn, which nvcc never contracts. So every row equals
// the plain version's bit for bit. Build without --use_fast_math.
//
// Bound on an H100: bytes. A lane reads its seed (8 B), its accumulation
// (8 B where one a lane) and its offset (4 B where one a lane) and writes
// 4 B a draw (8 B more for the state): 28 B a lane at the hero's NEE site,
// 8,355,840 lanes in 0.070 ms at 3.35 TB/s, against 20-90 u32 operations
// a lane (a three-draw site some 45: 0.38 G, about 0.03 ms at the integer
// pipes' rate of some 15 T a second). The design meets the byte bound: one
// lane's arithmetic stays in registers, a thread takes four consecutive lanes
// with 16-byte loads of the seeds (and of the lane operands) and a 16-byte
// store of each row where every array it steps through is 16-byte aligned
// (the wrapper's choice, passed as n_vec; the rest one lane a thread), and
// a grid of one wave of 256-thread blocks strides over the wavefront. The
// four independent lanes of a thread are what keeps the jittered camera
// site near its bound: on an H100 the one-lane body alone takes 0.082 ms
// there against 0.058 ms (the jitter's fmodf and hashes), and 2-7% more at
// the NEE sites.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2048 / kThreads;  // one wave
constexpr int kMaxDraws = 5;
constexpr int kVector = 4;  // lanes of a thread's 16-byte groups
// float32(0.6180339887498949), the golden ratio's conjugate
constexpr float kGoldenRatioConjugate = 0x1.3c6ef4p-1f;

struct SiteArgs {
  const long long* seeds;   // [R] u32 values held in int64
  const long long* acc;     // [R] u32 values held in int64, or null
  const int* offset;        // [R], or null
  unsigned acc_value;       // the accumulation where `acc` is null
  unsigned offset_value;    // the offset where `offset` is null
  int n;                    // draws, 1..kMaxDraws
  bool scramble;
  bool jitter;
  float* rows;              // [n] rows of row_stride floats
  long long row_stride;
  long long* state;         // [R] the state after the draws, or null
};

__device__ __forceinline__ uint32_t hash_u32(uint32_t i) {
  i ^= i >> 16;
  i *= 0x21F0AAADu;
  i ^= i >> 15;
  i *= 0xD35A2D97u;
  i ^= i >> 15;
  return i ^ 0xE6FE3BEBu;
}

__device__ __forceinline__ uint32_t hash_2d(uint32_t x, uint32_t y) {
  constexpr uint32_t m = 0x41C64E6Du;
  const uint32_t qx = ((x >> 1) ^ y) * m;
  const uint32_t qy = ((y >> 1) ^ x) * m;
  return (qx ^ (qy >> 3)) * m;
}

__device__ __forceinline__ float unit_float(uint32_t bits) {
  return __fmul_rn(__uint2float_rn(bits), 0x1p-32f);
}

// pcg_output of `state` as a unit float; the state then takes its
// pcg_state_transition
__device__ __forceinline__ float draw(uint32_t& state) {
  const uint32_t s = state;
  const uint32_t word = ((s >> ((s >> 28) + 4u)) ^ s) * 277803737u;
  state = s * 747796405u + 2891336453u;
  return unit_float((word >> 22) ^ word);
}

// the stratified pixel jitter: van der Corput over the accumulation index
// and its golden-ratio product, each rotated by a hash of the pixel seed
__device__ __forceinline__ float2 jitter(uint32_t acc, uint32_t seed) {
  const float vdc = unit_float(__brev(acc));
  const float gr =
      fmodf(__fmul_rn(__uint2float_rn(acc), kGoldenRatioConjugate), 1.0f);
  const float ox = unit_float(hash_u32(seed));
  const float oy = unit_float(hash_u32(seed ^ 0x9E3779B9u));
  return make_float2(fmodf(__fadd_rn(vdc, ox), 1.0f),
                     fmodf(__fadd_rn(gr, oy), 1.0f));
}

// lanes [i0, i0 + kW): kW = kVector by 16-byte groups, or 1
template <int kW>
__device__ __forceinline__ void site_lanes(const SiteArgs& a, long long i0) {
  uint32_t seed[kW], acc[kW], off[kW];
  if constexpr (kW == kVector) {
    const longlong2* s = reinterpret_cast<const longlong2*>(a.seeds + i0);
    const longlong2 s01 = __ldg(s), s23 = __ldg(s + 1);
    seed[0] = s01.x, seed[1] = s01.y, seed[2] = s23.x, seed[3] = s23.y;
    if (a.acc != nullptr) {
      const longlong2* p = reinterpret_cast<const longlong2*>(a.acc + i0);
      const longlong2 a01 = __ldg(p), a23 = __ldg(p + 1);
      acc[0] = a01.x, acc[1] = a01.y, acc[2] = a23.x, acc[3] = a23.y;
    } else {
      acc[0] = acc[1] = acc[2] = acc[3] = a.acc_value;
    }
    if (a.offset != nullptr) {
      const int4 o = __ldg(reinterpret_cast<const int4*>(a.offset + i0));
      off[0] = o.x, off[1] = o.y, off[2] = o.z, off[3] = o.w;
    } else {
      off[0] = off[1] = off[2] = off[3] = a.offset_value;
    }
  } else {
    seed[0] = static_cast<uint32_t>(a.seeds[i0]);
    acc[0] = a.acc != nullptr ? static_cast<uint32_t>(a.acc[i0])
                              : a.acc_value;
    off[0] = a.offset != nullptr ? static_cast<uint32_t>(a.offset[i0])
                                 : a.offset_value;
  }
  uint32_t state[kW];
  float2 jit[kW];
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    state[j] = hash_2d(acc[j], seed[j] + off[j]);
    if (a.scramble) state[j] = hash_u32(state[j]);
    jit[j] = a.jitter ? jitter(acc[j], seed[j]) : make_float2(0.0f, 0.0f);
  }
  for (int k = 0; k < a.n; ++k) {
    float f[kW];
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      f[j] = draw(state[j]);
      if (a.jitter && k < 2) f[j] = k == 0 ? jit[j].x : jit[j].y;
    }
    float* row = a.rows + k * a.row_stride + i0;
    if constexpr (kW == kVector) {
      *reinterpret_cast<float4*>(row) = make_float4(f[0], f[1], f[2], f[3]);
    } else {
      row[0] = f[0];
    }
  }
  if (a.state != nullptr) {
    if constexpr (kW == kVector) {
      longlong2* s = reinterpret_cast<longlong2*>(a.state + i0);
      s[0] = make_longlong2(state[0], state[1]);
      s[1] = make_longlong2(state[2], state[3]);
    } else {
      a.state[i0] = state[0];
    }
  }
}

// items [0, n_vec) are 16-byte groups of lanes, the rest single lanes from
// lane kVector * n_vec on
__global__ void __launch_bounds__(kThreads)
    site_kernel(SiteArgs a, long long r, long long n_vec) {
  const long long items = n_vec + (r - kVector * n_vec);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < items; t += step) {
    if (t < n_vec) {
      site_lanes<kVector>(a, kVector * t);
    } else {
      site_lanes<1>(a, kVector * n_vec + (t - n_vec));
    }
  }
}

}  // namespace

// C entry point, bound with ctypes: one RNG site over r lanes on `stream`;
// returns cudaGetLastError() (0 = launched). `acc` / `offset` null take
// `acc_value` / `offset_value` for every lane; `state` null writes no
// state. Lanes [0, 4 n_vec) go by 16-byte groups: `seeds`, `rows` (every
// row: row_stride a multiple of 4), and `acc`, `offset` and `state` where
// not null, must then be 16-byte aligned (the wrapper's check). `sms`, the
// card's SM count, sizes the grid to one wave.
extern "C" int rng_site(const long long* seeds, const long long* acc,
                        unsigned acc_value, const int* offset,
                        unsigned offset_value, int n, int scramble,
                        int jitter, float* rows, long long row_stride,
                        long long* state, long long r, long long n_vec,
                        int sms, void* stream) {
  if (n < 1 || n > kMaxDraws || (jitter && n < 2) || r < 0 ||
      row_stride < r || n_vec < 0 || kVector * n_vec > r ||
      (n_vec > 0 && row_stride % kVector) || sms < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (r == 0) return static_cast<int>(cudaGetLastError());
  SiteArgs args{seeds, acc, offset, acc_value, offset_value, n,
                scramble != 0, jitter != 0, rows, row_stride, state};
  const long long items = n_vec + (r - kVector * n_vec);
  const long long needed = (items + kThreads - 1) / kThreads;
  const long long wave = static_cast<long long>(sms) * kBlocksPerSm;
  const int blocks = static_cast<int>(needed < wave ? needed : wave);
  site_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      args, r, n_vec);
  return static_cast<int>(cudaGetLastError());
}
