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
// lane's arithmetic stays in registers, and the lanes go in lanes.cuh's form
// (four a thread by 16-byte loads of the seeds and lane operands and
// 16-byte row stores where aligned, one wave of blocks). The
// four independent lanes of a thread are what keeps the jittered camera
// site near its bound: on an H100 the one-lane body alone takes 0.082 ms
// there against 0.058 ms (the jitter's fmodf and hashes), and 2-7% more at
// the NEE sites.

#include <cstdint>
#include <cuda_runtime.h>

#include "lanes.cuh"

namespace {

constexpr int kMaxDraws = 5;
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

// lanes [i0, i0 + kW): kW = lanes::kVector by 16-byte groups, or 1
template <int kW>
__device__ __forceinline__ void site_lanes(const SiteArgs& a, long long i0) {
  long long seed[kW], acc[kW];
  int off[kW];
  lanes::load<kW>(a.seeds, i0, seed);
  if (a.acc != nullptr) {
    lanes::load<kW>(a.acc, i0, acc);
  } else {
#pragma unroll
    for (int j = 0; j < kW; ++j) acc[j] = a.acc_value;
  }
  if (a.offset != nullptr) {
    lanes::load<kW>(a.offset, i0, off);
  } else {
#pragma unroll
    for (int j = 0; j < kW; ++j) off[j] = a.offset_value;
  }
  uint32_t state[kW];
  float2 jit[kW];
#pragma unroll
  for (int j = 0; j < kW; ++j) {
    const uint32_t s = static_cast<uint32_t>(seed[j]);
    const uint32_t c = static_cast<uint32_t>(acc[j]);
    state[j] = hash_2d(c, s + static_cast<uint32_t>(off[j]));
    if (a.scramble) state[j] = hash_u32(state[j]);
    jit[j] = a.jitter ? jitter(c, s) : make_float2(0.0f, 0.0f);
  }
  for (int k = 0; k < a.n; ++k) {
    float f[kW];
#pragma unroll
    for (int j = 0; j < kW; ++j) {
      f[j] = draw(state[j]);
      if (a.jitter && k < 2) f[j] = k == 0 ? jit[j].x : jit[j].y;
    }
    lanes::store<kW>(a.rows + k * a.row_stride, i0, f);
  }
  if (a.state != nullptr) {
    long long st[kW];
#pragma unroll
    for (int j = 0; j < kW; ++j) st[j] = state[j];
    lanes::store<kW>(a.state, i0, st);
  }
}

__global__ void __launch_bounds__(lanes::kThreads)
    site_kernel(SiteArgs a, long long r, long long n_vec) {
  lanes::each(r, n_vec, [&](auto w, long long i0) {
    site_lanes<decltype(w)::value>(a, i0);
  });
}

}  // namespace

// C entry point, bound with ctypes: one RNG site over r lanes on `stream`
// in lanes.cuh's form (n_vec 16-byte groups, the wrapper's choice; `sms` the
// card's SM count); returns cudaGetLastError() (0 = launched). `acc` /
// `offset` null take `acc_value` / `offset_value` for every lane; `state`
// null writes no state; `rows` holds the n rows, row_stride floats apart.
extern "C" int rng_site(const long long* seeds, const long long* acc,
                        unsigned acc_value, const int* offset,
                        unsigned offset_value, int n, int scramble,
                        int jitter, float* rows, long long row_stride,
                        long long* state, long long r, long long n_vec,
                        int sms, void* stream) {
  if (n < 1 || n > kMaxDraws || (jitter && n < 2) ||
      !lanes::form_ok(r, n_vec, {row_stride}, sms)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (r == 0) return static_cast<int>(cudaGetLastError());
  SiteArgs args{seeds, acc, offset, acc_value, offset_value, n,
                scramble != 0, jitter != 0, rows, row_stride, state};
  site_kernel<<<lanes::blocks(r, n_vec, sms), lanes::kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(args, r, n_vec);
  return static_cast<int>(cudaGetLastError());
}
