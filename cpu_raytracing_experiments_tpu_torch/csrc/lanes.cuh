// The form of the lane kernels (rng.cu, nee.cu): one wave of 256-thread
// blocks strides over r lanes; a thread takes four consecutive lanes with
// 16-byte loads and stores where every column it steps through is aligned,
// and one lane otherwise. The host (ops/kernels/lanes.py) picks n_vec, the
// number of 16-byte groups: lanes [0, 4 n_vec) go by groups, the rest one a
// thread. A column of 4- or 8-byte elements is then 16-byte aligned, a uint8
// column 4-byte aligned, and every row stride a multiple of 4.
#pragma once

#include <cstdint>
#include <initializer_list>
#include <cuda_runtime.h>

namespace lanes {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2048 / kThreads;  // one wave
constexpr int kVector = 4;  // lanes of a thread's 16-byte groups

// The width of a lane body's call: kVector or 1.
template <int kW>
struct Width {
  static constexpr int value = kW;
};

// Items of the grid-stride loop: n_vec groups, then the single lanes.
__host__ __device__ __forceinline__ long long items(long long r,
                                                    long long n_vec) {
  return n_vec + (r - kVector * n_vec);
}

// Whether r lanes in n_vec groups, rows `strides` floats apart and `sms`
// SMs make a launch: the entry points' common check.
inline bool form_ok(long long r, long long n_vec,
                    std::initializer_list<long long> strides, int sms) {
  if (r < 0 || n_vec < 0 || kVector * n_vec > r || sms < 1) return false;
  for (const long long s : strides) {
    if (s < r || (n_vec > 0 && s % kVector)) return false;
  }
  return true;
}

// Blocks of one wave, or fewer where the items take fewer.
inline int blocks(long long r, long long n_vec, int sms) {
  const long long needed = (items(r, n_vec) + kThreads - 1) / kThreads;
  const long long wave = static_cast<long long>(sms) * kBlocksPerSm;
  return static_cast<int>(needed < wave ? needed : wave);
}

// The grid-stride loop: body(Width<kVector>(), i0) for the groups, then
// body(Width<1>(), i0) for the single lanes from lane kVector * n_vec on;
// i0 is the first lane of the call.
template <class Body>
__device__ __forceinline__ void each(long long r, long long n_vec,
                                     Body body) {
  const long long n = items(r, n_vec);
  const long long step = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       t < n; t += step) {
    if (t < n_vec) {
      body(Width<kVector>(), kVector * t);
    } else {
      body(Width<1>(), kVector * n_vec + (t - n_vec));
    }
  }
}

// Lanes [i0, i0 + kW) of a column: one access of Group<T> (16 bytes; uint8
// 4) for kW = kVector, else one element; int64 by two 16-byte accesses.
template <class T>
struct Group;
template <>
struct Group<float> {
  using type = float4;
};
template <>
struct Group<int> {
  using type = int4;
};
template <>
struct Group<uint8_t> {
  using type = uchar4;
};

template <int kW, class T>
__device__ __forceinline__ void load(const T* p, long long i0, T (&v)[kW]) {
  if constexpr (kW == kVector) {
    const auto x =
        __ldg(reinterpret_cast<const typename Group<T>::type*>(p + i0));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
    v[0] = __ldg(p + i0);
  }
}

template <int kW>
__device__ __forceinline__ void load(const long long* p, long long i0,
                                     long long (&v)[kW]) {
  if constexpr (kW == kVector) {
    const longlong2* q = reinterpret_cast<const longlong2*>(p + i0);
    const longlong2 x01 = __ldg(q), x23 = __ldg(q + 1);
    v[0] = x01.x, v[1] = x01.y, v[2] = x23.x, v[3] = x23.y;
  } else {
    v[0] = __ldg(p + i0);
  }
}

template <int kW, class T>
__device__ __forceinline__ void store(T* p, long long i0, const T (&v)[kW]) {
  if constexpr (kW == kVector) {
    *reinterpret_cast<typename Group<T>::type*>(p + i0) = {v[0], v[1], v[2],
                                                           v[3]};
  } else {
    p[i0] = v[0];
  }
}

template <int kW>
__device__ __forceinline__ void store(long long* p, long long i0,
                                      const long long (&v)[kW]) {
  if constexpr (kW == kVector) {
    longlong2* q = reinterpret_cast<longlong2*>(p + i0);
    q[0] = make_longlong2(v[0], v[1]);
    q[1] = make_longlong2(v[2], v[3]);
  } else {
    p[i0] = v[0];
  }
}

}  // namespace lanes
