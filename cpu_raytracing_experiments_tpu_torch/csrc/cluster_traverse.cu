// Clustered traversal of the PyTorch port, for Hopper (sm_90a): the per-tile
// cluster planner and the two cluster walks of the large-scene path
// (accel='pallas').
//
// Replaces the TPU kernels of the JAX package's
// ops/pallas/traverse_kernel.py:
//   cluster_plan     <- _make_plan_kernel(sort_in_kernel=True), the flat
//                       'ray' plan and its use_super ('super') and use_dual
//                       ('group') options (driven by _plan_visits)
//   cluster_plan_rows <- _make_plan_kernel(sort_in_kernel=False) with the
//                       same options, _make_plan_kernel_tilebox and
//                       _make_plan_kernel_hybrid: the unsorted entry matrix
//                       that _plan_visits sorts in XLA
//   cluster_closest  <- _make_closest_kernel with _sphere_battery /
//                       _triangle_battery (driven by
//                       intersect_clustered_pallas)
//   cluster_occluded <- _make_shadow_kernel with _sphere_anyhit_battery /
//                       _triangle_anyhit_battery (driven by
//                       occluded_clustered_pallas)
//   the battery code 2 of both walks <- _triangle_battery_mxu, the triangle
//                       test in product form (mxu=True)
//   cluster_closest_stream, cluster_occluded_stream <- _stream_kernels
//                       (stream=True): the same walks over the row-packed
//                       table of _tables_packed
//   stream_replay    <- the DMA replay of benchmarks/diag_stream2.py (:152):
//                       one tile's visited clusters copied out through the
//                       streamed walks' staging
//
// What they compute. Rays are cut into tiles of tile_r consecutive rays; one
// thread block works on one tile (a tilebox block of cluster_plan_rows on up
// to eight).
//   cluster_plan: for every cluster box, the least slab entry distance over
//   the tile's valid rays (FLT_MAX where no valid ray enters it before its
//   tfar), then the tile's entered clusters sorted front to back, the lowest
//   cluster id first among equal entries. Outputs the sorted entries, the
//   cluster ids in that order and their number nvis; positions at or past
//   nvis hold FLT_MAX and -1 and are never read. Its modes: 'ray' as said;
//   'group', the lesser of the entries against a cluster's two leaf boxes;
//   'super', the entries against the union boxes of 128 consecutive
//   clusters first, then the 'ray' entries of the members of the entered
//   unions only, which equal the 'ray' plan bit for bit.
//   cluster_plan_rows: the same entries, unsorted, as a [T, C] matrix, in
//   those three modes and two more. 'tilebox': the tile's valid rays summed
//   up by per-axis origin and direction intervals and their largest tfar,
//   tested against each box once by interval arithmetic (a lower bound of
//   every ray's entry). 'hybrid': 'tilebox' where the tile's directions are
//   sign-coherent on all three axes, else 'ray'. It sweeps the clusters in
//   chunks that fit shared memory and so has no cluster limit.
//   cluster_closest: every valid ray's nearest primitive over the tile's
//   visit list, walked while the next entry is below the tile's exit bound
//   mx = max over valid lanes of min(current tfar, exit distance from the
//   root box). A candidate replaces the running hit only if strictly nearer,
//   so the first primitive in (visit order, slot order) keeps a tie. Returns
//   (tfar, cluster * K + slot), or (tfar0, -1).
//   cluster_occluded: whether any primitive lies at t in [0, tfar); lanes
//   with tfar <= 0 are invalid and never occluded; the walk ends when every
//   valid lane is occluded (mx drops to -FLT_MAX).
// Skipping a cluster whose entry is at or beyond mx cannot change a result,
// and a stale mx is only larger, so any refresh schedule gives the same
// output. These kernels refresh mx after every visit, which walks the fewest
// clusters.
//
// Rounding contract: bit-equal to the plain PyTorch versions in
// ops/kernels/cluster_traverse.py on the card, as in sphere_battery.cu:
// fma32 (__fmaf_rn, rounded once as core/fp.py's fma and XLA's contraction
// are) for the multiply-adds that XLA fuses in the JAX package, the _rn
// intrinsics (never contracted by nvcc) and IEEE division and square root
// for the rest. Build without --use_fast_math.
// NaN: jnp.minimum / torch.minimum propagate NaN and fminf does not. In the
// slab test a NaN (0 * inf: a zero direction component with the origin on
// that box face) reaches tmin and tmax whichever operand it starts in, and
// the comparison `tmax >= entry` is then false: the ray does not enter the
// box. So slab() (the walks' root box test) uses fminf/fmaxf and reports
// separately whether any of the six products was NaN, and the planners use
// min / max that propagate NaN (nan_min, nan_max), with the same outcome.
//
// Bound on an H100. The planner does tile_r x C slab tests per tile (about
// 25 operations each) and writes 8 bytes per (tile, cluster): operations
// bind it from a few hundred clusters on. 'super' does tile_r x (S + 128 E)
// tests for E entered unions; 'tilebox' one interval test per (tile,
// cluster) and writes 4 bytes for it: bytes bind it. The walks read each
// visited cluster's rows once per tile (16 B per sphere, 48 B per triangle)
// and do 20 (spheres) or about 38 (triangles) float32 operations per (ray,
// primitive) pair: operations bind them.
//
// The product-form triangle battery. Per visited cluster the TPU kernel
// multiplies the tile's [tile_r, 3] direction and origin matrices with
// m = [n | f1 | f2] of shape [3, 3K], then t = (d0 - n.p) / (n.d),
// u = f1.p + t * (f1.d) + g1 and v likewise; the hit point is never formed.
// Here each thread computes its ray's row of both products from the staged
// rows of m, every element as mat3(): ax*bx, then two fused multiply-adds,
// in float32 (fma32). No tensor core: one-pass TF32 would not keep the prim
// ids. It rounds differently from the ordinary battery by design.
//
// The walks keep two slots of one cluster's rows in shared memory. Before
// the block waits for visit j's rows it starts the asynchronous copy
// (cp.async, one commit group per visit) of visit j + 1 into the other slot,
// so that copy runs under visit j's battery. A copy started for a visit that
// the early exit then skips is waited for before the block ends. The
// resident [C * K, F] table is already in the batteries' layout (a sphere
// one float4, a triangle three) and is copied 16 bytes at a time. The
// streamed walks read the packed table [C * F8, K] (cluster c's attribute
// rows contiguous, zero rows up to F8 = 8 or 16; the zero rows are not
// copied) by 4-byte copies that transpose the attribute rows into the
// resident layout, so that the batteries are fed the same values: the
// results are equal bit for bit.
//
// What bounds the walks, and the design against it. The streamed walks carry
// the
// large meshes (1.3 M triangles, 127 of 130 planned clusters walked a tile
// on bounce rays), where a launch is some 4.3e9 (lane, slot) pairs of a
// float32 battery of about 40 instructions: the SMs' issue rate bounds it.
// Four things kept them far from that rate, and each has its answer here.
// (1) Float64: the multiply-adds ran in double, and the conversions to and
// from it issue at 1/8 of the float32 rate; the battery is float32 only now
// (__fmaf_rn). (2) Shared loads: read from attribute rows, a triangle took
// twelve 4-byte loads, and the shared-memory pipe (one load a clock an SM)
// bound the walk; staged transposed it takes three 16-byte ones. (3) A
// narrow wavefront leaves most of the card idle: the bounce loop's
// 131,072-lane batches are 512 tiles of 256 threads, about half the card's
// resident threads, and of those only the live lanes work. So S threads
// share a ray (S in {1, 2, 4}, the wrapper's choice from the tile count and
// the SM count, ops/kernels/cluster_traverse.py::_stream_split): thread t
// works on ray t / S and owns the slots k = t % S (mod S) of each staged
// cluster; after each visit the S adjacent lanes reduce (t, slot) by
// __shfl_xor, the least t and the lowest slot of equal t, and the ray's
// best takes the result only if strictly nearer, so the first prim in
// (visit order, slot order) keeps a tie, as in the sequential loop; the
// any-hit walk ORs the S lanes. (4) Dead lanes rode in warps that ran the
// battery: one block-wide prefix sum over the live flags (a ballot per
// warp, one warp's scan of the warps' counts) packs the tile's live rays
// into the first ray positions, so a warp past the live count skips the
// battery on a uniform branch and only joins the barriers; each result is
// written to its ray's own index, and a lane that is not live gets its
// untouched result at the start. The exit bound keeps its meaning: the
// block's max of every live ray's bound, refreshed after each visit. A
// block is tile_r * S threads, at most 1024 (__launch_bounds__). Every walk,
// closest or any-hit, resident or streamed, is this split walk: one kernel
// template a walk (closest_kernel, occluded_kernel) that differs between
// its resident and streamed forms only in the fetch.
//
// The sorted planner, cluster_plan. A slab test has no multiply-add: 6
// subtractions and 6 multiplications for the FP32 pipe, and min / max /
// compares for the integer-rate one, so the SMs' issue rate binds it before
// the FLOP bound does, and a first design that read seven 4-byte shared
// words per test and tested the six products for NaN apart ran at 4.6x the
// FLOP bound. Here each lane keeps the boxes of 8 clusters (4 under 'group')
// in registers and streams the tile's staged rays past them, so that two
// 16-byte broadcast loads of a ray feed 8 tests. The staged rays are the
// tile's valid ones only, grouped by octant (the signs of 1 / d): within an
// octant every slab's near and far plane are known at compile time, so
// tmin is a max of three products and tmax a min of three, with min / max
// that propagate NaN in place of the NaN flag, and `entry < tfar` is
// `min(tmax, tfp) >= entry` with tfp the float below tfar: 20 instructions
// a test. Every warp takes every batch of clusters and an eighth of the
// rays, and folds its least entries into one per cluster by shared atomic
// min on the float bits, so the warps stay even for any C; a C of at most
// kNarrowClusters takes batches of 2 in fewer registers, for occupancy. The
// entered ids are compacted (a ballot per warp) and sorted by (entry, id)
// in shared memory: by one warp in registers up to 32 keys, else by a
// block-wide bitonic network. 'super' sweeps the S union boxes first, then
// the 32-cluster slots of the entered unions; 'group' holds both leaf
// boxes of a cluster.
// The unsorted planner, cluster_plan_rows, is the same kernel body: its
// exact modes (and the incoherent tiles of 'hybrid') take the same sweep
// and write the tile's row from s_min, coalesced, in place of the sort. Its
// [T, C] output has no cluster limit: s_min holds `chunk` clusters (the
// wrapper's plan_rows_chunk, a multiple of 32 that fits shared memory
// beside the staged rays), and the block sweeps chunk after chunk with its
// rays staged once; 'super' sweeps the union boxes once a tile and in each
// chunk the slots of the entered unions. 'tilebox' (and the sign-coherent
// tiles of 'hybrid') is bound by the bytes of its output, one interval test
// a (tile, cluster): a box block plans up to eight tiles, one warp
// reducing each tile's bundle by shuffles (min / max that propagate NaN, as
// the JAX reductions do), and each thread loads a box once and tests it
// against every bundle of the block, writing each tile's row coalesced.
// Warp-level culling inside a tile, several clusters per staging step and
// tensor-core batteries are later work.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPlanThreads = 256;

// core/fp.py's fma: a * b + c rounded once.
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}

// ax*bx + ay*by + az*bz as XLA contracts it: fma(z, z', fma(x, x', y*y')).
__device__ __forceinline__ float dot3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return fma32(az, bz, fma32(ax, bx, __fmul_rn(ay, by)));
}

struct Ray {
  float px, py, pz, dx, dy, dz;
};

struct Slab {
  float tmin, tmax;
  bool nan;  // one of the six products was NaN: the box is not entered
};

// The slab test of _tile_entry_row / _root_exit_bound, with the ray's
// reciprocal direction (ix, iy, iz) computed by the caller.
__device__ __forceinline__ Slab slab(float lox, float loy, float loz,
                                     float hix, float hiy, float hiz,
                                     float px, float py, float pz, float ix,
                                     float iy, float iz) {
  const float ax = __fmul_rn(__fsub_rn(lox, px), ix);
  const float bx = __fmul_rn(__fsub_rn(hix, px), ix);
  const float ay = __fmul_rn(__fsub_rn(loy, py), iy);
  const float by = __fmul_rn(__fsub_rn(hiy, py), iy);
  const float az = __fmul_rn(__fsub_rn(loz, pz), iz);
  const float bz = __fmul_rn(__fsub_rn(hiz, pz), iz);
  Slab s;
  s.tmin = fmaxf(fmaxf(fminf(ax, bx), fminf(ay, by)), fminf(az, bz));
  s.tmax = fminf(fminf(fmaxf(ax, bx), fmaxf(ay, by)), fmaxf(az, bz));
  s.nan = (ax != ax) || (bx != bx) || (ay != ay) || (by != by) ||
          (az != az) || (bz != bz);
  return s;
}

// _root_exit_bound: the ray's exit distance from the root box, padded by
// 1e-5, or 0 where it misses the box.
__device__ __forceinline__ float root_exit(const float* __restrict__ root,
                                           const Ray& r) {
  const Slab s = slab(root[0], root[1], root[2], root[3], root[4], root[5],
                      r.px, r.py, r.pz, __fdiv_rn(1.0f, r.dx),
                      __fdiv_rn(1.0f, r.dy), __fdiv_rn(1.0f, r.dz));
  const bool hit = !s.nan && s.tmax >= fmaxf(s.tmin, 0.0f);
  return hit ? __fmul_rn(s.tmax, 1.00001f) : 0.0f;
}

// Max of v over the block, returned to every thread. s_red holds one float
// per warp.
__device__ __forceinline__ float block_max(float v, float* s_red) {
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  const int n_warps = (blockDim.x + 31) >> 5;
  if ((threadIdx.x & 31) == 0) s_red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = s_red[0];
  for (int w = 1; w < n_warps; ++w) m = fmaxf(m, s_red[w]);
  __syncthreads();  // s_red may be rewritten after this
  return m;
}

// ---------------------------------------------------------------------------
// Planners: cluster_plan (sorted in the kernel) and cluster_plan_rows (the
// unsorted entry matrix), one kernel body
// ---------------------------------------------------------------------------
// The `mode` argument of both entry points (_MODES of the wrapper).
constexpr int kFlat = 0;     // 'ray'
constexpr int kDual = 1;     // 'group': the second slab set is each
                             // cluster's second leaf box
constexpr int kSuper = 2;    // 'super': the second slab set is the S
                             // supercluster boxes
constexpr int kTilebox = 3;  // 'tilebox' (cluster_plan_rows only)
constexpr int kHybrid = 4;   // 'hybrid' (cluster_plan_rows only)
constexpr int kSuperSize = 128;  // clusters a supercluster box covers

// Six rows of boxes: lo.xyz, hi.xyz.
struct Boxes {
  const float *lox, *loy, *loz, *hix, *hiy, *hiz;
};

// What a planner launch reads and writes.
struct PlanArgs {
  Boxes boxes;   // the cluster boxes (the first leaf boxes under kDual)
  Boxes second;  // the second leaf boxes (kDual), the union boxes (kSuper)
  int n_super;   // union boxes under kSuper, else 0
  const float *px, *py, *pz, *dx, *dy, *dz, *tf;
  const uint8_t* valid;
  int n_rays, tile_r, n_clusters;
  int n_keys;     // cluster_plan: C rounded up to a power of two (the sort)
  int chunk;      // clusters a pass of the sweep (cluster_plan: all C)
  int box_tiles;  // cluster_plan_rows: tiles a tilebox block plans
  float* entry_out;
  int32_t *visit_out, *nvis_out;  // cluster_plan
};

// min / max that propagate NaN, as jnp.minimum / maximum and jnp.min / max
// do (fminf / fmaxf drop it): one instruction each on sm_80 and later.
__device__ __forceinline__ float nan_min(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float nan_max(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

constexpr int kPlanWarps = kPlanThreads / 32;
constexpr int kMaxRaysAThread = 1024 / kPlanThreads;  // tile_r <= 1024
constexpr unsigned kMissBits = 0x7f7fffffu;  // FLT_MAX: no entry
constexpr uint16_t kPadId = 0xffffu;         // sorts last

// The tile's valid rays staged for the sweep, grouped by octant (the signs
// of 1 / d), two float4 each: (px, py, pz, tfp), (ix, iy, iz, 0), with tfp
// the largest float below tfar, so that `entry < tfar` is `entry <= tfp`.
// Octant o holds rays [s_oct[o], s_oct[o + 1]). Invalid lanes are left out:
// they enter no box. Returns after a barrier.
__device__ __forceinline__ void stage_octants(float4* s_ray, int* s_oct,
                                              const PlanArgs& a, int base) {
  __shared__ int s_in_octant[8];
  if (threadIdx.x < 8) s_in_octant[threadIdx.x] = 0;
  __syncthreads();
  float4 ra[kMaxRaysAThread], rb[kMaxRaysAThread];
  int oct[kMaxRaysAThread], at[kMaxRaysAThread];
#pragma unroll
  for (int k = 0; k < kMaxRaysAThread; ++k) {
    const int i = threadIdx.x + k * kPlanThreads;
    const int r = base + i;
    oct[k] = -1;
    if (i < a.tile_r && r < a.n_rays && __ldg(&a.valid[r]) != 0) {
      const float ix = __fdiv_rn(1.0f, __ldg(&a.dx[r]));
      const float iy = __fdiv_rn(1.0f, __ldg(&a.dy[r]));
      const float iz = __fdiv_rn(1.0f, __ldg(&a.dz[r]));
      ra[k] = make_float4(__ldg(&a.px[r]), __ldg(&a.py[r]), __ldg(&a.pz[r]),
                          nextafterf(__ldg(&a.tf[r]), -INFINITY));
      rb[k] = make_float4(ix, iy, iz, 0.0f);
      oct[k] = static_cast<int>(signbit(ix)) |
               (static_cast<int>(signbit(iy)) << 1) |
               (static_cast<int>(signbit(iz)) << 2);
      at[k] = atomicAdd(&s_in_octant[oct[k]], 1);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int o = 0; o < 8; ++o) {
      s_oct[o] = sum;
      sum += s_in_octant[o];
    }
    s_oct[8] = sum;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < kMaxRaysAThread; ++k) {
    if (oct[k] >= 0) {
      const int q = s_oct[oct[k]] + at[k];
      s_ray[2 * q] = ra[k];
      s_ray[2 * q + 1] = rb[k];
    }
  }
  __syncthreads();
}

// Whether the tile's valid directions are sign-coherent on all three axes
// (_sign_coherent: on each axis every d > 0 or every d < 0; so is a tile
// without a valid ray), by one block-wide OR of two bits an axis: some d is
// not > 0, some d is not < 0. Returns after a barrier.
__device__ __forceinline__ bool tile_coherent(const PlanArgs& a, int base) {
  __shared__ unsigned s_signs;
  if (threadIdx.x == 0) s_signs = 0;
  __syncthreads();
  unsigned signs = 0;
  for (int i = threadIdx.x; i < a.tile_r; i += blockDim.x) {
    const int r = base + i;
    if (r < a.n_rays && a.valid[r] != 0) {
      const float d[3] = {a.dx[r], a.dy[r], a.dz[r]};
#pragma unroll
      for (int ax = 0; ax < 3; ++ax) {
        signs |= (static_cast<unsigned>(!(d[ax] > 0.0f)) << (2 * ax)) |
                 (static_cast<unsigned>(!(d[ax] < 0.0f)) << (2 * ax + 1));
      }
    }
  }
  signs = __reduce_or_sync(0xffffffffu, signs);
  if ((threadIdx.x & 31) == 0 && signs) atomicOr(&s_signs, signs);
  __syncthreads();
  signs = s_signs;
  return (signs & 3u) != 3u && (signs & 12u) != 12u && (signs & 48u) != 48u;
}

// One batch of the sweep: kR slots of 32 clusters, lane l of the warp holding
// cluster 32 slot + l of each, as kBoxes boxes (two under 'group') with
// lo <= hi per axis (a NaN coordinate makes every slab product NaN).
template <int kBoxes, int kR>
struct Batch {
  float lo[kR][kBoxes][3], hi[kR][kBoxes][3];
  float e[kR];  // least entry so far, FLT_MAX for none
};

// The staged rays of octant kOct that this warp takes (every kPlanWarps-th)
// against a batch. Knowing the signs of 1 / d, the slab's near and far
// planes are known per axis: tmin is the max of the near products and tmax
// the min of the far ones, with the same values as the min / max pairs of
// _tile_entry_row ((lo - p) * i <= (hi - p) * i for i >= 0: rounding is
// monotone), and a NaN product propagates into one of them, which makes
// `exit >= entry` false as in the plain version. Ten instructions of
// arithmetic and eight min / max / compare a slab test; two 16-byte
// broadcast loads a ray for the kR x kBoxes tests of the batch.
template <int kOct, int kBoxes, int kR>
__device__ __forceinline__ void sweep_octant(const float4* s_ray, int begin,
                                             int end,
                                             Batch<kBoxes, kR>& bt) {
  constexpr bool nx = kOct & 1, ny = kOct & 2, nz = kOct & 4;
  for (int r = begin + (threadIdx.x >> 5); r < end; r += kPlanWarps) {
    const float4 a = s_ray[2 * r], b = s_ray[2 * r + 1];
#pragma unroll
    for (int j = 0; j < kR; ++j) {
#pragma unroll
      for (int g = 0; g < kBoxes; ++g) {
        const float* lo = bt.lo[j][g];
        const float* hi = bt.hi[j][g];
        const float t0x = __fmul_rn(__fsub_rn(nx ? hi[0] : lo[0], a.x), b.x);
        const float t1x = __fmul_rn(__fsub_rn(nx ? lo[0] : hi[0], a.x), b.x);
        const float t0y = __fmul_rn(__fsub_rn(ny ? hi[1] : lo[1], a.y), b.y);
        const float t1y = __fmul_rn(__fsub_rn(ny ? lo[1] : hi[1], a.y), b.y);
        const float t0z = __fmul_rn(__fsub_rn(nz ? hi[2] : lo[2], a.z), b.z);
        const float t1z = __fmul_rn(__fsub_rn(nz ? lo[2] : hi[2], a.z), b.z);
        const float entry = nan_max(nan_max(nan_max(t0x, t0y), t0z), 0.0f);
        const float exit = nan_min(nan_min(nan_min(t1x, t1y), t1z), a.w);
        if (exit >= entry) bt.e[j] = fminf(bt.e[j], entry);
      }
    }
  }
}

// Every staged ray of this warp's share against a batch, octant by octant.
template <int kBoxes, int kR>
__device__ __forceinline__ void sweep(const float4* s_ray, const int* s_oct,
                                      Batch<kBoxes, kR>& bt) {
  sweep_octant<0>(s_ray, s_oct[0], s_oct[1], bt);
  sweep_octant<1>(s_ray, s_oct[1], s_oct[2], bt);
  sweep_octant<2>(s_ray, s_oct[2], s_oct[3], bt);
  sweep_octant<3>(s_ray, s_oct[3], s_oct[4], bt);
  sweep_octant<4>(s_ray, s_oct[4], s_oct[5], bt);
  sweep_octant<5>(s_ray, s_oct[5], s_oct[6], bt);
  sweep_octant<6>(s_ray, s_oct[6], s_oct[7], bt);
  sweep_octant<7>(s_ray, s_oct[7], s_oct[8], bt);
}

// Load box c (or the NaN box past n) into a batch, lo and hi put in order
// with NaN kept, so that the near / far choice of sweep_octant holds for any
// box and the test equals the min / max pairs of the plain version.
__device__ __forceinline__ void load_box(const Boxes& b, int c, int n,
                                         float* lo, float* hi) {
  const float nan = __int_as_float(0x7fc00000);
  const float l[3] = {c < n ? b.lox[c] : nan, c < n ? b.loy[c] : nan,
                      c < n ? b.loz[c] : nan};
  const float h[3] = {c < n ? b.hix[c] : nan, c < n ? b.hiy[c] : nan,
                      c < n ? b.hiz[c] : nan};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    lo[k] = nan_min(l[k], h[k]);
    hi[k] = nan_max(l[k], h[k]);
  }
}

// One batch of kR slots from list position k: slot_of(k + j) for j below
// `left` (more positions are padding, NaN boxes). Every warp sweeps the
// batch on its share of the rays and folds each cluster's least entry into
// s_min[c - c0] (float bits: entries are >= 0, so they order as unsigned;
// -0 is made +0 first).
template <int kBoxes, int kR, typename SlotOf>
__device__ __forceinline__ void sweep_batch(const Boxes& b, const Boxes& b2,
                                            int n, int k, int left, int c0,
                                            SlotOf slot_of,
                                            const float4* s_ray,
                                            const int* s_oct,
                                            unsigned* s_min) {
  const int lane = threadIdx.x & 31;
  Batch<kBoxes, kR> bt;
  int at[kR];  // s_min index of each box, -1 for padding: one register each
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    const int c = j < left ? 32 * slot_of(k + j) + lane : n;
    load_box(b, c, n, bt.lo[j][0], bt.hi[j][0]);
    if (kBoxes == 2) load_box(b2, c, n, bt.lo[j][kBoxes - 1],
                              bt.hi[j][kBoxes - 1]);
    bt.e[j] = FLT_MAX;
    at[j] = c < n ? c - c0 : -1;
  }
  sweep(s_ray, s_oct, bt);
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    if (at[j] >= 0 && bt.e[j] < FLT_MAX) {
      atomicMin(&s_min[at[j]], __float_as_uint(__fadd_rn(bt.e[j], 0.0f)));
    }
  }
}

// The least entry over the tile's staged rays of each of the n boxes of
// the slots slot_of(0 .. n_slots - 1), into s_min[c - c0] (set to
// kMissBits by the caller). kWide: batches of 8 boxes a lane, the rest in
// batches of 2; else batches of 2 only, in fewer registers. Every warp takes
// every batch and an eighth of the rays, so the warps stay even whatever n
// is. Returns after a barrier.
template <int kBoxes, bool kWide, typename SlotOf>
__device__ __forceinline__ void sweep_slots(const Boxes& b, const Boxes& b2,
                                            int n, int n_slots, int c0,
                                            SlotOf slot_of,
                                            const float4* s_ray,
                                            const int* s_oct,
                                            unsigned* s_min) {
  constexpr int kRest = 2 / kBoxes, kFull = kWide ? 8 / kBoxes : kRest;
  int k = 0;
  for (; k + kFull <= n_slots; k += kFull) {
    sweep_batch<kBoxes, kFull>(b, b2, n, k, kFull, c0, slot_of, s_ray, s_oct,
                               s_min);
  }
  for (; k < n_slots; k += kRest) {
    sweep_batch<kBoxes, kRest>(b, b2, n, k, n_slots - k, c0, slot_of, s_ray,
                               s_oct, s_min);
  }
  __syncthreads();
}

__device__ __forceinline__ void fill(unsigned* a, int n, unsigned v) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) a[i] = v;
}

// Dynamic shared memory of a sweep block, in this order: the staged rays
// (2 tile_r float4), s_min (the `chunk` clusters swept at once), s_super
// (S), the chunk's slot list (chunk / 32 rounded up), and for cluster_plan's
// sort the ids (n_keys = C rounded up to a power of two, 2 bytes each; 0 for
// cluster_plan_rows). cluster_plan sweeps all C at once.
__host__ __device__ inline size_t plan_shared_bytes(int tile_r, int chunk,
                                                    int n_super, int n_keys) {
  return static_cast<size_t>(tile_r) * 32 +
         (static_cast<size_t>(chunk) + n_super + (chunk + 31) / 32) * 4 +
         static_cast<size_t>(n_keys) * 2;
}

__device__ __forceinline__ unsigned long long sort_key(const unsigned* s_min,
                                                       uint16_t id) {
  return id == kPadId ? ~0ull
                      : (static_cast<unsigned long long>(s_min[id]) << 32) | id;
}

// The tile's ray bundle of _tilebox_entry_row: per axis the masked min /
// max of origin (pl, ph) and direction (dl, dh) over the valid rays, the
// max of their tfar, whether any ray is valid. Invalid lanes count as
// +FLT_MAX in a min and -FLT_MAX in a max, as the JAX fills.
constexpr int kBundle = 14;  // pl.xyz, dl.xyz (mins); ph.xyz, dh.xyz, tfm,
                             // any (maxes)

// A tile's bundle as the box blocks test it, 16-byte aligned for broadcast
// loads: per axis the origin interval and the interval of 1 / direction
// (pl, ph, il, ih); the largest tfar; flags: kMixed << axis where the
// direction interval holds 0 (the axis then bounds nothing), kAnyValid,
// kCoherent (the 'hybrid' rule: on each axis dl > 0 or dh < 0).
struct TileBundle {
  float4 axis[3];
  float tfm;
  unsigned flags;
};
constexpr unsigned kMixed = 1, kAnyValid = 8, kCoherent = 16;

// One axis of the bundle from its (pl, ph, dl, dh).
__device__ __forceinline__ float4 bundle_axis(float pl, float ph, float dl,
                                              float dh, bool mixed) {
  const float inv_a = __fdiv_rn(1.0f, mixed ? 1.0f : dh);
  const float inv_b = __fdiv_rn(1.0f, mixed ? 1.0f : dl);
  return make_float4(pl, ph, nan_min(inv_a, inv_b), nan_max(inv_a, inv_b));
}

// The bundle of `tile`, reduced by one warp: each lane folds every 32nd ray
// with min / max that propagate NaN, as the JAX reductions do, then
// shuffles fold the lanes. Every lane returns it.
__device__ __forceinline__ TileBundle tile_bundle(const PlanArgs& a,
                                                  int tile) {
  float v[kBundle];
#pragma unroll
  for (int k = 0; k < 6; ++k) v[k] = FLT_MAX;
#pragma unroll
  for (int k = 6; k < kBundle; ++k) v[k] = -FLT_MAX;
  const int base = tile * a.tile_r;
  for (int i = threadIdx.x & 31; i < a.tile_r; i += 32) {
    const int r = base + i;
    if (!(r < a.n_rays && __ldg(&a.valid[r]) != 0)) continue;
    const float x[6] = {__ldg(&a.px[r]), __ldg(&a.py[r]), __ldg(&a.pz[r]),
                        __ldg(&a.dx[r]), __ldg(&a.dy[r]), __ldg(&a.dz[r])};
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      v[k] = nan_min(v[k], x[k]);
      v[6 + k] = nan_max(v[6 + k], x[k]);
    }
    v[12] = nan_max(v[12], __ldg(&a.tf[r]));
    v[13] = 1.0f;
  }
#pragma unroll
  for (int k = 0; k < kBundle; ++k) {
    for (int o = 16; o > 0; o >>= 1) {
      const float w = __shfl_xor_sync(0xffffffffu, v[k], o);
      v[k] = k < 6 ? nan_min(v[k], w) : nan_max(v[k], w);
    }
  }
  TileBundle t;
  t.tfm = v[12];
  t.flags = (v[13] > 0.0f ? kAnyValid : 0u) | kCoherent;
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    const float dl = v[3 + ax], dh = v[9 + ax];
    const bool mixed = dl <= 0.0f && dh >= 0.0f;
    t.axis[ax] = bundle_axis(v[ax], v[6 + ax], dl, dh, mixed);
    t.flags |= mixed ? kMixed << ax : 0u;
    if (!(dl > 0.0f || dh < 0.0f)) t.flags &= ~kCoherent;
  }
  return t;
}

// The axis's bounds (lower bound of tmin, upper bound of tmax) for the box
// [lo, hi] on that axis, the products of _tilebox_entry_row's axis(); `a`
// is (pl, ph, il, ih).
__device__ __forceinline__ void axis_bounds(float4 a, bool mixed, float lo,
                                            float hi, float* lb, float* ub) {
  const float lp = __fsub_rn(lo, a.y), ll = __fsub_rn(lo, a.x);
  const float hp = __fsub_rn(hi, a.y), hl = __fsub_rn(hi, a.x);
  const float a1 = __fmul_rn(lp, a.z), a2 = __fmul_rn(lp, a.w);
  const float a3 = __fmul_rn(ll, a.z), a4 = __fmul_rn(ll, a.w);
  const float b1 = __fmul_rn(hp, a.z), b2 = __fmul_rn(hp, a.w);
  const float b3 = __fmul_rn(hl, a.z), b4 = __fmul_rn(hl, a.w);
  const float t_lo_lb = nan_min(nan_min(a1, a2), nan_min(a3, a4));
  const float t_lo_ub = nan_max(nan_max(a1, a2), nan_max(a3, a4));
  const float t_hi_lb = nan_min(nan_min(b1, b2), nan_min(b3, b4));
  const float t_hi_ub = nan_max(nan_max(b1, b2), nan_max(b3, b4));
  *lb = mixed ? -FLT_MAX : nan_min(t_lo_lb, t_hi_lb);
  *ub = mixed ? FLT_MAX : nan_max(t_lo_ub, t_hi_ub);
}

// _tilebox_entry_row for the box [lo, hi]: a lower bound of every valid
// ray's entry, FLT_MAX where the bundle cannot enter the box before its
// largest tfar; +0, never -0.
__device__ __forceinline__ float tilebox_entry(const float* lo,
                                               const float* hi,
                                               const TileBundle& t) {
  float xlb, xub, ylb, yub, zlb, zub;
  axis_bounds(t.axis[0], t.flags & kMixed, lo[0], hi[0], &xlb, &xub);
  axis_bounds(t.axis[1], t.flags & kMixed << 1, lo[1], hi[1], &ylb, &yub);
  axis_bounds(t.axis[2], t.flags & kMixed << 2, lo[2], hi[2], &zlb, &zub);
  const float entry = nan_max(nan_max(nan_max(xlb, ylb), zlb), 0.0f);
  const float exit_ub = nan_min(nan_min(xub, yub), zub);
  const bool hit = exit_ub >= entry && entry < t.tfm && (t.flags & kAnyValid);
  return hit ? __fadd_rn(entry, 0.0f) : FLT_MAX;
}

// A box block of cluster_plan_rows: the tilebox rows of tiles [g0, g0 +
// box_tiles) ('tilebox'; under 'hybrid' those of them that are
// sign-coherent). Warp w reduces tile g0 + w's bundle; then each thread
// loads each of its boxes once and tests it against every bundle of the
// block, and each tile's row is written coalesced.
template <int kMode>
__device__ __forceinline__ void tilebox_rows(const PlanArgs& a, int g0,
                                             int n_tiles) {
  __shared__ TileBundle s_bundle[kPlanWarps];  // float4s: 16-byte aligned
  const int warp = threadIdx.x >> 5;
  const int n_here = min(a.box_tiles, n_tiles - g0);
  if (warp < n_here) {
    const TileBundle t = tile_bundle(a, g0 + warp);
    if ((threadIdx.x & 31) == 0) s_bundle[warp] = t;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < a.n_clusters; c += blockDim.x) {
    const float lo[3] = {a.boxes.lox[c], a.boxes.loy[c], a.boxes.loz[c]};
    const float hi[3] = {a.boxes.hix[c], a.boxes.hiy[c], a.boxes.hiz[c]};
#pragma unroll
    for (int g = 0; g < kPlanWarps; ++g) {
      if (g >= n_here) break;
      const TileBundle t = s_bundle[g];
      if (kMode == kHybrid && !(t.flags & kCoherent)) continue;
      a.entry_out[static_cast<size_t>(g0 + g) * a.n_clusters + c] =
          tilebox_entry(lo, hi, t);
    }
  }
}

// A sweep block's pass over clusters [c0, c1) (c0 on a slot of 32): their
// least entries over the staged rays into s_min[c - c0]. 'super' takes the
// 32-cluster slots whose union was entered (s_super), listed in s_list
// with *s_count as its counter (0 on entry and on return); the other exact
// modes take every slot. Returns after a barrier.
template <int kMode, bool kWide>
__device__ __forceinline__ void sweep_chunk(const PlanArgs& a, int c0, int c1,
                                            const float4* s_ray,
                                            const int* s_oct,
                                            const unsigned* s_super,
                                            int* s_list, int* s_count,
                                            unsigned* s_min) {
  const int s0 = c0 / 32, s1 = (c1 + 31) / 32;  // the chunk's slots
  fill(s_min, c1 - c0, kMissBits);
  if (kMode == kSuper) {
    for (int s = s0 + threadIdx.x; s < s1; s += blockDim.x) {
      if (s_super[s * 32 / kSuperSize] != kMissBits) {
        s_list[atomicAdd(s_count, 1)] = s;
      }
    }
    __syncthreads();
    const int n_list = *s_count;
    __syncthreads();
    if (threadIdx.x == 0) *s_count = 0;
    sweep_slots<1, kWide>(a.boxes, a.boxes, a.n_clusters, n_list, c0,
                          [s_list](int k) { return s_list[k]; }, s_ray, s_oct,
                          s_min);
  } else {
    __syncthreads();  // s_min is filled
    sweep_slots<kMode == kDual ? 2 : 1, kWide>(
        a.boxes, a.second, a.n_clusters, s1 - s0, c0,
        [s0](int k) { return s0 + k; }, s_ray, s_oct, s_min);
  }
}

// kWide: register blocks of 8 boxes a lane, for C above kNarrowClusters;
// else blocks of 2, and the registers for 4 blocks an SM (a small C leaves
// little work per tile, and latency, not issue, bounds it). Left alone,
// ptxas gives the wide kernels 160-168 registers, one block an SM; at 3
// blocks (80 registers) they ran fastest without a spill, 'super' at 2
// (128: at 80 its two sweeps spill).
constexpr int kNarrowClusters = 256;

// cluster_plan (kRows false) and cluster_plan_rows (kRows) in one body.
// A sweep block plans one tile: it stages the tile's valid rays by octant
// and sweeps the cluster boxes past them `chunk` clusters at a time,
// folding each cluster's least entry into s_min; cluster_plan (one chunk of
// all C) then compacts the entered ids and sorts them, cluster_plan_rows
// writes each chunk's part of the row from s_min, coalesced. 'super' sweeps
// the S union boxes once a tile, then in each chunk the 32-cluster slots of
// the entered unions (a chunk starts on a slot, and a slot's 32 clusters
// lie in one union). Every block of 'ray', 'group' and 'super' is a sweep
// block; under 'tilebox' every block is a box block (tilebox_rows); under
// 'hybrid' the first T blocks sweep the tiles that are not sign-coherent
// and leave the others to the box blocks after them.
template <int kMode, bool kWide, bool kRows>
__global__ void __launch_bounds__(kPlanThreads,
                                  kWide ? (kMode == kSuper ? 2 : 3) : 4)
plan_kernel(const PlanArgs a) {
  extern __shared__ float4 s_ray[];
  __shared__ int s_oct[9];
  __shared__ int s_count;
  const int n_tiles = (a.n_rays + a.tile_r - 1) / a.tile_r;
  if constexpr (kMode == kTilebox || kMode == kHybrid) {
    const int box_block = static_cast<int>(blockIdx.x) -
                          (kMode == kHybrid ? n_tiles : 0);
    if (box_block >= 0) {
      tilebox_rows<kMode>(a, box_block * a.box_tiles, n_tiles);
      return;
    }
  }
  if constexpr (kMode != kTilebox) {
    const int tile = blockIdx.x;
    const int chunk = kRows ? a.chunk : a.n_clusters;
    const int n_super = kMode == kSuper ? a.n_super : 0;
    unsigned* s_min = reinterpret_cast<unsigned*>(s_ray + 2 * a.tile_r);
    unsigned* s_super = s_min + chunk;
    int* s_list = reinterpret_cast<int*>(s_super + n_super);
    if (kMode == kHybrid && tile_coherent(a, tile * a.tile_r)) {
      return;  // a box block writes this tile's row
    }
    if (threadIdx.x == 0) s_count = 0;
    fill(s_super, n_super, kMissBits);
    stage_octants(s_ray, s_oct, a, tile * a.tile_r);
    if (kMode == kSuper) {  // phase A: the union boxes
      sweep_slots<1, kWide>(a.second, a.second, n_super, (n_super + 31) / 32,
                            0, [](int k) { return k; }, s_ray, s_oct,
                            s_super);
    }
    const size_t row = static_cast<size_t>(tile) * a.n_clusters;
    if constexpr (kRows) {
      for (int c0 = 0; c0 < a.n_clusters; c0 += a.chunk) {
        const int c1 = min(c0 + a.chunk, a.n_clusters);
        sweep_chunk<kMode, kWide>(a, c0, c1, s_ray, s_oct, s_super, s_list,
                                  &s_count, s_min);
        for (int c = c0 + threadIdx.x; c < c1; c += blockDim.x) {
          // kMissBits are FLT_MAX's bits
          a.entry_out[row + c] = __uint_as_float(s_min[c - c0]);
        }
        __syncthreads();  // before s_min is filled again
      }
    }
    if constexpr (!kRows) {
      const int n_clusters = a.n_clusters;
      sweep_chunk<kMode, kWide>(a, 0, n_clusters, s_ray, s_oct, s_super,
                                s_list, &s_count, s_min);
      uint16_t* s_ids =
          reinterpret_cast<uint16_t*>(s_list + (n_clusters + 31) / 32);
      // the entered clusters' ids, one atomic a warp and 32 clusters
      for (int c0 = threadIdx.x & ~31; c0 < n_clusters; c0 += blockDim.x) {
        const int c = c0 + (threadIdx.x & 31);
        const bool in = c < n_clusters && s_min[c] != kMissBits;
        const unsigned ballot = __ballot_sync(0xffffffffu, in);
        int first = 0;
        if ((threadIdx.x & 31) == 0 && ballot) {
          first = atomicAdd(&s_count, __popc(ballot));
        }
        first = __shfl_sync(0xffffffffu, first, 0);
        if (in) {
          s_ids[first + __popc(ballot & ((1u << (threadIdx.x & 31)) - 1))] =
              static_cast<uint16_t>(c);
        }
      }
      __syncthreads();
      const int n_vis = s_count;
      int n_sort = 1;
      while (n_sort < n_vis) n_sort <<= 1;
      // bitonic sort, ascending: by entry, then by cluster id. Up to 32 keys
      // one warp sorts them in registers, with no block barrier a step.
      if (n_sort <= 32) {
        if (threadIdx.x < 32) {
          const int lane = threadIdx.x;
          unsigned long long key =
              sort_key(s_min, lane < n_vis ? s_ids[lane] : kPadId);
          for (int k = 2; k <= 32; k <<= 1) {
            for (int j = k >> 1; j > 0; j >>= 1) {
              const unsigned long long other =
                  __shfl_xor_sync(0xffffffffu, key, j);
              const bool low = key < other;
              // the lower lane of a pair keeps the lesser key where ascending
              key =
                  (((lane & j) == 0) == ((lane & k) == 0)) == low ? key : other;
            }
          }
          if (lane < n_vis) s_ids[lane] = static_cast<uint16_t>(key);
        }
        __syncthreads();
        n_sort = 0;  // sorted
      }
      for (int i = n_vis + threadIdx.x; i < n_sort; i += blockDim.x) {
        s_ids[i] = kPadId;
      }
      __syncthreads();
      for (int k = 2; k <= n_sort; k <<= 1) {
        for (int j = k >> 1; j > 0; j >>= 1) {
          for (int i = threadIdx.x; i < n_sort; i += blockDim.x) {
            const int partner = i ^ j;
            if (partner > i) {
              const uint16_t x = s_ids[i], y = s_ids[partner];
              const bool ascending = (i & k) == 0;
              if ((sort_key(s_min, x) > sort_key(s_min, y)) == ascending) {
                s_ids[i] = y;
                s_ids[partner] = x;
              }
            }
          }
          __syncthreads();
        }
      }
      for (int i = threadIdx.x; i < n_clusters; i += blockDim.x) {
        const bool seen = i < n_vis;
        const int id = seen ? s_ids[i] : -1;
        a.entry_out[row + i] = seen ? __uint_as_float(s_min[id]) : FLT_MAX;
        a.visit_out[row + i] = id;
      }
      if (threadIdx.x == 0) a.nvis_out[tile] = n_vis;
    }
  }
}

// ---------------------------------------------------------------------------
// Batteries: one ray against one staged primitive
// ---------------------------------------------------------------------------
// b = d . (c - p) and rsq - |c - p|^2 (sphere_battery.cu's pair_terms)
struct PairTerms {
  float b, rsq_minus_len2;
};

__device__ __forceinline__ PairTerms pair_terms(const Ray& r, float4 s) {
  const float tx = __fsub_rn(s.x, r.px);
  const float ty = __fsub_rn(s.y, r.py);
  const float tz = __fsub_rn(s.z, r.pz);
  const float b = dot3(r.dx, r.dy, r.dz, tx, ty, tz);
  const float len2 = dot3(tx, ty, tz, tx, ty, tz);
  return PairTerms{b, __fsub_rn(s.w, len2)};
}

// _sphere_battery: the near root, else the far root; FLT_MAX on a miss.
__device__ __forceinline__ float sphere_t(const Ray& r, float4 s) {
  const PairTerms pt = pair_terms(r, s);
  const float b = pt.b;
  const float disc = fma32(b, b, pt.rsq_minus_len2);
  const float sq = __fsqrt_rn(fmaxf(disc, 0.0f));
  const float t_near = __fsub_rn(b, sq);
  const float t = t_near < 0.0f ? __fadd_rn(b, sq) : t_near;
  return (disc >= 0.0f && t >= 0.0f) ? t : FLT_MAX;
}

// _sphere_anyhit_battery: the sqrt-free predicate. b*b has three uses, so
// it is not fused into disc.
__device__ __forceinline__ bool sphere_occludes(const Ray& r, float tf,
                                                float4 s) {
  const PairTerms pt = pair_terms(r, s);
  const float b = pt.b;
  const float bb = __fmul_rn(b, b);
  const float disc = __fadd_rn(pt.rsq_minus_len2, bb);
  const float e = __fsub_rn(b, tf);
  const float q = __fmul_rn(e, e);
  const bool near_ge0 = (b >= 0.0f) && (bb >= disc);
  const bool hit_near = (e < 0.0f) || (q < disc);
  const bool far_ge0 = (b >= 0.0f) || (bb <= disc);
  const bool hit_far = (e < 0.0f) && (disc < q);
  return disc >= 0.0f && (near_ge0 ? hit_near : (far_ge0 && hit_far));
}

// _triangle_battery (Baldwin-Weber planes): rows = (n, d0), (f1, g1),
// (f2, g2). u and v sum their three products as XLA contracts them and add
// g unfused.
__device__ __forceinline__ float triangle_t(const Ray& r, float4 n, float4 f1,
                                            float4 f2) {
  const float den = dot3(n.x, n.y, n.z, r.dx, r.dy, r.dz);
  const float num = __fsub_rn(n.w, dot3(n.x, n.y, n.z, r.px, r.py, r.pz));
  const float t = __fdiv_rn(num, den);
  const float qx = fma32(t, r.dx, r.px);
  const float qy = fma32(t, r.dy, r.py);
  const float qz = fma32(t, r.dz, r.pz);
  const float u = __fadd_rn(dot3(f1.x, f1.y, f1.z, qx, qy, qz), f1.w);
  const float v = __fadd_rn(dot3(f2.x, f2.y, f2.z, qx, qy, qz), f2.w);
  const bool valid = fabsf(den) > 1e-12f && u >= 0.0f && v >= 0.0f &&
                     __fadd_rn(u, v) <= 1.0f && t > 1e-6f;
  return valid ? t : FLT_MAX;
}

// One element of a [., 3] x [3, .] product: k = 0, 1, 2 in order, a fused
// multiply-add per step (_mat3 of the plain version).
__device__ __forceinline__ float mat3(float ax, float ay, float az, float bx,
                                      float by, float bz) {
  return fma32(az, bz, fma32(ay, by, __fmul_rn(ax, bx)));
}

// _triangle_battery_mxu: the ray's rows of dmat x m and pmat x m for one
// triangle (columns n, f1, f2 of m), then t, u and v without the hit point.
__device__ __forceinline__ float triangle_product_t(const Ray& r, float4 n,
                                                    float4 f1, float4 f2) {
  const float den = mat3(r.dx, r.dy, r.dz, n.x, n.y, n.z);
  const float f1d = mat3(r.dx, r.dy, r.dz, f1.x, f1.y, f1.z);
  const float f2d = mat3(r.dx, r.dy, r.dz, f2.x, f2.y, f2.z);
  const float pn = mat3(r.px, r.py, r.pz, n.x, n.y, n.z);
  const float f1p = mat3(r.px, r.py, r.pz, f1.x, f1.y, f1.z);
  const float f2p = mat3(r.px, r.py, r.pz, f2.x, f2.y, f2.z);
  const float t = __fdiv_rn(__fsub_rn(n.w, pn), den);
  const float u = __fadd_rn(fma32(t, f1d, f1p), f1.w);
  const float v = __fadd_rn(fma32(t, f2d, f2p), f2.w);
  const bool valid = fabsf(den) > 1e-12f && u >= 0.0f && v >= 0.0f &&
                     __fadd_rn(u, v) <= 1.0f && t > 1e-6f;
  return valid ? t : FLT_MAX;
}

// The `battery` argument of the walks' entry points.
constexpr int kSphere = 0;
constexpr int kTriangle = 1;
constexpr int kTriangleProduct = 2;

template <int kBattery>
__device__ __forceinline__ float prim_t(const Ray& r, const float4* rows,
                                        int k) {
  if (kBattery == kTriangle) {
    return triangle_t(r, rows[3 * k], rows[3 * k + 1], rows[3 * k + 2]);
  }
  if (kBattery == kTriangleProduct) {
    return triangle_product_t(r, rows[3 * k], rows[3 * k + 1],
                              rows[3 * k + 2]);
  }
  return sphere_t(r, rows[k]);
}

// cp.async: a 4-byte copy from global to shared memory that the thread
// does not wait for; copies are grouped by commit and awaited by group.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most kPending of this thread's commit groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Start the copy of cluster c's kAttrs attribute rows (K floats each, at the
// head of its packed rows; the zero rows are left out) into a slot,
// transposed to the resident tables' layout: prim k's attributes as
// kAttrs / 4 float4 (sphere: c, rsq; triangle: n, d0 | f1, g1 | f2, g2), so
// that the battery reads a prim in one or three 16-byte loads. Consecutive
// threads read consecutive floats of an attribute row.
template <int kAttrs>
__device__ __forceinline__ void fetch_cluster(float4* slot,
                                              const float* __restrict__ packed,
                                              int c, int k_prims,
                                              int cluster_floats) {
  const float* src = packed + static_cast<size_t>(c) * cluster_floats;
  float* dst = reinterpret_cast<float*>(slot);
  const int n = kAttrs * k_prims;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int attr = i / k_prims;
    cp_async4(dst + (i - attr * k_prims) * kAttrs + attr, src + i);
  }
}

// Start bringing the line of `p` into L1; nothing waits for it.
__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// cp.async of 16 bytes (both addresses 16-byte aligned), past L1.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem)
               : "memory");
}

// Start the copy of cluster c's n4 float4 of the resident [C * K, F] table
// into a slot: they are contiguous and already in the batteries' layout.
__device__ __forceinline__ void fetch_rows(float4* slot,
                                           const float4* __restrict__ table,
                                           int c, int n4) {
  const float4* src = table + static_cast<size_t>(c) * n4;
  for (int i = threadIdx.x; i < n4; i += blockDim.x) {
    cp_async16(slot + i, src + i);
  }
}

__device__ __forceinline__ Ray load_ray(const float* px, const float* py,
                                        const float* pz, const float* dx,
                                        const float* dy, const float* dz,
                                        int i) {
  return Ray{px[i], py[i], pz[i], dx[i], dy[i], dz[i]};
}

// ---------------------------------------------------------------------------
// The split walks: cluster_closest, cluster_occluded and their streamed forms
// ---------------------------------------------------------------------------
constexpr int kMaxBlock = 1024;  // threads a block: tile_r * S at most

// The loop of the split walks. Visit j's rows are in slot j & 1. The copy of
// visit j + 1 is started before the wait for visit j, into the slot that
// visit j - 1 used: the two barriers of that visit's block_max lie between
// its reads and this overwrite. One commit group per trip, empty where there
// is no next visit, so that "all but the newest group" is always "visit j
// has landed". `fetch(slot, c)` starts the copies of cluster c's n4 float4
// into a slot; `visit_fn(c, rows)` runs the battery on the staged rows
// (prim k at rows[k * n4 / K]) and returns the tile's new exit bound.
// Without kExit (stream_replay) the loop takes every visit j < n in order
// and reads neither `entry_row` nor the bound. Returns the visits walked.
template <bool kExit = true, typename Fetch, typename Visit>
__device__ __forceinline__ int stream_walk(
    const int32_t* __restrict__ visit_row, const float* __restrict__ entry_row,
    int n, float mx, int n4, float4* slots, Fetch fetch, Visit visit_fn) {
  if (n > 0) fetch(slots, visit_row[0]);
  cp_async_commit();
  int j = 0;
  for (; j < n; ++j) {
    if (kExit && !(entry_row[j] < mx)) break;  // uniform: mx is the block's
    if (j + 1 < n) fetch(slots + ((j + 1) & 1) * n4, visit_row[j + 1]);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's part of visit j has landed
    __syncthreads();     // and every other thread's
    mx = visit_fn(visit_row[j], slots + (j & 1) * n4);
  }
  cp_async_wait<0>();  // a copy started for a visit the exit skipped
  return j;
}

// Start the copy of cluster c's rows into a slot: 16-byte copies of the
// resident [C * K, F] table, already in the batteries' layout, or the
// transposing 4-byte copies of the packed [C * F8, K] table (kPacked).
template <int kBattery, bool kPacked>
__device__ __forceinline__ void fetch_visit(float4* slot,
                                            const float* __restrict__ table,
                                            int c, int k_prims) {
  constexpr int kAttrs = kBattery == kSphere ? 4 : 12;
  if (kPacked) {
    fetch_cluster<kAttrs>(slot, table, c, k_prims,
                          (kBattery == kSphere ? 8 : 16) * k_prims);
  } else {
    fetch_rows(slot, reinterpret_cast<const float4*>(table), c,
               kAttrs / 4 * k_prims);
  }
}

// The tile's live rays packed to the front: thread t < tile_r says in `live`
// whether position t is live and gives its `value`; afterwards s_rays[q] is
// the value of the q-th live position, in order, and the count is returned.
// One ballot per warp, then one warp scans the warps' counts (s_scan: 33
// ints). The caller's reads of s_rays may precede the call: the first write
// follows two barriers. Returns after a barrier.
__device__ __forceinline__ int pack_live(bool live, int value, int* s_rays,
                                         int* s_scan) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, live);
  if (lane == 0) s_scan[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const int n_warps = (blockDim.x + 31) >> 5;
    const int v = lane < n_warps ? s_scan[lane] : 0;
    int incl = v;
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += u;
    }
    s_scan[lane] = incl - v;  // the warps before this one
    if (lane == 31) s_scan[32] = incl;
  }
  __syncthreads();
  if (live) {
    s_rays[s_scan[warp] + __popc(ballot & ((1u << lane) - 1))] = value;
  }
  __syncthreads();
  return s_scan[32];
}

// The S-way split, for S = kS in {1, 2, 4}: thread t works on the live ray
// q = t / S of the packed order, and owns the slots k = t % S (mod S) of
// each staged cluster, walked in ascending order. The S threads of a ray
// are adjacent lanes of one warp. A warp whose first ray position is past
// the live count holds no live ray and skips the battery on a uniform
// branch (it still joins the barriers); in a warp that holds one, every lane
// runs the battery, so the shuffles see all 32 lanes, and a thread without
// a ray discards its result.
struct Split {
  int q, s;        // ray position in the packed order, slot residue
  bool has_ray;    // q < the tile's live count
  bool warp_live;  // some ray of this warp is live (uniform over the warp)
};

template <int kS>
__device__ __forceinline__ Split split_of(int n_live) {
  const int q = threadIdx.x / kS;
  return Split{q, static_cast<int>(threadIdx.x % kS), q < n_live,
               static_cast<int>(threadIdx.x & ~31u) / kS < n_live};
}

// A split walk's thread: its share of the split, and its ray (the q-th live
// ray of the tile): index, origin and direction, starting tfar and the exit
// bound it holds the tile to, min(tfar, exit from the root box), or
// -FLT_MAX without a ray.
struct Lane {
  Split sp;
  int i;
  Ray r;
  float tf, bound;
};

template <int kS>
__device__ __forceinline__ Lane lane_of(
    int n_live, int base, const int* s_rays, const float* __restrict__ root,
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tf) {
  Lane l{split_of<kS>(n_live), 0, Ray{}, 0.0f, -FLT_MAX};
  if (l.sp.has_ray) {
    l.i = base + s_rays[l.sp.q];
    l.r = load_ray(px, py, pz, dx, dy, dz, l.i);
    l.tf = tf[l.i];
    l.bound = fminf(l.tf, root_exit(root, l.r));
  }
  return l;
}

// The walks' work counters, in the kCount forms of the walk bodies: the
// overload of each walk kernel that takes a WalkCounts, which the entry
// points launch where `counts` is not null (the wrapper passes null unless
// a profiler session records). The kernels without it are the walks' code
// alone, so the timed path pays nothing for counting; both overloads keep
// the kernel's name, which the trace's readers match.
// A kCount walk adds to counts[0] the (valid ray, real prim) pairs it
// needs, the plain walks' count (ops/kernels/cluster_traverse.py:
// walk_closest_plain, walk_occluded_plain): the closest walk every ray
// against every real prim of each visit, the any-hit walk a ray not yet
// occluded against the real prims up to and including its first occluder
// in slot order (a thread of the split may test past it: those tests are
// not counted), and to counts[1] the visits it walks. A cluster's real
// prims fill its first `filled[c]` slots (every builder of
// ops/clustered.py packs them so). Each thread sums its ray's pairs, and
// each warp adds its sum with one atomicAdd when the block is done.
struct WalkCounts {
  const int32_t* filled;      // [C] real prims a cluster
  unsigned long long* counts;  // [2]: pairs, visits
};

// The block's counts, added once it is done: a warp's pairs summed by
// shuffles (every thread of the block reaches this), then one atomicAdd a
// warp, and the visits by thread 0.
template <bool kCount>
__device__ __forceinline__ void add_counts(const WalkCounts& wc,
                                           unsigned long long pairs,
                                           int visits) {
  if (!kCount) return;
  for (int o = 16; o > 0; o >>= 1) {
    pairs += __shfl_xor_sync(0xffffffffu, pairs, o);
  }
  if ((threadIdx.x & 31) == 0 && pairs) atomicAdd(&wc.counts[0], pairs);
  if (threadIdx.x == 0 && visits) {
    atomicAdd(&wc.counts[1], static_cast<unsigned long long>(visits));
  }
}

// The closest walk's kernel parameters, and their names.
#define CLOSEST_PARAMS                                                      \
  const int32_t *__restrict__ nvis, const int32_t *__restrict__ visit,      \
      const float *__restrict__ entry, const float *__restrict__ root,      \
      const float *__restrict__ px, const float *__restrict__ py,           \
      const float *__restrict__ pz, const float *__restrict__ dx,           \
      const float *__restrict__ dy, const float *__restrict__ dz,           \
      const float *__restrict__ tf0, const uint8_t *__restrict__ valid,     \
      const float *__restrict__ table, int n_rays, int tile_r,              \
      int n_clusters, int k_prims, float *__restrict__ tfar_out,            \
      int32_t *__restrict__ prim_out
#define CLOSEST_NAMES                                                       \
  nvis, visit, entry, root, px, py, pz, dx, dy, dz, tf0, valid, table,      \
      n_rays, tile_r, n_clusters, k_prims, tfar_out, prim_out

// cluster_closest (kPacked false: the resident [C * K, F] table) and
// cluster_closest_stream (kPacked: the packed table) in one body.
template <int kBattery, bool kPacked, int kS, bool kCount>
__device__ __forceinline__ void closest_walk(CLOSEST_PARAMS,
                                             const WalkCounts& wc) {
  extern __shared__ float4 slots[];  // two slots of n4 float4
  __shared__ float s_red[32];
  __shared__ int s_rays[kMaxBlock];
  __shared__ int s_scan[33];
  const int tile = blockIdx.x;
  const int base = tile * tile_r;
  bool own_live = false;
  const int t = threadIdx.x;
  if (t < tile_r && base + t < n_rays) {
    const int i = base + t;
    own_live = valid[i] != 0;
    if (!own_live) {  // a lane the walk leaves as it is: (tf0, -1)
      tfar_out[i] = tf0[i];
      prim_out[i] = -1;
    }
  }
  const Lane l = lane_of<kS>(pack_live(own_live, t, s_rays, s_scan), base,
                             s_rays, root, px, py, pz, dx, dy, dz, tf0);
  const Split& sp = l.sp;
  float best = l.tf;
  int32_t best_id = -1;
  unsigned long long pairs = 0;  // counted only under kCount
  const size_t row = static_cast<size_t>(tile) * n_clusters;
  const int visits = stream_walk(
      visit + row, entry + row, nvis[tile], block_max(l.bound, s_red),
      (kBattery == kSphere ? 1 : 3) * k_prims, slots,
      [&](float4* slot, int c) {
        fetch_visit<kBattery, kPacked>(slot, table, c, k_prims);
      },
      [&](int c, const float4* rows) {
        if (kCount && sp.has_ray && sp.s == 0) {
          pairs += __ldg(&wc.filled[c]);
        }
        if (sp.warp_live) {
          float tl = INFINITY;  // this thread's slots: least t, first slot
          int kl = k_prims;
          for (int k = sp.s; k < k_prims; k += kS) {
            const float t = prim_t<kBattery>(l.r, rows, k);
            if (t < tl) {
              tl = t;
              kl = k;
            }
          }
          // over the ray's S threads: the least t, the lowest slot of equals
          for (int o = 1; o < kS; o <<= 1) {
            const float to = __shfl_xor_sync(0xffffffffu, tl, o);
            const int ko = __shfl_xor_sync(0xffffffffu, kl, o);
            if (to < tl || (to == tl && ko < kl)) {
              tl = to;
              kl = ko;
            }
          }
          // strict: an earlier visit keeps a tie
          if (sp.has_ray && tl < best) {
            best = tl;
            best_id = c * k_prims + kl;
          }
        }
        return block_max(sp.has_ray ? fminf(best, l.bound) : -FLT_MAX,
                         s_red);
      });
  if (sp.has_ray && sp.s == 0) {
    tfar_out[l.i] = best;
    prim_out[l.i] = best_id;
  }
  add_counts<kCount>(wc, pairs, visits);
}

template <int kBattery, bool kPacked, int kS>
__global__ void __launch_bounds__(kMaxBlock) closest_kernel(CLOSEST_PARAMS) {
  closest_walk<kBattery, kPacked, kS, false>(CLOSEST_NAMES, WalkCounts{});
}

template <int kBattery, bool kPacked, int kS>
__global__ void __launch_bounds__(kMaxBlock)
    closest_kernel(CLOSEST_PARAMS, const WalkCounts wc) {
  closest_walk<kBattery, kPacked, kS, true>(CLOSEST_NAMES, wc);
}

// The any-hit test of one staged prim: the sqrt-free sphere predicate, or
// the triangle battery's t below tfar.
template <int kBattery>
__device__ __forceinline__ bool occludes(const Ray& r, float tf,
                                         const float4* rows, int k) {
  if (kBattery == kSphere) return sphere_occludes(r, tf, rows[k]);
  return prim_t<kBattery>(r, rows, k) < tf;
}

// Whether one of the staged cluster's prims occludes this thread's ray,
// over its S threads (an OR: any schedule of the slots gives the same
// bits). Each thread leaves its slots at its first hit, whose slot it puts
// in *first (k_prims where it has none). (A vote of the ray's S threads
// every 4 slots, so that they leave together, was slower on every table and
// batch at the wrapper's S, by 0.3-23%: PERF.md.)
template <int kBattery, int kS>
__device__ __forceinline__ bool any_hit(const Lane& l, const float4* rows,
                                        int k_prims, bool need, int* first) {
  bool hit = false;
  int k = l.sp.s;
  for (; need && k < k_prims; k += kS) {
    hit = occludes<kBattery>(l.r, l.tf, rows, k);
    if (hit) break;
  }
  *first = hit ? k : k_prims;
  for (int o = 1; o < kS; o <<= 1) {
    hit = __shfl_xor_sync(0xffffffffu, static_cast<int>(hit), o) || hit;
  }
  return hit;
}

// cluster_occluded (kPacked false) and cluster_occluded_stream (kPacked) in
// one body: whether any prim lies at t in [0, tfar). A lane with tfar <= 0
// (or NaN) is invalid and never occluded. The block's exit bound counts the
// unoccluded rays only, so the walk ends once every ray is occluded.
// (Re-packing the unoccluded rays to the front once their count halved won
// up to 8% on 100,000 spheres' bounce batches and lost up to 3% on the
// triangle tables, which carry the any-hit time: PERF.md.)
#define OCCLUDED_PARAMS                                                     \
  const int32_t *__restrict__ nvis, const int32_t *__restrict__ visit,      \
      const float *__restrict__ entry, const float *__restrict__ root,      \
      const float *__restrict__ px, const float *__restrict__ py,           \
      const float *__restrict__ pz, const float *__restrict__ dx,           \
      const float *__restrict__ dy, const float *__restrict__ dz,           \
      const float *__restrict__ tfar, const float *__restrict__ table,      \
      int n_rays, int tile_r, int n_clusters, int k_prims,                  \
      uint8_t *__restrict__ occ_out
#define OCCLUDED_NAMES                                                      \
  nvis, visit, entry, root, px, py, pz, dx, dy, dz, tfar, table, n_rays,    \
      tile_r, n_clusters, k_prims, occ_out

template <int kBattery, bool kPacked, int kS, bool kCount>
__device__ __forceinline__ void occluded_walk(OCCLUDED_PARAMS,
                                              const WalkCounts& wc) {
  extern __shared__ float4 slots[];  // two slots of n4 float4
  __shared__ float s_red[32];
  __shared__ int s_rays[kMaxBlock];
  __shared__ int s_scan[33];
  const int tile = blockIdx.x;
  const int base = tile * tile_r;
  bool own_live = false;
  const int t = threadIdx.x;
  if (t < tile_r && base + t < n_rays) {
    own_live = tfar[base + t] > 0.0f;
    if (!own_live) occ_out[base + t] = 0;
  }
  const Lane l = lane_of<kS>(pack_live(own_live, t, s_rays, s_scan), base,
                             s_rays, root, px, py, pz, dx, dy, dz, tfar);
  bool occ = false;
  unsigned long long pairs = 0;  // counted only under kCount
  const size_t row = static_cast<size_t>(tile) * n_clusters;
  const int visits = stream_walk(
      visit + row, entry + row, nvis[tile], block_max(l.bound, s_red),
      (kBattery == kSphere ? 1 : 3) * k_prims, slots,
      [&](float4* slot, int c) {
        fetch_visit<kBattery, kPacked>(slot, table, c, k_prims);
      },
      [&](int c, const float4* rows) {
        if (l.sp.warp_live) {
          // every lane of the warp joins any_hit's shuffles
          const bool need = l.sp.has_ray && !occ;
          int first;
          const bool hit =
              any_hit<kBattery, kS>(l, rows, k_prims, need, &first);
          occ = occ || (need && hit);
          if (kCount) {
            // the ray's first occluder: the least first slot of its S
            for (int o = 1; o < kS; o <<= 1) {
              first = min(first, __shfl_xor_sync(0xffffffffu, first, o));
            }
            const int real = __ldg(&wc.filled[c]);
            if (need && l.sp.s == 0) pairs += min(first + 1, real);
          }
        }
        return block_max((l.sp.has_ray && !occ) ? l.bound : -FLT_MAX, s_red);
      });
  if (l.sp.has_ray && l.sp.s == 0) occ_out[l.i] = occ ? 1 : 0;
  add_counts<kCount>(wc, pairs, visits);
}

template <int kBattery, bool kPacked, int kS>
__global__ void __launch_bounds__(kMaxBlock) occluded_kernel(OCCLUDED_PARAMS) {
  occluded_walk<kBattery, kPacked, kS, false>(OCCLUDED_NAMES, WalkCounts{});
}

template <int kBattery, bool kPacked, int kS>
__global__ void __launch_bounds__(kMaxBlock)
    occluded_kernel(OCCLUDED_PARAMS, const WalkCounts wc) {
  occluded_walk<kBattery, kPacked, kS, true>(OCCLUDED_NAMES, wc);
}

// stream_replay: the streamed walks' staging of one tile's visit list,
// written back out. The port of the double-buffered DMA replay of the JAX
// package's benchmarks/diag_stream2.py (its kernel at :118, launched at
// :152), which copies every visited cluster's F8 packed rows of the TPU's
// stream walk out through its two VMEM slots. Here the copy is the walks'
// own: stream_walk's loop without its exit, fetch_visit's transposing
// cp.async copies of the packed table into the two shared-memory slots, one
// commit group per visit, the next visit's copy in flight while this one is
// written out. The first nb = min(grid, max(1, nv / 2)) blocks of the grid
// each walk a contiguous slice of the list, nv / nb visits or one more (the
// longer slices last), in block order (the rest own no visit), so that every
// slice holds at least two visits where nv has them and runs the
// double-buffered sequence; block b's slice starts at visit 2b whenever nv
// <= 2 * grid + 1, so its first ids are fetched into L1 while nv =
// nvis[tile] is read on the card. stream_walk is handed the slice's visits
// only, so its prefetch of visit j + 1 never reads past the slice. The grid
// is sized by the wrapper from the card's SM count and the output's n_out >=
// nv visits (ops/kernels/cluster_traverse.py: replay_blocks, replay_slices).
// Slot reuse, as in the walks: the copy of visit j + 2 starts at the top of
// trip j + 1, into the slot that visit j was written out from; the barrier
// that ends visit j's write-back (every thread's reads of the slot are done)
// and stream_walk's own barrier of trip j lie between those reads and that
// copy. The write-back undoes the transposition into visit j's F8 rows of
// out[n_out * F8, K], in packed order, a thread a prim k (a column): its
// kAttrs / 4 float4 read from the slot (at a stride of kAttrs / 4 float4
// across a quarter warp: no bank conflict), each float stored to row a at
// column k (coalesced). The F8 - kAttrs rows that pad a cluster (never
// staged, never read by a walk) are written as the zeros the packed table
// holds there, by the block that owns the visit; the visits [nv, n_out) that
// pad the output to a multiple of 8 visits are zeroed by every block,
// grid-stride. Bound by bytes: each visited cluster's F8 * K floats are read
// once and written once.
constexpr int kReplayThreads = 256;

template <int kBattery>
__global__ void __launch_bounds__(kReplayThreads) replay_kernel(
    const int32_t* __restrict__ nvis, const int32_t* __restrict__ visit,
    const float* __restrict__ packed, int tile, int n_clusters, int k_prims,
    int n_out, float* __restrict__ out) {
  extern __shared__ float4 slots[];  // two slots of n4 float4
  constexpr int kAttrs = kBattery == kSphere ? 4 : 12;
  constexpr int kGroups = kAttrs / 4;  // float4 a prim in a slot
  constexpr int kRows = kBattery == kSphere ? 8 : 16;  // F8
  const int32_t* row = visit + static_cast<size_t>(tile) * n_clusters;
  const int b = blockIdx.x;
  // most lists give block b the visits from 2b on: their ids start on
  // their way to L1 while nv is read
  if (threadIdx.x == 0 && 2 * b < n_clusters) prefetch_l1(row + 2 * b);
  const int nv = min(nvis[tile], n_out);
  const int owners = min(static_cast<int>(gridDim.x), max(1, nv / 2));
  const size_t visit_floats = static_cast<size_t>(kRows) * k_prims;
  if (b < owners) {  // uniform over the block
    // per or per + 1 visits a block, the longer slices last
    const int per = nv / owners, longer = nv - per * owners;
    const int first = b * per + max(0, b - (owners - longer));
    const int last = first + per + (b >= owners - longer ? 1 : 0);
    int j = first;  // stream_walk hands over the slice's visits in order
    stream_walk<false>(
        row + first, nullptr, last - first, 0.0f, kGroups * k_prims, slots,
        [&](float4* slot, int c) {
          fetch_visit<kBattery, true>(slot, packed, c, k_prims);
        },
        [&](int /*c*/, const float4* rows) {
          float* dst = out + static_cast<size_t>(j) * visit_floats;
          for (int k = threadIdx.x; k < k_prims; k += blockDim.x) {
#pragma unroll
            for (int g = 0; g < kGroups; ++g) {
              const float4 v = rows[k * kGroups + g];
              dst[(4 * g) * k_prims + k] = v.x;
              dst[(4 * g + 1) * k_prims + k] = v.y;
              dst[(4 * g + 2) * k_prims + k] = v.z;
              dst[(4 * g + 3) * k_prims + k] = v.w;
            }
#pragma unroll
            for (int a = kAttrs; a < kRows; ++a) dst[a * k_prims + k] = 0.0f;
          }
          ++j;
          __syncthreads();  // next trip starts the copy two visits on here
          return 0.0f;
        });
  }
  // the pad visits, F8 * K floats each (a multiple of 4: float4 stores)
  float4* pad = reinterpret_cast<float4*>(out + nv * visit_floats);
  const size_t n4 = (n_out - nv) * visit_floats / 4;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n4; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    pad[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// Shared memory above 48 KB has to be asked for; the limit counts the
// kernel's static shared memory too (at most 4.4 KB: the split walks'
// packed ray order), so ask from 40 KB on.
template <typename Kernel>
cudaError_t allow_shared(Kernel kernel, size_t bytes) {
  if (bytes <= 40 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
}

}  // namespace

// C entry points, bound with ctypes. Each launches on `stream` and returns
// the first CUDA error (0 = launched). The wrappers in
// ops/kernels/cluster_traverse.py check shapes, types and sizes.
// The planners' common arguments: `mode` (kFlat ... kHybrid), the six rows
// of the cluster boxes (the first leaf boxes under kDual), a second set of
// six rows (the second leaf boxes under kDual, the n_second supercluster
// boxes under kSuper; unused otherwise), the rays, their count, the tile
// size and the cluster count.
#define PLAN_ARGS                                                          \
  int mode, const float *lox, const float *loy, const float *loz,          \
      const float *hix, const float *hiy, const float *hiz,                \
      const float *slox, const float *sloy, const float *sloz,             \
      const float *shix, const float *shiy, const float *shiz,             \
      int n_second, const float *px, const float *py, const float *pz,     \
      const float *dx, const float *dy, const float *dz, const float *tf,  \
      const uint8_t *valid, int n_rays, int tile_r, int n_clusters

// The planners' common arguments as a PlanArgs.
#define PLAN_INPUTS                                                          \
  Boxes{lox, loy, loz, hix, hiy, hiz},                                       \
      Boxes{slox, sloy, sloz, shix, shiy, shiz},                             \
      mode == kSuper ? n_second : 0, px, py, pz, dx, dy, dz, tf, valid,      \
      n_rays, tile_r, n_clusters

using PlanFn = decltype(&plan_kernel<kFlat, false, false>);

// The sweep kernel of an exact mode (or 'hybrid') for C clusters.
template <bool kRows>
static PlanFn sweep_kernel(int mode, int n_clusters) {
  const bool wide = n_clusters > kNarrowClusters;
  switch (mode) {
    case kFlat:
      return wide ? plan_kernel<kFlat, true, kRows>
                  : plan_kernel<kFlat, false, kRows>;
    case kDual:
      return wide ? plan_kernel<kDual, true, kRows>
                  : plan_kernel<kDual, false, kRows>;
    case kSuper:
      return wide ? plan_kernel<kSuper, true, kRows>
                  : plan_kernel<kSuper, false, kRows>;
    case kHybrid:
      if (kRows) {
        return wide ? plan_kernel<kHybrid, true, true>
                    : plan_kernel<kHybrid, false, true>;
      }
  }
  return nullptr;
}

static int launch_plan(PlanFn kernel, int blocks, size_t shared,
                       const PlanArgs& a, void* stream) {
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_shared(kernel, shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kPlanThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

// cluster_plan: modes kFlat, kDual and kSuper, each tile's list sorted.
extern "C" int cluster_plan(PLAN_ARGS, float* entry_out, int32_t* visit_out,
                            int32_t* nvis_out, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  if (n_clusters > kPadId) return static_cast<int>(cudaErrorInvalidValue);
  int n_keys = 1;
  while (n_keys < n_clusters) n_keys <<= 1;
  const PlanArgs a{PLAN_INPUTS, n_keys, n_clusters, 0,
                   entry_out,   visit_out, nvis_out};
  return launch_plan(sweep_kernel<false>(mode, n_clusters),
                     (n_rays + tile_r - 1) / tile_r,
                     plan_shared_bytes(tile_r, n_clusters, a.n_super, n_keys),
                     a, stream);
}

// cluster_plan_rows: every mode, the unsorted [T, C] entry matrix. The
// sweep takes `chunk` clusters at a time (a positive multiple of 32: the
// wrapper's plan_rows_chunk). A box block plans the most tiles, up to one a
// warp, at which the launch keeps two box blocks an SM.
extern "C" int cluster_plan_rows(PLAN_ARGS, int chunk, float* entry_out,
                                 void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  if (chunk <= 0 || chunk % 32) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (n_rays + tile_r - 1) / tile_r;
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  int box_tiles = kPlanWarps;
  while (box_tiles > 1 && (tiles + box_tiles - 1) / box_tiles < 2 * sms) {
    box_tiles >>= 1;
  }
  const int box_blocks = (tiles + box_tiles - 1) / box_tiles;
  const PlanArgs a{PLAN_INPUTS, 0, chunk, box_tiles, entry_out, nullptr,
                   nullptr};
  if (mode == kTilebox) {
    return launch_plan(plan_kernel<kTilebox, false, true>, box_blocks, 0, a,
                       stream);
  }
  return launch_plan(sweep_kernel<true>(mode, n_clusters),
                     tiles + (mode == kHybrid ? box_blocks : 0),
                     plan_shared_bytes(tile_r, chunk, a.n_super, 0), a,
                     stream);
}

#undef PLAN_INPUTS
#undef PLAN_ARGS

// The walks: `battery` 0 (spheres), 1 (triangles) or 2 (the product form,
// resident table only), `split` the S of the S-way split (1, 2 or 4;
// tile_r * S threads a block, at most 1024). Two slots of one cluster's
// rows. cluster_closest and cluster_occluded read the resident [C * K, F]
// table (16-byte aligned), the _stream forms the packed [C * F8, K] one.
// `filled` [C] and `counts` [2] are WalkCounts': with counts null the walk
// without counters runs and neither is read.
// A walk's kernel, for walk_for: the overload without counters (Walk) or
// with them (CountWalk), resolved by the pointer type.
struct ClosestWalk {
  template <int kBattery, bool kPacked, int kS>
  static auto kernel() {
    void (*fn)(CLOSEST_PARAMS) = &closest_kernel<kBattery, kPacked, kS>;
    return fn;
  }
};

struct ClosestCountWalk {
  template <int kBattery, bool kPacked, int kS>
  static auto kernel() {
    void (*fn)(CLOSEST_PARAMS, const WalkCounts) =
        &closest_kernel<kBattery, kPacked, kS>;
    return fn;
  }
};

struct OccludedWalk {
  template <int kBattery, bool kPacked, int kS>
  static auto kernel() {
    void (*fn)(OCCLUDED_PARAMS) = &occluded_kernel<kBattery, kPacked, kS>;
    return fn;
  }
};

struct OccludedCountWalk {
  template <int kBattery, bool kPacked, int kS>
  static auto kernel() {
    void (*fn)(OCCLUDED_PARAMS, const WalkCounts) =
        &occluded_kernel<kBattery, kPacked, kS>;
    return fn;
  }
};

#undef CLOSEST_PARAMS
#undef CLOSEST_NAMES
#undef OCCLUDED_PARAMS
#undef OCCLUDED_NAMES

template <typename Walk>
using WalkFn = decltype(Walk::template kernel<kSphere, false, 1>());

template <typename Walk, int kBattery, bool kPacked>
static WalkFn<Walk> walk_split(int split) {
  return split == 4   ? Walk::template kernel<kBattery, kPacked, 4>()
         : split == 2 ? Walk::template kernel<kBattery, kPacked, 2>()
         : split == 1 ? Walk::template kernel<kBattery, kPacked, 1>()
                      : nullptr;
}

// The kernel of (battery, table, split), or nullptr where there is none.
template <typename Walk>
static WalkFn<Walk> walk_for(int battery, bool packed, int split) {
  if (packed) {
    return battery == kTriangle ? walk_split<Walk, kTriangle, true>(split)
           : battery == kSphere ? walk_split<Walk, kSphere, true>(split)
                                : nullptr;
  }
  return battery == kTriangleProduct
             ? walk_split<Walk, kTriangleProduct, false>(split)
         : battery == kTriangle ? walk_split<Walk, kTriangle, false>(split)
         : battery == kSphere   ? walk_split<Walk, kSphere, false>(split)
                                : nullptr;
}

// Launch walk `Walk` on every tile, `args` the kernel's arguments.
template <typename Walk, typename... Args>
static int launch_on(bool packed, int battery, int split, int n_rays,
                     int tile_r, int k_prims, void* stream, Args... args) {
  const WalkFn<Walk> kernel = walk_for<Walk>(battery, packed, split);
  if (kernel == nullptr || tile_r * split > kMaxBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t shared =
      2 * static_cast<size_t>(k_prims) * (battery ? 12 : 4) * sizeof(float);
  const cudaError_t err = allow_shared(kernel, shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<(n_rays + tile_r - 1) / tile_r, tile_r * split, shared,
           static_cast<cudaStream_t>(stream)>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// Launch walk `Walk`, or `CountWalk` with `wc` as its last argument where
// wc.counts is set.
template <typename Walk, typename CountWalk, typename... Args>
static int launch_walk(bool packed, int battery, int split, int n_rays,
                       int tile_r, int k_prims, void* stream,
                       const WalkCounts wc, Args... args) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  if (wc.counts == nullptr) {
    return launch_on<Walk>(packed, battery, split, n_rays, tile_r, k_prims,
                           stream, args...);
  }
  return launch_on<CountWalk>(packed, battery, split, n_rays, tile_r,
                              k_prims, stream, args..., wc);
}

#define CLOSEST_ARGS                                                        \
  const int32_t *nvis, const int32_t *visit, const float *entry,            \
      const float *root, const float *px, const float *py, const float *pz, \
      const float *dx, const float *dy, const float *dz, const float *tf0,  \
      const uint8_t *valid, const float *table, int battery, int split,     \
      int n_rays, int tile_r, int n_clusters, int k_prims, float *tfar_out, \
      int32_t *prim_out, const int32_t *filled, unsigned long long *counts, \
      void *stream
#define CLOSEST_LAUNCH(packed)                                              \
  launch_walk<ClosestWalk, ClosestCountWalk>(                               \
      packed, battery, split, n_rays, tile_r, k_prims, stream,              \
      WalkCounts{filled, counts}, nvis, visit, entry, root, px, py, pz, dx, \
      dy, dz, tf0, valid, table, n_rays, tile_r, n_clusters, k_prims,       \
      tfar_out, prim_out)

extern "C" int cluster_closest(CLOSEST_ARGS) { return CLOSEST_LAUNCH(false); }

extern "C" int cluster_closest_stream(CLOSEST_ARGS) {
  return CLOSEST_LAUNCH(true);
}

#undef CLOSEST_LAUNCH
#undef CLOSEST_ARGS

#define OCCLUDED_ARGS                                                       \
  const int32_t *nvis, const int32_t *visit, const float *entry,            \
      const float *root, const float *px, const float *py, const float *pz, \
      const float *dx, const float *dy, const float *dz, const float *tfar, \
      const float *table, int battery, int split, int n_rays, int tile_r,   \
      int n_clusters, int k_prims, uint8_t *occ_out, const int32_t *filled, \
      unsigned long long *counts, void *stream
#define OCCLUDED_LAUNCH(packed)                                             \
  launch_walk<OccludedWalk, OccludedCountWalk>(                             \
      packed, battery, split, n_rays, tile_r, k_prims, stream,              \
      WalkCounts{filled, counts}, nvis, visit, entry, root, px, py, pz, dx, \
      dy, dz, tfar, table, n_rays, tile_r, n_clusters, k_prims, occ_out)

extern "C" int cluster_occluded(OCCLUDED_ARGS) {
  return OCCLUDED_LAUNCH(false);
}

extern "C" int cluster_occluded_stream(OCCLUDED_ARGS) {
  return OCCLUDED_LAUNCH(true);
}

#undef OCCLUDED_LAUNCH
#undef OCCLUDED_ARGS

// stream_replay: tile `tile`'s visit list (visit [T, C], nvis [T]) replayed
// through the streamed walks' staging from the packed [C * F8, K] table of
// battery 0 (spheres, F8 = 8) or 1 (triangles, F8 = 16), into out
// [n_out * F8, K] (16-byte aligned); n_out, the visits the output holds, is
// at least the tile's nvis (the wrapper's ceil(nv / 8) * 8). `blocks` is the
// grid (the wrapper's replay_blocks).
using ReplayFn = decltype(&replay_kernel<kSphere>);

static ReplayFn replay_for(int battery) {
  return battery == kTriangle ? &replay_kernel<kTriangle>
         : battery == kSphere ? &replay_kernel<kSphere>
                              : nullptr;
}

static size_t replay_shared(int battery, int k_prims) {
  return 2 * static_cast<size_t>(k_prims) * (battery ? 12 : 4) *
         sizeof(float);
}

extern "C" int stream_replay(const int32_t* nvis, const int32_t* visit,
                             const float* packed, int battery, int tile,
                             int n_clusters, int k_prims, int n_out,
                             int blocks, float* out, void* stream) {
  if (n_out <= 0) return static_cast<int>(cudaGetLastError());
  const auto kernel = replay_for(battery);
  if (kernel == nullptr || tile < 0 || k_prims <= 0 || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t shared = replay_shared(battery, k_prims);
  const cudaError_t err = allow_shared(kernel, shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<blocks, kReplayThreads, shared,
           static_cast<cudaStream_t>(stream)>>>(nvis, visit, packed, tile,
                                                n_clusters, k_prims, n_out,
                                                out);
  return static_cast<int>(cudaGetLastError());
}

// The replay's blocks an SM can hold at K = k_prims (its shared memory
// asked for as a launch asks), into *per_sm.
extern "C" int stream_replay_occupancy(int battery, int k_prims,
                                       int* per_sm) {
  const auto kernel = replay_for(battery);
  if (kernel == nullptr || k_prims <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t shared = replay_shared(battery, k_prims);
  cudaError_t err = allow_shared(kernel, shared);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        per_sm, kernel, kReplayThreads, shared);
  }
  return static_cast<int>(err);
}
