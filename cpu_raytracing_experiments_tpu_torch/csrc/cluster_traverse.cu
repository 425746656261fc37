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
//
// What they compute. Rays are cut into tiles of tile_r consecutive rays; one
// thread block works on one tile.
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
//   sign-coherent on all three axes, else 'ray'. It keeps no list in shared
//   memory and so has no cluster limit.
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
// box. So slab() uses fminf/fmaxf and reports separately whether any of the
// six products was NaN, and cluster_plan's sweep uses min / max that
// propagate NaN (nan_min, nan_max), with the same outcome.
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
// The streamed walks. They read the packed table [C * F8, K] (cluster c's
// attribute rows contiguous, zero rows up to F8 = 8 or 16) and keep two
// slots of one cluster's rows in shared memory. Before the block waits for
// visit j's rows it starts the asynchronous copy (cp.async, one commit
// group per visit) of visit j + 1 into the other slot, so that copy runs
// under visit j's battery. The zero rows are not copied. A copy started for
// a visit that the early exit then skips is waited for before the block
// ends. The copies are 4 bytes each and transpose the attribute rows into
// the resident tables' layout (a sphere one float4, a triangle three), so
// that the batteries are the resident walks' own, fed the same values:
// the results are equal bit for bit.
//
// What bounds the split walks (the streamed walks and every closest walk),
// and the design against it. The streamed walks carry the
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
// block is tile_r * S threads, at most 1024 (__launch_bounds__).
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
// boxes of a cluster. cluster_plan_rows keeps the first design's loop:
// each thread owns clusters c, c + 256, ... and loops over the staged
// rays; 'super' keeps the S union entries in shared memory, each warp's 32
// consecutive clusters sharing one union. The tilebox bundle is one
// block-wide reduction (warp shuffles, then one value per warp in shared
// memory) of min / max that propagate NaN, as the JAX reductions do.
// The walks. cluster_closest and cluster_closest_stream are one kernel
// template, the split walk described above, that differs only in the
// fetch: the resident [C * K, F] table is already in the batteries'
// layout and is copied 16 bytes at a time. cluster_occluded keeps one
// thread per ray with its ray in registers, the visited cluster's rows
// staged in shared memory as float4 and read by broadcast, and the exit
// bound a block-wide max through warp shuffles; the split is still to come
// to it. Warp-level culling inside a tile, several clusters per staging
// step and tensor-core batteries are later work.

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
// Planners: cluster_plan (sorted in the kernel), cluster_plan_rows (the
// unsorted entry matrix)
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

// The tile's rays as staged in shared memory: origin, 1 / direction, tfar;
// an invalid lane is staged as a ray that enters no box.
struct Staged {
  float *px, *py, *pz, *ix, *iy, *iz, *tf;
};

__device__ __forceinline__ Staged staged_rays(float* base, int tile_r) {
  return Staged{base,              base + tile_r,     base + 2 * tile_r,
                base + 3 * tile_r, base + 4 * tile_r, base + 5 * tile_r,
                base + 6 * tile_r};
}

__device__ __forceinline__ void stage_rays(
    const Staged& s, const float* __restrict__ px,
    const float* __restrict__ py, const float* __restrict__ pz,
    const float* __restrict__ dx, const float* __restrict__ dy,
    const float* __restrict__ dz, const float* __restrict__ tf,
    const uint8_t* __restrict__ valid, int base, int n_rays, int tile_r) {
  for (int i = threadIdx.x; i < tile_r; i += blockDim.x) {
    const int r = base + i;
    const bool ok = r < n_rays && valid[r] != 0;
    // an invalid lane never enters a box: entry >= 0 is never below tfar 0
    s.px[i] = ok ? px[r] : 0.0f;
    s.py[i] = ok ? py[r] : 0.0f;
    s.pz[i] = ok ? pz[r] : 0.0f;
    s.ix[i] = ok ? __fdiv_rn(1.0f, dx[r]) : 1.0f;
    s.iy[i] = ok ? __fdiv_rn(1.0f, dy[r]) : 1.0f;
    s.iz[i] = ok ? __fdiv_rn(1.0f, dz[r]) : 1.0f;
    s.tf[i] = ok ? tf[r] : 0.0f;
  }
}

// _tile_entry_row for box c: the least slab entry distance over the staged
// rays, FLT_MAX where no ray enters the box before its tfar.
__device__ __forceinline__ float tile_entry(const Boxes& b, int c,
                                            const Staged& s, int tile_r) {
  const float lx = b.lox[c], ly = b.loy[c], lz = b.loz[c];
  const float hx = b.hix[c], hy = b.hiy[c], hz = b.hiz[c];
  float emin = FLT_MAX;
  for (int i = 0; i < tile_r; ++i) {
    const Slab sl = slab(lx, ly, lz, hx, hy, hz, s.px[i], s.py[i], s.pz[i],
                         s.ix[i], s.iy[i], s.iz[i]);
    const float entry = fmaxf(sl.tmin, 0.0f);
    const bool hit = !sl.nan && sl.tmax >= entry && entry < s.tf[i];
    emin = fminf(emin, hit ? entry : FLT_MAX);
  }
  return emin;
}

// Phase A of 'super': the staged rays against the S supercluster boxes,
// into s_super[S]. Returns after a barrier.
__device__ __forceinline__ void super_entries(const Boxes& supers,
                                              int n_super, const Staged& s,
                                              int tile_r, float* s_super) {
  for (int k = threadIdx.x; k < n_super; k += blockDim.x) {
    s_super[k] = tile_entry(supers, k, s, tile_r);
  }
  __syncthreads();
}

// The entry of cluster c under an exact mode. 'group': the lesser of the
// two leaf boxes' entries (the min over rays and the min of the two rows
// commute, and no entry is NaN). 'super' (phase B): the flat entry where the
// cluster's supercluster was entered, else FLT_MAX; a supercluster box
// contains its members' boxes and the slab test is monotone in the box, so
// this equals the flat entry bit for bit.
template <int kMode>
__device__ __forceinline__ float exact_entry(const Boxes& b,
                                             const Boxes& second, int c,
                                             const Staged& s, int tile_r,
                                             const float* s_super) {
  if (kMode == kDual) {
    return fminf(tile_entry(b, c, s, tile_r),
                 tile_entry(second, c, s, tile_r));
  }
  if (kMode == kSuper && !(s_super[c / kSuperSize] < FLT_MAX)) {
    return FLT_MAX;
  }
  return tile_entry(b, c, s, tile_r);
}

// ---------------------------------------------------------------------------
// cluster_plan: the sweep of the staged rays against register-held boxes
// ---------------------------------------------------------------------------
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
__device__ __forceinline__ void stage_octants(
    float4* s_ray, int* s_oct, const float* __restrict__ px,
    const float* __restrict__ py, const float* __restrict__ pz,
    const float* __restrict__ dx, const float* __restrict__ dy,
    const float* __restrict__ dz, const float* __restrict__ tf,
    const uint8_t* __restrict__ valid, int base, int n_rays, int tile_r) {
  __shared__ int s_in_octant[8];
  if (threadIdx.x < 8) s_in_octant[threadIdx.x] = 0;
  __syncthreads();
  float4 a[kMaxRaysAThread], b[kMaxRaysAThread];
  int oct[kMaxRaysAThread], at[kMaxRaysAThread];
#pragma unroll
  for (int k = 0; k < kMaxRaysAThread; ++k) {
    const int i = threadIdx.x + k * kPlanThreads;
    const int r = base + i;
    oct[k] = -1;
    if (i < tile_r && r < n_rays && valid[r] != 0) {
      const float ix = __fdiv_rn(1.0f, dx[r]);
      const float iy = __fdiv_rn(1.0f, dy[r]);
      const float iz = __fdiv_rn(1.0f, dz[r]);
      a[k] = make_float4(px[r], py[r], pz[r], nextafterf(tf[r], -INFINITY));
      b[k] = make_float4(ix, iy, iz, 0.0f);
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
      s_ray[2 * q] = a[k];
      s_ray[2 * q + 1] = b[k];
    }
  }
  __syncthreads();
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
// s_min[c] (float bits: entries are >= 0, so they order as unsigned; -0 is
// made +0 first).
template <int kBoxes, int kR, typename SlotOf>
__device__ __forceinline__ void sweep_batch(const Boxes& b, const Boxes& b2,
                                            int n, int k, int left,
                                            SlotOf slot_of,
                                            const float4* s_ray,
                                            const int* s_oct,
                                            unsigned* s_min) {
  const int lane = threadIdx.x & 31;
  Batch<kBoxes, kR> bt;
  int c[kR];
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    c[j] = j < left ? 32 * slot_of(k + j) + lane : n;
    load_box(b, c[j], n, bt.lo[j][0], bt.hi[j][0]);
    if (kBoxes == 2) load_box(b2, c[j], n, bt.lo[j][kBoxes - 1],
                              bt.hi[j][kBoxes - 1]);
    bt.e[j] = FLT_MAX;
  }
  sweep(s_ray, s_oct, bt);
#pragma unroll
  for (int j = 0; j < kR; ++j) {
    if (c[j] < n && bt.e[j] < FLT_MAX) {
      atomicMin(&s_min[c[j]], __float_as_uint(__fadd_rn(bt.e[j], 0.0f)));
    }
  }
}

// The least entry over the tile's staged rays of each of the n boxes of
// the slots slot_of(0 .. n_slots - 1), into s_min (set to kMissBits by the
// caller). kWide: batches of 8 boxes a lane, the rest in batches of 2;
// else batches of 2 only, in fewer registers. Every warp takes every batch
// and an eighth of the rays, so the warps stay even whatever n is. Returns
// after a barrier.
template <int kBoxes, bool kWide, typename SlotOf>
__device__ __forceinline__ void sweep_slots(const Boxes& b, const Boxes& b2,
                                            int n, int n_slots,
                                            SlotOf slot_of,
                                            const float4* s_ray,
                                            const int* s_oct,
                                            unsigned* s_min) {
  constexpr int kRest = 2 / kBoxes, kFull = kWide ? 8 / kBoxes : kRest;
  int k = 0;
  for (; k + kFull <= n_slots; k += kFull) {
    sweep_batch<kBoxes, kFull>(b, b2, n, k, kFull, slot_of, s_ray, s_oct,
                               s_min);
  }
  for (; k < n_slots; k += kRest) {
    sweep_batch<kBoxes, kRest>(b, b2, n, k, n_slots - k, slot_of, s_ray,
                               s_oct, s_min);
  }
  __syncthreads();
}

__device__ __forceinline__ void fill(unsigned* a, int n, unsigned v) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) a[i] = v;
}

// Dynamic shared memory of cluster_plan, in this order: the staged rays
// (2 tile_r float4), s_min (C), s_super (S), the slot list (C / 32 rounded
// up), the ids to sort (n_keys = C rounded up to a power of two, 2 bytes
// each).
__host__ __device__ inline size_t plan_shared_bytes(int tile_r, int n_clusters,
                                                    int n_super, int n_keys) {
  return static_cast<size_t>(tile_r) * 32 +
         (static_cast<size_t>(n_clusters) + n_super + (n_clusters + 31) / 32) *
             4 +
         static_cast<size_t>(n_keys) * 2;
}

__device__ __forceinline__ unsigned long long sort_key(const unsigned* s_min,
                                                       uint16_t id) {
  return id == kPadId ? ~0ull
                      : (static_cast<unsigned long long>(s_min[id]) << 32) | id;
}

// kWide: register blocks of 8 boxes a lane, for C above kNarrowClusters;
// else blocks of 2, and the registers for 4 blocks an SM (a small C leaves
// little work per tile, and latency, not issue, bounds it). Left alone,
// ptxas gives the wide kernels 160-168 registers, one block an SM; at 3
// blocks (80 registers) they ran fastest without a spill, 'super' at 2
// (128: at 80 its two sweeps spill).
constexpr int kNarrowClusters = 256;

template <int kMode, bool kWide>
__global__ void __launch_bounds__(kPlanThreads,
                                  kWide ? (kMode == kSuper ? 2 : 3) : 4)
plan_kernel(Boxes boxes, Boxes second, int n_super,
            const float* __restrict__ px, const float* __restrict__ py,
            const float* __restrict__ pz, const float* __restrict__ dx,
            const float* __restrict__ dy, const float* __restrict__ dz,
            const float* __restrict__ tf, const uint8_t* __restrict__ valid,
            int n_rays, int tile_r, int n_clusters, int n_keys,
            float* __restrict__ entry_out, int32_t* __restrict__ visit_out,
            int32_t* __restrict__ nvis_out) {
  extern __shared__ float4 s_ray[];
  unsigned* s_min = reinterpret_cast<unsigned*>(s_ray + 2 * tile_r);
  unsigned* s_super = s_min + n_clusters;
  const int n_slots = (n_clusters + 31) / 32;
  int* s_list = reinterpret_cast<int*>(s_super + n_super);
  uint16_t* s_ids = reinterpret_cast<uint16_t*>(s_list + n_slots);
  __shared__ int s_oct[9];
  __shared__ int s_count;

  const int tile = blockIdx.x;
  if (threadIdx.x == 0) s_count = 0;
  fill(s_min, n_clusters, kMissBits);
  fill(s_super, n_super, kMissBits);
  stage_octants(s_ray, s_oct, px, py, pz, dx, dy, dz, tf, valid,
                tile * tile_r, n_rays, tile_r);
  const auto identity = [](int k) { return k; };
  if (kMode == kSuper) {
    // phase A: the union boxes; then the slots of the entered unions (a
    // slot's 32 clusters lie in one union of 128)
    sweep_slots<1, kWide>(second, second, n_super, (n_super + 31) / 32,
                          identity, s_ray, s_oct, s_super);
    for (int s = threadIdx.x; s < n_slots; s += blockDim.x) {
      if (s_super[s * 32 / kSuperSize] != kMissBits) {
        s_list[atomicAdd(&s_count, 1)] = s;
      }
    }
    __syncthreads();
    const int n_list = s_count;
    __syncthreads();
    if (threadIdx.x == 0) s_count = 0;
    sweep_slots<1, kWide>(boxes, boxes, n_clusters, n_list,
                          [s_list](int k) { return s_list[k]; }, s_ray, s_oct,
                          s_min);
  } else {
    sweep_slots<kMode == kDual ? 2 : 1, kWide>(
        boxes, second, n_clusters, n_slots, identity, s_ray, s_oct, s_min);
  }

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
          key = (((lane & j) == 0) == ((lane & k) == 0)) == low ? key : other;
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
          const uint16_t a = s_ids[i], b = s_ids[partner];
          const bool ascending = (i & k) == 0;
          if ((sort_key(s_min, a) > sort_key(s_min, b)) == ascending) {
            s_ids[i] = b;
            s_ids[partner] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  const size_t row = static_cast<size_t>(tile) * n_clusters;
  for (int i = threadIdx.x; i < n_clusters; i += blockDim.x) {
    const bool seen = i < n_vis;
    const int id = seen ? s_ids[i] : -1;
    entry_out[row + i] = seen ? __uint_as_float(s_min[id]) : FLT_MAX;
    visit_out[row + i] = id;
  }
  if (threadIdx.x == 0) nvis_out[tile] = n_vis;
}

// The tile's ray bundle of _tilebox_entry_row: per axis the masked min /
// max of origin (pl, ph) and direction (dl, dh) over the valid rays, the
// max of their tfar, whether any ray is valid. Invalid lanes count as
// +FLT_MAX in a min and -FLT_MAX in a max, as the JAX fills.
constexpr int kBundle = 14;  // pl.xyz, dl.xyz (mins); ph.xyz, dh.xyz, tfm,
                             // any (maxes)

__device__ __forceinline__ void tile_bundle(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tf, const uint8_t* __restrict__ valid,
    int base, int n_rays, int tile_r, float (*s_part)[32], float* bundle) {
  float v[kBundle];
  for (int k = 0; k < 6; ++k) v[k] = FLT_MAX;
  for (int k = 6; k < kBundle; ++k) v[k] = -FLT_MAX;
  for (int i = threadIdx.x; i < tile_r; i += blockDim.x) {
    const int r = base + i;
    if (!(r < n_rays && valid[r] != 0)) continue;
    const float a[6] = {px[r], py[r], pz[r], dx[r], dy[r], dz[r]};
    for (int k = 0; k < 6; ++k) {
      v[k] = nan_min(v[k], a[k]);
      v[6 + k] = nan_max(v[6 + k], a[k]);
    }
    v[12] = nan_max(v[12], tf[r]);
    v[13] = 1.0f;
  }
  for (int k = 0; k < kBundle; ++k) {
    for (int o = 16; o > 0; o >>= 1) {
      const float w = __shfl_xor_sync(0xffffffffu, v[k], o);
      v[k] = k < 6 ? nan_min(v[k], w) : nan_max(v[k], w);
    }
  }
  const int n_warps = (blockDim.x + 31) >> 5;
  if ((threadIdx.x & 31) == 0) {
    for (int k = 0; k < kBundle; ++k) s_part[k][threadIdx.x >> 5] = v[k];
  }
  __syncthreads();
  for (int k = 0; k < kBundle; ++k) {
    float m = s_part[k][0];
    for (int w = 1; w < n_warps; ++w) {
      m = k < 6 ? nan_min(m, s_part[k][w]) : nan_max(m, s_part[k][w]);
    }
    bundle[k] = m;
  }
}

// One axis of the bundle: its origin interval and the interval of
// 1 / direction; `mixed` where the direction interval holds 0, and the axis
// then bounds nothing.
struct Axis {
  bool mixed;
  float pl, ph, il, ih;
};

__device__ __forceinline__ Axis bundle_axis(float pl, float ph, float dl,
                                            float dh) {
  const bool mixed = dl <= 0.0f && dh >= 0.0f;
  const float inv_a = __fdiv_rn(1.0f, mixed ? 1.0f : dh);
  const float inv_b = __fdiv_rn(1.0f, mixed ? 1.0f : dl);
  return Axis{mixed, pl, ph, nan_min(inv_a, inv_b), nan_max(inv_a, inv_b)};
}

// The axis's bounds (lower bound of tmin, upper bound of tmax) for the box
// [lo, hi] on that axis, the products of _tilebox_entry_row's axis().
__device__ __forceinline__ void axis_bounds(const Axis& a, float lo,
                                            float hi, float* lb, float* ub) {
  const float lp = __fsub_rn(lo, a.ph), ll = __fsub_rn(lo, a.pl);
  const float hp = __fsub_rn(hi, a.ph), hl = __fsub_rn(hi, a.pl);
  const float a1 = __fmul_rn(lp, a.il), a2 = __fmul_rn(lp, a.ih);
  const float a3 = __fmul_rn(ll, a.il), a4 = __fmul_rn(ll, a.ih);
  const float b1 = __fmul_rn(hp, a.il), b2 = __fmul_rn(hp, a.ih);
  const float b3 = __fmul_rn(hl, a.il), b4 = __fmul_rn(hl, a.ih);
  const float t_lo_lb = nan_min(nan_min(a1, a2), nan_min(a3, a4));
  const float t_lo_ub = nan_max(nan_max(a1, a2), nan_max(a3, a4));
  const float t_hi_lb = nan_min(nan_min(b1, b2), nan_min(b3, b4));
  const float t_hi_ub = nan_max(nan_max(b1, b2), nan_max(b3, b4));
  *lb = a.mixed ? -FLT_MAX : nan_min(t_lo_lb, t_hi_lb);
  *ub = a.mixed ? FLT_MAX : nan_max(t_lo_ub, t_hi_ub);
}

// _tilebox_entry_row for box c: a lower bound of every valid ray's entry,
// FLT_MAX where the bundle cannot enter the box before its largest tfar.
__device__ __forceinline__ float tilebox_entry(const Boxes& b, int c,
                                               const Axis* axes, float tfm,
                                               bool any_ok) {
  float xlb, xub, ylb, yub, zlb, zub;
  axis_bounds(axes[0], b.lox[c], b.hix[c], &xlb, &xub);
  axis_bounds(axes[1], b.loy[c], b.hiy[c], &ylb, &yub);
  axis_bounds(axes[2], b.loz[c], b.hiz[c], &zlb, &zub);
  const float entry = nan_max(nan_max(nan_max(xlb, ylb), zlb), 0.0f);
  const float exit_ub = nan_min(nan_min(xub, yub), zub);
  const bool hit = exit_ub >= entry && entry < tfm && any_ok;
  return hit ? entry : FLT_MAX;
}

template <int kMode>
__global__ void __launch_bounds__(kPlanThreads)
plan_rows_kernel(Boxes boxes, Boxes second, int n_super,
                 const float* __restrict__ px, const float* __restrict__ py,
                 const float* __restrict__ pz, const float* __restrict__ dx,
                 const float* __restrict__ dy, const float* __restrict__ dz,
                 const float* __restrict__ tf,
                 const uint8_t* __restrict__ valid, int n_rays, int tile_r,
                 int n_clusters, float* __restrict__ entry_out) {
  extern __shared__ float rays[];  // 7 ray rows, then n_super entries
  const Staged staged = staged_rays(rays, tile_r);
  float* s_super = rays + 7 * tile_r;
  __shared__ float s_part[kBundle][32];
  const int tile = blockIdx.x;
  const size_t row = static_cast<size_t>(tile) * n_clusters;

  if (kMode == kTilebox || kMode == kHybrid) {
    float v[kBundle];
    tile_bundle(px, py, pz, dx, dy, dz, tf, valid, tile * tile_r, n_rays,
                tile_r, s_part, v);
    // one block plans one tile: the branch is uniform over the block
    const bool coherent = (v[3] > 0.0f || v[9] < 0.0f) &&
                          (v[4] > 0.0f || v[10] < 0.0f) &&
                          (v[5] > 0.0f || v[11] < 0.0f);
    if (kMode == kTilebox || coherent) {
      const Axis axes[3] = {bundle_axis(v[0], v[6], v[3], v[9]),
                            bundle_axis(v[1], v[7], v[4], v[10]),
                            bundle_axis(v[2], v[8], v[5], v[11])};
      for (int c = threadIdx.x; c < n_clusters; c += blockDim.x) {
        float e = tilebox_entry(boxes, c, axes, v[12], v[13] > 0.0f);
        if (e == 0.0f) e = 0.0f;
        entry_out[row + c] = e;
      }
      return;
    }
  }
  stage_rays(staged, px, py, pz, dx, dy, dz, tf, valid, tile * tile_r,
             n_rays, tile_r);
  __syncthreads();
  if (kMode == kSuper) {
    super_entries(second, n_super, staged, tile_r, s_super);
  }
  for (int c = threadIdx.x; c < n_clusters; c += blockDim.x) {
    float e = exact_entry<kMode == kHybrid ? kFlat : kMode>(
        boxes, second, c, staged, tile_r, s_super);
    if (e == 0.0f) e = 0.0f;
    entry_out[row + c] = e;
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

// Stage cluster c's rows (K prims of 1 or 3 float4 each) into shared memory.
template <int kBattery>
__device__ __forceinline__ void stage(float4* rows,
                                      const float4* __restrict__ table, int c,
                                      int k_prims) {
  const int n = k_prims * (kBattery == kSphere ? 1 : 3);
  const float4* src = table + static_cast<size_t>(c) * n;
  for (int k = threadIdx.x; k < n; k += blockDim.x) rows[k] = src[k];
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
// cluster_occluded
// ---------------------------------------------------------------------------
template <int kBattery>
__global__ void occluded_kernel(
    const int32_t* __restrict__ nvis, const int32_t* __restrict__ visit,
    const float* __restrict__ entry, const float* __restrict__ root,
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tfar, const float4* __restrict__ table,
    int n_rays, int n_clusters, int k_prims, uint8_t* __restrict__ occ_out) {
  extern __shared__ float4 rows[];
  __shared__ float s_red[32];
  const int tile = blockIdx.x;
  const int i = tile * blockDim.x + threadIdx.x;
  const bool in_range = i < n_rays;
  Ray r{};
  float tf = 0.0f;
  if (in_range) {
    r = load_ray(px, py, pz, dx, dy, dz, i);
    tf = tfar[i];
  }
  const bool live = in_range && tf > 0.0f;  // tfar <= 0 (or NaN): invalid
  const float bound = live ? fminf(tf, root_exit(root, r)) : -FLT_MAX;
  // the farthest a still-unoccluded lane can be hit: clusters entirely
  // beyond it cannot occlude
  float mx = block_max(bound, s_red);
  bool occ = false;
  const int n = nvis[tile];
  const size_t row = static_cast<size_t>(tile) * n_clusters;
  for (int j = 0; j < n; ++j) {
    if (!(entry[row + j] < mx)) break;
    const int c = visit[row + j];
    stage<kBattery>(rows, table, c, k_prims);
    __syncthreads();
    if (live && !occ) {
      for (int k = 0; k < k_prims; ++k) {
        const bool hit = kBattery == kSphere
                             ? sphere_occludes(r, tf, rows[k])
                             : prim_t<kBattery>(r, rows, k) < tf;
        if (hit) {
          occ = true;
          break;
        }
      }
    }
    mx = block_max((live && !occ) ? bound : -FLT_MAX, s_red);
  }
  if (in_range) occ_out[i] = occ ? 1 : 0;
}

// ---------------------------------------------------------------------------
// cluster_closest_stream, cluster_occluded_stream
// ---------------------------------------------------------------------------
constexpr int kMaxBlock = 1024;  // threads a block: tile_r * S at most

// The loop of the split walks (cluster_closest, and both streamed walks).
// Visit j's rows are in slot j & 1. The copy of visit j + 1 is started
// before the wait for visit j, into the slot that visit j - 1 used: the two
// barriers of that visit's block_max lie between its reads and this
// overwrite. One commit group per trip, empty where there is no next visit,
// so that "all but the newest group" is always "visit j has landed".
// `fetch(slot, c)` starts the copies of cluster c's n4 float4 into a slot;
// `visit_fn(c, rows)` runs the battery on the staged rows (prim k at
// rows[k * n4 / K]) and returns the tile's new exit bound.
template <typename Fetch, typename Visit>
__device__ __forceinline__ void stream_walk(
    const int32_t* __restrict__ visit_row, const float* __restrict__ entry_row,
    int n, float mx, int n4, float4* slots, Fetch fetch, Visit visit_fn) {
  if (n > 0) fetch(slots, visit_row[0]);
  cp_async_commit();
  for (int j = 0; j < n; ++j) {
    if (!(entry_row[j] < mx)) break;  // uniform: mx is the block's
    if (j + 1 < n) fetch(slots + ((j + 1) & 1) * n4, visit_row[j + 1]);
    cp_async_commit();
    cp_async_wait<1>();  // this thread's part of visit j has landed
    __syncthreads();     // and every other thread's
    mx = visit_fn(visit_row[j], slots + (j & 1) * n4);
  }
  cp_async_wait<0>();  // a copy started for a visit the exit skipped
}

// The tile's live rays packed to the front: thread t < tile_r says in `live`
// whether ray t of the tile is live; afterwards s_rays[q] is the tile index
// of the q-th live ray, in ray order, and the count is returned. One ballot
// per warp, then one warp scans the warps' counts (s_scan: 33 ints).
// Returns after a barrier.
__device__ __forceinline__ int pack_live(bool live, int* s_rays,
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
    s_rays[s_scan[warp] + __popc(ballot & ((1u << lane) - 1))] = threadIdx.x;
  }
  __syncthreads();
  return s_scan[32];
}

// The S-way split, for S = kS in {1, 2, 4}: thread t works on the live ray
// q = t / S of the packed order, and owns the slots k = t % S (mod S) of
// each staged cluster, walked in ascending order. The S threads of a ray are adjacent lanes of one
// warp. A warp whose first ray position is past the live count holds no
// live ray and skips the battery on a uniform branch (it still joins the
// barriers); in a warp that holds one, every lane runs the battery, so the
// shuffles see all 32 lanes, and a thread without a ray discards its result.
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

// cluster_closest (kPacked false: the resident [C * K, F] table, copied 16
// bytes at a time) and cluster_closest_stream (kPacked: the packed table,
// transposed by 4-byte copies) in one body: they differ only in how a
// cluster's rows reach shared memory.
template <int kBattery, bool kPacked, int kS>
__global__ void __launch_bounds__(kMaxBlock) closest_kernel(
    const int32_t* __restrict__ nvis, const int32_t* __restrict__ visit,
    const float* __restrict__ entry, const float* __restrict__ root,
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tf0, const uint8_t* __restrict__ valid,
    const float* __restrict__ table, int n_rays, int tile_r, int n_clusters,
    int k_prims, float* __restrict__ tfar_out, int32_t* __restrict__ prim_out) {
  extern __shared__ float4 slots[];  // two slots of n4 float4
  __shared__ float s_red[32];
  __shared__ int s_rays[kMaxBlock];
  __shared__ int s_scan[33];
  constexpr int kAttrs = kBattery == kSphere ? 4 : 12;
  constexpr int kPackedRows = kBattery == kSphere ? 8 : 16;
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
  const Split sp = split_of<kS>(pack_live(own_live, s_rays, s_scan));
  int i = 0;
  Ray r{};
  float best = 0.0f;
  if (sp.has_ray) {
    i = base + s_rays[sp.q];
    r = load_ray(px, py, pz, dx, dy, dz, i);
    best = tf0[i];
  }
  const float bound = sp.has_ray ? fminf(best, root_exit(root, r)) : -FLT_MAX;
  const float mx = block_max(bound, s_red);
  int32_t best_id = -1;
  const size_t row = static_cast<size_t>(tile) * n_clusters;
  const int n4 = kAttrs / 4 * k_prims;
  const auto fetch = [&](float4* slot, int c) {
    if (kPacked) {
      fetch_cluster<kAttrs>(slot, table, c, k_prims, kPackedRows * k_prims);
    } else {
      fetch_rows(slot, reinterpret_cast<const float4*>(table), c, n4);
    }
  };
  stream_walk(
      visit + row, entry + row, nvis[tile], mx, n4, slots, fetch,
      [&](int c, const float4* rows) {
        if (sp.warp_live) {
          float tl = INFINITY;  // this thread's slots: least t, first slot
          int kl = k_prims;
          for (int k = sp.s; k < k_prims; k += kS) {
            const float t = prim_t<kBattery>(r, rows, k);
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
        return block_max(sp.has_ray ? fminf(best, bound) : -FLT_MAX, s_red);
      });
  if (sp.has_ray && sp.s == 0) {
    tfar_out[i] = best;
    prim_out[i] = best_id;
  }
}

template <bool kTri, int kS>
__global__ void __launch_bounds__(kMaxBlock) occluded_stream_kernel(
    const int32_t* __restrict__ nvis, const int32_t* __restrict__ visit,
    const float* __restrict__ entry, const float* __restrict__ root,
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ pz, const float* __restrict__ dx,
    const float* __restrict__ dy, const float* __restrict__ dz,
    const float* __restrict__ tfar, const float* __restrict__ packed,
    int n_rays, int tile_r, int n_clusters, int k_prims,
    uint8_t* __restrict__ occ_out) {
  extern __shared__ float4 slots[];
  __shared__ float s_red[32];
  __shared__ int s_rays[kMaxBlock];
  __shared__ int s_scan[33];
  constexpr int kAttrs = kTri ? 12 : 4;
  constexpr int kPackedRows = kTri ? 16 : 8;
  const int tile = blockIdx.x;
  const int base = tile * tile_r;
  bool own_live = false;
  const int t = threadIdx.x;
  if (t < tile_r && base + t < n_rays) {
    const int i = base + t;
    own_live = tfar[i] > 0.0f;  // tfar <= 0 (or NaN): invalid, never occluded
    if (!own_live) occ_out[i] = 0;
  }
  const Split sp = split_of<kS>(pack_live(own_live, s_rays, s_scan));
  int i = 0;
  Ray r{};
  float tf = 0.0f;
  if (sp.has_ray) {
    i = base + s_rays[sp.q];
    r = load_ray(px, py, pz, dx, dy, dz, i);
    tf = tfar[i];
  }
  const float bound = sp.has_ray ? fminf(tf, root_exit(root, r)) : -FLT_MAX;
  // the farthest a still-unoccluded lane can be hit: clusters entirely
  // beyond it cannot occlude
  const float mx = block_max(bound, s_red);
  bool occ = false;
  const size_t row = static_cast<size_t>(tile) * n_clusters;
  stream_walk(
      visit + row, entry + row, nvis[tile], mx, kAttrs / 4 * k_prims, slots,
      [&](float4* slot, int c) {
        fetch_cluster<kAttrs>(slot, packed, c, k_prims,
                              kPackedRows * k_prims);
      },
      [&](int /*c*/, const float4* rows) {
        if (sp.warp_live) {
          const bool need = sp.has_ray && !occ;
          bool hit = false;
          for (int k = sp.s; need && k < k_prims; k += kS) {
            hit = kTri ? prim_t<kTriangle>(r, rows, k) < tf
                       : sphere_occludes(r, tf, rows[k]);
            if (hit) break;
          }
          for (int o = 1; o < kS; o <<= 1) {  // any of the ray's S threads
            hit = __shfl_xor_sync(0xffffffffu, static_cast<int>(hit), o) ||
                  hit;
          }
          occ = occ || (need && hit);
        }
        return block_max((sp.has_ray && !occ) ? bound : -FLT_MAX, s_red);
      });
  if (sp.has_ray && sp.s == 0) occ_out[i] = occ ? 1 : 0;
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

// cluster_plan: modes kFlat, kDual and kSuper, each tile's list sorted.
extern "C" int cluster_plan(PLAN_ARGS, float* entry_out, int32_t* visit_out,
                            int32_t* nvis_out, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  if (mode != kFlat && mode != kDual && mode != kSuper) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int n_keys = 1;
  while (n_keys < n_clusters) n_keys <<= 1;
  if (n_clusters > kPadId) return static_cast<int>(cudaErrorInvalidValue);
  const int n_super = mode == kSuper ? n_second : 0;
  const size_t shared =
      plan_shared_bytes(tile_r, n_clusters, n_super, n_keys);
  const bool wide = n_clusters > kNarrowClusters;
  auto kernel = mode == kDual
                    ? (wide ? plan_kernel<kDual, true> : plan_kernel<kDual, false>)
                : mode == kSuper
                    ? (wide ? plan_kernel<kSuper, true>
                            : plan_kernel<kSuper, false>)
                    : (wide ? plan_kernel<kFlat, true> : plan_kernel<kFlat, false>);
  const cudaError_t err = allow_shared(kernel, shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n_rays + tile_r - 1) / tile_r;
  kernel<<<tiles, kPlanThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      Boxes{lox, loy, loz, hix, hiy, hiz},
      Boxes{slox, sloy, sloz, shix, shiy, shiz}, n_super, px, py, pz, dx, dy,
      dz, tf, valid, n_rays, tile_r, n_clusters, n_keys, entry_out, visit_out,
      nvis_out);
  return static_cast<int>(cudaGetLastError());
}

// cluster_plan_rows: every mode, the unsorted [T, C] entry matrix.
extern "C" int cluster_plan_rows(PLAN_ARGS, float* entry_out, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  if (mode < kFlat || mode > kHybrid) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_super = mode == kSuper ? n_second : 0;
  const size_t shared =
      (static_cast<size_t>(tile_r) * 7 + n_super) * sizeof(float);
  auto kernel = mode == kDual      ? plan_rows_kernel<kDual>
                : mode == kSuper   ? plan_rows_kernel<kSuper>
                : mode == kTilebox ? plan_rows_kernel<kTilebox>
                : mode == kHybrid  ? plan_rows_kernel<kHybrid>
                                   : plan_rows_kernel<kFlat>;
  const cudaError_t err = allow_shared(kernel, shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n_rays + tile_r - 1) / tile_r;
  kernel<<<tiles, kPlanThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      Boxes{lox, loy, loz, hix, hiy, hiz},
      Boxes{slox, sloy, sloz, shix, shiy, shiz}, n_super, px, py, pz, dx, dy,
      dz, tf, valid, n_rays, tile_r, n_clusters, entry_out);
  return static_cast<int>(cudaGetLastError());
}

#undef PLAN_ARGS

extern "C" int cluster_occluded(
    const int32_t* nvis, const int32_t* visit, const float* entry,
    const float* root, const float* px, const float* py, const float* pz,
    const float* dx, const float* dy, const float* dz, const float* tfar,
    const float* table, int battery, int n_rays, int tile_r, int n_clusters,
    int k_prims, uint8_t* occ_out, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const size_t shared =
      static_cast<size_t>(k_prims) * (battery ? 3 : 1) * sizeof(float4);
  auto kernel = battery == kTriangleProduct
                    ? occluded_kernel<kTriangleProduct>
                : battery == kTriangle ? occluded_kernel<kTriangle>
                                       : occluded_kernel<kSphere>;
  const cudaError_t err = allow_shared(kernel, shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n_rays + tile_r - 1) / tile_r;
  kernel<<<tiles, tile_r, shared, static_cast<cudaStream_t>(stream)>>>(
      nvis, visit, entry, root, px, py, pz, dx, dy, dz, tfar,
      reinterpret_cast<const float4*>(table), n_rays, n_clusters, k_prims,
      occ_out);
  return static_cast<int>(cudaGetLastError());
}

// The closest walks: `battery` 0 (spheres), 1 (triangles) or 2 (the
// product form, resident table only), `split` the S of the S-way split (1,
// 2 or 4; tile_r * S threads a block, at most 1024). Two slots of one
// cluster's rows. cluster_closest reads the resident [C * K, F] table
// (16-byte aligned), cluster_closest_stream the packed [C * F8, K] one.
using ClosestFn = decltype(&closest_kernel<kSphere, false, 1>);

template <int kBattery, bool kPacked>
static ClosestFn closest_split(int split) {
  return split == 4   ? closest_kernel<kBattery, kPacked, 4>
         : split == 2 ? closest_kernel<kBattery, kPacked, 2>
         : split == 1 ? closest_kernel<kBattery, kPacked, 1>
                      : nullptr;
}

// The kernel of (battery, table, split), or nullptr where there is none.
static ClosestFn closest_for(int battery, bool packed, int split) {
  if (packed) {
    return battery == kTriangle ? closest_split<kTriangle, true>(split)
           : battery == kSphere ? closest_split<kSphere, true>(split)
                                : nullptr;
  }
  return battery == kTriangleProduct
             ? closest_split<kTriangleProduct, false>(split)
         : battery == kTriangle ? closest_split<kTriangle, false>(split)
         : battery == kSphere   ? closest_split<kSphere, false>(split)
                                : nullptr;
}

#define CLOSEST_ARGS                                                        \
  const int32_t *nvis, const int32_t *visit, const float *entry,            \
      const float *root, const float *px, const float *py, const float *pz, \
      const float *dx, const float *dy, const float *dz, const float *tf0,  \
      const uint8_t *valid, const float *table, int battery, int split,     \
      int n_rays, int tile_r, int n_clusters, int k_prims, float *tfar_out, \
      int32_t *prim_out, void *stream

static int launch_closest(bool packed, CLOSEST_ARGS) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const ClosestFn kernel = closest_for(battery, packed, split);
  if (kernel == nullptr || tile_r * split > kMaxBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t shared =
      2 * static_cast<size_t>(k_prims) * (battery ? 12 : 4) * sizeof(float);
  const cudaError_t err = allow_shared(kernel, shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n_rays + tile_r - 1) / tile_r;
  kernel<<<tiles, tile_r * split, shared,
           static_cast<cudaStream_t>(stream)>>>(
      nvis, visit, entry, root, px, py, pz, dx, dy, dz, tf0, valid, table,
      n_rays, tile_r, n_clusters, k_prims, tfar_out, prim_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cluster_closest(CLOSEST_ARGS) {
  return launch_closest(false, nvis, visit, entry, root, px, py, pz, dx, dy,
                        dz, tf0, valid, table, battery, split, n_rays, tile_r,
                        n_clusters, k_prims, tfar_out, prim_out, stream);
}

extern "C" int cluster_closest_stream(CLOSEST_ARGS) {
  return launch_closest(true, nvis, visit, entry, root, px, py, pz, dx, dy,
                        dz, tf0, valid, table, battery, split, n_rays, tile_r,
                        n_clusters, k_prims, tfar_out, prim_out, stream);
}

#undef CLOSEST_ARGS

// The streamed any-hit walk: `packed` is the [C * F8, K] table, `battery` 0
// for spheres and 1 for triangles, `split` as above.
using OccludedStreamFn = decltype(&occluded_stream_kernel<true, 1>);

static OccludedStreamFn occluded_stream_for(int battery, int split) {
  if (battery) {
    return split == 4   ? occluded_stream_kernel<true, 4>
           : split == 2 ? occluded_stream_kernel<true, 2>
           : split == 1 ? occluded_stream_kernel<true, 1>
                        : nullptr;
  }
  return split == 4   ? occluded_stream_kernel<false, 4>
         : split == 2 ? occluded_stream_kernel<false, 2>
         : split == 1 ? occluded_stream_kernel<false, 1>
                      : nullptr;
}

extern "C" int cluster_occluded_stream(
    const int32_t* nvis, const int32_t* visit, const float* entry,
    const float* root, const float* px, const float* py, const float* pz,
    const float* dx, const float* dy, const float* dz, const float* tfar,
    const float* packed, int battery, int split, int n_rays, int tile_r,
    int n_clusters, int k_prims, uint8_t* occ_out, void* stream) {
  if (n_rays <= 0) return static_cast<int>(cudaGetLastError());
  const OccludedStreamFn kernel = occluded_stream_for(battery, split);
  if (kernel == nullptr || tile_r * split > kMaxBlock) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t shared =
      2 * static_cast<size_t>(k_prims) * (battery ? 12 : 4) * sizeof(float);
  const cudaError_t err = allow_shared(kernel, shared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (n_rays + tile_r - 1) / tile_r;
  kernel<<<tiles, tile_r * split, shared,
           static_cast<cudaStream_t>(stream)>>>(
      nvis, visit, entry, root, px, py, pz, dx, dy, dz, tfar, packed, n_rays,
      tile_r, n_clusters, k_prims, occ_out);
  return static_cast<int>(cudaGetLastError());
}
