// Closest-hit sphere kernel for sm_90a (kernel K2): the brute closest
// (t, slot) of every ray over a two-part sphere table.
//
// Replaces: smallpt_tpu/ops/intersect_pallas.py::_intersect_kernel, launched
// there by _closest_hit through one pallas_call; entry point
// smallpt_closest_hit, kernel closest_hit_kernel; the launch's plan,
// smallpt_closest_hit_plan.
//
// Contract (ops/intersect_pallas.py::closest_hit): org and dir are (3, N) f32
// planes, the table (rows, 8) f32 rows [cx cy cz r eps 0 0 0]. Rows
// [0, n_a) are swept in the stable citardauq form (op for op the JAX
// kernel's stable_body, lane.cuh::sphere_tt), rows [n_a, n_a + n_b) in the
// direct quadratic (its fast_body, lane.cuh::sphere_tt_fast). Each ray gets
// the least t (3e38 where nothing is hit) and the first slot holding it (0
// on a miss). The JAX kernel's chunk min-loc (the first row of a chunk
// attaining the chunk's least t) followed by a strict < across chunks is
// this one sequential strict-< fold over the slots in table order.
//
// What bounds it on an H100: at the Cornell box (11 live rows of 192,
// 786,432 rays) the bytes, 24 B of ray in and 8 B of result out a ray, ~25
// MB a launch, 7.5 us at 3.35 TB/s; at 10,000 spheres (10,121 live rows)
// the float work. A REGEN bounce of 196,608 rays is 1.99 G (ray, live row)
// pairs for this brute sweep, all but ~0.1% misses (det < 0), but a grid
// walk (K4, dda.cu) finds the same hits with ~190 tests a ray (part A's
// 128 and ~60 in the ~2.5 cells it walks), so the function's bound there
// is the walk's work, ~0.012 ms at 67 TFLOP/s (chip_smoke.py::k2_bound).
// Beside it the floor of this sweep's own work, each pair at the ops spent
// up to its decision (17 a direct miss, 24 a stable one, 24 and 38 a det
// >= 0 pair, none for a row left out): 0.51 ms; and at the whole test on
// every row, as the kernel before this design was held to: 0.78 ms.
//
// What the design does about it:
// - live rows only: as the table is staged through shared memory (kChunk
//   rows at a time, the survivors in table order, their places from the
//   warps' ballots), every row where !(r > 0) is left out (part A's
//   padding, part B's zeroed big spheres and padding; a NaN radius too):
//   such a row is never hit, so the fold is unchanged. Each survivor is
//   staged as two float4 rows, [cx cy cz r] and [eps r*r slot 0] (r*r the
//   same single rounding the direct quadratic takes), the part-A rows
//   first (they are the slots below n_a), so each chunk sweeps its stable
//   rows, then its direct ones, with no radius test and no per-row form
//   test. The Cornell box sweeps 11 rows, not 192;
// - kRays rays a thread: each staged row, two shared-memory broadcasts,
//   serves all of a thread's rays; a ray past the last traces a finite
//   dummy and is not written. Four rays take 69 registers (7 blocks, 28
//   warps an SM; 8 KB of shared memory a block); on a 10,000-sphere
//   bounce they ran 6% ahead of two rays and 12% ahead of one, on path
//   4's 25 M Cornell rays 5% and 22% (PERF.md);
// - an early miss in lane.cuh's early_stable_tt and early_direct_tt,
//   shared with K3, K4 and K5 (lane.cuh's sphere_tt and sphere_tt_fast,
//   which K1 shares, keep the JAX order): where !(det >= 0 && r > 0) the
//   pair is dropped before the square roots, the roots and the division
//   that only a hit needs, and before the fold's compare (the whole test
//   gives 3e38 there, never below the fold's best, which starts at 3e38).
//   The same ops in the same order otherwise, so the same bits, NaN
//   included. On 10,000 spheres ~0.1% of the pairs and 0.2-1.1% of the
//   (32 rays, row) pairs go past det;
// - the launch fills the card: where its ray blocks would leave part of
//   the blocks the card holds at once (the fill: the SMs times this
//   kernel's occupancy, read once a device) idle, the rows are cut into
//   ranges of whole chunks, one unit (a block) a (ray block, range): the
//   fewest ranges whose units run in full-row waves within 5% of the ideal
//   (plan.cuh::make_plan, shared with K5 and K6, as are the staging,
//   stage_places, and the merge, finish_unit). Each unit folds its rows in
//   order with the strict < from (3e38, slot 0) and writes a partial (t,
//   slot) a ray; the last unit of a ray block to finish (a counter a ray
//   block, zeroed on the stream before the launch) folds the partials in
//   range order with the strict <: the least t and, among equal ones, the
//   earliest range's, whose own slot is its first, so the sequential
//   fold's winner for any cut (tests/test_torch_hit_split.py). A range
//   may cross the A/B boundary; a range with no hit leaves (3e38, 0);
// - the ray planes are read coalesced (plane-major, as the JAX kernel's
//   (3, N) layout), the results written once;
// - built with --fmad=false, so each op rounds as in the JAX kernel and in
//   the plain version (ops/intersect_pallas.py::closest_hit_plain).
//
// Interface: plain C functions, loaded with ctypes. The launch runs on the
// caller's stream (a memset of the counters where the rows are cut, then
// the kernel), synchronises nothing, allocates nothing (the caller hands
// it scratch of the plan's size) and returns the first cudaGetLastError().

#include "lane.cuh"
#include "plan.cuh"

namespace {

using namespace smallpt;

constexpr int kBlock = 128;                // threads a block
constexpr int kRays = 4;                   // rays a thread
constexpr int kBlockRays = kBlock * kRays;
constexpr int kChunk = 2 * kBlock;         // table rows staged at once
constexpr int kWarps = kBlock / 32;

__global__ void __launch_bounds__(kBlock)
    closest_hit_kernel(const float* __restrict__ org,
                       const float* __restrict__ dir,
                       const float4* __restrict__ rows, float* t_out,
                       int* slot_out, float2* part, int* done, int n,
                       int n_a, int n_rows, int range_rows) {
  __shared__ float4 s_c[kChunk], s_e[kChunk];
  __shared__ int s_warp[4 * kWarps];
  __shared__ int s_last;
  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float bt[kRays];
  int bi[kRays];
  load_rays<kBlock, kRays>(org, dir, n, ox, oy, oz, dx, dy, dz);
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    bt[j] = kBig;
    bi[j] = 0;
  }
  const int lo = blockIdx.y * range_rows;
  const int hi = min(n_rows, lo + range_rows);
  for (int base = lo; base < hi; base += kChunk) {
    // stage the chunk's live rows (r > 0) in table order, two rows a
    // thread; the part-A ones (slot < n_a) come first, m_a of them
    bool live[2], in_a[2];
    float4 c[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = base + h * kBlock + threadIdx.x;
      live[h] = false;
      in_a[h] = k < n_a;
      if (k < hi) {
        c[h] = __ldg(rows + 2 * k);
        live[h] = c[h].w > 0.0f;
      }
    }
    int at[2], m, m_a;
    stage_places<kWarps>(live, in_a, s_warp, at, m, m_a);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (live[h]) {
        const int k = base + h * kBlock + threadIdx.x;
        s_c[at[h]] = c[h];
        s_e[at[h]] = make_float4(
            __ldg(reinterpret_cast<const float*>(rows) + 8 * k + 4),
            c[h].w * c[h].w, __int_as_float(k), 0.0f);
      }
    }
    __syncthreads();
    for (int q = 0; q < m_a; ++q) {
      const float4 r = s_c[q], e = s_e[q];
#pragma unroll
      for (int j = 0; j < kRays; ++j) {
        float tt;
        if (early_stable_tt(ox[j], oy[j], oz[j], dx[j], dy[j], dz[j], r, e.x,
                            tt) &&
            tt < bt[j]) {
          bt[j] = tt;
          bi[j] = __float_as_int(e.z);
        }
      }
    }
    for (int q = m_a; q < m; ++q) {
      const float4 r = s_c[q], e = s_e[q];
#pragma unroll
      for (int j = 0; j < kRays; ++j) {
        float tt;
        if (early_direct_tt(ox[j], oy[j], oz[j], dx[j], dy[j], dz[j], r, e.y,
                            e.x, tt) &&
            tt < bt[j]) {
          bt[j] = tt;
          bi[j] = __float_as_int(e.z);
        }
      }
    }
  }
  float2 best[kRays];
#pragma unroll
  for (int j = 0; j < kRays; ++j)
    best[j] = make_float2(bt[j], __int_as_float(bi[j]));
  finish_unit<kBlock, kRays>(best, part, done, n, &s_last,
                             [=](int i, float2 b) {
                               t_out[i] = b.x;
                               slot_out[i] = __float_as_int(b.y);
                             });
}

}  // namespace

// The plan smallpt_closest_hit makes on the current device for n rays over
// n_rows rows (forced > 0: the rows cut into that many ranges, which
// chip_smoke.py's checks of the merge ask for): out, seven int64 {blocks,
// ranges, range_rows, fill, n_sm, per_sm, scratch_words}.
// Returns a cudaError_t (the device query's).
extern "C" int smallpt_closest_hit_plan(int n, int n_rows, int forced,
                                        void* out) {
  if (n < 0 || n_rows < 0 || forced < 0) return (int)cudaErrorInvalidValue;
  Fit fit;
  const cudaError_t err = device_fit(closest_hit_kernel, kBlock, &fit);
  if (err != cudaSuccess) return (int)err;
  write_plan(make_plan(n, n_rows, forced, fit, kBlockRays, kChunk, 2), out);
  return 0;
}

// The closest (t, slot) of iparams[0] rays. org, dir: (3, N) f32 planes and
// table: (rows, 8) f32 on the device; t: (N,) f32 and slot: (N,) i32
// outputs; scratch: iparams[3] int32 words on the device, at least the
// plan's scratch_words (nothing in it is read before the launch writes
// it); iparams: host array {N, n_a, n_b, scratch words, forced ranges (0:
// the plan's own)}; stream: a cudaStream_t. Returns the first
// cudaGetLastError().
extern "C" int smallpt_closest_hit(const void* org, const void* dir,
                                   const void* table, void* t, void* slot,
                                   void* scratch, const void* iparams,
                                   void* stream) {
  int ip[5];
  memcpy(ip, iparams, sizeof(ip));
  const int n = ip[0], n_a = ip[1], n_b = ip[2];
  if (n < 0 || n_a < 0 || n_b < 0 || ip[4] < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Fit fit;
  cudaError_t err = device_fit(closest_hit_kernel, kBlock, &fit);
  if (err != cudaSuccess) return (int)err;
  const Plan p = make_plan(n, n_a + n_b, ip[4], fit, kBlockRays, kChunk, 2);
  if (ip[3] < p.scratch_words) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float2* part = (float2*)scratch;
  int* done = (int*)scratch + 2 * p.ranges * n;
  if (p.ranges > 1 &&
      (err = cudaMemsetAsync(done, 0, p.blocks * sizeof(int), s)) !=
          cudaSuccess)
    return (int)err;
  const dim3 grid((unsigned)p.blocks, (unsigned)p.ranges);
  closest_hit_kernel<<<grid, kBlock, 0, s>>>(
      (const float*)org, (const float*)dir, (const float4*)table, (float*)t,
      (int*)slot, part, done, n, n_a, n_a + n_b, (int)p.range_rows);
  return (int)cudaGetLastError();
}
