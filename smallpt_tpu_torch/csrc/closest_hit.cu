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
// - an early miss in K2's own copies of the two tests (stable_tt,
//   direct_tt; lane.cuh's, which K1 and K3 share, keep the JAX order):
//   where !(det >= 0 && r > 0) the pair is dropped before the square
//   roots, the roots and the division that only a hit needs, and before
//   the fold's compare (the whole test gives 3e38 there, never below the
//   fold's best, which starts at 3e38). The same ops in the same order
//   otherwise, so the same bits, NaN included. On 10,000 spheres ~0.1% of
//   the pairs and 0.2-1.1% of the (32 rays, row) pairs go past det;
// - the launch fills the card: where its ray blocks would leave part of
//   the blocks the card holds at once (the fill: the SMs times this
//   kernel's occupancy, read once a device) idle, the rows are cut into
//   ranges of whole chunks, one unit (a block) a (ray block, range): the
//   fewest ranges whose units run in full-row waves within 5% of the ideal
//   (plan.cuh::make_plan, shared with K6). Each unit folds its rows in
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

// lane.cuh::sphere_tt with the miss decided first (K8's
// sphere_tt_miss_first): where det < 0 or NaN, or the radius is not
// positive, it returns false before the two square roots and the division
// that only a hit needs (the whole test's 3e38 there is never below a
// fold's best, which starts at 3e38, so the fold skips the pair);
// otherwise true and the whole test's tt, op for op. c = [cx cy cz r].
__device__ __forceinline__ bool stable_tt(float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float4 c, float seps, float& tt) {
  const float opx = c.x - ox;
  const float opy = c.y - oy;
  const float opz = c.z - oz;
  const float b = opx * dx + opy * dy + opz * dz;
  const float fx = opx - b * dx;
  const float fy = opy - b * dy;
  const float fz = opz - b * dz;
  const float pp = fx * fx + fy * fy + fz * fz;
  const float sp = sqrtf(pp);
  const float det = (c.w - sp) * (c.w + sp);
  if (!(det >= 0.0f && c.w > 0.0f)) return false;
  const float s = sqrtf(fmaxf(det, 0.0f));
  const float opn = sqrtf(b * b + pp);
  const float cc = (opn - c.w) * (opn + c.w);
  const float denom = b + s;
  const float t_near = denom > 0.0f ? cc / denom : -kBig;
  tt = t_near > seps ? t_near : (denom > seps ? denom : kBig);
  return true;
}

// lane.cuh::sphere_tt_fast with the miss decided first, as stable_tt:
// false where det < 0 or NaN, or the radius is not positive, before the
// square root and the roots; otherwise true and the whole test's tt. rr =
// r * r, rounded once as there. c = [cx cy cz r].
__device__ __forceinline__ bool direct_tt(float ox, float oy, float oz,
                                          float dx, float dy, float dz,
                                          float4 c, float rr, float seps,
                                          float& tt) {
  const float opx = c.x - ox;
  const float opy = c.y - oy;
  const float opz = c.z - oz;
  const float b = opx * dx + opy * dy + opz * dz;
  const float op2 = opx * opx + opy * opy + opz * opz;
  const float det = b * b - op2 + rr;
  if (!(det >= 0.0f && c.w > 0.0f)) return false;
  const float s = sqrtf(fmaxf(det, 0.0f));
  const float t0 = b - s;
  const float t1 = b + s;
  tt = t0 > seps ? t0 : (t1 > seps ? t1 : kBig);
  return true;
}

__global__ void __launch_bounds__(kBlock)
    closest_hit_kernel(const float* __restrict__ org,
                       const float* __restrict__ dir,
                       const float4* __restrict__ rows, float* t_out,
                       int* slot_out, float2* part, int* done, int n,
                       int n_a, int n_rows, int range_rows) {
  __shared__ float4 s_c[kChunk], s_e[kChunk];
  __shared__ int s_warp[4 * kWarps];
  __shared__ int s_last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float bt[kRays];
  int bi[kRays];
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const int i = blockIdx.x * kBlockRays + j * kBlock + threadIdx.x;
    // a ray past the last traces a finite dummy
    const bool ray = i < n;
    ox[j] = ray ? org[i] : 0.0f;
    oy[j] = ray ? org[n + i] : 0.0f;
    oz[j] = ray ? org[2 * n + i] : 0.0f;
    dx[j] = ray ? dir[i] : 1.0f;
    dy[j] = ray ? dir[n + i] : 0.0f;
    dz[j] = ray ? dir[2 * n + i] : 0.0f;
    bt[j] = kBig;
    bi[j] = 0;
  }
  const int lo = blockIdx.y * range_rows;
  const int hi = min(n_rows, lo + range_rows);
  for (int base = lo; base < hi; base += kChunk) {
    // stage the chunk's live rows (r > 0) in table order, two rows a
    // thread, their places from the warps' ballots; the part-A ones (slot
    // < n_a) come first, m_a of them
    bool live[2];
    unsigned ball[2], ball_a[2];
    float4 c[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = base + h * kBlock + threadIdx.x;
      live[h] = false;
      if (k < hi) {
        c[h] = __ldg(rows + 2 * k);
        live[h] = c[h].w > 0.0f;
      }
      ball[h] = __ballot_sync(0xffffffffu, live[h]);
      ball_a[h] = __ballot_sync(0xffffffffu, live[h] && k < n_a);
    }
    __syncthreads();  // the previous chunk's readers are done
    if (lane == 0) {
      s_warp[warp] = __popc(ball[0]);
      s_warp[kWarps + warp] = __popc(ball[1]);
      s_warp[2 * kWarps + warp] = __popc(ball_a[0]);
      s_warp[3 * kWarps + warp] = __popc(ball_a[1]);
    }
    __syncthreads();
    int m = 0, m_a = 0, off[2] = {0, 0};
#pragma unroll
    for (int e = 0; e < 2 * kWarps; ++e) {
      if (e == warp) off[0] = m;
      if (e == kWarps + warp) off[1] = m;
      m += s_warp[e];
      m_a += s_warp[2 * kWarps + e];
    }
    const unsigned below = (1u << lane) - 1u;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (live[h]) {
        const int k = base + h * kBlock + threadIdx.x;
        const int at = off[h] + __popc(ball[h] & below);
        s_c[at] = c[h];
        s_e[at] = make_float4(
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
        if (stable_tt(ox[j], oy[j], oz[j], dx[j], dy[j], dz[j], r, e.x,
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
        if (direct_tt(ox[j], oy[j], oz[j], dx[j], dy[j], dz[j], r, e.y, e.x,
                      tt) &&
            tt < bt[j]) {
          bt[j] = tt;
          bi[j] = __float_as_int(e.z);
        }
      }
    }
  }
  if (gridDim.y == 1) {
#pragma unroll
    for (int j = 0; j < kRays; ++j) {
      const int i = blockIdx.x * kBlockRays + j * kBlock + threadIdx.x;
      if (i < n) {
        t_out[i] = bt[j];
        slot_out[i] = bi[j];
      }
    }
    return;
  }
  // a range of several: this unit's partials, then the last unit of the
  // ray block folds them all in range order
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const int i = blockIdx.x * kBlockRays + j * kBlock + threadIdx.x;
    if (i < n)
      part[(size_t)blockIdx.y * n + i] =
          make_float2(bt[j], __int_as_float(bi[j]));
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(done + blockIdx.x, 1) == (int)gridDim.y - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    const int i = blockIdx.x * kBlockRays + j * kBlock + threadIdx.x;
    if (i >= n) continue;
    float2 best = __ldcg(part + i);
    for (int r = 1; r < (int)gridDim.y; ++r) {
      const float2 p = __ldcg(part + (size_t)r * n + i);
      if (p.x < best.x) best = p;
    }
    t_out[i] = best.x;
    slot_out[i] = __float_as_int(best.y);
  }
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
