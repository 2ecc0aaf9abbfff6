// Closest-hit sphere kernel for sm_90a with the small spheres' quadratic
// coefficients taken from table rows (kernel K5).
//
// Replaces: smallpt_tpu/ops/intersect_pallas.py::_intersect_kernel_mxu,
// launched there by _closest_hit_mxu through one pallas_call; entry point
// smallpt_closest_hit_mxu, kernel closest_hit_mxu_kernel; the launch's
// plan, smallpt_closest_hit_mxu_plan.
//
// Contract (ops/intersect_pallas.py::closest_hit_mxu): org (origins in the
// frame recentred at the small spheres' centroid) and dir are (3, N) f32
// planes. Part A, the (rows, 8) f32 stable table [cx cy cz r eps 0 0 0],
// is swept over its first n_a rows in the stable citardauq form
// (lane.cuh::sphere_tt, K2's part A). The small class is the (2 * n_b, 8)
// f32 MXU table: chunk c holds 64 rows of b coefficients [cx cy cz 0 0 0 0
// 0] and then 64 rows of det coefficients [0 0 0 2cx 2cy 2cz -q -1]; a
// masked row (a big sphere, the padding) carries q = 1e30 and a 0 in place
// of -1. Slot n_a + j is small sphere j. Each ray gets the least t (3e38
// where nothing is hit) and the first slot holding it (0 on a miss): the
// JAX kernel's chunk min-loc and strict < across chunks are one
// sequential strict-< fold over the slots in order.
//
// The small class's test, over the coefficients' non-zero terms, in the
// order the 8-term dot products take them (od = o.d, oo = o.o a ray):
//   b   = ((cx dx + cy dy) + cz dz) - od
//   e   = (((2cx ox + 2cy oy) + 2cz oz) + (-q)) - oo
//   det = b b + e
// then, where det >= 0, s = sqrt(det) and the roots b - s and b + s
// against the one eps. The plain version (closest_hit_mxu_plain) takes the
// same form, so the two agree bit for bit on every input. Against the
// 8-term dots summed left to right with their zero terms (the form this
// kernel had before, kept in numpy by
// tests/test_torch_mxu.py::test_plain_is_the_kernels_arithmetic_in_numpy):
// wherever the features are finite each zero term is a +-0 added to a
// partial sum, which leaves a non-zero sum as it is; (-q) * 1 and (-1) *
// oo are exact. So b can differ only in the sign of a zero, b * b not at
// all, and e only in the sign of a zero, which b * b + e (b * b is +0 or
// more) absorbs: det has the same bits. Where b is a zero of the other
// sign and det is 0, the root b - s is a zero of the other sign, which a
// compare with an eps >= 0 treats alike. A masked row is left out (below);
// in the 8-term form it gave b = -od and det = od * od - 1e30, a miss
// wherever the recentred |o| stays well below 1e15 (ROADMAP.md records the
// hazard beyond). An early miss: where !(det >= 0) (a NaN included) the
// pair is dropped before the square root, the roots and the fold's
// compare; before, the NaN square root failed both root compares and gave
// 3e38, which a fold never takes, so the result is the same.
//
// What bounds it on an H100: the float work. On procedural_sphere_scene
// (10000) and 196,608 rays every ray sweeps 128 live part-A rows and 9,993
// live small spheres. A small pair costs 16 ops up to its det test (b 6,
// e 7, det 2, the compare) and 22 past it (the square root, the two roots,
// their compares, the fold's); a part-A pair K2's stable counts (24 to a
// miss, 38 past det); a masked row none. chip_smoke.py::k5_bound counts
// this run's pairs; beside it the count at 21 ops a small pair that this
// kernel was held to before (its dots also summed the zero terms, 39 ops),
// and the function's own bound, a grid walk's (K4's) work on the same
// rays, two orders of magnitude lower. The bytes, 24 B of ray in and 8 B
// out a ray and the 643-KB table once, take 0.002 ms.
//
// What the design does about it (K2's design, csrc/closest_hit.cu, on this
// table, with K2's rays, staging and merge from plan.cuh: load_rays,
// stage_places, finish_unit):
// - live rows only: as a chunk of kChunk slots is staged through shared
//   memory, a part-A row whose radius is not > 0 and a small sphere whose
//   det row has a 0 in column 7 (masked) are left out; the survivors go in
//   slot order (their places from the warps' ballots), part A's first.
//   A part-A row is staged as [cx cy cz r] and [eps - - slot], a small
//   sphere as its non-zero coefficients, [cx cy cz -q] and [2cx 2cy 2cz
//   slot]. The tables themselves (build_sphere_table_mxu) are unchanged;
// - kRays rays a thread: each staged row, two shared-memory broadcasts,
//   serves all of a thread's rays; a ray past the last traces a finite
//   dummy and is not written. Four rays capped at kMinBlocks blocks an SM
//   (71 registers, a few spilled) ran 13% ahead of four uncapped (80
//   registers, 6 blocks), 9% ahead of two uncapped, 4% ahead of three and
//   level with two capped at 8 blocks; the small spheres' loop unrolled
//   4 times, so that the tests of a ray's next spheres overlap, 7% more
//   (unrolled twice, 4%; PERF.md);
// - part A through lane.cuh's early_stable_tt, the miss decided at det;
// - the launch fills the card through csrc/plan.cuh::make_plan, shared
//   with K2 and K6: where the ray blocks would leave part of the blocks the
//   card holds at once idle, the slots are cut into ranges of whole chunks,
//   one unit a (ray block, range); each unit folds its range with the
//   strict < from (3e38, slot 0) and writes a partial (t, slot) a ray, and
//   the last unit of a ray block to finish (a counter a ray block, zeroed
//   on the stream before the launch) folds the partials in range order
//   with the strict <, which keeps the earliest range's slot on a tie, the
//   sequential fold's (a merge that took ties would fail on twin spheres;
//   tests/test_torch_mxu_split.py);
// - built with --fmad=false, so every op rounds as in the plain version;
// - FP32 cores only. The tensor cores are left out: TF32 keeps 10
//   mantissa bits, so b and det would lose the f32 answer; 3xTF32 gets
//   close to f32, but the hardware accumulates in an order it does not
//   fix, so no plain version can equal it bit for bit; and the FP32 bound
//   at the old 21-op count (0.63 ms) is already 8x below the time this
//   kernel took before this design.
//
// Interface: plain C functions, loaded with ctypes. The launch runs on the
// caller's stream (a memset of the counters where the slots are cut, then
// the kernel), synchronises nothing, allocates nothing (the caller hands
// it scratch of the plan's size) and returns the first cudaGetLastError().

#include "lane.cuh"
#include "plan.cuh"

namespace {

using namespace smallpt;

constexpr int kBlock = 128;         // threads a block
constexpr int kMinBlocks = 7;       // blocks an SM, for the register cap
constexpr int kRays = 4;            // rays a thread
constexpr int kBlockRays = kBlock * kRays;
constexpr int kChunk = 2 * kBlock;  // slots staged at once
constexpr int kWarps = kBlock / 32;
constexpr int kSph = 64;            // small spheres of an MXU-table chunk

// The small class's test of one (ray, sphere) pair: c = [cx cy cz -q], t2
// = [2cx 2cy 2cz -], the ray's od and oo. False where !(det >= 0), before
// the square root and the roots; otherwise true and the candidate t (3e38
// where neither root passes eps).
__device__ __forceinline__ bool coef_tt(float ox, float oy, float oz,
                                        float dx, float dy, float dz,
                                        float od, float oo, float4 c,
                                        float4 t2, float eps, float& tt) {
  const float b = c.x * dx + c.y * dy + c.z * dz - od;
  const float e = t2.x * ox + t2.y * oy + t2.z * oz + c.w - oo;
  const float det = b * b + e;
  if (!(det >= 0.0f)) return false;
  const float s = sqrtf(det);
  const float t0 = b - s;
  const float t1 = b + s;
  tt = t0 > eps ? t0 : (t1 > eps ? t1 : kBig);
  return true;
}

__global__ void __launch_bounds__(kBlock, kMinBlocks)
    closest_hit_mxu_kernel(const float* __restrict__ org,
                           const float* __restrict__ dir,
                           const float4* __restrict__ stable,
                           const float4* __restrict__ mxu, float* t_out,
                           int* slot_out, float2* part, int* done, int n,
                           int n_a, int n_slots, int range_slots,
                           float eps) {
  __shared__ float4 s_c[kChunk], s_e[kChunk];
  __shared__ int s_warp[4 * kWarps];
  __shared__ int s_last;
  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float od[kRays], oo[kRays], bt[kRays];
  int bi[kRays];
  load_rays<kBlock, kRays>(org, dir, n, ox, oy, oz, dx, dy, dz);
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    od[j] = (ox[j] * dx[j] + oy[j] * dy[j]) + oz[j] * dz[j];
    oo[j] = (ox[j] * ox[j] + oy[j] * oy[j]) + oz[j] * oz[j];
    bt[j] = kBig;
    bi[j] = 0;
  }
  const int lo = blockIdx.y * range_slots;
  const int hi = min(n_slots, lo + range_slots);
  for (int base = lo; base < hi; base += kChunk) {
    // stage the chunk's live slots in slot order, two a thread; the part-A
    // ones (slot < n_a) come first, m_a of them
    bool live[2], in_a[2];
    float4 c[2], e[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = base + h * kBlock + threadIdx.x;
      live[h] = false;
      in_a[h] = k < n_a;
      if (k < hi && k < n_a) {
        c[h] = __ldg(stable + 2 * k);  // cx cy cz r
        live[h] = c[h].w > 0.0f;
        e[h] = make_float4(__ldg(stable + 2 * k + 1).x, 0.0f, 0.0f,
                           __int_as_float(k));
      } else if (k < hi) {
        const int j = k - n_a;
        const int r1 = (j / kSph) * 2 * kSph + j % kSph;  // the b row
        const float4 b_row = __ldg(mxu + 2 * r1);           // cx cy cz 0
        const float4 d_lo = __ldg(mxu + 2 * (r1 + kSph));   // 0 0 0 2cx
        const float4 d_hi = __ldg(mxu + 2 * (r1 + kSph) + 1);  // 2cy 2cz -q w
        live[h] = d_hi.w != 0.0f;
        c[h] = make_float4(b_row.x, b_row.y, b_row.z, d_hi.z);
        e[h] = make_float4(d_lo.w, d_hi.x, d_hi.y, __int_as_float(k));
      }
    }
    int at[2], m, m_a;
    stage_places<kWarps>(live, in_a, s_warp, at, m, m_a);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (live[h]) {
        s_c[at[h]] = c[h];
        s_e[at[h]] = e[h];
      }
    }
    __syncthreads();
    for (int q = 0; q < m_a; ++q) {
      const float4 r = s_c[q], x = s_e[q];
#pragma unroll
      for (int j = 0; j < kRays; ++j) {
        float tt;
        if (early_stable_tt(ox[j], oy[j], oz[j], dx[j], dy[j], dz[j], r, x.x,
                            tt) &&
            tt < bt[j]) {
          bt[j] = tt;
          bi[j] = __float_as_int(x.w);
        }
      }
    }
#pragma unroll 4
    for (int q = m_a; q < m; ++q) {
      const float4 r = s_c[q], x = s_e[q];
#pragma unroll
      for (int j = 0; j < kRays; ++j) {
        float tt;
        if (coef_tt(ox[j], oy[j], oz[j], dx[j], dy[j], dz[j], od[j], oo[j],
                    r, x, eps, tt) &&
            tt < bt[j]) {
          bt[j] = tt;
          bi[j] = __float_as_int(x.w);
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

// The plan smallpt_closest_hit_mxu makes on the current device for n rays
// over n_slots slots (n_a + n_b; forced > 0: the slots cut into that many
// ranges, which chip_smoke.py's checks of the merge ask for): out, seven
// int64 {blocks, ranges, range_rows, fill, n_sm, per_sm, scratch_words}.
// Returns a cudaError_t (the device query's).
extern "C" int smallpt_closest_hit_mxu_plan(int n, int n_slots, int forced,
                                            void* out) {
  if (n < 0 || n_slots < 0 || forced < 0) return (int)cudaErrorInvalidValue;
  Fit fit;
  const cudaError_t err = device_fit(closest_hit_mxu_kernel, kBlock, &fit);
  if (err != cudaSuccess) return (int)err;
  write_plan(make_plan(n, n_slots, forced, fit, kBlockRays, kChunk, 2), out);
  return 0;
}

// The closest (t, slot) of iparams[0] rays. org, dir: (3, N) f32 planes,
// stable: (rows >= n_a, 8) f32 and mxu: (2 * n_b, 8) f32 on the device; t:
// (N,) f32 and slot: (N,) i32 outputs; scratch: iparams[3] int32 words on
// the device, at least the plan's scratch_words (nothing in it is read
// before the launch writes it); iparams: host array {N, n_a, n_b, scratch
// words, forced ranges (0: the plan's own)}; fparams: host array {eps};
// stream: a cudaStream_t. Returns the first cudaGetLastError().
extern "C" int smallpt_closest_hit_mxu(const void* org, const void* dir,
                                       const void* stable, const void* mxu,
                                       void* t, void* slot, void* scratch,
                                       const void* iparams,
                                       const void* fparams, void* stream) {
  int ip[5];
  float eps;
  memcpy(ip, iparams, sizeof(ip));
  memcpy(&eps, fparams, sizeof(eps));
  const int n = ip[0], n_a = ip[1], n_b = ip[2];
  if (n < 0 || n_a < 0 || n_b < 0 || n_b % kSph || ip[4] < 0)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Fit fit;
  cudaError_t err = device_fit(closest_hit_mxu_kernel, kBlock, &fit);
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
  closest_hit_mxu_kernel<<<grid, kBlock, 0, s>>>(
      (const float*)org, (const float*)dir, (const float4*)stable,
      (const float4*)mxu, (float*)t, (int*)slot, part, done, n, n_a,
      n_a + n_b, (int)p.range_rows, eps);
  return (int)cudaGetLastError();
}
