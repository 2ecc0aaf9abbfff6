// Closest-hit triangle kernel for sm_90a (kernel K6): the brute closest
// (t, tri, u, v) of every ray over a triangle table.
//
// Replaces: smallpt_tpu/ops/mesh_pallas.py::_mesh_kernel, launched there by
// _closest_tri through one pallas_call; entry point smallpt_closest_tri,
// kernel closest_tri_kernel; the launch's plan, smallpt_closest_tri_plan.
//
// Contract (ops/mesh_pallas.py::closest_tri): org and dir are (3, N) f32
// planes, the table (rows, 16) f32 rows [v0(3) e1(3) e2(3) n(3) valid 0 0
// 0] with n = cross(e1, e2). Per (ray, row), op for op the JAX kernel's
// formulation (iq's triIntersect, scene.cpp:52-70; tri.cuh::tri_candidate,
// which K7 shares):
//   rov0 = o - v0;  q = cross(rov0, d);  dn = dot(d, n)
//   inv = 1 / (dn == 0 ? 1 : dn)
//   u = -dot(q, e2) * inv;  v = dot(q, e1) * inv;  t = -dot(n, rov0) * inv
//   a candidate iff 0 <= u <= 1, 0 <= v, u + v <= 1, valid, dn != 0, t > eps.
// Each ray gets the least t (3e38 where nothing is hit), the first row
// holding it (0 on a miss) and that row's u and v (0 on a miss): the JAX
// kernel's chunk min-loc with a strict < across chunks, which is one
// sequential strict-< fold over the rows in table order.
//
// What bounds it on an H100: the float work of every (ray, live row) pair.
// A FLAT bounce of procedural_mesh_scene(500) (32,014 triangles) at
// 256x192, 4 spp, is 196,608 rays x 32,014 rows; its bytes (40 B a ray in
// and out, the 2.05 MB table once) take ~2 us. chip_smoke.py::k6_bound
// prices each pair at the ops a test that decides dn and t first needs,
// and beside it at tri_candidate's whole test.
//
// What the design does about it:
// - rows that can never be a candidate are left out as the table is
//   staged through shared memory (kChunk rows at a time, the survivors in
//   row order): the padding (valid 0) and the degenerate triangles (n =
//   (0, 0, 0), where dn is 0 or NaN for every ray: 8 of the 64 triangles
//   of each tessellated ball, 12.6% of procedural_mesh_scene(500)'s rows),
//   so the sweep has no padding test either. Every pair that is swept
//   takes tri_candidate's whole test, the one K7 runs. A test that drops
//   a pair on dn and t before q, u and v (a per-lane branch, or the tail
//   skipped where a whole warp drops) gains only on coherent camera rays
//   and loses 11-13% on bounce rays, whose warps run the tail on nearly
//   every row (PERF.md, PR 15);
// - kRays rays a thread: each row read from shared memory (v0/e1x, the
//   rest of the edges, e2z/n: three float4 broadcasts) serves them all;
//   13 KB of shared memory a block, so registers (70, 7 blocks or 28 warps
//   an SM) set the occupancy;
// - the launch fills the card: where its ray blocks would leave the
//   blocks the card holds at once (the fill: the SMs times this kernel's
//   occupancy, read once a device) partly idle, the rows are cut into
//   ranges of whole chunks, one unit (a block) a (ray block, range): the
//   fewest ranges whose units run in full-row waves within 5% of the ideal
//   (plan.cuh::make_plan, shared with K2 and K5, as are the staging,
//   stage_places, and the merge, finish_unit). Each unit folds its rows in
//   order with the strict < from (3e38, row 0) and writes a partial (t,
//   row, u, v) a ray; the last unit of a ray block to finish (a counter a
//   ray block, zeroed on the stream before the launch) folds the partials
//   in range order with the strict <: the least t and, among equal ones,
//   the earliest range's, whose own row is its first, so the sequential
//   fold's winner for any cut (tests/test_torch_tri_split.py). With every
//   pair tested whole, a later range does no more work than an uncut
//   sweep of its rows;
// - built with --fmad=false, so each op rounds as in the JAX kernel and in
//   the plain version (ops/mesh_pallas.py::closest_tri_plain).
//
// Interface: plain C functions, loaded with ctypes. The launch runs on the
// caller's stream (a memset of the counters, then the kernel), synchronises
// nothing, allocates nothing (the caller hands it scratch of the plan's
// size) and returns the first cudaGetLastError().

#include "tri.cuh"
#include "plan.cuh"

namespace {

using namespace smallpt;

constexpr int kBlock = 128;                // threads a block
constexpr int kRays = 2;                   // rays a thread
constexpr int kBlockRays = kBlock * kRays;
constexpr int kChunk = 2 * kBlock;         // table rows staged at once
constexpr int kWarps = kBlock / 32;

__global__ void __launch_bounds__(kBlock)
    closest_tri_kernel(const float* __restrict__ org,
                       const float* __restrict__ dir,
                       const float4* __restrict__ rows, float* t_out,
                       int* tri_out, float* u_out, float* v_out,
                       float4* part, int* done, int n, int n_rows,
                       int range_rows, float eps) {
  __shared__ float4 s_a[kChunk], s_b[kChunk], s_c[kChunk];
  __shared__ int s_idx[kChunk];
  __shared__ int s_warp[4 * kWarps];
  __shared__ int s_last;
  float ox[kRays], oy[kRays], oz[kRays], dx[kRays], dy[kRays], dz[kRays];
  float bt[kRays], bu[kRays], bv[kRays];
  int bi[kRays];
  load_rays<kBlock, kRays>(org, dir, n, ox, oy, oz, dx, dy, dz);
#pragma unroll
  for (int j = 0; j < kRays; ++j) {
    bt[j] = kBig;
    bu[j] = 0.0f;
    bv[j] = 0.0f;
    bi[j] = 0;
  }
  const int lo = blockIdx.y * range_rows;
  const int hi = min(n_rows, lo + range_rows);
  for (int base = lo; base < hi; base += kChunk) {
    // stage the chunk's live rows in row order, two rows a thread; a row is
    // live where it is valid and its n is not (0, 0, 0): with n = 0, dn is
    // 0 (or NaN) for every ray
    bool live[2];
    const bool one_class[2] = {false, false};
    float4 cn[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = base + h * kBlock + threadIdx.x;
      live[h] = false;
      if (k < hi) {
        cn[h] = __ldg(rows + 4 * k + 2);
        live[h] =
            __ldg(reinterpret_cast<const float*>(rows + 4 * k + 3)) > 0.5f &&
            !(cn[h].y == 0.0f && cn[h].z == 0.0f && cn[h].w == 0.0f);
      }
    }
    int at[2], m, m_first;
    stage_places<kWarps>(live, one_class, s_warp, at, m, m_first);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (live[h]) {
        const int k = base + h * kBlock + threadIdx.x;
        s_a[at[h]] = __ldg(rows + 4 * k);
        s_b[at[h]] = __ldg(rows + 4 * k + 1);
        s_c[at[h]] = cn[h];
        s_idx[at[h]] = k;
      }
    }
    __syncthreads();
    for (int q = 0; q < m; ++q) {
      const TriRow r{s_a[q], s_b[q], s_c[q], make_float4(0.f, 0.f, 0.f, 0.f)};
#pragma unroll
      for (int j = 0; j < kRays; ++j) {
        float t, u, v;
        if (tri_candidate(ox[j], oy[j], oz[j], dx[j], dy[j], dz[j], r, eps, t,
                          u, v) &&
            t < bt[j]) {
          bt[j] = t;
          bi[j] = s_idx[q];
          bu[j] = u;
          bv[j] = v;
        }
      }
    }
  }
  float4 best[kRays];
#pragma unroll
  for (int j = 0; j < kRays; ++j)
    best[j] = make_float4(bt[j], __int_as_float(bi[j]), bu[j], bv[j]);
  finish_unit<kBlock, kRays>(best, part, done, n, &s_last,
                             [=](int i, float4 b) {
                               t_out[i] = b.x;
                               tri_out[i] = __float_as_int(b.y);
                               u_out[i] = b.z;
                               v_out[i] = b.w;
                             });
}

}  // namespace

// The plan smallpt_closest_tri makes on the current device for n rays over
// n_rows rows: out, seven int64 {blocks, ranges, range_rows, fill, n_sm,
// per_sm, scratch_words}. Returns a cudaError_t (the device query's).
extern "C" int smallpt_closest_tri_plan(int n, int n_rows, void* out) {
  if (n < 0 || n_rows < 0) return (int)cudaErrorInvalidValue;
  Fit fit;
  const cudaError_t err = device_fit(closest_tri_kernel, kBlock, &fit);
  if (err != cudaSuccess) return (int)err;
  write_plan(make_plan(n, n_rows, 0, fit, kBlockRays, kChunk, 4), out);
  return 0;
}

// The closest (t, tri, u, v) of iparams[0] rays over the first iparams[1]
// table rows, rejecting t <= fparams[0]. org, dir: (3, N) f32 planes and
// table: (rows, 16) f32 on the device; t, u, v: (N,) f32 and tri: (N,) i32
// outputs; scratch: iparams[2] int32 words on the device, at least the
// plan's scratch_words (nothing in it is read before the launch writes
// it); stream: a cudaStream_t. Returns the first cudaGetLastError().
extern "C" int smallpt_closest_tri(const void* org, const void* dir,
                                   const void* table, void* t, void* tri,
                                   void* u, void* v, void* scratch,
                                   const void* iparams, const void* fparams,
                                   void* stream) {
  int ip[3];
  float fp[1];
  memcpy(ip, iparams, sizeof(ip));
  memcpy(fp, fparams, sizeof(fp));
  const int n = ip[0], n_rows = ip[1];
  if (n < 0 || n_rows < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  Fit fit;
  cudaError_t err = device_fit(closest_tri_kernel, kBlock, &fit);
  if (err != cudaSuccess) return (int)err;
  const Plan p = make_plan(n, n_rows, 0, fit, kBlockRays, kChunk, 4);
  if (ip[2] < p.scratch_words) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  float4* part = (float4*)scratch;
  int* done = (int*)scratch + 4 * p.ranges * n;
  if (p.ranges > 1 &&
      (err = cudaMemsetAsync(done, 0, p.blocks * sizeof(int), s)) !=
          cudaSuccess)
    return (int)err;
  const dim3 grid((unsigned)p.blocks, (unsigned)p.ranges);
  closest_tri_kernel<<<grid, kBlock, 0, s>>>(
      (const float*)org, (const float*)dir, (const float4*)table, (float*)t,
      (int*)tri, (float*)u, (float*)v, part, done, n, n_rows,
      (int)p.range_rows, fp[0]);
  return (int)cudaGetLastError();
}
