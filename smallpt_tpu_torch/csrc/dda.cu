// Per-ray DDA closest-hit sphere kernel for sm_90a (kernel K4): the closest
// (t, code) of every ray, found by walking the ray through a uniform grid
// of sphere lists.
//
// Replaces: smallpt_tpu/ops/dda.py::_dda_kernel, launched there by
// _closest_hit_dda through one pallas_call; entry point smallpt_dda, kernel
// dda_kernel.
//
// Contract (ops/dda.py::closest_hit_dda): org and dir are (3, N) f32 planes;
// part_a is the first 128 rows of the two-part sphere table, [cx cy cz r eps
// 0 0 0]; overflow is (F, 8) [cx cy cz r eps id 0 0]; cells is (C, K, 8),
// slot q of cell c [cx cy cz r id 0 0 0], filled from the front, an empty
// slot's id 3e38. Per ray, op for op the JAX kernel:
// 1. part A in the stable citardauq form (lane.cuh::sphere_tt, as K2's
//    closest_hit.cu sweeps it), the first slot attaining the least t;
// 2. the overflow rows in the direct quadratic (lane.cuh::sphere_tt_fast),
//    folded on (t, original id);
// 3. the walk: clip the ray to the grid box (directions below 1e-20 on an
//    axis are kept off zero), take the entry cell by truncating f32 to i32
//    and clamping, then at most nx + ny + nz + 3 steps, each testing the
//    cell's slots in the direct quadratic at the uniform local eps and
//    folding them on (t, id), ending once min(part A's t, the fold's t) is
//    no further than the cell's exit t, else stepping the axis of least
//    next crossing (ties to x, then y), ending when the ray leaves the grid;
// 4. part A wins a tie; code = an original id when a local or overflow
//    sphere wins, -(slot + 1) when part-A slot wins, 0 on a miss (t 3e38).
// The TPU kernel steps 1024-lane tiles in lockstep until the tile's last
// lane ends; a lane inactive there updates nothing, so one thread a ray
// looping on its own gives each ray the same answer. The JAX kernel's
// block folds (a chunk's least t, then its least id) equal this sequential
// (t, id) fold, and its empty slots (r = 0) never win, so the walk stops
// reading a cell at its first empty slot.
//
// What bounds it on an H100: float work. Every ray tests part A's live
// rows (38 ops each, 6 on smallpt-class scenes) and the slots of each cell
// it visits (26 ops each); procedural_sphere_scene(10000) at occ 16-48
// holds 48-96 slots a cell. chip_smoke.py counts the pairs this run's rays
// test (the plain version walks the same cells) and gives the bound: at
// 196,608 rays some tenths of a millisecond of float work against ~6 MB of
// rays in, results out and the cell table once.
//
// What the design does about it:
// - one thread per ray, its walk state and running folds in registers;
// - part A (128 rows, the five columns it reads, 2.5 KB) is staged in
//   shared memory once per block, every thread reading the same row at once
//   (a broadcast), as K2 stages its table;
// - the cell table (0.5-0.7 MB at 10,000 spheres) stays in global memory
//   and is read through L1/L2 with __ldg (it fits the 50 MB L2 many times;
//   the TPU's bf16x3 one-hot MXU gather becomes this indexed load), a slot
//   as two 16-B loads of one 32-B sector; the overflow rows likewise;
// - float-to-int truncation saturates (__float2int_rz), as XLA's conversion
//   does; built with --fmad=false, so every op rounds as in the JAX kernel
//   and in the plain version (ops/dda.py::closest_hit_dda_plain), and each
//   tested pair exactly as K2 tests it.
// The grid clip keeps its own axis_clip: K3's (stream_dda.cu) returns the
// kept-off-zero direction, which K3 divides by later, where this walk
// multiplies by the reciprocal, as the JAX kernel does.
//
// Interface: a plain C function, loaded with ctypes. It launches on the
// caller's stream, synchronises nothing and returns cudaGetLastError() of
// the launch.

#include "lane.cuh"

namespace {

using namespace smallpt;

constexpr int kBlock = 128;
constexpr int kPartA = 128;  // ops/intersect_pallas.py::MAX_BIG
constexpr int kSlot = 8;     // floats a cell slot or an overflow row
constexpr float kBigId = 3.0e38f;
constexpr float kTiny = 1e-20f;

// integer and float launch arguments (ops/dda.py::_launch_args, same order)
enum { D_N, D_NX, D_NY, D_NZ, D_K, D_F_ROWS, D_COUNT };
enum { DF_LOX, DF_LOY, DF_LOZ, DF_CLX, DF_CLY, DF_CLZ, DF_EPS, DF_COUNT };

struct Grid {
  int n[3];    // cells per axis
  int k;       // slots a cell
  int f_rows;  // overflow rows, padding included
  float lo[3], cl[3];
  float eps;   // the local spheres' root-rejection eps
};

// Fold a candidate (tt, id) into the running (bt, bid) in (t, id) order.
__device__ __forceinline__ void fold_lex(float tt, float id, float& bt,
                                         float& bid) {
  if (tt < kBig && (tt < bt || (tt == bt && id < bid))) {
    bt = tt;
    bid = id;
  }
}

__global__ void __launch_bounds__(kBlock)
    dda_kernel(const float* __restrict__ org, const float* __restrict__ dir,
               const float* __restrict__ part_a,
               const float* __restrict__ overflow,
               const float* __restrict__ cells, float* __restrict__ t_out,
               int* __restrict__ code_out, int n, const Grid g) {
  __shared__ float4 s_row[kPartA];
  __shared__ float s_eps[kPartA];
  for (int k = threadIdx.x; k < kPartA; k += blockDim.x) {
    s_row[k] = __ldg(reinterpret_cast<const float4*>(part_a) + 2 * k);
    s_eps[k] = __ldg(part_a + kSlot * k + 4);
  }
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float o[3] = {org[i], org[n + i], org[2 * n + i]};
  const float d[3] = {dir[i], dir[n + i], dir[2 * n + i]};

  // ---- 1. part A: the stable sweep, strict < keeps the first slot
  float bta = kBig;
  int bia = 0;
  for (int k = 0; k < kPartA; ++k) {
    const float4 c = s_row[k];
    if (!(c.w > 0.0f)) continue;  // radius 0: never hit
    const float tt = sphere_tt(o[0], o[1], o[2], d[0], d[1], d[2], c.x, c.y,
                               c.z, c.w, s_eps[k]);
    if (tt < bta) {
      bta = tt;
      bia = k;
    }
  }

  // ---- 2. the overflow rows, folded on (t, id)
  float btb = kBig, bidb = kBigId;
  const float4* ovf = reinterpret_cast<const float4*>(overflow);
  for (int k = 0; k < g.f_rows; ++k) {
    const float4 c = __ldg(ovf + 2 * k);
    if (!(c.w > 0.0f)) continue;  // padding
    const float4 e = __ldg(ovf + 2 * k + 1);  // eps, id
    fold_lex(sphere_tt_fast(o[0], o[1], o[2], d[0], d[1], d[2], c.x, c.y,
                            c.z, c.w, e.x),
             e.y, btb, bidb);
  }

  // ---- 3. the walk: clip to the grid box, the entry cell, the crossings
  float t0[3], t1[3], inv[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ghi = g.lo[a] + g.cl[a] * (float)g.n[a];
    const float dn = fabsf(d[a]) < kTiny ? (d[a] >= 0.0f ? kTiny : -kTiny)
                                         : d[a];
    inv[a] = 1.0f / dn;
    const float ta = (g.lo[a] - o[a]) * inv[a];
    const float tb = (ghi - o[a]) * inv[a];
    t0[a] = fminf(ta, tb);
    t1[a] = fmaxf(ta, tb);
  }
  const float t_in = fmaxf(fmaxf(t0[0], t0[1]), t0[2]);
  const float t_far = fminf(fminf(t1[0], t1[1]), t1[2]);
  const float enter = fmaxf(t_in, 0.0f);
  bool active = enter <= t_far && t_far > 0.0f;
  int ci[3], stp[3];
  float tm[3], dt[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float p = o[a] + d[a] * enter;
    const float invc = 1.0f / g.cl[a];
    ci[a] = min(max(__float2int_rz((p - g.lo[a]) * invc), 0), g.n[a] - 1);
    const bool fwd = d[a] >= 0.0f;
    stp[a] = fwd ? 1 : -1;
    const float nxt = g.lo[a] + (float)(ci[a] + (fwd ? 1 : 0)) * g.cl[a];
    const bool tiny = fabsf(d[a]) < kTiny;
    tm[a] = tiny ? kBig : (nxt - o[a]) * inv[a];
    dt[a] = tiny ? kBig : g.cl[a] * fabsf(inv[a]);
  }
  const int max_steps = g.n[0] + g.n[1] + g.n[2] + 3;
  const float4* cell4 = reinterpret_cast<const float4*>(cells);
  for (int it = 0; it < max_steps && active; ++it) {
    const size_t base =
        (size_t)((ci[0] * g.n[1] + ci[1]) * g.n[2] + ci[2]) * g.k * 2;
    for (int q = 0; q < g.k; ++q) {
      const float4 e = __ldg(cell4 + base + 2 * q + 1);  // id, 0, 0, 0
      if (!(e.x < kBigId)) break;  // the first empty slot ends the list
      const float4 c = __ldg(cell4 + base + 2 * q);
      fold_lex(sphere_tt_fast(o[0], o[1], o[2], d[0], d[1], d[2], c.x, c.y,
                              c.z, c.w, g.eps),
               e.x, btb, bidb);
    }
    // conservative exit: the best so far lies within the visited prefix
    const float t_exit = fminf(fminf(tm[0], tm[1]), tm[2]);
    const bool done = fminf(bta, btb) <= t_exit;
    // step the axis of least next crossing, ties to x, then y (constant
    // indices keep the arrays in registers)
    if (tm[0] <= tm[1] && tm[0] <= tm[2]) {
      ci[0] += stp[0];
      tm[0] = tm[0] + dt[0];
      active = !done && ci[0] >= 0 && ci[0] < g.n[0];
    } else if (tm[1] <= tm[2]) {
      ci[1] += stp[1];
      tm[1] = tm[1] + dt[1];
      active = !done && ci[1] >= 0 && ci[1] < g.n[1];
    } else {
      ci[2] += stp[2];
      tm[2] = tm[2] + dt[2];
      active = !done && ci[2] >= 0 && ci[2] < g.n[2];
    }
  }

  // ---- 4. part A wins ties; misses encode as 0
  const bool a_wins = bta <= btb;
  const float best = a_wins ? bta : btb;
  t_out[i] = best;
  code_out[i] = best >= kBig ? 0 : (a_wins ? -(bia + 1) : (int)bidb);
}

}  // namespace

// The closest (t, code) of iparams[D_N] rays. org, dir: (3, N) f32 planes;
// part_a: (128, 8), overflow: (F, 8), cells: (C, K, 8) f32 on the device;
// t: (N,) f32 and code: (N,) i32 outputs; iparams: host int32 {N nx ny nz K
// F}; fparams: host f32 {lo(3) cell(3) eps}; stream: a cudaStream_t.
// Returns the launch's cudaGetLastError().
extern "C" int smallpt_dda(const void* org, const void* dir,
                           const void* part_a, const void* overflow,
                           const void* cells, void* t, void* code,
                           const void* iparams, const void* fparams,
                           void* stream) {
  int ip[D_COUNT];
  float fp[DF_COUNT];
  memcpy(ip, iparams, sizeof(ip));
  memcpy(fp, fparams, sizeof(fp));
  const int n = ip[D_N];
  Grid g;
  for (int a = 0; a < 3; ++a) {
    g.n[a] = ip[D_NX + a];
    g.lo[a] = fp[DF_LOX + a];
    g.cl[a] = fp[DF_CLX + a];
    if (g.n[a] < 1) return (int)cudaErrorInvalidValue;
  }
  g.k = ip[D_K];
  g.f_rows = ip[D_F_ROWS];
  g.eps = fp[DF_EPS];
  if (n < 0 || g.k < 1 || g.f_rows < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int grid = (n + kBlock - 1) / kBlock;
  dda_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)org, (const float*)dir, (const float*)part_a,
      (const float*)overflow, (const float*)cells, (float*)t, (int*)code, n,
      g);
  return (int)cudaGetLastError();
}
