// Closest-hit sphere kernel for sm_90a (kernel K2): the brute closest
// (t, slot) of every ray over a two-part sphere table.
//
// Replaces: smallpt_tpu/ops/intersect_pallas.py::_intersect_kernel, launched
// there by _closest_hit through one pallas_call; entry point
// smallpt_closest_hit, kernel closest_hit_kernel.
//
// Contract (ops/intersect_pallas.py::closest_hit): org and dir are (3, N) f32
// planes, the table (rows, 8) f32 rows [cx cy cz r eps 0 0 0]. Rows
// [0, n_a) are swept in the stable citardauq form (lane.cuh::sphere_tt, op
// for op the JAX kernel's stable_body), rows [n_a, n_a + n_b) in the direct
// quadratic (lane.cuh::sphere_tt_fast, its fast_body). Each ray gets the
// least t (3e38 where nothing is hit) and the first slot holding it (0 on a
// miss). The JAX kernel's chunk min-loc (the first row of a chunk attaining
// the chunk's least t) followed by a strict < across chunks is this one
// sequential strict-< fold over the slots in table order.
//
// What bounds it on an H100: at the Cornell box (11 live rows, 786,432
// rays) the bytes, 24 B of ray in and 8 B of result out per ray, ~25 MB a
// launch, 7.5 us at 3.35 TB/s, against ~4.6 us of float work; at 10,000
// spheres the float work, 25-38 ops a (ray, sphere) pair (a square root
// counted as one op): ~50 G ops a 196,608-ray launch, 0.75 ms at the 67
// TFLOP/s rate (1.5 ms at the no-FMA rate this build retires at).
// chip_smoke.py computes both bounds from the launch's real shapes.
//
// What the design does about it:
// - one thread per ray, its running (t, slot) in registers; each block
//   stages the table through shared memory in chunks of kChunk rows (the
//   five columns it reads, 20 KB), so a 10,000-sphere table (324 KB, above
//   the 227 KB a block may hold) needs no opt-in and no second instance;
//   every thread reads the same row at once, a shared-memory broadcast;
// - rows of radius 0 (part A's padding, part B's zeroed big spheres and
//   padding) are skipped with a branch that is uniform over the block: such
//   a row is never hit, so the fold is unchanged (the megakernel sweeps
//   only the scene's rows, not the padding, on the same argument);
// - the ray planes are read coalesced (plane-major, as the JAX kernel's
//   (3, N) layout), the results written once;
// - built with --fmad=false, so each op rounds as in the JAX kernel and in
//   the plain version (ops/intersect_pallas.py::closest_hit_plain).
//
// Interface: a plain C function, loaded with ctypes. It launches on the
// caller's stream, synchronises nothing and returns cudaGetLastError() of
// the launch.

#include "lane.cuh"

namespace {

using namespace smallpt;

constexpr int kBlock = 128;
constexpr int kChunk = 1024;  // table rows staged in shared memory at once

// Fold rows [lo, hi) of the table into the ray's running (bt, bi), the
// stable form for kStable and the direct quadratic otherwise. Every thread
// of the block calls it (it synchronises the block).
template <bool kStable>
__device__ __forceinline__ void sweep(const float4* __restrict__ rows,
                                      int lo, int hi, float4* s_row,
                                      float* s_eps, float ox, float oy,
                                      float oz, float dx, float dy, float dz,
                                      float& bt, int& bi) {
  for (int base = lo; base < hi; base += kChunk) {
    const int n = min(kChunk, hi - base);
    __syncthreads();  // the previous chunk's readers are done
    for (int k = threadIdx.x; k < n; k += blockDim.x) {
      s_row[k] = __ldg(rows + 2 * (base + k));
      s_eps[k] = __ldg(reinterpret_cast<const float*>(rows) +
                       8 * (base + k) + 4);
    }
    __syncthreads();
    for (int k = 0; k < n; ++k) {
      const float4 c = s_row[k];
      if (!(c.w > 0.0f)) continue;  // radius 0: never hit
      const float tt =
          kStable ? sphere_tt(ox, oy, oz, dx, dy, dz, c.x, c.y, c.z, c.w,
                              s_eps[k])
                  : sphere_tt_fast(ox, oy, oz, dx, dy, dz, c.x, c.y, c.z,
                                   c.w, s_eps[k]);
      if (tt < bt) {
        bt = tt;
        bi = base + k;
      }
    }
  }
}

__global__ void __launch_bounds__(kBlock)
    closest_hit_kernel(const float* __restrict__ org,
                       const float* __restrict__ dir,
                       const float4* __restrict__ rows, float* t_out,
                       int* slot_out, int n, int n_a, int n_b) {
  __shared__ float4 s_row[kChunk];
  __shared__ float s_eps[kChunk];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool ray = i < n;
  // a thread past the last ray still stages rows; it traces a finite dummy
  const float ox = ray ? org[i] : 0.0f;
  const float oy = ray ? org[n + i] : 0.0f;
  const float oz = ray ? org[2 * n + i] : 0.0f;
  const float dx = ray ? dir[i] : 1.0f;
  const float dy = ray ? dir[n + i] : 0.0f;
  const float dz = ray ? dir[2 * n + i] : 0.0f;
  float bt = kBig;
  int bi = 0;
  sweep<true>(rows, 0, n_a, s_row, s_eps, ox, oy, oz, dx, dy, dz, bt, bi);
  sweep<false>(rows, n_a, n_a + n_b, s_row, s_eps, ox, oy, oz, dx, dy, dz,
               bt, bi);
  if (ray) {
    t_out[i] = bt;
    slot_out[i] = bi;
  }
}

}  // namespace

// The closest (t, slot) of iparams[0] rays. org, dir: (3, N) f32 planes and
// table: (rows, 8) f32 on the device; t: (N,) f32 and slot: (N,) i32
// outputs; iparams: host array {N, n_a, n_b}; stream: a cudaStream_t.
// Returns the launch's cudaGetLastError().
extern "C" int smallpt_closest_hit(const void* org, const void* dir,
                                   const void* table, void* t, void* slot,
                                   const void* iparams, void* stream) {
  int ip[3];
  memcpy(ip, iparams, sizeof(ip));
  const int n = ip[0], n_a = ip[1], n_b = ip[2];
  if (n < 0 || n_a < 0 || n_b < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int grid = (n + kBlock - 1) / kBlock;
  closest_hit_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)org, (const float*)dir, (const float4*)table, (float*)t,
      (int*)slot, n, n_a, n_b);
  return (int)cudaGetLastError();
}
