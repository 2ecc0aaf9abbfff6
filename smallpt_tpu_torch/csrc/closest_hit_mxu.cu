// Closest-hit sphere kernel for sm_90a with the small spheres' quadratic
// coefficients taken as dot products of table rows with ray features
// (kernel K5).
//
// Replaces: smallpt_tpu/ops/intersect_pallas.py::_intersect_kernel_mxu,
// launched there by _closest_hit_mxu through one pallas_call; entry point
// smallpt_closest_hit_mxu, kernel closest_hit_mxu_kernel.
//
// Contract (ops/intersect_pallas.py::closest_hit_mxu): org (origins in the
// frame recentred at the small spheres' centroid) and dir are (3, N) f32
// planes. Part A, the (rows, 8) f32 stable table [cx cy cz r eps 0 0 0],
// is swept over its first n_a rows in the stable citardauq form
// (lane.cuh::sphere_tt, K2's part A). The small class is the (2 * n_b, 8)
// f32 MXU table: chunk c holds 64 rows of b coefficients [cx cy cz 0 0 0 0
// 0] and then 64 rows of det coefficients [0 0 0 2cx 2cy 2cz -q -1]. With
// the ray's features F = [dx dy dz ox oy oz 1 oo], od = o.d, oo = o.o:
// b = row1.F - od, det = b*b + row2.F, s = sqrtf(det), NaN when det < 0
// (masked rows carry q = 1e30), so both root compares fail and the row is
// a miss; t0 = b - s, t1 = b + s against the one eps. Each ray gets the
// least t (3e38 where nothing is hit) and the first slot holding it (n_a +
// j for small sphere j, 0 on a miss): the JAX kernel's chunk min-loc and
// strict < across chunks are this one sequential strict-< fold.
//
// Each 8-term dot product is summed left to right with its zero terms, and
// the plain version (closest_hit_mxu_plain) sums in the same order; with
// --fmad=false and IEEE sqrtf the two agree bit for bit. The JAX kernel's
// matmul order is XLA's, so across the packages K5 meets only the JAX
// suite's statistical gates (as the JAX kernel does against K2).
//
// What bounds it on an H100: the float work. A (ray, small sphere) pair
// needs the two dots over their non-zero terms (5 and 7 ops), b, det, the
// square root, the two roots and three compares, 21 ops; at 10,000
// spheres and 196,608 rays, with part A's stable tests, that is ~42 G ops,
// 0.63 ms at the 67 TFLOP/s rate. This kernel also sums the zero terms
// (39 ops a pair). The bytes, 24 B of ray in and 8 B out a ray and the
// 643-KB table once, take 0.002 ms. chip_smoke.py computes both bounds
// from the launch's real rows.
//
// What the design does about it:
// - one thread per ray, features, od and the running (t, slot) in
//   registers, as K2;
// - part A (128 rows) is staged once in shared memory and swept with
//   lane.cuh's stable test, rows of radius 0 skipped (a uniform branch,
//   such a row never wins);
// - the MXU table (643 KB at 10,000 spheres, above a block's 227 KB) is
//   staged through shared memory kStage chunks (32 KB) at a time; every
//   thread reads the same row at once, a broadcast, as float4s;
// - FP32 cores only: the tensor-core variant (TF32, or 3xTF32 for f32
//   accuracy) is for a later change, once an A/B against K2 on the same
//   rays says it pays.
//
// Interface: a plain C function, loaded with ctypes. It launches on the
// caller's stream, synchronises nothing and returns cudaGetLastError() of
// the launch.

#include "lane.cuh"

namespace {

using namespace smallpt;

constexpr int kBlock = 128;
constexpr int kMaxA = 128;   // part A rows staged (MAX_BIG)
constexpr int kSph = 64;     // spheres of an MXU-table chunk
constexpr int kStage = 8;    // chunks staged in shared memory at once

// row . F over the 8 features, summed left to right, zero terms included
__device__ __forceinline__ float dot8(const float4 lo, const float4 hi,
                                      const float* f) {
  float p = lo.x * f[0];
  p = p + lo.y * f[1];
  p = p + lo.z * f[2];
  p = p + lo.w * f[3];
  p = p + hi.x * f[4];
  p = p + hi.y * f[5];
  p = p + hi.z * f[6];
  p = p + hi.w * f[7];
  return p;
}

__global__ void __launch_bounds__(kBlock)
    closest_hit_mxu_kernel(const float* __restrict__ org,
                           const float* __restrict__ dir,
                           const float4* __restrict__ stable,
                           const float4* __restrict__ mxu, float* t_out,
                           int* slot_out, int n, int n_a, int n_b,
                           float eps) {
  __shared__ float4 s_a[kMaxA];
  __shared__ float s_a_eps[kMaxA];
  __shared__ float4 s_rows[kStage * 2 * kSph * 2];  // (rows, 8) as float4s
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

  // ---- part A: the stable form over n_a rows
  for (int k = threadIdx.x; k < n_a; k += blockDim.x) {
    s_a[k] = __ldg(stable + 2 * k);
    s_a_eps[k] = __ldg(reinterpret_cast<const float*>(stable) + 8 * k + 4);
  }
  __syncthreads();
  for (int k = 0; k < n_a; ++k) {
    const float4 c = s_a[k];
    if (!(c.w > 0.0f)) continue;  // radius 0: never hit
    const float tt = sphere_tt(ox, oy, oz, dx, dy, dz, c.x, c.y, c.z, c.w,
                               s_a_eps[k]);
    if (tt < bt) {
      bt = tt;
      bi = k;
    }
  }

  // ---- the small class: b and det from the coefficient rows
  const float od = (ox * dx + oy * dy) + oz * dz;
  const float oo = (ox * ox + oy * oy) + oz * oz;
  const float f[8] = {dx, dy, dz, ox, oy, oz, 1.0f, oo};
  const int n_chunks = n_b / kSph;
  for (int c0 = 0; c0 < n_chunks; c0 += kStage) {
    const int nc = min(kStage, n_chunks - c0);
    const int n4 = nc * 2 * kSph * 2;  // float4s of the staged chunks
    __syncthreads();  // the previous stage's readers are done
    const float4* src = mxu + (size_t)c0 * 2 * kSph * 2;
    for (int k = threadIdx.x; k < n4; k += blockDim.x) s_rows[k] = __ldg(src + k);
    __syncthreads();
    for (int c = 0; c < nc; ++c) {
      const float4* r1 = s_rows + c * 2 * kSph * 2;  // 64 b rows
      const float4* r2 = r1 + kSph * 2;              // 64 det rows
      const int base = n_a + (c0 + c) * kSph;
      for (int k = 0; k < kSph; ++k) {
        const float b = dot8(r1[2 * k], r1[2 * k + 1], f) - od;
        const float det = b * b + dot8(r2[2 * k], r2[2 * k + 1], f);
        const float s = sqrtf(det);  // NaN for det < 0: both compares fail
        const float t0 = b - s;
        const float t1 = b + s;
        const float tt = t0 > eps ? t0 : (t1 > eps ? t1 : kBig);
        if (tt < bt) {
          bt = tt;
          bi = base + k;
        }
      }
    }
  }
  if (ray) {
    t_out[i] = bt;
    slot_out[i] = bi;
  }
}

}  // namespace

// The closest (t, slot) of iparams[0] rays. org, dir: (3, N) f32 planes,
// stable: (rows, 8) f32 and mxu: (2 * n_b, 8) f32 on the device; t: (N,)
// f32 and slot: (N,) i32 outputs; iparams: host array {N, n_a, n_b};
// fparams: host array {eps}; stream: a cudaStream_t. Returns the launch's
// cudaGetLastError().
extern "C" int smallpt_closest_hit_mxu(const void* org, const void* dir,
                                       const void* stable, const void* mxu,
                                       void* t, void* slot,
                                       const void* iparams,
                                       const void* fparams, void* stream) {
  int ip[3];
  float eps;
  memcpy(ip, iparams, sizeof(ip));
  memcpy(&eps, fparams, sizeof(eps));
  const int n = ip[0], n_a = ip[1], n_b = ip[2];
  if (n < 0 || n_a < 0 || n_a > kMaxA || n_b < 0 || n_b % kSph)
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int grid = (n + kBlock - 1) / kBlock;
  closest_hit_mxu_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)org, (const float*)dir, (const float4*)stable,
      (const float4*)mxu, (float*)t, (int*)slot, n, n_a, n_b, eps);
  return (int)cudaGetLastError();
}
