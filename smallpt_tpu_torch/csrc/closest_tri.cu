// Closest-hit triangle kernel for sm_90a (kernel K6): the brute closest
// (t, tri, u, v) of every ray over a triangle table.
//
// Replaces: smallpt_tpu/ops/mesh_pallas.py::_mesh_kernel, launched there by
// _closest_tri through one pallas_call; entry point smallpt_closest_tri,
// kernel closest_tri_kernel.
//
// Contract (ops/mesh_pallas.py::closest_tri): org and dir are (3, N) f32
// planes, the table (rows, 16) f32 rows [v0(3) e1(3) e2(3) n(3) valid 0 0
// 0] with n = cross(e1, e2). Per (ray, row), op for op the JAX kernel's
// formulation (iq's triIntersect, scene.cpp:52-70; tri.cuh::tri_candidate,
// shared with K7):
//   rov0 = o - v0;  q = cross(rov0, d);  dn = dot(d, n)
//   inv = 1 / (dn == 0 ? 1 : dn)
//   u = -dot(q, e2) * inv;  v = dot(q, e1) * inv;  t = -dot(n, rov0) * inv
//   a candidate iff 0 <= u <= 1, 0 <= v, u + v <= 1, valid, dn != 0, t > eps.
// Each ray gets the least t (3e38 where nothing is hit), the first row
// holding it (0 on a miss) and that row's u and v (0 on a miss): the JAX
// kernel's chunk min-loc with a strict < across chunks, which is one
// sequential strict-< fold over the rows in table order.
//
// What bounds it on an H100: the float work, ~30 ops a (ray, triangle)
// pair and one division. A FLAT bounce of procedural_mesh_scene(500) (32,014
// triangles) at 256x192, 4 spp, is 196,608 rays x 32,014 rows, ~189 G ops,
// 2.8 ms at the 67 TFLOP/s rate (5.6 ms at the no-FMA rate this build
// retires at); its bytes (28 B a ray in and out, the 2.05 MB table once)
// take ~2 us. chip_smoke.py computes both bounds from the launch's shapes.
//
// What the design does about it:
// - one thread per ray, its running (t, tri, u, v) in registers; each block
//   stages the table through shared memory in chunks of kChunk rows (32 KB
//   of the 13 floats a row holds, as four float4s), so the 2.05 MB table of
//   32k triangles streams through without an opt-in; every thread reads
//   the same row at once, a shared-memory broadcast;
// - padding rows (valid 0) are skipped with a branch that is uniform over
//   the block: such a row is never a candidate, so the fold is unchanged;
// - the ray planes are read coalesced, the results written once;
// - built with --fmad=false, so each op rounds as in the JAX kernel and in
//   the plain version (ops/mesh_pallas.py::closest_tri_plain).
//
// Interface: a plain C function, loaded with ctypes. It launches on the
// caller's stream, synchronises nothing and returns cudaGetLastError() of
// the launch.

#include "tri.cuh"

namespace {

using namespace smallpt;

constexpr int kBlock = 128;
constexpr int kChunk = 512;  // table rows staged in shared memory at once

__global__ void __launch_bounds__(kBlock)
    closest_tri_kernel(const float* __restrict__ org,
                       const float* __restrict__ dir,
                       const float4* __restrict__ rows, float* t_out,
                       int* tri_out, float* u_out, float* v_out, int n,
                       int n_rows, float eps) {
  __shared__ float4 s_row[4 * kChunk];
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool ray = i < n;
  // a thread past the last ray still stages rows; it traces a finite dummy
  const float ox = ray ? org[i] : 0.0f;
  const float oy = ray ? org[n + i] : 0.0f;
  const float oz = ray ? org[2 * n + i] : 0.0f;
  const float dx = ray ? dir[i] : 1.0f;
  const float dy = ray ? dir[n + i] : 0.0f;
  const float dz = ray ? dir[2 * n + i] : 0.0f;
  float bt = kBig, bu = 0.0f, bv = 0.0f;
  int bi = 0;
  for (int base = 0; base < n_rows; base += kChunk) {
    const int m = min(kChunk, n_rows - base);
    __syncthreads();  // the previous chunk's readers are done
    for (int k = threadIdx.x; k < 4 * m; k += blockDim.x)
      s_row[k] = __ldg(rows + 4 * base + k);
    __syncthreads();
    for (int k = 0; k < m; ++k) {
      const TriRow r = load_tri_row(s_row, k);
      if (!(r.d.x > 0.5f)) continue;  // padding: never a candidate
      float t, u, v;
      if (tri_candidate(ox, oy, oz, dx, dy, dz, r, eps, t, u, v) && t < bt) {
        bt = t;
        bi = base + k;
        bu = u;
        bv = v;
      }
    }
  }
  if (ray) {
    t_out[i] = bt;
    tri_out[i] = bi;
    u_out[i] = bu;
    v_out[i] = bv;
  }
}

}  // namespace

// The closest (t, tri, u, v) of iparams[0] rays over the first iparams[1]
// table rows, rejecting t <= fparams[0]. org, dir: (3, N) f32 planes and
// table: (rows, 16) f32 on the device; t, u, v: (N,) f32 and tri: (N,) i32
// outputs; stream: a cudaStream_t. Returns the launch's cudaGetLastError().
extern "C" int smallpt_closest_tri(const void* org, const void* dir,
                                   const void* table, void* t, void* tri,
                                   void* u, void* v, const void* iparams,
                                   const void* fparams, void* stream) {
  int ip[2];
  float fp[1];
  memcpy(ip, iparams, sizeof(ip));
  memcpy(fp, fparams, sizeof(fp));
  const int n = ip[0], n_rows = ip[1];
  if (n < 0 || n_rows < 0) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  const int grid = (n + kBlock - 1) / kBlock;
  closest_tri_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(
      (const float*)org, (const float*)dir, (const float4*)table, (float*)t,
      (int*)tri, (float*)u, (float*)v, n, n_rows, fp[0]);
  return (int)cudaGetLastError();
}
