// Grid-culled closest-hit triangle kernel for sm_90a (kernel K7): the
// closest (t, tri, u, v) of every ray over the chunks its tile can reach,
// nearest first, with a tile-level early exit.
//
// Replaces: smallpt_tpu/ops/mesh_pallas.py::_mesh_culled_kernel, launched
// there by intersect_mesh_culled through one pallas_call per slab of tiles;
// entry point smallpt_closest_tri_culled, kernel closest_tri_culled_kernel.
//
// Contract (ops/mesh_pallas.py::closest_tri_culled): org and dir are
// (3, N_pad) f32 planes, N_pad a multiple of kTile, rays at or past n_rays
// padding; the table (rows, 16) f32 is the accel's (ops/mesh_accel.py):
// n_glob global chunks of kChunkRows rows, then n_chunks local ones, rows
// [v0(3) e1(3) e2(3) n(3) valid id 0 0] with column 13 the ORIGINAL
// triangle id. Per tile t of kTile rays: stops[t] (signed walk count,
// negative when the reach set overflowed the list), lists[t, :l_max]
// (local chunk ids nearest-first) and dlo[t, :l_max] (a lower bound on the
// distance to every chunk at that slot or later, non-decreasing). The block
// sweeps, in this order:
//   1. every global chunk;
//   2. the listed chunks j = 0, 1, ... < |stops[t]|, chunk
//      n_glob + lists[t, j]; after each, it stops once every VALID lane's
//      best t is strictly below dlo[t, j + 1];
//   3. only when stops[t] < 0 and some valid lane's best t is at or above
//      dlo[t, |stops[t]| - 1]: every local chunk in ascending order.
// Per (ray, row) the test is K6's (tri.cuh::tri_candidate). The fold keeps
// the lexicographic least (t, original id) over the candidates it sweeps:
// the winner does not depend on the sweep order and equals K6's first
// least row (K6's table is in original id order). A lane with no
// candidate below 3e38 returns K6's miss outputs: t 3e38, tri 0, u 0, v 0
// (the JAX kernel returns some swept row's id and u, v there, which no
// caller reads; ROADMAP.md hazard H6).
//
// What bounds it on an H100: the float work of the pairs it sweeps, ~49
// ops a (ray, live row) pair as K6 (chip_smoke.py counts the pairs this
// run's lists make the block sweep, from the plain version's count of
// chunks per tile); the bytes (rays in and out, the lists and the table
// once) are far below. The early exit is tile-wide, so a tile sweeps for
// its slowest lane.
//
// What the design does about it:
// - one block of kTile = 1,024 threads per tile, one ray a thread, its
//   running (t, id, u, v) in registers: the layout of K6 and of the JAX
//   tile, so the list, the exit and the fallback are per block and the
//   loop control is uniform over it. __launch_bounds__(1024) caps a thread
//   at 64 registers (ptxas's count is in chip_smoke.py's output);
// - each chunk (16 rows x 64 B = 1 KB) is staged in shared memory by 64
//   threads and read by every thread at once, a broadcast;
// - the exit test is one __syncthreads_or vote of the valid lanes;
// - lists, dlo and stops are read from global memory: no slabbing of the
//   tile axis (the JAX launcher slabs it for the TPU's scalar memory);
// - padding rows (valid 0) are skipped with a branch uniform over the
//   block;
// - built with --fmad=false, so each op rounds as in the JAX kernel and in
//   the plain version (ops/mesh_pallas.py::closest_tri_culled_plain).
// Not done yet (later perf work): cp.async/TMA double buffering of the
// chunks, several chunks a stage.
//
// Interface: a plain C function, loaded with ctypes. It launches on the
// caller's stream, synchronises nothing and returns cudaGetLastError() of
// the launch.

#include "tri.cuh"

namespace {

using namespace smallpt;

constexpr int kTile = 1024;     // rays a tile (mesh_accel.RAY_TILE)
constexpr int kChunkRows = 16;  // rows a chunk (mesh_accel.CHUNK_T)
constexpr float kBigId = 3.0e38f;

struct Best {
  float t, id, u, v;
};

// Stage chunk `cid` in shared memory and fold its rows into `b`.
__device__ __forceinline__ void sweep_chunk(const float4* __restrict__ rows,
                                            float4* s_row, int cid, float ox,
                                            float oy, float oz, float dx,
                                            float dy, float dz, float eps,
                                            Best& b) {
  __syncthreads();  // the previous chunk's readers are done
  if (threadIdx.x < 4 * kChunkRows)
    s_row[threadIdx.x] = __ldg(rows + 4 * kChunkRows * cid + threadIdx.x);
  __syncthreads();
#pragma unroll 4
  for (int k = 0; k < kChunkRows; ++k) {
    const TriRow r = load_tri_row(s_row, k);
    if (!(r.d.x > 0.5f)) continue;  // padding: never a candidate
    float t, u, v;
    if (tri_candidate(ox, oy, oz, dx, dy, dz, r, eps, t, u, v) &&
        (t < b.t || (t == b.t && r.d.y < b.id))) {
      b = Best{t, r.d.y, u, v};
    }
  }
}

__global__ void __launch_bounds__(kTile)
    closest_tri_culled_kernel(const float* __restrict__ org,
                              const float* __restrict__ dir,
                              const float4* __restrict__ rows,
                              const int* __restrict__ stops,
                              const int* __restrict__ lists,
                              const float* __restrict__ dlo, float* t_out,
                              int* tri_out, float* u_out, float* v_out,
                              int n_pad, int n_rays, int n_glob, int n_chunks,
                              int l_max, float eps) {
  __shared__ float4 s_row[4 * kChunkRows];
  const int tile = blockIdx.x;
  const int i = tile * kTile + threadIdx.x;
  const bool valid = i < n_rays;
  const float ox = org[i], oy = org[n_pad + i], oz = org[2 * n_pad + i];
  const float dx = dir[i], dy = dir[n_pad + i], dz = dir[2 * n_pad + i];
  Best b{kBig, kBigId, 0.0f, 0.0f};

  for (int c = 0; c < n_glob; ++c)
    sweep_chunk(rows, s_row, c, ox, oy, oz, dx, dy, dz, eps, b);

  const int stop = stops[tile];
  const int walk = stop < 0 ? -stop : stop;
  const int* list = lists + (size_t)tile * l_max;
  const float* bound = dlo + (size_t)tile * l_max;
  for (int j = 0; j < walk; ++j) {
    sweep_chunk(rows, s_row, n_glob + list[j], ox, oy, oz, dx, dy, dz, eps,
                b);
    if (j + 1 >= walk) break;
    // exit once every valid lane's best t is strictly below the bound on
    // all remaining chunks (strict: an equal-t hit could win on its id)
    if (!__syncthreads_or(valid && b.t >= bound[j + 1])) break;
  }
  // overflow: the unlisted chunks are the farthest tail, bounded by the
  // last listed slot's bound; sweep everything ascending if a lane reaches
  // it (re-sweeping a listed chunk leaves the fold unchanged)
  if (stop < 0 &&
      __syncthreads_or(valid && b.t >= bound[walk > 0 ? walk - 1 : 0])) {
    for (int c = 0; c < n_chunks; ++c)
      sweep_chunk(rows, s_row, n_glob + c, ox, oy, oz, dx, dy, dz, eps, b);
  }
  if (valid) {
    const bool hit = b.t < kBig;
    t_out[i] = hit ? b.t : kBig;
    tri_out[i] = hit ? (int)b.id : 0;
    u_out[i] = hit ? b.u : 0.0f;
    v_out[i] = hit ? b.v : 0.0f;
  }
}

}  // namespace

// The culled closest (t, tri, u, v) of the iparams[1] = n_rays rays of
// (3, iparams[0] = N_pad) f32 planes org and dir, over the accel table with
// iparams[2] = n_glob global and iparams[3] = n_chunks local chunks, the
// tiles' stops (T,) i32, lists (T, iparams[4] = l_max) i32 and dlo
// (T, l_max) f32, rejecting t <= fparams[0]. t, u, v: (n_rays,) f32 and
// tri: (n_rays,) i32 outputs; stream: a cudaStream_t. Returns the launch's
// cudaGetLastError().
extern "C" int smallpt_closest_tri_culled(
    const void* org, const void* dir, const void* table, const void* stops,
    const void* lists, const void* dlo, void* t, void* tri, void* u, void* v,
    const void* iparams, const void* fparams, void* stream) {
  int ip[5];
  float fp[1];
  memcpy(ip, iparams, sizeof(ip));
  memcpy(fp, fparams, sizeof(fp));
  const int n_pad = ip[0], n_rays = ip[1], n_glob = ip[2], n_chunks = ip[3],
            l_max = ip[4];
  if (n_pad < 0 || n_pad % kTile || n_rays < 0 || n_rays > n_pad ||
      n_glob < 0 || n_chunks < 0 || l_max < 1)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  closest_tri_culled_kernel<<<n_pad / kTile, kTile, 0,
                              (cudaStream_t)stream>>>(
      (const float*)org, (const float*)dir, (const float4*)table,
      (const int*)stops, (const int*)lists, (const float*)dlo, (float*)t,
      (int*)tri, (float*)u, (float*)v, n_pad, n_rays, n_glob, n_chunks,
      l_max, fp[0]);
  return (int)cudaGetLastError();
}
