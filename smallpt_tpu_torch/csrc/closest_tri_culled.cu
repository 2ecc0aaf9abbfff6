// Grid-culled closest-hit triangle kernel for sm_90a (kernel K7): the
// closest (t, tri, u, v) of every ray over the chunks its tile can reach,
// nearest first, each warp's rays tested against the chunk boxes.
//
// Replaces: smallpt_tpu/ops/mesh_pallas.py::_mesh_culled_kernel, launched
// there by intersect_mesh_culled through one pallas_call per slab of tiles;
// entry point smallpt_closest_tri_culled, kernel closest_tri_culled_kernel.
//
// Contract (ops/mesh_pallas.py::closest_tri_culled): org and dir are (3,
// N_pad) f32 planes, N_pad a multiple of kTile, rays at or past n_rays
// padding; the table (rows, 16) f32 is the accel's (ops/mesh_accel.py):
// n_glob global chunks of kChunkRows rows, then n_chunks local ones, rows
// [v0(3) e1(3) e2(3) n(3) valid id 0 0] with column 13 the ORIGINAL
// triangle id; boxes (n_glob + n_chunks, 8) f32 and slivers (n_slivers,)
// i32 are ops/mesh_pallas.py::chunk_boxes of the table: a row a chunk,
// [c(3) w0 h(3) live], a box [c - h, c + h] that holds v0, v0 + e1 and
// v0 + e2 of the chunk's valid rows, w0 = kBoxRel * |h|_1, and the
// chunk's live rows (valid, n not 0) but its slivers as a 16-bit mask in
// the float's bits; slivers, the table rows of the live rows whose
// triangle is degenerate to rounding (|n| < 2^-7 |e1| |e2|); cones
// (n_cones, 4) f32 and cone_rows (n_cones + 1 + R,) i32 are
// ops/mesh_pallas.py::graze_cones: the local chunks' live rows but the
// slivers grouped by their unit normal, a cone [a s] (a the rows' mean
// unit normal, s >= rho + 2^-10 / min sin(phi) + 2^-20, rho the largest
// distance from a to a row's unit normal), the offsets of each cone's
// rows, then their table rows. Per tile t of kTile rays: stops[t] (signed walk
// count, negative when the reach set overflowed the list), lists[t,
// :l_max] (local chunk ids nearest-first) and dlo[t, :l_max] (a lower
// bound on the distance to every chunk at that slot or later,
// non-decreasing). The result is the JAX kernel's: per ray the
// lexicographic least (t, original id) of K6's test (tri.cuh::
// tri_candidate) over the global chunks and the tile's reachable chunks,
// which equals K6's first least row (K6's table is in original id order).
// A lane with no candidate below 3e38 returns K6's miss outputs: t 3e38,
// tri 0, u 0, v 0 (the JAX kernel returns some swept row's id and u, v
// there, which no caller reads; ROADMAP.md hazard H6).
//
// The sweep: a group is 32 consecutive rays of one tile, a warp, a ray a
// lane. A group folds, in this order:
//   1. every global chunk, and every sliver row;
//   2. for each valid lane, the rows of every cone its ray grazes (|d . a|
//      < s |d|, graze_cones), swept by the whole warp for that lane;
//   3. the listed chunks j = 0, 1, ... < |stops[t]|, chunk n_glob +
//      lists[t, j], nearest first;
//   4. only when stops[t] < 0 and some valid lane's best t is at or above
//      dlo[t, |stops[t]| - 1]: every local chunk in ascending order (the
//      unlisted chunks are the farthest tail, bounded by the last slot's
//      bound, strictly: an equal-t hit could win on its id; a chunk swept
//      twice leaves the fold unchanged).
// In 3 and 4 each lane first tests its ray against the chunk's box
// (box_keep), and the group sweeps the chunk's live rows if some valid
// lane may hold a candidate there. The fold keeps the lexicographic least
// (t, id) of what it tests, so the winner does not depend on the order, on
// which groups sweep a chunk or on a row tested twice.
//
// Why no winner is dropped. Let a candidate of a live row have t at or
// below the lane's best. If the row is a sliver or in a global chunk,
// every ray sweeps it. If the lane's ray grazes the row's cone, step 2
// tests it. Otherwise, with cos the angle between d and n and phi the
// triangle's angle between e1 and e2, |cos| >= |d . a| / |d| - rho >= s -
// 2^-20 - rho (the 2^-20 above the test's f32 rounding) >= 2^-10 /
// sin(phi): |cos| * sin(phi) >= 2^-10, and the box keeps its chunk. The
// candidate has u, v inside the barycentric bounds, so q = v0 + u e1 + v
// e2 lies in the row's triangle, which the box holds; its computed t
// places the ray
// at p = o + t d, and in exact arithmetic over the computed numerators and
// denominator (inv = 1 / dn, t = -dot(n, rov0) * inv, u and v likewise),
// p - q = rov0 * (dn_c - dn) / dn_c - M e / dn_c, with dn_c the computed
// dn, M = [e1 e2 -d] and e the numerators' rounding. Counted term by term
// (the rounding of rov0, q, the three dot products, dn and n against e1 x
// e2), |p - q| <= 20 * 2^-24 * |rov0| / (|cos| * sin(phi)), at most
// 20 * 2^-14 = 0.0012 of |rov0| here. The test widens the box on every
// side by w = kBoxRel * |c - o|_1 + w0 >= kBoxRel * |rov0| (|rov0| <=
// |c - o|_1 + |h|_1), 0.0039 of |rov0|: more than twice that, and the
// rest of w absorbs the test's own rounding (c - o, the slab products: a
// few 2^-24 of |t|). So p lies in the widened box, the ray enters it at
// or before t and leaves it at or after t: enter <= t <= best and leave
// >= t > eps keep the chunk. Below 2^-10 the count gives no bound: where
// dn is rounding, a row's computed t, u and v are ratios of rounding
// errors, and rays that lie in a triangle's plane with their origin on it
// have candidates away from its box (tests/test_torch_tri_cull.py finds
// such winners that the box alone drops, at |cos| <= 1e-6; no finite
// widening covers every one). A sliver's candidates are not tied to its
// position at any angle: where e1 == e2, as on every sliver of these
// meshes (a ball's pole triangles, v1 == v2, whose n is the cross
// product's rounding residue), u = -v, so a candidate has u = v = 0 and
// lies where the ray meets the sliver's whole line, wherever that is.
// Directions with a zero component give i = +-inf and, where the origin
// lies on a widened face, 0 * inf = NaN: the slab products, their max and
// min (min.NaN / max.NaN) and so enter and leave are then NaN, and every
// comparison that drops a chunk is false on a NaN: a NaN keeps the chunk.
// Rays with NaN or inf components reach NaN the same way or hold no
// candidate below 3e38 (tests/test_torch_tri_cull.py holds the plain cull,
// ops/mesh_pallas.py::box_test with cone_test, to never drop a candidate
// at or below the lane's winner on such rays, grazing ones, axis-parallel
// ones, origins on box faces and inside boxes, and random, coherent and
// surface rays, and every row a ray grazes to lie in a cone it grazes).
//
// What bounds it on an H100: the float work. For each ray |d| (6 ops), a
// cone test (7 ops) a cone and a box test (32 ops, box_keep) over the
// slots it walks; K6's staged test (9, 19 or 46 ops as dn, t or the whole
// test decides the pair) on the live rows of the global chunks, of the
// slivers, of the cones it grazes and of the chunks whose box it enters
// before its final t; a group sweeps the union of its lanes' chunks
// (chip_smoke.py::k7_bound counts both, and beside them the tile-wide
// walk's work the kernel did before). The bytes (rays in and out, the
// lists, the box and cone tables and the table once) are far below.
//
// What the design does about it:
// - a group of 32 rays (one warp) is the unit, not a 1,024-ray tile, and
//   the groups fill the card: one launch of blocks of kWarps warps, a warp
//   a group (6,144 groups on a 196,608-ray launch, 1,536 on a 49,152-lane
//   one); a block's groups lie in one tile and share its list in L1; the
//   votes are warp ballots, and the only synchronisation is __syncwarp
//   around the warp's staging;
// - the box cull: each lane tests its ray against a listed chunk's box
//   before the group sweeps it (box_keep); a chunk whose box no valid lane
//   enters before its best t is not swept. With it, the walk takes no
//   early exit: a
//   group-wide vote after each slot on the tile's dlo (the old kernel's
//   exit, per group) and a queue of groups on a persistent grid were
//   built, measured and lost (PERF.md, PR 20), as did two rays a lane,
//   reading the boxes from global memory a slot at a time, and testing
//   the grazing of every row of every walked chunk (3.5 times slower);
// - the cones: a lane whose ray grazes a cone (a few in a hundred rays on
//   the meshes' repeated balls, whose copies share their normals) hands
//   the cone's rows to its whole warp, 32 rows at a time, and the warp's
//   least (t, id) of them comes back to it by a butterfly of shuffles;
// - the walk stages 32 slots at a time: each lane loads one slot's chunk
//   id and its box into the warp's shared memory, and the slots are then
//   read as broadcasts;
// - a swept chunk (16 rows x 64 B) is staged by the warp in its shared
//   memory (two float4 a lane) and only its live rows are swept, from the
//   box table's mask (padding, valid 0, and degenerate rows, n = 0, where
//   dn is 0 or NaN for every ray, are never candidates; K6 leaves them
//   out too); the loop over them is uniform over the warp; the slivers
//   are gathered 16 rows at a time the same way;
// - built with --fmad=false, so each op rounds as in the JAX kernel and in
//   the plain version (ops/mesh_pallas.py::closest_tri_culled_plain, which
//   sweeps group by group, a window of slots at a time).
//
// Interface: a plain C function, loaded with ctypes. It launches on the
// caller's stream, synchronises nothing and returns cudaGetLastError() of
// the launch.

#include "tri.cuh"

namespace {

using namespace smallpt;

constexpr int kTile = 1024;         // rays a tile (mesh_accel.RAY_TILE)
constexpr int kChunkRows = 16;      // rows a chunk (mesh_accel.CHUNK_T)
constexpr int kWarps = 4;           // warps a block
constexpr float kBoxRel = 0.00390625f;  // 2^-8, mesh_pallas.BOX_REL
constexpr float kBigId = 3.0e38f;
constexpr unsigned kAll = 0xffffffffu;

struct Best {
  float t, id, u, v;
};

// A warp's shared memory: the chunk it sweeps and a window of 32 slots
// (chunk id and box).
struct Stage {
  float4 row[4 * kChunkRows];
  float4 box[32][2];
  int cid[32];
};

// The group's ray on this lane.
struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float ix, iy, iz;  // 1 / d
  float len;         // |d|
  bool valid;
  Best b;
};

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// Whether the ray must sweep the chunk of box (lo: c, w0; hi: h, live),
// op for op ops/mesh_pallas.py::box_test: the box widened by w = kBoxRel
// * |c - o|_1 + w0 on every side, the ray inside it for t in [enter,
// leave], the chunk kept unless enter > leave, enter > best or leave <
// eps (false on a NaN): 32 ops (OPS_K7_BOX in chip_smoke.py).
__device__ __forceinline__ bool box_keep(const Ray& r, float4 lo, float4 hi,
                                         float eps) {
  const float cox = lo.x - r.ox;
  const float coy = lo.y - r.oy;
  const float coz = lo.z - r.oz;
  const float w = (fabsf(cox) + fabsf(coy) + fabsf(coz)) * kBoxRel + lo.w;
  const float sx = copysignf(hi.x + w, r.ix);
  const float sy = copysignf(hi.y + w, r.iy);
  const float sz = copysignf(hi.z + w, r.iz);
  const float enter = max_nan(max_nan((cox - sx) * r.ix, (coy - sy) * r.iy),
                              (coz - sz) * r.iz);
  const float leave = min_nan(min_nan((cox + sx) * r.ix, (coy + sy) * r.iy),
                              (coz + sz) * r.iz);
  return !(enter > leave || enter > r.b.t || leave < eps);
}

// Whether (t, id) comes before best in the fold's order.
__device__ __forceinline__ bool before(float t, float id, const Best& b) {
  return t < b.t || (t == b.t && id < b.id);
}

// Test a table row for the ray (o, d) into best.
__device__ __forceinline__ void fold_row(float ox, float oy, float oz,
                                         float dx, float dy, float dz,
                                         const TriRow& row, float eps,
                                         Best& b) {
  float t, u, v;
  if (tri_candidate(ox, oy, oz, dx, dy, dz, row, eps, t, u, v) &&
      before(t, row.d.y, b))
    b = Best{t, row.d.y, u, v};
}

// Fold the staged rows whose bits are set in live into the lane's ray.
__device__ __forceinline__ void fold_staged(const Stage& s, unsigned live,
                                            float eps, Ray& r) {
  while (live) {
    const int k = __ffs(live) - 1;
    live &= live - 1;
    fold_row(r.ox, r.oy, r.oz, r.dx, r.dy, r.dz, load_tri_row(s.row, k), eps,
             r.b);
  }
}

// Stage chunk cid in the warp's shared memory and fold its live rows (the
// bits of live) into the lanes' rays.
__device__ __forceinline__ void sweep_chunk(const float4* __restrict__ rows,
                                            Stage& s, int cid, unsigned live,
                                            int lane, float eps, Ray& r) {
  __syncwarp();  // the previous chunk's readers are done
  const float4* src = rows + 4 * kChunkRows * (size_t)cid;
  s.row[lane] = __ldg(src + lane);
  s.row[lane + 32] = __ldg(src + lane + 32);
  __syncwarp();
  fold_staged(s, live, eps, r);
}

// Fold the sliver rows (their table rows in slivers[0, n)), kChunkRows at a
// time, into the lanes' rays: lane l stages a quarter (l & 3) of rows l / 4
// and 8 + l / 4 of each batch.
__device__ __forceinline__ void sweep_slivers(
    const float4* __restrict__ rows, const int* __restrict__ slivers, int n,
    Stage& s, int lane, float eps, Ray& r) {
  for (int k0 = 0; k0 < n; k0 += kChunkRows) {
    __syncwarp();  // the previous batch's readers are done
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + 8 * h + (lane >> 2);
      if (k < n)
        s.row[32 * h + lane] =
            __ldg(rows + 4 * (size_t)__ldg(slivers + k) + (lane & 3));
    }
    __syncwarp();
    const int m = min(kChunkRows, n - k0);
    fold_staged(s, (1u << m) - 1u, eps, r);
  }
}

// Step 2: for each cone (cones[c] = a, s; its rows cone_rows[n_cones + 1
// + cone_rows[c] ...]) and each valid lane whose ray grazes it (|d . a| <
// s |d|, op for op ops/mesh_pallas.py::cone_test), the warp sweeps the
// cone's rows for that lane, lane k taking rows k, k + 32, ..., and the
// lexicographic least (t, id) of the warp comes back to the lane.
__device__ __forceinline__ void sweep_cones(const float4* __restrict__ rows,
                                            const float4* __restrict__ cones,
                                            const int* __restrict__ cone_rows,
                                            int n_cones, int lane, float eps,
                                            Ray& r) {
  const int* list = cone_rows + n_cones + 1;
  for (int c = 0; c < n_cones; ++c) {
    const float4 a = __ldg(cones + c);
    const bool grazes =
        r.valid && fabsf(r.dx * a.x + r.dy * a.y + r.dz * a.z) < a.w * r.len;
    unsigned mask = __ballot_sync(kAll, grazes);
    if (!mask) continue;
    const int j0 = __ldg(cone_rows + c), j1 = __ldg(cone_rows + c + 1);
    while (mask) {
      const int l = __ffs(mask) - 1;
      mask &= mask - 1;
      const float ox = __shfl_sync(kAll, r.ox, l);
      const float oy = __shfl_sync(kAll, r.oy, l);
      const float oz = __shfl_sync(kAll, r.oz, l);
      const float dx = __shfl_sync(kAll, r.dx, l);
      const float dy = __shfl_sync(kAll, r.dy, l);
      const float dz = __shfl_sync(kAll, r.dz, l);
      Best b{kBig, kBigId, 0.0f, 0.0f};
      for (int j = j0 + lane; j < j1; j += 32) {
        const float4* src = rows + 4 * (size_t)__ldg(list + j);
        fold_row(ox, oy, oz, dx, dy, dz,
                 TriRow{__ldg(src), __ldg(src + 1), __ldg(src + 2),
                        __ldg(src + 3)},
                 eps, b);
      }
#pragma unroll
      for (int w = 16; w > 0; w >>= 1) {
        const Best o{__shfl_xor_sync(kAll, b.t, w),
                     __shfl_xor_sync(kAll, b.id, w),
                     __shfl_xor_sync(kAll, b.u, w),
                     __shfl_xor_sync(kAll, b.v, w)};
        if (before(o.t, o.id, b)) b = o;
      }
      if (lane == l && before(b.t, b.id, r.b)) r.b = b;
    }
  }
}

// A local chunk of the walk or the fallback (slot k of the staged
// window): the lanes' box tests, then the sweep if some valid lane keeps
// it.
__device__ __forceinline__ void visit(const float4* __restrict__ rows,
                                      Stage& s, int k, int lane, float eps,
                                      Ray& r) {
  const float4 lo = s.box[k][0], hi = s.box[k][1];
  const unsigned live = __float_as_uint(hi.w);
  if (!live) return;
  const bool keep = r.valid && box_keep(r, lo, hi, eps);
  if (__any_sync(kAll, keep))
    sweep_chunk(rows, s, s.cid[k], live, lane, eps, r);
}

// Stage the window of slots [j0, j0 + 32): slot j0 + lane's chunk (the
// list's, or n_glob + j0 + lane with list null) and its box.
__device__ __forceinline__ void stage_window(Stage& s,
                                             const float4* __restrict__ boxes,
                                             const int* __restrict__ list,
                                             int j0, int walk, int n_glob,
                                             int lane) {
  __syncwarp();  // the previous window's readers are done
  const int j = j0 + lane;
  if (j < walk) {
    const int cid = n_glob + (list ? __ldg(list + j) : j);
    s.cid[lane] = cid;
    s.box[lane][0] = __ldg(boxes + 2 * cid);
    s.box[lane][1] = __ldg(boxes + 2 * cid + 1);
  }
  __syncwarp();
}

// Visit slots [0, walk) of the list (null: the local chunks in order),
// window by window.
__device__ __forceinline__ void walk_slots(const float4* __restrict__ rows,
                                           const float4* __restrict__ boxes,
                                           Stage& s,
                                           const int* __restrict__ list,
                                           int walk, int n_glob, int lane,
                                           float eps, Ray& r) {
  for (int j0 = 0; j0 < walk; j0 += 32) {
    stage_window(s, boxes, list, j0, walk, n_glob, lane);
    const int n = min(32, walk - j0);
    for (int k = 0; k < n; ++k) visit(rows, s, k, lane, eps, r);
  }
}

__global__ void __launch_bounds__(32 * kWarps)
    closest_tri_culled_kernel(const float* __restrict__ org,
                              const float* __restrict__ dir,
                              const float4* __restrict__ rows,
                              const float4* __restrict__ boxes,
                              const int* __restrict__ slivers,
                              const float4* __restrict__ cones,
                              const int* __restrict__ cone_rows,
                              const int* __restrict__ stops,
                              const int* __restrict__ lists,
                              const float* __restrict__ dlo, float* t_out,
                              int* tri_out, float* u_out, float* v_out,
                              int n_pad, int n_rays, int n_glob,
                              int n_chunks, int l_max, int n_slivers,
                              int n_cones, float eps) {
  __shared__ Stage s_stage[kWarps];
  const int lane = threadIdx.x & 31;
  Stage& s = s_stage[threadIdx.x >> 5];
  const int g = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (g >= n_pad / 32) return;  // whole warps: the votes stay full
  const int i = g * 32 + lane;
  const int tile = (g * 32) / kTile;
  Ray r;
  r.valid = i < n_rays;
  r.ox = org[i];
  r.oy = org[n_pad + i];
  r.oz = org[2 * n_pad + i];
  r.dx = dir[i];
  r.dy = dir[n_pad + i];
  r.dz = dir[2 * n_pad + i];
  r.ix = 1.0f / r.dx;
  r.iy = 1.0f / r.dy;
  r.iz = 1.0f / r.dz;
  r.len = sqrtf(r.dx * r.dx + r.dy * r.dy + r.dz * r.dz);
  r.b = Best{kBig, kBigId, 0.0f, 0.0f};
  for (int c = 0; c < n_glob; ++c) {
    const unsigned live = __float_as_uint(__ldg(boxes + 2 * c + 1).w);
    if (live) sweep_chunk(rows, s, c, live, lane, eps, r);
  }
  sweep_slivers(rows, slivers, n_slivers, s, lane, eps, r);
  sweep_cones(rows, cones, cone_rows, n_cones, lane, eps, r);
  const int stop = __ldg(stops + tile);
  const int walk = stop < 0 ? -stop : stop;
  walk_slots(rows, boxes, s, lists + (size_t)tile * l_max, walk, n_glob,
             lane, eps, r);
  // overflow: every local chunk, ascending, if a lane reaches the tail
  if (stop < 0 &&
      __any_sync(kAll, r.valid && r.b.t >= __ldg(dlo + (size_t)tile * l_max +
                                                 (walk > 0 ? walk - 1 : 0))))
    walk_slots(rows, boxes, s, nullptr, n_chunks, n_glob, lane, eps, r);
  if (r.valid) {
    const bool hit = r.b.t < kBig;
    t_out[i] = hit ? r.b.t : kBig;
    tri_out[i] = hit ? (int)r.b.id : 0;
    u_out[i] = hit ? r.b.u : 0.0f;
    v_out[i] = hit ? r.b.v : 0.0f;
  }
}

}  // namespace

// The culled closest (t, tri, u, v) of the iparams[1] = n_rays rays of
// (3, iparams[0] = N_pad) f32 planes org and dir, over the accel table with
// iparams[2] = n_glob global and iparams[3] = n_chunks local chunks, its
// box table boxes (n_glob + n_chunks, 8) f32, its sliver rows slivers
// (iparams[5],) i32, its normal cones cones (iparams[6] = n_cones, 4) f32
// and cone_rows (n_cones + 1 + R,) i32, the tiles' stops (T,) i32, lists
// (T, iparams[4] = l_max) i32 and dlo (T, l_max) f32, rejecting t <=
// fparams[0]. t, u, v:
// (n_rays,) f32 and tri: (n_rays,) i32 outputs; stream: a cudaStream_t.
// Returns the launch's cudaGetLastError().
extern "C" int smallpt_closest_tri_culled(
    const void* org, const void* dir, const void* table, const void* boxes,
    const void* slivers, const void* cones, const void* cone_rows,
    const void* stops, const void* lists, const void* dlo, void* t,
    void* tri, void* u, void* v, const void* iparams, const void* fparams,
    void* stream) {
  int ip[7];
  float fp[1];
  memcpy(ip, iparams, sizeof(ip));
  memcpy(fp, fparams, sizeof(fp));
  const int n_pad = ip[0], n_rays = ip[1], n_glob = ip[2], n_chunks = ip[3],
            l_max = ip[4], n_slivers = ip[5], n_cones = ip[6];
  if (n_pad < 0 || n_pad % kTile || n_rays < 0 || n_rays > n_pad ||
      n_glob < 0 || n_chunks < 0 || l_max < 1 || n_slivers < 0 ||
      n_cones < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return 0;
  const int blocks = (n_pad / 32 + kWarps - 1) / kWarps;
  closest_tri_culled_kernel<<<blocks, 32 * kWarps, 0,
                              (cudaStream_t)stream>>>(
      (const float*)org, (const float*)dir, (const float4*)table,
      (const float4*)boxes, (const int*)slivers, (const float4*)cones,
      (const int*)cone_rows, (const int*)stops, (const int*)lists,
      (const float*)dlo, (float*)t, (int*)tri, (float*)u, (float*)v, n_pad,
      n_rays, n_glob, n_chunks, l_max, n_slivers, n_cones, fp[0]);
  return (int)cudaGetLastError();
}
