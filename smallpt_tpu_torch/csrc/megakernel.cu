// Per-pass wavefront megakernel for sm_90a: regenerate + intersect + shade,
// fused into one launch per pass.
//
// Replaces: smallpt_tpu/ops/megakernel.py::_mega_kernel in its per-pass mode
// (streaming=False, no NEE, no record planes), as launched by
// render_pass_megakernel through one pallas_call.
//
// What bounds it on an H100: FP32 ALU work, not memory. A pass reads a
// sphere table of S x 64 bytes and writes 16 bytes per pixel lane, while
// every ray costs about 27 float ops per sphere in the closest-hit sweep
// (plus 3 square roots and a division) and a few hundred for regeneration,
// PCG4D hashing and shading. The Cornell box (S = 9) spends ~250 ops per ray
// in the sweep and ~200 in the rest. The card's float32 rate outside the
// tensor cores is 67 TFLOP/s, counting an FMA as two flops; built with
// --fmad=false this kernel issues no FMA, so its adds and multiplies retire
// at most at 33.5 T/s. Square roots and divisions are multi-instruction
// sequences, counted here as one op each.
//
// What the design does about it:
// - one thread per pixel lane, each looping on its own until its samples
//   are done (the TPU kernel's tile-wide any() exists only because 8x1024
//   lanes retire together); per lane the result is the same, and the
//   k_samples * max_depth iteration cap of the JAX kernel is kept;
// - path state lives in registers; only radiance (G, 3) f32 and the ray
//   count (G,) i32 are written, once per lane;
// - the sweep columns [cx cy cz r eps] sit in shared memory, loaded once per
//   block and sized to the scene (2048 x 20 B = 40 KB at most, under the
//   48 KB a launch gets without opting in), read as warp-wide broadcasts;
//   the sweep visits the scene's n_spheres rows, not the table's padding to
//   a multiple of 8 (as the JAX kernel's SMEM sweep does);
// - the TPU kernel's 12-way per-sphere select fold (it has no per-lane
//   gather) becomes one indexed load of the winner's material row;
// - the sweep keeps _shadow_tt's citardauq arithmetic, strict < for ties
//   (the first id wins) and the 3e38 sentinel; built with --fmad=false so
//   each op rounds in the JAX kernel's order.
//
// Interface: a plain C function, loaded with ctypes (ops/megakernel.py). It
// launches on the caller's stream, synchronises nothing and returns
// cudaGetLastError() of the launch.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxSpheres = 2048;
constexpr int kBlock = 128;
constexpr float kBig = 3.0e38f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr uint32_t kCameraSalt = 0x9E3779B9u;
constexpr uint32_t kGolden = 0x85EBCA6Bu;
constexpr uint32_t kLensSalt = 0x94D049BBu;

// Integer launch arguments (ops/megakernel.py::_IP_NAMES, same order).
enum {
  IP_N_LANES, IP_N_SPHERES, IP_WIDTH, IP_HEIGHT, IP_ROW_OFFSET, IP_IP_OFFSET,
  IP_K_SAMPLES, IP_MAX_IT, IP_SPP, IP_SPP_PER_CELL, IP_JITTER, IP_MAX_DEPTH,
  IP_RR_DEPTH, IP_TENT, IP_MATRIX, IP_FLIP, IP_HAS_ENV, IP_K0, IP_K1,
  IP_COUNT
};
// Float launch arguments (ops/megakernel.py::_launch_args, same order).
enum {
  FP_IOR, FP_SHADING_EPS, FP_APERTURE, FP_FOCAL, FP_ENV_R, FP_ENV_G,
  FP_ENV_B, FP_COUNT
};

struct Params {
  int i[IP_COUNT];
  float f[FP_COUNT];
};

// PCG4D (Jarzynski & Olano 2020), bit-identical to core/rng.py::_pcg4d.
__device__ __forceinline__ void pcg4d(uint32_t& a, uint32_t& b, uint32_t& c,
                                      uint32_t& d) {
  a = a * 1664525u + 1013904223u;
  b = b * 1664525u + 1013904223u;
  c = c * 1664525u + 1013904223u;
  d = d * 1664525u + 1013904223u;
  a += b * d;
  b += c * a;
  c += a * b;
  d += b * c;
  a ^= a >> 16;
  b ^= b >> 16;
  c ^= c >> 16;
  d ^= d >> 16;
  a += b * d;
  b += c * a;
  c += a * b;
  d += b * c;
}

__device__ __forceinline__ float to_unit(uint32_t bits) {
  return (float)(bits >> 8) * (1.0f / 16777216.0f);
}

__device__ __forceinline__ void normalize3(float& x, float& y, float& z) {
  const float inv = 1.0f / sqrtf(x * x + y * y + z * z);
  x = x * inv;
  y = y * inv;
  z = z * inv;
}

// Candidate hit distance of one sphere: the stable citardauq form of the
// JAX kernel's _shadow_tt (ops/megakernel.py:127-148), op for op; its
// sr > 0 test keeps a zero-radius sphere from being hit by a ray through
// its centre.
__device__ __forceinline__ float sphere_tt(float ox, float oy, float oz,
                                           float dx, float dy, float dz,
                                           float scx, float scy, float scz,
                                           float sr, float seps) {
  const float opx = scx - ox;
  const float opy = scy - oy;
  const float opz = scz - oz;
  const float b = opx * dx + opy * dy + opz * dz;
  const float fx = opx - b * dx;
  const float fy = opy - b * dy;
  const float fz = opz - b * dz;
  const float pp = fx * fx + fy * fy + fz * fz;
  const float sp = sqrtf(pp);
  const float det = (sr - sp) * (sr + sp);
  const float s = sqrtf(fmaxf(det, 0.0f));
  const float opn = sqrtf(b * b + pp);
  const float cc = (opn - sr) * (opn + sr);
  const float denom = b + s;
  const float t_near = denom > 0.0f ? cc / denom : -kBig;
  const float tt = t_near > seps ? t_near : (denom > seps ? denom : kBig);
  return (det >= 0.0f && sr > 0.0f) ? tt : kBig;
}

__global__ void __launch_bounds__(kBlock)
mega_pass_kernel(const float* __restrict__ table,
                 const float* __restrict__ cam, float* __restrict__ rad,
                 int* __restrict__ rays, const Params p) {
  // 5 * n_spheres floats of dynamic shared memory (40 KB at most)
  extern __shared__ float smem[];
  const int n_spheres = p.i[IP_N_SPHERES];
  float* s_cx = smem;
  float* s_cy = smem + n_spheres;
  float* s_cz = smem + 2 * n_spheres;
  float* s_r = smem + 3 * n_spheres;
  float* s_eps = smem + 4 * n_spheres;
  for (int s = threadIdx.x; s < n_spheres; s += blockDim.x) {
    const float* row = table + 16 * s;
    s_cx[s] = row[0];
    s_cy[s] = row[1];
    s_cz[s] = row[2];
    s_r[s] = row[3];
    s_eps[s] = row[4];
  }
  __syncthreads();

  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= p.i[IP_N_LANES]) return;

  const int W = p.i[IP_WIDTH];
  const float Wf = (float)W;
  const float Hf = (float)p.i[IP_HEIGHT];
  const int pix_col = lane % W;
  const int pix_row = lane / W + p.i[IP_ROW_OFFSET];
  const uint32_t pixel = (uint32_t)pix_row * (uint32_t)W + (uint32_t)pix_col;
  const uint32_t k0 = (uint32_t)p.i[IP_K0];
  const uint32_t k1 = (uint32_t)p.i[IP_K1];
  const uint32_t kk = k0 + k1;
  const int budget = p.i[IP_K_SAMPLES];
  const int max_it = p.i[IP_MAX_IT];
  const int ip_offset = p.i[IP_IP_OFFSET];
  const uint32_t spp = (uint32_t)p.i[IP_SPP];
  const int spp_per_cell = p.i[IP_SPP_PER_CELL];
  const int js = p.i[IP_JITTER];
  const float jsf = (float)js;
  const int max_depth = p.i[IP_MAX_DEPTH];
  const int rr_depth = p.i[IP_RR_DEPTH];
  const bool tent = p.i[IP_TENT] != 0;
  const bool matrix = p.i[IP_MATRIX] != 0;
  const bool flip_normals = p.i[IP_FLIP] != 0;
  const bool has_env = p.i[IP_HAS_ENV] != 0;
  const float nt = p.f[FP_IOR];
  const float shading_eps = p.f[FP_SHADING_EPS];
  const float aperture = p.f[FP_APERTURE];
  const float focal = p.f[FP_FOCAL];

  const float ax = cam[0], ay = cam[1], az = cam[2];
  const float bx = cam[3], by = cam[4], bz = cam[5];
  const float cxv = cam[6], cyv = cam[7], czv = cam[8];
  const float o0x = cam[9], o0y = cam[10], o0z = cam[11];
  const float push = cam[12];

  float ox = 0.f, oy = 0.f, oz = 0.f, dx = 0.f, dy = 0.f, dz = 0.f;
  float wx = 0.f, wy = 0.f, wz = 0.f, rx = 0.f, ry = 0.f, rz = 0.f;
  int depth = 0, s_idx = -1, nrays = 0;
  bool alive = false;
  uint32_t wa = 0;  // the current sample's PCG4D word: sid ^ k0

  for (int it = 0; it < max_it; ++it) {
    // ---- regenerate with the pixel's next sample ---------------------------
    if (!alive) {
      if (s_idx >= budget - 1) break;
      ++s_idx;
      const int ip = ip_offset + s_idx;
      wa = (pixel * spp + (uint32_t)ip) ^ k0;
      const int group = (ip / spp_per_cell) % (js * js);
      const float cx_cell = (float)(group % js);
      const float cy_cell = (float)(group / js);
      uint32_t ua = wa, ub = k1, uc = kCameraSalt, ud = kk;
      pcg4d(ua, ub, uc, ud);
      const float u0 = to_unit(ua);
      const float u1 = to_unit(ub);
      float off0, off1;
      if (tent) {
        const float r0 = 2.0f * u0;
        const float r1 = 2.0f * u1;
        const float f0 = r0 < 1.0f ? sqrtf(r0) - 1.0f
                                   : 1.0f - sqrtf(fmaxf(2.0f - r0, 0.0f));
        const float f1 = r1 < 1.0f ? sqrtf(r1) - 1.0f
                                   : 1.0f - sqrtf(fmaxf(2.0f - r1, 0.0f));
        off0 = (cx_cell + 0.5f + f0) / jsf - 0.5f;
        off1 = (cy_cell + 0.5f + f1) / jsf - 0.5f;
      } else {
        off0 = (cx_cell + u0) / jsf - 0.5f;
        off1 = (cy_cell + u1) / jsf - 0.5f;
      }
      float sx = ((float)pix_col + 0.5f + off0) / Wf - 0.5f;
      float sy = ((float)pix_row + 0.5f + off1) / Hf - 0.5f;
      if (matrix) {
        sx = 2.0f * sx;
        sy = 2.0f * sy;
      }
      const float gdx = sx * ax + sy * bx + cxv;
      const float gdy = sx * ay + sy * by + cyv;
      const float gdz = sx * az + sy * bz + czv;
      ox = o0x + gdx * push;
      oy = o0y + gdy * push;
      oz = o0z + gdz * push;
      dx = gdx;
      dy = gdy;
      dz = gdz;
      normalize3(dx, dy, dz);
      if (aperture > 0.0f) {
        // thin lens: jitter the origin on the aperture disk, re-aim at the
        // along-ray focus point (core/camera.py::_thin_lens)
        uint32_t la = wa, lb = k1, lc = kLensSalt, ld = kk;
        pcg4d(la, lb, lc, ld);
        const float lrad = aperture * sqrtf(to_unit(la));
        const float lth = kTwoPi * to_unit(lb);
        const float lx = lrad * cosf(lth);
        const float ly = lrad * sinf(lth);
        float rnx = ax, rny = ay, rnz = az;
        float unx = bx, uny = by, unz = bz;
        normalize3(rnx, rny, rnz);
        normalize3(unx, uny, unz);
        const float fpx = ox + dx * focal;
        const float fpy = oy + dy * focal;
        const float fpz = oz + dz * focal;
        ox = ox + rnx * lx + unx * ly;
        oy = oy + rny * lx + uny * ly;
        oz = oz + rnz * lx + unz * ly;
        dx = fpx - ox;
        dy = fpy - oy;
        dz = fpz - oz;
        normalize3(dx, dy, dz);
      }
      wx = 1.0f;
      wy = 1.0f;
      wz = 1.0f;
      depth = 0;
      alive = true;
    }
    ++nrays;

    // ---- closest-hit sweep over the shared-memory table --------------------
    float bt = kBig;
    int bi = -1;
    for (int s = 0; s < n_spheres; ++s) {
      const float tt = sphere_tt(ox, oy, oz, dx, dy, dz, s_cx[s], s_cy[s],
                                 s_cz[s], s_r[s], s_eps[s]);
      if (tt < bt) {
        bt = tt;
        bi = s;
      }
    }
    if (bi < 0) {
      // escaped: pick up the environment (the smallpt.cpp:168 hook), die
      if (has_env) {
        rx = rx + wx * p.f[FP_ENV_R];
        ry = ry + wy * p.f[FP_ENV_G];
        rz = rz + wz * p.f[FP_ENV_B];
      }
      alive = false;
      ++depth;
      continue;
    }

    // ---- the winner's row: one indexed load --------------------------------
    const float* row = table + 16 * bi;
    const float hx = ox + bt * dx;
    const float hy = oy + bt * dy;
    const float hz = oz + bt * dz;
    float nx = hx - __ldg(row + 0);
    float ny = hy - __ldg(row + 1);
    float nz = hz - __ldg(row + 2);
    normalize3(nx, ny, nz);
    float nlx = nx, nly = ny, nlz = nz;
    if (flip_normals && !(nx * dx + ny * dy + nz * dz < 0.0f)) {
      nlx = -nx;
      nly = -ny;
      nlz = -nz;
    }

    // emission, pre-RR (smallpt.cpp:179)
    rx = rx + wx * __ldg(row + 5);
    ry = ry + wy * __ldg(row + 6);
    rz = rz + wz * __ldg(row + 7);

    uint32_t sa = wa, sb = k1, sc = (uint32_t)depth + kGolden, sd = kk;
    pcg4d(sa, sb, sc, sd);
    const float u_rr = to_unit(sa);
    const float u_b1 = to_unit(sb);
    const float u_b2 = to_unit(sc);
    const float u_ch = to_unit(sd);

    // Russian roulette (smallpt.cpp:187-198)
    const float al_x = __ldg(row + 8);
    const float al_y = __ldg(row + 9);
    const float al_z = __ldg(row + 10);
    const float p_rr = fmaxf(al_x, fmaxf(al_y, al_z));
    const bool rr_active = depth > rr_depth;
    const bool survive = !rr_active || u_rr < p_rr;
    ++depth;
    if (!survive) {
      alive = false;
      continue;
    }
    const float boost = rr_active ? 1.0f / fmaxf(p_rr, 1e-12f) : 1.0f;
    float fx = al_x * boost;
    float fy = al_y * boost;
    float fz = al_z * boost;

    const float refl = __ldg(row + 11);
    float ndx, ndy, ndz;
    float eps_off = shading_eps;
    if (refl < 0.5f) {
      // DIFF: cosine-weighted hemisphere around nl (smallpt.cpp:208-216)
      const float r1 = kTwoPi * u_b1;
      const float r2s = sqrtf(u_b2);
      const bool bigx = fabsf(nlx) > 0.1f;
      const float upx = bigx ? 0.0f : 1.0f;
      const float upy = bigx ? 1.0f : 0.0f;
      float tux = upy * nlz;
      float tuy = -upx * nlz;
      float tuz = upx * nly - upy * nlx;
      normalize3(tux, tuy, tuz);
      const float tvx = nly * tuz - nlz * tuy;
      const float tvy = nlz * tux - nlx * tuz;
      const float tvz = nlx * tuy - nly * tux;
      const float cr1 = cosf(r1) * r2s;
      const float sr1 = sinf(r1) * r2s;
      const float wzc = sqrtf(fmaxf(1.0f - u_b2, 0.0f));
      ndx = tux * cr1 + tvx * sr1 + nlx * wzc;
      ndy = tuy * cr1 + tvy * sr1 + nly * wzc;
      ndz = tuz * cr1 + tvz * sr1 + nlz * wzc;
      normalize3(ndx, ndy, ndz);
    } else {
      // SPEC mirror (smallpt.cpp:218); REFR reflects the same way
      const float nd = nx * dx + ny * dy + nz * dz;
      ndx = dx - nx * (2.0f * nd);
      ndy = dy - ny * (2.0f * nd);
      ndz = dz - nz * (2.0f * nd);
      if (refl >= 1.5f) {
        // REFR: Snell + TIR + Schlick (smallpt.cpp:225-246)
        const bool into = (nx * nlx + ny * nly + nz * nlz) > 0.0f;
        const float nnt = into ? 1.0f / nt : nt / 1.0f;
        const float ddn = dx * nlx + dy * nly + dz * nlz;
        const float cos2t = 1.0f - nnt * nnt * (1.0f - ddn * ddn);
        const bool tir = cos2t < 0.0f;
        const float sq = sqrtf(fmaxf(cos2t, 0.0f));
        const float tfac = (into ? 1.0f : -1.0f) * (ddn * nnt + sq);
        float tdx = 1.0f, tdy = 0.0f, tdz = 0.0f;
        if (!tir) {
          tdx = dx * nnt - nx * tfac;
          tdy = dy * nnt - ny * tfac;
          tdz = dz * nnt - nz * tfac;
        }
        normalize3(tdx, tdy, tdz);
        const float a = nt - 1.0f;
        const float b = nt + 1.0f;
        const float r0 = (a * a) / (b * b);
        const float cterm =
            1.0f - (into ? -ddn : tdx * nx + tdy * ny + tdz * nz);
        const float re =
            r0 + (1.0f - r0) * cterm * cterm * cterm * cterm * cterm;
        const float tr = 1.0f - re;
        const float p_refl = 0.25f + 0.5f * re;
        const bool choose_refl = u_ch < p_refl;
        float wf = 1.0f;
        if (!tir) {
          wf = choose_refl ? re / p_refl : tr / (1.0f - p_refl);
          if (!choose_refl) {
            ndx = tdx;
            ndy = tdy;
            ndz = tdz;
            eps_off = -shading_eps;
          }
        }
        fx = fx * wf;
        fy = fy * wf;
        fz = fz * wf;
      }
    }

    ox = hx + eps_off * nlx;
    oy = hy + eps_off * nly;
    oz = hz + eps_off * nlz;
    dx = ndx;
    dy = ndy;
    dz = ndz;
    wx = wx * fx;
    wy = wy * fy;
    wz = wz * fz;
    alive = depth < max_depth;
  }

  rad[3 * lane + 0] = rx;
  rad[3 * lane + 1] = ry;
  rad[3 * lane + 2] = rz;
  rays[lane] = nrays;
}

}  // namespace

// Launch one per-pass megakernel over params[IP_N_LANES] pixel lanes.
// table: (>= n_spheres, 16) f32 and cam: (16,) f32 on the device; rad: (G, 3)
// f32 and rays: (G,) i32 outputs; iparams/fparams: host arrays of IP_COUNT
// ints and FP_COUNT floats; stream: a cudaStream_t. Returns the launch's
// cudaGetLastError().
extern "C" int smallpt_mega_pass(const void* table, const void* cam,
                                 void* rad, void* rays, const void* iparams,
                                 const void* fparams, void* stream) {
  Params p;
  memcpy(p.i, iparams, sizeof(p.i));
  memcpy(p.f, fparams, sizeof(p.f));
  const int n = p.i[IP_N_LANES];
  if (p.i[IP_N_SPHERES] < 0 || p.i[IP_N_SPHERES] > kMaxSpheres ||
      p.i[IP_WIDTH] <= 0 || p.i[IP_JITTER] <= 0 || p.i[IP_SPP_PER_CELL] <= 0)
    return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const int grid = (n + kBlock - 1) / kBlock;
  const size_t smem = 5 * sizeof(float) * (size_t)p.i[IP_N_SPHERES];
  mega_pass_kernel<<<grid, kBlock, smem, (cudaStream_t)stream>>>(
      (const float*)table, (const float*)cam, (float*)rad, (int*)rays, p);
  return (int)cudaGetLastError();
}
