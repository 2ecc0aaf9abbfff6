// Per-lane device code shared by the megakernel (megakernel.cu, K1), the
// streaming DDA kernel (stream_dda.cu, K3), the binned bounce
// (stream_binned.cu, K8) and the closest-hit sweeps K2 (closest_hit.cu),
// K4 (dda.cu) and K5 (closest_hit_mxu.cu): the launch arguments, PCG4D
// and its uniforms, the sphere tests (whole, and with the miss decided
// first), camera regeneration, the BSDF and Russian roulette shade, the
// NEE cone sample and the UV AOV's polynomial trig. One copy of each formula
// serves every kernel, as the JAX package's stream_dda.py mirrors
// _mega_kernel line for line. Every function keeps the JAX kernels' op
// order; the kernels are built with --fmad=false so each op rounds as there.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace smallpt {

constexpr int kMaxLights = 31;  // the width of the suppression bit mask
constexpr float kBig = 3.0e38f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInvPi = 0.3183098861837907f;
constexpr float kThird = 1.0f / 3.0f;
constexpr uint32_t kCameraSalt = 0x9E3779B9u;
constexpr uint32_t kGolden = 0x85EBCA6Bu;
constexpr uint32_t kLensSalt = 0x94D049BBu;
constexpr uint32_t kNeeSalt = 0x2545F491u;
constexpr uint32_t kNeeSlotStride = 0x632BE59Bu;
constexpr uint32_t kStreamIpMult = 0x9E3779B1u;
// Dynamic shared memory a launch gets without opting in.
constexpr size_t kSmemDefault = 48 * 1024;

// Integer launch arguments (ops/megakernel.py::_IP_NAMES, same order),
// followed by kMaxLights light indices.
enum {
  IP_N_LANES, IP_N_SPHERES, IP_WIDTH, IP_HEIGHT, IP_ROW_OFFSET, IP_IP_OFFSET,
  IP_K_SAMPLES, IP_MAX_IT, IP_SPP, IP_SPP_PER_CELL, IP_JITTER, IP_MAX_DEPTH,
  IP_RR_DEPTH, IP_TENT, IP_MATRIX, IP_FLIP, IP_HAS_ENV, IP_K0, IP_K1,
  IP_N_LIGHTS, IP_COUNT
};
// Float launch arguments (ops/megakernel.py::_launch_args, same order).
enum {
  FP_IOR, FP_SHADING_EPS, FP_APERTURE, FP_FOCAL, FP_ENV_R, FP_ENV_G,
  FP_ENV_B, FP_COUNT
};
// Streaming state planes (ops/megakernel.py::_F_PLANES/_I_PLANES); the DDA
// kernel appends its walk planes after these.
enum { F_OX, F_OY, F_OZ, F_DX, F_DY, F_DZ, F_WX, F_WY, F_WZ, F_RX, F_RY,
       F_RZ, F_M1, F_M2, F_COUNT };
enum { I_DEPTH, I_SIDX, I_ALIVE, I_RAYS, I_BUDGET, I_SUP, I_COUNT };

struct Params {
  int i[IP_COUNT];
  int lights[kMaxLights];
  float f[FP_COUNT];
};

inline Params read_params(const void* iparams, const void* fparams) {
  Params p;
  memcpy(p.i, iparams, sizeof(p.i));
  memcpy(p.lights, (const int*)iparams + IP_COUNT, sizeof(p.lights));
  memcpy(p.f, fparams, sizeof(p.f));
  return p;
}

// The largest dynamic shared memory a block of the current device may opt in
// to (227 KB on an H100).
inline size_t smem_optin_limit() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return (size_t)bytes;
}

// Let `kernel` take up to the opt-in limit of dynamic shared memory on the
// current device. The attribute is per device, so every launch needing more
// than the 48 KB default sets it (a cheap host call next to the launch).
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_optin_limit());
}

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

// atan2(y, x) from abs/min/max/div/select and a degree-9 odd minimax
// polynomial, op for op the JAX package's _atan2_poly
// (ops/megakernel.py:93) and ops/megakernel.py::_atan2_poly here: the UV
// AOV's longitude in the binned kernel (K8), not the library atan2f.
__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x);
  const float ay = fabsf(y);
  const float hi = fmaxf(ax, ay);
  const float z = fminf(ax, ay) / fmaxf(hi, 1e-30f);
  const float z2 = z * z;
  float p = 0.0208351f * z2;
  p = p - 0.0851330f;
  p = p * z2 + 0.1801410f;
  p = p * z2 - 0.3302995f;
  p = p * z2 + 0.9998660f;
  float a = p * z;
  if (ay > ax) a = 1.5707963267948966f - a;
  if (x < 0.0f) a = 3.141592653589793f - a;
  return y < 0.0f ? -a : a;
}

// asin(y) on [-1, 1] as atan2(y, sqrt(1 - y^2)) (_asin_poly,
// ops/megakernel.py:120): exact at the poles.
__device__ __forceinline__ float asin_poly(float y) {
  const float c = fminf(fmaxf(y, -1.0f), 1.0f);
  return atan2_poly(c, sqrtf(fmaxf(1.0f - c * c, 0.0f)));
}

// An orthonormal (u, v) around the unit vector n (smallpt.cpp:209):
// u = normalize(up x n), up = y if |n.x| > 0.1 else x; v = n x u.
__device__ __forceinline__ void frame(float nx, float ny, float nz,
                                      float& ux, float& uy, float& uz,
                                      float& vx, float& vy, float& vz) {
  const bool bigx = fabsf(nx) > 0.1f;
  const float upx = bigx ? 0.0f : 1.0f;
  const float upy = bigx ? 1.0f : 0.0f;
  ux = upy * nz;
  uy = -upx * nz;
  uz = upx * ny - upy * nx;
  normalize3(ux, uy, uz);
  vx = ny * uz - nz * uy;
  vy = nz * ux - nx * uz;
  vz = nx * uy - ny * ux;
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

// Candidate hit distance of one sphere in the direct quadratic: the JAX
// closest-hit kernel's fast_body (ops/intersect_pallas.py:106-120), op for
// op, for spheres below its STABLE_RADIUS, where b and |op|^2 are of the
// scene's scale and their cancellation is harmless in float32.
__device__ __forceinline__ float sphere_tt_fast(float ox, float oy, float oz,
                                                float dx, float dy, float dz,
                                                float scx, float scy,
                                                float scz, float sr,
                                                float seps) {
  const float opx = scx - ox;
  const float opy = scy - oy;
  const float opz = scz - oz;
  const float b = opx * dx + opy * dy + opz * dz;
  const float op2 = opx * opx + opy * opy + opz * opz;
  const float det = b * b - op2 + sr * sr;
  const float s = sqrtf(fmaxf(det, 0.0f));
  const float t0 = b - s;
  const float t1 = b + s;
  const float tt = t0 > seps ? t0 : (t1 > seps ? t1 : kBig);
  return (det >= 0.0f && sr > 0.0f) ? tt : kBig;
}

// sphere_tt with the miss decided first: where det < 0 or NaN, or the
// radius is not positive, it returns false before the two square roots and
// the division that only a hit needs; otherwise true and the whole test's
// tt, op for op. The whole test's 3e38 on a miss never goes below a fold's
// best, which starts at 3e38, so a fold may skip the pair. c = [cx cy cz
// r]. The closest-hit sweeps K2 (closest_hit.cu), K4 (dda.cu) and K5
// (closest_hit_mxu.cu) and the DDA walk K3 (stream_dda.cu) call it.
__device__ __forceinline__ bool early_stable_tt(float ox, float oy, float oz,
                                                float dx, float dy, float dz,
                                                float4 c, float seps,
                                                float& tt) {
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

// sphere_tt_fast with the miss decided first: false where det < 0 or NaN,
// or the radius is not positive, before the square root and the roots;
// otherwise true and the whole test's tt, op for op. rr = r * r, the one
// rounding sphere_tt_fast takes (a caller may stage it once a row). c =
// [cx cy cz r]. K2 and K4 call it.
__device__ __forceinline__ bool early_direct_tt(float ox, float oy, float oz,
                                                float dx, float dy, float dz,
                                                float4 c, float rr,
                                                float seps, float& tt) {
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

// A pixel lane: its image coordinates and its streaming key word a.
struct Pixel {
  int col, row;
  uint32_t id;  // row * W + col
};

__device__ __forceinline__ Pixel pixel_of(const Params& p, int lane) {
  const int W = p.i[IP_WIDTH];
  Pixel px;
  px.col = lane % W;
  px.row = lane / W + p.i[IP_ROW_OFFSET];
  px.id = (uint32_t)px.row * (uint32_t)W + (uint32_t)px.col;
  return px;
}

// The streaming v2 PCG4D words a and b of sample ip (core/rng.py
// stream_key_words): (pixel ^ k0, k1 ^ ip * mult).
__device__ __forceinline__ void stream_words(const Params& p, const Pixel& px,
                                             int ip, uint32_t& wa,
                                             uint32_t& wb) {
  wa = px.id ^ (uint32_t)p.i[IP_K0];
  wb = (uint32_t)p.i[IP_K1] ^ ((uint32_t)ip * kStreamIpMult);
}

// The camera ray of the pixel's sample ip, keyed by its words (wa, wb):
// the jitter cell, the tent or box filter, the legacy or matrix camera
// vector cam (ops/megakernel.py::build_camera_vec) and the thin lens.
__device__ __forceinline__ void camera_ray(const Params& p,
                                           const float* __restrict__ cam,
                                           const Pixel& px, int ip,
                                           uint32_t wa, uint32_t wb,
                                           float& ox, float& oy, float& oz,
                                           float& dx, float& dy, float& dz) {
  const uint32_t kk = (uint32_t)p.i[IP_K0] + (uint32_t)p.i[IP_K1];
  const int js = p.i[IP_JITTER];
  const float jsf = (float)js;
  // the jitter cell cycles over the js x js grid (streaming ip runs past spp)
  const int group = (ip / p.i[IP_SPP_PER_CELL]) % (js * js);
  const float cx_cell = (float)(group % js);
  const float cy_cell = (float)(group / js);
  uint32_t ua = wa, ub = wb, uc = kCameraSalt, ud = kk;
  pcg4d(ua, ub, uc, ud);
  const float u0 = to_unit(ua);
  const float u1 = to_unit(ub);
  float off0, off1;
  if (p.i[IP_TENT] != 0) {
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
  float sx = ((float)px.col + 0.5f + off0) / (float)p.i[IP_WIDTH] - 0.5f;
  float sy = ((float)px.row + 0.5f + off1) / (float)p.i[IP_HEIGHT] - 0.5f;
  if (p.i[IP_MATRIX] != 0) {
    sx = 2.0f * sx;
    sy = 2.0f * sy;
  }
  const float ax = cam[0], ay = cam[1], az = cam[2];
  const float bx = cam[3], by = cam[4], bz = cam[5];
  const float gdx = sx * ax + sy * bx + cam[6];
  const float gdy = sx * ay + sy * by + cam[7];
  const float gdz = sx * az + sy * bz + cam[8];
  const float push = cam[12];
  ox = cam[9] + gdx * push;
  oy = cam[10] + gdy * push;
  oz = cam[11] + gdz * push;
  dx = gdx;
  dy = gdy;
  dz = gdz;
  normalize3(dx, dy, dz);
  const float aperture = p.f[FP_APERTURE];
  if (aperture > 0.0f) {
    // thin lens: jitter the origin on the aperture disk, re-aim at the
    // along-ray focus point (core/camera.py::_thin_lens)
    const float focal = p.f[FP_FOCAL];
    uint32_t la = wa, lb = wb, lc = kLensSalt, ld = kk;
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
}

// What the shade of one hit decides: whether the path survives Russian
// roulette, its throughput factor f, the next direction, and the offset of
// the next origin along the oriented normal (negative when the ray is
// transmitted).
struct Shade {
  bool survive, diffuse;
  float fx, fy, fz;
  float ndx, ndy, ndz;
  float eps_off;
};

// Russian roulette, then the DIFF/SPEC/REFR BSDF of smallpt.cpp:187-246 at a
// hit with incoming direction d, geometric normal n (unit, outward) and
// oriented normal nl, albedo al and refl class; u_* are the vertex's
// shade uniforms, depth its pre-increment depth. The direction of a path
// that does not survive is not computed.
__device__ __forceinline__ Shade shade(const Params& p, float dx, float dy,
                                       float dz, float nx, float ny, float nz,
                                       float nlx, float nly, float nlz,
                                       float al_x, float al_y, float al_z,
                                       float refl, float u_rr, float u_b1,
                                       float u_b2, float u_ch, int depth) {
  Shade s;
  const float p_rr = fmaxf(al_x, fmaxf(al_y, al_z));
  const bool rr_active = depth > p.i[IP_RR_DEPTH];
  s.survive = !rr_active || u_rr < p_rr;
  s.diffuse = refl < 0.5f;
  s.eps_off = p.f[FP_SHADING_EPS];
  if (!s.survive) return s;
  const float boost = rr_active ? 1.0f / fmaxf(p_rr, 1e-12f) : 1.0f;
  s.fx = al_x * boost;
  s.fy = al_y * boost;
  s.fz = al_z * boost;
  if (s.diffuse) {
    // DIFF: cosine-weighted hemisphere around nl (smallpt.cpp:208-216)
    const float r1 = kTwoPi * u_b1;
    const float r2s = sqrtf(u_b2);
    float tux, tuy, tuz, tvx, tvy, tvz;
    frame(nlx, nly, nlz, tux, tuy, tuz, tvx, tvy, tvz);
    const float cr1 = cosf(r1) * r2s;
    const float sr1 = sinf(r1) * r2s;
    const float wzc = sqrtf(fmaxf(1.0f - u_b2, 0.0f));
    s.ndx = tux * cr1 + tvx * sr1 + nlx * wzc;
    s.ndy = tuy * cr1 + tvy * sr1 + nly * wzc;
    s.ndz = tuz * cr1 + tvz * sr1 + nlz * wzc;
    normalize3(s.ndx, s.ndy, s.ndz);
    return s;
  }
  // SPEC mirror (smallpt.cpp:218); REFR reflects the same way
  const float nd = nx * dx + ny * dy + nz * dz;
  s.ndx = dx - nx * (2.0f * nd);
  s.ndy = dy - ny * (2.0f * nd);
  s.ndz = dz - nz * (2.0f * nd);
  if (refl >= 1.5f) {
    // REFR: Snell + TIR + Schlick (smallpt.cpp:225-246)
    const float nt = p.f[FP_IOR];
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
    const float cterm = 1.0f - (into ? -ddn : tdx * nx + tdy * ny + tdz * nz);
    const float re = r0 + (1.0f - r0) * cterm * cterm * cterm * cterm * cterm;
    const float tr = 1.0f - re;
    const float p_refl = 0.25f + 0.5f * re;
    const bool choose_refl = u_ch < p_refl;
    float wf = 1.0f;
    if (!tir) {
      wf = choose_refl ? re / p_refl : tr / (1.0f - p_refl);
      if (!choose_refl) {
        s.ndx = tdx;
        s.ndy = tdy;
        s.ndz = tdz;
        s.eps_off = -p.f[FP_SHADING_EPS];
      }
    }
    s.fx = s.fx * wf;
    s.fy = s.fy * wf;
    s.fz = s.fz * wf;
  }
  return s;
}

// One NEE cone sample of the light sphere (lc, lrr, leps) from the shading
// point no with oriented normal nl: the direction ld, the light's own
// candidate t_light along it (the sweep's arithmetic), and the factor
// cos * omega / pi of its contribution f * Le * scale. Returns false, with
// nothing computed, when no is inside the light's shell. salt is the
// vertex's NEE word c (pre-increment depth + the slot's salt).
__device__ __forceinline__ bool nee_cone(const Params& p, float nox,
                                         float noy, float noz, float nlx,
                                         float nly, float nlz, float lcx,
                                         float lcy, float lcz, float lrr,
                                         float leps, uint32_t wa, uint32_t wb,
                                         uint32_t salt, float& ldx,
                                         float& ldy, float& ldz,
                                         float& t_light, float& scale) {
  const float swx = lcx - nox;
  const float swy = lcy - noy;
  const float swz = lcz - noz;
  const float d2 = swx * swx + swy * swy + swz * swz;
  const float lrr2 = lrr * lrr;
  if (d2 <= lrr2) return false;  // inside the light's shell: no sample
  const float d2c = fmaxf(d2, 1e-12f);
  const float cos_a_max = sqrtf(fmaxf(1.0f - lrr2 / d2c, 0.0f));
  uint32_t na = wa, nb = wb, nc = salt;
  uint32_t nd = (uint32_t)p.i[IP_K0] + (uint32_t)p.i[IP_K1];
  pcg4d(na, nb, nc, nd);
  const float nu0 = to_unit(na);
  const float nu1 = to_unit(nb);
  const float cos_a = 1.0f - nu0 + nu0 * cos_a_max;
  const float sin_a = sqrtf(fmaxf(1.0f - cos_a * cos_a, 0.0f));
  const float nphi = kTwoPi * nu1;
  const float inv_d = 1.0f / sqrtf(d2c);
  const float swnx = swx * inv_d;
  const float swny = swy * inv_d;
  const float swnz = swz * inv_d;
  float sux, suy, suz, svx, svy, svz;
  frame(swnx, swny, swnz, sux, suy, suz, svx, svy, svz);
  const float cphi = cosf(nphi) * sin_a;
  const float sphi = sinf(nphi) * sin_a;
  ldx = sux * cphi + svx * sphi + swnx * cos_a;
  ldy = suy * cphi + svy * sphi + swny * cos_a;
  ldz = suz * cphi + svz * sphi + swnz * cos_a;
  normalize3(ldx, ldy, ldz);
  t_light = sphere_tt(nox, noy, noz, ldx, ldy, ldz, lcx, lcy, lcz, lrr, leps);
  const float cosine = fmaxf(ldx * nlx + ldy * nly + ldz * nlz, 0.0f);
  const float omega = kTwoPi * (1.0f - cos_a_max);
  scale = cosine * omega * kInvPi;
  return true;
}

// The launch's ray count (or another count): the exact int64 sum of the
// lanes' increments, reduced per warp and added with one atomic per warp.
// Every thread of the block calls it.
__device__ __forceinline__ void add_rays(unsigned long long* rays,
                                         long long traced) {
  for (int off = 16; off > 0; off >>= 1)
    traced += __shfl_down_sync(0xFFFFFFFFu, traced, off);
  if ((threadIdx.x & 31) == 0 && traced != 0)
    atomicAdd(rays, (unsigned long long)traced);
}

}  // namespace smallpt
