// K3a / K3b: the whole-pass path-tracing megakernel and its replay-gradient
// twin, for scenes of at most 128 triangles, 32 materials, 32 emitters.
//
// Replaces fermat_tpu/ops/pallas_pt_mega.py: _mega_kernel (:427, launched by
// _mega_impl :705) and _mega_grad_kernel (:745, launched by
// _mega_grad_impl :1015). The Pallas kernels put rays on full (8, 128)
// vregs and lane-replicate every table row, because Mosaic has no per-lane
// gather or control flow. Here one thread owns one path at a time and reads
// the tables from shared memory: the triangle loop reads the same record in
// every thread (a broadcast), the material and light fetches index by the
// lane's id. A shadow ray leaves the triangle loop at its first hit (the
// Pallas loop only ORs, :346, so that changes no output).
//
// Every __device__ function transcribes the port's PyTorch function of the
// same name (core/rng.py, core/math.py, core/sampling.py, bsdf/ggx.py,
// bsdf/composite.py, ops/pt_mega.py:_plain_pass) in its operation order.
// Built with --fmad=false and without fast math, so it rounds like the plain
// version on the card: sqrtf, IEEE '/', sincosf (the bits of sinf and cosf,
// which torch.sin and torch.cos compute), and rsqrtf where torch calls
// torch.rsqrt (on a CUDA tensor that op computes ::rsqrt(float), i.e.
// rsqrtf; on the CPU it is 1/sqrt). Clamps propagate NaN as torch.clamp,
// clamp_min and maximum do (fminf/fmaxf alone would drop it).
//
// Bound on H100: FP32 operations (the triangle tests, ~46 flops each, and
// the shading, a few thousand flops a vertex; chip_smoke.py phase 6 counts
// them per event); the bytes are the 27 output lanes per pixel. What holds
// the kernel back is latency and divergence, not a unit's peak: a vertex
// is a long dependent chain of IEEE divisions, square roots and sines, and
// paths end after 1 to max_path_length vertices. The design:
//  * Persistent CTAs, path regeneration. The grid is as many 128-thread
//    blocks as fit on the card at once. A thread runs one vertex of its path
//    per step (Path holds what a vertex needs of the one before); a lane
//    whose path has ended takes its warp's next pixel at the next step
//    (__ballot_sync, __popc), so the warp's lanes stay busy until its pixels
//    run out instead of waiting for the warp's longest path. Warp w of W
//    owns the pixels ((j / 32) * W + w) * 32 + j % 32, j = 0, 1, ...: the
//    assignment is static and depends only on the data, so two launches
//    give the same bits (K3b's sum included), and the interleave spreads
//    the image's costly regions over all warps. A pixel's arithmetic is the
//    same as in a one-thread-per-pixel loop, so its 27 lanes keep their bits.
//  * The tables are staged once per CTA, with 16-byte loads, into dynamic
//    shared memory sized by the scene (the CornellBox: ~10 KB, not the caps'
//    42 KB), so registers alone set the occupancy. Each triangle's p0, e1,
//    e2 also go into a 48-byte record of three float4, so a test reads three
//    LDS.128 broadcasts instead of nine scalar loads from its 53-float row.
//  * What every BSDF evaluation at a vertex shares is computed once a vertex
//    (Vtx: E(|wi.z|), 103 flops, and the lobe-selection probabilities; the
//    plain version recomputes them in each call, five times a vertex, with
//    the same operations), and K3b takes d f / d diffuse from the lobe
//    values f was built from instead of a second component_weights.
//  * K3b keeps the replay's per-material U (the path's d log throughput /
//    d diffuse so far) and G (the thread's d loss / d diffuse) in the same
//    dynamic shared memory, one column per thread (conflict-free, indexed by
//    the runtime material id; no register array that would go to local
//    memory), and walks only the scene's materials. At the end each block
//    reduces its G (warp shuffles, then the warps in order) into one row of
//    a (rows, M, 3) partial buffer that the wrapper sums; the rows past the
//    grid are written as zeros. No atomics, so the result does not depend
//    on the order the blocks run in.
//  * Each kernel is built twice: with the main path's option switches as
//    constants (its dead branches compile away) and with runtime switches
//    for every other option set; the launch picks by the options.
// Outputs are one (27, N) float32 SoA tensor.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;
constexpr int kTriMax = 128, kMatMax = 32, kLightMax = 32, kGradMatMax = 16;
constexpr int kTriCols = 53, kMatCols = 52, kLightCols = 17, kCamCols = 24;
constexpr int kOut = 27;
constexpr int kKnots = 32;
constexpr int kNumOpts = 14;

// float32 values of the Python constants of the plain version
constexpr float kBig = 3e+38f;
constexpr float kInvPi = 0.31830987f;
constexpr float kPi = 3.1415927f;
constexpr float kTwoPi = 6.2831855f;
constexpr float kInv21 = 0.04761905f;
constexpr float kInv3 = 0.33333334f;
constexpr float kShadowScale = 0.999f;  // 1 - 1e-3
constexpr float kMinAlpha = 1e-04f;
constexpr float kDeltaPdf = 1e+30f;
constexpr float kInv2_32 = 0x1p-32f;
constexpr float kBelowOne = 0.99999994f;
constexpr float kEpsDet = 1e-12f;

struct Opts {
  int lobe[4];  // dr, dt, gr, gt
  int clearcoat, rr, rr_start, dims;
  int direct_nee, direct_bsdf, indirect_nee, indirect_bsdf, visible_lights;
  int max_path_length;  // >= 1
};

// The main path's option switches, (field, value): the lobes of a scene
// without transmission or coat, no clearcoat, RR, NEE and BSDF lighting at
// every vertex, visible lights. The kernels built with kMain take them as
// constants; main_switches picks those kernels.
#define MEGA_MAIN_SWITCHES(X)                                                                \
  X(lobe[0], 1) X(lobe[1], 0) X(lobe[2], 1) X(lobe[3], 0) X(clearcoat, 0) X(rr, 1)          \
  X(direct_nee, 1) X(direct_bsdf, 1) X(indirect_nee, 1) X(indirect_bsdf, 1)                 \
  X(visible_lights, 1)

inline bool main_switches(const Opts& o) {
#define MEGA_SWITCH_IS(f, v) &&o.f == (v)
  return true MEGA_MAIN_SWITCHES(MEGA_SWITCH_IS);
#undef MEGA_SWITCH_IS
}

template <bool kMain>
__device__ __forceinline__ void fix_switches(Opts& o) {
#define MEGA_SWITCH_SET(f, v) o.f = (v);
  if (kMain) {
    MEGA_MAIN_SWITCHES(MEGA_SWITCH_SET)
  }
#undef MEGA_SWITCH_SET
}

struct Scene {
  const float* tri;
  int n_tris;
  const float* mat;
  int n_mats;
  const float* light;
  int n_lights;
  const float* cam;
  uint32_t seed, inst;
  int res_x, n;
  Opts o;
};

// The block's shared copy of the scene tables
struct Tables {
  const float4* rec;   // (T, 3): p0, e1, e2 of each triangle (w unused)
  const float* tri;    // (T, 53)
  const float* mat;    // (M, 52)
  const float* light;  // (L, 17)
  const float* cam;    // (24,)
};

// Float offsets of the sections of the dynamic shared memory, each 16-byte
// aligned, sized by the scene's counts; U and G (K3b) are kBlock columns of
// 3 M floats each
struct Layout {
  int rec, tri, mat, light, cam, u, g, floats;
};

inline int up4(int x) { return (x + 3) & ~3; }

inline Layout layout_of(int n_tris, int n_mats, int n_lights, bool grad) {
  Layout l;
  l.rec = 0;
  l.tri = l.rec + 12 * n_tris;
  l.mat = l.tri + up4(n_tris * kTriCols);
  l.light = l.mat + up4(n_mats * kMatCols);
  l.cam = l.light + up4(n_lights * kLightCols);
  l.u = l.cam + up4(kCamCols);
  l.g = l.u + (grad ? 3 * n_mats * kBlock : 0);
  l.floats = l.g + (grad ? 3 * n_mats * kBlock : 0);
  return l;
}

// ---------------------------------------------------------------- math ----

__device__ __forceinline__ float clamp_min(float x, float lo) { return x != x ? x : fmaxf(x, lo); }
__device__ __forceinline__ float clamp_max(float x, float hi) { return x != x ? x : fminf(x, hi); }
__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float tmaximum(float a, float b) {  // torch.maximum
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

struct V3 {
  float x, y, z;
};
__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return V3{a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return V3{a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, float s) { return V3{a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ V3 neg(V3 a) { return V3{-a.x, -a.y, -a.z}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 normalize(V3 a) { return a * rsqrtf(clamp_min(dot(a, a), 1e-20f)); }
__device__ __forceinline__ V3 load3(const float* r, int c) { return V3{r[c], r[c + 1], r[c + 2]}; }
__device__ __forceinline__ float max_comp(V3 v) { return tmaximum(tmaximum(v.x, v.y), v.z); }

struct Frame {
  V3 t, b, n;
};

// orthonormal_basis (core/math.py): branchless Frisvad/Duff
__device__ __forceinline__ Frame frame_of(V3 n) {
  const float s = n.z >= 0.0f ? 1.0f : -1.0f;
  const float a = (1.0f / (s + n.z)) * -1.0f;
  const float b = n.x * n.y * a;
  return Frame{V3{1.0f + s * n.x * n.x * a, s * b, -s * n.x}, V3{b, s + n.y * n.y * a, -n.y}, n};
}
__device__ __forceinline__ V3 to_local(V3 v, const Frame& f) {
  return V3{dot(v, f.t), dot(v, f.b), dot(v, f.n)};
}
__device__ __forceinline__ V3 to_world(V3 v, const Frame& f) {
  return V3{v.x * f.t.x + v.y * f.b.x + v.z * f.n.x, v.x * f.t.y + v.y * f.b.y + v.z * f.n.y,
            v.x * f.t.z + v.y * f.b.z + v.z * f.n.z};
}

__device__ __forceinline__ float power_heuristic(float pdf_a, float pdf_b) {
  const float r = pdf_b / clamp_min(pdf_a, 1e-32f);
  return pdf_a > 0.0f ? 1.0f / (1.0f + r * r) : 0.0f;
}

__device__ __forceinline__ float safe_inv(float x) {
  return x > 0.0f ? 1.0f / (x <= 0.0f ? 1.0f : x) : 0.0f;
}

// ----------------------------------------------------------------- rng ----

__device__ __forceinline__ uint32_t hash_u32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}
__device__ __forceinline__ uint32_t hash_combine(uint32_t a, uint32_t b) {
  return hash_u32(a ^ (b + 0x9E3779B9u + (a << 6) + (a >> 2)));
}
__device__ __forceinline__ float uniform_from_bits(uint32_t bits) {
  const float hi = static_cast<float>(bits >> 16);
  const float lo = static_cast<float>(bits & 0xFFFFu);
  return fminf((hi * 65536.0f + lo) * kInv2_32, kBelowOne);
}
__device__ __forceinline__ uint32_t laine_karras(uint32_t x, uint32_t seed) {
  x += seed;
  x ^= x * 0x6C50B47Cu;
  x ^= x * 0xB82F1E52u;
  x ^= x * 0xC7AFE638u;
  x ^= x * 0x8D22F6E6u;
  return x;
}
__device__ __forceinline__ uint32_t owen_scramble(uint32_t x, uint32_t seed) {
  return __brev(laine_karras(__brev(x), seed));
}

// TiledSequence.sample_2d; `both` false skips the second dimension
__device__ void sample_2d(const Scene& sc, uint32_t pix, uint32_t dim, float* u0, float* u1,
                          bool both = true) {
  const uint32_t idx_seed = hash_combine(sc.seed, hash_combine(pix, dim >> 1));
  uint32_t i = owen_scramble(sc.inst, idx_seed);
  *u0 = uniform_from_bits(owen_scramble(__brev(i), hash_combine(idx_seed, 0x68BC21EBu)));
  if (!both) return;
  uint32_t d1 = 0u, v = 1u << 31;
  for (int k = 0; k < 32; ++k) {  // sobol02_u32, dimension 1
    if (i & 1u) d1 ^= v;
    i >>= 1;
    v ^= v >> 1;
  }
  *u1 = uniform_from_bits(owen_scramble(d1, hash_combine(idx_seed, 0x02E5BE93u)));
}
__device__ void sample_3d(const Scene& sc, uint32_t pix, uint32_t dim, float* u0, float* u1,
                          float* u2) {
  sample_2d(sc, pix, dim, u0, u1);
  const uint32_t k = hash_combine(sc.seed, hash_combine(pix, dim + 2u));
  *u2 = uniform_from_bits(hash_combine(k, sc.inst));
}

// ----------------------------------------------------------------- ggx ----

__device__ __forceinline__ float alpha_of(float roughness) {
  return clamp_min(roughness * roughness, kMinAlpha);
}
__device__ float ndf_d(float alpha, float nh) {
  nh = clamp_min(nh, 0.0f);
  const float a2 = alpha * alpha;
  const float d = nh * nh * (a2 - 1.0f) + 1.0f;
  return a2 / clamp_min(kPi * d * d, 1e-20f);
}
__device__ float smith_lambda(float alpha, float cos_t) {
  const float c = clampf(fabsf(cos_t), 1e-06f, 1.0f);
  const float s2 = clamp_min(1.0f - c * c, 0.0f);
  const float a2 = alpha * alpha;
  return 0.5f * (sqrtf(1.0f + a2 * s2 / (c * c)) - 1.0f);
}
__device__ float smith_g1(float alpha, float c) { return 1.0f / (1.0f + smith_lambda(alpha, c)); }
__device__ float smith_g2(float alpha, float ci, float co) {
  return 1.0f / (1.0f + smith_lambda(alpha, ci) + smith_lambda(alpha, co));
}
__device__ V3 sample_vndf(float alpha, V3 wi, float u0, float u1) {
  const V3 v = normalize(V3{alpha * wi.x, alpha * wi.y, wi.z});
  const float lensq = v.x * v.x + v.y * v.y;
  const float inv = rsqrtf(clamp_min(lensq, 1e-20f));
  const bool big = lensq > 1e-12f;
  const V3 t1{big ? -v.y * inv : 1.0f, big ? v.x * inv : 0.0f, 0.0f};
  const V3 t2{v.y * t1.z - v.z * t1.y, v.z * t1.x - v.x * t1.z, v.x * t1.y - v.y * t1.x};
  const float r = sqrtf(u0);
  const float phi = kTwoPi * u1;
  float sin_phi, cos_phi;
  sincosf(phi, &sin_phi, &cos_phi);
  const float p1 = r * cos_phi;
  float p2 = r * sin_phi;
  const float s = 0.5f * (1.0f + v.z);
  p2 = (1.0f - s) * sqrtf(clamp_min(1.0f - p1 * p1, 0.0f)) + s * p2;
  const float p3 = sqrtf(clamp_min(1.0f - p1 * p1 - p2 * p2, 0.0f));
  const V3 nh = t1 * p1 + t2 * p2 + v * p3;
  return normalize(V3{alpha * nh.x, alpha * nh.y, clamp_min(nh.z, 1e-06f)});
}
__device__ float vndf_pdf(float alpha, V3 wi, V3 h) {
  const float ci = fabsf(wi.z);
  const float g1 = smith_g1(alpha, wi.z);
  const float d = ndf_d(alpha, fabsf(h.z));
  return g1 * clamp_min(dot(wi, h), 0.0f) * d / clamp_min(ci, 1e-08f);
}
__device__ float reflect_eval(float alpha, V3 wi, V3 wo) {
  const float ci = wi.z, co = wo.z;
  const bool same = ci * co > 0.0f;
  V3 h = normalize(wi + wo);
  h = h * (h.z < 0.0f ? -1.0f : 1.0f);
  const float d = ndf_d(alpha, h.z);
  const float g = smith_g2(alpha, ci, co);
  const float f = d * g / clamp_min(4.0f * fabsf(ci) * fabsf(co), 1e-12f);
  return same ? f : 0.0f;
}
__device__ float reflect_pdf(float alpha, V3 wi, V3 wo) {
  const bool same = wi.z * wo.z > 0.0f;
  const float flip = wi.z < 0.0f ? -1.0f : 1.0f;
  const V3 wiu = wi * flip, wou = wo * flip;
  const V3 h = normalize(wiu + wou);
  const float ph = vndf_pdf(alpha, wiu, h);
  const float p = ph / clamp_min(4.0f * fabsf(dot(wiu, h)), 1e-12f);
  return same ? p : 0.0f;
}
__device__ V3 reflect_sample_dir(float alpha, V3 wi, float u0, float u1) {
  const float flip = wi.z < 0.0f ? -1.0f : 1.0f;
  const V3 wiu = wi * flip;
  const V3 h = sample_vndf(alpha, wiu, u0, u1);
  const V3 wou = h * (2.0f * dot(wiu, h)) - wiu;
  return wou * flip;
}
__device__ float refract_eval(float alpha, float ior, V3 wi, V3 wo) {
  const float ci = wi.z, co = wo.z;
  const bool opposite = ci * co < 0.0f;
  const float eta = ci > 0.0f ? ior : 1.0f / ior;
  V3 h = normalize(V3{wi.x + wo.x * eta, wi.y + wo.y * eta, wi.z + wo.z * eta});
  h = h * (h.z < 0.0f ? -1.0f : 1.0f);
  const float ih = dot(wi, h), oh = dot(wo, h);
  const float d = ndf_d(alpha, h.z);
  const float g = smith_g2(alpha, ci, co);
  const float denom = ih + eta * oh;
  const float jac = eta * eta * fabsf(oh) / clamp_min(denom * denom, 1e-12f);
  const float f = fabsf(ih) * jac * d * g / clamp_min(fabsf(ci) * fabsf(co), 1e-12f);
  return opposite ? f : 0.0f;
}
__device__ float refract_pdf(float alpha, float ior, V3 wi, V3 wo) {
  const float ci = wi.z, co = wo.z;
  const bool opposite = ci * co < 0.0f;
  const float eta = ci > 0.0f ? ior : 1.0f / ior;
  V3 h = normalize(V3{wi.x + wo.x * eta, wi.y + wo.y * eta, wi.z + wo.z * eta});
  h = h * (h.z < 0.0f ? -1.0f : 1.0f);
  const float flip = ci < 0.0f ? -1.0f : 1.0f;
  const V3 wiu = wi * flip;
  V3 hu = h * flip;
  hu = hu * (hu.z < 0.0f ? -1.0f : 1.0f);
  const float ph = vndf_pdf(alpha, wiu, hu);
  const float oh = dot(wo, h), ih = dot(wi, h);
  const float denom = ih + eta * oh;
  const float jac = eta * eta * fabsf(oh) / clamp_min(denom * denom, 1e-12f);
  return opposite ? ph * jac : 0.0f;
}
__device__ V3 refract_sample(float alpha, float ior, V3 wi, float u0, float u1, float* pdf) {
  const float flip = wi.z < 0.0f ? -1.0f : 1.0f;
  const V3 wiu = wi * flip;
  const V3 h = sample_vndf(alpha, wiu, u0, u1);
  const float eta_rel = wi.z > 0.0f ? 1.0f / ior : ior;
  const float ih = dot(wiu, h);
  const float sin2_t = eta_rel * eta_rel * clamp_min(1.0f - ih * ih, 0.0f);
  const bool tir = sin2_t >= 1.0f;
  const float cos_t = sqrtf(clamp_min(1.0f - sin2_t, 0.0f));
  const V3 wou = normalize((h * ih - wiu) * eta_rel - h * cos_t);
  const V3 wo = wou * flip;
  const float p = refract_pdf(alpha, ior, wi, wo);
  *pdf = tir ? 0.0f : p;
  return wo;
}

// ----------------------------------------------------------- composite ----

struct Bsdf {
  V3 diffuse, diffuse_trans, specular, reflectivity;
  float roughness, ior, opacity;
  const float* ec;  // the material's 33 E-PWL coefficients (shared memory)
};

__device__ __forceinline__ V3 f0_of(const Bsdf& p) { return p.specular * kInvPi; }

__device__ V3 schlick(float cos_t, V3 f0) {
  const float c = clampf(fabsf(cos_t), 0.0f, 1.0f);
  const float m = 1.0f - c;
  const float m2 = m * m;
  const float w = m2 * m2 * m;
  return V3{f0.x + (1.0f - f0.x) * w, f0.y + (1.0f - f0.y) * w, f0.z + (1.0f - f0.z) * w};
}

// e_fn of the megakernel (pallas_pt_mega.py:375-381): the exact 32-knot
// piecewise-linear rebuild of the bilinear albedo lookup at this roughness
__device__ float e_pwl(const float* ec, float cos_t) {
  const float c = clampf(fabsf(cos_t), 0.0f, 1.0f);
  float acc = ec[0];
#pragma unroll 8
  for (int j = 0; j < kKnots; ++j) {
    acc = acc + ec[1 + j] * clamp_min(c - (j + 0.5f) * (1.0f / kKnots), 0.0f);
  }
  return acc;
}

__device__ float e_glossy(const Bsdf& p, float cos_t) {
  const float e1 = e_pwl(p.ec, cos_t);
  const float f0m = max_comp(f0_of(p));
  float favg = f0m + (1.0f - f0m) * kInv21;
  favg = f0m <= 0.0f ? 0.0f : favg;
  const float e = clampf(e1 * favg, 0.0f, 1.0f);
  return p.ior == 0.0f ? 0.0f : e;
}

__device__ V3 clearcoat_fresnel(const Bsdf& p, V3 wi) {
  const float r0 = clamp_max(max_comp(p.reflectivity), 0.95f);
  const float sq = sqrtf(clamp_min(r0, 0.0f));
  const float ior_c = (1.0f + sq) / clamp_min(1.0f - sq, 1e-06f);
  const float ci = fabsf(wi.z);
  const float eta = 1.0f / ior_c;
  const float s2t = eta * eta * clamp_min(1.0f - ci * ci, 0.0f);
  const float ct = sqrtf(clamp_min(1.0f - s2t, 0.0f));
  const float rs = (ci - ior_c * ct) / clamp_min(ci + ior_c * ct, 1e-08f);
  const float rp = (ior_c * ci - ct) / clamp_min(ior_c * ci + ct, 1e-08f);
  const float f_s = 0.5f * (rs * rs + rp * rp);
  const float w = clampf((f_s - r0) / clamp_min(1.0f - r0, 1e-06f), 0.0f, 1.0f);
  const bool off = max_comp(p.reflectivity) <= 0.0f;
  const V3 r = p.reflectivity;
  return V3{off ? 0.0f : r.x + (1.0f - r.x) * w, off ? 0.0f : r.y + (1.0f - r.y) * w,
            off ? 0.0f : r.z + (1.0f - r.z) * w};
}

struct Weights {
  V3 r;  // glossy-reflection Fresnel r_coeff
  float w_d, w_dt, w_gt;
};

// e_i: e_glossy(p, |wi.z|) of the vertex (Vtx)
__device__ Weights component_weights(const Bsdf& p, float e_i, V3 wi, V3 wo) {
  const V3 h = normalize(wi + wo);
  float voh = fabsf(dot(wi, h));
  voh = isfinite(voh) ? voh : fabsf(wi.z);
  V3 r = schlick(voh, f0_of(p));
  if (p.ior == 0.0f) r = V3{0.0f, 0.0f, 0.0f};
  const float t = 1.0f - max_comp(r);
  const float k = (1.0f - e_i) * (1.0f - e_glossy(p, fabsf(wo.z)));
  const float w_d = t * p.opacity * k;
  return Weights{r, w_d, w_d, t * (1.0f - p.opacity)};
}

struct Probs {
  float dr, dt, gr, gt, cc;
};

__device__ Probs selection_probs(const Bsdf& p, float e_i, V3 wi, const Opts& o) {
  const float nov = fabsf(wi.z);
  float r_lum = max_comp(schlick(nov, f0_of(p)));
  r_lum = p.ior == 0.0f ? 0.0f : r_lum;
  const float t = 1.0f - r_lum;
  const float k = 1.0f - e_i;
  const float w_dr = o.lobe[0] ? t * p.opacity * k * max_comp(p.diffuse) : 0.0f;
  const float w_dt = o.lobe[1] ? t * p.opacity * k * max_comp(p.diffuse_trans) : 0.0f;
  const float w_gr = o.lobe[2] ? r_lum : 0.0f;
  const float w_gt = o.lobe[3] ? t * (1.0f - p.opacity) : 0.0f;
  const float total = w_dr + w_dt + w_gr + w_gt;
  const float inv = 1.0f / clamp_min(total, 1e-12f);
  const bool dead = total <= 1e-12f;
  Probs pr{dead ? 1.0f : w_dr * inv, dead ? 0.0f : w_dt * inv, dead ? 0.0f : w_gr * inv,
           dead ? 0.0f : w_gt * inv, 0.0f};
  if (o.clearcoat) {
    const V3 fc = clearcoat_fresnel(p, wi);
    pr.cc = (fc.x + fc.y + fc.z) * kInv3;
    const float s = 1.0f - pr.cc;
    pr.dr = pr.dr * s;
    pr.dt = pr.dt * s;
    pr.gr = pr.gr * s;
    pr.gt = pr.gt * s;
  }
  return pr;
}

// What every BSDF evaluation at one vertex (wi fixed) shares, computed once:
// E(|wi.z|) and the lobe-selection probabilities. The plain version
// recomputes them in each call, with the same operations, so the bits agree.
struct Vtx {
  float e_i;
  Probs pr;
};

__device__ Vtx vertex_terms(const Bsdf& p, V3 wi, const Opts& o) {
  Vtx v;
  v.e_i = e_glossy(p, fabsf(wi.z));
  v.pr = selection_probs(p, v.e_i, wi, o);
  return v;
}

struct Lobes {  // composite._lobe_values
  float alpha;
  V3 r;
  bool same;
  float abs_co, f_dr, f_dt, g_r, pdf_gr, g_t;
};

__device__ Lobes lobe_values(const Bsdf& p, const Vtx& v, V3 wi, V3 wo, const Opts& o) {
  Lobes l;
  l.alpha = alpha_of(p.roughness);
  const Weights cw = component_weights(p, v.e_i, wi, wo);
  l.r = cw.r;
  l.same = wi.z * wo.z > 0.0f;
  l.abs_co = fabsf(wo.z);
  l.f_dr = o.lobe[0] ? (l.same ? kInvPi : 0.0f) * cw.w_d : 0.0f;
  l.f_dt = o.lobe[1] ? (!l.same ? kInvPi : 0.0f) * cw.w_dt : 0.0f;
  l.g_r = o.lobe[2] ? reflect_eval(l.alpha, wi, wo) : 0.0f;
  l.pdf_gr = o.lobe[2] ? reflect_pdf(l.alpha, wi, wo) : 0.0f;
  l.g_t = o.lobe[3] ? refract_eval(l.alpha, p.ior, wi, wo) * cw.w_gt : 0.0f;
  return l;
}

__device__ float mix_pdf(const Bsdf& p, const Vtx& v, V3 wi, V3 wo, const Opts& o,
                         const Lobes& l) {
  const Probs& pr = v.pr;
  return pr.dr * (o.lobe[0] ? (l.same ? l.abs_co * kInvPi : 0.0f) : 0.0f) +
         pr.dt * (o.lobe[1] ? (!l.same ? l.abs_co * kInvPi : 0.0f) : 0.0f) + pr.gr * l.pdf_gr +
         pr.gt * (o.lobe[3] ? refract_pdf(l.alpha, p.ior, wi, wo) : 0.0f);
}

__device__ V3 coat(V3 f, V3 tc) {
  return V3{f.x * (1.0f - tc.x), f.y * (1.0f - tc.y), f.z * (1.0f - tc.z)};
}

// composite.diffuse_refl_unit (d f / d p.diffuse) from the lobe values of f at the same wo
__device__ V3 diffuse_refl_unit(const Bsdf& p, V3 wi, const Opts& o, const Lobes& l) {
  const V3 f{l.f_dr, l.f_dr, l.f_dr};
  return o.clearcoat ? coat(f, clearcoat_fresnel(p, wi)) : f;
}

// composite.f_split; *l: its lobe values at wo
__device__ void f_split(const Bsdf& p, const Vtx& v, V3 wi, V3 wo, const Opts& o, V3* fd,
                        V3* fg, float* pdf, Lobes* l_out) {
  const Lobes l = lobe_values(p, v, wi, wo, o);
  *fd = V3{p.diffuse.x * l.f_dr + p.diffuse_trans.x * l.f_dt,
           p.diffuse.y * l.f_dr + p.diffuse_trans.y * l.f_dt,
           p.diffuse.z * l.f_dr + p.diffuse_trans.z * l.f_dt};
  *fg = V3{l.r.x * l.g_r + l.g_t, l.r.y * l.g_r + l.g_t, l.r.z * l.g_r + l.g_t};
  if (o.clearcoat) {
    const V3 tc = clearcoat_fresnel(p, wi);
    *fd = coat(*fd, tc);
    *fg = coat(*fg, tc);
  }
  *pdf = mix_pdf(p, v, wi, wo, o, l);
  *l_out = l;
}

__device__ Lobes f_and_pdf(const Bsdf& p, const Vtx& v, V3 wi, V3 wo, const Opts& o, V3* f,
                           float* pdf) {
  const Lobes l = lobe_values(p, v, wi, wo, o);
  *f = V3{p.diffuse.x * l.f_dr + p.diffuse_trans.x * l.f_dt + l.r.x * l.g_r + l.g_t,
          p.diffuse.y * l.f_dr + p.diffuse_trans.y * l.f_dt + l.r.y * l.g_r + l.g_t,
          p.diffuse.z * l.f_dr + p.diffuse_trans.z * l.f_dt + l.r.z * l.g_r + l.g_t};
  if (o.clearcoat) *f = coat(*f, clearcoat_fresnel(p, wi));
  *pdf = mix_pdf(p, v, wi, wo, o, l);
  return l;
}

struct Sample {
  V3 wo, f, g;
  Lobes l;  // the lobe values of f at wo
  float pdf;
  int comp;
  bool valid;
};

// composite.sample: only the picked lobe's direction is computed (the plain
// version computes all and selects one; the values are the same)
__device__ Sample bsdf_sample(const Bsdf& p, const Vtx& v, V3 wi, float u0, float u1, float u2,
                              const Opts& o) {
  const Probs& pr = v.pr;
  const float alpha = alpha_of(p.roughness);
  const float side = wi.z >= 0.0f ? 1.0f : -1.0f;
  const float c0 = pr.dr, c1 = c0 + pr.dt, c2 = c1 + pr.gr, c3 = c2 + pr.gt;
  int comp = u2 < c0 ? 0 : u2 < c1 ? 1 : u2 < c2 ? 2 : u2 < c3 ? 3 : 4;
  if (!o.clearcoat) comp = min(comp, 3);
  // square_to_cosine_hemisphere
  const float r = sqrtf(u0);
  const float phi = kTwoPi * u1;
  float sin_phi, cos_phi;
  sincosf(phi, &sin_phi, &cos_phi);
  const V3 d_loc{r * cos_phi, r * sin_phi, sqrtf(clamp_min(1.0f - u0, 0.0f))};
  const V3 wo_dr{d_loc.x, d_loc.y, d_loc.z * side};
  Sample s;
  float pdf_gt_s = 1.0f;
  if (comp == 0) {
    s.wo = wo_dr;
  } else if (comp == 1) {
    s.wo = V3{d_loc.x, d_loc.y, -d_loc.z * side};
  } else if (comp == 2) {
    s.wo = o.lobe[2] ? reflect_sample_dir(alpha, wi, u0, u1) : wo_dr;
  } else if (comp == 3) {
    s.wo = o.lobe[3] ? refract_sample(alpha, p.ior, wi, u0, u1, &pdf_gt_s) : wo_dr;
  } else {  // clearcoat: mirror about the shading normal
    s.wo = V3{-wi.x, -wi.y, wi.z};
  }
  s.l = f_and_pdf(p, v, wi, s.wo, o, &s.f, &s.pdf);
  if (comp == 3 && pdf_gt_s <= 0.0f) s.pdf = 0.0f;  // TIR
  s.valid = s.pdf > 1e-12f;
  const float inv_pdf = s.valid ? 1.0f / s.pdf : 0.0f;
  const float cos_o = fabsf(s.wo.z);
  s.g = V3{s.f.x * cos_o * inv_pdf, s.f.y * cos_o * inv_pdf, s.f.z * cos_o * inv_pdf};
  if (comp == 4) {  // delta coat: g = Fc / p_cc, pdf = the delta stand-in
    const V3 fc = clearcoat_fresnel(p, wi);
    const float p_cc_safe = clamp_min(pr.cc, 1e-12f);
    const bool cc_ok = pr.cc > 1e-7f;
    s.g = cc_ok ? V3{fc.x / p_cc_safe, fc.y / p_cc_safe, fc.z / p_cc_safe} : V3{0.f, 0.f, 0.f};
    s.f = V3{0.0f, 0.0f, 0.0f};
    s.pdf = kDeltaPdf;
    s.valid = cc_ok;
  }
  s.comp = comp;
  return s;
}

// ---------------------------------------------------------------- trace ----

// Moller-Trumbore in the order of ops/trace.py:_mt (= pallas_pt_mega.py:244-265)
// on a triangle's record (p0, e1, e2)
__device__ __forceinline__ bool mt_inside(const float4* rec, V3 o, V3 d, float* t, float* u,
                                          float* v) {
  const float4 ra = rec[0], rb = rec[1], rc = rec[2];
  const float p0x = ra.x, p0y = ra.y, p0z = ra.z;
  const float e1x = rb.x, e1y = rb.y, e1z = rb.z;
  const float e2x = rc.x, e2y = rc.y, e2z = rc.z;
  const float pvx = d.y * e2z - d.z * e2y;
  const float pvy = d.z * e2x - d.x * e2z;
  const float pvz = d.x * e2y - d.y * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool det_ok = fabsf(det) > kEpsDet;
  const float inv_det = det_ok ? 1.0f / det : 0.0f;
  const float tvx = o.x - p0x, tvy = o.y - p0y, tvz = o.z - p0z;
  const float uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float vv = (d.x * qvx + d.y * qvy + d.z * qvz) * inv_det;
  *t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  *u = uu;
  *v = vv;
  return det_ok && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f;
}

// shadow any-hit in (0, t_lim); leaves at the first hit
__device__ bool any_hit(const Tables& s, int n_tris, V3 o, V3 d, float t_lim) {
  for (int k = 0; k < n_tris; ++k) {
    float t, u, v;
    if (mt_inside(&s.rec[3 * k], o, d, &t, &u, &v) && t > 0.0f && t < t_lim) return true;
  }
  return false;
}

__device__ __forceinline__ V3 offset_origin(V3 pos, V3 gn, V3 d, float eps) {
  const float side = dot(gn, d) >= 0.0f ? 1.0f : -1.0f;
  return V3{pos.x + gn.x * side * eps, pos.y + gn.y * side * eps, pos.z + gn.z * side * eps};
}

// ----------------------------------------------------------------- path ----

// What one vertex step needs of the steps before it
struct Path {
  V3 thr, org, d;
  V3 l[3];  // radiance: direct, diffuse, specular
  V3 adj;   // K3b: the pixel's adjoint
  float prev_pdf, rays;
  int channel, b;
  uint32_t pix;
};

__device__ __forceinline__ void add_routed(Path& ps, V3 c) {
  if (ps.channel == 0) {
    ps.l[0] = ps.l[0] + c;
  } else if (ps.channel == 1) {
    ps.l[1] = ps.l[1] + c;
  } else {
    ps.l[2] = ps.l[2] + c;
  }
}

// G[m] += sel * U[m] over the scene's materials (the replay's per-material
// accumulators: this thread's column, stride kBlock)
__device__ __forceinline__ void add_g(float* G, const float* U, int n_mats, V3 sel) {
  for (int m = 0; m < n_mats; ++m) {
    float* g = G + 3 * m * kBlock;
    const float* u = U + 3 * m * kBlock;
    g[0] = g[0] + sel.x * u[0];
    g[kBlock] = g[kBlock] + sel.y * u[kBlock];
    g[2 * kBlock] = g[2 * kBlock] + sel.z * u[2 * kBlock];
  }
}

__device__ __forceinline__ void put(float* out, int n, uint32_t pix, int lane, float v) {
  out[static_cast<size_t>(lane) * n + pix] = v;
}

// The G-buffer lanes 9-25 of the first vertex: depth, hit, n, p, uv, mat, da, sa
__device__ void put_gbuffer(float* out, int n, uint32_t pix, float depth, float hit, V3 nrm,
                            V3 pos, float uvx, float uvy, float mat, V3 da, V3 sa) {
  const float v[17] = {depth, hit, nrm.x, nrm.y, nrm.z, pos.x, pos.y, pos.z, uvx,
                       uvy,   mat, da.x,  da.y,  da.z,  sa.x,  sa.y,  sa.z};
#pragma unroll
  for (int k = 0; k < 17; ++k) put(out, n, pix, 9 + k, v[k]);
}

// A pixel's camera ray (pallas_pt_mega.py:453-471): the pixel goes int32 ->
// float32, times float32(1/res_x); K3b: the adjoint, and U cleared
template <bool kGrad>
__device__ void begin_path(const Tables& s, const Scene& sc, uint32_t pix,
                           const float* __restrict__ adjoint, float* U, Path& ps) {
  const float* cam = s.cam;
  const V3 cu = load3(cam, 3), cv = load3(cam, 6), cw = load3(cam, 9);
  const float inv_rx = cam[17], inv_ry = cam[18];
  float jx, jy;
  sample_2d(sc, pix, 0u, &jx, &jy);
  const uint32_t rx = static_cast<uint32_t>(sc.res_x);
  const float pxf = static_cast<float>(static_cast<int>(pix % rx));
  const float pyf = static_cast<float>(static_cast<int>(pix / rx));
  const float dx_c = (pxf + jx) * inv_rx * 2.0f - 1.0f;
  const float dy_c = (pyf + jy) * inv_ry * 2.0f - 1.0f;
  ps.d = normalize(V3{dx_c * cu.x + dy_c * cv.x + cw.x, dx_c * cu.y + dy_c * cv.y + cw.y,
                      dx_c * cu.z + dy_c * cv.z + cw.z});
  ps.org = load3(cam, 0);
  ps.thr = V3{1.0f, 1.0f, 1.0f};
  ps.l[0] = ps.l[1] = ps.l[2] = V3{0.0f, 0.0f, 0.0f};
  ps.prev_pdf = 0.0f;
  ps.rays = 0.0f;
  ps.channel = 0;
  ps.b = 0;
  ps.pix = pix;
  if (kGrad) {
    ps.adj = V3{__ldg(adjoint + 3 * static_cast<size_t>(pix)),
                __ldg(adjoint + 3 * static_cast<size_t>(pix) + 1),
                __ldg(adjoint + 3 * static_cast<size_t>(pix) + 2)};
    for (int k = 0; k < 3 * sc.n_mats; ++k) U[k * kBlock] = 0.0f;
  }
}

// One vertex of a path: one iteration of _mega_kernel's shade_bounce loop
// (pallas_pt_mega.py:489-684), with the replay terms of _mega_grad_kernel
// (:812-975) when kGrad. K3a writes the G-buffer at the first vertex.
// Returns true when the path has ended.
template <bool kGrad>
__device__ bool step_path(const Tables& s, const Scene& sc, Path& ps, float* __restrict__ out,
                          float* U, float* G) {
  const Opts& o = sc.o;
  const float* cam = s.cam;
  const V3 env = load3(cam, 12);
  const float eps = cam[15];
  const int b = ps.b;
  const bool first = b == 0;
  const V3 thr = ps.thr, d = ps.d;
  ps.rays += 1.0f;
  // closest hit: strict tt < tb in index order keeps the lowest index on ties
  int best = -1;
  float tb = kBig, ub = 0.0f, vb = 0.0f;
  for (int k = 0; k < sc.n_tris; ++k) {
    float t, u, v;
    if (mt_inside(&s.rec[3 * k], ps.org, d, &t, &u, &v) && t > eps && t < tb) {
      tb = t;
      ub = u;
      vb = v;
      best = k;
    }
  }
  if (best < 0) {  // constant environment on a miss; the path ends
    add_routed(ps, V3{thr.x * env.x, thr.y * env.y, thr.z * env.z});
    if (kGrad) {
      const V3 adj = ps.adj;
      add_g(G, U, sc.n_mats,
            V3{adj.x * thr.x * env.x, adj.y * thr.y * env.y, adj.z * thr.z * env.z});
    } else if (first) {  // a miss: depth +inf, hit flag -1, material -1
      const V3 z{0.0f, 0.0f, 0.0f};
      put_gbuffer(out, sc.n, ps.pix, __int_as_float(0x7f800000), -1.0f, z, z, 0.0f, 0.0f,
                  -1.0f, z, z);
    }
    return true;
  }
  const float* row = &s.tri[best * kTriCols];
  const V3 p0 = load3(row, 0), e1 = load3(row, 3), e2 = load3(row, 6), gn = load3(row, 9);
  const V3 n0 = load3(row, 12), n1 = load3(row, 15), n2 = load3(row, 18);
  const float midf = row[27], pdf_area_hit = row[52];
  const V3 pos{p0.x + e1.x * ub + e2.x * vb, p0.y + e1.y * ub + e2.y * vb,
               p0.z + e1.z * ub + e2.z * vb};
  const float w = 1.0f - ub - vb;
  const V3 sn = normalize(V3{n0.x * w + n1.x * ub + n2.x * vb, n0.y * w + n1.y * ub + n2.y * vb,
                             n0.z * w + n1.z * ub + n2.z * vb});
  const V3 wi = neg(d);
  const float flip = dot(gn, wi) < 0.0f ? -1.0f : 1.0f;
  const V3 sn_f = sn * flip;
  const Frame fr = frame_of(sn_f);
  const V3 wi_loc = to_local(wi, fr);
  // material row by round(mat id); the clamp only keeps a corrupt table
  // inside shared memory (build_mega_tables checks the ids)
  const int mid = min(max(__float2int_rn(midf), 0), sc.n_mats - 1);
  const float* mrow = &s.mat[mid * kMatCols];
  const Bsdf p{load3(mrow, 0), load3(mrow, 9), load3(mrow, 3), load3(mrow, 12),
               mrow[15], mrow[16], mrow[17], mrow + 19};
  const V3 emissive = load3(mrow, 6);
  const Vtx vt = vertex_terms(p, wi_loc, o);
  if (!kGrad && first) {  // G-buffer at the first hit; `hit` is a flag (:521)
    put_gbuffer(out, sc.n, ps.pix, tb, 1.0f, sn_f, pos, row[21] * w + row[23] * ub + row[25] * vb,
                row[22] * w + row[24] * ub + row[26] * vb, midf, p.diffuse, p.specular);
  }

  // emissive hit + MIS (:539-572)
  const bool show = first ? o.visible_lights : (o.direct_bsdf || o.indirect_bsdf);
  if (show) {
    const V3 le = dot(gn, wi) > 0.0f ? emissive : V3{0.0f, 0.0f, 0.0f};
    float w_mis = 1.0f;
    if (!first) {
      const bool is_direct = b == 1;
      const float dist2 = tb * tb;
      const float cos_l = fabsf(dot(gn, wi));
      const float pdf_sa = pdf_area_hit * dist2 / clamp_min(cos_l, 1e-08f);
      const bool nee_mask = is_direct ? o.direct_nee : o.indirect_nee;
      w_mis = nee_mask ? power_heuristic(ps.prev_pdf, pdf_sa) : 1.0f;
      const bool show_mask = is_direct ? o.direct_bsdf : o.indirect_bsdf;
      w_mis = w_mis * (show_mask ? 1.0f : 0.0f);
    }
    add_routed(ps, V3{thr.x * le.x * w_mis, thr.y * le.y * w_mis, thr.z * le.z * w_mis});
    if (kGrad) {
      const V3 adj = ps.adj;
      add_g(G, U, sc.n_mats,
            V3{adj.x * thr.x * le.x * w_mis, adj.y * thr.y * le.y * w_mis,
               adj.z * thr.z * le.z * w_mis});
    }
  }

  // NEE: CDF pick over the emissive subset, shadow any-hit (:574-627)
  const uint32_t base_dim = 2u + static_cast<uint32_t>(b) * static_cast<uint32_t>(o.dims);
  const bool nee_on = first ? o.direct_nee : o.indirect_nee;
  if (nee_on) {
    float ul0, ul1, ul2;
    sample_3d(sc, ps.pix, base_dim, &ul0, &ul1, &ul2);
    int idx = 0;
    for (int k = 0; k < sc.n_lights; ++k) idx += s.light[k * kLightCols + 16] <= ul2 ? 1 : 0;
    const float* lrow = &s.light[min(idx, sc.n_lights - 1) * kLightCols];
    const float su0 = sqrtf(ul0);
    const float b0 = 1.0f - su0, b1 = ul1 * su0;
    const V3 lp0 = load3(lrow, 0), le1 = load3(lrow, 3), le2 = load3(lrow, 6);
    const V3 lpos{lp0.x + le1.x * b0 + le2.x * b1, lp0.y + le1.y * b0 + le2.y * b1,
                  lp0.z + le1.z * b0 + le2.z * b1};
    const V3 ln = load3(lrow, 9), lle = load3(lrow, 12);
    const float lpdf_a = lrow[15];
    const V3 to_l = lpos - pos;
    const float dist2 = clamp_min(dot(to_l, to_l), 1e-12f);
    const float dist = sqrtf(dist2);
    const V3 wo{to_l.x / dist, to_l.y / dist, to_l.z / dist};
    const float cos_l = dot(ln, neg(wo));
    const V3 wo_loc = to_local(wo, fr);
    V3 fd, fg;
    float bsdf_pdf;
    Lobes lv;
    f_split(p, vt, wi_loc, wo_loc, o, &fd, &fg, &bsdf_pdf, &lv);
    const float pdf_sa = lpdf_a * dist2 / clamp_min(fabsf(cos_l), 1e-08f);
    const bool bsdf_on = first ? o.direct_bsdf : o.indirect_bsdf;
    const float w_mis = bsdf_on ? power_heuristic(pdf_sa, bsdf_pdf) : 1.0f;
    const float cos_s = fabsf(wo_loc.z);
    const bool able = cos_l > 1e-06f && pdf_sa > 1e-12f &&
                      (fd.x + fd.y + fd.z + fg.x + fg.y + fg.z) > 0.0f;
    if (able) {
      const V3 so = offset_origin(pos, gn, wo, eps);
      const bool occluded = any_hit(s, sc.n_tris, so, wo, dist * kShadowScale);
      ps.rays += 1.0f;
      if (!occluded) {
        const float scale = cos_s * w_mis / clamp_min(pdf_sa, 1e-12f);
        const float wX = thr.x * lle.x * scale, wY = thr.y * lle.y * scale,
                    wZ = thr.z * lle.z * scale;
        if (first) {  // split routing: diffuse part -> diffuse, glossy -> specular
          ps.l[1] = ps.l[1] + V3{fd.x * wX, fd.y * wY, fd.z * wZ};
          ps.l[2] = ps.l[2] + V3{fg.x * wX, fg.y * wY, fg.z * wZ};
        } else {
          add_routed(ps, V3{(fd.x + fg.x) * wX, (fd.y + fg.y) * wY, (fd.z + fg.z) * wZ});
        }
        if (kGrad) {  // the NEE vertex's local factor kd / f (:916-932)
          const V3 adj = ps.adj;
          const V3 kd = diffuse_refl_unit(p, wi_loc, o, lv);
          const V3 ft{fd.x + fg.x, fd.y + fg.y, fd.z + fg.z};
          const V3 nn{adj.x * ft.x * wX, adj.y * ft.y * wY, adj.z * ft.z * wZ};
          const V3 lo{nn.x * kd.x * safe_inv(ft.x), nn.y * kd.y * safe_inv(ft.y),
                      nn.z * kd.z * safe_inv(ft.z)};
          add_g(G, U, sc.n_mats, nn);
          float* g = G + 3 * mid * kBlock;  // then + lo at this vertex's material
          g[0] = g[0] + lo.x;
          g[kBlock] = g[kBlock] + lo.y;
          g[2 * kBlock] = g[2 * kBlock] + lo.z;
        }
      }
    }
  }

  // BSDF scatter + Russian roulette (:629-648); before rr_start_bounce
  // q = 1 keeps the lane and scales by exactly 1, so u_rr is not drawn
  float ub0, ub1, ub2;
  sample_3d(sc, ps.pix, base_dim + 3u, &ub0, &ub1, &ub2);
  const Sample smp = bsdf_sample(p, vt, wi_loc, ub0, ub1, ub2, o);
  const V3 wo_world = to_world(smp.wo, fr);
  V3 new_thr{thr.x * smp.g.x, thr.y * smp.g.y, thr.z * smp.g.z};
  bool new_alive = smp.valid && (smp.g.x + smp.g.y + smp.g.z) > 0.0f;
  if (o.rr && !first && b >= o.rr_start) {
    float u_rr, unused;
    sample_2d(sc, ps.pix, base_dim + 6u, &u_rr, &unused, false);
    const float q = clampf(tmaximum(tmaximum(new_thr.x, new_thr.y), new_thr.z), 0.05f, 1.0f);
    new_alive = new_alive && u_rr < q;
    new_thr = new_thr * (1.0f / q);
  }
  if (kGrad && new_alive) {  // d log(thr g) / d a here: kd(wo) / f(wo) (:955-965)
    const V3 kd_s = diffuse_refl_unit(p, wi_loc, o, smp.l);
    float* u = U + 3 * mid * kBlock;
    u[0] = u[0] + kd_s.x * safe_inv(smp.f.x);
    u[kBlock] = u[kBlock] + kd_s.y * safe_inv(smp.f.y);
    u[2 * kBlock] = u[2 * kBlock] + kd_s.z * safe_inv(smp.f.z);
  }
  if (first) ps.channel = smp.comp >= 2 ? 2 : 1;  // glossy lobes -> specular
  if (!new_alive) return true;
  ps.thr = new_thr;
  ps.org = offset_origin(pos, gn, wo_world, eps);
  ps.d = wo_world;
  ps.prev_pdf = smp.pdf;
  ps.b = b + 1;
  return ps.b >= o.max_path_length;
}

// K3a: the radiance lanes 0-8 and the ray count (lane 26) of an ended path
__device__ void put_radiance(float* out, int n, const Path& ps) {
  const float v[9] = {ps.l[0].x, ps.l[0].y, ps.l[0].z, ps.l[1].x, ps.l[1].y,
                      ps.l[1].z, ps.l[2].x, ps.l[2].y, ps.l[2].z};
#pragma unroll
  for (int k = 0; k < 9; ++k) put(out, n, ps.pix, k, v[k]);
  put(out, n, ps.pix, kOut - 1, ps.rays);
}

// This thread's paths. Warp w of the grid's W warps owns the pixels
// ((j / 32) * W + w) * 32 + j % 32, j = 0, 1, ... At each step the lanes
// without a path take the warp's next j in lane order (ballot and popc), then
// every lane with a path runs one vertex; the warp leaves when its pixels
// are done.
template <bool kGrad>
__device__ void run_paths(const Tables& s, const Scene& sc, float* __restrict__ out,
                          const float* __restrict__ adjoint, float* U, float* G) {
  const unsigned lane = threadIdx.x & 31u;
  const long long warps = static_cast<long long>(gridDim.x) * (kBlock / 32);
  const long long warp = static_cast<long long>(blockIdx.x) * (kBlock / 32) + (threadIdx.x >> 5);
  Path ps;
  bool live = false;
  long long next = 0;  // the warp's next j
  for (;;) {
    const unsigned idle = __ballot_sync(0xffffffffu, !live);
    if (!live) {
      const long long j = next + __popc(idle & ((1u << lane) - 1u));
      const long long pix = ((j >> 5) * warps + warp) * 32 + (j & 31);
      if (pix < sc.n) {
        begin_path<kGrad>(s, sc, static_cast<uint32_t>(pix), adjoint, U, ps);
        live = true;
      }
    }
    next += __popc(idle);
    if (!__any_sync(0xffffffffu, live)) return;
    if (live && step_path<kGrad>(s, sc, ps, out, U, G)) {
      if (!kGrad) put_radiance(out, sc.n, ps);
      live = false;
    }
  }
}

// Copies count floats into shared memory, 16 bytes a load where src is
// 16-byte aligned (dst always is)
__device__ void copy_floats(float* dst, const float* __restrict__ src, int count) {
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0u) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    const int n4 = count >> 2;
    for (int k = threadIdx.x; k < n4; k += kBlock) d4[k] = __ldg(s4 + k);
    done = n4 << 2;
  }
  for (int k = done + threadIdx.x; k < count; k += kBlock) dst[k] = __ldg(src + k);
}

__device__ Tables stage_tables(float* smem, const Scene& sc, const Layout& ly) {
  copy_floats(smem + ly.tri, sc.tri, sc.n_tris * kTriCols);
  copy_floats(smem + ly.mat, sc.mat, sc.n_mats * kMatCols);
  copy_floats(smem + ly.light, sc.light, sc.n_lights * kLightCols);
  copy_floats(smem + ly.cam, sc.cam, kCamCols);
  float4* rec = reinterpret_cast<float4*>(smem + ly.rec);
  for (int k = threadIdx.x; k < 3 * sc.n_tris; k += kBlock) {
    const float* r = sc.tri + (k / 3) * kTriCols + (k % 3) * 3;
    rec[k] = make_float4(__ldg(r), __ldg(r + 1), __ldg(r + 2), 0.0f);
  }
  __syncthreads();
  return Tables{rec, smem + ly.tri, smem + ly.mat, smem + ly.light, smem + ly.cam};
}

template <bool kMain>
__global__ void __launch_bounds__(kBlock)
mega_forward_kernel(Scene sc, Layout ly, float* __restrict__ out) {
  extern __shared__ float4 smem4[];
  fix_switches<kMain>(sc.o);
  const Tables s = stage_tables(reinterpret_cast<float*>(smem4), sc, ly);
  run_paths<false>(s, sc, out, nullptr, nullptr, nullptr);
}

template <bool kMain>
__global__ void __launch_bounds__(kBlock)
mega_grad_kernel(Scene sc, Layout ly, const float* __restrict__ adjoint,
                 float* __restrict__ partial, int rows) {
  extern __shared__ float4 smem4[];
  __shared__ float red[kBlock / 32][kGradMatMax * 3];
  fix_switches<kMain>(sc.o);
  float* smem = reinterpret_cast<float*>(smem4);
  const Tables s = stage_tables(smem, sc, ly);
  float* U = smem + ly.u + threadIdx.x;
  float* G = smem + ly.g + threadIdx.x;
  const int k3 = 3 * sc.n_mats;
  for (int k = 0; k < k3; ++k) G[k * kBlock] = 0.0f;
  run_paths<true>(s, sc, nullptr, adjoint, U, G);
  // block sum of G: warp shuffles, then the warps in order (deterministic)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < k3; ++k) {
    float v = G[k * kBlock];
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    if (lane == 0) red[warp][k] = v;
  }
  __syncthreads();
  const int k = threadIdx.x;
  if (k < k3) {
    float acc = 0.0f;
    for (int wv = 0; wv < kBlock / 32; ++wv) acc += red[wv][k];
    partial[static_cast<size_t>(blockIdx.x) * k3 + k] = acc;
    for (int r = gridDim.x + blockIdx.x; r < rows; r += gridDim.x) {
      partial[static_cast<size_t>(r) * k3 + k] = 0.0f;  // rows past the grid
    }
  }
}

// opts: the kNumOpts ints of ops/pt_mega.py:_opt_vector
Opts opts_of(const int* opts) {
  Opts o;
  for (int k = 0; k < 4; ++k) o.lobe[k] = opts[k];
  o.clearcoat = opts[4];
  o.rr = opts[5];
  o.rr_start = opts[6];
  o.dims = opts[7];
  o.direct_nee = opts[8];
  o.direct_bsdf = opts[9];
  o.indirect_nee = opts[10];
  o.indirect_bsdf = opts[11];
  o.visible_lights = opts[12];
  o.max_path_length = opts[13] < 1 ? 1 : opts[13];
  return o;
}

int make_scene(Scene* sc, const float* tri, int n_tris, const float* mat, int n_mats,
               const float* light, int n_lights, const float* cam, unsigned seed, unsigned inst,
               int res_x, int n, const int* opts) {
  if (n_tris <= 0 || n_tris > kTriMax || n_mats <= 0 || n_mats > kMatMax || n_lights <= 0 ||
      n_lights > kLightMax || res_x <= 0 || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  *sc = Scene{tri, n_tris, mat, n_mats, light, n_lights, cam, seed, inst, res_x, n, opts_of(opts)};
  return 0;
}

// The persistent grid: as many blocks as fit on the card at once with smem
// bytes of dynamic shared memory each, or one per kBlock pixels if fewer
template <typename Kernel>
cudaError_t path_grid(Kernel kernel, size_t smem, int n, int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess && smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBlock, smem);
  }
  if (err != cudaSuccess) return err;
  const int want = (n + kBlock - 1) / kBlock;
  const int fit = sms * per_sm > 0 ? sms * per_sm : 1;
  *grid = want < fit ? want : fit;
  return cudaSuccess;
}

static_assert(kNumOpts == 14, "option vector layout (ops/pt_mega.py:_opt_vector)");
static_assert(kBlock % 32 == 0 && (3 * kBlock) % 4 == 0, "whole warps; 16-byte sections");

}  // namespace

extern "C" const char* fermat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// 1 if K3a/K3b run these options (the 14 ints of ops/pt_mega.py:_opt_vector)
// on their build with the main path's switches as constants, else 0
extern "C" int fermat_mega_main_switches(const int* opts) {
  return main_switches(opts_of(opts)) ? 1 : 0;
}

// K3a: out (27, n) f32; opts: the 14 ints of ops/pt_mega.py:_opt_vector
extern "C" int fermat_mega_forward(const float* tri, int n_tris, const float* mat, int n_mats,
                                   const float* light, int n_lights, const float* cam,
                                   unsigned seed, unsigned inst, int res_x, int n,
                                   const int* opts, float* out, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Scene sc;
  const int bad = make_scene(&sc, tri, n_tris, mat, n_mats, light, n_lights, cam, seed, inst,
                             res_x, n, opts);
  if (bad) return bad;
  if (n == 0) return 0;
  const Layout ly = layout_of(n_tris, n_mats, n_lights, false);
  const size_t smem = static_cast<size_t>(ly.floats) * sizeof(float);
  int grid = 0;
  const auto kernel = main_switches(sc.o) ? mega_forward_kernel<true> : mega_forward_kernel<false>;
  err = path_grid(kernel, smem, n, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kBlock, smem, stream>>>(sc, ly, out);
  return static_cast<int>(cudaGetLastError());
}

// K3b: adjoint (n, 3) f32 -> partial (blocks, n_mats, 3) f32, blocks = max(ceil(n/128), 1);
// the persistent grid fills its first rows, the rest are zeros
extern "C" int fermat_mega_grad(const float* tri, int n_tris, const float* mat, int n_mats,
                                const float* light, int n_lights, const float* cam,
                                unsigned seed, unsigned inst, int res_x, int n, const int* opts,
                                const float* adjoint, float* partial, int blocks, int device,
                                cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Scene sc;
  const int bad = make_scene(&sc, tri, n_tris, mat, n_mats, light, n_lights, cam, seed, inst,
                             res_x, n, opts);
  if (bad) return bad;
  const int want = n > 0 ? (n + kBlock - 1) / kBlock : 1;
  if (n_mats > kGradMatMax || blocks != want) return static_cast<int>(cudaErrorInvalidValue);
  const Layout ly = layout_of(n_tris, n_mats, n_lights, true);
  const size_t smem = static_cast<size_t>(ly.floats) * sizeof(float);
  int grid = 0;
  const auto kernel = main_switches(sc.o) ? mega_grad_kernel<true> : mega_grad_kernel<false>;
  err = path_grid(kernel, smem, n, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (grid < 1) grid = 1;
  kernel<<<grid, kBlock, smem, stream>>>(sc, ly, adjoint, partial, blocks);
  return static_cast<int>(cudaGetLastError());
}
