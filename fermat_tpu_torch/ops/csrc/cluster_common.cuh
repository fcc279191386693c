// The arithmetic that the cluster-table tracers share: frontier.cu (K5),
// cluster.cu (K6) and binned.cu (K7). Each kernel equals the shared plain
// PyTorch versions of ops/frontier_trace.py bit for bit only while it rounds
// exactly as they do, so the ray set-up, the slab entry with its margin E'
// and the Moller-Trumbore test live here once, in the operation order of
// frontier_trace.py cluster_entries / _slack and trace.py mt_test. Build
// with --fmad=false. ops/_cuda.py keys each library on the bytes of the
// headers its source includes, so an edit here rebuilds all three.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCluster = 128;  // triangle slots of a cluster
constexpr int kRowFloat4 = 3;  // one 48-byte row per slot: p0 e1 e2 id 0 0
constexpr float kEpsDet = 1e-12f;
constexpr float kSlackMul = 1.0f - 0.0009765625f;  // 1 - 2^-10, exact
constexpr float kSlackAdd = 0.000244140625f;       // 2^-12
constexpr int kIntMax = 0x7fffffff;

__device__ __forceinline__ float inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ float inv_dir(float c) {
  return fabsf(c) > 1e-20f ? 1.0f / c : (c >= 0.0f ? 1e20f : -1e20f);
}

struct Ray {
  float ox, oy, oz, dx, dy, dz;
  float ix, iy, iz;  // guarded reciprocal directions
  float tmin, tmax;
};

struct RayPtrs {
  const float *ox, *oy, *oz, *dx, *dy, *dz, *tmin, *tmax;
  const uint8_t* active;  // null where the caller has compacted the live rays
};

__device__ __forceinline__ Ray load_ray(const RayPtrs& p, int i) {
  Ray r;
  r.ox = p.ox[i];
  r.oy = p.oy[i];
  r.oz = p.oz[i];
  r.dx = p.dx[i];
  r.dy = p.dy[i];
  r.dz = p.dz[i];
  r.ix = inv_dir(r.dx);
  r.iy = inv_dir(r.dy);
  r.iz = inv_dir(r.dz);
  r.tmin = p.tmin[i];
  r.tmax = p.tmax[i];
  return r;
}

// Slab test of box (lo, hi) within [tmin, tmax]: E' of the entry in *e,
// true when the ray meets the box.
__device__ __forceinline__ bool slab(const Ray& r, float lox, float loy, float loz,
                                     float hix, float hiy, float hiz, float* e) {
  const float t0x = (lox - r.ox) * r.ix;
  const float t1x = (hix - r.ox) * r.ix;
  const float t0y = (loy - r.oy) * r.iy;
  const float t1y = (hiy - r.oy) * r.iy;
  const float t0z = (loz - r.oz) * r.iz;
  const float t1z = (hiz - r.oz) * r.iz;
  const float near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fmaxf(fminf(t0z, t1z), r.tmin));
  const float far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                          fminf(fmaxf(t0z, t1z), r.tmax));
  *e = near * kSlackMul - kSlackAdd;
  return near <= far && lox <= hix;
}

// A cluster entered as cluster_entries counts it: a met box with finite E'.
__device__ __forceinline__ bool entered(const Ray& r, float lox, float loy, float loz,
                                        float hix, float hiy, float hiz, float* e) {
  return slab(r, lox, loy, loz, hix, hiy, hiz, e) && *e < inf();
}

// Moller-Trumbore against a row (p0 e1 e2 of float4 a, b, c): t, u, v, and
// true for a hit with tmin < t < tmax.
__device__ __forceinline__ bool hit_test(const Ray& r, float4 a, float4 b, float4 c,
                                         float* t, float* u, float* v) {
  const float p0x = a.x, p0y = a.y, p0z = a.z;
  const float e1x = a.w, e1y = b.x, e1z = b.y;
  const float e2x = b.z, e2y = b.w, e2z = c.x;
  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  const bool det_ok = fabsf(det) > kEpsDet;
  const float inv_det = det_ok ? 1.0f / det : 0.0f;
  const float tvx = r.ox - p0x;
  const float tvy = r.oy - p0y;
  const float tvz = r.oz - p0z;
  const float uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float vv = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;
  const float tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  *t = tt;
  *u = uu;
  *v = vv;
  return det_ok && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > r.tmin &&
         tt < r.tmax;
}

}  // namespace
