// K1a / K1b: dense closest-hit and any-hit ray casting against a whole
// triangle soup of at most a few thousand triangles (Moller-Trumbore).
//
// Replaces fermat_tpu/ops/pallas_trace.py: _trace_kernel (:65, launched by
// _trace_impl :146) and _any_kernel (:213, launched by _any_impl :264). The
// Pallas kernels put rays on sublanes and 128 triangles on lanes and take a
// lane argmin, because Mosaic has no per-lane control flow. Here each thread
// owns one ray and walks the triangles in order, so the TPU layout is gone
// while the function stays the same:
//   * an inactive lane gets tmax = -1 and is a guaranteed miss
//     (pallas_trace.py:198-200); it skips the loop;
//   * a hit needs tmin < t < t_best; on equal t the lowest triangle index
//     wins (the first column inside a tile, strict compares across tiles,
//     pallas_trace.py:109-129): a strict `<` in index order is the same rule;
//   * inv_det = |det| > 1e-12 ? 1/det : 0 (pallas_trace.py:97-99);
//   * a miss returns t = tmax (the caller's, not -1), tri = -1, u = v = 0;
//   * any-hit returns occ & active and stops a ray at its first hit.
// The arithmetic is written in the order of the plain PyTorch version and
// built with --fmad=false, so both round identically on the card.
//
// Bound on H100: for the path's 36-triangle scene, bytes (8 floats + 1 flag
// in, 16 bytes out per ray); for thousands of triangles, FP32 operations
// (~45 per ray-triangle test). Design: the soup is staged through shared
// memory 128 triangles at a time (9 floats each, read by all threads of the
// block as broadcasts), so global memory sees each ray once and each
// triangle once per block.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kTile = 128;
constexpr float kEpsDet = 1e-12f;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

__device__ __forceinline__ void load_tile(float (*s)[kTile], const float* __restrict__ tris,
                                          int n_tris, int base) {
  const int n = min(kTile, n_tris - base);
  for (int k = threadIdx.x; k < 9 * kTile; k += kBlock) {
    const int row = k / kTile;
    const int col = k - row * kTile;
    s[row][col] = col < n ? tris[row * n_tris + base + col] : 0.0f;
  }
}

// Moller-Trumbore against triangle `c` of the staged tile; same operation
// order as fermat_tpu_torch/ops/trace.py:_mt.
__device__ __forceinline__ bool hit_test(float (*s)[kTile], int c, const Ray& r,
                                         float tmin, float tmax, float* t,
                                         float* u, float* v) {
  const float p0x = s[0][c], p0y = s[1][c], p0z = s[2][c];
  const float e1x = s[3][c], e1y = s[4][c], e1z = s[5][c];
  const float e2x = s[6][c], e2y = s[7][c], e2z = s[8][c];
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
  return det_ok && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > tmin && tt < tmax;
}

struct RayPtrs {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
};

__device__ __forceinline__ Ray load_ray(const RayPtrs& p, int i) {
  return Ray{p.ox[i], p.oy[i], p.oz[i], p.dx[i], p.dy[i], p.dz[i]};
}

__global__ void __launch_bounds__(kBlock)
closest_kernel(RayPtrs ray, const float* __restrict__ tmin,
               const float* __restrict__ tmax, const uint8_t* __restrict__ active,
               const float* __restrict__ tris, int n_tris, int n,
               float* __restrict__ t_out, int* __restrict__ tri_out,
               float* __restrict__ u_out, float* __restrict__ v_out) {
  __shared__ float s[9][kTile];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n;
  const bool work = live && active[i] != 0;
  Ray r{};
  float lo = 0.0f, t_best = -1.0f;
  if (work) {
    r = load_ray(ray, i);
    lo = tmin[i];
    t_best = tmax[i];
  }
  int best = -1;
  float bu = 0.0f, bv = 0.0f;
  for (int base = 0; base < n_tris; base += kTile) {
    if (!__syncthreads_or(work)) break;  // no live ray left in this block
    load_tile(s, tris, n_tris, base);
    __syncthreads();
    if (work) {
      const int cnt = min(kTile, n_tris - base);
      for (int c = 0; c < cnt; ++c) {
        float t, u, v;
        if (hit_test(s, c, r, lo, t_best, &t, &u, &v)) {
          t_best = t;
          best = base + c;
          bu = u;
          bv = v;
        }
      }
    }
  }
  if (live) {
    t_out[i] = best >= 0 ? t_best : tmax[i];
    tri_out[i] = best;
    u_out[i] = bu;
    v_out[i] = bv;
  }
}

__global__ void __launch_bounds__(kBlock)
any_kernel(RayPtrs ray, const float* __restrict__ tmin,
           const float* __restrict__ tmax, const uint8_t* __restrict__ active,
           const float* __restrict__ tris, int n_tris, int n,
           uint8_t* __restrict__ occ_out) {
  __shared__ float s[9][kTile];
  const int i = blockIdx.x * kBlock + threadIdx.x;
  const bool live = i < n;
  const bool work = live && active[i] != 0;
  Ray r{};
  float lo = 0.0f, hi = -1.0f;
  if (work) {
    r = load_ray(ray, i);
    lo = tmin[i];
    hi = tmax[i];
  }
  bool occ = false;
  for (int base = 0; base < n_tris; base += kTile) {
    if (!__syncthreads_or(work && !occ)) break;  // every ray of the block is done
    load_tile(s, tris, n_tris, base);
    __syncthreads();
    if (work && !occ) {
      const int cnt = min(kTile, n_tris - base);
      for (int c = 0; c < cnt; ++c) {
        float t, u, v;
        if (hit_test(s, c, r, lo, hi, &t, &u, &v)) {
          occ = true;
          break;
        }
      }
    }
  }
  if (live) occ_out[i] = occ ? 1 : 0;  // inactive lanes never set occ: occ & active
}

inline int blocks_for(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

extern "C" const char* fermat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int fermat_trace_closest(const float* ox, const float* oy, const float* oz,
                                    const float* dx, const float* dy, const float* dz,
                                    const float* tmin, const float* tmax,
                                    const uint8_t* active, const float* tris, int n_tris,
                                    int n, float* t_out, int* tri_out, float* u_out,
                                    float* v_out, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  closest_kernel<<<blocks_for(n), kBlock, 0, stream>>>(RayPtrs{ox, oy, oz, dx, dy, dz}, tmin,
                                                      tmax, active, tris, n_tris, n, t_out,
                                                      tri_out, u_out, v_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fermat_trace_any(const float* ox, const float* oy, const float* oz,
                                const float* dx, const float* dy, const float* dz,
                                const float* tmin, const float* tmax,
                                const uint8_t* active, const float* tris, int n_tris, int n,
                                uint8_t* occ_out, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  any_kernel<<<blocks_for(n), kBlock, 0, stream>>>(RayPtrs{ox, oy, oz, dx, dy, dz}, tmin,
                                                  tmax, active, tris, n_tris, n, occ_out);
  return static_cast<int>(cudaGetLastError());
}
