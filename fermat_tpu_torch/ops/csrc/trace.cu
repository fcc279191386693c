// K1a / K1b: dense closest-hit and any-hit ray casting against a whole
// triangle soup of at most a few thousand triangles (Moller-Trumbore).
//
// Replaces fermat_tpu/ops/pallas_trace.py: _trace_kernel (:65, launched by
// _trace_impl :146) and _any_kernel (:213, launched by _any_impl :264). The
// Pallas kernels put rays on sublanes and 128 triangles on lanes and take a
// lane argmin, because Mosaic has no per-lane control flow. Here a thread
// owns a ray and walks the triangles in order, so the TPU layout is gone
// while the function stays the same:
//   * an inactive lane gets tmax = -1 and is a guaranteed miss
//     (pallas_trace.py:198-200); it is not traced;
//   * a hit needs tmin < t < t_best; on equal t the lowest triangle index
//     wins (the first column inside a tile, strict compares across tiles,
//     pallas_trace.py:109-129): a strict `<` in index order is the same rule;
//   * inv_det = |det| > 1e-12 ? 1/det : 0 (pallas_trace.py:97-99);
//   * a miss returns t = tmax (the caller's, not -1), tri = -1, u = v = 0;
//   * any-hit returns occ & active and stops a ray at its first hit.
// The arithmetic is written in the order of the plain PyTorch version and
// built with --fmad=false, so both round identically on the card.
//
// Bound on H100: for the path's 36-triangle scene, FP32 operations of the
// active lanes (~46 per ray-triangle test) and, at few active lanes, bytes
// (every lane's flag and tmax in and 16 bytes out, the ray and tmin of the
// active lanes only); for thousands of triangles, operations.
//
// K1a's design (closest_kernel). The path calls it once a bounce on every
// lane of the pass, and from the second bounce on most lanes are dead (13%
// active at the fourth), scattered so that nearly every warp holds one:
//   * a block compacts its lanes before tracing: a ballot per warp and the
//     warps' counts give each active lane its place in a shared list, in
//     lane order; a slot thread takes a ray of the list, loads it and
//     writes its result back to that ray's own lane, so a warp with no ray
//     left exits at once and the busy warps are full. A ray's bits do not
//     depend on which thread traces it. Inactive lanes write the miss
//     themselves. Nothing is read back to the host;
//   * a block takes 256 lanes, one a thread; where the launch still gives
//     two blocks an SM at 512 (the path's 262,144 lanes do), it takes 512,
//     two a thread, and a thread traces two rays (sharing each record
//     load) where the block has more rays than threads;
//   * where a block has few active rays, g threads (2-8, as the block's
//     threads allow) share a ray: each walks every g-th triangle, and a
//     shuffle reduction keeps the nearest hit, the lowest index on equal t
//     (the walk's own rule), so a late bounce's sparse blocks do not wait on
//     one thread's walk over every triangle;
//   * the triangles are staged as three float4 records each (p0, e1, e2;
//     three 16-byte shared loads a test), up to kTileTris at once: a scene
//     of one tile is staged once, with one barrier;
//   * a test returns as soon as the det, u or v bound rejects it (the same
//     decisions: u + v <= 1 with v >= 0 needs u <= 1, since rounding is
//     monotone), and 1/det is __frcp_rn (IEEE round-to-nearest, the bits of
//     1.0f / det).
// K1b's design (any_kernel) is K1a's, shaped for a boolean answer. The path
// calls it once a bounce for the shadow rays of mesh-light NEE (4-100% of the
// lanes active):
//   * the same block compaction and records; an inactive lane writes 0
//     itself. One lane a thread at every launch size: K1a's two lanes a
//     thread made K1b's dense launches slower (tools/torch_k1b_k2b_steps.py);
//   * the same test (record_test, one function for both kernels, so their
//     decisions cannot drift apart), and a ray stops at its first hit;
//   * a sparse block's ray is spread over g threads (2-8) that each test
//     every g-th triangle; occlusion is an OR, so the ray's answer is a vote
//     of its g threads (a ballot of the warp, cut to the group's lanes), and
//     the ray stops testing after the first vote that finds a hit. No order
//     of the tests can change the flag. A warp steps as one until all its
//     rays are done (a vote with a mask of the group alone let the groups
//     step apart and serialised the warp: 1.4x slower over the path, 3x with
//     one thread a ray, tools/torch_k1b_k2b_steps.py);
//   * a thread checks for a hit, and a group votes, after every kVoteStride
//     tests, not after each: the tests of a stride run without a branch
//     between them, and at most kVoteStride - 1 tests past a hit are wasted;
//   * at most 64 registers a thread (__launch_bounds__(kBlock, 4)): four
//     blocks an SM, at the cost of a 20-byte spill (measured faster than 80
//     registers and three blocks).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
// triangles staged at once (48 KB of records), and the most threads that
// share a ray's triangles
constexpr int kTileTris = 1024;
constexpr int kSplit = 8;
// K1b: the tests a thread runs between its checks for a hit (and a group's
// votes): the flag is an OR, so tests past a hit change nothing
constexpr int kVoteStride = 4;
constexpr float kEpsDet = 1e-12f;

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

struct RayPtrs {
  const float *ox, *oy, *oz, *dx, *dy, *dz;
};

__device__ __forceinline__ Ray load_ray(const RayPtrs& p, int i) {
  return Ray{p.ox[i], p.oy[i], p.oz[i], p.dx[i], p.dy[i], p.dz[i]};
}

// Moller-Trumbore against one staged record (three float4: p0, e1, e2), in
// the operation order of fermat_tpu_torch/ops/trace.py:mt_test, returning at
// the first bound that rejects (u + v <= 1 with v >= 0 needs u <= 1, since
// rounding is monotone, so the decisions are the full test's); 1/det is
// __frcp_rn, the bits of 1.0f / det. Writes t, u, v only on a hit. K1a and
// K1b both test with it.
__device__ __forceinline__ bool record_test(const float4* __restrict__ rec, const Ray& r,
                                            float tmin, float tmax, float* t, float* u,
                                            float* v) {
  const float4 ra = rec[0], rb = rec[1], rc = rec[2];
  const float p0x = ra.x, p0y = ra.y, p0z = ra.z;
  const float e1x = rb.x, e1y = rb.y, e1z = rb.z;
  const float e2x = rc.x, e2y = rc.y, e2z = rc.z;
  const float pvx = r.dy * e2z - r.dz * e2y;
  const float pvy = r.dz * e2x - r.dx * e2z;
  const float pvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * pvx + e1y * pvy + e1z * pvz;
  if (!(fabsf(det) > kEpsDet)) return false;
  const float inv_det = __frcp_rn(det);
  const float tvx = r.ox - p0x;
  const float tvy = r.oy - p0y;
  const float tvz = r.oz - p0z;
  const float uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;
  if (!(uu >= 0.0f && uu <= 1.0f)) return false;
  const float qvx = tvy * e1z - tvz * e1y;
  const float qvy = tvz * e1x - tvx * e1z;
  const float qvz = tvx * e1y - tvy * e1x;
  const float vv = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;
  if (!(vv >= 0.0f && uu + vv <= 1.0f)) return false;
  const float tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;
  if (!(tt > tmin && tt < tmax)) return false;
  *t = tt;
  *u = uu;
  *v = vv;
  return true;
}

// triangles [base, base + cnt) of the (9, T) soup as float4 records
__device__ __forceinline__ void stage_records(float4* rec, const float* __restrict__ tris,
                                              int n_tris, int base, int cnt) {
  for (int c = threadIdx.x; c < cnt; c += kBlock) {
    const float* t = tris + base + c;
    rec[3 * c] = make_float4(t[0], t[n_tris], t[2 * n_tris], 0.0f);
    rec[3 * c + 1] = make_float4(t[3 * n_tris], t[4 * n_tris], t[5 * n_tris], 0.0f);
    rec[3 * c + 2] = make_float4(t[6 * n_tris], t[7 * n_tris], t[8 * n_tris], 0.0f);
  }
}

// Block compaction, before a barrier: each warp's count of its working
// lanes (thread t holds lanes first + t + k * kBlock)
template <int kRays>
__device__ __forceinline__ void count_lanes(const bool (&work)[kRays], unsigned (&ballot)[kRays],
                                            int (*warp_n)[kBlock / 32]) {
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    ballot[k] = __ballot_sync(0xffffffffu, work[k]);
    if ((threadIdx.x & 31) == 0) warp_n[k][threadIdx.x >> 5] = __popc(ballot[k]);
  }
}

// after that barrier: each working lane's place in the shared list, in lane
// order; returns the block's count of working lanes
template <int kRays>
__device__ __forceinline__ int list_lanes(const bool (&work)[kRays],
                                          const unsigned (&ballot)[kRays],
                                          int (*warp_n)[kBlock / 32], int first,
                                          int* list) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int total = 0, before[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
#pragma unroll
    for (int w = 0; w < kBlock / 32; ++w) {
      if (w == warp) before[k] = total;
      total += warp_n[k][w];
    }
  }
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    if (work[k]) {
      const int pos = before[k] + __popc(ballot[k] & ((1u << lane) - 1u));
      list[pos] = first + k * kBlock + threadIdx.x;
    }
  }
  return total;
}

// How a block's `total` listed rays are shared out: a slot holds the list's
// entries s, s + slots, ... (per of them: one, or kRays where the block's
// threads are fewer than its rays); g threads share a slot's triangles (a
// power of two up to kSplit, as many as the block's threads allow), thread
// s * g + part taking triangles part, part + g, ...
struct Slots {
  int per, slots, g;
};

__device__ __forceinline__ Slots share_out(int total) {
  Slots s;
  s.per = (total + kBlock - 1) / kBlock;
  s.slots = (total + s.per - 1) / s.per;
  s.g = 1;
  while (s.g < kSplit && 2 * s.g * s.slots <= kBlock) s.g *= 2;
  return s;
}

// kRays: lanes a thread compacts (kBlock * kRays a block)
template <int kRays>
__global__ void __launch_bounds__(kBlock)
closest_kernel(RayPtrs ray, const float* __restrict__ tmin,
               const float* __restrict__ tmax, const uint8_t* __restrict__ active,
               const float* __restrict__ tris, int n_tris, int n,
               float* __restrict__ t_out, int* __restrict__ tri_out,
               float* __restrict__ u_out, float* __restrict__ v_out) {
  constexpr int kLanes = kBlock * kRays;
  extern __shared__ float4 rec[];  // a tile of triangles, 3 records each
  __shared__ int list[kLanes];     // the block's active lanes, in lane order
  __shared__ int warp_n[kRays][kBlock / 32];
  const int warp = threadIdx.x >> 5;
  const int first = blockIdx.x * kLanes;
  bool work[kRays];
  unsigned ballot[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int i = first + k * kBlock + threadIdx.x;
    const bool live = i < n;
    work[k] = live && active[i] != 0;
    if (live && !work[k]) {
      t_out[i] = tmax[i];
      tri_out[i] = -1;
      u_out[i] = 0.0f;
      v_out[i] = 0.0f;
    }
  }
  count_lanes(work, ballot, warp_n);
  int cnt = min(kTileTris, n_tris);
  stage_records(rec, tris, n_tris, 0, cnt);
  __syncthreads();
  const int total = list_lanes(work, ballot, warp_n, first, list);
  if (total == 0) return;  // the whole block is inactive
  __syncthreads();         // the list
  const Slots sh = share_out(total);
  const int per = sh.per, slots = sh.slots, g = sh.g;
  const bool busy = warp * 32 < slots * g;  // the warp holds a slot
  if (!busy && n_tris <= kTileTris) return;  // no slot, no tile to stage
  const int slot = threadIdx.x / g;
  const int part = threadIdx.x & (g - 1);
  Ray r[kRays];
  int at[kRays], best[kRays];
  float lo[kRays], tb[kRays], bu[kRays], bv[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int s = slot + k * slots;
    const bool has = k < per && slot < slots && s < total;
    at[k] = has ? list[s] : -1;
    r[k] = Ray{};
    lo[k] = 0.0f;
    tb[k] = -1.0f;  // a guaranteed miss for an empty slot
    if (has) {
      r[k] = load_ray(ray, at[k]);
      lo[k] = tmin[at[k]];
      tb[k] = tmax[at[k]];
    }
    best[k] = -1;
    bu[k] = 0.0f;
    bv[k] = 0.0f;
  }
  for (int base = 0;;) {
    for (int c = part; busy && c < cnt; c += g) {
#pragma unroll
      for (int k = 0; k < kRays; ++k) {
        float t, u, v;
        if (record_test(rec + 3 * c, r[k], lo[k], tb[k], &t, &u, &v)) {
          tb[k] = t;
          best[k] = base + c;
          bu[k] = u;
          bv[k] = v;
        }
      }
    }
    base += cnt;
    if (base >= n_tris) break;
    __syncthreads();  // the tile is consumed
    cnt = min(kTileTris, n_tris - base);
    stage_records(rec, tris, n_tris, base, cnt);
    __syncthreads();
  }
  // the g threads of a slot hold each the nearest hit of their triangles
  // (the lowest index on equal t): the nearest of those, the lowest index on
  // equal t, is the nearest hit over all, as a walk in index order finds it;
  // a miss (tri = -1, t = tmax) loses to any hit (t < tmax)
  for (int off = g >> 1; off > 0; off >>= 1) {
#pragma unroll
    for (int k = 0; k < kRays; ++k) {
      const float t2 = __shfl_xor_sync(0xffffffffu, tb[k], off);
      const int b2 = __shfl_xor_sync(0xffffffffu, best[k], off);
      const float u2 = __shfl_xor_sync(0xffffffffu, bu[k], off);
      const float v2 = __shfl_xor_sync(0xffffffffu, bv[k], off);
      if (t2 < tb[k] ||
          (t2 == tb[k] && static_cast<unsigned>(b2) < static_cast<unsigned>(best[k]))) {
        tb[k] = t2;
        best[k] = b2;
        bu[k] = u2;
        bv[k] = v2;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    if (part == 0 && at[k] >= 0) {  // t stays the caller's tmax on a miss
      t_out[at[k]] = tb[k];
      tri_out[at[k]] = best[k];
      u_out[at[k]] = bu[k];
      v_out[at[k]] = bv[k];
    }
  }
}

// kRays: lanes a thread compacts (kBlock * kRays a block)
template <int kRays>
__global__ void __launch_bounds__(kBlock, 4)
any_kernel(RayPtrs ray, const float* __restrict__ tmin,
           const float* __restrict__ tmax, const uint8_t* __restrict__ active,
           const float* __restrict__ tris, int n_tris, int n, uint8_t* __restrict__ occ_out) {
  constexpr int kLanes = kBlock * kRays;
  extern __shared__ float4 rec[];  // a tile of triangles, 3 records each
  __shared__ int list[kLanes];     // the block's active lanes, in lane order
  __shared__ int warp_n[kRays][kBlock / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int first = blockIdx.x * kLanes;
  bool work[kRays];
  unsigned ballot[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int i = first + k * kBlock + threadIdx.x;
    const bool live = i < n;
    work[k] = live && active[i] != 0;
    if (live && !work[k]) occ_out[i] = 0;  // occ & active
  }
  count_lanes(work, ballot, warp_n);
  int cnt = min(kTileTris, n_tris);
  stage_records(rec, tris, n_tris, 0, cnt);
  __syncthreads();
  const int total = list_lanes(work, ballot, warp_n, first, list);
  if (total == 0) return;  // the whole block is inactive
  __syncthreads();         // the list
  const Slots sh = share_out(total);
  const int per = sh.per, slots = sh.slots, g = sh.g;
  const bool busy = warp * 32 < slots * g;  // the warp holds a slot
  if (!busy && n_tris <= kTileTris) return;  // no slot, no tile to stage
  const int slot = threadIdx.x / g;
  const int part = threadIdx.x & (g - 1);
  // this thread's group of g lanes (g divides 32) starts at lane lead
  const int lead = lane & ~(g - 1);
  const unsigned gmask = 0xffffffffu >> (32 - g);
  Ray r[kRays];
  int at[kRays];
  float lo[kRays], hi[kRays];
  bool occ[kRays];
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    const int s = slot + k * slots;
    const bool has = k < per && slot < slots && s < total;
    at[k] = has ? list[s] : -1;
    r[k] = Ray{};
    lo[k] = 0.0f;
    hi[k] = -1.0f;  // a guaranteed miss for an empty slot
    if (has) {
      r[k] = load_ray(ray, at[k]);
      lo[k] = tmin[at[k]];
      hi[k] = tmax[at[k]];
    }
    occ[k] = false;
  }
  bool done = true;  // every ray of the slot is occluded (or there is none)
#pragma unroll
  for (int k = 0; k < kRays; ++k) done = done && at[k] < 0;
  for (int base = 0;;) {
    if (busy && g == 1) {  // a thread a slot: a ray stops after a stride with a hit
      for (int c0 = 0; !done && c0 < cnt; c0 += kVoteStride) {
        done = true;
#pragma unroll
        for (int k = 0; k < kRays; ++k) {
          float t, u, v;
          if (at[k] >= 0 && !occ[k]) {
            bool o = false;
#pragma unroll
            for (int j = 0; j < kVoteStride; ++j) {
              const int c = c0 + j;
              o = (c < cnt && record_test(rec + 3 * c, r[k], lo[k], hi[k], &t, &u, &v)) || o;
            }
            occ[k] = o;
          }
          done = done && (occ[k] || at[k] < 0);
        }
      }
    } else if (busy) {
      // strides of kVoteStride steps of g triangles; the warp steps as one
      // (its votes take every lane) until every ray of its groups is done
      for (int c0 = 0; c0 < cnt; c0 += kVoteStride * g) {
        if (__all_sync(0xffffffffu, done)) break;
        done = true;
#pragma unroll
        for (int k = 0; k < kRays; ++k) {
          float t, u, v;
          if (at[k] >= 0 && !occ[k]) {
            bool o = false;
#pragma unroll
            for (int j = 0; j < kVoteStride; ++j) {
              const int c = c0 + j * g + part;
              o = (c < cnt && record_test(rec + 3 * c, r[k], lo[k], hi[k], &t, &u, &v)) || o;
            }
            occ[k] = o;
          }
          // the group's vote: occluded once any of its g threads found a hit
          occ[k] = (__ballot_sync(0xffffffffu, occ[k]) >> lead) & gmask;
          done = done && (occ[k] || at[k] < 0);
        }
      }
    }
    base += cnt;
    if (base >= n_tris) break;
    if (!__syncthreads_or(busy && !done)) break;  // every ray of the block is occluded
    cnt = min(kTileTris, n_tris - base);
    stage_records(rec, tris, n_tris, base, cnt);
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kRays; ++k) {
    if (part == 0 && at[k] >= 0) occ_out[at[k]] = occ[k] ? 1 : 0;
  }
}

// dynamic shared memory of a launch: the records of one tile
inline size_t record_bytes(int n_tris) {
  return 3 * sizeof(float4) * static_cast<size_t>(max(1, min(n_tris, kTileTris)));
}

template <typename Kernel>
cudaError_t allow_records(Kernel kernel, size_t smem) {
  if (smem <= 32 * 1024) return cudaSuccess;  // with the static list, under 48 KB a block
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int kRays>
cudaError_t launch_closest(const RayPtrs& ray, const float* tmin, const float* tmax,
                           const uint8_t* active, const float* tris, int n_tris, int n,
                           float* t_out, int* tri_out, float* u_out, float* v_out,
                           cudaStream_t stream) {
  const size_t smem = record_bytes(n_tris);
  const cudaError_t err = allow_records(closest_kernel<kRays>, smem);
  if (err != cudaSuccess) return err;
  constexpr int kLanes = kBlock * kRays;
  closest_kernel<kRays><<<(n + kLanes - 1) / kLanes, kBlock, smem, stream>>>(
      ray, tmin, tmax, active, tris, n_tris, n, t_out, tri_out, u_out, v_out);
  return cudaGetLastError();
}

template <int kRays>
cudaError_t launch_any(const RayPtrs& ray, const float* tmin, const float* tmax,
                       const uint8_t* active, const float* tris, int n_tris, int n,
                       uint8_t* occ_out, cudaStream_t stream) {
  const size_t smem = record_bytes(n_tris);
  const cudaError_t err = allow_records(any_kernel<kRays>, smem);
  if (err != cudaSuccess) return err;
  constexpr int kLanes = kBlock * kRays;
  any_kernel<kRays><<<(n + kLanes - 1) / kLanes, kBlock, smem, stream>>>(
      ray, tmin, tmax, active, tris, n_tris, n, occ_out);
  return cudaGetLastError();
}

// two lanes a thread where that still leaves two blocks an SM
cudaError_t two_lanes(int n, int device, bool* two) {
  int sms = 0;
  const cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  *two = (n + 2 * kBlock - 1) / (2 * kBlock) >= 2 * sms;
  return err;
}

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
  bool two = false;
  err = two_lanes(n, device, &two);
  if (err != cudaSuccess) return static_cast<int>(err);
  const RayPtrs ray{ox, oy, oz, dx, dy, dz};
  err = two ? launch_closest<2>(ray, tmin, tmax, active, tris, n_tris, n, t_out, tri_out, u_out,
                                v_out, stream)
            : launch_closest<1>(ray, tmin, tmax, active, tris, n_tris, n, t_out, tri_out, u_out,
                                v_out, stream);
  return static_cast<int>(err);
}

extern "C" int fermat_trace_any(const float* ox, const float* oy, const float* oz,
                                const float* dx, const float* dy, const float* dz,
                                const float* tmin, const float* tmax,
                                const uint8_t* active, const float* tris, int n_tris, int n,
                                uint8_t* occ_out, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  // one lane a thread at any n: two (K1a's rule) measured slower for K1b
  const RayPtrs ray{ox, oy, oz, dx, dy, dz};
  err = launch_any<1>(ray, tmin, tmax, active, tris, n_tris, n, occ_out, stream);
  return static_cast<int>(err);
}
