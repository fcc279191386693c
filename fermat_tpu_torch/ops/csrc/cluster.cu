// K6a / K6b: the cluster tracer. Closest hit (with the winner's Moller-
// Trumbore u, v) and occlusion over the cluster table of a large scene
// (clusters of at most 128 triangles, accel/cluster.py), visiting clusters
// near to far per block of rays.
//
// Replaces fermat_tpu/ops/pallas_cluster_trace.py: _closest_kernel (:165,
// phase 1 _group_near_phase :100, launched by _closest_impl :348, call :365)
// and _any_kernel (:268, launched by _any_impl :390, call :405). The Pallas
// kernel's shape carries over, because it is a block-coherent algorithm and
// not a TPU workaround:
//   * one CTA per block of `block` rays (the wrapper co-sorts the rays by
//     origin morton cell and direction octant first, so a block is tight);
//     one thread per ray;
//   * phase 1 puts, for every cluster, the block-minimum entry E' of the
//     block's active rays into a shared-memory row of C_pad floats (+inf
//     where no ray of the block enters the cluster). Thread k owns clusters
//     k, k + block, ... and loops over the block's rays, staged in shared
//     memory, so each minimum is a plain fminf: no atomics, and negative
//     entries (E' = -2^-12 at tmin = 0) need no ordered-int trick;
//   * phase 2 visits clusters in ascending block-min E': a block-wide
//     argmin over the row (ties to the smaller cluster id), the cluster's
//     real triangles (count[c] rows of 48 bytes, at most 6 KB) staged in
//     shared memory, and each thread tests its own ray only where its own
//     E' <= its best t (closest) or while it is not occluded (occlusion).
//     The CTA stops when the next block-min E' exceeds the largest best t
//     of its active rays (closest), or when every active ray is occluded or
//     no cluster is left that a ray enters (occlusion).
// An unvisited cluster's E' for a ray is at least its block-min, which is
// above that ray's best t, so the visits hold every cluster the function of
// fermat_tpu_torch/ops/frontier_trace.py needs: the answer (t, tri, occ) is
// K5's bit for bit, whatever the order. The arithmetic is K5's, shared in
// cluster_common.cuh, and built with --fmad=false.
//
// Bound on H100: FP32 operations, ~46 per ray-triangle test over the
// clusters a ray must enter (as K5's); bytes are the rays and one read of
// the table. Design: the argmin and the staging are per cluster visit and
// shared by the block's rays; the tests read the staged triangle that every
// thread of a warp reads at once (a shared-memory broadcast).
#include "cluster_common.cuh"

namespace {

// H100: 232,448 bytes of shared memory per block, less room for the static
// variables; ops/cluster_trace.py checks the same limit
constexpr int kMaxSmem = 231424;

__device__ __forceinline__ void load_box(const float* __restrict__ boxes, int cp, int c,
                                         float* b) {
#pragma unroll
  for (int k = 0; k < 6; ++k) b[k] = __ldg(boxes + k * cp + c);
}

struct Table {
  const float* boxes;  // (6, cp) lo xyz, hi xyz rows
  int cp;
  int c_pad;           // clusters with a table row; boxes past it are padding
  const float4* rows;  // (c_pad, 128, 3) float4: p0 e1 e2 id 0 0
  const int* count;    // (c_pad,) real triangles per cluster (a prefix)
};

struct Out {
  float* t;
  int* tri;
  float* u;
  float* v;
  uint8_t* occ;
};

// Dynamic shared memory: the staged cluster, the block's rays (9 rows of
// `block` floats: ox oy oz ix iy iz tmin tmax active), the E' row, and
// three rows of 32 for the block reductions.
inline size_t smem_bytes(int block, int c_pad) {
  return sizeof(float4) * kCluster * kRowFloat4 +
         sizeof(float) * (9 * static_cast<size_t>(block) + c_pad + 3 * 32);
}

template <bool kClosest>
__global__ void cluster_kernel(RayPtrs ray, Table tab, int n, Out out) {
  extern __shared__ float4 smem[];
  float4* tri_s = smem;
  float* ray_s = reinterpret_cast<float*>(smem + kCluster * kRowFloat4);
  const int nb = blockDim.x;
  float* row = ray_s + 9 * nb;
  float* red_v = row + tab.c_pad;
  int* red_c = reinterpret_cast<int*>(red_v + 32);
  float* red_t = red_v + 64;
  __shared__ int s_cur;
  __shared__ float s_val, s_live;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.x * nb + tid;
  const bool valid = i < n;
  const bool act = valid && ray.active[i] != 0;
  Ray r{};
  if (act) r = load_ray(ray, i);
  ray_s[tid] = r.ox;
  ray_s[nb + tid] = r.oy;
  ray_s[2 * nb + tid] = r.oz;
  ray_s[3 * nb + tid] = r.ix;
  ray_s[4 * nb + tid] = r.iy;
  ray_s[5 * nb + tid] = r.iz;
  ray_s[6 * nb + tid] = r.tmin;
  ray_s[7 * nb + tid] = r.tmax;
  ray_s[8 * nb + tid] = act ? 1.0f : 0.0f;
  __syncthreads();

  // ---- phase 1: block-min E' of every cluster ----
  const int rays_here = min(nb, n - static_cast<int>(blockIdx.x) * nb);
  for (int c = tid; c < tab.c_pad; c += nb) {
    float b[6];
    load_box(tab.boxes, tab.cp, c, b);
    float m = inf();
    for (int k = 0; k < rays_here; ++k) {
      if (ray_s[8 * nb + k] == 0.0f) continue;
      Ray q{};
      q.ox = ray_s[k];
      q.oy = ray_s[nb + k];
      q.oz = ray_s[2 * nb + k];
      q.ix = ray_s[3 * nb + k];
      q.iy = ray_s[4 * nb + k];
      q.iz = ray_s[5 * nb + k];
      q.tmin = ray_s[6 * nb + k];
      q.tmax = ray_s[7 * nb + k];
      float e;
      if (entered(q, b[0], b[1], b[2], b[3], b[4], b[5], &e)) m = fminf(m, e);
    }
    row[c] = m;
  }
  __syncthreads();

  // ---- phase 2: clusters in ascending block-min E' ----
  float t_best = r.tmax;
  int id_best = kIntMax;
  float u_best = 0.0f, v_best = 0.0f;
  bool occ = false;
  const unsigned full = 0xffffffffu;
  while (true) {
    float bv = inf();
    int bc = kIntMax;
    for (int c = tid; c < tab.c_pad; c += nb) {
      const float x = row[c];
      if (x < bv) {  // ascending c: the smaller id keeps a tie
        bv = x;
        bc = c;
      }
    }
    // the stop bound: the largest best t of the active rays (closest);
    // +inf while an active ray is not occluded (occlusion)
    float live = -inf();
    if (kClosest) {
      if (act) live = t_best;
    } else if (act && !occ) {
      live = inf();
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(full, bv, off);
      const int oc = __shfl_down_sync(full, bc, off);
      if (ov < bv || (ov == bv && oc < bc)) {
        bv = ov;
        bc = oc;
      }
      live = fmaxf(live, __shfl_down_sync(full, live, off));
    }
    if (lane == 0) {
      red_v[warp] = bv;
      red_c[warp] = bc;
      red_t[warp] = live;
    }
    __syncthreads();
    if (warp == 0) {
      const int nw = nb >> 5;
      bv = lane < nw ? red_v[lane] : inf();
      bc = lane < nw ? red_c[lane] : kIntMax;
      live = lane < nw ? red_t[lane] : -inf();
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(full, bv, off);
        const int oc = __shfl_down_sync(full, bc, off);
        if (ov < bv || (ov == bv && oc < bc)) {
          bv = ov;
          bc = oc;
        }
        live = fmaxf(live, __shfl_down_sync(full, live, off));
      }
      if (lane == 0) {
        s_cur = bc;
        s_val = bv;
        s_live = live;
      }
    }
    __syncthreads();
    const int cur = s_cur;
    // every entry left is +inf (no ray enters it), or above every bound
    if (cur >= tab.c_pad || !(s_val <= s_live)) break;
    if (tid == 0) row[cur] = inf();  // visited
    const int cnt = __ldg(tab.count + cur);
    const float4* src = tab.rows + static_cast<size_t>(cur) * kCluster * kRowFloat4;
    for (int k = tid; k < cnt * kRowFloat4; k += nb) tri_s[k] = __ldg(src + k);
    __syncthreads();
    if (act && !occ) {
      float b[6];
      load_box(tab.boxes, tab.cp, cur, b);
      float ec;
      if (entered(r, b[0], b[1], b[2], b[3], b[4], b[5], &ec) &&
          (!kClosest || ec <= t_best)) {
        for (int j = 0; j < cnt; ++j) {
          const float4 c2 = tri_s[3 * j + 2];
          float t, uu, vv;
          if (!hit_test(r, tri_s[3 * j], tri_s[3 * j + 1], c2, &t, &uu, &vv)) continue;
          if (!kClosest) {
            occ = true;
            break;
          }
          const int id = static_cast<int>(c2.y);
          if (t >= ec && (t < t_best || (t == t_best && id < id_best))) {
            t_best = t;
            id_best = id;
            u_best = uu;
            v_best = vv;
          }
        }
      }
    }
    __syncthreads();  // the next visit restages tri_s
  }
  if (!valid) return;
  if (kClosest) {
    const bool hit = id_best != kIntMax;
    out.t[i] = hit ? t_best : ray.tmax[i];
    out.tri[i] = hit ? id_best : -1;
    out.u[i] = hit ? u_best : 0.0f;
    out.v[i] = hit ? v_best : 0.0f;
  } else {
    out.occ[i] = occ ? 1 : 0;
  }
}

template <bool kClosest>
int launch(RayPtrs ray, Table tab, int n, int block, Out out, int device,
           cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  if (block < 32 || block > 1024 || block % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(block, tab.c_pad);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(cluster_kernel<kClosest>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (n + block - 1) / block;
  cluster_kernel<kClosest><<<grid, block, smem, stream>>>(ray, tab, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* fermat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int fermat_cluster_closest(const float* ox, const float* oy, const float* oz,
                                      const float* dx, const float* dy, const float* dz,
                                      const float* tmin, const float* tmax,
                                      const uint8_t* active, const float* boxes, int cp,
                                      int c_pad, const float* rows, const int* count, int n,
                                      int block, float* t_out, int* tri_out, float* u_out,
                                      float* v_out, int device, cudaStream_t stream) {
  return launch<true>(RayPtrs{ox, oy, oz, dx, dy, dz, tmin, tmax, active},
                      Table{boxes, cp, c_pad, reinterpret_cast<const float4*>(rows), count},
                      n, block, Out{t_out, tri_out, u_out, v_out, nullptr}, device, stream);
}

extern "C" int fermat_cluster_any(const float* ox, const float* oy, const float* oz,
                                  const float* dx, const float* dy, const float* dz,
                                  const float* tmin, const float* tmax,
                                  const uint8_t* active, const float* boxes, int cp, int c_pad,
                                  const float* rows, const int* count, int n, int block,
                                  uint8_t* occ_out, int device, cudaStream_t stream) {
  return launch<false>(RayPtrs{ox, oy, oz, dx, dy, dz, tmin, tmax, active},
                       Table{boxes, cp, c_pad, reinterpret_cast<const float4*>(rows), count},
                       n, block, Out{nullptr, nullptr, nullptr, nullptr, occ_out}, device,
                       stream);
}
