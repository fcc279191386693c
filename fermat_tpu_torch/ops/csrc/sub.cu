// K8a / K8b: the subcluster tracer. Closest hit (t, triangle id) and
// occlusion over the 32-triangle leaves of accel/cluster.build_subclusters,
// visiting leaves near to far per block of rays, four at a time.
//
// Replaces fermat_tpu/ops/pallas_sub_trace.py: _closest_kernel (:109,
// launched by _closest_impl :346, call :364) and _any_kernel (:237,
// launched by _any_impl :389, call :404). The Pallas kernel stores every
// 32-triangle tile at four lane phases so that it can merge the four
// nearest still-eligible subclusters into one dense 128-lane Moller-Trumbore
// tile: fine leaves cull more pair tests, but a 32-lane tile would cost as
// much as a 128-lane one on the VPU. On the GPU a thread tests one triangle
// at a time, so the composite is a staging unit, not a vector shape:
//   * one CTA per block of `block` rays (co-sorted by the wrapper), one
//     thread per ray; phase 1 puts, for every leaf, the block-min entry E'
//     of the block's active rays into a shared-memory row of Ns floats, as
//     cluster.cu (K6) does per cluster: thread k owns leaves k, k + block,
//     ... and loops over the block's rays staged in shared memory;
//   * phase 2 picks, per step, the kPick leaves of smallest block-min E'
//     still within the stop bound (kPick block-wide argmins, ties to the
//     smaller leaf id), stages their real triangles together as one
//     128-slot composite in shared memory (6 KB), and each thread tests its
//     own ray against each picked leaf it enters, where its own E' <= its
//     best t (closest) or while it is not occluded (occlusion). The stop
//     bound is K6's: the largest best t of the block's active rays
//     (closest), +inf while an active ray is not occluded (occlusion).
// A leaf left unvisited has an E' above every active ray's best t, so the
// answer is the function of ops/frontier_trace.py over the leaf table, bit
// for bit, whatever the order; the arithmetic is cluster_common.cuh's,
// built with --fmad=false. u, v are recomputed outside from the winner, as
// in JAX's trace_closest_sub.
//
// Bound on H100: FP32 operations, ~46 per ray-triangle test over the leaves
// a ray must enter; finer leaves need fewer tests than K5's clusters for
// the same rays, at the price of a 4x longer E' row (phase 1) and four
// argmins per step.
#include "cluster_common.cuh"

namespace {

constexpr int kSub = 32;   // triangle slots of a leaf (accel/cluster.py SUB)
constexpr int kPick = 4;   // leaves staged a step
// H100: 232,448 bytes of shared memory per block, less room for the static
// variables; ops/sub_trace.py reads it through fermat_sub_smem
constexpr int kMaxSmem = 231424;

__device__ __forceinline__ void load_box(const float* __restrict__ boxes, int cs, int c,
                                         float* b) {
#pragma unroll
  for (int k = 0; k < 6; ++k) b[k] = __ldg(boxes + k * cs + c);
}

struct Table {
  const float* boxes;  // (6, cs) lo xyz, hi xyz rows
  int cs;
  int ns;              // leaves with a table row; boxes past it are padding
  const float4* rows;  // (ns, 32, 3) float4: p0 e1 e2 id 0 0
  const int* count;    // (ns,) real triangles per leaf (a prefix)
};

struct Out {
  float* t;
  int* tri;
  uint8_t* occ;
};

// Dynamic shared memory: the staged composite, the block's rays (9 rows of
// `block` floats: ox oy oz ix iy iz tmin tmax active), the E' row, and
// three rows of 32 for the block reductions.
inline size_t smem_bytes(int block, int ns) {
  return sizeof(float4) * kPick * kSub * kRowFloat4 +
         sizeof(float) * (9 * static_cast<size_t>(block) + ns + 3 * 32);
}

template <bool kClosest>
__global__ void sub_kernel(RayPtrs ray, Table tab, int n, Out out) {
  extern __shared__ float4 smem[];
  float4* tri_s = smem;
  float* ray_s = reinterpret_cast<float*>(smem + kPick * kSub * kRowFloat4);
  const int nb = blockDim.x;
  float* row = ray_s + 9 * nb;
  float* red_v = row + tab.ns;
  int* red_c = reinterpret_cast<int*>(red_v + 32);
  float* red_t = red_v + 64;
  __shared__ int s_pick[kPick];
  __shared__ int s_cnt[kPick];
  __shared__ float s_live;

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

  // ---- phase 1: block-min E' of every leaf ----
  const int rays_here = min(nb, n - static_cast<int>(blockIdx.x) * nb);
  for (int c = tid; c < tab.ns; c += nb) {
    float b[6];
    load_box(tab.boxes, tab.cs, c, b);
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

  // ---- phase 2: kPick leaves a step, in ascending block-min E' ----
  float t_best = r.tmax;
  int id_best = kIntMax;
  bool occ = false;
  const unsigned full = 0xffffffffu;
  while (true) {
    // the stop bound of this step: the largest best t of the active rays
    // (closest); +inf while an active ray is not occluded (occlusion)
    float live = -inf();
    if (kClosest) {
      if (act) live = t_best;
    } else if (act && !occ) {
      live = inf();
    }
    for (int p = 0; p < kPick; ++p) {
      float bv = inf();
      int bc = kIntMax;
      for (int c = tid; c < tab.ns; c += nb) {
        const float x = row[c];
        if (x < bv) {  // ascending c: the smaller id keeps a tie
          bv = x;
          bc = c;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(full, bv, off);
        const int oc = __shfl_down_sync(full, bc, off);
        if (ov < bv || (ov == bv && oc < bc)) {
          bv = ov;
          bc = oc;
        }
        if (p == 0) live = fmaxf(live, __shfl_down_sync(full, live, off));
      }
      if (lane == 0) {
        red_v[warp] = bv;
        red_c[warp] = bc;
        if (p == 0) red_t[warp] = live;
      }
      __syncthreads();
      if (warp == 0) {
        const int nw = nb >> 5;
        bv = lane < nw ? red_v[lane] : inf();
        bc = lane < nw ? red_c[lane] : kIntMax;
        if (p == 0) live = lane < nw ? red_t[lane] : -inf();
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_down_sync(full, bv, off);
          const int oc = __shfl_down_sync(full, bc, off);
          if (ov < bv || (ov == bv && oc < bc)) {
            bv = ov;
            bc = oc;
          }
          if (p == 0) live = fmaxf(live, __shfl_down_sync(full, live, off));
        }
        if (lane == 0) {
          if (p == 0) s_live = live;
          // every entry left is +inf (no ray enters it), or above the bound
          if (bc < tab.ns && bv <= s_live) {
            s_pick[p] = bc;
            s_cnt[p] = __ldg(tab.count + bc);
            row[bc] = inf();  // visited
          } else {
            for (int q = p; q < kPick; ++q) s_pick[q] = -1;  // this step ends here
          }
        }
      }
      __syncthreads();
      if (s_pick[p] < 0) break;  // the later picks are empty too
    }
    if (s_pick[0] < 0) break;
    for (int k = tid; k < kPick * kSub * kRowFloat4; k += nb) {
      const int p = k / (kSub * kRowFloat4);
      const int j = k - p * kSub * kRowFloat4;
      const int s = s_pick[p];
      if (s >= 0 && j < s_cnt[p] * kRowFloat4)
        tri_s[k] = __ldg(tab.rows + static_cast<size_t>(s) * kSub * kRowFloat4 + j);
    }
    __syncthreads();
    if (act && !occ) {
      for (int p = 0; p < kPick; ++p) {
        const int s = s_pick[p];
        if (s < 0) break;
        float b[6];
        load_box(tab.boxes, tab.cs, s, b);
        float ec;
        if (!entered(r, b[0], b[1], b[2], b[3], b[4], b[5], &ec) ||
            (kClosest && ec > t_best))
          continue;
        const float4* tri = tri_s + p * kSub * kRowFloat4;
        const int cnt = s_cnt[p];
        for (int j = 0; j < cnt; ++j) {
          const float4 c2 = tri[3 * j + 2];
          float t, uu, vv;
          if (!hit_test(r, tri[3 * j], tri[3 * j + 1], c2, &t, &uu, &vv)) continue;
          if (!kClosest) {
            occ = true;
            break;
          }
          const int id = static_cast<int>(c2.y);
          if (t >= ec && (t < t_best || (t == t_best && id < id_best))) {
            t_best = t;
            id_best = id;
          }
        }
        if (occ) break;
      }
    }
    __syncthreads();  // the next step restages tri_s and rewrites s_pick
  }
  if (!valid) return;
  if (kClosest) {
    const bool hit = id_best != kIntMax;
    out.t[i] = hit ? t_best : ray.tmax[i];
    out.tri[i] = hit ? id_best : -1;
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
  const size_t smem = smem_bytes(block, tab.ns);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(sub_kernel<kClosest>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (n + block - 1) / block;
  sub_kernel<kClosest><<<grid, block, smem, stream>>>(ray, tab, n, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" const char* fermat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The dynamic shared memory a CTA of `block` rays needs over `ns` leaves,
// and the most a launch may take: the wrapper's gate (ops/sub_trace.py)
// asks here, so only this file knows the layout.
extern "C" void fermat_sub_smem(int block, int ns, long long* need, long long* limit) {
  *need = static_cast<long long>(smem_bytes(block, ns));
  *limit = kMaxSmem;
}

extern "C" int fermat_sub_closest(const float* ox, const float* oy, const float* oz,
                                  const float* dx, const float* dy, const float* dz,
                                  const float* tmin, const float* tmax, const uint8_t* active,
                                  const float* boxes, int cs, int ns, const float* rows,
                                  const int* count, int n, int block, float* t_out, int* tri_out,
                                  int device, cudaStream_t stream) {
  return launch<true>(RayPtrs{ox, oy, oz, dx, dy, dz, tmin, tmax, active},
                      Table{boxes, cs, ns, reinterpret_cast<const float4*>(rows), count}, n,
                      block, Out{t_out, tri_out, nullptr}, device, stream);
}

extern "C" int fermat_sub_any(const float* ox, const float* oy, const float* oz,
                              const float* dx, const float* dy, const float* dz,
                              const float* tmin, const float* tmax, const uint8_t* active,
                              const float* boxes, int cs, int ns, const float* rows,
                              const int* count, int n, int block, uint8_t* occ_out, int device,
                              cudaStream_t stream) {
  return launch<false>(RayPtrs{ox, oy, oz, dx, dy, dz, tmin, tmax, active},
                       Table{boxes, cs, ns, reinterpret_cast<const float4*>(rows), count}, n,
                       block, Out{nullptr, nullptr, occ_out}, device, stream);
}
