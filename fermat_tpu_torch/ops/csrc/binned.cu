// K7a / K7b: the binned tracer. Closest hit (with the winner's Moller-
// Trumbore u, v) and occlusion over the cluster table of a large scene, as
// rounds of per-ray visits binned by cluster (ops/binned_trace.py drives
// the rounds).
//
// Replaces fermat_tpu/ops/pallas_binned_trace.py: _run_kernel (:320,
// pallas_call :341) over _binned_closest_kernel (:189) and
// _binned_any_kernel (:264), called once a round by _closest_impl (:362)
// and _any_impl (:426). A round of the port:
//   1. scan_kernel (a helper, not a port of a Pallas kernel: JAX runs its
//      _frontier_scan :109 in XLA): one thread per live ray finds its next
//      cluster, the smallest (E', cid) strictly after its cursor with
//      E' <= its best t (closest), or the smallest cid after its cursor
//      (occlusion: min by cid, :166-169), over the cluster boxes staged in
//      shared memory 1,024 at a time; SENT when there is none;
//   2. the driver drops the finished rays and sorts the rest by cid;
//   3. test_kernel: one CTA per `block` sorted rays tests up to `u_steps`
//      distinct clusters of its rays, each staged in shared memory (the
//      cluster's real triangles, 48 bytes each); only the rays whose cid
//      matches are tested, and they alone advance their cursor (the
//      Pallas kernel's `tested` flag); the others retry next round. The
//      merge of JAX's round loop (:394-405) happens here, in place: a
//      tested ray keeps the better of its best hit and this cluster's by
//      (t, id), and sets its cursor to (E', cid).
// The function is that of fermat_tpu_torch/ops/frontier_trace.py (entry
// margin E', a hit counts only with E' <= t, ties to the smallest original
// id, occlusion in any entered cluster): a ray visits its clusters in
// ascending (E', cid) while E' <= its best t, which holds every cluster the
// function needs, so the answer equals K5's bit for bit. The arithmetic is
// K5's, shared in cluster_common.cuh, and built with --fmad=false.
//
// Bound on H100: FP32 operations, ~46 per ray-triangle test over the
// clusters a ray must enter (as K5's); the scan adds a slab test per live
// ray and cluster each round. Design: the rays of a CTA share few clusters
// after the sort, so a staged cluster serves many rays; the host reads the
// number of live rays back once a round.
#include "cluster_common.cuh"

namespace {

constexpr int kScanThreads = 256;
constexpr int kScanTile = 1024;  // cluster boxes staged per pass of the scan
constexpr int kSent = kIntMax;   // no next cluster (ops/binned_trace.py SENT)

// Per-ray state of a trace, indexed by the ray's lane; the test kernel
// updates it in place.
struct State {
  float* t_best;
  int* id_best;
  float* u;
  float* v;
  float* last_e;  // cursor (E', cid) of the last tested cluster
  int* last_c;
  uint8_t* occ;
};

template <bool kClosest>
__global__ void __launch_bounds__(kScanThreads)
scan_kernel(const int* __restrict__ live, int m, RayPtrs ray, State st,
            const float* __restrict__ boxes, int cp, int c_pad, float* __restrict__ ent_out,
            int* __restrict__ cid_out) {
  __shared__ float box_s[6][kScanTile];
  const int j = blockIdx.x * kScanThreads + threadIdx.x;
  const bool has = j < m;
  Ray r{};
  float tb = 0.0f, le = 0.0f;
  int lc = 0;
  bool done = !has;
  if (has) {
    const int gi = live[j];
    r = load_ray(ray, gi);
    lc = st.last_c[gi];
    if (kClosest) {
      tb = st.t_best[gi];
      le = st.last_e[gi];
    } else {
      done = st.occ[gi] != 0;  // an occluded ray scans no further
    }
  }
  float best_e = inf();
  int best_c = kSent;
  for (int base = 0; base < c_pad; base += kScanTile) {
    const int w = min(kScanTile, c_pad - base);
    __syncthreads();  // the previous tile is no longer read
    for (int k = threadIdx.x; k < 6 * w; k += kScanThreads) {
      const int comp = k / w, q = k - comp * w;
      box_s[comp][q] = __ldg(boxes + comp * cp + base + q);
    }
    __syncthreads();
    if (done) continue;
    for (int q = 0; q < w; ++q) {
      const int c = base + q;
      if (!kClosest && c <= lc) continue;
      float e;
      if (!entered(r, box_s[0][q], box_s[1][q], box_s[2][q], box_s[3][q], box_s[4][q],
                   box_s[5][q], &e))
        continue;
      if (kClosest) {
        // ascending c: a strict < keeps the smaller cid among equal E'
        if (e <= tb && (e > le || (e == le && c > lc)) && e < best_e) {
          best_e = e;
          best_c = c;
        }
      } else {
        best_c = c;  // the first entered cluster after the cursor
        done = true;
        break;
      }
    }
  }
  if (!has) return;
  cid_out[j] = best_c;
  if (kClosest) ent_out[j] = best_c == kSent ? inf() : best_e;
}

template <bool kClosest>
__global__ void test_kernel(const int* __restrict__ live, const int* __restrict__ cid,
                            const float* __restrict__ ent, int m, int u_steps, RayPtrs ray,
                            const float4* __restrict__ rows, const int* __restrict__ count,
                            State st) {
  extern __shared__ float4 tri_s[];
  __shared__ int s_next;
  const int nb = blockDim.x;
  const int j = blockIdx.x * nb + threadIdx.x;
  const int my_c = j < m ? cid[j] : kSent;
  // the rays are sorted by cid, so the block's first ray has its smallest
  int cur = cid[blockIdx.x * nb];
  for (int step = 0; step < u_steps && cur != kSent; ++step) {
    const int cnt = __ldg(count + cur);
    const float4* src = rows + static_cast<size_t>(cur) * kCluster * kRowFloat4;
    for (int k = threadIdx.x; k < cnt * kRowFloat4; k += nb) tri_s[k] = __ldg(src + k);
    if (threadIdx.x == 0) s_next = kSent;
    __syncthreads();
    if (my_c == cur) {
      const int gi = live[j];
      const Ray r = load_ray(ray, gi);
      if (kClosest) {
        const float ec = ent[j];
        float tb = st.t_best[gi];
        int ib = st.id_best[gi];
        float ub = 0.0f, vb = 0.0f;
        bool got = false;
        for (int k = 0; k < cnt; ++k) {
          const float4 c2 = tri_s[3 * k + 2];
          float t, uu, vv;
          if (!hit_test(r, tri_s[3 * k], tri_s[3 * k + 1], c2, &t, &uu, &vv) || t < ec)
            continue;
          const int id = static_cast<int>(c2.y);
          if (t < tb || (t == tb && id < ib)) {
            tb = t;
            ib = id;
            ub = uu;
            vb = vv;
            got = true;
          }
        }
        if (got) {
          st.t_best[gi] = tb;
          st.id_best[gi] = ib;
          st.u[gi] = ub;
          st.v[gi] = vb;
        }
        st.last_e[gi] = ec;
      } else {
        for (int k = 0; k < cnt; ++k) {
          float t, uu, vv;
          if (hit_test(r, tri_s[3 * k], tri_s[3 * k + 1], tri_s[3 * k + 2], &t, &uu, &vv)) {
            st.occ[gi] = 1;
            break;
          }
        }
      }
      st.last_c[gi] = cur;
    } else if (my_c > cur && my_c != kSent) {
      atomicMin(&s_next, my_c);
    }
    __syncthreads();
    cur = s_next;
    __syncthreads();  // before s_next is reset and tri_s restaged
  }
}

inline int set_device(int device) { return static_cast<int>(cudaSetDevice(device)); }

}  // namespace

extern "C" const char* fermat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int fermat_binned_scan(int closest, const int* live, int m, const float* ox,
                                  const float* oy, const float* oz, const float* dx,
                                  const float* dy, const float* dz, const float* tmin,
                                  const float* tmax, float* t_best, float* last_e,
                                  int* last_c, uint8_t* occ, const float* boxes, int cp,
                                  int c_pad, float* ent_out, int* cid_out, int device,
                                  cudaStream_t stream) {
  int err = set_device(device);
  if (err != 0 || m == 0) return err;
  const RayPtrs ray{ox, oy, oz, dx, dy, dz, tmin, tmax, nullptr};
  const State st{t_best, nullptr, nullptr, nullptr, last_e, last_c, occ};
  const int grid = (m + kScanThreads - 1) / kScanThreads;
  if (closest)
    scan_kernel<true><<<grid, kScanThreads, 0, stream>>>(live, m, ray, st, boxes, cp, c_pad,
                                                          ent_out, cid_out);
  else
    scan_kernel<false><<<grid, kScanThreads, 0, stream>>>(live, m, ray, st, boxes, cp, c_pad,
                                                           ent_out, cid_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fermat_binned_test(int closest, const int* live, const int* cid,
                                  const float* ent, int m, int block, int u_steps,
                                  const float* ox, const float* oy, const float* oz,
                                  const float* dx, const float* dy, const float* dz,
                                  const float* tmin, const float* tmax, const float* rows,
                                  const int* count, float* t_best, int* id_best, float* u,
                                  float* v, float* last_e, int* last_c, uint8_t* occ,
                                  int device, cudaStream_t stream) {
  int err = set_device(device);
  if (err != 0 || m == 0) return err;
  if (block < 32 || block > 1024 || block % 32 != 0 || u_steps < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const RayPtrs ray{ox, oy, oz, dx, dy, dz, tmin, tmax, nullptr};
  const State st{t_best, id_best, u, v, last_e, last_c, occ};
  const auto* r4 = reinterpret_cast<const float4*>(rows);
  const int grid = (m + block - 1) / block;
  const size_t smem = sizeof(float4) * kCluster * kRowFloat4;
  if (closest)
    test_kernel<true><<<grid, block, smem, stream>>>(live, cid, ent, m, u_steps, ray, r4,
                                                     count, st);
  else
    test_kernel<false><<<grid, block, smem, stream>>>(live, cid, ent, m, u_steps, ray, r4,
                                                      count, st);
  return static_cast<int>(cudaGetLastError());
}
