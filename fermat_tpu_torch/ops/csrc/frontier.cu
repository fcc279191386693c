// K5a / K5b: closest hit and occlusion over the cluster table of a large
// scene (clusters of at most 128 triangles, accel/cluster.py).
//
// Replaces fermat_tpu/ops/pallas_frontier_trace.py: _closest_kernel (:204,
// launched by _closest_impl :489) and _any_kernel (:352, launched by
// _any_impl :537). The Pallas kernels exist because Mosaic has no per-lane
// control flow: a ray block builds a (BLK, Cp) matrix of slab entries into
// every cluster box in VMEM, picks the K nearest clusters any ray of the
// block still needs, DMAs their (16, 128) tiles and tests them against the
// whole block. A GPU thread can walk a tree on its own, so here:
//   * one thread per ray;
//   * a top-level BVH over the real clusters' boxes (built on the host by
//     accel/bvh.build_bvh, one cluster per leaf), walked with a per-thread
//     stack, the nearer child first;
//   * at a leaf, the cluster's real triangles (a prefix of its 128 slots),
//     one 48-byte row each (p0 e1 e2, original id), read through L1/L2: the
//     whole table of a 100k-triangle scene is ~7 MB and stays in L2.
// The function is the one documented in fermat_tpu_torch/ops/frontier_trace.py
// (entry E from the slab test with tmin/tmax and the lox <= hix emptiness
// test; E' = E * (1 - 2^-10) - 2^-12; a node or cluster is entered while
// E' <= t_best; a closest hit needs E' <= t and wins by (t, original id);
// occlusion is any hit in an entered cluster). A node's box holds its
// children's boxes exactly, and every step of the slab arithmetic is
// monotone in the box bounds, so a node's E' is never above a child's: the
// walk enters every cluster the plain version enters, and the answer does
// not depend on the visit order. The arithmetic (cluster_common.cuh, shared
// with K6 and K7) is written in the operation order of the plain PyTorch
// version and built with --fmad=false, so the two agree bit for bit on the
// card.
//
// Bound on H100: FP32 operations, ~46 per ray-triangle test (128 per
// entered cluster), over the clusters a ray must enter before its hit;
// bytes are the rays (8 floats + 1 flag in, 8 bytes out) and one read of
// the table. Design: the box tests of the tree are cheap next to a leaf's
// 128 triangle tests; a ray leaves its walk as soon as the stack holds no
// node nearer than its best hit (closest) or at its first hit (occlusion).
#include "cluster_common.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kStack = 64;  // accel/cluster.py caps the tree depth at 60

__device__ __forceinline__ bool node_entry(const Ray& r, const float* __restrict__ box,
                                           int node, float* e) {
  const float* b = box + 6 * node;
  return slab(r, __ldg(b), __ldg(b + 1), __ldg(b + 2), __ldg(b + 3), __ldg(b + 4),
              __ldg(b + 5), e);
}

__device__ __forceinline__ bool cluster_entry(const Ray& r, const float* __restrict__ boxes,
                                              int cp, int c, float* e) {
  return slab(r, __ldg(boxes + c), __ldg(boxes + cp + c), __ldg(boxes + 2 * cp + c),
              __ldg(boxes + 3 * cp + c), __ldg(boxes + 4 * cp + c),
              __ldg(boxes + 5 * cp + c), e);
}

struct Scene {
  const float* node_box;  // (n_nodes, 6)
  const int* node_ref;    // inner: right child; leaf: ~cluster
  const float* boxes;     // (6, cp) cluster boxes
  int cp;
  const float4* rows;  // (C_pad, 128, 3) float4: p0 e1 e2 id 0 0
  const int* count;    // (C_pad,)
};

// Walks the tree; for each entered cluster calls leaf(c, e') and stops when
// it returns true. `limit` is read before each entry (the best t so far).
template <typename Leaf>
__device__ __forceinline__ void walk(const Ray& r, const Scene& s, const float& limit,
                                     Leaf leaf) {
  int stack_node[kStack];
  float stack_e[kStack];
  int sp = 0;
  float e;
  if (node_entry(r, s.node_box, 0, &e)) {
    stack_node[0] = 0;
    stack_e[0] = e;
    sp = 1;
  }
  while (sp > 0) {
    --sp;
    const int node = stack_node[sp];
    if (stack_e[sp] > limit) continue;
    const int ref = __ldg(s.node_ref + node);
    if (ref < 0) {
      const int c = ~ref;
      float ec;
      if (!cluster_entry(r, s.boxes, s.cp, c, &ec) || ec > limit) continue;
      if (leaf(c, ec)) return;
      continue;
    }
    const int left = node + 1;
    float el, er;
    const bool vl = node_entry(r, s.node_box, left, &el) && el <= limit;
    const bool vr = node_entry(r, s.node_box, ref, &er) && er <= limit;
    if (vl && vr) {
      const bool left_first = el <= er;
      stack_node[sp] = left_first ? ref : left;
      stack_e[sp] = left_first ? er : el;
      stack_node[sp + 1] = left_first ? left : ref;
      stack_e[sp + 1] = left_first ? el : er;
      sp += 2;
    } else if (vl || vr) {
      stack_node[sp] = vl ? left : ref;
      stack_e[sp] = vl ? el : er;
      ++sp;
    }
  }
}

__global__ void __launch_bounds__(kBlock)
closest_kernel(RayPtrs ray, Scene s, int n, float* __restrict__ t_out,
               int* __restrict__ tri_out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  const float t_far = ray.tmax[i];
  if (ray.active[i] == 0) {
    t_out[i] = t_far;
    tri_out[i] = -1;
    return;
  }
  const Ray r = load_ray(ray, i);
  float t_best = r.tmax;
  int id_best = kIntMax;
  walk(r, s, t_best, [&](int c, float ec) {
    const float4* row = s.rows + static_cast<size_t>(c) * kCluster * kRowFloat4;
    const int cnt = __ldg(s.count + c);
    for (int j = 0; j < cnt; ++j) {
      const float4 a = __ldg(row + 3 * j);
      const float4 b = __ldg(row + 3 * j + 1);
      const float4 cc = __ldg(row + 3 * j + 2);
      float t, u, v;
      if (hit_test(r, a, b, cc, &t, &u, &v) && t >= ec) {
        const int id = static_cast<int>(cc.y);
        if (t < t_best || (t == t_best && id < id_best)) {
          t_best = t;
          id_best = id;
        }
      }
    }
    return false;
  });
  const bool hit = id_best != kIntMax;
  t_out[i] = hit ? t_best : t_far;
  tri_out[i] = hit ? id_best : -1;
}

__global__ void __launch_bounds__(kBlock)
any_kernel(RayPtrs ray, Scene s, int n, uint8_t* __restrict__ occ_out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  if (ray.active[i] == 0) {
    occ_out[i] = 0;
    return;
  }
  const Ray r = load_ray(ray, i);
  const float no_limit = inf();  // enter every box
  bool occ = false;
  walk(r, s, no_limit, [&](int c, float) {
    const float4* row = s.rows + static_cast<size_t>(c) * kCluster * kRowFloat4;
    const int cnt = __ldg(s.count + c);
    for (int j = 0; j < cnt; ++j) {
      float t, u, v;
      if (hit_test(r, __ldg(row + 3 * j), __ldg(row + 3 * j + 1), __ldg(row + 3 * j + 2),
                   &t, &u, &v)) {
        occ = true;
        return true;
      }
    }
    return false;
  });
  occ_out[i] = occ ? 1 : 0;
}

inline int blocks_for(int n) { return (n + kBlock - 1) / kBlock; }

}  // namespace

extern "C" const char* fermat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int fermat_frontier_closest(const float* ox, const float* oy, const float* oz,
                                       const float* dx, const float* dy, const float* dz,
                                       const float* tmin, const float* tmax,
                                       const uint8_t* active, const float* node_box,
                                       const int* node_ref, const float* boxes, int cp,
                                       const float* rows, const int* count, int n,
                                       float* t_out, int* tri_out, int device,
                                       cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  closest_kernel<<<blocks_for(n), kBlock, 0, stream>>>(
      RayPtrs{ox, oy, oz, dx, dy, dz, tmin, tmax, active},
      Scene{node_box, node_ref, boxes, cp, reinterpret_cast<const float4*>(rows), count}, n,
      t_out, tri_out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fermat_frontier_any(const float* ox, const float* oy, const float* oz,
                                   const float* dx, const float* dy, const float* dz,
                                   const float* tmin, const float* tmax,
                                   const uint8_t* active, const float* node_box,
                                   const int* node_ref, const float* boxes, int cp,
                                   const float* rows, const int* count, int n,
                                   uint8_t* occ_out, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  any_kernel<<<blocks_for(n), kBlock, 0, stream>>>(
      RayPtrs{ox, oy, oz, dx, dy, dz, tmin, tmax, active},
      Scene{node_box, node_ref, boxes, cp, reinterpret_cast<const float4*>(rows), count}, n,
      occ_out);
  return static_cast<int>(cudaGetLastError());
}
