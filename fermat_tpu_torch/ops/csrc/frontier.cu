// K5a / K5b: closest hit and occlusion over the cluster table of a large
// scene (clusters of at most 128 triangles, accel/cluster.py), and the
// coherence key the wrapper sorts the rays by before either.
//
// Replaces fermat_tpu/ops/pallas_frontier_trace.py: _closest_kernel (:204,
// launched by _closest_impl :489) and _any_kernel (:352, launched by
// _any_impl :537); key_kernel is _sort_key (:61-89, XLA there). The Pallas
// kernels exist because Mosaic has no per-lane control flow: a ray block
// builds a (BLK, Cp) matrix of slab entries into every cluster box in VMEM,
// picks the K nearest clusters any ray of the block still needs, DMAs their
// (16, 128) tiles and tests them against the whole block. A GPU thread can
// walk a tree on its own, so here:
//   * the wrapper co-sorts the rays as the Pallas wrapper does (dead rays
//     last, then the direction octant, then the origin's morton cell in the
//     cluster bounds; key_kernel computes JAX's key bit for bit) and passes
//     the permutation: thread slot i traces ray perm[i] and writes its
//     answer at perm[i], so no ray lane is gathered or scattered. A warp's
//     rays then share their octant and neighbourhood, walk the same nodes
//     and test the same clusters at once (one broadcast load serves the
//     warp), and the dead rays of late bounces fill whole warps that exit
//     at once;
//   * a top-level BVH over the real clusters' boxes (built on the host by
//     accel/bvh.build_bvh, one cluster per leaf), stored as one 64-byte
//     record per inner node that holds both children's boxes and refs
//     (four float4 loads; Aila and Laine, HPG 2009), walked nearer child
//     first with the farther one on a per-thread stack of (ref, E') in
//     shared memory, one column per thread (entry k of thread t at
//     k * kBlock + t: a warp's pushes and pops hit 32 consecutive 8-byte
//     words). The stack holds at most one entry per tree level below the
//     root, and the wrapper sizes it to the tree's depth (<= 60,
//     accel/cluster.py MAX_DEPTH), so no tree the builder accepts
//     overflows it. A lane steps through inner nodes until it holds a leaf
//     and only then tests it (Aila and Laine's while-while loop), so the
//     lanes of a warp run their leaves' triangle loops together;
//   * at a leaf, the cluster's real triangles (a prefix of its 128 slots),
//     one 48-byte row each (p0 e1 e2, original id), read through L1/L2:
//     the whole table of a 100k-triangle scene is ~7 MB and stays in L2.
// The function is the one documented in fermat_tpu_torch/ops/frontier_trace.py
// (entry E from the slab test with tmin/tmax and the lox <= hix emptiness
// test; E' = E * (1 - 2^-10) - 2^-12; a node or cluster is entered while
// E' <= t_best; a closest hit needs E' <= t and wins by (t, original id);
// occlusion is any hit in an entered cluster). A node's box holds its
// children's boxes exactly, and every step of the slab arithmetic is
// monotone in the box bounds, so a node's E' is never above a child's: the
// walk enters every cluster the plain version enters, and the answer does
// not depend on the visit order or on the order of the rays. A leaf's box
// in the record is its cluster's box bit for bit (accel/cluster.py checks
// it), so the E' of the record's slab test is the cluster's. The
// arithmetic (cluster_common.cuh, shared with K6, K7 and K8) is written in
// the operation order of the plain PyTorch version and built with
// --fmad=false, so the two agree bit for bit on the card.
//
// Bound on H100: FP32 operations, ~46 per ray-triangle test (each real
// triangle of each entered cluster), over the clusters a ray must enter
// before its hit; with --fmad=false no test contracts to FMAs, so the
// reachable rate is half the 67 TFLOP/s peak. Bytes are the rays (8
// floats + 1 flag in, 8 bytes out) and one read of the table. Design: the
// box tests of the tree are cheap next to a leaf's ~88 triangle tests; a
// ray leaves its walk as soon as the stack holds no node nearer than its
// best hit (closest) or at its first hit (occlusion). Persistent warps
// fed from a global ray counter, and an L2 persisting window over the rows,
// were measured on top of this design and left out: neither paid
// (tools/torch_k5_steps.py measures both; PERF.md has the numbers).
#include "cluster_common.cuh"

namespace {

constexpr int kBlock = 128;
constexpr int kMaxStack = 64;  // entries; accel/cluster.py caps the tree depth at 60
constexpr int kSortDead = 27, kSortOctant = 24, kSortShift = 6;  // _sort_key's layout

struct Scene {
  const float4* nodes;  // (n_inner, 4) records: see accel/cluster.py _node_records
  const float4* rows;   // (C_pad, 128, 3) float4: p0 e1 e2 id 0 0
  const int* count;     // (C_pad,)
};

// Walks the tree; for each entered cluster calls leaf(c, e') and stops when
// it returns true. `limit` is read before each entry (the best t so far).
// stack: this thread's column of the CTA's shared-memory stack. A lane
// steps through inner nodes until it holds a leaf, so the lanes of a warp
// run their leaves' triangle loops together rather than one after another
// (the while-while loop of Aila and Laine).
template <typename Leaf>
__device__ __forceinline__ void walk(const Ray& r, const Scene& s, const float& limit,
                                     int2* __restrict__ stack, Leaf leaf) {
  int sp = 0;
  int ref = 0;  // record 0 is the root
  float e = 0.0f;
  // the nearest deferred node still within the limit into (ref, e); false
  // when none is left
  auto pop = [&]() {
    int2 top;
    do {
      if (sp == 0) return false;
      top = stack[--sp * kBlock];
    } while (__int_as_float(top.y) > limit);
    ref = top.x;
    e = __int_as_float(top.y);
    return true;
  };
  for (;;) {
    while (ref >= 0) {
      const float4* nd = s.nodes + 4 * ref;
      const float4 a = __ldg(nd);      // left lo.x hi.x lo.y hi.y
      const float4 b = __ldg(nd + 1);  // right lo.x hi.x lo.y hi.y
      const float4 c = __ldg(nd + 2);  // left lo.z hi.z, right lo.z hi.z
      const float4 d = __ldg(nd + 3);  // left ref, right ref (int bits)
      float el, er;
      const bool vl = slab(r, a.x, a.z, c.x, a.y, a.w, c.y, &el) && el <= limit;
      const bool vr = slab(r, b.x, b.z, c.z, b.y, b.w, c.w, &er) && er <= limit;
      const int rl = __float_as_int(d.x), rr = __float_as_int(d.y);
      if (vl && vr) {
        const bool left_first = el <= er;
        stack[sp * kBlock] = make_int2(left_first ? rr : rl,
                                       __float_as_int(left_first ? er : el));
        ++sp;
        ref = left_first ? rl : rr;
        e = left_first ? el : er;
      } else if (vl || vr) {
        ref = vl ? rl : rr;
        e = vl ? el : er;
      } else if (!pop()) {
        return;
      }
    }
    if (leaf(~ref, e) || !pop()) return;
  }
}

__device__ __forceinline__ void closest_ray(const RayPtrs& ray, const Scene& s, int i,
                                            int2* stack, float* __restrict__ t_out,
                                            int* __restrict__ tri_out) {
  const float t_far = ray.tmax[i];
  if (ray.active[i] == 0) {
    t_out[i] = t_far;
    tri_out[i] = -1;
    return;
  }
  const Ray r = load_ray(ray, i);
  float t_best = r.tmax;
  int id_best = kIntMax;
  walk(r, s, t_best, stack, [&](int c, float ec) {
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

__device__ __forceinline__ void any_ray(const RayPtrs& ray, const Scene& s, int i,
                                        int2* stack, uint8_t* __restrict__ occ_out) {
  if (ray.active[i] == 0) {
    occ_out[i] = 0;
    return;
  }
  const Ray r = load_ray(ray, i);
  const float no_limit = inf();  // enter every box
  bool occ = false;
  walk(r, s, no_limit, stack, [&](int c, float) {
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

// Thread slot k traces ray perm[k] (ray k without a permutation).
template <bool kClosest>
__global__ void __launch_bounds__(kBlock)
trace_kernel(RayPtrs ray, const int64_t* __restrict__ perm, Scene s, int n,
             float* __restrict__ t_out, int* __restrict__ tri_out,
             uint8_t* __restrict__ occ_out) {
  extern __shared__ int2 stack_mem[];  // (depth, kBlock)
  int2* stack = stack_mem + threadIdx.x;
  const int slot = blockIdx.x * kBlock + threadIdx.x;
  if (slot >= n) return;
  const int i = perm != nullptr
                    ? static_cast<int>(__ldg(reinterpret_cast<const long long*>(perm) + slot))
                    : slot;
  if (kClosest) {
    closest_ray(ray, s, i, stack, t_out, tri_out);
  } else {
    any_ray(ray, s, i, stack, occ_out);
  }
}

// morton3d of pallas_frontier_trace._sort_key (fermat_tpu/core/morton.py):
// each normalised coordinate to a 10-bit cell, the bits interleaved x y z
__device__ __forceinline__ unsigned int cell(float x) {
  // fmaxf(NaN, 0) = 0: a NaN coordinate takes cell 0, as in the plain version
  return static_cast<unsigned int>(fminf(fmaxf(x * 1023.0f, 0.0f), 1023.0f));
}

__device__ __forceinline__ unsigned int expand_bits(unsigned int v) {
  v = (v * 0x00010001u) & 0xFF0000FFu;
  v = (v * 0x00000101u) & 0x0F00F00Fu;
  v = (v * 0x00000011u) & 0xC30C30C3u;
  v = (v * 0x00000005u) & 0x49249249u;
  return v;
}

// key = dead << 27 | octant << 24 | morton3d(normalised origin) >> 6, with
// dead = !active or tmax <= tmin; norm = (lo xyz, 1 / extent xyz) of the
// cluster boxes.
__global__ void __launch_bounds__(256)
key_kernel(RayPtrs ray, const float* __restrict__ norm, int n, int* __restrict__ key) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float nx = (ray.ox[i] - __ldg(norm)) * __ldg(norm + 3);
  const float ny = (ray.oy[i] - __ldg(norm + 1)) * __ldg(norm + 4);
  const float nz = (ray.oz[i] - __ldg(norm + 2)) * __ldg(norm + 5);
  const unsigned int m = (expand_bits(cell(nx)) << 2) | (expand_bits(cell(ny)) << 1) |
                         expand_bits(cell(nz));
  const unsigned int octant = (ray.dx[i] < 0.0f ? 4u : 0u) + (ray.dy[i] < 0.0f ? 2u : 0u) +
                              (ray.dz[i] < 0.0f ? 1u : 0u);
  const unsigned int dead = (ray.active[i] == 0 || ray.tmax[i] <= ray.tmin[i]) ? 1u : 0u;
  key[i] = static_cast<int>((dead << kSortDead) | (octant << kSortOctant) | (m >> kSortShift));
}

template <bool kClosest>
cudaError_t launch_trace(const RayPtrs& ray, const int64_t* perm, const Scene& s, int depth,
                         int n, float* t_out, int* tri_out, uint8_t* occ_out,
                         cudaStream_t stream) {
  if (depth < 1 || depth > kMaxStack) return cudaErrorInvalidValue;
  const size_t smem = static_cast<size_t>(depth) * kBlock * sizeof(int2);
  if (smem > 48 * 1024) {  // a deep tree's stack: more than a launch gets unasked
    const cudaError_t err = cudaFuncSetAttribute(
        trace_kernel<kClosest>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  trace_kernel<kClosest><<<(n + kBlock - 1) / kBlock, kBlock, smem, stream>>>(
      ray, perm, s, n, t_out, tri_out, occ_out);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* fermat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int fermat_frontier_sort_key(const float* ox, const float* oy, const float* oz,
                                        const float* dx, const float* dy, const float* dz,
                                        const float* tmin, const float* tmax,
                                        const uint8_t* active, const float* norm, int n,
                                        int* key, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  key_kernel<<<(n + 255) / 256, 256, 0, stream>>>(
      RayPtrs{ox, oy, oz, dx, dy, dz, tmin, tmax, active}, norm, n, key);
  return static_cast<int>(cudaGetLastError());
}

// perm: (n,) int64 slot -> ray, or null for the identity; nodes (n_inner,
// 16) f32 records; depth: the tree's depth, the stack entries a walk needs.
extern "C" int fermat_frontier_closest(const float* ox, const float* oy, const float* oz,
                                       const float* dx, const float* dy, const float* dz,
                                       const float* tmin, const float* tmax,
                                       const uint8_t* active, const int64_t* perm,
                                       const float* nodes, const float* rows, const int* count,
                                       int depth, int n, float* t_out, int* tri_out,
                                       int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  return static_cast<int>(launch_trace<true>(
      RayPtrs{ox, oy, oz, dx, dy, dz, tmin, tmax, active}, perm,
      Scene{reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(rows),
            count},
      depth, n, t_out, tri_out, nullptr, stream));
}

extern "C" int fermat_frontier_any(const float* ox, const float* oy, const float* oz,
                                   const float* dx, const float* dy, const float* dz,
                                   const float* tmin, const float* tmax,
                                   const uint8_t* active, const int64_t* perm,
                                   const float* nodes, const float* rows, const int* count,
                                   int depth, int n, uint8_t* occ_out, int device,
                                   cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  return static_cast<int>(launch_trace<false>(
      RayPtrs{ox, oy, oz, dx, dy, dz, tmin, tmax, active}, perm,
      Scene{reinterpret_cast<const float4*>(nodes), reinterpret_cast<const float4*>(rows),
            count},
      depth, n, nullptr, nullptr, occ_out, stream));
}
