// The skip-link BVH walk: closest hit (walk_kernel<false>) and occlusion
// (walk_kernel<true>) over a triangle BVH, one thread a ray.
//
// Replaces fermat_tpu/accel/traverse.py:trace_closest (:140) and trace_any
// (:196). These are not Pallas kernels: JAX runs the walk as an XLA
// while_loop in lockstep over the whole wavefront, one node cursor a ray,
// every step a gather of the cursor's node, its slab test, leaf_size
// unrolled triangle tests and the cursor's move, until no cursor is live.
// In eager PyTorch that loop reads a flag back to the host every few steps,
// thousands of steps a trace on a large scene, so on the card the walk is a
// kernel: a thread runs one ray's cursor on its own, from node 0 until it
// falls off the tree (-1), and nothing waits for the slowest ray but its
// own warp.
//
// Each thread takes exactly the plain version's steps (accel/traverse.py
// _walk) in the same order: the slab test of the node's box within
// [tmin, t] (closest: t is the best hit so far; any: tmax), at a leaf the
// Moller-Trumbore tests of its prims[start + k], k < leaf_size, in order
// (-1 slots skipped; a closest hit needs tmin < t' < t, so the first of
// equal t wins), then the cursor moves to `child` on a box hit at an inner
// node and to `skip` otherwise. The any-hit walk stops at the first hit.
// The arithmetic is written in the plain version's operation order
// (cluster_common.cuh's inv_dir and hit_test, trace.py mt_test) and built
// with --fmad=false, so a ray's node visits, its tests and its hit are the
// plain version's bit for bit.
//
// Layout: a node is two float4 records (accel/bvh.py BvhView.nodes): (lo
// xyz, skip as int bits) and (hi xyz, child, or -1 - prim_start for a
// leaf, as int bits); one 32-byte sector a visit. The triangles are the
// dense tracer's (9, T) soup, nine scalar loads a test.
//
// Bound on H100: FP32 operations, 24 a node visit (the slab test: 6
// subtractions, 6 multiplications, 12 min/max) and 46 a triangle test, over
// the visits and tests the rays' walks take; bytes are the rays (8 floats
// and a flag in, 13 bytes out for a closest hit, 1 for occlusion) and one
// read of the nodes, prims and soup. Design: the
// simplest walk that is right; the rays are not sorted, a warp's rays
// diverge in their walks, and each visit waits on its node's load. A short
// stack, ray sorting and warp-wide traversal are the later work.
#include "cluster_common.cuh"

namespace {

constexpr int kBlock = 128;

// Slab test of the node's box (a.xyz, b.xyz) within [tmin, tmax], in the
// operation order of traverse.py _slab_test.
__device__ __forceinline__ bool box_hit(const Ray& r, float4 a, float4 b, float tmin,
                                        float tmax) {
  const float t0x = (a.x - r.ox) * r.ix;
  const float t1x = (b.x - r.ox) * r.ix;
  const float t0y = (a.y - r.oy) * r.iy;
  const float t1y = (b.y - r.oy) * r.iy;
  const float t0z = (a.z - r.oz) * r.iz;
  const float t1z = (b.z - r.oz) * r.iz;
  const float near = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)),
                           fmaxf(fminf(t0z, t1z), tmin));
  const float far = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)),
                          fminf(fmaxf(t0z, t1z), tmax));
  return near <= far;
}

// Moller-Trumbore of ray r against soup triangle `id` within (r.tmin, r.tmax).
__device__ __forceinline__ bool tri_hit(const Ray& r, const float* __restrict__ tris,
                                        int n_tris, int id, float* t, float* u, float* v) {
  const float* c = tris + id;
  const float4 a = make_float4(__ldg(c), __ldg(c + n_tris), __ldg(c + 2 * n_tris),
                               __ldg(c + 3 * n_tris));
  const float4 b = make_float4(__ldg(c + 4 * n_tris), __ldg(c + 5 * n_tris),
                               __ldg(c + 6 * n_tris), __ldg(c + 7 * n_tris));
  const float4 e = make_float4(__ldg(c + 8 * n_tris), 0.0f, 0.0f, 0.0f);
  return hit_test(r, a, b, e, t, u, v);
}

template <bool kAny>
__global__ void __launch_bounds__(kBlock)
walk_kernel(const float4* __restrict__ nodes, const int* __restrict__ prims,
            const float* __restrict__ tris, RayPtrs rp, int leaf_size, int n_tris, int n,
            float* __restrict__ t_out, int* __restrict__ tri_out, float* __restrict__ u_out,
            float* __restrict__ v_out, uint8_t* __restrict__ occ_out) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i >= n) return;
  Ray r = load_ray(rp, i);  // the closest walk lowers r.tmax to each better hit
  int tri = -1;
  float u = 0.0f, v = 0.0f;
  bool occ = false;
  int node = rp.active[i] ? 0 : -1;
  while (node >= 0) {
    const float4 a = __ldg(nodes + 2 * node);
    const float4 b = __ldg(nodes + 2 * node + 1);
    const int meta = __float_as_int(b.w);
    const bool hit = box_hit(r, a, b, r.tmin, r.tmax);
    if (hit && meta < 0) {
      const int start = -1 - meta;
      for (int k = 0; k < leaf_size; ++k) {
        const int id = __ldg(prims + start + k);
        if (id < 0) continue;
        float th, uh, vh;
        if (tri_hit(r, tris, n_tris, id, &th, &uh, &vh)) {
          if (kAny) {
            occ = true;
            break;
          }
          r.tmax = th;
          tri = id;
          u = uh;
          v = vh;
        }
      }
      if (kAny && occ) break;
    }
    node = (hit && meta >= 0) ? meta : __float_as_int(a.w);
  }
  if (kAny) {
    occ_out[i] = occ;
  } else {
    t_out[i] = r.tmax;  // the caller's tmax on a miss
    tri_out[i] = tri;
    u_out[i] = u;
    v_out[i] = v;
  }
}

}  // namespace

extern "C" const char* fermat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// nodes (n_nodes, 8) f32 records, prims (n_slots,) i32, tris (9, T) f32,
// rays (n,) f32 each, tmin/tmax (n,) f32, active (n,) u8 -> t, tri, u, v (n,).
extern "C" int fermat_bvh_closest(const float* nodes, const int* prims, const float* tris,
                                  const float* ox, const float* oy, const float* oz,
                                  const float* dx, const float* dy, const float* dz,
                                  const float* tmin, const float* tmax, const uint8_t* active,
                                  int leaf_size, int n_tris, int n, float* t_out, int* tri_out,
                                  float* u_out, float* v_out, int device, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const RayPtrs rp{ox, oy, oz, dx, dy, dz, tmin, tmax, active};
  walk_kernel<false><<<(n + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
      reinterpret_cast<const float4*>(nodes), prims, tris, rp, leaf_size, n_tris, n, t_out,
      tri_out, u_out, v_out, nullptr);
  return static_cast<int>(cudaGetLastError());
}

// The same inputs -> occ (n,) u8.
extern "C" int fermat_bvh_any(const float* nodes, const int* prims, const float* tris,
                              const float* ox, const float* oy, const float* oz,
                              const float* dx, const float* dy, const float* dz,
                              const float* tmin, const float* tmax, const uint8_t* active,
                              int leaf_size, int n_tris, int n, uint8_t* occ_out, int device,
                              cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const RayPtrs rp{ox, oy, oz, dx, dy, dz, tmin, tmax, active};
  walk_kernel<true><<<(n + kBlock - 1) / kBlock, kBlock, 0, stream>>>(
      reinterpret_cast<const float4*>(nodes), prims, tris, rp, leaf_size, n_tris, n, nullptr,
      nullptr, nullptr, nullptr, occ_out);
  return static_cast<int>(cudaGetLastError());
}
