// K2: row gather out[n, :] = table[idx[n], :] (exact float32 copy).
//
// Replaces fermat_tpu/ops/gather.py:_pallas_onehot_gather (kernel body
// _onehot_kernel, gather.py:41), which builds a (block, R) one-hot matrix in
// VMEM and multiplies it by the table on the MXU because Mosaic has no
// per-lane gather. A GPU thread can load any address, so this is a plain
// gather: no matmul form, hence no TF32 or bf16 rounding can arise.
//
// Bound on H100: bytes. Per call it must read idx (4 B/row) and the table
// once, and write the output (4*K B/row). Design (gather_rows_kernel): a warp
// copies a tile of 32 consecutive rows. Lane l loads the index of row l once;
// the tile's output is 32 * q consecutive vectors (q = K/4 float4 a row when
// K % 4 == 0 and both pointers are 16-byte aligned, else q = K floats),
// and lane l copies vectors l, l + 32, ..., taking each row's index from
// the lane that loaded it (a shuffle) and stepping (row, column) without an
// integer division, so every store of the warp is 512 (or 128) consecutive
// bytes. A row of one vector (the path's 1-column pdf) is copied a thread a
// row instead, with no shuffle (the tile loop was measured slower there,
// tools/torch_k2_k1_steps.py). The grid is the blocks that fit on the card at once (one wave at the
// CornellBox's 262,144 rows), striding over the tiles beyond that (big_room's
// 1,433,600). The table is read through L1/L2 (staging the path's 7.5 KB
// table in shared memory was measured slower, tools/torch_k2_k1_steps.py).
// An output larger than L2 is written with streaming stores (st.global.cs),
// so that its stream (298 MB on big_room, 54.5 MB for the CornellBox's
// 52-column rows) does not evict the table from L2; a smaller one, which
// the pass's next kernels read back while it is still in L2, with plain
// stores. An index outside [0, R) yields a zero row, as the padded one-hot
// does (gather.py:56-72).
//
// K2b: its backward, d_table[r, :] = sum of g[n, :] over the lanes n with
// idx[n] == r (lanes outside [0, R) add nothing). Replaces
// fermat_tpu/ops/gather.py:_pog_bwd (:84, the custom VJP of the Pallas
// gather), an XLA matmul of the transposed (N, Rp) one-hot by the
// cotangent. Here it is a scatter-add. Bound on H100: bytes (idx 4 B and the
// cotangent 4*K B per lane in, d_table once out). Two modes, chosen by the
// wrapper (ops/gather.py bwd_slices):
//   * shared (small tables, whose partials fit in shared memory; the
//     CornellBox's 36 x 52): the grid is the CTAs that fit on the card at
//     once (at most kBwdPerSm an SM); the lanes are cut into grid x S
//     contiguous slices, S a CTA. Thread (j, c) of a CTA owns vector column
//     c (q = K / 4 float4 when K % 4 == 0 and the cotangent is 16-byte
//     aligned, else q = K floats) of slice j's private (R, K) partial in
//     shared memory; it walks its slice's lanes in order with kUnroll lanes'
//     loads in flight (the cotangent's loads do not wait on the index
//     loads; the q threads of a slice read a row's consecutive vectors) and
//     adds each lane's vector to its row of the partial. The S partials are
//     added in slice order into the CTA's partial in global scratch, and a
//     second launch (gather_bwd_sum_kernel) sums those in a fixed order.
//     Every sum has a fixed order, set by (N, R, K) and the card's SM count:
//     two launches give the same bits. No add waits for another thread's.
//     Measured and left out (tools/torch_k1b_k2b_steps.py), each slower or
//     no faster: summing a run of lanes with one index in registers first,
//     folding the second launch into the first (the last CTAs to finish, by
//     tickets, summing the partials), 16 lanes' loads in flight, two CTAs
//     an SM, 512 threads a CTA;
//   * atomic (larger tables; big_room's 99,636 x 52): d_table zeroed, one
//     global atomicAdd per non-zero cotangent element. The order of the adds
//     changes from run to run: not deterministic, within float rounding of
//     the plain version (tolerance in chip_smoke.py phase 3).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

// V: float4 (q = cols / 4) or float (q = cols); kStream: streaming stores
template <typename V, bool kStream>
__global__ void __launch_bounds__(kBlock)
gather_rows_kernel(const V* __restrict__ table, const int* __restrict__ idx, int rows, int q,
                   int n, V* __restrict__ out) {
  if (q == 1) {
    for (int i = blockIdx.x * kBlock + threadIdx.x; i < n; i += gridDim.x * kBlock) {
      const int ri = __ldg(idx + i);
      V val{};
      if (ri >= 0 && ri < rows) val = __ldg(table + ri);
      if constexpr (kStream) {
        __stcs(out + i, val);
      } else {
        out[i] = val;
      }
    }
    return;
  }
  const int lane = threadIdx.x & 31;
  const int r0 = lane / q, c0 = lane - r0 * q;  // the lane's first vector: (row, column)
  const int dr = 32 / q, dc = 32 - dr * q;      // its step of 32 vectors
  const int tiles = (n + 31) >> 5;
  for (int tile = blockIdx.x * (kBlock / 32) + (threadIdx.x >> 5); tile < tiles;
       tile += gridDim.x * (kBlock / 32)) {
    const int row0 = tile << 5;
    const int valid = min(32, n - row0);
    const int mine = lane < valid ? __ldg(idx + row0 + lane) : -1;
    V* dst = out + static_cast<size_t>(row0) * q;
    int r = r0, c = c0;
#pragma unroll 4
    for (int f = lane; f < 32 * q; f += 32) {  // vector f of the tile: (r, c)
      const int ri = __shfl_sync(0xffffffffu, mine, r);
      if (r < valid) {
        V val{};
        if (ri >= 0 && ri < rows) val = __ldg(table + ri * q + c);
        if constexpr (kStream) {
          __stcs(dst + f, val);
        } else {
          dst[f] = val;
        }
      }
      r += dr;
      c += dc;
      if (c >= q) {
        c -= q;
        ++r;
      }
    }
  }
}

template <typename V, bool kStream>
cudaError_t launch_gather(const float* table, const int* idx, int rows, int q, int n,
                          float* out, int sms, cudaStream_t stream) {
  int per_sm = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gather_rows_kernel<V, kStream>, kBlock, 0);
  if (err != cudaSuccess) return err;
  const int tiles = (n + 31) / 32;
  const int blocks = min((tiles + kBlock / 32 - 1) / (kBlock / 32), max(per_sm, 1) * sms);
  gather_rows_kernel<V, kStream><<<blocks, kBlock, 0, stream>>>(
      reinterpret_cast<const V*>(table), idx, rows, q, n, reinterpret_cast<V*>(out));
  return cudaGetLastError();
}

constexpr int kBwdThreads = 256;  // most threads a CTA (ops/gather.py BWD_THREADS)
constexpr int kBwdPerSm = 2;      // most CTAs an SM in the grid (ops/gather.py BWD_PER_SM)
constexpr int kBwdSmem = 232448;  // most shared memory a CTA (ops/gather.py BWD_SMEM)
constexpr int kBwdMinLanes = 32;  // fewest lanes a slice, as n allows
constexpr int kUnroll = 8;

__device__ __forceinline__ void vadd(float& a, float b) { a += b; }
__device__ __forceinline__ void vadd(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// Shared mode (see the header): V float4 (q = K / 4) or float (q = K).
// Thread j * q + c for j < slices; the rest only help to zero and sum.
template <typename V>
__global__ void __launch_bounds__(kBwdThreads)
gather_bwd_shared_kernel(const V* __restrict__ g, const int* __restrict__ idx, int rows, int q,
                         int n, int slices, int per_slice, float* __restrict__ part) {
  extern __shared__ float4 smem[];
  V* sp = reinterpret_cast<V*>(smem);  // (slices, rows, q)
  const int rq = rows * q;
  for (int e = threadIdx.x; e < slices * rq; e += blockDim.x) sp[e] = V{};
  __syncthreads();
  const int j = threadIdx.x / q;
  const int c = threadIdx.x - j * q;
  if (j < slices) {
    V* mine = sp + j * rq + c;
    const int lo = min(n, (blockIdx.x * slices + j) * per_slice);
    const int hi = min(n, lo + per_slice);
    for (int base = lo; base < hi; base += kUnroll) {
      int r[kUnroll];
      V v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // the row's load waits on no index load
        const int ln = base + u;
        r[u] = ln < hi ? __ldg(idx + ln) : -1;
        v[u] = ln < hi ? __ldg(g + static_cast<size_t>(ln) * q + c) : V{};
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {  // a lane out of range adds nothing
        if (r[u] >= 0 && r[u] < rows) vadd(mine[r[u] * q], v[u]);
      }
    }
  }
  __syncthreads();
  // the CTA's partial: its slices' partials in slice order
  V* dst = reinterpret_cast<V*>(part) + static_cast<size_t>(blockIdx.x) * rq;
  for (int e = threadIdx.x; e < rq; e += blockDim.x) {
    V a = sp[e];
    for (int s2 = 1; s2 < slices; ++s2) vadd(a, sp[s2 * rq + e]);
    dst[e] = a;
  }
}

// Shared mode, pass 2: out[e] = sum over c of part[c, e], c in order. A CTA
// of 256 threads takes 32 elements; thread (q, el) sums c = q, q + 8, ...,
// and the 8 sums are added in q order.
__global__ void gather_bwd_sum_kernel(const float* __restrict__ part, int ctas, int rk,
                                      float* __restrict__ out) {
  __shared__ float red[8][32];
  const int el = threadIdx.x & 31;
  const int q = threadIdx.x >> 5;
  const int e = blockIdx.x * 32 + el;
  float acc = 0.0f;
  if (e < rk) {
#pragma unroll 8
    for (int c = q; c < ctas; c += 8) acc += part[static_cast<size_t>(c) * rk + e];
  }
  red[q][el] = acc;
  __syncthreads();
  if (q == 0 && e < rk) {
    float s2 = red[0][el];
#pragma unroll
    for (int w = 1; w < 8; ++w) s2 += red[w][el];
    out[e] = s2;
  }
}

// the kernel's shared-memory attribute on a device, set once to the most a
// launch has needed so far (each set is a driver call)
template <typename V>
cudaError_t allow_bwd_smem(int device, size_t smem) {
  static int allowed[64] = {};  // by device
  if (smem <= 48 * 1024) return cudaSuccess;
  if (device < 64 && static_cast<int>(smem) <= allowed[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      gather_bwd_shared_kernel<V>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess && device < 64) allowed[device] = static_cast<int>(smem);
  return err;
}

template <typename V>
cudaError_t launch_bwd_shared(const float* g, const int* idx, int rows, int cols, int n,
                              float* scratch, float* out, int slices, int device, int sms,
                              cudaStream_t stream) {
  const int q = cols / static_cast<int>(sizeof(V) / sizeof(float));
  const int s = min(slices, kBwdThreads / q);
  const int threads = ((s * q + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(s) * rows * cols * sizeof(float);
  if (s < 1 || threads > kBwdThreads || smem > static_cast<size_t>(kBwdSmem))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_bwd_smem<V>(device, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_bwd_shared_kernel<V>,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  const int need = (n + s * kBwdMinLanes - 1) / (s * kBwdMinLanes);
  const int ctas = max(1, min(need, max(1, min(per_sm, kBwdPerSm)) * sms));
  const int per_slice = (n + ctas * s - 1) / (ctas * s);
  gather_bwd_shared_kernel<V><<<ctas, threads, smem, stream>>>(
      reinterpret_cast<const V*>(g), idx, rows, q, n, s, per_slice, scratch);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int rk = rows * cols;
  gather_bwd_sum_kernel<<<(rk + 31) / 32, 256, 0, stream>>>(scratch, ctas, rk, out);
  return cudaGetLastError();
}

// Atomic mode: one atomicAdd per non-zero cotangent element of an in-range
// lane (adding a zero leaves the sum's value as it is).
__global__ void __launch_bounds__(kBlock)
gather_bwd_atomic_kernel(const float* __restrict__ g, const int* __restrict__ idx, int rows,
                         int cols, int total, float* __restrict__ out) {
  const int stride = gridDim.x * blockDim.x;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
    const int ln = e / cols;
    const int k = e - ln * cols;
    const int r = __ldg(idx + ln);
    const float v = __ldg(g + e);
    if (r >= 0 && r < rows && v != 0.0f) atomicAdd(out + static_cast<size_t>(r) * cols + k, v);
  }
}

}  // namespace

extern "C" const char* fermat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// table (rows, cols) f32, idx (n,) i32 -> out (n, cols) f32; n * cols < 2^31.
extern "C" int fermat_gather_rows(const float* table, const int* idx, int rows,
                                  int cols, int n, float* out, int device,
                                  cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0 || cols == 0) return 0;
  int sms = 0, l2 = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&l2, cudaDevAttrL2CacheSize, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = cols % 4 == 0 &&
                   ((reinterpret_cast<uintptr_t>(table) | reinterpret_cast<uintptr_t>(out)) &
                    15u) == 0;
  const bool big = static_cast<size_t>(n) * cols * sizeof(float) > static_cast<size_t>(l2);
  if (vec) {
    err = big ? launch_gather<float4, true>(table, idx, rows, cols / 4, n, out, sms, stream)
              : launch_gather<float4, false>(table, idx, rows, cols / 4, n, out, sms, stream);
  } else {
    err = big ? launch_gather<float, true>(table, idx, rows, cols, n, out, sms, stream)
              : launch_gather<float, false>(table, idx, rows, cols, n, out, sms, stream);
  }
  return static_cast<int>(err);
}

// g (n, cols) f32 cotangent, idx (n,) i32 -> out (rows, cols) f32 d_table.
// slices > 0: the shared mode with at most that many lane slices a CTA
// (fewer where the threads allow fewer), scratch sms * kBwdPerSm * rows *
// cols floats; slices == 0: the atomic mode (scratch unused). n * cols and
// rows * cols < 2^31.
extern "C" int fermat_gather_rows_bwd(const float* g, const int* idx, int rows, int cols,
                                      int n, float* scratch, float* out, int slices, int device,
                                      cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rk = rows * cols;
  if (rk == 0) return 0;
  if (slices == 0 || n == 0) {
    err = cudaMemsetAsync(out, 0, static_cast<size_t>(rk) * sizeof(float), stream);
    if (err != cudaSuccess || n == 0) return static_cast<int>(err);
    const int total = n * cols;
    int blocks = (total + kBlock - 1) / kBlock;
    if (blocks > 132 * 16) blocks = 132 * 16;
    gather_bwd_atomic_kernel<<<blocks, kBlock, 0, stream>>>(g, idx, rows, cols, total, out);
    return static_cast<int>(cudaGetLastError());
  }
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = cols % 4 == 0 && (reinterpret_cast<uintptr_t>(g) & 15u) == 0;
  err = vec ? launch_bwd_shared<float4>(g, idx, rows, cols, n, scratch, out, slices, device, sms,
                                        stream)
            : launch_bwd_shared<float>(g, idx, rows, cols, n, scratch, out, slices, device, sms,
                                       stream);
  return static_cast<int>(err);
}
