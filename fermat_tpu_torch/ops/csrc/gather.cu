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
//   * shared (at most 128 rows, whose partials fit in shared memory; the
//     CornellBox's 36 x 52): a CTA takes kBwdChunk consecutive lanes; thread (j, k) owns
//     column k of a private (R, K) partial for lane slice j (lanes j, j + S,
//     ...), so every add lands in a shared word no other thread writes, in
//     lane order; the S partials are summed in slice order into a (CTAs, R,
//     K) buffer, and a second launch sums that over the CTAs in CTA order.
//     Every sum has a fixed order: deterministic, the same bits every run.
//     Many lanes land on few rows, and no add waits for another thread's;
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

constexpr int kBwdChunk = 512;  // lanes per CTA (ops/gather.py BWD_CHUNK)
constexpr int kBwdSmem = 96 * 1024;  // ops/gather.py BWD_SMEM
constexpr int kUnroll = 8;

// Shared mode, pass 1: the CTA's (R, K) partial of its kBwdChunk lanes into
// part_out[blockIdx.x]. Threads j * cols + k for j < slices; the rest idle.
__global__ void gather_bwd_partial_kernel(const float* __restrict__ g,
                                          const int* __restrict__ idx, int rows, int cols,
                                          int n, int slices, float* __restrict__ part_out) {
  extern __shared__ float part[];  // (slices, rows, cols)
  const int rk = rows * cols;
  for (int e = threadIdx.x; e < slices * rk; e += blockDim.x) part[e] = 0.0f;
  __syncthreads();
  const int j = threadIdx.x / cols;
  const int k = threadIdx.x - j * cols;
  if (j < slices) {
    float* mine = part + j * rk + k;
    const int lo = blockIdx.x * kBwdChunk;
    const int hi = min(n, lo + kBwdChunk);
    // lanes lo + j, lo + j + S, ...: loads of kUnroll lanes in flight, then
    // their adds in lane order
    for (int base = lo + j; base < hi; base += kUnroll * slices) {
      int r[kUnroll];
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int ln = base + u * slices;
        r[u] = ln < hi ? __ldg(idx + ln) : -1;
        v[u] = (r[u] >= 0 && r[u] < rows) ? __ldg(g + static_cast<size_t>(ln) * cols + k)
                                          : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r[u] >= 0 && r[u] < rows) mine[r[u] * cols] += v[u];
      }
    }
  }
  __syncthreads();
  float* dst = part_out + static_cast<size_t>(blockIdx.x) * rk;
  for (int e = threadIdx.x; e < rk; e += blockDim.x) {
    float acc = part[e];
    for (int s2 = 1; s2 < slices; ++s2) acc += part[s2 * rk + e];
    dst[e] = acc;
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
// slices > 0: the shared mode with that many lane slices a CTA, part a
// (ceil(n / kBwdChunk), rows, cols) scratch buffer; slices == 0: the atomic
// mode (part unused). n * cols and rows * cols < 2^31.
extern "C" int fermat_gather_rows_bwd(const float* g, const int* idx, int rows, int cols,
                                      int n, float* part, float* out, int slices, int device,
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
  const int threads = ((slices * cols + 31) / 32) * 32;
  const size_t smem = static_cast<size_t>(slices) * rk * sizeof(float);
  if (threads > 1024 || smem > static_cast<size_t>(kBwdSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  err = cudaFuncSetAttribute(gather_bwd_partial_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctas = (n + kBwdChunk - 1) / kBwdChunk;
  gather_bwd_partial_kernel<<<ctas, threads, smem, stream>>>(g, idx, rows, cols, n, slices,
                                                              part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gather_bwd_sum_kernel<<<(rk + 31) / 32, 256, 0, stream>>>(part, ctas, rk, out);
  return static_cast<int>(cudaGetLastError());
}
