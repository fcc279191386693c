// K4: fused discrete-CDF pick and row fetch,
// out[n, :] = rows[min(upper_bound(cdf, u[n]), L - 1), :].
//
// Replaces fermat_tpu/ops/pallas_cdf_gather.py:cdf_pick_rows (kernel
// _pick_fetch_kernel :39, pallas_call :83). The Pallas kernel counts
// `cdf <= u` over 128-lane chunks of a lane-replicated CDF row and fetches
// the row with a one-hot matmul, because Mosaic has neither a per-lane
// binary search nor a gather. Here each thread binary-searches the CDF and
// the block then copies the picked rows out.
//   * upper_bound is the count of entries <= u (the CDF is non-decreasing),
//     written as `cdf[mid] <= u` so that a NaN u counts nothing and picks
//     row 0, as sum(cdf <= NaN) does; a u past the last entry picks L - 1;
//   * the block stages the CDF in shared memory when it has at most 4096
//     entries (16 KB) and reads it from global memory otherwise;
//   * the picks of a block's 256 lanes go to shared memory, and the block
//     writes its 256 x C output elements in order, so neighbouring threads
//     store neighbouring addresses.
// Exact: a copy, no arithmetic on the rows.
//
// Bound on H100: bytes (u in, N x C rows out, the table once); the search
// is ~log2(L) shared-memory reads per lane.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;
constexpr int kSharedCdf = 4096;

template <bool kStage>
__global__ void __launch_bounds__(kBlock)
pick_kernel(const float* __restrict__ rows, const float* __restrict__ cdf,
            const float* __restrict__ u, int n_rows, int cols, int n,
            float* __restrict__ out) {
  __shared__ float s_cdf[kStage ? kSharedCdf : 1];
  __shared__ int s_pick[kBlock];
  if constexpr (kStage) {
    for (int k = threadIdx.x; k < n_rows; k += kBlock) s_cdf[k] = cdf[k];
    __syncthreads();
  }
  const int base = blockIdx.x * kBlock;
  const int i = base + threadIdx.x;
  if (i < n) {
    const float x = u[i];
    int lo = 0, hi = n_rows;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const float c = kStage ? s_cdf[mid] : __ldg(cdf + mid);
      if (c <= x) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    s_pick[threadIdx.x] = min(lo, n_rows - 1);
  }
  __syncthreads();
  const int lanes = min(kBlock, n - base);
  const int total = lanes * cols;
  float* dst = out + static_cast<size_t>(base) * cols;
  for (int e = threadIdx.x; e < total; e += kBlock) {
    const int lane = e / cols;
    const int col = e - lane * cols;
    dst[e] = __ldg(rows + s_pick[lane] * cols + col);
  }
}

}  // namespace

extern "C" const char* fermat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// rows (L, C) f32, cdf (L,) f32 non-decreasing, u (N,) f32 -> out (N, C).
extern "C" int fermat_cdf_pick_rows(const float* rows, const float* cdf, const float* u,
                                    int n_rows, int cols, int n, float* out, int device,
                                    cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n == 0) return 0;
  const int blocks = (n + kBlock - 1) / kBlock;
  if (n_rows <= kSharedCdf) {
    pick_kernel<true><<<blocks, kBlock, 0, stream>>>(rows, cdf, u, n_rows, cols, n, out);
  } else {
    pick_kernel<false><<<blocks, kBlock, 0, stream>>>(rows, cdf, u, n_rows, cols, n, out);
  }
  return static_cast<int>(cudaGetLastError());
}
