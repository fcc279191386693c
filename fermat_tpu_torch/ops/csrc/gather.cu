// K2: row gather out[n, :] = table[idx[n], :] (exact float32 copy).
//
// Replaces fermat_tpu/ops/gather.py:_pallas_onehot_gather (kernel body
// _onehot_kernel, gather.py:41), which builds a (block, R) one-hot matrix in
// VMEM and multiplies it by the table on the MXU because Mosaic has no
// per-lane gather. A GPU thread can load any address, so this is a plain
// gather: no matmul form, hence no TF32 or bf16 rounding can arise.
//
// Bound on H100: bytes. Per call it must read idx (4 B/row) and write the
// output (4*K B/row); the table itself is tiny (<= 4096 rows). Design: one
// thread per output element in a grid-stride loop, so neighbouring threads
// store neighbouring addresses (coalesced); the table is staged once per
// block in shared memory when it fits in 48 KB (the path's 36x52 table is
// 7.5 KB), otherwise read through the read-only cache. An index outside
// [0, R) yields a zero row, as the padded one-hot does (gather.py:56-72).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;

template <bool kStage>
__global__ void __launch_bounds__(kBlock)
gather_rows_kernel(const float* __restrict__ table, const int* __restrict__ idx,
                   int rows, int cols, int total, float* __restrict__ out) {
  extern __shared__ float staged[];
  if constexpr (kStage) {
    for (int k = threadIdx.x; k < rows * cols; k += blockDim.x) staged[k] = table[k];
    __syncthreads();
  }
  const int stride = gridDim.x * blockDim.x;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += stride) {
    const int n = e / cols;
    const int k = e - n * cols;
    const int r = __ldg(idx + n);
    float val = 0.0f;
    if (r >= 0 && r < rows) {
      if constexpr (kStage) {
        val = staged[r * cols + k];
      } else {
        val = __ldg(table + r * cols + k);
      }
    }
    out[e] = val;
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
  const int total = n * cols;
  if (total == 0) return 0;
  int blocks = (total + kBlock - 1) / kBlock;
  if (blocks > 132 * 8) blocks = 132 * 8;  // grid-stride: ~8 blocks per SM
  const size_t table_bytes = static_cast<size_t>(rows) * cols * sizeof(float);
  if (table_bytes <= 48 * 1024) {
    gather_rows_kernel<true><<<blocks, kBlock, table_bytes, stream>>>(
        table, idx, rows, cols, total, out);
  } else {
    gather_rows_kernel<false><<<blocks, kBlock, 0, stream>>>(
        table, idx, rows, cols, total, out);
  }
  return static_cast<int>(cudaGetLastError());
}
