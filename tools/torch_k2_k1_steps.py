#!/usr/bin/env python3
"""K2 (the row gather, fermat_tpu_torch/ops/csrc/gather.cu) and K1a (the
dense closest-hit tracer, ops/csrc/trace.cu) step by step on one CUDA card,
at the main path's recorded inputs: the 17 K2 and 6 K1a launches of one
512x512 glossy CornellBox pass (chip_smoke.py phase 4) and the 11 K2
launches of one big_room(8300) 1600x896 pass (phase 4d), max_path_length=6.

    python3 tools/torch_k2_k1_steps.py --parent DIR [--timed NAME ...] [--alternate ROUNDS]
                                       [--builds NAME ...] [--out FILE]

DIR holds an unpacked checkout of an earlier commit (`git archive`): its
gather.cu and trace.cu are built as the parent kernels (the same C
signatures). The design steps are built from this checkout's sources, each
with the later steps taken out again, or a try put in, by exact text edits
(the script stops if one no longer applies). Each step is on top of the one
before:

K2 (gather.cu)
  parent             the parent commit's kernel: a thread per output element,
                     tables up to 48 KB staged in shared memory
  +rows              a warp copies 32 rows at a time, one index load a row,
                     16-byte vectors where the width and alignment allow; the
                     table read through L1/L2; the parent's grid (elements /
                     256, at most 1,056 blocks)
  +grid              the grid of the blocks that fit on the card at once
                     (occupancy), striding over the tiles beyond
  +streaming stores  every output written with st.global.cs
  +stores by size    st.global.cs only for an output larger than L2, plain
                     stores for one that the next kernels read back from
                     L2
  +one-column rows   a one-vector row (the 1-column pdf) copied a thread a
                     row, no shuffle: this checkout
Tries, on top of this checkout:
  +staging           tables up to 64 KB staged once per block in dynamic
                     shared memory
  +evict_last        the table read with an L2 evict_last policy
  +one tile a warp   a grid of one 32-row tile a warp, no striding
  +packed stores     widths that are no multiple of 4 written as float4
                     stores too, each packed from four scalar reads (with
                     st.global.cs)

K1a (trace.cu)
  parent             the parent commit's kernel: a thread per lane, 128
                     triangles a tile as nine scalar rows
  +compaction        each block's 256 active lanes compacted into a shared
                     list (ballot, warp counts), a thread per active ray,
                     loaded through the list, results to each ray's own
                     lane; the parent's full test
  +cheaper tests     the test returns at the first det, u or v bound that
                     rejects; 1/det as __frcp_rn
  +records           the triangles as three float4 records, up to 1,024 a
                     tile (one tile, one barrier for the path's 36)
  +split             a sparse block's rays shared by 2-8 threads each, every
                     g-th triangle a thread, a shuffle reduction to the
                     nearest hit
  +two-lane chunks   512 lanes a block, two a thread (two rays a slot where
                     the block has more rays than threads), where the launch
                     still gives two blocks an SM (the path's 262,144 lanes)
  +cached lanes      ops/trace.py: trace_closest's number tmin and tmax as
                     cached constant lanes, not a fill kernel each per call
                     (the steps before run with ops/trace.py's _lanes in its
                     place, as the parent did): this checkout
Tries, on top of this checkout:
  +whole soup        4,096 triangles a tile (192 KB of shared memory)
  +div               1.0f / det in place of __frcp_rn(det)
  +min blocks 4      __launch_bounds__(256, 4): at most 64 registers
  +full test         the parent's full test in place of the early returns
  +rays in shared memory  each active lane loads its own ray before the
                     compaction and leaves it in the shared list

K1a is timed through its wrapper (trace_closest, as the path calls it) and
alone (its C entry point on launch arguments made once). For each build:
every recorded launch against its plain version (K2 exact,
K1a's t/u/v bits and tri) and against the parent's output, bit for bit; two
launches bit-equal. A step that fails is reported, not timed, and the script
exits non-zero. Then, for the steps named by --timed (default: all), each
recorded launch is timed in replay (CUDA events around each of 20
back-to-back replays behind a spin kernel: median, min, max; cold with 128
MiB written before each replay), and K1a also at 65,536 random rays against
random_soup(4096) (the tile-size question; not a main-path shape) and at
the first launch's rays with no lane and every 64th lane active (its
floor, and a sparse bounce), each checked like the rest. Every
build prints ptxas's registers, stack frame and spill bytes per kernel. The
unchanged kernels, K1b (any_kernel, at the pass's 6 launches) and K2b
(gather_rows_bwd, at the idx of the pass's 52-column launches with a seeded
cotangent), are timed with each of the parent's and this checkout's
builds. The order is parent, the steps, the tries, then parent and this
checkout again, so drift within the call shows. --alternate ROUNDS then
binds the builds named by --builds (default: parent this; a step or try of
one file goes with this checkout's other file) in turn, in order and then
in reverse (A, B, C, C, B, A, ...), and times, ROUNDS each, one dense CornellBox pass and
one big_room pass through RenderingContext: ms/pass on the host's clock
(best of 3 batches of 8 and of 3 passes) and the device-busy time of one
profiled pass, with K1a's and K2's device time in it. Prints one JSON line
per build and round; --out writes them all as one JSON file.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
from torch_steps_common import (FLUSH_BYTES, bind, build, edited, filled_lanes,  # noqa: E402
                                log, record_pass, replay)

RES, MPL, PASSES, REPS = 512, 6, 8, 3
BIG_BOXES, BIG_W, BIG_H, BIG_PASSES = 8300, 1600, 896, 3
N_SOUP = 65_536

# ---- gather.cu: the exact text edits that take a step out or put a try in
# (old, new[, count]) ----
KERNEL_HEAD = "// V: float4 (q = cols / 4) or float (q = cols); kStream: streaming stores\n"
KERNEL_SIG = (
    "template <typename V, bool kStream>\n"
    "__global__ void __launch_bounds__(kBlock)\n"
    "gather_rows_kernel(const V* __restrict__ table, const int* __restrict__ idx, int rows, int q,\n"
    "                   int n, V* __restrict__ out) {\n")
TABLE_LOAD = "val = __ldg(table + ri * q + c);"
LAUNCH_GATHER = (
    "template <typename V, bool kStream>\n"
    "cudaError_t launch_gather(const float* table, const int* idx, int rows, int q, int n,\n"
    "                          float* out, int sms, cudaStream_t stream) {\n"
    "  int per_sm = 0;\n"
    "  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n"
    "      &per_sm, gather_rows_kernel<V, kStream>, kBlock, 0);\n"
    "  if (err != cudaSuccess) return err;\n"
    "  const int tiles = (n + 31) / 32;\n"
    "  const int blocks = min((tiles + kBlock / 32 - 1) / (kBlock / 32), max(per_sm, 1) * sms);\n"
    "  gather_rows_kernel<V, kStream><<<blocks, kBlock, 0, stream>>>(\n"
    "      reinterpret_cast<const V*>(table), idx, rows, q, n, reinterpret_cast<V*>(out));\n"
    "  return cudaGetLastError();\n"
    "}\n")
OCCUPANCY_GRID = (
    "  int per_sm = 0;\n"
    "  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n"
    "      &per_sm, gather_rows_kernel<V, kStream>, kBlock, 0);\n"
    "  if (err != cudaSuccess) return err;\n"
    "  const int tiles = (n + 31) / 32;\n"
    "  const int blocks = min((tiles + kBlock / 32 - 1) / (kBlock / 32), max(per_sm, 1) * sms);\n")
PARENT_GRID = [(OCCUPANCY_GRID,
                "  const int blocks = min((n * q * static_cast<int>(sizeof(V) / sizeof(float)) + kBlock - 1)"
                " / kBlock, 132 * 8);\n")]
STORES_BY_SIZE = ("  const bool big = static_cast<size_t>(n) * cols * sizeof(float) > "
                  "static_cast<size_t>(l2);\n")
PLAIN_STORES = [(STORES_BY_SIZE, "  const bool big = false;\n")]
STREAMING_STORES = [(STORES_BY_SIZE, "  const bool big = true;\n")]
ONE_TILE_A_WARP = [(
    "  const int blocks = min((tiles + kBlock / 32 - 1) / (kBlock / 32), max(per_sm, 1) * sms);\n",
    "  const int blocks = (tiles + kBlock / 32 - 1) / (kBlock / 32);\n")]
EVICT_LAST = [
    (KERNEL_HEAD,
     "__device__ __forceinline__ float4 ld_keep(const float4* p) {\n"
     "  float4 v;\n"
     "  asm(\"{\\n\\t.reg .b64 pol;\\n\\tcreatepolicy.fractional.L2::evict_last.b64 pol, 1.0;\\n\\t\"\n"
     "      \"ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], pol;\\n\\t}\"\n"
     "      : \"=f\"(v.x), \"=f\"(v.y), \"=f\"(v.z), \"=f\"(v.w) : \"l\"(p));\n"
     "  return v;\n"
     "}\n"
     "__device__ __forceinline__ float ld_keep(const float* p) {\n"
     "  float v;\n"
     "  asm(\"{\\n\\t.reg .b64 pol;\\n\\tcreatepolicy.fractional.L2::evict_last.b64 pol, 1.0;\\n\\t\"\n"
     "      \"ld.global.nc.L2::cache_hint.f32 %0, [%1], pol;\\n\\t}\" : \"=f\"(v) : \"l\"(p));\n"
     "  return v;\n"
     "}\n\n" + KERNEL_HEAD),
    (TABLE_LOAD, "val = ld_keep(table + ri * q + c);"),
]
# tables of at most 64 KB staged once per block in dynamic shared memory
STAGING = [
    (KERNEL_HEAD,
     "// the most table bytes a block stages in shared memory (three blocks an SM\n"
     "// still fit); a larger table is read through L2\n"
     "constexpr int kStageMax = 64 * 1024;\n"
     "\n"
     "template <typename V, bool kStage>\n"
     "__device__ __forceinline__ V fetch(const V* __restrict__ table, const V* staged, int at) {\n"
     "  if constexpr (kStage) {\n"
     "    return staged[at];\n"
     "  } else {\n"
     "    return __ldg(table + at);\n"
     "  }\n"
     "}\n"
     "\n" + KERNEL_HEAD),
    (KERNEL_SIG,
     KERNEL_SIG.replace("bool kStream>", "bool kStream, bool kStage>")
     + "  extern __shared__ float4 smem[];\n"
       "  V* staged = reinterpret_cast<V*>(smem);\n"
       "  if constexpr (kStage) {\n"
       "    for (int k = threadIdx.x; k < rows * q; k += kBlock) staged[k] = __ldg(table + k);\n"
       "    __syncthreads();\n"
       "  }\n"),
    (TABLE_LOAD, "val = fetch<V, kStage>(table, staged, ri * q + c);"),
    (LAUNCH_GATHER,
     "template <typename V, bool kStream, bool kStage>\n"
     "cudaError_t launch_staged(const float* table, const int* idx, int rows, int q, int n,\n"
     "                          float* out, int sms, cudaStream_t stream) {\n"
     "  const int smem = kStage ? rows * q * static_cast<int>(sizeof(V)) : 0;\n"
     "  cudaError_t err = cudaSuccess;\n"
     "  if (smem > 48 * 1024) {\n"
     "    err = cudaFuncSetAttribute(gather_rows_kernel<V, kStream, kStage>,\n"
     "                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);\n"
     "    if (err != cudaSuccess) return err;\n"
     "  }\n"
     "  int per_sm = 0;\n"
     "  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(\n"
     "      &per_sm, gather_rows_kernel<V, kStream, kStage>, kBlock, smem);\n"
     "  if (err != cudaSuccess) return err;\n"
     "  const int tiles = (n + 31) / 32;\n"
     "  const int blocks = min((tiles + kBlock / 32 - 1) / (kBlock / 32), max(per_sm, 1) * sms);\n"
     "  gather_rows_kernel<V, kStream, kStage><<<blocks, kBlock, smem, stream>>>(\n"
     "      reinterpret_cast<const V*>(table), idx, rows, q, n, reinterpret_cast<V*>(out));\n"
     "  return cudaGetLastError();\n"
     "}\n"
     "\n"
     "template <typename V, bool kStream>\n"
     "cudaError_t launch_gather(const float* table, const int* idx, int rows, int q, int n,\n"
     "                          float* out, int sms, cudaStream_t stream) {\n"
     "  return static_cast<size_t>(rows) * q * sizeof(V) <= kStageMax\n"
     "             ? launch_staged<V, kStream, true>(table, idx, rows, q, n, out, sms, stream)\n"
     "             : launch_staged<V, kStream, false>(table, idx, rows, q, n, out, sms, stream);\n"
     "}\n"),
]
# the steps before "+one-column rows": a one-vector row (the path's 1-column
# pdf) goes through the 32-row tile loop too
NO_ONE_COLUMN = [(
    "  if (q == 1) {\n"
    "    for (int i = blockIdx.x * kBlock + threadIdx.x; i < n; i += gridDim.x * kBlock) {\n"
    "      const int ri = __ldg(idx + i);\n"
    "      V val{};\n"
    "      if (ri >= 0 && ri < rows) val = __ldg(table + ri);\n"
    "      if constexpr (kStream) {\n"
    "        __stcs(out + i, val);\n"
    "      } else {\n"
    "        out[i] = val;\n"
    "      }\n"
    "    }\n"
    "    return;\n"
    "  }\n"
    "  const int lane = threadIdx.x & 31;\n",
    "  const int lane = threadIdx.x & 31;\n")]

# the widths that are no multiple of 4 (the path's 23- and 1-column tables)
# written as packed float4 stores too, each packed from four scalar reads
PACKED_STORES = [
    ("template <typename V, bool kStream>\ncudaError_t launch_gather(",
     "// any width: a tile's 32 rows of K floats are 8 * K float4 of output; lane l\n// packs float4s l, l + 32, ... from four scalar reads, each float's (row,\n// column) stepped as the scalar path steps them\n__global__ void __launch_bounds__(kBlock)\ngather_rows_packed_kernel(const float* __restrict__ table, const int* __restrict__ idx,\n                          int rows, int cols, int n, float* __restrict__ out) {\n  const int lane = threadIdx.x & 31;\n  const int r0 = 4 * lane / cols, c0 = 4 * lane - r0 * cols;\n  const int dr = 128 / cols, dc = 128 - dr * cols;\n  const int tiles = (n + 31) >> 5;\n  for (int tile = blockIdx.x * (kBlock / 32) + (threadIdx.x >> 5); tile < tiles;\n       tile += gridDim.x * (kBlock / 32)) {\n    const int row0 = tile << 5;\n    const int valid = min(32, n - row0);\n    const int mine = lane < valid ? __ldg(idx + row0 + lane) : -1;\n    float* dst = out + static_cast<size_t>(row0) * cols;\n    int r = r0, c = c0;\n    for (int f0 = 0; f0 < 8 * cols; f0 += 32) {\n      const int f = f0 + lane;\n      float v[4];\n      int rj[4];\n      int rr = r, cc = c;\n#pragma unroll\n      for (int j = 0; j < 4; ++j) {\n        const int ri = __shfl_sync(0xffffffffu, mine, rr & 31);\n        rj[j] = rr;\n        v[j] = (ri >= 0 && ri < rows) ? __ldg(table + ri * cols + cc) : 0.0f;\n        if (++cc == cols) {\n          cc = 0;\n          ++rr;\n        }\n      }\n      if (f < 8 * cols) {\n        if (rj[3] < valid) {\n          __stcs(reinterpret_cast<float4*>(dst) + f, make_float4(v[0], v[1], v[2], v[3]));\n        } else {\n#pragma unroll\n          for (int j = 0; j < 4; ++j)\n            if (rj[j] < valid) __stcs(dst + 4 * f + j, v[j]);\n        }\n      }\n      r += dr;\n      c += dc;\n      if (c >= cols) {\n        c -= cols;\n        ++r;\n      }\n    }\n  }\n}\n\ncudaError_t launch_packed(const float* table, const int* idx, int rows, int cols, int n,\n                          float* out, int device, cudaStream_t stream) {\n  int sms = 0, per_sm = 0;\n  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);\n  if (err != cudaSuccess) return err;\n  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_rows_packed_kernel,\n                                                      kBlock, 0);\n  if (err != cudaSuccess) return err;\n  const int tiles = (n + 31) / 32;\n  const int blocks = min((tiles + kBlock / 32 - 1) / (kBlock / 32), max(per_sm, 1) * sms);\n  gather_rows_packed_kernel<<<blocks, kBlock, 0, stream>>>(table, idx, rows, cols, n, out);\n  return cudaGetLastError();\n}\n\n" + "template <typename V, bool kStream>\ncudaError_t launch_gather(", 1),
    ("    err = big ? launch_gather<float, true>(table, idx, rows, cols, n, out, sms, stream)\n",
     "    err = (reinterpret_cast<uintptr_t>(out) & 15u) == 0\n"
     "              ? launch_packed(table, idx, rows, cols, n, out, device, stream)\n"
     "          : big ? launch_gather<float, true>(table, idx, rows, cols, n, out, sms, stream)\n"),
]

# ---- trace.cu ----
RECORD_TEST_HEAD = (
    "__device__ __forceinline__ bool closest_test(const float4* __restrict__ rec, const Ray& r,\n"
    "                                             float tmin, float tmax, float* t, float* u,\n"
    "                                             float* v) {\n"
    "  const float4 ra = rec[0], rb = rec[1], rc = rec[2];\n"
    "  const float p0x = ra.x, p0y = ra.y, p0z = ra.z;\n"
    "  const float e1x = rb.x, e1y = rb.y, e1z = rb.z;\n"
    "  const float e2x = rc.x, e2y = rc.y, e2z = rc.z;\n")
RECORD_STAGE = (
    "  for (int c = threadIdx.x; c < cnt; c += kBlock) {\n"
    "    const float* t = tris + base + c;\n"
    "    rec[3 * c] = make_float4(t[0], t[n_tris], t[2 * n_tris], 0.0f);\n"
    "    rec[3 * c + 1] = make_float4(t[3 * n_tris], t[4 * n_tris], t[5 * n_tris], 0.0f);\n"
    "    rec[3 * c + 2] = make_float4(t[6 * n_tris], t[7 * n_tris], t[8 * n_tris], 0.0f);\n"
    "  }\n")
# nine scalar rows of 128 triangles (the parent's layout) in the dynamic buffer
SCALAR_TILES = [
    ("constexpr int kTileTris = 1024;\n", "constexpr int kTileTris = 128;\n", 1),
    (RECORD_TEST_HEAD,
     "__device__ __forceinline__ bool closest_test(const float* __restrict__ s, const Ray& r,\n"
     "                                             float tmin, float tmax, float* t, float* u,\n"
     "                                             float* v) {\n"
     "  const float p0x = s[0], p0y = s[kTileTris], p0z = s[2 * kTileTris];\n"
     "  const float e1x = s[3 * kTileTris], e1y = s[4 * kTileTris], e1z = s[5 * kTileTris];\n"
     "  const float e2x = s[6 * kTileTris], e2y = s[7 * kTileTris], e2z = s[8 * kTileTris];\n", 1),
    (RECORD_STAGE,
     "  float* s = reinterpret_cast<float*>(rec);\n"
     "  for (int k = threadIdx.x; k < 9 * kTileTris; k += kBlock) {\n"
     "    const int row = k / kTileTris;\n"
     "    const int col = k - row * kTileTris;\n"
     "    s[k] = col < cnt ? tris[row * n_tris + base + col] : 0.0f;\n"
     "  }\n", 1),
    ("closest_test(rec + 3 * c, ", "closest_test(reinterpret_cast<const float*>(rec) + c, ", 1),
    ("  const size_t smem = 3 * sizeof(float4) * static_cast<size_t>(max(1, min(n_tris, kTileTris)));\n",
     "  const size_t smem = 9 * sizeof(float) * kTileTris;\n", 1),
]
EARLY_OUT_BODY = (
    "  if (!(fabsf(det) > kEpsDet)) return false;\n"
    "  const float inv_det = __frcp_rn(det);\n"
    "  const float tvx = r.ox - p0x;\n"
    "  const float tvy = r.oy - p0y;\n"
    "  const float tvz = r.oz - p0z;\n"
    "  const float uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;\n"
    "  if (!(uu >= 0.0f && uu <= 1.0f)) return false;\n"
    "  const float qvx = tvy * e1z - tvz * e1y;\n"
    "  const float qvy = tvz * e1x - tvx * e1z;\n"
    "  const float qvz = tvx * e1y - tvy * e1x;\n"
    "  const float vv = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;\n"
    "  if (!(vv >= 0.0f && uu + vv <= 1.0f)) return false;\n"
    "  const float tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;\n"
    "  if (!(tt > tmin && tt < tmax)) return false;\n"
    "  *t = tt;\n"
    "  *u = uu;\n"
    "  *v = vv;\n"
    "  return true;\n")
# the parent's hit_test arithmetic: every test runs to its end
FULL_TEST = [(EARLY_OUT_BODY,
              "  const bool det_ok = fabsf(det) > kEpsDet;\n"
              "  const float inv_det = det_ok ? 1.0f / det : 0.0f;\n"
              "  const float tvx = r.ox - p0x;\n"
              "  const float tvy = r.oy - p0y;\n"
              "  const float tvz = r.oz - p0z;\n"
              "  const float uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det;\n"
              "  const float qvx = tvy * e1z - tvz * e1y;\n"
              "  const float qvy = tvz * e1x - tvx * e1z;\n"
              "  const float qvz = tvx * e1y - tvy * e1x;\n"
              "  const float vv = (r.dx * qvx + r.dy * qvy + r.dz * qvz) * inv_det;\n"
              "  const float tt = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det;\n"
              "  *t = tt;\n"
              "  *u = uu;\n"
              "  *v = vv;\n"
              "  return det_ok && uu >= 0.0f && vv >= 0.0f && uu + vv <= 1.0f && tt > tmin && "
              "tt < tmax;\n", 1)]
NO_SPLIT = [("constexpr int kSplit = 8;", "constexpr int kSplit = 1;", 1)]
# each block's lanes one a thread (256 a block), whatever the launch's size
ONE_LANE = [("  err = (n + 2 * kBlock - 1) / (2 * kBlock) >= 2 * sms\n", "  err = false\n", 1)]
# each active lane loads its own ray before the compaction and leaves it in
# a shared list beside its lane, where its slot thread reads it
SMEM_RAYS = [
    ("// kRays: lanes a thread compacts (kBlock * kRays a block)\n",
     "// an active ray, loaded by its own lane, as two float4 (o.xyz d.x, d.yz tmin tmax)\n"
     "__device__ __forceinline__ void load_rec(float4* dst, const RayPtrs& p,\n"
     "                                         const float* __restrict__ tmin,\n"
     "                                         const float* __restrict__ tmax, int i) {\n"
     "  dst[0] = make_float4(p.ox[i], p.oy[i], p.oz[i], p.dx[i]);\n"
     "  dst[1] = make_float4(p.dy[i], p.dz[i], tmin[i], tmax[i]);\n"
     "}\n\n"
     "// kRays: lanes a thread compacts (kBlock * kRays a block)\n", 1),
    ("  __shared__ int list[kLanes];     // the block's active lanes, in lane order\n",
     "  __shared__ float4 rays[2 * kLanes];  // the block's active rays, in lane order\n"
     "  __shared__ int list[kLanes];         // and their lanes\n", 1),
    ("  unsigned ballot[kRays];\n", "  unsigned ballot[kRays];\n  float4 mine[kRays][2];\n", 1),
    ("    if (live && !work[k]) {\n",
     "    if (work[k]) {\n      load_rec(mine[k], ray, tmin, tmax, i);\n    } else if (live) {\n", 1),
    ("      list[pos] = first + k * kBlock + threadIdx.x;\n",
     "      rays[2 * pos] = mine[k][0];\n      rays[2 * pos + 1] = mine[k][1];\n"
     "      list[pos] = first + k * kBlock + threadIdx.x;\n", 1),
    ("      r[k] = load_ray(ray, at[k]);\n      lo[k] = tmin[at[k]];\n      tb[k] = tmax[at[k]];\n",
     "      const float4 a = rays[2 * s], b = rays[2 * s + 1];\n"
     "      r[k] = Ray{a.x, a.y, a.z, a.w, b.x, b.y};\n      lo[k] = b.z;\n      tb[k] = b.w;\n",
     1),
]
WHOLE_SOUP = [("constexpr int kTileTris = 1024;\n", "constexpr int kTileTris = 4096;\n", 1)]
DIV = [("  const float inv_det = __frcp_rn(det);\n", "  const float inv_det = 1.0f / det;\n", 1)]
MIN_BLOCKS_4 = [("__global__ void __launch_bounds__(kBlock)\nclosest_kernel(",
                 "__global__ void __launch_bounds__(kBlock, 4)\nclosest_kernel(", 1)]

K2_STEPS = ["parent", "+rows", "+grid", "+streaming stores", "+stores by size",
            "+one-column rows"]
K2_TRIES = ["+staging", "+evict_last", "+one tile a warp", "+packed stores"]
K1_STEPS = ["parent", "+compaction", "+cheaper tests", "+records", "+split",
            "+two-lane chunks", "+cached lanes"]
K1_TRIES = ["+whole soup", "+div", "+min blocks 4", "+full test", "+rays in shared memory"]
HERE = {"gather.cu": "+one-column rows", "trace.cu": "+cached lanes"}  # this checkout's build
# the step that changes ops/trace.py alone (the source is the step's before
# it); the steps before it run with a fill per call for tmin and tmax
CACHED_LANES = "+cached lanes"


def step_sources(gather_here: str, trace_here: str, gather_parent: str,
                 trace_parent: str) -> dict:
    """{(source file, step): source text} for every step and try."""
    g = lambda edits: edited(gather_here, edits, "gather.cu")
    t = lambda edits: edited(trace_here, edits, "trace.cu")
    return {
        ("gather.cu", "parent"): gather_parent,
        ("gather.cu", "+rows"): g(NO_ONE_COLUMN + PARENT_GRID + PLAIN_STORES),
        ("gather.cu", "+grid"): g(NO_ONE_COLUMN + PLAIN_STORES),
        ("gather.cu", "+streaming stores"): g(NO_ONE_COLUMN + STREAMING_STORES),
        ("gather.cu", "+stores by size"): g(NO_ONE_COLUMN),
        ("gather.cu", "+one-column rows"): gather_here,
        ("gather.cu", "+staging"): g(STAGING),
        ("gather.cu", "+evict_last"): g(EVICT_LAST),
        ("gather.cu", "+one tile a warp"): g(ONE_TILE_A_WARP),
        ("gather.cu", "+packed stores"): g(PACKED_STORES),
        ("trace.cu", "parent"): trace_parent,
        ("trace.cu", "+compaction"): t(ONE_LANE + NO_SPLIT + FULL_TEST + SCALAR_TILES),
        ("trace.cu", "+cheaper tests"): t(ONE_LANE + NO_SPLIT + SCALAR_TILES),
        ("trace.cu", "+records"): t(ONE_LANE + NO_SPLIT),
        ("trace.cu", "+split"): t(ONE_LANE),
        ("trace.cu", "+two-lane chunks"): trace_here,
        ("trace.cu", "+cached lanes"): trace_here,
        ("trace.cu", "+whole soup"): t(WHOLE_SOUP),
        ("trace.cu", "+div"): t(DIV),
        ("trace.cu", "+min blocks 4"): t(MIN_BLOCKS_4),
        ("trace.cu", "+full test"): t(FULL_TEST),
        ("trace.cu", "+rays in shared memory"): t(SMEM_RAYS),
    }


KERNELS = ("closest_kernel", "any_kernel", "gather_rows_kernel", "gather_rows_packed_kernel",
           "gather_bwd_partial_kernel", "gather_bwd_sum_kernel", "gather_bwd_atomic_kernel")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="an unpacked checkout of the commit whose K2 and K1a are the parent")
    ap.add_argument("--timed", nargs="*", default=None,
                    help="time only these steps (all are built and checked)")
    ap.add_argument("--alternate", type=int, default=0, metavar="ROUNDS",
                    help="then time the builds named by --builds end to end, alternating")
    ap.add_argument("--builds", nargs="+", default=["parent", "this"],
                    help="the builds --alternate times: parent (both files), this (this "
                         "checkout), or a step or try of one file (with this checkout's other)")
    ap.add_argument("--out", type=Path, default=None)
    a = ap.parse_args()
    builds = {}
    for name in a.builds:
        if name == "parent":
            builds[name] = {"gather.cu": "parent", "trace.cu": "parent"}
        elif name in K2_STEPS + K2_TRIES or name in K1_STEPS + K1_TRIES:
            builds[name] = dict(HERE, **{"gather.cu" if name in K2_STEPS + K2_TRIES
                                         else "trace.cu": name})
        elif name == "this":
            builds[name] = dict(HERE)
        else:
            ap.error(f"--builds: no step or try named {name!r}")
    if not torch.cuda.is_available():
        print("torch_k2_k1_steps: no CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from fermat_tpu_torch.core.math import Vec3
    from fermat_tpu_torch.integrators import pt
    from fermat_tpu_torch.ops import _cuda
    from fermat_tpu_torch.ops import gather as gather_mod
    from fermat_tpu_torch.ops import trace as trace_mod
    from fermat_tpu_torch.render.context import RenderingContext
    from fermat_tpu_torch.scene.procedural import (big_room, big_room_camera, cornell_box,
                                                   cornell_camera, random_soup)

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    csrc = lambda root, f: (root / "fermat_tpu_torch" / "ops" / "csrc" / f).read_text()
    variants = step_sources(csrc(ROOT, "gather.cu"), csrc(ROOT, "trace.cu"),
                            csrc(a.parent, "gather.cu"), csrc(a.parent, "trace.cu"))
    built = build({k: (k[0], v) for k, v in variants.items()}, _cuda.BUILD_DIR / "k2_k1_steps",
                  KERNELS)
    for fname in ("gather.cu", "trace.cu"):
        for step in {"parent", HERE[fname], *(b[fname] for b in builds.values())}:
            if built[(fname, step)][0] is None:
                raise SystemExit(f"{fname} {step} did not build")
    gather_kerns = [gather_mod.GATHER, gather_mod.GATHER_BWD]
    trace_kerns = [trace_mod.CLOSEST, trace_mod.ANY]
    libs = {}
    for (fname, step), (so, _, _) in built.items():
        if so is not None:
            libs[(fname, step)] = bind(so, gather_kerns if fname == "gather.cu" else trace_kerns)

    cached = trace_mod._lanes

    def use(fname, step):
        for kern, (fn, err) in zip(gather_kerns if fname == "gather.cu" else trace_kerns,
                                   libs[(fname, step)]):
            kern._fn, kern._err = fn, err
        if fname == "trace.cu":
            before = step in K1_STEPS and K1_STEPS.index(step) < K1_STEPS.index(CACHED_LANES)
            trace_mod._lanes = filled_lanes if before else cached

    # ---- the main path's inputs, recorded with this checkout's kernels ----
    use("gather.cu", HERE["gather.cu"])
    use("trace.cu", HERE["trace.cu"])
    ctx = RenderingContext.create(cornell_box(glossy_boxes=True), cornell_camera(), RES, RES,
                                  renderer="pt", max_path_length=MPL)
    dense = record_pass(ctx.view, pt.PTOptions(**ctx.renderer_options), RES, RES)
    bctx = RenderingContext.create(big_room(BIG_BOXES), big_room_camera(), BIG_W, BIG_H,
                                   renderer="pt", max_path_length=MPL)
    big = record_pass(bctx.view, pt.PTOptions(**bctx.renderer_options), BIG_W, BIG_H)
    rec = {"dense_k2": dense["k2"], "big_k2": big["k2"], "k1a": dense["k1a"],
           "k1b": dense["k1b"]}
    lanes = lambda x, n: trace_mod._lanes(x, n, dev)
    k1a = []
    for tris, o, d, tmin, tmax, active in rec["k1a"]:
        n = o.x.shape[0]
        act = active if active is not None else torch.ones(n, dtype=torch.bool, device=dev)
        k1a.append((tris, o, d, tmin, tmax, active, lanes(tmin, n), lanes(tmax, n), act))
    soup = random_soup(4096)
    soup_tris = soup.device_view(dev).tri_soup()
    gen = torch.Generator(device=dev).manual_seed(20261017)
    lo = torch.tensor(soup.vertices.min(0), device=dev)[:, None]
    hi = torch.tensor(soup.vertices.max(0), device=dev)[:, None]
    so = torch.rand(3, N_SOUP, generator=gen, device=dev) * (hi - lo) + lo
    sd = torch.randn(3, N_SOUP, generator=gen, device=dev)
    sd = sd / sd.norm(dim=0, keepdim=True)
    s_act = torch.rand(N_SOUP, generator=gen, device=dev) < 0.8
    soup_case = (soup_tris, Vec3(*so), Vec3(*sd), 1e-4, 3.0e38, s_act, lanes(1e-4, N_SOUP),
                 lanes(3.0e38, N_SOUP), s_act)
    # the first launch's rays with no lane and every 64th lane active: the
    # launch's floor, and its cost at a sparse bounce
    c0 = k1a[0]
    n0 = c0[1].x.shape[0]
    extra = {"soup4096": soup_case}
    for label, keep in (("no lane active", torch.zeros(n0, dtype=torch.bool, device=dev)),
                        ("every 64th lane active", torch.arange(n0, device=dev) % 64 == 0)):
        extra[label] = (*c0[:5], keep, c0[6], c0[7], keep)
    k1a_direct = []  # the kernel alone: its launch arguments made once
    for c in k1a:
        n = c[1].x.shape[0]
        args = trace_mod._kernel_args(c[0], c[1], c[2], c[6], c[7], c[8])
        outs = [torch.empty(n, device=dev), torch.empty(n, dtype=torch.int32, device=dev),
                torch.empty(n, device=dev), torch.empty(n, device=dev)]
        k1a_direct.append(([a.data_ptr() for a in args], c[0].shape[1], n,
                           [x.data_ptr() for x in outs], args, outs))
    bwd_in = []  # K2b at the idx of the 52-column launches, a seeded cotangent
    for key in ("dense_k2", "big_k2"):
        for table, idx in rec[key]:
            if table.shape[1] == 52:
                g = torch.randn(idx.shape[0], 52, generator=gen, device=dev)
                bwd_in.append((key, g, idx, table.shape[0]))
    log(f"recorded: K2 {len(rec['dense_k2'])} dense launches "
        f"{sorted({(tuple(t.shape), i.shape[0]) for t, i in rec['dense_k2']})}, "
        f"{len(rec['big_k2'])} big_room launches "
        f"{sorted({(tuple(t.shape), i.shape[0]) for t, i in rec['big_k2']})}; K1a "
        f"{len(k1a)} launches, active lanes {[int(c[8].sum()) for c in k1a]} of "
        f"{k1a[0][1].x.shape[0]}, {k1a[0][0].shape[1]} triangles; K1b {len(rec['k1b'])}")

    # the plain answers, once
    plain_k2 = {key: [gather_mod._gather_plain(t, i) for t, i in rec[key]]
                for key in ("dense_k2", "big_k2")}
    plain_k1 = [trace_mod._closest_plain(c[0], c[1], c[2], c[6], c[7], c[8]) for c in k1a]
    plain_extra = {k: trace_mod._closest_plain(*c[:3], *c[6:]) for k, c in extra.items()}
    torch.cuda.synchronize()
    bits = lambda t: t.contiguous().view(torch.int32)
    flush = torch.empty(FLUSH_BYTES // 4, device=dev)

    def timed_set(calls):
        """Per launch of calls [(label, fn)]: warm and cold replay times;
        with the mean over the launches of each figure."""
        each = [{"launch": lab, "warm": replay(fn, False, flush), "cold": replay(fn, True, flush)}
                for lab, fn in calls]
        mean = {w: {k: statistics.fmean(e[w][k] for e in each) for k in ("us", "us_min", "us_max")}
                for w in ("warm", "cold")}
        return {"each": each, **mean}

    def k1a_hit(c):
        return trace_mod.trace_closest(c[0], c[1], c[2], c[3], c[4], c[5])

    parent_out = {}

    def check_gather(step, row):
        bad = []
        for key in ("dense_k2", "big_k2"):
            for k, ((table, idx), want) in enumerate(zip(rec[key], plain_k2[key])):
                got = gather_mod.gather_rows(table, idx)
                again = gather_mod.gather_rows(table, idx)
                torch.cuda.synchronize()
                if not torch.equal(bits(got), bits(want)):
                    bad.append(f"{key}[{k}] differs from plain")
                if not torch.equal(bits(got), bits(again)):
                    bad.append(f"{key}[{k}]: two launches differ")
                if step == "parent":
                    parent_out[(key, k)] = got
                elif not torch.equal(bits(got), bits(parent_out[(key, k)])):
                    bad.append(f"{key}[{k}] differs from the parent")
        row["failed"] = bad

    def check_trace(step, row):
        bad = []
        labels = [f"k1a[{k}]" for k in range(len(k1a))] + list(extra)
        for k, (lab, c, want) in enumerate(zip(labels, [*k1a, *extra.values()],
                                               [*plain_k1, *plain_extra.values()])):
            got, again = k1a_hit(c), k1a_hit(c)
            torch.cuda.synchronize()
            same = lambda x, y: (torch.equal(x.tri, y.tri) and all(
                torch.equal(bits(p), bits(q)) for p, q in ((x.t, y.t), (x.u, y.u), (x.v, y.v))))
            if not same(got, want):
                bad.append(f"{lab} differs from plain")
            if not same(got, again):
                bad.append(f"{lab}: two launches differ")
            if step == "parent":
                parent_out[("k1a", k)] = got
            elif not same(got, parent_out[("k1a", k)]):
                bad.append(f"{lab} differs from the parent")
        row["failed"] = bad

    def time_gather(row, with_bwd):
        for key in ("dense_k2", "big_k2"):
            row[key] = timed_set([(f"{tuple(t.shape)} x {i.shape[0]}",
                                   (lambda t=t, i=i: gather_mod.gather_rows(t, i)))
                                  for t, i in rec[key]])
        if with_bwd:
            for key in ("dense_k2", "big_k2"):
                row[key.replace("k2", "k2b")] = timed_set([
                    (f"{g.shape[0]} x 52 into {r} rows",
                     (lambda g=g, i=i, r=r: gather_mod.gather_rows_bwd(g, i, r)))
                    for k, g, i, r in bwd_in if k == key])

    def time_trace(row, with_any):
        row["k1a"] = timed_set([(f"{int(c[8].sum())} active", (lambda c=c: k1a_hit(c)))
                                for c in k1a])
        row["k1a_kernel"] = timed_set([
            (f"{int(c[8].sum())} active",
             (lambda p=p, t=t, n=n, q=q: trace_mod.CLOSEST.launch(dev, *p, t, n, *q)))
            for c, (p, t, n, q, _, _) in zip(k1a, k1a_direct)])
        row["k1a_soup4096"] = timed_set([("65,536 rays, 80% active, 4096 tris",
                                          lambda: k1a_hit(soup_case))])
        row["k1a_masks"] = timed_set([(label, (lambda c=extra[label]: k1a_hit(c)))
                                      for label in ("no lane active", "every 64th lane active")])
        if with_any:
            row["k1b"] = timed_set([(f"{tuple(args[0].shape)}",
                                     (lambda args=args: trace_mod.trace_any(*args)))
                                    for args in rec["k1b"]])

    timed = None if a.timed is None else set(a.timed)
    results = []
    for fname, steps, tries, checker, timer in (
            ("gather.cu", K2_STEPS, K2_TRIES, check_gather, time_gather),
            ("trace.cu", K1_STEPS, K1_TRIES, check_trace, time_trace)):
        use("gather.cu", HERE["gather.cu"])
        use("trace.cu", HERE["trace.cu"])
        order = [*steps, *tries, "parent", HERE[fname]]
        for run, step in enumerate(order):
            so, info, err_text = built[(fname, step)]
            row = {"source": fname, "step": step, "run": run,
                   "card": torch.cuda.get_device_name(0), "nvidia_smi": smi, "ptxas": info}
            if so is None:
                row["failed"] = ["did not build"]
                row["nvcc"] = err_text[-4000:]
                results.append(row)
                print(json.dumps(row), flush=True)
                continue
            use(fname, step)
            checker(step, row)
            if row["failed"]:
                log(f"{fname} {step}: FAILED: " + "; ".join(row["failed"][:8]))
            elif timed is None or step in timed:
                timer(row, step in ("parent", HERE[fname]))
                if fname == "gather.cu":
                    msg = (f"K2 dense {row['dense_k2']['warm']['us']:.2f} us/launch (cold "
                           f"{row['dense_k2']['cold']['us']:.2f}), big_room "
                           f"{row['big_k2']['warm']['us']:.2f} (cold "
                           f"{row['big_k2']['cold']['us']:.2f})")
                    if "dense_k2b" in row:
                        msg += (f"; K2b dense {row['dense_k2b']['warm']['us']:.2f}, big_room "
                                f"{row['big_k2b']['warm']['us']:.2f}")
                    msg += "; each dense launch " + ", ".join(
                        f"{e['launch']} {e['warm']['us']:.2f}" for e in row["dense_k2"]["each"])
                    msg += "; each big_room launch " + ", ".join(
                        f"{e['launch']} {e['warm']['us']:.2f}" for e in row["big_k2"]["each"])
                else:
                    msg = (f"K1a {row['k1a']['warm']['us']:.2f} us/launch (cold "
                           f"{row['k1a']['cold']['us']:.2f}); each launch " + ", ".join(
                               f"{e['launch']} {e['warm']['us']:.2f}"
                               for e in row["k1a"]["each"])
                           + f"; the kernel alone {row['k1a_kernel']['warm']['us']:.2f}: "
                           + ", ".join(f"{e['warm']['us']:.2f}" for e in row["k1a_kernel"]["each"])
                           + f"; soup4096 {row['k1a_soup4096']['warm']['us']:.2f}; the first "
                           "launch's rays with " + ", ".join(
                               f"{e['launch']} {e['warm']['us']:.2f}"
                               for e in row["k1a_masks"]["each"]))
                    if "k1b" in row:
                        msg += f"; K1b {row['k1b']['warm']['us']:.2f}"
                log(f"{fname} {step}: bit-equal to plain and to the parent on every launch; "
                    + msg)
            results.append(row)
            print(json.dumps(row), flush=True)

    # ---- the builds of --builds end to end, alternating ----
    def profiled_pass(c):
        c.render_batch(1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            c.render_batch(1)
        us = {"busy": 0.0, "k1a": 0.0, "k2": 0.0}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us["busy"] += e.self_device_time_total
                if "closest_kernel" in e.name:
                    us["k1a"] += e.self_device_time_total
                if "gather_rows_kernel" in e.name:
                    us["k2"] += e.self_device_time_total
        return {k: v / 1e3 for k, v in us.items()}

    def wall(c, passes):
        best = float("inf")
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c.render_batch(passes)  # ends in torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return best / passes * 1e3

    host = {who: [] for who in builds}
    for k in range(a.alternate):
        for who in (list(builds) if k % 2 == 0 else list(builds)[::-1]):
            for fname in ("gather.cu", "trace.cu"):
                use(fname, builds[who][fname])
            row = {"alternate_round": k, "build": who}
            for label, c, passes in (("dense", ctx, PASSES), ("big_room", bctx, BIG_PASSES)):
                c.restart()
                p = profiled_pass(c)
                row[label] = {"ms_per_pass": wall(c, passes), "busy_ms": p["busy"],
                              "k1a_ms": p["k1a"], "k2_ms": p["k2"]}
            host[who].append(row)
            results.append(row)
            print(json.dumps(row), flush=True)
    for who, rows in host.items():
        if rows:
            parts = []
            for label in ("dense", "big_room"):
                for key in ("ms_per_pass", "busy_ms", "k2_ms", "k1a_ms"):
                    v = [r[label][key] for r in rows]
                    parts.append(f"{label} {key} {statistics.median(v):.3f} "
                                 f"({min(v):.3f}-{max(v):.3f})")
            log(f"alternating, {who} over {len(rows)} rounds: " + "; ".join(parts))
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(results, indent=1))
    return 1 if any(r.get("failed") for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
