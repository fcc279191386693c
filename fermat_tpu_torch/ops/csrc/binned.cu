// K7a / K7b: the binned tracer. Closest hit (with the winner's Moller-
// Trumbore u, v) and occlusion over the cluster table of a large scene, as
// rounds of per-ray cluster visits binned by cluster; the round loop runs on
// the device (ops/binned_trace.py enqueues the rounds in batches).
//
// Replaces fermat_tpu/ops/pallas_binned_trace.py: _run_kernel (:320,
// pallas_call :341) over _binned_closest_kernel (:189) and
// _binned_any_kernel (:264), and their round loops _closest_impl (:362) and
// _any_impl (:426), which JAX runs under lax.while_loop; the scan replaces
// the XLA helper _frontier_scan (:109). A round is four launches, each of
// which reads its counts from device memory (`ctl`) and exits early when
// there is nothing to do, so the host enqueues a batch of rounds without
// reading anything back. A batch is one CUDA graph launch: its kernels take
// no pointers (the trace's Loop is in constant memory, `c_loop`, set once a
// trace), so the graph of a batch shape is captured once and replayed by
// every trace; the host pays one launch a batch, not four a round. A round:
//   1. binned_scan_kernel: one thread a ray of the rescan list (in the
//      first round, every lane: it also starts the ray's state). One pass
//      over the cluster boxes, staged in shared memory 1,024 at a time with
//      the union box of each 32 (a ray that misses the union, or for the
//      closest hit enters it beyond its best t, skips the 32 boxes: exact,
//      since rounding is monotone), fills the ray's queue with its next K
//      keys, sorted in registers: the smallest (E', cid) after its cursor
//      with E' <= its best t (closest), or the next K entered cids
//      (occlusion, which JAX orders by cid, :166-169). The ray's first key
//      is appended to the ready list.
//   2. binned_offsets_kernel (one CTA) and binned_scatter_kernel: a counting
//      sort of the ready list by cid. The histogram was summed as the rays
//      were appended (one atomic per distinct cid of a warp); the offsets
//      kernel takes its exclusive scan over the c_pad bins, cuts each bin
//      into work items of `block` rays and holds JAX's liveness cap
//      (4 x Cp rounds, :373-378: a round that still has rays at the cap
//      sets ctl[kOver] instead of running); the scatter places each ray in
//      its bin, in any order within the bin.
//   3. binned_test_kernel: persistent CTAs pop work items (one bin's chunk
//      of at most `block` rays), stage that cluster's real triangles (at
//      most 128 rows of 48 bytes, 6 KiB) in shared memory with cp.async,
//      double-buffered so the next item's copy overlaps this item's tests,
//      and give each thread one ray. The ray folds the cluster's hits into
//      its own state (JAX's merge, :394-405: the better of its best hit and
//      this cluster's by (t, id)), steps its queue and appends itself to the
//      next round's ready list (its next key), to the rescan list (its queue
//      ran out and the scan saw more keys), or to neither (done).
// What bounds it on H100: K7a FP32 operations, ~46 per ray-triangle test
// over the clusters a ray must enter (as K5's), plus the scan's ~24 per ray
// and box it examines; K7b device-memory bytes (its bound is the rays in
// and the flags out, as K5b's). What the design does about the three costs
// of the round loop it replaces: the host read the live count back every
// round, now once per batch of rounds, launched as one graph; the scan slab-tested every live ray
// against every box every round, now once per K visits (a queue that holds
// all of a ray's keys is never rescanned); the test kernel tested up to
// `u_steps` clusters a CTA and left the other rays to retry, now every ready
// ray is tested every round, so a round is one visit of each live ray.
//
// The function is that of fermat_tpu_torch/ops/frontier_trace.py (entry
// margin E', a hit counts only with E' <= t, ties to the smallest original
// id, occlusion in any entered cluster). The closest hit is the minimum over
// (t, id) of the hits with t >= E' over the clusters entered with E' <= the
// final best t; a min does not depend on the order it is taken in, and the
// cut E' <= t_best at a visit only skips clusters that cannot hold it. The
// occlusion flag is an "any" over the entered clusters. So neither the order
// of the visits nor the order of the rays within a bin can change a bit,
// and the answer equals K5's. The arithmetic is K5's, shared in
// cluster_common.cuh (`entered`, `hit_test`), built with --fmad=false.
#include <cstring>
#include <mutex>

#include "cluster_common.cuh"

namespace {

constexpr int kScanThreads = 256;
constexpr int kScanTile = 1024;   // cluster boxes staged per pass of the scan
constexpr int kGroup = 32;        // boxes under one union box in the scan
constexpr int kBinThreads = 1024;  // the offsets kernel's one CTA
constexpr int kMaxBlock = 256;     // most rays a work item (threads a test CTA)
constexpr int kTriFloat4 = kCluster * kRowFloat4;  // a staged cluster: 384 float4
constexpr int kSent = kIntMax;     // no cluster
constexpr unsigned kFull = 0xffffffffu;

// Slots of ctl (ops/binned_trace.py CTL_*).
enum : int {
  kLive = 0,  // rays in the sorted list (tested this round)
  kReady,     // rays appended to the ready list for the next round
  kRescan,    // rays appended to the rescan list
  kItem,      // the test kernel's next work item
  kRounds,    // rounds that tested rays
  kOver,      // rays still live when the cap was reached (0: not reached)
  kScans,     // full passes over the boxes
  kPairs,     // ray-cluster visits
};

enum : int { kStepScan = 1, kStepBin = 2, kStepTest = 4 };

// Everything a round reads and writes; per-lane arrays are indexed by lane,
// the queue slot i of lane l at i * n + l.
struct Loop {
  RayPtrs ray;
  const float* boxes;
  int cp, c_pad;
  const float4* rows;
  const int* count;
  int n, block, cap;
  float* t_best;
  int* id_best;  // kIntMax: no hit yet
  int* tri;      // the answer's id: id_best, or -1 for no hit
  float* u;
  float* v;
  uint8_t* occ;
  float* qe;  // the queue: E' (closest only) and cid of a ray's next keys
  int* qc;
  int* qhead;       // next queue slot to visit
  int* qlen;        // keys in the queue
  uint8_t* qdone;   // the last scan saw no key beyond the queue
  int* sorted;      // the round's rays, binned by cid
  int* ready;       // rays with a next key, and the key's cid
  int* ready_cid;
  int* rescan;      // rays whose queue ran out
  int* hist;        // (c_pad) ready rays per cid
  int* start;       // (c_pad + 1) first slot of each bin in `sorted`
  int* items;       // (c_pad + 1) first work item of each bin
  int* fill;        // (c_pad) the scatter's cursor per bin
  int* item_bin;    // the bin of each work item
  int* ctl;
};

// The trace's Loop, set by the host before a batch (a batch is a CUDA graph
// whose kernels take no pointers, so one graph serves every trace).
__constant__ Loop c_loop;

__device__ __forceinline__ size_t slot(int i, int n, int lane) {
  return static_cast<size_t>(i) * n + lane;
}

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// Appends (lane, cid) to the ready list and counts it in the histogram for
// the lanes of the warp with `want`: one atomic for the slots, one per
// distinct cid. Every thread of the warp calls it.
__device__ __forceinline__ void append_ready(const Loop& a, bool want, int lane, int cid) {
  const unsigned mask = __ballot_sync(kFull, want);
  if (!want) return;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if ((threadIdx.x & 31) == leader) base = atomicAdd(a.ctl + kReady, __popc(mask));
  base = __shfl_sync(mask, base, leader);
  const int pos = base + __popc(mask & lanes_below());
  a.ready[pos] = lane;
  a.ready_cid[pos] = cid;
  const unsigned peers = __match_any_sync(mask, cid);
  if ((threadIdx.x & 31) == __ffs(peers) - 1) atomicAdd(a.hist + cid, __popc(peers));
}

__device__ __forceinline__ void append_rescan(const Loop& a, bool want, int lane) {
  const unsigned mask = __ballot_sync(kFull, want);
  if (!want) return;
  const int leader = __ffs(mask) - 1;
  int base = 0;
  if ((threadIdx.x & 31) == leader) base = atomicAdd(a.ctl + kRescan, __popc(mask));
  base = __shfl_sync(mask, base, leader);
  a.rescan[base + __popc(mask & lanes_below())] = lane;
}

// Inserts (e, c) into the ascending queue, given e < qe[K - 1]; an equal E'
// already queued keeps its place (its cid is smaller: the boxes are scanned
// in ascending cid).
template <int K>
__device__ __forceinline__ void insert(float (&qe)[K], int (&qc)[K], float e, int c) {
  bool placed = false;
#pragma unroll
  for (int i = K - 1; i > 0; --i) {
    if (!placed) {
      if (qe[i - 1] > e) {
        qe[i] = qe[i - 1];
        qc[i] = qc[i - 1];
      } else {
        qe[i] = e;
        qc[i] = c;
        placed = true;
      }
    }
  }
  if (!placed) {
    qe[0] = e;
    qc[0] = c;
  }
}

// Stages boxes [tile, tile + w) as (lo xyz, hi.x | hi.y, hi.z) and the union
// box of each kGroup of them (empty boxes left out; a group of empty boxes
// gets an empty union), then syncs the CTA.
__device__ __forceinline__ void stage_boxes(const Loop& a, int tile, int w,
                                            float4 (*box_s)[2], float4 (*grp_s)[2]) {
  for (int q = threadIdx.x; q < w; q += kScanThreads) {
    const float* b = a.boxes + tile + q;
    box_s[q][0] = make_float4(__ldg(b), __ldg(b + a.cp), __ldg(b + 2 * a.cp),
                              __ldg(b + 3 * a.cp));
    box_s[q][1] = make_float4(__ldg(b + 4 * a.cp), __ldg(b + 5 * a.cp), 0.0f, 0.0f);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  for (int g = threadIdx.x >> 5; g * kGroup < w; g += kScanThreads / 32) {
    const int q = g * kGroup + lane;
    float lo[3] = {inf(), inf(), inf()}, hi[3] = {-inf(), -inf(), -inf()};
    if (q < w) {
      const float4 l = box_s[q][0], h = box_s[q][1];
      if (l.x <= l.w) {  // a box that is not empty
        lo[0] = l.x;
        lo[1] = l.y;
        lo[2] = l.z;
        hi[0] = l.w;
        hi[1] = h.x;
        hi[2] = h.y;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        lo[k] = fminf(lo[k], __shfl_xor_sync(kFull, lo[k], o));
        hi[k] = fmaxf(hi[k], __shfl_xor_sync(kFull, hi[k], o));
      }
    }
    if (lane == 0) {
      grp_s[g][0] = make_float4(lo[0], lo[1], lo[2], hi[0]);
      grp_s[g][1] = make_float4(hi[1], hi[2], 0.0f, 0.0f);
    }
  }
  __syncthreads();
}

template <bool kClosest, int K>
__global__ void __launch_bounds__(kScanThreads) binned_scan_kernel(int first) {
  const Loop& a = c_loop;
  __shared__ float4 box_s[kScanTile][2];               // lo xyz hi.x | hi.yz
  __shared__ float4 grp_s[kScanTile / kGroup][2];      // the union of kGroup boxes
  const int n = a.n;
  const int m = first ? n : a.ctl[kRescan];
  int scans = 0;
  for (int base = blockIdx.x * kScanThreads; base < m; base += gridDim.x * kScanThreads) {
    const int j = base + threadIdx.x;
    int lane = -1;
    if (j < m) {
      if (first) {  // every lane starts its state; the active ones are scanned
        if (kClosest) {
          a.t_best[j] = a.ray.tmax[j];
          a.id_best[j] = kIntMax;
          a.tri[j] = -1;
          a.u[j] = 0.0f;
          a.v[j] = 0.0f;
        } else {
          a.occ[j] = 0;
        }
        if (a.ray.active[j]) lane = j;
      } else {
        lane = a.rescan[j];
      }
    }
    Ray r{};
    float tb = 0.0f, le = -inf();
    int lc = -1;
    if (lane >= 0) {
      r = load_ray(a.ray, lane);
      const int len = first ? 0 : a.qlen[lane];
      if (len > 0) {  // a rescan starts after the last key of the full queue
        lc = a.qc[slot(len - 1, n, lane)];
        if (kClosest) le = a.qe[slot(len - 1, n, lane)];
      }
      if (kClosest) tb = a.t_best[lane];
      ++scans;
    }
    float qe[K];
    int qc[K];
#pragma unroll
    for (int i = 0; i < K; ++i) {
      qe[i] = inf();
      qc[i] = kSent;
    }
    int found = 0;  // keys seen (occlusion stops at K + 1)
    bool stop = lane < 0;
    for (int tile = 0; tile < a.c_pad; tile += kScanTile) {
      const int w = min(kScanTile, a.c_pad - tile);
      __syncthreads();  // the previous tile is no longer read
      stage_boxes(a, tile, w, box_s, grp_s);
      if (stop) continue;
      for (int g0 = 0; g0 < w && !stop; g0 += kGroup) {
        // A ray that misses the union box misses every box under it, and
        // enters none before the union's E' (rounding is monotone): skip.
        const float4 gl = grp_s[g0 / kGroup][0], gh = grp_s[g0 / kGroup][1];
        float e;
        if (!entered(r, gl.x, gl.y, gl.z, gl.w, gh.x, gh.y, &e) || (kClosest && e > tb) ||
            (!kClosest && tile + g0 + kGroup - 1 <= lc))
          continue;
        const int q_end = min(g0 + kGroup, w);
        for (int q = g0; q < q_end; ++q) {
          const int c = tile + q;
          if (!kClosest && c <= lc) continue;
          const float4 lo = box_s[q][0], hi = box_s[q][1];
          if (!entered(r, lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, &e)) continue;
          if (kClosest) {
            if (!(e <= tb && (e > le || (e == le && c > lc)))) continue;
            ++found;
            if (e < qe[K - 1]) insert<K>(qe, qc, e, c);
          } else {
            if (found == K) {  // one key beyond the queue: the queue is not all
              found = K + 1;
              stop = true;
              break;
            }
#pragma unroll
            for (int i = 0; i < K; ++i)
              if (i == found) qc[i] = c;
            ++found;
          }
        }
      }
    }
    if (lane >= 0) {
      const int len = min(found, K);
#pragma unroll
      for (int i = 0; i < K; ++i) {
        if (i < len) {
          a.qc[slot(i, n, lane)] = qc[i];
          if (kClosest) a.qe[slot(i, n, lane)] = qe[i];
        }
      }
      a.qhead[lane] = 0;
      a.qlen[lane] = len;
      a.qdone[lane] = found <= K;
    }
    append_ready(a, lane >= 0 && found > 0, lane, qc[0]);
  }
  scans = __reduce_add_sync(kFull, scans);
  if ((threadIdx.x & 31) == 0 && scans) atomicAdd(a.ctl + kScans, scans);
}

// kClosest only names the kernel (a profile tells K7a's rounds from K7b's).
template <bool kClosest>
__global__ void __launch_bounds__(kBinThreads) binned_offsets_kernel() {
  const Loop& a = c_loop;
  __shared__ int s_m;
  __shared__ int s_warp[2][kBinThreads / 32];
  const int tid = threadIdx.x, c_pad = a.c_pad;
  if (tid == 0) {
    int m = a.ctl[kReady];
    if (m > 0 && a.ctl[kRounds] >= a.cap) {  // the liveness cap: no round runs
      a.ctl[kOver] = m;
      m = 0;
    }
    a.ctl[kLive] = m;
    a.ctl[kReady] = 0;
    a.ctl[kRescan] = 0;
    a.ctl[kItem] = 0;
    if (m > 0) {
      a.ctl[kRounds] += 1;
      a.ctl[kPairs] += m;
    }
    s_m = m;
  }
  __syncthreads();
  if (s_m == 0) {  // nothing to test: the test kernel finds no item
    for (int b = tid; b < c_pad; b += kBinThreads) a.hist[b] = 0;
    if (tid == 0) a.items[c_pad] = 0;
    return;
  }
  const int per = (c_pad + kBinThreads - 1) / kBinThreads;
  const int lo = min(tid * per, c_pad), hi = min(lo + per, c_pad);
  int rays = 0, items = 0;
  for (int b = lo; b < hi; ++b) {
    const int h = a.hist[b];
    rays += h;
    items += (h + a.block - 1) / a.block;
  }
  // exclusive scan of (rays, items) over the CTA, threads in bin order
  const int lid = tid & 31, wid = tid >> 5;
  int r_inc = rays, i_inc = items;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int r = __shfl_up_sync(kFull, r_inc, o), i = __shfl_up_sync(kFull, i_inc, o);
    if (lid >= o) {
      r_inc += r;
      i_inc += i;
    }
  }
  if (lid == 31) {
    s_warp[0][wid] = r_inc;
    s_warp[1][wid] = i_inc;
  }
  __syncthreads();
  if (wid == 0) {
    int r_w = s_warp[0][lid], i_w = s_warp[1][lid];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int r = __shfl_up_sync(kFull, r_w, o), i = __shfl_up_sync(kFull, i_w, o);
      if (lid >= o) {
        r_w += r;
        i_w += i;
      }
    }
    s_warp[0][lid] = r_w;
    s_warp[1][lid] = i_w;
  }
  __syncthreads();
  int r_off = r_inc - rays + (wid ? s_warp[0][wid - 1] : 0);
  int i_off = i_inc - items + (wid ? s_warp[1][wid - 1] : 0);
  for (int b = lo; b < hi; ++b) {
    const int h = a.hist[b], nb = (h + a.block - 1) / a.block;
    a.start[b] = r_off;
    a.fill[b] = r_off;
    a.items[b] = i_off;
    for (int k = 0; k < nb; ++k) a.item_bin[i_off + k] = b;
    r_off += h;
    i_off += nb;
    a.hist[b] = 0;
  }
  if (tid == kBinThreads - 1) {
    a.start[c_pad] = r_off;
    a.items[c_pad] = i_off;
  }
}

template <bool kClosest>
__global__ void __launch_bounds__(kScanThreads) binned_scatter_kernel() {
  const Loop& a = c_loop;
  const int m = a.ctl[kLive];
  for (int base = blockIdx.x * kScanThreads; base < m; base += gridDim.x * kScanThreads) {
    const int j = base + threadIdx.x;
    const bool has = j < m;
    const unsigned mask = __ballot_sync(kFull, has);
    if (has) {
      const int cid = a.ready_cid[j];
      const unsigned peers = __match_any_sync(mask, cid);
      const int leader = __ffs(peers) - 1;
      int pos = 0;
      if ((threadIdx.x & 31) == leader) pos = atomicAdd(a.fill + cid, __popc(peers));
      pos = __shfl_sync(peers, pos, leader);
      a.sorted[pos + __popc(peers & lanes_below())] = a.ready[j];
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

__device__ __forceinline__ void cp_async_wait_older() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

struct Item {
  int b, base, nr, cnt;  // bin (= cid), first slot in `sorted`, rays, triangles
};

__device__ __forceinline__ Item locate(const Loop& a, int item) {
  Item it;
  it.b = a.item_bin[item];
  it.base = a.start[it.b] + (item - a.items[it.b]) * a.block;
  it.nr = min(a.block, a.start[it.b + 1] - it.base);
  it.cnt = __ldg(a.count + it.b);
  return it;
}

__device__ __forceinline__ void stage(const Loop& a, const Item& it, float4* dst) {
  const float4* src = a.rows + static_cast<size_t>(it.b) * kTriFloat4;
  for (int k = threadIdx.x; k < it.cnt * kRowFloat4; k += blockDim.x) cp_async16(dst + k, src + k);
}

// One thread per ray of the item: test the staged cluster, fold, step the
// queue and append the ray where it goes next. Every thread calls it.
template <bool kClosest>
__device__ __forceinline__ void test_item(const Loop& a, const Item& it,
                                          const float4* __restrict__ tri) {
  const int n = a.n;
  int lane = -1, next = -1;
  bool again = false;
  if (static_cast<int>(threadIdx.x) < it.nr) {
    lane = a.sorted[it.base + threadIdx.x];
    const Ray r = load_ray(a.ray, lane);
    const int h = a.qhead[lane], len = a.qlen[lane];
    if (kClosest) {
      const float ec = a.qe[slot(h, n, lane)];
      float tb = a.t_best[lane];
      int ib = a.id_best[lane];
      float ub = 0.0f, vb = 0.0f;
      bool got = false;
      for (int k = 0; k < it.cnt; ++k) {
        const float4 c2 = tri[3 * k + 2];
        float t, uu, vv;
        if (!hit_test(r, tri[3 * k], tri[3 * k + 1], c2, &t, &uu, &vv) || t < ec) continue;
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
        a.t_best[lane] = tb;
        a.id_best[lane] = ib;
        a.tri[lane] = ib;
        a.u[lane] = ub;
        a.v[lane] = vb;
      }
      if (h + 1 < len) {
        if (a.qe[slot(h + 1, n, lane)] <= tb) next = a.qc[slot(h + 1, n, lane)];
      } else {
        again = !a.qdone[lane];
      }
    } else {
      bool hit = false;
      for (int k = 0; k < it.cnt && !hit; ++k) {
        float t, uu, vv;
        hit = hit_test(r, tri[3 * k], tri[3 * k + 1], tri[3 * k + 2], &t, &uu, &vv);
      }
      if (hit) {
        a.occ[lane] = 1;
      } else if (h + 1 < len) {
        next = a.qc[slot(h + 1, n, lane)];
      } else {
        again = !a.qdone[lane];
      }
    }
    a.qhead[lane] = h + 1;
  }
  append_ready(a, next >= 0, lane, next);
  append_rescan(a, again, lane);
}

template <bool kClosest>
__global__ void __launch_bounds__(kMaxBlock) binned_test_kernel() {
  const Loop& a = c_loop;
  extern __shared__ float4 tri_s[];  // two staged clusters
  __shared__ int s_item;
  const int total = a.items[a.c_pad];
  if (total == 0) return;
  if (threadIdx.x == 0) s_item = atomicAdd(a.ctl + kItem, 1);
  __syncthreads();
  const int first = s_item;
  if (first >= total) return;
  Item cur = locate(a, first);
  stage(a, cur, tri_s);
  cp_async_commit();
  int sel = 0;
  for (;;) {
    __syncthreads();  // s_item read, and the other buffer no longer tested
    if (threadIdx.x == 0) s_item = atomicAdd(a.ctl + kItem, 1);
    __syncthreads();
    const int nxt_item = s_item;
    const bool more = nxt_item < total;
    Item nxt = cur;
    if (more) {
      nxt = locate(a, nxt_item);
      stage(a, nxt, tri_s + (sel ^ 1) * kTriFloat4);
    }
    cp_async_commit();
    cp_async_wait_older();
    __syncthreads();  // the current cluster is in shared memory
    test_item<kClosest>(a, cur, tri_s + sel * kTriFloat4);
    if (!more) break;
    cur = nxt;
    sel ^= 1;
  }
}

constexpr int kMaxDevices = 64;
constexpr int kMaxGraphs = 64;

int sm_count(int device) {
  static int cached[kMaxDevices] = {};
  if (cached[device] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
      return 0;
    cached[device] = sms;
  }
  return cached[device];
}

// Test CTAs an SM holds at `block` threads (the persistent test grid), cached.
template <bool kClosest>
int test_ctas_per_sm(int device, int block, size_t smem) {
  static int cached[kMaxDevices][kMaxBlock / 32 + 1] = {};
  int& c = cached[device][block / 32];
  if (c == 0) {
    int per_sm = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, binned_test_kernel<kClosest>, block,
                                                      smem) != cudaSuccess)
      return 0;
    c = max(per_sm, 1);
  }
  return c;
}

// A batch of rounds as its graph was captured: every launch parameter.
struct Batch {
  int device, closest, first, n_rounds, steps, k, grid, test_grid, block;
  cudaGraphExec_t exec;
};

bool same_batch(const Batch& x, const Batch& y) {
  return x.device == y.device && x.closest == y.closest && x.first == y.first &&
         x.n_rounds == y.n_rounds && x.steps == y.steps && x.k == y.k && x.grid == y.grid &&
         x.test_grid == y.test_grid && x.block == y.block;
}

template <bool kClosest>
void launch_scan(const Batch& b, int first, cudaStream_t s) {
  if (b.k == 1)
    binned_scan_kernel<kClosest, 1><<<b.grid, kScanThreads, 0, s>>>(first);
  else
    binned_scan_kernel<kClosest, 8><<<b.grid, kScanThreads, 0, s>>>(first);
}

constexpr size_t kTestSmem = 2 * kTriFloat4 * sizeof(float4);

template <bool kClosest>
void launch_rounds(const Batch& b, cudaStream_t s) {
  for (int r = 0; r < b.n_rounds; ++r) {
    if (b.steps & kStepScan) launch_scan<kClosest>(b, b.first && r == 0, s);
    if (b.steps & kStepBin) {
      binned_offsets_kernel<kClosest><<<1, kBinThreads, 0, s>>>();
      binned_scatter_kernel<kClosest><<<b.grid, kScanThreads, 0, s>>>();
    }
    if (b.steps & kStepTest) binned_test_kernel<kClosest><<<b.test_grid, b.block, kTestSmem, s>>>();
  }
}

// The executable graph of a batch: captured on a stream of the library's
// own at its first use, then replayed. The kernels read everything else
// from c_loop, so the graph depends only on the launch parameters.
template <bool kClosest>
cudaError_t batch_graph(const Batch& key, cudaGraphExec_t* out) {
  static Batch cache[kMaxGraphs];
  static int used = 0;
  static cudaStream_t capture[kMaxDevices] = {};
  for (int i = 0; i < used; ++i) {
    if (same_batch(cache[i], key)) {
      *out = cache[i].exec;
      return cudaSuccess;
    }
  }
  cudaError_t err = cudaSuccess;
  if (used == kMaxGraphs) {  // rare (a tool sweeping shapes): start over
    err = cudaDeviceSynchronize();
    for (int i = 0; i < used; ++i) cudaGraphExecDestroy(cache[i].exec);
    used = 0;
    if (err != cudaSuccess) return err;
  }
  // load the batch's kernels before the capture (a lazy load is not captured)
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, key.k == 1 ? binned_scan_kernel<kClosest, 1>
                                                : binned_scan_kernel<kClosest, 8>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, binned_offsets_kernel<kClosest>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, binned_scatter_kernel<kClosest>);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, binned_test_kernel<kClosest>);
  cudaStream_t& cs = capture[key.device];
  if (err == cudaSuccess && cs == nullptr)
    err = cudaStreamCreateWithFlags(&cs, cudaStreamNonBlocking);
  if (err == cudaSuccess) err = cudaStreamBeginCapture(cs, cudaStreamCaptureModeThreadLocal);
  if (err != cudaSuccess) return err;
  launch_rounds<kClosest>(key, cs);
  const cudaError_t launched = cudaGetLastError();
  cudaGraph_t g = nullptr;
  err = cudaStreamEndCapture(cs, &g);
  if (err == cudaSuccess) err = launched;
  if (err == cudaSuccess) err = cudaGraphInstantiate(out, g, 0);
  if (g != nullptr) cudaGraphDestroy(g);
  if (err != cudaSuccess) return err;
  cache[used] = key;
  cache[used++].exec = *out;
  return cudaSuccess;
}

// Sets c_loop on the stream, unless it already holds this trace's Loop (the
// later batches of a trace copy nothing).
cudaError_t set_loop(const Loop& a, int device, cudaStream_t s) {
  static Loop last[kMaxDevices];
  static bool have[kMaxDevices] = {};
  if (have[device] && std::memcmp(&last[device], &a, sizeof(Loop)) == 0) return cudaSuccess;
  const cudaError_t err =
      cudaMemcpyToSymbolAsync(c_loop, &a, sizeof(Loop), 0, cudaMemcpyHostToDevice, s);
  if (err == cudaSuccess) {
    last[device] = a;
    have[device] = true;
  }
  return err;
}

template <bool kClosest>
cudaError_t enqueue(const Loop& a, int first, int n_rounds, int steps, int k, int device,
                    cudaStream_t s) {
  const int sms = sm_count(device);
  const int per_sm = sms ? test_ctas_per_sm<kClosest>(device, a.block, kTestSmem) : 0;
  if (per_sm == 0) return cudaErrorInvalidDevice;
  const int grid = max(1, min((a.n + kScanThreads - 1) / kScanThreads,
                              sms * (2048 / kScanThreads)));
  const Batch key{device, kClosest, first, n_rounds, steps, k, grid, sms * per_sm, a.block,
                  nullptr};
  cudaGraphExec_t exec = nullptr;
  cudaError_t err = batch_graph<kClosest>(key, &exec);
  if (err == cudaSuccess) err = set_loop(a, device, s);
  if (err == cudaSuccess && first) {
    err = cudaMemsetAsync(a.ctl, 0, 8 * sizeof(int), s);
    if (err == cudaSuccess) err = cudaMemsetAsync(a.hist, 0, a.c_pad * sizeof(int), s);
  }
  if (err == cudaSuccess) err = cudaGraphLaunch(exec, s);
  return err;
}

}  // namespace

extern "C" const char* fermat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Enqueues n_rounds rounds of the loop (the steps in `steps`: 1 scan, 2 the
// counting sort, 4 the test) on `stream`, as one graph launch; `first`
// starts the trace: its counts are zeroed and its first scan starts every
// lane's state. k (the queue) is 1 or 8. The traces of one device run on
// one stream at a time (c_loop is the device's, set in stream order). lists is
// (3, n): sorted, ready, rescan; bins (4 c_pad + 2): hist, start, items,
// fill; item_bin (n / block + c_pad + 1); ctl (8).
extern "C" int fermat_binned_rounds(
    int closest, int first, int n_rounds, int steps, int n, int k, int block, int cap,
    const float* ox, const float* oy, const float* oz, const float* dx, const float* dy,
    const float* dz, const float* tmin, const float* tmax, const uint8_t* active,
    const float* boxes, int cp, int c_pad, const float* rows, const int* count,
    float* t_best, int* id_best, int* tri, float* u, float* v, uint8_t* occ, float* qe,
    int* qc,
    int* qhead, int* qlen, uint8_t* qdone, int* lists, int* ready_cid, int* bins,
    int* item_bin, int* ctl, int device, cudaStream_t stream) {
  int err = static_cast<int>(cudaSetDevice(device));
  if (err != 0 || n == 0 || n_rounds == 0) return err;
  if (device < 0 || device >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  if (!(k == 1 || k == 8) || block < 32 || block > kMaxBlock ||
      block % 32 != 0 || c_pad < 1 || cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Loop a;
  std::memset(&a, 0, sizeof(Loop));  // padding too: set_loop compares bytes
  a.ray = RayPtrs{ox, oy, oz, dx, dy, dz, tmin, tmax, active};
  a.boxes = boxes;
  a.cp = cp;
  a.c_pad = c_pad;
  a.rows = reinterpret_cast<const float4*>(rows);
  a.count = count;
  a.n = n;
  a.block = block;
  a.cap = cap;
  a.t_best = t_best;
  a.id_best = id_best;
  a.tri = tri;
  a.u = u;
  a.v = v;
  a.occ = occ;
  a.qe = qe;
  a.qc = qc;
  a.qhead = qhead;
  a.qlen = qlen;
  a.qdone = qdone;
  a.sorted = lists;
  a.ready = lists + n;
  a.rescan = lists + 2 * static_cast<size_t>(n);
  a.ready_cid = ready_cid;
  a.hist = bins;
  a.start = bins + c_pad;
  a.items = a.start + c_pad + 1;
  a.fill = a.items + c_pad + 1;
  a.item_bin = item_bin;
  a.ctl = ctl;
  static std::mutex mu;  // the graph and c_loop caches (ctypes drops the GIL)
  const std::lock_guard<std::mutex> lock(mu);
  const cudaError_t e = closest ? enqueue<true>(a, first, n_rounds, steps, k, device, stream)
                                : enqueue<false>(a, first, n_rounds, steps, k, device, stream);
  return static_cast<int>(e);
}
