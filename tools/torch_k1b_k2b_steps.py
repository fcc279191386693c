#!/usr/bin/env python3
"""K1b (the dense any-hit tracer, fermat_tpu_torch/ops/csrc/trace.cu
any_kernel) and K2b in its shared-memory mode (the row gather's backward,
ops/csrc/gather.cu) step by step on one CUDA card, at the main path's
recorded inputs: K1b's 6 launches of one 512x512 glossy CornellBox pass
(chip_smoke.py phase 4) and the 6 of one CornellBox AD train step's forward,
K2b's 6 launches of that AD step's backward (phase 4f), max_path_length=6.

    python3 tools/torch_k1b_k2b_steps.py --parent DIR [--timed NAME ...] [--cut]
                                         [--alternate ROUNDS] [--builds NAME ...] [--out FILE]

DIR holds an unpacked checkout of an earlier commit (`git archive`): its
trace.cu and gather.cu are built as the parent kernels (the same C
signatures; the parent's K2b is called with the scratch and slices its own
wrapper gave it). The design steps are built from this checkout's sources,
each with the later steps taken out again, or a try put in, by exact text
edits (the script stops if one no longer applies). Each step is on top of
the one before:

K1b (trace.cu)
  parent             the parent commit's kernel: a thread per lane, 128
                     triangles a tile as nine scalar rows, every test run to
                     its end, a __syncthreads_or a tile
  +records           a thread per lane; the soup staged as float4 records, up
                     to 1,024 triangles at once (one barrier for the path's
                     36), K1a's early-out test (record_test)
  +compaction        K1a's block compaction: the block's active lanes in a
                     shared list, a thread a ray, 256 lanes a block
  +split             a sparse block's ray shared by 2-8 threads, every g-th
                     triangle a thread, a vote of the group after each step (a
                     ballot of the warp, whose lanes step as one); a thread
                     with a ray of its own stops at its first hit
  +vote stride       the check for a hit, and the group's vote, after every 4
                     tests (kVoteStride), not after each
  +min blocks 4      __launch_bounds__(256, 4): at most 64 registers, four
                     blocks an SM (a 20-byte spill)
  +cached lanes      ops/trace.py: trace_any's number tmin (and tmax) from the
                     cached lanes of _lanes (the steps before fill them per
                     call, as the parent's wrapper did): this checkout
Tries, on top of this checkout:
  +two-lane chunks   512 lanes a block, two a thread, where the launch still
                     gives two blocks an SM (K1a's rule; the path's 262,144
                     lanes)
  +area order        the soup's triangles by decreasing area, a fixed
                     permutation made once a soup (likely occluders first;
                     the flags cannot change)
  +group votes       the group's vote with the group's lanes as its mask
                     (__any_sync), each group of a warp stepping on its own

K2b (gather.cu, the shared-memory mode)
  parent             the parent commit's: 512-lane CTAs, 4 lane slices a CTA
                     taken in stride, scalar loads, an add a lane into the
                     slice's shared partial, a second launch summing the 512
                     CTAs' partials
  +grid              the CTAs that fit on the card at once, each a contiguous
                     range of lanes in contiguous slices; scalar loads, an
                     add a lane; a second launch sums the CTAs' partials
  +float4 loads      16-byte loads where K % 4 == 0 and the cotangent is
                     16-byte aligned (the path's 52 columns: 13 a row)
  +loads ahead       a lane's cotangent load issued beside its index load,
                     not after it (the steps before load only in-range lanes)
  +attribute once    the shared-memory attribute set once a device, not at
                     every call: this checkout
Tries, on top of this checkout:
  +runs in registers a run of consecutive lanes with one index summed in
                     registers, one shared add a run (the path's indices come
                     in runs: neighbouring pixels hit the same triangle)
  +unroll 16         16 lanes' loads in flight a thread, not 8
  +one launch        no second launch: tickets, the last CTA of each group of
                     ceil(sqrt(grid)) sums its group's partials, the last of
                     those the group sums (its own zeroed scratch)
  +two CTAs an SM    a CTA's partials capped at 113 KB (ops/gather.py
                     BWD_SMEM), so that two CTAs fit an SM: fewer slices a CTA,
                     more threads an SM
  +512 threads       512 threads a CTA, not 256 (ops/gather.py BWD_THREADS
                     with it): more slices a CTA

For each build: every recorded launch against its plain version (K1b flags
equal, K2b within ops/gather.py BWD_RTOL of sum|g|) and K1b against the
parent's flags; two launches equal (K2b bit for bit). K1b also at 65,536
random rays against random_soup(4096) (80% active) and at the first
launch's rays with no lane and every 64th lane active; K2b also at 262,144
uniform random indices into (36, 52). A step that fails is reported, not
timed, and the script exits non-zero. Then, for the steps named by --timed
(default: all), each launch is timed in replay (CUDA events around each of
20 replays behind a spin kernel: median, min, max; cold with 128 MiB
written before each), K1b through its wrapper and alone (its C entry point
on launch arguments made once). Every build prints ptxas's registers, stack
and spills per kernel. The order is parent, the steps, the tries, then parent
and this checkout again, so drift within the call shows.

--cut times this checkout's K2b in its shared mode (the slices of
ops/gather.py bwd_slices without its row cut) and in its atomic mode at 52
columns for 36, 64, 80, 96, 112, 128, 129, 144, 160, 192, 224, 256, 512 and
1,024 rows and at 36 rows x 1 and x 23 columns, 262,144 lanes, with runs of
1-32 equal indices and with uniform random indices, each result within
BWD_RTOL of the plain version.

--alternate ROUNDS then binds the builds named by --builds (default: parent
this; a step or try of one file goes with this checkout's other file) in
turn, in order and then in reverse, and times, ROUNDS each, one dense
CornellBox pass through RenderingContext (ms/pass on the host's clock, best
of 3 batches of 8; the device-busy time and K1b's of one profiled pass) and
one CornellBox AD train step (ms/step, best of 2 after a warm-up; busy,
K1b's and K2b's device time of one profiled step). Prints one JSON line per
build and round; --out writes them all as one JSON file.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
from torch_steps_common import (FLUSH_BYTES, ad_step, bind, build, edited,  # noqa: E402
                                filled_lanes, log, patch, record_ad_step, record_pass, replay)

RES, MPL, PASSES, REPS = 512, 6, 8, 3
N_SOUP = 65_536
N_CUT = 262_144
CUT_SHAPES = [(36, 52), (64, 52), (80, 52), (96, 52), (112, 52), (128, 52), (129, 52),
              (144, 52), (160, 52), (192, 52), (224, 52), (256, 52), (512, 52), (1024, 52),
              (36, 1), (36, 23)]

# ---- trace.cu: the exact text edits that take a step out or put a try in ----
# two lanes a thread where the launch still gives two blocks an SM (K1a's rule)
TWO_LANE_CHUNKS = [(
    "  // one lane a thread at any n: two (K1a's rule) measured slower for K1b\n"
    "  const RayPtrs ray{ox, oy, oz, dx, dy, dz};\n"
    "  err = launch_any<1>(ray, tmin, tmax, active, tris, n_tris, n, occ_out, stream);\n",
    "  bool two = false;\n"
    "  err = two_lanes(n, device, &two);\n"
    "  if (err != cudaSuccess) return static_cast<int>(err);\n"
    "  const RayPtrs ray{ox, oy, oz, dx, dy, dz};\n"
    "  err = two ? launch_any<2>(ray, tmin, tmax, active, tris, n_tris, n, occ_out, stream)\n"
    "            : launch_any<1>(ray, tmin, tmax, active, tris, n_tris, n, occ_out, stream);\n",
    1)]
ANY_NO_SPLIT = [(
    "  const int per = sh.per, slots = sh.slots, g = sh.g;\n"
    "  const bool busy = warp * 32 < slots * g;  // the warp holds a slot\n"
    "  if (!busy && n_tris <= kTileTris) return;  // no slot, no tile to stage\n"
    "  const int slot = threadIdx.x / g;\n"
    "  const int part = threadIdx.x & (g - 1);\n"
    "  // this thread's group of g lanes (g divides 32) starts at lane lead\n",
    "  const int per = sh.per, slots = sh.slots, g = 1;\n"
    "  const bool busy = warp * 32 < slots * g;  // the warp holds a slot\n"
    "  if (!busy && n_tris <= kTileTris) return;  // no slot, no tile to stage\n"
    "  const int slot = threadIdx.x / g;\n"
    "  const int part = threadIdx.x & (g - 1);\n"
    "  // this thread's group of g lanes (g divides 32) starts at lane lead\n", 1)]
ANY_HEAD = ("template <int kRays>\n__global__ void __launch_bounds__(kBlock)\n"
            "any_kernel(RayPtrs ray, const float* __restrict__ tmin,\n")
ANY_END = "// dynamic shared memory of a launch: the records of one tile\n"
# a thread per lane, no compaction: the parent's kernel on records with
# record_test (kRays kept for the launch code, unused)
PER_LANE_ANY = (
    "template <int kRays>\n"
    "__global__ void __launch_bounds__(kBlock)\n"
    "any_kernel(RayPtrs ray, const float* __restrict__ tmin,\n"
    "           const float* __restrict__ tmax, const uint8_t* __restrict__ active,\n"
    "           const float* __restrict__ tris, int n_tris, int n, uint8_t* __restrict__ occ_out) {\n"
    "  extern __shared__ float4 rec[];\n"
    "  const int i = blockIdx.x * kBlock + threadIdx.x;\n"
    "  const bool live = i < n;\n"
    "  const bool work = live && active[i] != 0;\n"
    "  Ray r{};\n"
    "  float lo = 0.0f, hi = -1.0f;\n"
    "  if (work) {\n"
    "    r = load_ray(ray, i);\n"
    "    lo = tmin[i];\n"
    "    hi = tmax[i];\n"
    "  }\n"
    "  bool occ = false;\n"
    "  for (int base = 0; base < n_tris; base += kTileTris) {\n"
    "    if (!__syncthreads_or(work && !occ)) break;\n"
    "    const int cnt = min(kTileTris, n_tris - base);\n"
    "    stage_records(rec, tris, n_tris, base, cnt);\n"
    "    __syncthreads();\n"
    "    if (work && !occ) {\n"
    "      for (int c = 0; c < cnt; ++c) {\n"
    "        float t, u, v;\n"
    "        if (record_test(rec + 3 * c, r, lo, hi, &t, &u, &v)) {\n"
    "          occ = true;\n"
    "          break;\n"
    "        }\n"
    "      }\n"
    "    }\n"
    "  }\n"
    "  if (live) occ_out[i] = occ ? 1 : 0;\n"
    "}\n\n")
# the launch of the per-lane kernel: a block of kBlock lanes
PER_LANE_LAUNCH = [(
    "  any_kernel<kRays><<<(n + kLanes - 1) / kLanes, kBlock, smem, stream>>>(\n",
    "  any_kernel<kRays><<<(n + kBlock - 1) / kBlock, kBlock, smem, stream>>>(\n", 1)]

# a group's vote with the group's own lanes as the mask, the warp's lanes
# stepping apart (the first build of "+split")
GROUP_VOTES = [
    ("      for (int c0 = 0; c0 < cnt; c0 += kVoteStride * g) {\n"
     "        if (__all_sync(0xffffffffu, done)) break;\n",
     "      for (int c0 = 0; !done && c0 < cnt; c0 += kVoteStride * g) {\n", 1),
    ("          occ[k] = (__ballot_sync(0xffffffffu, occ[k]) >> lead) & gmask;\n",
     "          occ[k] = __any_sync(gmask << lead, occ[k]);\n", 1)]

# a ray's check for a hit (and a group's vote) after every test
VOTE_EACH_TEST = [("constexpr int kVoteStride = 4;", "constexpr int kVoteStride = 1;", 1)]
# any_kernel without its cap of 64 registers (four blocks an SM)
ANY_ANY_REGISTERS = [("__global__ void __launch_bounds__(kBlock, 4)\nany_kernel(",
                      "__global__ void __launch_bounds__(kBlock)\nany_kernel(", 1)]

# ---- gather.cu ----
ATTRIBUTE_EVERY_CALL = [(
    "  if (device < 64 && static_cast<int>(smem) <= allowed[device]) return cudaSuccess;\n",
    "", 1)]
LOADS_AFTER_INDEX = [(
    "        v[u] = ln < hi ? __ldg(g + static_cast<size_t>(ln) * q + c) : V{};\n",
    "        v[u] = (r[u] >= 0 && r[u] < rows) ? __ldg(g + static_cast<size_t>(ln) * q + c)"
    " : V{};\n", 1)]
# a run of consecutive lanes with one index summed in registers, its sum
# added to the partial when the index changes
RUNS = [
    ("    const int hi = min(n, lo + per_slice);\n"
     "    for (int base = lo; base < hi; base += kUnroll) {\n",
     "    const int hi = min(n, lo + per_slice);\n"
     "    int cur = -1;  // the run's index\n"
     "    V acc{};       // the run's sum\n"
     "    for (int base = lo; base < hi; base += kUnroll) {\n", 1),
    ("      for (int u = 0; u < kUnroll; ++u) {  // a lane out of range adds nothing\n"
     "        if (r[u] >= 0 && r[u] < rows) vadd(mine[r[u] * q], v[u]);\n"
     "      }\n"
     "    }\n",
     "      for (int u = 0; u < kUnroll; ++u) {  // a lane out of range adds nothing\n"
     "        if (r[u] < 0 || r[u] >= rows) r[u] = -1;\n"
     "        if (r[u] == cur) {\n"
     "          vadd(acc, v[u]);\n"
     "        } else {\n"
     "          if (cur >= 0 && cur < rows) vadd(mine[cur * q], acc);\n"
     "          cur = r[u];\n"
     "          acc = v[u];\n"
     "        }\n"
     "      }\n"
     "    }\n"
     "    if (cur >= 0 && cur < rows) vadd(mine[cur * q], acc);\n", 1)]
SCALAR_LOADS = [(
    "  const bool vec = cols % 4 == 0 && (reinterpret_cast<uintptr_t>(g) & 15u) == 0;\n",
    "  const bool vec = false;\n", 1)]
UNROLL_16 = [("constexpr int kUnroll = 8;", "constexpr int kUnroll = 16;", 1)]
# 512 threads a CTA (with ops/gather.py BWD_THREADS = 512): more slices
THREADS_512 = [("constexpr int kBwdThreads = 256;", "constexpr int kBwdThreads = 512;", 1)]
# no second launch: the CTAs take tickets (a threadfence, then atomicInc,
# which wraps each counter back to 0); the last CTA of each group of
# ceil(sqrt(grid)) sums its group's partials in CTA order, the last of those
# the group sums in group order. The scratch: 64 counters, zero before the
# first launch, then the CTAs' and the groups' partials
TICKETS = 64
ONE_LAUNCH = [
    ("                         int n, int slices, int per_slice, float* __restrict__ part) {\n",
     "                         int n, int slices, int per_slice, unsigned* __restrict__ tickets,\n"
     "                         float* __restrict__ part, float* __restrict__ out) {\n", 1),
    ("    dst[e] = a;\n  }\n}\n",
     "    dst[e] = a;\n  }\n"
     "  __shared__ bool last;\n"
     "  const int rk = rq * static_cast<int>(sizeof(V) / sizeof(float));\n"
     "  const int ctas = gridDim.x;\n"
     "  int gsz = 1;\n"
     "  while (gsz * gsz < ctas) ++gsz;\n"
     "  const int groups = (ctas + gsz - 1) / gsz;\n"
     "  const int grp = blockIdx.x / gsz;\n"
     "  const int g0 = grp * gsz, gn = min(gsz, ctas - g0);\n"
     "  __threadfence();\n"
     "  __syncthreads();\n"
     "  if (threadIdx.x == 0) last = atomicInc(tickets + grp, gn - 1) == static_cast<unsigned>(gn - 1);\n"
     "  __syncthreads();\n"
     "  if (!last) return;\n"
     "  float* sums = part + static_cast<size_t>(ctas) * rk;\n"
     "  for (int e = threadIdx.x; e < rk; e += blockDim.x) {\n"
     "    float a = __ldcg(part + static_cast<size_t>(g0) * rk + e);\n"
     "    for (int c2 = 1; c2 < gn; ++c2) a += __ldcg(part + static_cast<size_t>(g0 + c2) * rk + e);\n"
     "    sums[static_cast<size_t>(grp) * rk + e] = a;\n"
     "  }\n"
     "  __threadfence();\n"
     "  __syncthreads();\n"
     "  if (threadIdx.x == 0) last = atomicInc(tickets + 63, groups - 1) == static_cast<unsigned>(groups - 1);\n"
     "  __syncthreads();\n"
     "  if (!last) return;\n"
     "  for (int e = threadIdx.x; e < rk; e += blockDim.x) {\n"
     "    float a = __ldcg(sums + e);\n"
     "    for (int g2 = 1; g2 < groups; ++g2) a += __ldcg(sums + static_cast<size_t>(g2) * rk + e);\n"
     "    out[e] = a;\n"
     "  }\n"
     "}\n", 1),
    ("      reinterpret_cast<const V*>(g), idx, rows, q, n, s, per_slice, scratch);\n"
     "  err = cudaGetLastError();\n"
     "  if (err != cudaSuccess) return err;\n"
     "  const int rk = rows * cols;\n"
     "  gather_bwd_sum_kernel<<<(rk + 31) / 32, 256, 0, stream>>>(scratch, ctas, rk, out);\n",
     "      reinterpret_cast<const V*>(g), idx, rows, q, n, s, per_slice,\n"
     "      reinterpret_cast<unsigned*>(scratch), scratch + 64, out);\n", 1),
]

K1B_STEPS = ["parent", "+records", "+compaction", "+split", "+vote stride", "+min blocks 4",
             "+cached lanes"]
K1B_TRIES = ["+two-lane chunks", "+area order", "+group votes"]
K2B_STEPS = ["parent", "+grid", "+float4 loads", "+loads ahead", "+attribute once"]
K2B_TRIES = ["+runs in registers", "+unroll 16", "+one launch", "+two CTAs an SM",
             "+512 threads"]
# the try that caps a CTA's partials (ops/gather.py BWD_SMEM, so its slices)
# so that two CTAs fit an SM (228 KB, 1 KB of it a CTA's own)
TWO_CTAS = "+two CTAs an SM"
TWO_CTAS_SMEM = 113 * 1024
THREADS_512_STEP = "+512 threads"
HERE = {"trace.cu": "+cached lanes", "gather.cu": "+attribute once"}  # this checkout's build
# the step that changes ops/trace.py alone: the steps before it fill trace_any's
# number lanes per call
CACHED_LANES = "+cached lanes"
# the try that changes the soup K1b is given, not the source
AREA_ORDER = "+area order"

KERNELS = ("closest_kernel", "any_kernel", "gather_rows_kernel", "gather_bwd_shared_kernel",
           "gather_bwd_partial_kernel", "gather_bwd_sum_kernel", "gather_bwd_atomic_kernel")


def per_lane_any(src: str) -> str:
    """trace.cu with the any_kernel of "+records" in place of this one."""
    a, b = src.index(ANY_HEAD), src.index(ANY_END)
    return edited(src[:a] + PER_LANE_ANY + src[b:], PER_LANE_LAUNCH, "trace.cu")


def step_sources(trace_here: str, gather_here: str, trace_parent: str,
                 gather_parent: str) -> dict:
    """{(source file, step): source text} for every step and try."""
    t = lambda edits: edited(trace_here, edits, "trace.cu")
    g = lambda edits: edited(gather_here, edits, "gather.cu")
    return {
        ("trace.cu", "parent"): trace_parent,
        ("trace.cu", "+records"): per_lane_any(t(ANY_ANY_REGISTERS)),
        ("trace.cu", "+compaction"): t(ANY_NO_SPLIT + VOTE_EACH_TEST + ANY_ANY_REGISTERS),
        ("trace.cu", "+split"): t(VOTE_EACH_TEST + ANY_ANY_REGISTERS),
        ("trace.cu", "+vote stride"): t(ANY_ANY_REGISTERS),
        ("trace.cu", "+min blocks 4"): trace_here,
        ("trace.cu", "+cached lanes"): trace_here,
        ("trace.cu", "+two-lane chunks"): t(TWO_LANE_CHUNKS),
        ("trace.cu", "+area order"): trace_here,
        ("trace.cu", "+group votes"): t(GROUP_VOTES),
        ("gather.cu", "parent"): gather_parent,
        ("gather.cu", "+grid"): g(SCALAR_LOADS + LOADS_AFTER_INDEX + ATTRIBUTE_EVERY_CALL),
        ("gather.cu", "+float4 loads"): g(LOADS_AFTER_INDEX + ATTRIBUTE_EVERY_CALL),
        ("gather.cu", "+loads ahead"): g(ATTRIBUTE_EVERY_CALL),
        ("gather.cu", "+attribute once"): gather_here,
        ("gather.cu", "+runs in registers"): g(RUNS),
        ("gather.cu", "+unroll 16"): g(UNROLL_16),
        ("gather.cu", "+one launch"): g(ONE_LAUNCH),
        ("gather.cu", "+two CTAs an SM"): gather_here,
        ("gather.cu", "+512 threads"): g(THREADS_512),
    }


def parent_slices(rows: int, cols: int) -> int:
    """The parent's ops/gather.py bwd_slices (512-lane CTAs, 96 KB)."""
    if rows > 128:
        return 0
    s = max(1, min(8, 256 // max(cols, 1)))
    while s > 0 and s * rows * cols * 4 > 96 * 1024:
        s //= 2
    return s if cols <= 1024 else 0


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="an unpacked checkout of the commit whose K1b and K2b are the parent")
    ap.add_argument("--timed", nargs="*", default=None,
                    help="time only these steps (all are built and checked)")
    ap.add_argument("--cut", action="store_true",
                    help="time K2b's shared and atomic modes around the shared mode's row cut")
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
            builds[name] = {"trace.cu": "parent", "gather.cu": "parent"}
        elif name in K1B_STEPS + K1B_TRIES or name in K2B_STEPS + K2B_TRIES:
            builds[name] = dict(HERE, **{"trace.cu" if name in K1B_STEPS + K1B_TRIES
                                         else "gather.cu": name})
        elif name == "this":
            builds[name] = dict(HERE)
        else:
            ap.error(f"--builds: no step or try named {name!r}")
    if not torch.cuda.is_available():
        print("torch_k1b_k2b_steps: no CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from fermat_tpu_torch.core.math import Vec3
    from fermat_tpu_torch.integrators import pt
    from fermat_tpu_torch.ops import _cuda
    from fermat_tpu_torch.ops import gather as gather_mod
    from fermat_tpu_torch.ops import trace as trace_mod
    from fermat_tpu_torch.render.context import RenderingContext
    from fermat_tpu_torch.scene.procedural import cornell_box, cornell_camera, random_soup

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    csrc = lambda root, f: (root / "fermat_tpu_torch" / "ops" / "csrc" / f).read_text()
    variants = step_sources(csrc(ROOT, "trace.cu"), csrc(ROOT, "gather.cu"),
                            csrc(a.parent, "trace.cu"), csrc(a.parent, "gather.cu"))
    built = build({k: (k[0], v) for k, v in variants.items()}, _cuda.BUILD_DIR / "k1b_k2b_steps",
                  KERNELS)
    for fname in ("trace.cu", "gather.cu"):
        for step in {"parent", HERE[fname], *(b[fname] for b in builds.values())}:
            if built[(fname, step)][0] is None:
                raise SystemExit(f"{fname} {step} did not build")
    trace_kerns = [trace_mod.CLOSEST, trace_mod.ANY]
    gather_kerns = [gather_mod.GATHER, gather_mod.GATHER_BWD]
    libs = {}
    for (fname, step), (so, _, _) in built.items():
        if so is not None:
            libs[(fname, step)] = bind(so, trace_kerns if fname == "trace.cu" else gather_kerns)
    cached = trace_mod._lanes
    bwd_smem, bwd_threads = gather_mod.BWD_SMEM, gather_mod.BWD_THREADS

    def use(fname, step):
        for kern, (fn, err) in zip(trace_kerns if fname == "trace.cu" else gather_kerns,
                                   libs[(fname, step)]):
            kern._fn, kern._err = fn, err
        if fname == "trace.cu":
            before = step in K1B_STEPS and K1B_STEPS.index(step) < K1B_STEPS.index(CACHED_LANES)
            trace_mod._lanes = filled_lanes if before else cached
        else:
            gather_mod.BWD_SMEM = TWO_CTAS_SMEM if step == TWO_CTAS else bwd_smem
            gather_mod.BWD_THREADS = 512 if step == THREADS_512_STEP else bwd_threads

    def parent_bwd(g, idx, rows):
        """The parent's K2b launch, with its own wrapper's scratch and slices."""
        n, k = g.shape
        s = parent_slices(rows, k)
        scratch = torch.empty(-(-n // 512) * rows * k if s else 1, device=dev)
        out = torch.empty((rows, k), device=dev)
        gather_mod.GATHER_BWD.launch(dev, g.data_ptr(), idx.data_ptr(), rows, k, n,
                                     scratch.data_ptr(), out.data_ptr(), s)
        return out

    tickets = {}  # "+one launch": its scratch by shape, the counters zeroed once

    def one_launch_bwd(g, idx, rows):
        n, k = g.shape
        cap = torch.cuda.get_device_properties(dev).multi_processor_count * gather_mod.BWD_PER_SM
        if (rows, k) not in tickets:
            tickets[(rows, k)] = torch.zeros(TICKETS + (cap + math.isqrt(cap - 1) + 1) * rows * k,
                                             device=dev)
        out = torch.empty((rows, k), device=dev)
        gather_mod.GATHER_BWD.launch(dev, g.data_ptr(), idx.data_ptr(), rows, k, n,
                                     tickets[(rows, k)].data_ptr(), out.data_ptr(),
                                     gather_mod.bwd_slices(rows, k))
        return out

    def bwd_for(step):
        return {"parent": parent_bwd, "+one launch": one_launch_bwd}.get(
            step, gather_mod.gather_rows_bwd)

    # ---- the main path's inputs, recorded with this checkout's kernels ----
    use("trace.cu", HERE["trace.cu"])
    use("gather.cu", HERE["gather.cu"])
    ctx = RenderingContext.create(cornell_box(glossy_boxes=True), cornell_camera(), RES, RES,
                                  renderer="pt", max_path_length=MPL)
    opts = pt.PTOptions(**ctx.renderer_options)
    dense = record_pass(ctx.view, opts, RES, RES)
    step_rec = record_ad_step(ctx.view, opts, RES, RES, 2)
    lanes = lambda x, n: cached(x, n, dev)
    k1b = []  # (label, wrapper args, the plain version's lanes)
    for src, recs in (("pass", dense["k1b"]), ("AD step", step_rec["k1b"])):
        for k, (tris, o, d, tmin, tmax, active) in enumerate(recs):
            n = o.x.shape[0]
            act = active if active is not None else torch.ones(n, dtype=torch.bool, device=dev)
            k1b.append((f"{src} {k}: {int(act.sum())} active", (tris, o, d, tmin, tmax, active),
                        (lanes(tmin, n), lanes(tmax, n), act)))
    soup = random_soup(4096)
    soup_tris = soup.device_view(dev).tri_soup()
    gen = torch.Generator(device=dev).manual_seed(20261018)
    lo = torch.tensor(soup.vertices.min(0), device=dev)[:, None]
    hi = torch.tensor(soup.vertices.max(0), device=dev)[:, None]
    so = torch.rand(3, N_SOUP, generator=gen, device=dev) * (hi - lo) + lo
    sd = torch.randn(3, N_SOUP, generator=gen, device=dev)
    sd = sd / sd.norm(dim=0, keepdim=True)
    s_act = torch.rand(N_SOUP, generator=gen, device=dev) < 0.8
    s_tmax = torch.rand(N_SOUP, generator=gen, device=dev) * float((hi - lo).norm())
    extra = [("soup4096", (soup_tris, Vec3(*so), Vec3(*sd), 0.0, s_tmax, s_act),
              (lanes(0.0, N_SOUP), s_tmax, s_act))]
    # the first launch's rays with no lane and every 64th lane active: the
    # launch's floor, and its cost at a sparse bounce
    tris0, o0, d0, tmin0, tmax0, _ = k1b[0][1]
    n0 = o0.x.shape[0]
    for label, keep in (("no lane active", torch.zeros(n0, dtype=torch.bool, device=dev)),
                        ("every 64th lane active", torch.arange(n0, device=dev) % 64 == 0)):
        extra.append((label, (tris0, o0, d0, tmin0, tmax0, keep), (*k1b[0][2][:2], keep)))
    k1b_cases = k1b + extra
    # +area order: each soup's triangles by decreasing area, made once
    by_area = {}
    for _, args, _ in k1b_cases:
        tris = args[0]
        if tris.data_ptr() not in by_area:
            e1, e2 = tris[3:6], tris[6:9]
            area = torch.linalg.cross(e1, e2, dim=0).norm(dim=0)
            by_area[tris.data_ptr()] = tris[:, torch.argsort(-area, stable=True)].contiguous()
    k2b = [(f"AD step {k}: {g.shape[0]} x {g.shape[1]} into {r} rows", (g, i, r))
           for k, (g, i, r) in enumerate(step_rec["k2b"])]
    u_idx = torch.randint(0, 36, (N_CUT,), generator=gen, device=dev, dtype=torch.int32)
    k2b_cases = k2b + [("uniform: 262,144 x 52 into 36 rows",
                        (torch.randn(N_CUT, 52, generator=gen, device=dev), u_idx, 36))]
    log(f"recorded: K1b {len(dense['k1b'])} pass + {len(step_rec['k1b'])} AD-step launches, "
        f"active lanes {[c[0] for c in k1b]}, {k1b[0][1][0].shape[1]} triangles; K2b "
        f"{len(k2b)} launches {sorted({c[0].split(': ')[1] for c in k2b})}; runs of equal "
        f"indices a launch: {[int((i[1:] != i[:-1]).sum()) + 1 for _, (_, i, _) in k2b]}")

    # the plain answers, once
    plain_any = [trace_mod._any_plain(args[0], args[1], args[2], *pl) for _, args, pl in k1b_cases]
    plain_bwd = [(gather_mod._gather_bwd_plain(g, i, r),
                  gather_mod._gather_bwd_plain(g.abs(), i, r)) for _, (g, i, r) in k2b_cases]
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

    def any_call(step, args):
        tris = by_area[args[0].data_ptr()] if step == AREA_ORDER else args[0]
        return lambda: trace_mod.trace_any(tris, *args[1:])

    parent_out = {}

    def check_trace(step, row):
        bad = []
        for k, ((lab, args, _), want) in enumerate(zip(k1b_cases, plain_any)):
            f = any_call(step, args)
            got, again = f(), f()
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                bad.append(f"{lab} differs from plain")
            if not torch.equal(got, again):
                bad.append(f"{lab}: two launches differ")
            if step == "parent":
                parent_out[("k1b", k)] = got
            elif not torch.equal(got, parent_out[("k1b", k)]):
                bad.append(f"{lab} differs from the parent")
        row["failed"] = bad

    def check_gather(step, row):
        bad, rel = [], []
        f = bwd_for(step)
        for k, ((lab, (g, i, r)), (want, scale)) in enumerate(zip(k2b_cases, plain_bwd)):
            got, again = f(g, i, r), f(g, i, r)
            torch.cuda.synchronize()
            err = float(((got - want).abs() / scale.clamp_min(1e-30)).max())
            if err > gather_mod.BWD_RTOL:
                bad.append(f"{lab}: {err:.3g} of sum|g| from plain")
            if not torch.equal(bits(got), bits(again)):
                bad.append(f"{lab}: two launches differ")
            if step == "parent":
                parent_out[("k2b", k)] = got
            else:
                rel.append(float(((got - parent_out[("k2b", k)]).abs()
                                  / scale.clamp_min(1e-30)).max()))
        row["failed"] = bad
        row["max_err_over_sum_abs_g_vs_parent"] = max(rel) if rel else 0.0

    def time_trace(step, row):
        row["k1b"] = timed_set([(lab, any_call(step, args)) for lab, args, _ in k1b_cases])
        direct = []  # the kernel alone: its launch arguments made once
        for lab, args, pl in k1b_cases:
            tris = by_area[args[0].data_ptr()] if step == AREA_ORDER else args[0]
            kargs = trace_mod._kernel_args(tris, args[1], args[2], *pl)
            n = args[1].x.shape[0]
            occ = torch.empty(n, dtype=torch.bool, device=dev)
            ptrs = [x.data_ptr() for x in kargs]
            direct.append((lab, (lambda p=ptrs, t=tris.shape[1], n=n, o=occ, _h=kargs:
                                 trace_mod.ANY.launch(dev, *p, t, n, o.data_ptr()))))
        row["k1b_kernel"] = timed_set(direct)
        path = row["k1b"]["each"][:len(k1b)]
        row["k1b_path_us"] = statistics.fmean(e["warm"]["us"] for e in path)
        row["k1b_path_kernel_us"] = statistics.fmean(
            e["warm"]["us"] for e in row["k1b_kernel"]["each"][:len(k1b)])

    def time_gather(step, row):
        f = bwd_for(step)
        row["k2b"] = timed_set([(lab, (lambda g=g, i=i, r=r: f(g, i, r)))
                                for lab, (g, i, r) in k2b_cases])
        row["k2b_path_us"] = statistics.fmean(e["warm"]["us"]
                                              for e in row["k2b"]["each"][:len(k2b)])

    timed = None if a.timed is None else set(a.timed)
    results = []
    for fname, steps, tries, checker, timer in (
            ("trace.cu", K1B_STEPS, K1B_TRIES, check_trace, time_trace),
            ("gather.cu", K2B_STEPS, K2B_TRIES, check_gather, time_gather)):
        use("trace.cu", HERE["trace.cu"])
        use("gather.cu", HERE["gather.cu"])
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
                timer(step, row)
                if fname == "trace.cu":
                    msg = (f"K1b {row['k1b_path_us']:.2f} us/launch over the path's "
                           f"{len(k1b)} (the kernel alone {row['k1b_path_kernel_us']:.2f}); "
                           "each launch (wrapper / alone) " + ", ".join(
                               f"{e['launch']} {e['warm']['us']:.2f} / {k['warm']['us']:.2f}"
                               for e, k in zip(row["k1b"]["each"], row["k1b_kernel"]["each"])))
                else:
                    msg = (f"K2b {row['k2b_path_us']:.2f} us/launch over the AD step's "
                           f"{len(k2b)} (max {row['max_err_over_sum_abs_g_vs_parent']:.3g} of "
                           "sum|g| from the parent); each launch " + ", ".join(
                               f"{e['launch']} {e['warm']['us']:.2f} (cold "
                               f"{e['cold']['us']:.2f})" for e in row["k2b"]["each"]))
                log(f"{fname} {step}: equal to plain (and K1b to the parent) at every launch; "
                    + msg)
            results.append(row)
            print(json.dumps(row), flush=True)
    use("trace.cu", HERE["trace.cu"])
    use("gather.cu", HERE["gather.cu"])

    # ---- K2b's two modes around the shared mode's row cut ----
    if a.cut:
        for rows, cols in CUT_SHAPES:
            q = cols // 4 if cols % 4 == 0 else cols
            s = min(gather_mod.BWD_THREADS // q, gather_mod.BWD_SMEM // (4 * rows * cols))
            for pattern in ("runs", "uniform"):
                if pattern == "runs":  # runs of 1-32 lanes, a random row each
                    lens = torch.randint(1, 33, (N_CUT,), generator=gen, device=dev)
                    ends = torch.cumsum(lens, 0)
                    starts = torch.zeros(N_CUT, dtype=torch.bool, device=dev)
                    starts[ends[ends < N_CUT]] = True
                    starts[0] = True
                    run_row = torch.randint(0, rows, (N_CUT,), generator=gen, device=dev)
                    idx = run_row[torch.cumsum(starts.long(), 0) - 1].to(torch.int32)
                else:
                    idx = torch.randint(0, rows, (N_CUT,), generator=gen, device=dev,
                                        dtype=torch.int32)
                g = torch.randn(N_CUT, cols, generator=gen, device=dev)
                want = gather_mod._gather_bwd_plain(g, idx, rows)
                scale = gather_mod._gather_bwd_plain(g.abs(), idx, rows)
                scratch = torch.empty(torch.cuda.get_device_properties(dev).multi_processor_count
                                      * gather_mod.BWD_PER_SM * rows * cols, device=dev)

                def mode(slices, g=g, idx=idx, rows=rows, cols=cols, scratch=scratch):
                    out = torch.empty((rows, cols), device=dev)
                    gather_mod.GATHER_BWD.launch(dev, g.data_ptr(), idx.data_ptr(), rows, cols,
                                                 N_CUT, scratch.data_ptr(), out.data_ptr(), slices)
                    return out

                row = {"cut": [rows, cols], "pattern": pattern, "slices": s,
                       "card": torch.cuda.get_device_name(0), "nvidia_smi": smi}
                for label, sl in (("shared", s), ("atomic", 0)):
                    if sl == 0 and label == "shared":
                        continue
                    got = mode(sl)
                    torch.cuda.synchronize()
                    err = float(((got - want).abs() / scale.clamp_min(1e-30)).max())
                    if err > gather_mod.BWD_RTOL:
                        row.setdefault("failed", []).append(f"{label}: {err:.3g} of sum|g|")
                    row[label] = {**replay(lambda sl=sl: mode(sl), False, flush), "err": err}
                results.append(row)
                print(json.dumps(row), flush=True)
                log(f"K2b cut ({rows}, {cols}) {pattern}: " + ", ".join(
                    f"{m} {row[m]['us']:.2f} us" for m in ("shared", "atomic") if m in row)
                    + f" (slices {s}); bwd_slices picks "
                    f"{'shared' if gather_mod.bwd_slices(rows, cols) else 'atomic'}")

    # ---- the builds of --builds end to end, alternating ----
    def filled_any(tris, o, d, tmin, tmax, active=None):
        """trace_any as the parent's wrapper called it: its number lanes filled."""
        n = o.x.shape[0]
        return trace_any(tris, o, d, filled_lanes(tmin, n, dev), filled_lanes(tmax, n, dev),
                         active)

    trace_any = trace_mod.trace_any

    def device_us(prof) -> dict:
        us = {"busy": 0.0, "k1b": 0.0, "k2b": 0.0}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us["busy"] += e.self_device_time_total
                if "any_kernel" in e.name:
                    us["k1b"] += e.self_device_time_total
                if "gather_bwd" in e.name:
                    us["k2b"] += e.self_device_time_total
        return {k: v / 1e3 for k, v in us.items()}

    def dense_pass(c):
        c.render_batch(1)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            c.render_batch(1)
        p = device_us(prof)
        best = float("inf")
        for _ in range(REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            c.render_batch(PASSES)  # ends in torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        return {"ms_per_pass": best / PASSES * 1e3, "busy_ms": p["busy"], "k1b_ms": p["k1b"]}

    def train_step():
        ad_step(ctx.view, opts, RES, RES, 1)  # warm-up
        best = float("inf")
        for k in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ad_step(ctx.view, opts, RES, RES, 2 + k)
            torch.cuda.synchronize()
            best = min(best, time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ad_step(ctx.view, opts, RES, RES, 4)
            torch.cuda.synchronize()
        p = device_us(prof)
        return {"ms_per_step": best * 1e3, "busy_ms": p["busy"], "k1b_ms": p["k1b"],
                "k2b_ms": p["k2b"]}

    host = {who: [] for who in builds}
    for k in range(a.alternate):
        for who in (list(builds) if k % 2 == 0 else list(builds)[::-1]):
            for fname in ("trace.cu", "gather.cu"):
                use(fname, builds[who][fname])
            t_step, g_step = builds[who]["trace.cu"], builds[who]["gather.cu"]
            fill = t_step in K1B_STEPS and K1B_STEPS.index(t_step) < K1B_STEPS.index(CACHED_LANES)
            with patch([(pt, "trace_any", filled_any if fill else trace_any),
                        (gather_mod, "gather_rows_bwd", bwd_for(g_step))]):
                trace_mod._lanes = cached  # K1a's lanes as the parent cached them
                ctx.restart()
                row = {"alternate_round": k, "build": who, "dense": dense_pass(ctx),
                       "ad_step": train_step()}
            host[who].append(row)
            results.append(row)
            print(json.dumps(row), flush=True)
    for who, rows in host.items():
        if rows:
            parts = []
            for label, keys in (("dense", ("ms_per_pass", "busy_ms", "k1b_ms")),
                                ("ad_step", ("ms_per_step", "busy_ms", "k1b_ms", "k2b_ms"))):
                for key in keys:
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
