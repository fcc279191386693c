#!/usr/bin/env python3
"""K5 (the frontier tracer, fermat_tpu_torch/ops/csrc/frontier.cu) step by
step on one CUDA card, at the inputs of one monolithic big_room(8300)
1600x896 6-bounce pass (chip_smoke.py phase 4d's configuration).

    python3 tools/torch_k5_steps.py --parent DIR [--out FILE]

DIR holds an unpacked checkout of an earlier commit (`git archive`): its
fermat_tpu_torch/ops/csrc/frontier.cu is built as the parent kernel, with
its own C signature (rays, the (n, 6) node boxes and node refs, the (6, Cp)
cluster boxes, rows, counts). The design steps are built from this
checkout's frontier.cu, each with the later steps taken out again, or a
step this checkout left out put in, by exact text edits of the source (the
script stops if one no longer applies):

  parent        the parent's kernel on the rays in the caller's order
  +sort         the parent's kernel on the rays co-sorted by the key of
                key_kernel (gathered into sorted order first; that gather
                and the scatter of the answers are not in its time)
  +records      the new kernel with the sort and the 64-byte node records,
                one thread per ray, its stack in local memory, one loop over
                inner nodes and leaves alike
  +smem stack   the same with the stack in shared memory
  +while-while  the same with the walk's inner loop over inner nodes until
                a lane holds a leaf (the warp's leaves tested together):
                this checkout's kernel
  +persistent   the same with persistent warps: a grid that fills the card,
                each warp taking the next 32 sorted rays from a global
                counter when all of its lanes are done
  +L2 window    this checkout's kernel with an L2 access-policy window
                (persisting) over the cluster rows around each launch
                (cudaLimitPersistingL2CacheSize set to the rows' bytes)

For each: every launch's answer is checked bit-equal to the plain version
(the plain answers computed once), then its device time per launch in
replay (CUDA events around each of 20 back-to-back replays of the kernel
launch alone, after a warm-up and queued behind a spin kernel so that the
events bracket device work only: median and min/max; and cold, with 128
MiB written before each replay) and inside one profiled pass (torch.profiler,
the kernel's own device time per launch, with the pass's device-busy time).
The kernels run in the order parent, the steps, then parent and this
checkout's kernel again (the L2 window last: its set-aside outlives its
launches), so drift within the call shows. Prints one JSON
line per kernel and a summary; --out writes them all as one JSON file.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))
from torch_steps_common import FLUSH_BYTES, build, edited, log, replay  # noqa: E402

BIG_BOXES, BIG_W, BIG_H, MPL = 8300, 1600, 896, 6

# the exact text edits that take a step out of this checkout's frontier.cu
LOCAL_STACK = [
    ("  extern __shared__ int2 stack_mem[];  // (depth, kBlock)\n"
     "  int2* stack = stack_mem + threadIdx.x;\n",
     "  int2 stack_local[kMaxStack];\n  int2* stack = stack_local;\n"),
    ("stack[sp * kBlock] = make_int2(", "stack[sp] = make_int2("),
    ("top = stack[--sp * kBlock];", "top = stack[--sp];"),
    ("  const size_t smem = static_cast<size_t>(depth) * kBlock * sizeof(int2);\n",
     "  const size_t smem = 0;\n"),
]
WALK = (
    "// Walks the tree; for each entered cluster calls leaf(c, e') and stops when\n"
    '// it returns true. `limit` is read before each entry (the best t so far).\n'
    "// stack: this thread's column of the CTA's shared-memory stack. A lane\n"
    '// steps through inner nodes until it holds a leaf, so the lanes of a warp\n'
    "// run their leaves' triangle loops together rather than one after another\n"
    '// (the while-while loop of Aila and Laine).\n'
    'template <typename Leaf>\n'
    '__device__ __forceinline__ void walk(const Ray& r, const Scene& s, const float& limit,\n'
    '                                     int2* __restrict__ stack, Leaf leaf) {\n'
    '  int sp = 0;\n'
    '  int ref = 0;  // record 0 is the root\n'
    '  float e = 0.0f;\n'
    '  // the nearest deferred node still within the limit into (ref, e); false\n'
    '  // when none is left\n'
    '  auto pop = [&]() {\n'
    '    int2 top;\n'
    '    do {\n'
    '      if (sp == 0) return false;\n'
    '      top = stack[--sp * kBlock];\n'
    '    } while (__int_as_float(top.y) > limit);\n'
    '    ref = top.x;\n'
    '    e = __int_as_float(top.y);\n'
    '    return true;\n'
    '  };\n'
    '  for (;;) {\n'
    '    while (ref >= 0) {\n'
    '      const float4* nd = s.nodes + 4 * ref;\n'
    '      const float4 a = __ldg(nd);      // left lo.x hi.x lo.y hi.y\n'
    '      const float4 b = __ldg(nd + 1);  // right lo.x hi.x lo.y hi.y\n'
    '      const float4 c = __ldg(nd + 2);  // left lo.z hi.z, right lo.z hi.z\n'
    '      const float4 d = __ldg(nd + 3);  // left ref, right ref (int bits)\n'
    '      float el, er;\n'
    '      const bool vl = slab(r, a.x, a.z, c.x, a.y, a.w, c.y, &el) && el <= limit;\n'
    '      const bool vr = slab(r, b.x, b.z, c.z, b.y, b.w, c.w, &er) && er <= limit;\n'
    '      const int rl = __float_as_int(d.x), rr = __float_as_int(d.y);\n'
    '      if (vl && vr) {\n'
    '        const bool left_first = el <= er;\n'
    '        stack[sp * kBlock] = make_int2(left_first ? rr : rl,\n'
    '                                       __float_as_int(left_first ? er : el));\n'
    '        ++sp;\n'
    '        ref = left_first ? rl : rr;\n'
    '        e = left_first ? el : er;\n'
    '      } else if (vl || vr) {\n'
    '        ref = vl ? rl : rr;\n'
    '        e = vl ? el : er;\n'
    '      } else if (!pop()) {\n'
    '        return;\n'
    '      }\n'
    '    }\n'
    '    if (leaf(~ref, e) || !pop()) return;\n'
    '  }\n'
    '}\n'
)
ONE_LOOP = [(WALK, (
    "// Walks the tree; for each entered cluster calls leaf(c, e') and stops when\n"
    '// it returns true. `limit` is read before each entry (the best t so far).\n'
    "// stack: this thread's column of the CTA's shared-memory stack.\n"
    'template <typename Leaf>\n'
    '__device__ __forceinline__ void walk(const Ray& r, const Scene& s, const float& limit,\n'
    '                                     int2* __restrict__ stack, Leaf leaf) {\n'
    '  int sp = 0;\n'
    '  int ref = 0;  // record 0 is the root\n'
    '  float e = 0.0f;\n'
    '  while (true) {\n'
    '    if (ref >= 0) {\n'
    '      const float4* nd = s.nodes + 4 * ref;\n'
    '      const float4 a = __ldg(nd);      // left lo.x hi.x lo.y hi.y\n'
    '      const float4 b = __ldg(nd + 1);  // right lo.x hi.x lo.y hi.y\n'
    '      const float4 c = __ldg(nd + 2);  // left lo.z hi.z, right lo.z hi.z\n'
    '      const float4 d = __ldg(nd + 3);  // left ref, right ref (int bits)\n'
    '      float el, er;\n'
    '      const bool vl = slab(r, a.x, a.z, c.x, a.y, a.w, c.y, &el) && el <= limit;\n'
    '      const bool vr = slab(r, b.x, b.z, c.z, b.y, b.w, c.w, &er) && er <= limit;\n'
    '      const int rl = __float_as_int(d.x), rr = __float_as_int(d.y);\n'
    '      if (vl && vr) {\n'
    '        const bool left_first = el <= er;\n'
    '        stack[sp * kBlock] = make_int2(left_first ? rr : rl,\n'
    '                                       __float_as_int(left_first ? er : el));\n'
    '        ++sp;\n'
    '        ref = left_first ? rl : rr;\n'
    '        e = left_first ? el : er;\n'
    '        continue;\n'
    '      }\n'
    '      if (vl || vr) {\n'
    '        ref = vl ? rl : rr;\n'
    '        e = vl ? el : er;\n'
    '        continue;\n'
    '      }\n'
    '    } else if (leaf(~ref, e)) {\n'
    '      return;\n'
    '    }\n'
    '    // the nearest deferred node still within the limit, or done\n'
    '    int2 top;\n'
    '    do {\n'
    '      if (sp == 0) return;\n'
    '      top = stack[--sp * kBlock];\n'
    '    } while (__int_as_float(top.y) > limit);\n'
    '    ref = top.x;\n'
    '    e = __int_as_float(top.y);\n'
    '  }\n'
    '}\n'
))]
LAUNCH = ("  trace_kernel<kClosest><<<(n + kBlock - 1) / kBlock, kBlock, smem, stream>>>(\n"
          "      ray, perm, s, n, t_out, tri_out, occ_out);\n"
          "  return cudaGetLastError();\n")
PERSISTENT = [
    ("// Thread slot k traces ray perm[k] (ray k without a permutation).\n",
     "__device__ int g_next;  // the persistent warps' ray counter\n"),
    ("  const int slot = blockIdx.x * kBlock + threadIdx.x;\n"
     "  if (slot >= n) return;\n"
     "  const int i = perm != nullptr\n"
     "                    ? static_cast<int>(__ldg(reinterpret_cast<const long long*>(perm) + slot))\n"
     "                    : slot;\n"
     "  if (kClosest) {\n"
     "    closest_ray(ray, s, i, stack, t_out, tri_out);\n"
     "  } else {\n"
     "    any_ray(ray, s, i, stack, occ_out);\n"
     "  }\n"
     "}\n",
     "  const int lane = threadIdx.x & 31;\n"
     "  for (;;) {\n"
     "    int base = 0;\n"
     "    if (lane == 0) base = atomicAdd(&g_next, 32);\n"
     "    base = __shfl_sync(0xffffffffu, base, 0);\n"
     "    if (base >= n) return;\n"
     "    const int slot = base + lane;\n"
     "    if (slot < n) {\n"
     "      const int i = perm != nullptr\n"
     "          ? static_cast<int>(__ldg(reinterpret_cast<const long long*>(perm) + slot))\n"
     "          : slot;\n"
     "      if (kClosest) {\n"
     "        closest_ray(ray, s, i, stack, t_out, tri_out);\n"
     "      } else {\n"
     "        any_ray(ray, s, i, stack, occ_out);\n"
     "      }\n"
     "    }\n"
     "  }\n"
     "}\n"),
    (LAUNCH,
     "  int dev = 0, sms = 0, per_sm = 0;\n"
     "  void* next = nullptr;\n"
     "  cudaError_t err = cudaGetDevice(&dev);\n"
     "  if (err == cudaSuccess)\n"
     "    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);\n"
     "  if (err == cudaSuccess)\n"
     "    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, trace_kernel<kClosest>,\n"
     "                                                        kBlock, smem);\n"
     "  if (err == cudaSuccess) err = cudaGetSymbolAddress(&next, g_next);\n"
     "  if (err == cudaSuccess) err = cudaMemsetAsync(next, 0, sizeof(int), stream);\n"
     "  if (err != cudaSuccess) return err;\n"
     "  const int wanted = (n + kBlock - 1) / kBlock;\n"
     "  const int grid = wanted < sms * per_sm ? wanted : sms * per_sm;\n"
     "  trace_kernel<kClosest><<<grid, kBlock, smem, stream>>>(\n"
     "      ray, perm, s, n, t_out, tri_out, occ_out);\n"
     "  return cudaGetLastError();\n"),
]


def l2_window(rows_bytes: int) -> list:
    return [(LAUNCH,
             f"  const size_t l2_bytes = {rows_bytes};\n"
             "  cudaError_t err = cudaDeviceSetLimit(cudaLimitPersistingL2CacheSize, l2_bytes);\n"
             "  if (err != cudaSuccess) return err;\n"
             "  cudaStreamAttrValue attr = {};\n"
             "  attr.accessPolicyWindow.base_ptr = const_cast<float4*>(s.rows);\n"
             "  attr.accessPolicyWindow.num_bytes = l2_bytes;\n"
             "  attr.accessPolicyWindow.hitRatio = 1.0f;\n"
             "  attr.accessPolicyWindow.hitProp = cudaAccessPropertyPersisting;\n"
             "  attr.accessPolicyWindow.missProp = cudaAccessPropertyStreaming;\n"
             "  err = cudaStreamSetAttribute(stream, cudaStreamAttributeAccessPolicyWindow, &attr);\n"
             "  if (err != cudaSuccess) return err;\n"
             "  trace_kernel<kClosest><<<(n + kBlock - 1) / kBlock, kBlock, smem, stream>>>(\n"
             "      ray, perm, s, n, t_out, tri_out, occ_out);\n"
             "  err = cudaGetLastError();\n"
             "  attr.accessPolicyWindow.num_bytes = 0;\n"
             "  const cudaError_t reset =\n"
             "      cudaStreamSetAttribute(stream, cudaStreamAttributeAccessPolicyWindow, &attr);\n"
             "  return err != cudaSuccess ? err : reset;\n")]


class Lib:
    """The C entry points of one build of frontier.cu."""

    def __init__(self, so: Path, parent: bool):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib = ctypes.CDLL(str(so))
        self.parent = parent
        if parent:
            sig_c = [P] * 9 + [P, P, P, I, P, P, I, P, P]
            sig_a = [P] * 9 + [P, P, P, I, P, P, I, P]
        else:
            sig_c = [P] * 9 + [P, P, P, P, I, I, P, P]
            sig_a = [P] * 9 + [P, P, P, P, I, I, P]
        self.closest, self.any = lib.fermat_frontier_closest, lib.fermat_frontier_any
        for fn, sig in ((self.closest, sig_c), (self.any, sig_a)):
            fn.argtypes = sig + [I, P]
            fn.restype = I

    def call(self, fn, args: list) -> None:
        import torch

        dev = torch.cuda.current_device()
        code = fn(*[a if isinstance(a, int) else 0 if a is None else a.data_ptr() for a in args],
                  dev, torch.cuda.current_stream().cuda_stream)
        if code != 0:
            raise RuntimeError(f"CUDA error {code} at launch")


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="an unpacked checkout of the commit whose K5 is the parent")
    ap.add_argument("--out", type=Path, default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k5_steps: no CUDA card", file=sys.stderr)
        return 1
    from fermat_tpu_torch.core.math import Vec3
    from fermat_tpu_torch.integrators import pt
    from fermat_tpu_torch.ops import _cuda
    from fermat_tpu_torch.ops import frontier_trace as ft
    from fermat_tpu_torch.ops.trace import _lane_args
    from fermat_tpu_torch.render.context import RenderingContext
    from fermat_tpu_torch.scene.procedural import big_room, big_room_camera

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    ctx = RenderingContext.create(big_room(BIG_BOXES), big_room_camera(), BIG_W, BIG_H,
                                  renderer="pt", max_path_length=MPL)
    view, opts = ctx.view, pt.PTOptions(**ctx.renderer_options)
    cl = view.clusters
    here = (ROOT / "fermat_tpu_torch" / "ops" / "csrc").resolve()
    there = (a.parent / "fermat_tpu_torch" / "ops" / "csrc").resolve()
    src = (here / "frontier.cu").read_text()
    steps_src = {
        "+records": edited(src, ONE_LOOP + LOCAL_STACK, "frontier.cu"),
        "+smem stack": edited(src, ONE_LOOP, "frontier.cu"),
        "+while-while": src,
        "+persistent": edited(src, PERSISTENT, "frontier.cu"),
        "+L2 window": edited(src, l2_window(cl.rows.numel() * 4), "frontier.cu"),
    }
    kernels = ("trace_kernel", "key_kernel")
    parent_build = build({"parent": ("frontier.cu", (there / "frontier.cu").read_text())},
                         _cuda.BUILD_DIR / "k5_steps", kernels, (there / "cluster_common.cuh",))
    sos = {**parent_build, **build({k: ("frontier.cu", v) for k, v in steps_src.items()},
                                   _cuda.BUILD_DIR / "k5_steps", kernels,
                                   (here / "cluster_common.cuh",))}
    failed = [k for k, (so, _, _) in sos.items() if so is None]
    if failed:
        raise SystemExit(f"nvcc failed for {failed}")
    libs = {k: Lib(so, parent=k == "parent") for k, (so, _, _) in sos.items()}
    libs["+sort"] = libs["parent"]

    # the rays of every K5 launch of one pass, and the plain answers
    calls = {"closest": [], "any": []}
    orig = {k: getattr(pt, f"trace_{k}_frontier") for k in calls}

    def recorder(kind):
        def wrapper(c, o, d, tmin, tmax, active=None, **kw):
            calls[kind].append((o, d, *_lane_args(o, tmin, tmax, active)))
            return orig[kind](c, o, d, tmin, tmax, active, **kw)
        return wrapper

    for k in calls:
        setattr(pt, f"trace_{k}_frontier", recorder(k))
    pt.render_pass(view, opts, BIG_W, BIG_H, 2000, 0)
    for k in calls:
        setattr(pt, f"trace_{k}_frontier", orig[k])
    want = {"closest": [ft._closest_plain(cl, *c) for c in calls["closest"]],
            "any": [ft._any_plain(cl, *c) for c in calls["any"]]}
    torch.cuda.synchronize()
    log(f"recorded {len(calls['closest'])} + {len(calls['any'])} launches; plain answers done")

    def launcher(name, kind, o, d, tmin, tmax, active):
        """(launch(), outputs): the kernel alone, inputs prepared outside."""
        lib, n = libs[name], o.x.shape[0]
        fn = lib.closest if kind == "closest" else lib.any
        outs = ([torch.empty(n, device=dev), torch.empty(n, dtype=torch.int32, device=dev)]
                if kind == "closest" else [torch.empty(n, dtype=torch.bool, device=dev)])
        if lib.parent:
            perm = None
            if name != "parent":  # +sort: the rays gathered into sorted order
                perm = torch.argsort(ft.sort_key(cl, o, d, tmin, tmax, active), stable=True)
                o, d = (Vec3(*(c[perm] for c in v)) for v in (o, d))
                tmin, tmax, active = tmin[perm], tmax[perm], active[perm]
            rays = ft._ray_args(o, d, tmin, tmax, active)
            boxes = cl.boxes().contiguous()
            args = [*rays, cl.node_box, cl.node_ref, boxes, boxes.shape[1], cl.rows, cl.count, n,
                    *outs]
        else:
            perm = None
            args = [*ft._launch_args(cl, o, d, tmin, tmax, active), *outs]
        hold = (args, outs)

        def launch():
            lib.call(fn, hold[0])

        def answer():
            if perm is None:
                return outs
            back = [torch.empty_like(x) for x in outs]
            for b, x in zip(back, outs):
                b[perm] = x
            return back
        return launch, answer

    flush = torch.empty(FLUSH_BYTES // 4, device=dev)

    def in_pass(name):
        """Per-launch device ms of the kernel inside one profiled pass, with
        pt's frontier tracers going through this build, and the pass's
        device-busy ms."""
        from torch.profiler import ProfilerActivity, profile

        def tracer(kind):
            def wrapper(c, o, d, tmin, tmax, active=None, **kw):
                tmin, tmax, active = _lane_args(o, tmin, tmax, active)
                launch, answer = launcher(name, kind, o, d, tmin, tmax, active)
                launch()
                out = answer()
                if kind == "any":
                    return out[0]
                z = torch.zeros_like(out[0])
                return ft.Hit(t=out[0], tri=out[1], u=z, v=z)
            return wrapper

        saved = {k: getattr(pt, f"trace_{k}_frontier") for k in calls}
        for k in calls:
            setattr(pt, f"trace_{k}_frontier", tracer(k))
        try:
            ctx.render_batch(1)  # warm-up
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                ctx.render_batch(1)
        finally:
            for k in calls:
                setattr(pt, f"trace_{k}_frontier", saved[k])
        each, busy = {"closest": [], "any": []}, 0.0
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                busy += e.self_device_time_total / 1e3
                nm = e.name
                if "closest_kernel" in nm or "trace_kernel<true>" in nm:
                    each["closest"].append(e.self_device_time_total / 1e3)
                elif "any_kernel" in nm or "trace_kernel<false>" in nm:
                    each["any"].append(e.self_device_time_total / 1e3)
        return each, busy

    def measure(name, row):
        """Every launch held bit-equal to plain, timed in replay, then in a pass."""
        for kind in ("closest", "any"):
            warm, cold = [], []
            for c, w in zip(calls[kind], want[kind]):
                launch, answer = launcher(name, kind, *c)
                launch()
                got = answer()
                torch.cuda.synchronize()
                if kind == "closest":
                    ok = (torch.equal(got[1], w[1])
                          and torch.equal(got[0].view(torch.int32), w[0].view(torch.int32)))
                else:
                    ok = torch.equal(got[0], w)
                if not ok:
                    raise SystemExit(f"{name} {kind}: differs from the plain version")
                warm.append(replay(launch, False, flush))
                cold.append(replay(launch, True, flush))
            row[kind] = {"replay_ms": [x["us"] / 1e3 for x in warm],
                         "replay_min_ms": [x["us_min"] / 1e3 for x in warm],
                         "replay_max_ms": [x["us_max"] / 1e3 for x in warm],
                         "cold_ms": [x["us"] / 1e3 for x in cold]}
        each, busy = in_pass(name)
        for kind in ("closest", "any"):
            row[kind]["in_pass_ms"] = each[kind]
            row[kind]["replay_total_ms"] = sum(row[kind]["replay_ms"])
            row[kind]["cold_total_ms"] = sum(row[kind]["cold_ms"])
            row[kind]["in_pass_total_ms"] = sum(each[kind])
        row["pass_busy_ms"] = busy

    results = []
    # the L2 window last: its persisting set-aside outlives its launches
    order = ["parent", "+sort", "+records", "+smem stack", "+while-while", "+persistent",
             "parent", "+while-while", "+L2 window"]
    for k, name in enumerate(order):
        row = {"kernel": name, "run": k, "card": torch.cuda.get_device_name(0), "nvidia_smi": smi}
        try:
            measure(name, row)
        except RuntimeError as e:  # a step the card refuses is recorded, not timed
            row["refused"] = str(e)
            log(f"{name}: refused ({e})")
            print(json.dumps(row), flush=True)
            results.append(row)
            continue
        results.append(row)
        log(f"{name}: K5a replay {row['closest']['replay_total_ms']:.2f} ms / in pass "
            f"{row['closest']['in_pass_total_ms']:.2f} ms; K5b replay "
            f"{row['any']['replay_total_ms']:.2f} / in pass {row['any']['in_pass_total_ms']:.2f}"
            f" ms (6 launches each); pass busy {row['pass_busy_ms']:.2f} ms; all launches "
            "bit-equal to plain")
        print(json.dumps(row), flush=True)
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
