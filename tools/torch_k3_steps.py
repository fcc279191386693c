#!/usr/bin/env python3
"""K3a / K3b (the megakernel and its replay gradient,
fermat_tpu_torch/ops/csrc/mega.cu) step by step on one CUDA card, at the
main path's inputs: the glossy CornellBox, 512x512, max_path_length=6, the
scene's lobes (chip_smoke.py phases 4b and 4c).

    python3 tools/torch_k3_steps.py --parent DIR [--timed NAME ...] [--alternate ROUNDS]
                                    [--out FILE]

DIR holds an unpacked checkout of an earlier commit (`git archive`): its
fermat_tpu_torch/ops/csrc/mega.cu is built as the parent kernel (the same C
signature). The design steps are built from this checkout's mega.cu, each
with the later steps taken out again, or a try this checkout left out put
in, by exact text edits of the source (the script stops if one no longer
applies). Each step is on top of the one before:

  parent           the parent commit's kernels
  +vertex steps    one thread per pixel (grid ceil(N/128)), the path run as a
                   loop of vertex steps; tables in dynamic shared memory at
                   the caps' size, staged with scalar loads, tests on the
                   53-float rows; K3b's U and G in shared memory, one column
                   per thread, over the scene's materials only
  +records         the triangle tests on 48-byte float4 records
  +scene tables    the tables' shared memory sized by the scene, staged with
                   16-byte loads
  +persistent      a grid of the blocks that fit on the card at once, each
                   lane taking its warp's next pixel when its path ends
  +shared terms    E(|wi.z|) and the lobe-selection probabilities computed
                   once a vertex, and K3b's d f / d diffuse taken from the
                   lobe values f was built from (without it, the BSDF
                   functions are the parent's, spliced in from DIR's mega.cu)
  +main switches   the kernels built with the main path's option switches as
                   constants, picked when the options match
  +sincosf         sincosf in place of the separate sinf and cosf calls (the
                   same bits): this checkout's kernels
Tries, each on top of this checkout's kernels (kept in the tree only if they
pay, and then they are no longer tries):
  +min blocks 5    __launch_bounds__(128, 5) on both kernels (96 registers)
  +unroll 2        the closest-hit loop over the triangles unrolled twice
  +path in shared memory  the path state (Path) in a shared-memory record per
                   thread instead of registers

For each: K3a at the 512x512 pass against the plain version (rays equal,
every radiance block within the image tolerance, hit flag equal on >= 99.9%)
and, bit for bit, against the parent's output; K3b on the same instance's
train-step adjoint against the plain version (within 1e-3 of max|g|), two
launches bit-equal (a step that fails is reported, not timed, and the
script exits non-zero). Then, for the steps named by --timed (default: all),
the device time per launch in replay (CUDA events around each of 20
back-to-back replays behind a spin kernel: median, min, max; cold with 128
MiB written before each replay), K3a's own time in one profiled mega pass
and K3a's and K3b's in one profiled replay train step (torch.profiler), with
the pass's and the step's device-busy time, the mega pass through
RenderingContext (ms/pass and Mrays/s, best of 3 batches of 8 passes) and the
replay train step (ms/step, best of 3: a mega pass, an MSE against zero,
K3b), with the port's wrappers bound to this build. Every build prints
ptxas's registers, stack frame and spill bytes for both kernels. The steps
run in the order parent, the steps, the tries, then parent and this
checkout's kernels again, so drift within the call shows. --alternate
ROUNDS then times the mega pass and the train step on the host's clock for
the parent and this checkout, ROUNDS each, in the order parent, this, this,
parent, ..., and prints each one's median and min-max. Prints one JSON line
per step and round; --out writes them all as one JSON file.
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
from torch_steps_common import FLUSH_BYTES, bind, build, edited, log, replay  # noqa: E402

RES, MPL, PASSES, REPS, INST = 512, 6, 8, 3, 3

# the exact text edits that take a step out of this checkout's mega.cu: (old, new, count)
NO_PERSIST = [
    ("  const unsigned lane = threadIdx.x & 31u;\n"
     "  const long long warps = static_cast<long long>(gridDim.x) * (kBlock / 32);\n"
     "  const long long warp = static_cast<long long>(blockIdx.x) * (kBlock / 32) + (threadIdx.x >> 5);\n"
     "  Path ps;\n"
     "  bool live = false;\n"
     "  long long next = 0;  // the warp's next j\n"
     "  for (;;) {\n"
     "    const unsigned idle = __ballot_sync(0xffffffffu, !live);\n"
     "    if (!live) {\n"
     "      const long long j = next + __popc(idle & ((1u << lane) - 1u));\n"
     "      const long long pix = ((j >> 5) * warps + warp) * 32 + (j & 31);\n"
     "      if (pix < sc.n) {\n"
     "        begin_path<kGrad>(s, sc, static_cast<uint32_t>(pix), adjoint, U, ps);\n"
     "        live = true;\n"
     "      }\n"
     "    }\n"
     "    next += __popc(idle);\n"
     "    if (!__any_sync(0xffffffffu, live)) return;\n"
     "    if (live && step_path<kGrad>(s, sc, ps, out, U, G)) {\n"
     "      if (!kGrad) put_radiance(out, sc.n, ps);\n"
     "      live = false;\n"
     "    }\n"
     "  }\n",
     "  const long long pix = static_cast<long long>(blockIdx.x) * kBlock + threadIdx.x;\n"
     "  if (pix >= sc.n) return;\n"
     "  Path ps;\n"
     "  begin_path<kGrad>(s, sc, static_cast<uint32_t>(pix), adjoint, U, ps);\n"
     "  while (!step_path<kGrad>(s, sc, ps, out, U, G)) {\n"
     "  }\n"
     "  if (!kGrad) put_radiance(out, sc.n, ps);\n", 1),
    ("  *grid = want < fit ? want : fit;\n", "  *grid = want;\n", 1),
]
CAP_TABLES = [
    ("  l.tri = l.rec + 12 * n_tris;\n"
     "  l.mat = l.tri + up4(n_tris * kTriCols);\n"
     "  l.light = l.mat + up4(n_mats * kMatCols);\n"
     "  l.cam = l.light + up4(n_lights * kLightCols);\n",
     "  l.tri = l.rec + 12 * kTriMax;\n"
     "  l.mat = l.tri + up4(kTriMax * kTriCols);\n"
     "  l.light = l.mat + up4(kMatMax * kMatCols);\n"
     "  l.cam = l.light + up4(kLightMax * kLightCols);\n", 1),
    ("  if ((reinterpret_cast<uintptr_t>(src) & 15u) == 0u) {\n", "  if (false) {\n", 1),
]
ROW_TESTS = [
    ("__device__ __forceinline__ bool mt_inside(const float4* rec, V3 o, V3 d, float* t, float* u,\n"
     "                                          float* v) {\n"
     "  const float4 ra = rec[0], rb = rec[1], rc = rec[2];\n"
     "  const float p0x = ra.x, p0y = ra.y, p0z = ra.z;\n"
     "  const float e1x = rb.x, e1y = rb.y, e1z = rb.z;\n"
     "  const float e2x = rc.x, e2y = rc.y, e2z = rc.z;\n",
     "__device__ __forceinline__ bool mt_inside(const float* row, V3 o, V3 d, float* t, float* u,\n"
     "                                          float* v) {\n"
     "  const float p0x = row[0], p0y = row[1], p0z = row[2];\n"
     "  const float e1x = row[3], e1y = row[4], e1z = row[5];\n"
     "  const float e2x = row[6], e2y = row[7], e2z = row[8];\n", 1),
    ("mt_inside(&s.rec[3 * k], ", "mt_inside(&s.tri[k * kTriCols], ", 2),
]
# the call sites of the shared shading terms, as this checkout has them and
# as they are with the parent's BSDF functions
SHARED_CALLS = [
    ("  const V3 emissive = load3(mrow, 6);\n  const Vtx vt = vertex_terms(p, wi_loc, o);\n",
     "  const V3 emissive = load3(mrow, 6);\n", 1),
    ("    Lobes lv;\n    f_split(p, vt, wi_loc, wo_loc, o, &fd, &fg, &bsdf_pdf, &lv);\n",
     "    f_split(p, wi_loc, wo_loc, o, &fd, &fg, &bsdf_pdf);\n", 1),
    ("diffuse_refl_unit(p, wi_loc, o, lv);", "diffuse_refl_unit(p, wi_loc, wo_loc, o);", 1),
    ("bsdf_sample(p, vt, wi_loc, ub0, ub1, ub2, o);", "bsdf_sample(p, wi_loc, ub0, ub1, ub2, o);", 1),
    ("diffuse_refl_unit(p, wi_loc, o, smp.l);", "diffuse_refl_unit(p, wi_loc, smp.wo, o);", 1),
]
BSDF_FROM, BSDF_TO = "struct Weights {\n", "// " + "-" * 64 + " trace ----"


def unshared(src: str, parent: str) -> str:
    """src with the parent's BSDF functions (from struct Weights to the
    trace section) and the call sites that go with them."""
    a, b = src.index(BSDF_FROM), src.index(BSDF_TO)
    pa, pb = parent.index(BSDF_FROM), parent.index(BSDF_TO)
    return edited(src[:a] + parent[pa:pb] + src[b:], SHARED_CALLS, "mega.cu")


NO_SINCOS = [
    ("  float sin_phi, cos_phi;\n  sincosf(phi, &sin_phi, &cos_phi);\n"
     "  const float p1 = r * cos_phi;\n  float p2 = r * sin_phi;\n",
     "  const float p1 = r * cosf(phi);\n  float p2 = r * sinf(phi);\n", 1),
    ("  float sin_phi, cos_phi;\n  sincosf(phi, &sin_phi, &cos_phi);\n"
     "  const V3 d_loc{r * cos_phi, r * sin_phi, sqrtf(clamp_min(1.0f - u0, 0.0f))};\n",
     "  const V3 d_loc{r * cosf(phi), r * sinf(phi), sqrtf(clamp_min(1.0f - u0, 0.0f))};\n", 1),
]
# the launch's choice of the kernels built with the main path's switches as constants
NO_SWITCHES = [("main_switches(sc.o) ?", "false ?", 2)]


# the path state in static shared memory, one 27-word record a thread (odd
# stride: no bank conflicts), instead of registers
PATH_SMEM = [
    ("  int channel, b;\n  uint32_t pix;\n};\n", "  int channel, b;\n  uint32_t pix;\n  int pad;\n};\n", 1),
    ("  Path ps;\n  bool live = false;\n",
     "  __shared__ Path paths[kBlock];\n  Path& ps = paths[threadIdx.x];\n  bool live = false;\n", 1),
]


UNROLL_2 = [("  float tb = kBig, ub = 0.0f, vb = 0.0f;\n  for (int k = 0; k < sc.n_tris; ++k) {\n",
             "  float tb = kBig, ub = 0.0f, vb = 0.0f;\n#pragma unroll 2\n"
             "  for (int k = 0; k < sc.n_tris; ++k) {\n", 1)]
MIN_BLOCKS_5 = [("__global__ void __launch_bounds__(kBlock)\n",
                 "__global__ void __launch_bounds__(kBlock, 5)\n", 2)]


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="an unpacked checkout of the commit whose K3 is the parent")
    ap.add_argument("--timed", nargs="*", default=None,
                    help="time only these steps (all are built and checked)")
    ap.add_argument("--alternate", type=int, default=0, metavar="ROUNDS",
                    help="then time the parent and this checkout end to end, alternating")
    ap.add_argument("--out", type=Path, default=None)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_k3_steps: no CUDA card", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from fermat_tpu_torch.integrators import pt
    from fermat_tpu_torch.ops import _cuda
    from fermat_tpu_torch.ops import pt_mega
    from fermat_tpu_torch.render.context import RenderingContext
    from fermat_tpu_torch.scene.procedural import cornell_box, cornell_camera

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    log(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    here = (ROOT / "fermat_tpu_torch" / "ops" / "csrc" / "mega.cu").read_text()
    there = (a.parent / "fermat_tpu_torch" / "ops" / "csrc" / "mega.cu").read_text()
    sin_cos = edited(here, NO_SINCOS, "mega.cu")
    runtime = edited(sin_cos, NO_SWITCHES, "mega.cu")
    before = unshared(runtime, there)
    steps = {
        "parent": there,
        "+vertex steps": edited(before, NO_PERSIST + CAP_TABLES + ROW_TESTS, "mega.cu"),
        "+records": edited(before, NO_PERSIST + CAP_TABLES, "mega.cu"),
        "+scene tables": edited(before, NO_PERSIST, "mega.cu"),
        "+persistent": before,
        "+shared terms": runtime,
        "+main switches": sin_cos,
        "+sincosf": here,
        "+min blocks 5": edited(here, MIN_BLOCKS_5, "mega.cu"),
        "+unroll 2": edited(here, UNROLL_2, "mega.cu"),
        "+path in shared memory": edited(here, PATH_SMEM, "mega.cu"),
    }
    built = build({k: ("mega.cu", v) for k, v in steps.items()}, _cuda.BUILD_DIR / "k3_steps",
                  ("mega_forward_kernel", "mega_grad_kernel"))
    failed = [k for k, (so, _, _) in built.items() if so is None]
    if failed:
        raise SystemExit(f"nvcc failed for {failed}")
    libs = {k: bind(so, [pt_mega.FORWARD, pt_mega.GRAD]) for k, (so, _, _) in built.items()}

    ctx = RenderingContext.create(cornell_box(glossy_boxes=True), cornell_camera(), RES, RES,
                                  renderer="pt", max_path_length=MPL, tracer="mega")
    opts = pt.PTOptions(**ctx.renderer_options)
    if not pt_mega.main_switches(opts):
        raise SystemExit(f"the main path's options {pt_mega._opt_vector(opts)} no longer take "
                         "the kernels built with mega.cu's MEGA_MAIN_SWITCHES")
    tb = pt_mega.build_mega_tables(ctx.view, RES, RES, opts.ray_eps)
    n = RES * RES
    ref = pt_mega._mega_plain(tb, opts, RES, n, INST, 0)
    comp = (ref[0:3] + ref[3:6] + ref[6:9]).t().contiguous()
    adjoint = 2.0 * comp / (n * 3)  # the train step's adjoint: MSE against zero
    g_ref = pt_mega._mega_grad_plain(tb, opts, RES, n, INST, 0, adjoint)
    torch.cuda.synchronize()
    g_scale = float(g_ref.abs().max())
    log(f"plain versions done: rays {float(ref[26].sum()):.0f}, max|g| {g_scale:.5g}")

    def use(name):
        for kern, (fn, err) in zip((pt_mega.FORWARD, pt_mega.GRAD), libs[name]):
            kern._fn, kern._err = fn, err

    flush = torch.empty(FLUSH_BYTES // 4, device=dev)

    def image_ok(got, want):
        near = torch.isclose(got, want, atol=1e-4, rtol=1e-3).all(dim=0).float().mean()
        gm, wm = got.mean(dim=1), want.mean(dim=1)
        mean_rel = ((gm - wm).abs() / wm.abs().clamp_min(1e-7)).max()
        return bool(near >= 0.99) and bool(mean_rel <= 1e-3), float(near)

    parent_out = {}

    def check(name, row):
        use(name)
        out = pt_mega._mega_forward(tb, opts, RES, n, INST, 0)
        g1 = pt_mega._mega_grad(tb, opts, RES, n, INST, 0, adjoint)
        g2 = pt_mega._mega_grad(tb, opts, RES, n, INST, 0, adjoint)
        torch.cuda.synchronize()
        bad = []
        if float(out[26].sum()) != float(ref[26].sum()):
            bad.append(f"rays {float(out[26].sum())} vs plain {float(ref[26].sum())}")
        near = []
        for k in range(0, 9, 3):
            ok, fr = image_ok(out[k:k + 3], ref[k:k + 3])
            near.append(fr)
            if not ok:
                bad.append(f"radiance block {k // 3} differs ({fr})")
        hit_eq = float((out[10] == ref[10]).float().mean())
        if hit_eq < 0.999:
            bad.append(f"hit flag equal on {hit_eq}")
        g_err = float((g1 - g_ref).abs().max())
        if not g_err <= 1e-3 * g_scale:
            bad.append(f"gradient off by {g_err / g_scale:.3g} of max|g|")
        same = torch.equal(g1.view(torch.int32), g2.view(torch.int32))
        if not same:
            bad.append("two K3b launches differ")
        bits = out.view(torch.int32)
        if name == "parent":
            parent_out.setdefault("out", bits.clone())
            parent_out.setdefault("g", g1.clone())
        p_bits = parent_out["out"]
        row.update(
            k3a_rays=float(out[26].sum()), k3a_near=near, k3a_hit_equal=hit_eq,
            k3a_pixels_bit_equal_plain=float((bits == ref.view(torch.int32)).all(0).float().mean()),
            k3a_pixels_bit_equal_parent=float((bits == p_bits).all(0).float().mean()),
            k3b_err_vs_plain=g_err / g_scale, k3b_two_launches_bit_equal=same,
            k3b_err_vs_parent=float((g1 - parent_out["g"]).abs().max()) / g_scale)
        row["failed"] = bad

    target = torch.zeros((n, 3), device=dev)

    def train_step(inst):
        out = pt_mega.render_pass_mega(ctx.view, opts, RES, RES, inst, 0, tables=tb)
        img = out.composited.stack()
        adj = 2.0 * (img - target) / (img.shape[0] * 3)
        return out.rays, pt_mega.render_grad_diffuse_mega(ctx.view, opts, RES, RES, inst, adj,
                                                          0, tables=tb)

    def profiled(fn):
        """Device µs of one profiled call of fn (after one warm-up call): all
        its kernels (busy), K3a's and K3b's."""
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        us = {"busy": 0.0, "k3a": 0.0, "k3b": 0.0}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                us["busy"] += e.self_device_time_total
                for key, kern in (("k3a", "mega_forward_kernel"), ("k3b", "mega_grad_kernel")):
                    if kern in e.name:
                        us[key] += e.self_device_time_total
        return us

    def host_times(row):
        """The mega pass through RenderingContext (best of REPS batches of
        PASSES passes) and the replay train step (best of REPS), on the host's
        clock, into row."""
        ctx.restart()
        ctx.render_batch(1)  # warm-up
        best, best_rays = float("inf"), 0.0
        for _ in range(REPS):
            rays0 = float(ctx.stats["rays"])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ctx.render_batch(PASSES)
            dt = time.perf_counter() - t0
            if dt < best:
                best, best_rays = dt, float(ctx.stats["rays"]) - rays0
        row["mega_ms_per_pass"] = best / PASSES * 1e3
        row["mega_mrays_per_s"] = best_rays / best / 1e6
        train_step(0)
        torch.cuda.synchronize()
        best, best_rays = float("inf"), 0.0
        for rep in range(REPS):
            t0 = time.perf_counter()
            rays_v, _ = train_step(rep + 1)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if dt < best:
                best, best_rays = dt, float(rays_v)
        row["train_ms_per_step"] = best * 1e3
        row["train_mrays_per_s"] = best_rays / best / 1e6

    def timing(name, row):
        use(name)
        f_fwd = lambda: pt_mega._mega_forward(tb, opts, RES, n, INST, 0)
        f_grad = lambda: pt_mega._mega_grad(tb, opts, RES, n, INST, 0, adjoint)
        for key, fn in (("k3a", f_fwd), ("k3b", f_grad)):
            row[key] = {"warm": replay(fn, False, flush), "cold": replay(fn, True, flush)}
        ctx.restart()
        in_pass = profiled(lambda: ctx.render_batch(1))
        in_step = profiled(lambda: train_step(0))
        row["k3a"]["in_pass_us"] = in_pass["k3a"]
        row["k3a"]["in_step_us"] = in_step["k3a"]
        row["k3b"]["in_step_us"] = in_step["k3b"]
        row["mega_pass_busy_us"] = in_pass["busy"]
        row["train_step_busy_us"] = in_step["busy"]
        host_times(row)

    timed = set(steps) if a.timed is None else set(a.timed)
    order = [*steps, "parent", "+sincosf"]
    results = []
    for k, name in enumerate(order):
        row = {"step": name, "run": k, "card": torch.cuda.get_device_name(0), "nvidia_smi": smi,
               "ptxas": built[name][1]}
        check(name, row)
        if row["failed"]:  # recorded, not timed; the script exits non-zero
            log(f"{name}: FAILED: " + "; ".join(row["failed"]))
            print(json.dumps(row), flush=True)
            results.append(row)
            continue
        msg = (f"{name}: rays equal to plain; radiance close {min(row['k3a_near']):.4f}; pixels "
               f"bit-equal to plain {row['k3a_pixels_bit_equal_plain']:.4f}, to the parent "
               f"{row['k3a_pixels_bit_equal_parent']:.4f}; K3b {row['k3b_err_vs_plain']:.2e} of "
               f"max|g| from plain, {row['k3b_err_vs_parent']:.2e} from the parent, two launches "
               f"bit-equal")
        if name in timed:
            timing(name, row)
            msg += (f"; K3a {row['k3a']['warm']['us']:.2f} us ({row['k3a']['warm']['us_min']:.2f}-"
                    f"{row['k3a']['warm']['us_max']:.2f}; cold {row['k3a']['cold']['us']:.2f}), "
                    f"{row['k3a']['in_pass_us']:.2f} in the pass; K3b {row['k3b']['warm']['us']:.2f} "
                    f"us ({row['k3b']['warm']['us_min']:.2f}-{row['k3b']['warm']['us_max']:.2f}; "
                    f"cold {row['k3b']['cold']['us']:.2f}), {row['k3b']['in_step_us']:.2f} in the "
                    f"step; mega pass {row['mega_ms_per_pass']:.3f} ms, "
                    f"{row['mega_mrays_per_s']:.2f} Mrays/s, busy {row['mega_pass_busy_us']:.1f} "
                    f"us; train step {row['train_ms_per_step']:.3f} ms, "
                    f"{row['train_mrays_per_s']:.2f} Mrays/s, busy "
                    f"{row['train_step_busy_us']:.1f} us")
        log(msg)
        print(json.dumps(row), flush=True)
        results.append(row)
    # the parent and this checkout, end to end on the host's clock, in
    # alternating order (parent, this, this, parent, ...)
    host = {"parent": [], "+sincosf": []}
    for k in range(a.alternate):
        for name in (("parent", "+sincosf") if k % 2 == 0 else ("+sincosf", "parent")):
            use(name)
            row = {"step": name, "alternate_round": k}
            host_times(row)
            host[name].append(row)
            print(json.dumps(row), flush=True)
            results.append(row)
    for name, rows in host.items():
        if rows:
            mega = [r["mega_ms_per_pass"] for r in rows]
            train = [r["train_ms_per_step"] for r in rows]
            log(f"alternating, {name}: mega pass {statistics.median(mega):.3f} ms "
                f"({min(mega):.3f}-{max(mega):.3f}), train step {statistics.median(train):.3f} "
                f"ms ({min(train):.3f}-{max(train):.3f}) over {len(rows)} rounds")
    if a.out is not None:
        a.out.parent.mkdir(parents=True, exist_ok=True)
        a.out.write_text(json.dumps(results, indent=1))
    return 1 if any(r.get("failed") for r in results) else 0


if __name__ == "__main__":
    sys.exit(main())
