"""K7 (the binned tracer, ops/binned_trace.py over csrc/binned.cu) on the
card: the design's choices measured at the main path's inputs.

It records the 6 closest and 6 occlusion calls of one big_room(8300)
1600x896 pass with tracer="binned" (6 bounces, the scene's lobes), holds
every call of every configuration bit-equal to the plain versions
(`_closest_uv_plain`, `_any_plain`), and for each configuration of the
module constants (QUEUE keys a scan, BLOCK rays a work item, ROUND_BATCH
rounds a readback) times each call: the device work (the sum of its
kernels under torch.profiler, median of 3 calls), its wall time (host
clock around a synced call, median of 3) and its split at the C calls
that enqueue the rounds, the rounds that tested rays, the host readbacks
and the full scans per visit. A queue depth other than the module's 1 and
8 is timed on a build of its own (an edited copy of binned.cu, bound in
place of the module's library for that configuration). With --parent DIR
(an unpacked `git archive` of another commit, in a directory of the repo
that .gitignore lists) the same pass's calls are also timed with DIR's
binned tracer and with this checkout's, each in a process of its own, in
the order parent, this, this, parent (with several DIRs: each, then this
twice, then each in reverse).

    python3 tools/torch_k7_steps.py [--configs Q:B[:R] ...] [--parent DIR ...] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

from torch_steps_common import bind, build, edited, log, patch  # noqa: E402

W, H, MPL, BOXES, INSTANCE = 1600, 896, 6, 8300, 2000

# Run in a process of its own from a checkout's root: records one binned
# pass's tracer calls and times each with that checkout's wrappers.
TIMING = r"""
import contextlib, json, statistics, sys, time
sys.path.insert(0, ".")
import torch
from torch.profiler import ProfilerActivity, profile
from fermat_tpu_torch.integrators import pt
from fermat_tpu_torch.render.context import RenderingContext
from fermat_tpu_torch.scene.procedural import big_room, big_room_camera
W, H, MPL, BOXES, INSTANCE = %d, %d, %d, %d, %d
ctx = RenderingContext.create(big_room(BOXES), big_room_camera(), W, H, renderer="pt",
                              max_path_length=MPL, tracer="binned")
ctx.render(1)
calls = {"closest": [], "any": []}

@contextlib.contextmanager
def recording(kind):
    name = f"trace_{kind}_binned"
    fn = getattr(pt, name)
    def wrapper(*args):
        calls[kind].append((fn, args))
        return fn(*args)
    setattr(pt, name, wrapper)
    try:
        yield
    finally:
        setattr(pt, name, fn)

with torch.no_grad(), recording("closest"), recording("any"):
    pt.render_pass(ctx.view, pt.PTOptions(**ctx.renderer_options), W, H, INSTANCE, 0)
torch.cuda.synchronize()
out = {}
for kind, lst in calls.items():
    dev_ms, wall_ms = [], []
    for fn, args in lst:
        fn(*args)
        torch.cuda.synchronize()
        d, w = [], []
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn(*args)
                torch.cuda.synchronize()
            d.append(sum(e.duration_ns() / 1e6 for e in prof.profiler.kineto_results.events()
                         if e.device_type() == torch.autograd.DeviceType.CUDA))
            t0 = time.perf_counter()
            fn(*args)
            torch.cuda.synchronize()
            w.append((time.perf_counter() - t0) * 1e3)
        dev_ms.append(statistics.median(d))
        wall_ms.append(statistics.median(w))
    out[kind] = dict(device_ms=dev_ms, wall_ms=wall_ms)
print("TIMING " + json.dumps(out), flush=True)
"""


def device_kernels(prof) -> list:
    """[(name, start ms, duration ms)] of the device records of a profile."""
    import torch

    return sorted(((e.name(), e.start_ns() / 1e6, e.duration_ns() / 1e6)
                   for e in prof.profiler.kineto_results.events()
                   if e.device_type() == torch.autograd.DeviceType.CUDA), key=lambda r: r[1])


def queue_variant(src: str, q: int) -> str:
    """binned.cu built for a queue of q keys in place of 8."""
    return edited(src, [
        ("binned_scan_kernel<kClosest, 8><<<", f"binned_scan_kernel<kClosest, {q}><<<"),
        (": binned_scan_kernel<kClosest, 8>);", f": binned_scan_kernel<kClosest, {q}>);"),
        ("(k == 1 || k == 8)", f"(k == 1 || k == {q})")], f"binned.cu (queue {q})")


def per_round(recs: list) -> list:
    """[[scan, counting sort, test] µs] of each round of one call's records."""
    from fermat_tpu_torch.ops.binned_trace import kernel_family

    rounds = []
    for name, _, ms in recs:
        fam = kernel_family(name)
        if fam == "scan":
            rounds.append([0.0, 0.0, 0.0])
        if rounds and fam != "other":
            rounds[-1][("scan", "bin", "test").index(fam)] += ms * 1e3
    return rounds


def anatomy(f, kind: str) -> dict:
    """A call's wall time split at the binned runner's C calls (median ms of
    3): the host's work before the first, the C calls (each enqueues a batch
    of rounds), the waits from each call's return to the end of its batch's
    readback, and the host's work between a readback and the next call or,
    after the last, to the call's return."""
    import torch

    from fermat_tpu_torch.ops import binned_trace as bt

    kern = bt.CLOSEST if kind == "closest" else bt.ANY
    marks = []
    launch, tolist = kern.launch, torch.Tensor.tolist

    def timed_launch(*a, **kw):
        marks.append(("call", time.perf_counter()))
        launch(*a, **kw)
        marks.append(("wait", time.perf_counter()))

    def timed_tolist(t):
        out = tolist(t)
        marks.append(("host", time.perf_counter()))
        return out

    parts = []
    for _ in range(3):
        torch.cuda.synchronize()
        marks.clear()
        with patch([(kern, "launch", timed_launch), (torch.Tensor, "tolist", timed_tolist)]):
            t0 = time.perf_counter()
            f()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
        split = dict(before=marks[0][1] - t0, call=0.0, wait=0.0, host=0.0)
        for (what, at), (_, end) in zip(marks, marks[1:] + [("end", t1)]):
            split[what] += end - at
        parts.append(split)
    out = {k: 1e3 * statistics.median(p[k] for p in parts) for k in parts[0]}
    return {**out, **prologue(f, kind)}


def prologue(f, kind: str) -> dict:
    """Host ms of the wrapper's steps before its first C call, each alone
    (mean of 20): its lanes, the runner (the table's and rays' checks, the
    boxes' concatenation) and the loop's state."""
    import torch

    from fermat_tpu_torch.ops import binned_trace as bt
    from fermat_tpu_torch.ops import trace as trace_mod

    seen = {}
    real = bt._rounds

    def grab(cl, rays, active, closest, run):
        seen.update(cl=cl, rays=rays, active=active)
        return real(cl, rays, active, closest, run)

    with patch([(bt, "_rounds", grab)]):
        f()
    cl, rays, active = seen["cl"], seen["rays"], seen["active"]
    steps = {"lanes": lambda: trace_mod._lane_args(rays.o, rays.tmin, rays.tmax, active),
             "runner": lambda: bt._kernel_run(cl, rays, active, kind == "closest"),
             "state": lambda: bt._new_loop(rays.tmax.shape[0], cl.rows.shape[0],
                                           kind == "closest", rays.tmax.device)}
    out = {}
    for name, step in steps.items():
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(20):
            step()
        out[f"prologue_{name}"] = (time.perf_counter() - t0) / 20 * 1e3
        torch.cuda.synchronize()
    return out


def time_checkout(where: Path) -> dict:
    """TIMING run from `where` in a process of its own."""
    res = subprocess.run([sys.executable, "-c", TIMING % (W, H, MPL, BOXES, INSTANCE)],
                         cwd=where, capture_output=True, text=True, timeout=900)
    line = next((ln for ln in res.stdout.splitlines() if ln.startswith("TIMING ")), None)
    if res.returncode != 0 or line is None:
        raise SystemExit(f"timing in {where} failed ({res.returncode}):\n{res.stderr[-3000:]}")
    return json.loads(line[len("TIMING "):])


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--configs", nargs="*", default=["8:128", "4:128", "16:128", "8:64", "8:256"],
                    help="QUEUE:BLOCK[:ROUND_BATCH] to time (the first is the module's)")
    ap.add_argument("--trace", type=Path, default=None,
                    help="write a chrome trace (host and device) of the second closest call "
                         "with the first configuration")
    ap.add_argument("--parent", type=Path, nargs="+", default=None,
                    help="checkouts to time beside this one: p1 .. pn, this, this, pn .. p1")
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from fermat_tpu_torch.integrators import pt
    from fermat_tpu_torch.ops import binned_trace as bt
    from fermat_tpu_torch.ops import frontier_trace as ft
    from fermat_tpu_torch.ops import trace as trace_mod
    from fermat_tpu_torch.render.context import RenderingContext
    from fermat_tpu_torch.scene.procedural import big_room, big_room_camera

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    log(f"card: {smi}")
    csrc = ROOT / "fermat_tpu_torch" / "ops" / "csrc"
    src = (csrc / "binned.cu").read_text()
    queues = sorted({int(c.split(":")[0]) for c in args.configs} - {1, 8})
    built = build({"binned": ("binned.cu", src),
                   **{f"queue{q}": ("binned.cu", queue_variant(src, q)) for q in queues}},
                  ROOT / "_scratch" / "k7_build",
                  ("binned_scan_kernel", "binned_offsets_kernel", "binned_scatter_kernel",
                   "binned_test_kernel"), headers=(str(csrc / "cluster_common.cuh"),))
    if any(so is None for so, _, _ in built.values()):
        raise SystemExit("a build failed")
    regs = {key: info for key, (_, info, _) in built.items()}
    bt.CLOSEST._bind()
    bt.ANY._bind()
    libs = {}  # a queue variant's entry points, typed as the wrappers type theirs
    for q in queues:
        (fc, ec), (fa, ea) = bind(built[f"queue{q}"][0], [bt.CLOSEST, bt.ANY])
        libs[q] = [(bt.CLOSEST, "_fn", fc), (bt.CLOSEST, "_err", ec), (bt.ANY, "_fn", fa),
                   (bt.ANY, "_err", ea)]

    ctx = RenderingContext.create(big_room(BOXES), big_room_camera(), W, H, renderer="pt",
                                  max_path_length=MPL, tracer="binned")
    ctx.render(1)
    calls = {"closest": [], "any": []}

    def rec(kind, fn):
        def wrapper(*a, **kw):
            calls[kind].append(a)
            return fn(*a, **kw)
        return wrapper

    with torch.no_grad(), patch([(pt, "trace_closest_binned",
                                  rec("closest", pt.trace_closest_binned)),
                                 (pt, "trace_any_binned", rec("any", pt.trace_any_binned))]):
        pt.render_pass(ctx.view, pt.PTOptions(**ctx.renderer_options), W, H, INSTANCE, 0)
    torch.cuda.synchronize()
    log(f"recorded {len(calls['closest'])} closest and {len(calls['any'])} occlusion calls")

    plain = {"closest": [], "any": []}
    for kind, lst in calls.items():
        for cl, o, d, tmin, tmax, active in lst:
            t0, t1, act = trace_mod._lane_args(o, tmin, tmax, active)
            plain[kind].append(ft._closest_uv_plain(cl, o, d, t0, t1, act) if kind == "closest"
                               else ft._any_plain(cl, o, d, t0, t1, act))
    torch.cuda.synchronize()
    log("plain answers made")

    fns = {"closest": bt.trace_closest_binned, "any": bt.trace_any_binned}
    bits = lambda t: t.view(torch.int32) if t.is_floating_point() else t
    report = {"card": smi, "ptxas": regs, "configs": {}}
    for cfg in args.configs:
        q, b, *rb = (int(x) for x in cfg.split(":"))
        with patch([(bt, "QUEUE", q), (bt, "BLOCK", b),
                    (bt, "ROUND_BATCH", rb[0] if rb else bt.ROUND_BATCH), *libs.get(q, [])]):
            if args.trace is not None and cfg == args.configs[0]:
                a = calls["closest"][1]
                fns["closest"](*a)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    fns["closest"](*a)
                    torch.cuda.synchronize()
                args.trace.parent.mkdir(parents=True, exist_ok=True)
                prof.export_chrome_trace(str(args.trace))
                log(f"wrote {args.trace}")
            per = {}
            for kind, lst in calls.items():
                rows = []
                for a, want in zip(lst, plain[kind]):
                    f = lambda: fns[kind](*a)
                    bt.LOOP.reset()
                    got = f()
                    torch.cuda.synchronize()
                    loop = dict(vars(bt.LOOP))
                    same = (all(torch.equal(bits(x), bits(y)) for x, y in zip(got, want))
                            if kind == "closest" else torch.equal(got, want))
                    if not same:
                        raise SystemExit(f"{cfg}: {kind} differs from plain")
                    d, w, recs = [], [], []
                    for _ in range(3):
                        with profile(activities=[ProfilerActivity.CUDA]) as prof:
                            f()
                            torch.cuda.synchronize()
                        recs = device_kernels(prof)
                        d.append(sum(r[2] for r in recs))
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        f()
                        torch.cuda.synchronize()
                        w.append((time.perf_counter() - t0) * 1e3)
                    fam = {}
                    for name, _, ms in recs:
                        f_name = bt.kernel_family(name)
                        fam[f_name] = fam.get(f_name, 0.0) + ms
                    span = (max(r[1] + r[2] for r in recs) - min(r[1] for r in recs)
                            if recs else 0.0)
                    rows.append(dict(device_ms=statistics.median(d), wall_ms=statistics.median(w),
                                     rounds=loop["rounds"], readbacks=loop["readbacks"],
                                     scans=loop["scans"], visits=loop["pairs"], split=fam,
                                     kernels=len(recs), span_ms=span,
                                     per_round=per_round(recs), anatomy=anatomy(f, kind)))
                per[kind] = rows
                log(f"QUEUE:BLOCK[:ROUND_BATCH] {cfg} {kind}: bit-equal to plain; device ms "
                    + ", ".join(f"{r['device_ms']:.2f}" for r in rows) + "; wall ms "
                    + ", ".join(f"{r['wall_ms']:.2f}" for r in rows) + "; rounds "
                    + ", ".join(str(r["rounds"]) for r in rows) + "; readbacks "
                    + ", ".join(str(r["readbacks"]) for r in rows) + "; scans/visit "
                    + ", ".join(f"{r['scans'] / max(r['visits'], 1):.3f}" for r in rows)
                    + f"; sums: device {sum(r['device_ms'] for r in rows):.2f} ms, wall "
                    f"{sum(r['wall_ms'] for r in rows):.2f} ms, first kernel to last end "
                    f"{sum(r['span_ms'] for r in rows):.2f} ms; by family "
                    + ", ".join(f"{k} {sum(r['split'].get(k, 0.0) for r in rows):.2f}"
                                for k in ("scan", "bin", "test", "other"))
                    + f" ms; {sum(r['kernels'] for r in rows)} device kernels; wall split (host "
                    "before the first C call, the C calls, from their returns to the ends of "
                    "their readbacks, the host between and after): "
                    + ", ".join(f"{sum(r['anatomy'][k] for r in rows):.2f}"
                                for k in ("before", "call", "wait", "host")) + " ms; before "
                    "the first C call, each alone: lanes, runner, state "
                    + ", ".join(f"{sum(r['anatomy'][f'prologue_{k}'] for r in rows):.2f}"
                                for k in ("lanes", "runner", "state")) + " ms")
                if cfg == args.configs[0]:
                    for i, r in enumerate(rows):
                        log(f"  {kind} call {i}: us a round (scan, counting sort, test): "
                            + " | ".join(",".join(f"{x:.0f}" for x in rd)
                                         for rd in r["per_round"]))
            report["configs"][cfg] = per
    if args.parent is not None:
        report["alternation"] = []
        order = [*map(str, args.parent), "this", "this", *map(str, args.parent[::-1])]
        for who in order:
            t = time_checkout(ROOT if who == "this" else Path(who).resolve())
            report["alternation"].append({who: t})
            log(f"{who}: " + "; ".join(
                f"{k} device {sum(v['device_ms']):.2f} ms, wall {sum(v['wall_ms']):.2f} ms "
                f"over {len(v['wall_ms'])} calls" for k, v in t.items()))
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(report, indent=1))
    print(json.dumps({k: v for k, v in report.items() if k != "configs"}))
    return 0


if __name__ == "__main__":
    os.environ.setdefault("PYTHONUNBUFFERED", "1")
    sys.exit(main())
