"""Profiling on torch.profiler (fermat_tpu/utils/profiling.py).

  * `capture_trace`: a callable run under torch.profiler after one warm-up
    call, its Chrome trace written to a directory;
  * `op_breakdown`: (op name, total ms, count) from the Chrome traces under
    a directory, and `print_op_breakdown`, which prints them (the
    reference's print_timer_stats);
  * `stage_split`: one call's time split into the three stage families of
    the reference's dump_speed_stats: rt_ms (closest tracers), shadow_rt_ms
    (any-hit tracers) and shade_ms (the rest), what
    RenderingContext.dump_speed_stats(detailed=True) reports.

On the card `stage_split` buckets the device kernels by the port's own
names: the dense, frontier, cluster, binned, subcluster and BVH tracer
kernels by their closest or any-hit instantiation, every other kernel
(gathers, the sort key and sorts, elementwise shading) to shade. On the CPU
the plain versions' aten ops carry no tracer's name, so the tracer
functions the passes look up in integrators/pt are wrapped in
record_function ranges for the call, and shade_ms is the call's wall time
less the two tracer ranges. CUPTI loses device records now and then (one
profiled pass in about forty): these are a profile, not a gate.
"""
from __future__ import annotations

import collections
import contextlib
import glob
import gzip
import json
import os
import time
from typing import Callable, Dict, List, Tuple

import torch

# the tracer entry points of integrators/pt, by stage
_CLOSEST = ("trace_closest", "trace_closest_frontier", "trace_closest_cluster",
            "trace_closest_binned", "trace_closest_bvh")
_ANY = ("trace_any", "trace_any_frontier", "trace_any_cluster", "trace_any_binned",
        "trace_any_bvh")
_RANGE = {"rt_ms": "fermat::closest", "shadow_rt_ms": "fermat::any"}
# device kernels templated on closest (true) or any-hit (false)
_BY_FLAG = ("trace_kernel<", "cluster_kernel<", "sub_kernel<", "scan_kernel<", "test_kernel<")


def capture_trace(fn: Callable, out_dir: str, n_runs: int = 3):
    """Run fn() once, then n_runs times under torch.profiler, and write the
    Chrome trace to out_dir/trace.json; returns the last result."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available()
                                     else [])
    r = fn()
    _sync()
    with profile(activities=acts) as prof:
        for _ in range(n_runs):
            r = fn()
        _sync()
    os.makedirs(out_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
    return r


def op_breakdown(trace_dir: str, top: int = 30) -> List[Tuple[str, float, int]]:
    """(op name, total ms, count) of the complete events of the Chrome
    traces (.json or .json.gz) under trace_dir, longest first."""
    agg: Dict[str, float] = collections.Counter()
    cnt: Dict[str, int] = collections.Counter()
    for pattern in ("*.json", "*.json.gz"):
        for fn in glob.glob(os.path.join(trace_dir, "**", pattern), recursive=True):
            opener = gzip.open if fn.endswith(".gz") else open
            with opener(fn, "rt") as fh:
                data = json.load(fh)
            for ev in data.get("traceEvents", []):
                if ev.get("ph") == "X" and "dur" in ev:
                    name = ev.get("name", "?")
                    agg[name] += ev["dur"] / 1e3
                    cnt[name] += 1
    out = [(name, ms, cnt[name]) for name, ms in agg.items()]
    out.sort(key=lambda x: -x[1])
    return out[:top]


def print_op_breakdown(trace_dir: str, top: int = 30) -> None:
    """print_timer_stats analog (profiling.py:54-57)."""
    for name, ms, n in op_breakdown(trace_dir, top):
        print(f"{ms:10.3f} ms  x{n:6d}  {name[:100]}")


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def kernel_stage(name: str) -> str:
    """The stage key of a device kernel's (demangled) name."""
    if "any_kernel" in name or "walk_kernel<true>" in name:
        return "shadow_rt_ms"
    if "closest_kernel" in name or "walk_kernel<false>" in name:
        return "rt_ms"
    for k in _BY_FLAG:
        if k + "true>" in name:
            return "rt_ms"
        if k + "false>" in name:
            return "shadow_rt_ms"
    return "shade_ms"


@contextlib.contextmanager
def _tracer_ranges():
    """The tracer functions of integrators/pt wrapped in record_function
    ranges named by their stage."""
    from torch.profiler import record_function

    from fermat_tpu_torch.integrators import pt

    def wrap(fn, label):
        def call(*args, **kw):
            with record_function(label):
                return fn(*args, **kw)
        return call

    saved = {n: getattr(pt, n) for n in _CLOSEST + _ANY}
    for n, fn in saved.items():
        setattr(pt, n, wrap(fn, _RANGE["rt_ms" if n in _CLOSEST else "shadow_rt_ms"]))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(pt, n, fn)


def _events(prof):
    for e in prof.profiler.kineto_results.events():
        ns = e.duration_ns() if hasattr(e, "duration_ns") else 1e3 * e.duration_us()
        yield e, ns / 1e6


def stage_split(fn: Callable, device) -> Dict[str, float]:
    """{rt_ms, shadow_rt_ms, shade_ms} of one call of fn() under
    torch.profiler (see the module docstring)."""
    from torch.profiler import ProfilerActivity, profile

    out = {k: 0.0 for k in ("rt_ms", "shadow_rt_ms", "shade_ms")}
    if torch.device(device).type == "cuda":
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        for e, ms in _events(prof):
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                out[kernel_stage(torch._C._demangle(e.name()))] += ms
        return out
    with _tracer_ranges(), profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = 1e3 * (time.perf_counter() - t0)
    label = {v: k for k, v in _RANGE.items()}
    for e, ms in _events(prof):
        if e.name() in label:
            out[label[e.name()]] += ms
    out["shade_ms"] = max(wall - out["rt_ms"] - out["shadow_rt_ms"], 0.0)
    return out
