"""What the port's design-step tools share (tools/torch_k3_steps.py,
tools/torch_k5_steps.py, tools/torch_k2_k1_steps.py,
tools/torch_k1b_k2b_steps.py): exact text edits of a kernel source, one nvcc
a variant started together, ptxas's registers and spills per kernel, binding
a build's C entry points the way the port's wrappers bind them, CUDA-event
replay timing behind a spin kernel, and the main path's recorded launches
(one render_pass, one AD train step).

A tool builds each design step from this checkout's sources by exact text
edits. The edits are a record of how the kernel was designed: they are
checked when the tool runs (`edited` stops at one that no longer applies),
not by the test suite, so a later change of a kernel does not have to
keep its old steps applying.
"""
from __future__ import annotations

import ctypes
import re
import shutil
import statistics
import subprocess
import time
from pathlib import Path

T0 = time.perf_counter()
REPLAYS = 20
FLUSH_BYTES = 128 * 2 ** 20
SPIN_CYCLES = 50_000_000  # ~25 ms at the H100's 1.98 GHz boost clock


def log(msg: str) -> None:
    print(f"[+{time.perf_counter() - T0:.1f} s] {msg}", flush=True)


def edited(src: str, edits: list, what: str) -> str:
    """src with each edit (old, new[, count]) made; old must occur exactly
    count times (default once), or the tool stops."""
    for old, new, *count in edits:
        count = count[0] if count else 1
        if src.count(old) != count:
            raise SystemExit(f"a step's edit no longer applies to {what}: {old[:70]!r}")
        src = src.replace(old, new)
    return src


_ARGS = {"I6float4": "float4", "If": "float", "Lb1E": "true", "Lb0E": "false"}


def ptxas(text: str, kernels: tuple) -> dict:
    """{kernel<template args>: {registers, stack_bytes, spill_store_bytes,
    spill_load_bytes}} from nvcc -Xptxas -v output; `kernels` names the
    kernels (a mangled name is cut to the first one it contains)."""
    out, cur = {}, None
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            base = next((k for k in kernels if k in name), name)
            tail = name[name.index(base) + len(base):] if base in name else ""
            args = [_ARGS.get(a) or a[2:-1]
                    for a in re.findall(r"I6float4|If|Lb[01]E|Li\d+E", tail.split("EEv")[0] + "E")
                    ] if tail.startswith("I") else []
            cur = base + (f"<{','.join(args)}>" if args else "")
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out[cur].update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                            spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[cur]["registers"] = int(m.group(1))
    return out


def build(variants: dict, build_dir: Path, kernels: tuple, headers: tuple = (),
          nvcc: list = None) -> dict:
    """{key: (file name, source text)} -> {key: (.so path or None, ptxas
    dict, nvcc's output)}: one nvcc each with the port's flags, all started
    together, `headers` copied beside each source. A key is a string or a
    tuple of strings (its directory's name)."""
    if nvcc is None:
        from fermat_tpu_torch.ops import _cuda

        nvcc = [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS]
    procs = {}
    for key, (fname, text) in variants.items():
        label = "_".join(key) if isinstance(key, tuple) else key
        d = build_dir / re.sub(r"[^A-Za-z0-9]+", "_", label).strip("_")
        d.mkdir(parents=True, exist_ok=True)
        for h in headers:
            shutil.copy(h, d / Path(h).name)
        (d / fname).write_text(text)
        procs[key] = (subprocess.Popen([*nvcc, "-o", str(d / "lib.so"), str(d / fname)],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), d / "lib.so")
    out = {}
    for key, (p, so) in procs.items():
        text, _ = p.communicate()
        if p.returncode != 0:
            log(f"nvcc FAILED for {key}:\n{text}")
            out[key] = (None, {}, text)
            continue
        info = ptxas(text, kernels)
        log(f"built {key}: " + "; ".join(
            f"{k} {v.get('registers')} registers, {v.get('stack_bytes')} B stack, "
            f"{v.get('spill_store_bytes')}/{v.get('spill_load_bytes')} B spill stores/loads"
            for k, v in info.items()))
        out[key] = (so, info, text)
    return out


def bind(so: Path, kernels: list) -> list:
    """[(C entry point, error_string)] of one build for each CudaKernel,
    typed as the port's wrappers type them."""
    from fermat_tpu_torch.ops import _cuda

    lib = ctypes.CDLL(str(so))
    err = lib.fermat_error_string
    err.argtypes = [_cuda.I]
    err.restype = ctypes.c_char_p
    out = []
    for kern in kernels:
        fn = getattr(lib, kern.symbol)
        fn.argtypes = kern.argtypes + [_cuda.I, _cuda.P]
        fn.restype = _cuda.I
        out.append((fn, err))
    return out


def replay(fn, cold: bool, flush) -> dict:
    """fn's device time: CUDA events around each of REPLAYS replays queued
    behind a spin kernel (the card waits while the host queues them);
    cold: `flush` (a 128 MiB tensor) written before each. Median, min and
    max in µs."""
    import torch

    fn()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
          for _ in range(REPLAYS)]
    torch.cuda._sleep(SPIN_CYCLES)
    for s, e in ev:
        if cold:
            flush.fill_(1.0)
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    t = [s.elapsed_time(e) * 1e3 for s, e in ev]
    return {"us": statistics.median(t), "us_min": min(t), "us_max": max(t)}


class patch:
    """Temporarily replace module attributes [(module, name, value)]."""

    def __init__(self, replacements):
        self.replacements = replacements

    def __enter__(self):
        self.saved = [(m, n, getattr(m, n)) for m, n, _ in self.replacements]
        for m, n, v in self.replacements:
            setattr(m, n, v)

    def __exit__(self, *exc):
        for m, n, v in self.saved:
            setattr(m, n, v)


def filled_lanes(x, n: int, device):
    """A tracer's lanes as the wrappers made them before ops/trace._lanes
    cached a number's: a fill on the device per call."""
    import torch

    if isinstance(x, (int, float)):
        return torch.full((n,), x, dtype=torch.float32, device=device)
    return torch.as_tensor(x, dtype=torch.float32, device=device).expand(n).contiguous()


def record_pass(view, opts, res_x: int, res_y: int, instance: int = 2000) -> dict:
    """The dense tracers' and the row gather's launches of one render_pass
    (no autograd), as their wrappers' arguments: {"k1a": [(tris, o, d, tmin,
    tmax, active)], "k1b": [...], "k2": [(table, idx)]}. A pass with another
    tracer records only its K2 launches."""
    import torch

    from fermat_tpu_torch.integrators import pt
    from fermat_tpu_torch.scene import lights as lights_mod
    from fermat_tpu_torch.scene import mesh as mesh_mod

    rec = {"k1a": [], "k1b": [], "k2": []}

    def recorder(key, fn):
        def wrapper(*args):
            rec[key].append(args)
            return fn(*args)
        return wrapper

    with torch.no_grad(), patch([(pt, "trace_closest", recorder("k1a", pt.trace_closest)),
                                 (pt, "trace_any", recorder("k1b", pt.trace_any)),
                                 (mesh_mod, "gather_rows", recorder("k2", mesh_mod.gather_rows)),
                                 (lights_mod, "gather_rows",
                                  recorder("k2", lights_mod.gather_rows))]):
        pt.render_pass(view, opts, res_x, res_y, instance, 0)
    torch.cuda.synchronize()
    return rec


def ad_step(view, opts, res_x: int, res_y: int, instance: int):
    """One AD train step as chip_smoke.py phase 4f drives it (bench.py:152-163):
    render_pass under autograd with the (M, 3) diffuse albedos as a leaf, an
    MSE against a zero target, backward(). Returns the leaf's gradient."""
    import torch

    from fermat_tpu_torch.core.math import Vec3
    from fermat_tpu_torch.integrators import pt

    leaf = view.mesh.materials.diffuse.stack().detach().clone().requires_grad_(True)
    mats = view.mesh.materials._replace(diffuse=Vec3(leaf[:, 0], leaf[:, 1], leaf[:, 2]))
    out = pt.render_pass(view._replace(mesh=view.mesh._replace(materials=mats)), opts,
                         res_x, res_y, instance, 0)
    torch.mean(out.composited.stack() ** 2).backward()
    return leaf.grad


def record_ad_step(view, opts, res_x: int, res_y: int, instance: int) -> dict:
    """The launches of one AD train step (ad_step): its forward's dense
    tracer and gather launches as record_pass records them, and "k2b": K2b's
    [(g, idx, rows)]."""
    import torch

    from fermat_tpu_torch.integrators import pt
    from fermat_tpu_torch.ops import gather as gather_mod

    rec = {"k1a": [], "k1b": [], "k2b": []}
    bwd = gather_mod.gather_rows_bwd

    def recorder(key, fn):
        def wrapper(*args):
            rec[key].append(args)
            return fn(*args)
        return wrapper

    with patch([(pt, "trace_closest", recorder("k1a", pt.trace_closest)),
                (pt, "trace_any", recorder("k1b", pt.trace_any)),
                (gather_mod, "gather_rows_bwd", recorder("k2b", bwd))]):
        ad_step(view, opts, res_x, res_y, instance)
    torch.cuda.synchronize()
    return rec
