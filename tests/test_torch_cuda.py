"""Port kernels against their plain PyTorch versions ON THE CARD.

Marked `cuda`: they skip where torch.cuda.is_available() is false. This file
imports no JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

With --fmad=false the tracer, gather and CDF-pick kernels round like their
plain versions, so those comparisons are exact (bit-equal floats, equal hit
ids and flags); the frontier kernels (K5a/K5b) visit clusters in another
order than their plain versions and still give the same answer, and so do
the cluster (K6a/K6b), binned (K7a/K7b) and subcluster (K8a/K8b) kernels,
u and v included. K2's backward (K2b) sums in another order than its plain
version and is held to the tolerance stated in ops/gather.py. The megakernels (K3a/K3b) are held to their plain versions with
the image tolerances of tests/test_torch_pt.py and equal `rays`: a path is
a long chain of transcendental calls and data-dependent branches, so one
ulp anywhere may move a lobe pick on a few pixels.
"""
import copy
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fermat_tpu_torch.core.math import Vec3  # noqa: E402
from fermat_tpu_torch.integrators import pt as tpt  # noqa: E402
from fermat_tpu_torch.integrators import rl as trl  # noqa: E402
from fermat_tpu_torch.accel.cluster import build_clusters, build_subclusters  # noqa: E402
from fermat_tpu_torch.ops import binned_trace as bt  # noqa: E402
from fermat_tpu_torch.ops import bvh_trace  # noqa: E402
from fermat_tpu_torch.ops import cdf_gather  # noqa: E402
from fermat_tpu_torch.ops import cluster_trace as ct  # noqa: E402
from fermat_tpu_torch.ops import frontier_trace as ft  # noqa: E402
from fermat_tpu_torch.ops import gather as gather_mod  # noqa: E402
from fermat_tpu_torch.ops import pt_mega  # noqa: E402
from fermat_tpu_torch.ops import sub_trace as st  # noqa: E402
from fermat_tpu_torch.ops import trace as trace_mod  # noqa: E402
from fermat_tpu_torch.scene.procedural import (big_room, cornell_box,  # noqa: E402
                                               cornell_camera, glass_cornell_box,
                                               random_soup)
from fermat_tpu_torch.scene.view import SceneView  # noqa: E402


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _rays(n, lo, hi, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    o = torch.rand(3, n, generator=g, device=dev) * (hi - lo) + lo
    d = torch.randn(3, n, generator=g, device=dev)
    d = d / d.norm(dim=0, keepdim=True)
    active = torch.rand(n, generator=g, device=dev) < 0.9
    tmax = torch.rand(n, generator=g, device=dev) * 4.0
    return Vec3(*o), Vec3(*d), active, tmax


def _bits(t):
    return t.contiguous().view(torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["cornell", "soup300"])
def test_trace_kernels_match_plain_on_card(dev, scene):
    mesh = (cornell_box(glossy_boxes=True) if scene == "cornell" else random_soup(300))
    tris = mesh.device_view(dev).tri_soup()
    o, d, active, tmax = _rays(65536, -1.0, 1.0, dev, seed=1)
    o = Vec3(o.x, o.y + 1.0, o.z)  # inside the box
    hit = trace_mod.trace_closest(tris, o, d, 1e-4, 3.0e38, active)
    ref = trace_mod._closest_plain(tris, o, d, trace_mod._lanes(1e-4, 65536, dev),
                                   trace_mod._lanes(3.0e38, 65536, dev), active)
    torch.cuda.synchronize()
    assert torch.equal(hit.tri, ref.tri)
    for a, b in ((hit.t, ref.t), (hit.u, ref.u), (hit.v, ref.v)):
        assert torch.equal(_bits(a), _bits(b))
    assert (hit.tri >= 0).any()
    occ = trace_mod.trace_any(tris, o, d, 0.0, tmax, active)
    occ_ref = trace_mod._any_plain(tris, o, d, trace_mod._lanes(0.0, 65536, dev), tmax, active)
    torch.cuda.synchronize()
    assert torch.equal(occ, occ_ref)
    assert occ.any() and not occ.all()


def _hit_equal(a, b) -> bool:
    return torch.equal(a.tri, b.tri) and all(
        torch.equal(_bits(x), _bits(y)) for x, y in ((a.t, b.t), (a.u, b.u), (a.v, b.v)))


def _aimed_rays(tris, n, dev, seed):
    """n rays from random points of the soup's box toward random triangles'
    centroids, so that every triangle count gets hits."""
    g = torch.Generator(device=dev).manual_seed(seed)
    lo = tris[0:3].min(dim=1).values[:, None] - 1.0
    hi = tris[0:3].max(dim=1).values[:, None] + 1.0
    o = torch.rand(3, n, generator=g, device=dev) * (hi - lo) + lo
    k = torch.randint(0, tris.shape[1], (n,), generator=g, device=dev)
    c = tris[0:3, k] + (tris[3:6, k] + tris[6:9, k]) / 3.0
    d = c - o
    return Vec3(*o), Vec3(*(d / d.norm(dim=0, keepdim=True)))


_N_MASK = 4 * 256 + 77  # lanes: not a multiple of K1a's 256-lane block
# the path's lanes: K1a takes two a thread, 512 a block, from 2 blocks an SM up
_N_PATH = 512 * 512


def _mask(kind, n, dev):
    i = torch.arange(n, device=dev)
    return {"none": i < 0, "one": i == 300, "31_lanes": i < 31,
            "33_lanes": (i >= 200) & (i < 233), "every_7th": i % 7 == 0, "all": i >= 0}[kind]


_MASK_CASES = ([(m, t, _N_MASK) for m in ["none", "one", "31_lanes", "33_lanes", "every_7th",
                                            "all"] for t in [1, 127, 129, 4096]]
               + [(m, t, _N_PATH) for m in ["none", "one", "33_lanes", "every_7th", "all"]
                  for t in [36, 4096]])


@pytest.mark.cuda
@pytest.mark.parametrize("mask,n_tris,n", _MASK_CASES)
def test_closest_kernel_active_masks_match_plain_on_card(dev, mask, n_tris, n):
    """K1a's block compaction bit for bit against the plain version: active
    lanes none, one, within one warp and across two, scattered, all; a
    partial last block; one tile (1, 36, 127, 129) and four (4,096
    triangles); 1,101 lanes (one lane a thread) and the path's 262,144 (two
    a thread, two rays a slot); inactive lanes keep t = tmax, tri = -1,
    u = v = 0; two launches bit-equal."""
    tris = random_soup(n_tris).device_view(dev).tri_soup()
    o, d = _aimed_rays(tris, n, dev, seed=n_tris)
    active = _mask(mask, n, dev)
    tmax = trace_mod._lanes(3.0e38, n, dev)
    hit = trace_mod.trace_closest(tris, o, d, 1e-4, tmax, active)
    again = trace_mod.trace_closest(tris, o, d, 1e-4, tmax, active)
    ref = trace_mod._closest_plain(tris, o, d, trace_mod._lanes(1e-4, n, dev), tmax, active)
    torch.cuda.synchronize()
    assert _hit_equal(hit, ref) and _hit_equal(hit, again)
    off = ~active
    assert bool((hit.tri[off] == -1).all()) and bool((hit.t[off] == 3.0e38).all())
    assert bool((hit.u[off] == 0.0).all()) and bool((hit.v[off] == 0.0).all())
    if mask != "none":
        assert bool((hit.tri[active] >= 0).any())


@pytest.mark.cuda
@pytest.mark.parametrize("n", [65_536, _N_PATH])
@pytest.mark.parametrize("tmax", [3.0e38, float("inf")])
def test_closest_kernel_ties_and_tmax_match_plain_on_card(dev, tmax, n):
    """Coplanar ties: the soup holds every triangle twice, so each hit ties
    exactly across indices and tiles, and once more with its vertices
    rotated (the same plane, a t that rounds differently), so hits nearly
    tie (387 triangles, four 128-triangle plain tiles); on an exact tie the
    lowest index wins, as in the plain version. tmax 3e38 and inf; 65,536
    lanes (one a thread) and the path's 262,144 (two a thread); two
    launches bit-equal."""
    base = random_soup(129).device_view(dev).tri_soup()
    p1, p2 = base[0:3] + base[3:6], base[0:3] + base[6:9]
    rotated = torch.cat([p1, p2 - p1, base[0:3] - p1])
    tris = torch.cat([base, base, rotated], dim=1).contiguous()
    o, d = _aimed_rays(base, n, dev, seed=11)
    active = torch.arange(n, device=dev) % 3 != 0
    hit = trace_mod.trace_closest(tris, o, d, 0.0, tmax, active)
    again = trace_mod.trace_closest(tris, o, d, 0.0, tmax, active)
    ref = trace_mod._closest_plain(tris, o, d, trace_mod._lanes(0.0, n, dev),
                                   trace_mod._lanes(tmax, n, dev), active)
    torch.cuda.synchronize()
    assert _hit_equal(hit, ref) and _hit_equal(hit, again)
    got = hit.tri[hit.tri >= 0]
    # the exact copy never wins its tie
    assert got.numel() > 0 and not bool(((got >= 129) & (got < 258)).any())
    assert bool((hit.t[hit.tri < 0] == tmax).all())


@pytest.mark.cuda
@pytest.mark.parametrize("mask,n_tris,n", _MASK_CASES)
def test_any_kernel_active_masks_match_plain_on_card(dev, mask, n_tris, n):
    """K1b's block compaction and split rays against the plain version: the
    masks, triangle counts and lane counts of K1a's test; tmax from the
    ray's reach into the box, so that some rays are occluded and some are
    not; inactive lanes report False; two launches equal."""
    tris = random_soup(n_tris).device_view(dev).tri_soup()
    o, d = _aimed_rays(tris, n, dev, seed=n_tris + 1)
    active = _mask(mask, n, dev)
    g = torch.Generator(device=dev).manual_seed(n)
    tmax = torch.rand(n, generator=g, device=dev) * 3.0
    occ = trace_mod.trace_any(tris, o, d, 1e-4, tmax, active)
    again = trace_mod.trace_any(tris, o, d, 1e-4, tmax, active)
    ref = trace_mod._any_plain(tris, o, d, trace_mod._lanes(1e-4, n, dev), tmax, active)
    torch.cuda.synchronize()
    assert torch.equal(occ, ref) and torch.equal(occ, again)
    assert not bool(occ[~active].any())
    if mask in ("every_7th", "all") and n_tris > 1:
        assert bool(occ[active].any()) and not bool(occ[active].all())


@pytest.mark.cuda
@pytest.mark.parametrize("mask", ["all", "one", "every_7th"])
@pytest.mark.parametrize("n", [_N_MASK, _N_PATH])
def test_any_kernel_hit_at_tmin_or_tmax_is_no_hit_on_card(dev, mask, n):
    """A hit at t exactly tmin or exactly tmax occludes nothing (tmin < t <
    tmax): every ray meets one triangle of a 36-triangle soup at t = 1
    exactly (u = v = 0.25), away from the others."""
    tris = random_soup(36).device_view(dev).tri_soup().clone()
    tris[:, 17] = torch.tensor([10.0, 10.0, 5.0, 1.0, 0.0, 0.0, 0.0, 1.0, 0.0], device=dev)
    full = lambda v: torch.full((n,), v, device=dev)
    o, d = Vec3(full(10.25), full(10.25), full(6.0)), Vec3(full(0.0), full(0.0), full(-1.0))
    active = _mask(mask, n, dev)
    for tmin, tmax, want in ((1.0, 2.0, False), (0.0, 1.0, False), (0.5, 1.5, True)):
        occ = trace_mod.trace_any(tris, o, d, tmin, tmax, active)
        ref = trace_mod._any_plain(tris, o, d, trace_mod._lanes(tmin, n, dev),
                                   trace_mod._lanes(tmax, n, dev), active)
        torch.cuda.synchronize()
        assert torch.equal(occ, ref) and torch.equal(occ, active & want)


def _dispatched(fn) -> list:
    """The aten ops one call of fn dispatches, views left out, after a
    warm-up call: every device kernel PyTorch launches is one of these ops
    (a view launches none), and the port's own kernels are counted by their
    wrappers' launch counters."""
    from torch.utils._python_dispatch import TorchDispatchMode

    ops = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not func.is_view:
                ops.append(str(func))
            return func(*args, **(kwargs or {}))

    fn()
    torch.cuda.synchronize()
    with Record():
        fn()
    torch.cuda.synchronize()
    return ops


_WRAPPERS = {"dense": (trace_mod.trace_closest, trace_mod.trace_any),
             "frontier": (ft.trace_closest_frontier, ft.trace_any_frontier),
             "cluster": (ct.trace_closest_cluster, ct.trace_any_cluster),
             "binned": (bt.trace_closest_binned, bt.trace_any_binned),
             "sub": (st.trace_closest_sub, st.trace_any_sub)}
_COUNTERS = {"dense": (trace_mod.CLOSEST, trace_mod.ANY), "frontier": (ft.CLOSEST, ft.ANY),
             "cluster": (ct.CLOSEST, ct.ANY), "binned": (bt.CLOSEST, bt.ANY),
             "sub": (st.CLOSEST, st.ANY)}
_FILLS = ("aten.full", "aten.fill_", "aten.ones", "aten.zeros", "aten.new_full",
          "aten.new_ones", "aten.new_zeros")


@pytest.mark.cuda
@pytest.mark.parametrize("tracer", list(_WRAPPERS))
def test_tracer_wrappers_launch_no_fill_on_card(dev, tracer):
    """With number tmin / tmax (and no mask) a tracer wrapper dispatches the
    same aten ops as with lanes made before the call, and launches its
    kernel as often: its lanes are cached (ops/trace._lanes), so it fills
    none. No wrapper dispatches a fill at all (the binned round loop's
    first scan starts the per-ray state on the card, and its C entry point
    zeroes the loop's counts, binned_trace._new_loop allocating only).
    trace_any dispatches only its output's empty and launches K1b once.

    The kernels are counted at the dispatcher, not from torch.profiler's
    event list: on an H100 the profiler's list of one call now and then
    lacks kernels the call ran (CUPTI loses activity records: a list short
    of a few kernels, or empty, in about 1 of 40 sessions) and holds
    kernels that ran before the session (the test's own fills)."""
    mesh = big_room(400).device_view(dev)
    table = (mesh.tri_soup() if tracer == "dense" else build_subclusters(mesh)
             if tracer == "sub" else build_clusters(mesh))
    n = 4096
    o, d, active, _ = _rays(n, -6.0, 6.0, dev, seed=9)
    t0, t1 = torch.full((n,), 1e-4, device=dev), torch.full((n,), 3.0e38, device=dev)
    every = torch.ones(n, dtype=torch.bool, device=dev)
    for fn, kern in zip(_WRAPPERS[tracer], _COUNTERS[tracer]):
        for act, act_t in ((active, active), (None, every)):
            before = kern.launches
            with_numbers = _dispatched(lambda: fn(table, o, d, 1e-4, 3.0e38, act))
            mid = kern.launches
            with_lanes = _dispatched(lambda: fn(table, o, d, t0, t1, act_t))
            assert kern.launches - mid == mid - before >= 2
            assert with_numbers == with_lanes, (with_numbers, with_lanes)
            fills = [op for op in with_numbers if op.startswith(_FILLS)]
            assert not fills, fills
    soup = mesh.tri_soup()
    before = trace_mod.ANY.launches
    ops = _dispatched(lambda: trace_mod.trace_any(soup, o, d, 0.0, 2.5, active))
    assert ops == ["aten.empty.memory_format"], ops
    assert trace_mod.ANY.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols,n", [(36, 52, 100_003), (36, 23, 100_003), (36, 1, 100_003),
                                         (4096, 52, 100_003), (36, 3, 100_003),
                                         (36, 16, 100_003), (36, 53, 100_003),
                                         (99_636, 52, 100_003), (36, 52, 262_144),
                                         (36, 53, 262_144)])
def test_gather_kernel_matches_plain_on_card(dev, rows, cols, n):
    """K2 exact against the plain version: the 16-byte row path (cols 16,
    52) and the scalar one (1, 3, 23, 53, and a table 4 bytes off 16-byte
    alignment), small tables and one of big_room's 99,636 rows, outputs
    within L2 (plain stores) and larger (262,144 x 52 or 53: streaming
    stores), indices -1 and R, n = 0; two launches bit-equal."""
    g = torch.Generator(device=dev).manual_seed(rows + cols)
    table = torch.randn(rows, cols, generator=g, device=dev)
    idx = torch.randint(-3, rows + 3, (n,), generator=g, device=dev,
                        dtype=torch.int32)  # includes out-of-range rows
    idx[:2] = torch.tensor([-1, rows], device=dev)
    buf = torch.empty(rows * cols + 1, device=dev)
    shifted = buf[1:].view(rows, cols)  # contiguous, 4 bytes past 16-byte alignment
    shifted.copy_(table)
    before = gather_mod.GATHER.launches
    out = gather_mod.gather_rows(table, idx)
    again = gather_mod.gather_rows(table, idx)
    off = gather_mod.gather_rows(shifted, idx)
    empty = gather_mod.gather_rows(table, idx[:0])
    torch.cuda.synchronize()
    assert gather_mod.GATHER.launches == before + 4
    want = gather_mod._gather_plain(table, idx)
    assert torch.equal(_bits(out), _bits(want)) and torch.equal(_bits(out), _bits(again))
    assert torch.equal(_bits(off), _bits(want))
    assert bool((out[:2] == 0.0).all()) and empty.shape == (0, cols)


@pytest.mark.cuda
def test_wrappers_count_launches_and_reject_bad_input(dev):
    table = torch.zeros(4, 3, device=dev)
    before = gather_mod.GATHER.launches
    gather_mod.gather_rows(table, torch.zeros(5, dtype=torch.int32, device=dev))
    assert gather_mod.GATHER.launches == before + 1
    with pytest.raises(TypeError):
        gather_mod.gather_rows(table, torch.zeros(5, dtype=torch.int64, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["big_room400", "soup4096"])
def test_frontier_kernels_match_plain_on_card(dev, scene):
    mesh = (big_room(400) if scene == "big_room400" else random_soup(4096)).device_view(dev)
    cl = build_clusters(mesh)
    lo = torch.tensor([-8.0, 0.0, -8.0] if scene == "big_room400" else [-5.0] * 3, device=dev)
    hi = torch.tensor([8.0, 8.0, 8.0] if scene == "big_room400" else [5.0] * 3, device=dev)
    o, d, active, tmax = _rays(65536, 0.0, 1.0, dev, seed=2)
    o = Vec3(*(lo[k] + (hi[k] - lo[k]) * c for k, c in enumerate(o)))
    tmax = tmax * 4.0
    n = o.x.shape[0]
    for t0, t1 in ((1e-4, 3.0e38), (0.0, tmax)):
        hit = ft.trace_closest_frontier(cl, o, d, t0, t1, active, with_uv=False)
        t_ref, tri_ref = ft._closest_plain(cl, o, d, trace_mod._lanes(t0, n, dev),
                                           trace_mod._lanes(t1, n, dev), active)
        occ = ft.trace_any_frontier(cl, o, d, t0, t1, active)
        occ_ref = ft._any_plain(cl, o, d, trace_mod._lanes(t0, n, dev),
                                trace_mod._lanes(t1, n, dev), active)
        torch.cuda.synchronize()
        assert torch.equal(hit.tri, tri_ref) and torch.equal(_bits(hit.t), _bits(t_ref))
        assert torch.equal(occ, occ_ref)
        assert (hit.tri >= 0).any() and occ.any() and not occ.all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["dead_lanes", "tmax_inf", "all_dead"])
def test_frontier_kernels_with_the_sort_match_plain_on_card(dev, case):
    """K5a/K5b over rays the wrappers co-sort (more than 4 blocks, a ragged
    last warp), bit for bit against the plain versions: lanes dead by the
    mask and by tmax <= tmin, tmax = inf, and a launch where every lane is
    dead; the sort key kernel equal to its plain version."""
    cl = build_clusters(big_room(400).device_view(dev))
    n = 4 * ft.SORT_MIN + 77
    o, d, active, tmax = _rays(n, 0.0, 1.0, dev, seed=5)
    lo, hi = torch.tensor([-8.0, 0.0, -8.0], device=dev), torch.tensor([8.0] * 3, device=dev)
    o = Vec3(*(lo[k] + (hi[k] - lo[k]) * c for k, c in enumerate(o)))
    tmin = trace_mod._lanes(1e-4, n, dev)
    tmax = tmax * 4.0
    if case == "dead_lanes":
        tmax[::7] = 0.0  # tmax <= tmin: dead although active
    elif case == "tmax_inf":
        tmax = torch.full((n,), float("inf"), device=dev)
    else:
        active = torch.zeros(n, dtype=torch.bool, device=dev)
    key = ft.sort_key(cl, o, d, tmin, tmax, active)
    assert torch.equal(key, ft._sort_key_plain(cl, o, d, tmin, tmax, active))
    before = (ft.KEY.launches, ft.CLOSEST.launches, ft.ANY.launches)
    hit = ft.trace_closest_frontier(cl, o, d, tmin, tmax, active, with_uv=False)
    occ = ft.trace_any_frontier(cl, o, d, tmin, tmax, active)
    assert (ft.KEY.launches, ft.CLOSEST.launches, ft.ANY.launches) == tuple(
        b + k for b, k in zip(before, (2, 1, 1)))
    t_ref, tri_ref = ft._closest_plain(cl, o, d, tmin, tmax, active)
    occ_ref = ft._any_plain(cl, o, d, tmin, tmax, active)
    torch.cuda.synchronize()
    assert torch.equal(hit.tri, tri_ref) and torch.equal(_bits(hit.t), _bits(t_ref))
    assert torch.equal(occ, occ_ref)
    if case == "all_dead":
        assert bool((hit.tri == -1).all()) and not bool(occ.any())
    else:
        assert (hit.tri >= 0).any() and occ.any() and not occ.all()


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows,cols", [(2, 23), (544, 23), (5000, 7)])
def test_cdf_pick_kernel_matches_plain_on_card(dev, n_rows, cols):
    g = torch.Generator(device=dev).manual_seed(n_rows)
    w = torch.rand(n_rows, generator=g, device=dev) + 1e-3
    cdf = (torch.cumsum(w, 0) / w.sum()).contiguous()
    rows = torch.randn(n_rows, cols, generator=g, device=dev)
    u = torch.rand(100_003, generator=g, device=dev)
    u[:n_rows] = cdf  # exact boundaries
    u[n_rows:n_rows + 4] = torch.tensor([float("nan"), 1.0, 1.5, -0.25], device=dev)
    out = cdf_gather.cdf_pick_rows(rows, cdf, u)
    torch.cuda.synchronize()
    assert torch.equal(_bits(out), _bits(cdf_gather._pick_plain(rows, cdf, u)))
    assert torch.equal(out[n_rows], rows[0])  # NaN picks row 0


@pytest.mark.cuda
def test_frontier_and_cdf_wrappers_count_launches_and_reject_bad_input(dev):
    cl = build_clusters(random_soup(300).device_view(dev))
    o, d, active, _ = _rays(64, -1.0, 1.0, dev, seed=3)
    before = (ft.CLOSEST.launches, ft.ANY.launches, cdf_gather.PICK.launches)
    ft.trace_closest_frontier(cl, o, d, 1e-4, 3.0e38, active)
    ft.trace_any_frontier(cl, o, d, 1e-4, 3.0e38, active)
    cdf_gather.cdf_pick_rows(torch.zeros(2, 3, device=dev), torch.tensor([0.5, 1.0], device=dev),
                             torch.rand(10, device=dev))
    assert (ft.CLOSEST.launches, ft.ANY.launches, cdf_gather.PICK.launches) == tuple(
        b + 1 for b in before)
    with pytest.raises(ValueError):  # an active mask on the CPU
        ft.trace_closest_frontier(cl, o, d, 1e-4, 3.0e38, active.cpu())
    with pytest.raises(TypeError):  # float64 rays
        ft.trace_any_frontier(cl, Vec3(*(c.double() for c in o)), d, 1e-4, 3.0e38, active)
    with pytest.raises(ValueError):  # a cdf that does not match the rows
        cdf_gather.cdf_pick_rows(torch.zeros(3, 3, device=dev), torch.ones(2, device=dev),
                                 torch.rand(10, device=dev))
    with pytest.raises(TypeError):
        cdf_gather.cdf_pick_rows(torch.zeros(2, 3, device=dev), torch.ones(2, device=dev),
                                 torch.rand(10, device=dev, dtype=torch.float64))
    assert (ft.CLOSEST.launches, ft.ANY.launches, cdf_gather.PICK.launches) == tuple(
        b + 1 for b in before)


# the third entry: binned_trace constants set for the case (a queue of one
# key, so a scan a visit, and work items of 32 rays)
_K6_K7 = {"cluster": (ct.trace_closest_cluster, ct.trace_any_cluster, {}),
          "binned": (bt.trace_closest_binned, bt.trace_any_binned, {}),
          "binned_q1_b32": (bt.trace_closest_binned, bt.trace_any_binned,
                            dict(BLOCK=32, QUEUE=1))}


@pytest.mark.cuda
@pytest.mark.parametrize("tracer", list(_K6_K7))
@pytest.mark.parametrize("scene", ["big_room400", "soup4096"])
def test_cluster_and_binned_kernels_match_plain_on_card(dev, scene, tracer, monkeypatch):
    """K6/K7 against the shared plain versions (t, tri, u, v bit-equal,
    occlusion equal) and against K5 on the same rays; 8192 rays, so that
    the cluster tracer co-sorts them (n >= 4 blocks)."""
    closest, anyhit, consts = _K6_K7[tracer]
    for name, value in consts.items():
        monkeypatch.setattr(bt, name, value)
    mesh = (big_room(400) if scene == "big_room400" else random_soup(4096)).device_view(dev)
    cl = build_clusters(mesh)
    lo = torch.tensor([-8.0, 0.0, -8.0] if scene == "big_room400" else [-5.0] * 3, device=dev)
    hi = torch.tensor([8.0, 8.0, 8.0] if scene == "big_room400" else [5.0] * 3, device=dev)
    o, d, active, tmax = _rays(8192, 0.0, 1.0, dev, seed=4)
    o = Vec3(*(lo[k] + (hi[k] - lo[k]) * c for k, c in enumerate(o)))
    n = o.x.shape[0]
    for t0, t1 in ((1e-4, 3.0e38), (0.0, tmax * 4.0), (1e-4, float("inf"))):
        lanes = trace_mod._lanes(t0, n, dev), trace_mod._lanes(t1, n, dev)
        hit = closest(cl, o, d, t0, t1, active)
        ref = ft._closest_uv_plain(cl, o, d, *lanes, active)
        occ = anyhit(cl, o, d, t0, t1, active)
        occ_ref = ft._any_plain(cl, o, d, *lanes, active)
        k5 = ft.trace_closest_frontier(cl, o, d, t0, t1, active, with_uv=False)
        torch.cuda.synchronize()
        assert torch.equal(hit.tri, ref.tri)
        for a, b in ((hit.t, ref.t), (hit.u, ref.u), (hit.v, ref.v)):
            assert torch.equal(_bits(a), _bits(b))
        assert torch.equal(occ, occ_ref)
        assert torch.equal(k5.tri, hit.tri) and torch.equal(_bits(k5.t), _bits(hit.t))
        assert (hit.tri >= 0).any() and occ.any() and not occ.all()


@pytest.mark.cuda
@pytest.mark.parametrize("closest", [True, False])
def test_binned_steps_match_plain_on_card(dev, closest):
    """Each kernel of the binned round loop (scan, counting sort, test)
    against its plain version, step by step over the first rounds of a
    trace on big_room(400): the per-ray state and the bins bit-equal, the
    lists equal as binned_trace._state_diff reads them."""
    cl = build_clusters(big_room(400).device_view(dev))
    lo = torch.tensor([-8.0, 0.0, -8.0], device=dev)
    hi = torch.tensor([8.0, 8.0, 8.0], device=dev)
    o, d, active, tmax = _rays(8192, 0.0, 1.0, dev, seed=5)
    o = Vec3(*(lo[k] + (hi[k] - lo[k]) * c for k, c in enumerate(o)))
    n = o.x.shape[0]
    t0 = trace_mod._lanes(1e-4, n, dev)
    t1 = trace_mod._lanes(3.0e38, n, dev) if closest else tmax * 4.0
    rays = bt._Rays(o, d, t0, t1)
    kern = bt._kernel_run(cl, rays, active, closest)
    plain = bt._plain_run(cl, rays, active, closest)
    lk = bt._new_loop(n, cl.rows.shape[0], closest, dev)
    for r in range(4):
        for step in (bt.STEP_SCAN, bt.STEP_BIN, bt.STEP_TEST):
            lp = bt._Loop(*(t.clone() for t in lk))
            first = r == 0 and step == bt.STEP_SCAN
            kern(lk, 1, first, step)
            plain(lp, 1, first, step)
            torch.cuda.synchronize()
            assert bt._state_diff(lk, lp, closest) == [], (r, step)
    assert int(lk.ctl[bt.CTL_ROUNDS]) == 4 and int(lk.ctl[bt.CTL_SCANS]) > 0


@pytest.mark.cuda
def test_cluster_and_binned_wrappers_count_launches_and_reject_bad_input(dev):
    cl = build_clusters(random_soup(300).device_view(dev))
    o, d, active, _ = _rays(64, -1.0, 1.0, dev, seed=3)
    kernels = (ct.CLOSEST, ct.ANY, bt.CLOSEST, bt.ANY, bt.SCAN_CLOSEST, bt.SCAN_ANY, bt.BIN)
    before = [k.launches for k in kernels]
    ct.trace_closest_cluster(cl, o, d, 1e-4, 3.0e38, active)
    ct.trace_any_cluster(cl, o, d, 1e-4, 3.0e38, active)
    readbacks = 0
    for fn in (bt.trace_closest_binned, bt.trace_any_binned):
        # one readback of the loop's counts per batch of ROUND_BATCH rounds,
        # the last of them finding the loop over
        bt.LOOP.reset()
        fn(cl, o, d, 1e-4, 3.0e38, active)
        assert bt.LOOP.traces == 1 and bt.LOOP.rounds > 0
        assert bt.LOOP.readbacks == bt.LOOP.rounds // bt.ROUND_BATCH + 1
        readbacks += bt.LOOP.readbacks
    after = [k.launches for k in kernels]
    assert after[:2] == [b + 1 for b in before[:2]]
    # each kernel of a round launched once per enqueued round
    rounds = [a - b for a, b in zip(after[2:], before[2:])]
    assert rounds[0] == rounds[2] and rounds[1] == rounds[3] and rounds[4] == sum(rounds[:2])
    assert sum(rounds[:2]) == bt.ROUND_BATCH * readbacks
    with pytest.raises(ValueError):  # an active mask on the CPU
        ct.trace_closest_cluster(cl, o, d, 1e-4, 3.0e38, active.cpu())
    with pytest.raises(TypeError):  # float64 rays
        bt.trace_any_binned(cl, Vec3(*(c.double() for c in o)), d, 1e-4, 3.0e38, active)
    # more clusters than the E' row of shared memory holds at block 512
    c_pad = 60_000
    wide = lambda: torch.zeros(1, c_pad, device=dev)
    big = cl._replace(rows=torch.empty(c_pad, 128, 12, device=dev),
                      count=torch.zeros(c_pad, dtype=torch.int32, device=dev),
                      lo_x=wide(), lo_y=wide(), lo_z=wide(), hi_x=wide(), hi_y=wide(),
                      hi_z=wide())
    with pytest.raises(NotImplementedError):
        ct.trace_closest_cluster(big, o, d, 1e-4, 3.0e38, active)
    assert [k.launches for k in kernels] == after


def _image_ok(got, want) -> bool:
    near = torch.isclose(got, want, atol=1e-4, rtol=1e-3).all(dim=0).float().mean()
    gm, wm = got.mean(dim=1), want.mean(dim=1)
    mean_rel = ((gm - wm).abs() / wm.abs().clamp_min(1e-7)).max()
    return bool(near >= 0.99) and bool(mean_rel <= 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("scene,lobes,clearcoat", [
    ("cornell", (True, False, True, False), False),
    ("cornell", (True, True, True, True), True),
    ("glass", (True, True, True, True), False),
    ("glass", (True, True, True, True), True),
])
def test_mega_forward_matches_plain_on_card(dev, scene, lobes, clearcoat):
    res = 64
    storage = glass_cornell_box() if scene == "glass" else cornell_box(glossy_boxes=True)
    view = SceneView.build(storage, cornell_camera(), dev)
    opts = tpt.PTOptions(tracer="mega", max_path_length=6, lobes=lobes, clearcoat=clearcoat)
    tb = pt_mega.build_mega_tables(view, res, res, opts.ray_eps)
    before = pt_mega.FORWARD.launches
    out = pt_mega._mega_forward(tb, opts, res, res * res, 5, 0)
    ref = pt_mega._mega_plain(tb, opts, res, res * res, 5, 0)
    torch.cuda.synchronize()
    assert pt_mega.FORWARD.launches == before + 1
    assert float(out[26].sum()) == float(ref[26].sum())  # rays
    for k in range(0, 9, 3):  # direct, diffuse, specular
        assert _image_ok(out[k:k + 3], ref[k:k + 3])
    assert float((out[10] == ref[10]).float().mean()) >= 0.999  # hit flag
    assert float(out[:9].sum()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("scene,lobes", [("cornell", (True, False, True, False)),
                                         ("glass", (True, True, True, True))])
def test_mega_grad_matches_plain_on_card(dev, scene, lobes):
    res = 64
    n = res * res
    storage = glass_cornell_box() if scene == "glass" else cornell_box(glossy_boxes=True)
    view = SceneView.build(storage, cornell_camera(), dev)
    opts = tpt.PTOptions(tracer="mega", max_path_length=6, lobes=lobes)
    tb = pt_mega.build_mega_tables(view, res, res, opts.ray_eps)
    img = pt_mega._mega_forward(tb, opts, res, n, 2, 0)
    comp = (img[0:3] + img[3:6] + img[6:9]).t().contiguous()
    adjoint = 2.0 * (comp - 0.2) / (n * 3)
    g = pt_mega._mega_grad(tb, opts, res, n, 2, 0, adjoint)
    ref = pt_mega._mega_grad_plain(tb, opts, res, n, 2, 0, adjoint)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    assert scale > 0.0
    assert float((g - ref).abs().max()) <= 1e-3 * scale


def _cornell_16_materials():
    """The glossy CornellBox with its 36 triangles spread over 16 materials
    (GRAD_M_MAX): the boxes' 24 triangles go over the box material and 11
    copies of it with other diffuse colours, two triangles each, one of
    each box, so that each material has a triangle the camera sees (each
    box's last two lie on the floor)."""
    storage = cornell_box(glossy_boxes=True)
    box = storage.materials[4]
    for k in range(11):
        m = copy.deepcopy(box)
        m.name = f"box{k}"
        m.diffuse = tuple(0.3 + 0.05 * k + 0.02 * c for c in range(3))
        storage.materials.append(m)
    ids = storage.material_ids.copy()
    boxes = np.flatnonzero(ids == 4)
    k = np.arange(boxes.size)
    ids[boxes] = 4 + np.where(k < 12, k, (k - 6) % 12)
    storage.material_ids = ids
    assert len(storage.materials) == pt_mega.GRAD_M_MAX
    return storage


@pytest.mark.cuda
@pytest.mark.parametrize("res_x,res_y", [(100, 37), (16, 16), (300, 301)])
def test_mega_forward_matches_plain_at_any_pixel_count_on_card(dev, res_x, res_y):
    """K3a's persistent grid at 3,700 pixels (not a multiple of 128), 256
    (fewer blocks than the grid holds) and 90,300 (more pixels than the
    grid's threads, so lanes take further pixels): every pixel traced once
    (a hit flag of +-1 and at least one ray in every lane) and the pass
    held to its plain version."""
    view = SceneView.build(cornell_box(glossy_boxes=True), cornell_camera(), dev)
    opts = tpt.PTOptions(tracer="mega", max_path_length=6, lobes=(True, False, True, False))
    tb = pt_mega.build_mega_tables(view, res_x, res_y, opts.ray_eps)
    n = res_x * res_y
    out = pt_mega._mega_forward(tb, opts, res_x, n, 5, 0)
    ref = pt_mega._mega_plain(tb, opts, res_x, n, 5, 0)
    torch.cuda.synchronize()
    assert bool((out[10].abs() == 1.0).all()) and bool((out[26] >= 1.0).all())
    assert float(out[26].sum()) == float(ref[26].sum())
    for k in range(0, 9, 3):
        assert _image_ok(out[k:k + 3], ref[k:k + 3])
    assert float((out[10] == ref[10]).float().mean()) >= 0.999


@pytest.mark.cuda
def test_mega_grad_two_launches_bit_equal_on_card(dev):
    """K3b at the main path's 512x512 (lanes take several pixels each): the
    pixel-to-lane assignment is static, so the sum is the same every run."""
    res = 512
    n = res * res
    view = SceneView.build(cornell_box(glossy_boxes=True), cornell_camera(), dev)
    opts = tpt.PTOptions(tracer="mega", max_path_length=6, lobes=(True, False, True, False))
    tb = pt_mega.build_mega_tables(view, res, res, opts.ray_eps)
    img = pt_mega._mega_forward(tb, opts, res, n, 3, 0)
    adjoint = 2.0 * (img[0:3] + img[3:6] + img[6:9]).t().contiguous() / (n * 3)
    g1 = pt_mega._mega_grad(tb, opts, res, n, 3, 0, adjoint)
    g2 = pt_mega._mega_grad(tb, opts, res, n, 3, 0, adjoint)
    torch.cuda.synchronize()
    assert float(g1.abs().max()) > 0.0
    assert torch.equal(_bits(g1), _bits(g2))


@pytest.mark.cuda
def test_mega_grad_at_sixteen_materials_matches_plain_on_card(dev):
    res = 128
    n = res * res
    view = SceneView.build(_cornell_16_materials(), cornell_camera(), dev)
    opts = tpt.PTOptions(tracer="mega", max_path_length=6, lobes=(True, False, True, False))
    tb = pt_mega.build_mega_tables(view, res, res, opts.ray_eps)
    assert tb.n_mats == pt_mega.GRAD_M_MAX
    img = pt_mega._mega_forward(tb, opts, res, n, 2, 0)
    adjoint = 2.0 * ((img[0:3] + img[3:6] + img[6:9]).t().contiguous() - 0.2) / (n * 3)
    g = pt_mega._mega_grad(tb, opts, res, n, 2, 0, adjoint)
    ref = pt_mega._mega_grad_plain(tb, opts, res, n, 2, 0, adjoint)
    torch.cuda.synchronize()
    scale = float(ref.abs().max())
    assert scale > 0.0 and bool((ref.abs().sum(dim=1) > 0.0).all())  # every material seen
    assert float((g - ref).abs().max()) <= 1e-3 * scale


@pytest.mark.cuda
def test_mega_wrappers_reject_bad_input(dev):
    view = SceneView.build(cornell_box(glossy_boxes=True), cornell_camera(), dev)
    opts = tpt.PTOptions(tracer="mega", max_path_length=2)
    tb = pt_mega.build_mega_tables(view, 8, 8, opts.ray_eps)
    with pytest.raises(ValueError):  # a table on the wrong device
        pt_mega._mega_forward(tb._replace(cam=tb.cam.cpu()), opts, 8, 64, 0, 0)
    with pytest.raises(ValueError):  # an adjoint of the wrong shape
        pt_mega._mega_grad(tb, opts, 8, 64, 0, 0, torch.zeros(63, 3, device=dev))
    with pytest.raises(TypeError):
        pt_mega._mega_grad(tb, opts, 8, 64, 0, 0, torch.zeros(64, 3, device=dev,
                                                             dtype=torch.float64))
    with pytest.raises(NotImplementedError):
        soup = SceneView.build(random_soup(200), cornell_camera(), dev)
        tpt.render_pass(soup, opts, 8, 8, 0)


def _bwd_close(got, want, g, idx, rows) -> bool:
    """K2b's stated tolerance (ops/gather.py BWD_RTOL)."""
    scale = gather_mod._gather_bwd_plain(g.abs(), idx, rows)
    return bool(((got - want).abs() <= gather_mod.BWD_RTOL * scale).all())


@pytest.mark.cuda
@pytest.mark.parametrize("rows,cols", [(36, 52), (36, 1), (7, 300), (4096, 52), (99_636, 52)])
def test_gather_bwd_kernel_matches_plain_on_card(dev, rows, cols):
    """K2b in both modes (shared: the first three; atomic: the last two)
    against _gather_bwd_plain, out-of-range indices included; the shared
    mode gives the same bits on every launch."""
    gen = torch.Generator(device=dev).manual_seed(rows + cols)
    n = 262_147
    idx = torch.randint(-3, rows + 3, (n,), generator=gen, device=dev, dtype=torch.int32)
    g = torch.randn(n, cols, generator=gen, device=dev)
    shared = gather_mod.bwd_slices(rows, cols) > 0
    assert shared == (rows * cols <= 36 * 300)
    before = gather_mod.GATHER_BWD.launches
    got = gather_mod.gather_rows_bwd(g, idx, rows)
    again = gather_mod.gather_rows_bwd(g, idx, rows)
    want = gather_mod._gather_bwd_plain(g, idx, rows)
    torch.cuda.synchronize()
    assert gather_mod.GATHER_BWD.launches == before + 2
    assert _bwd_close(got, want, g, idx, rows)
    if shared:
        assert torch.equal(_bits(got), _bits(again))
    # through autograd: the Function's backward is the kernel
    table = torch.randn(rows, cols, generator=gen, device=dev, requires_grad=True)
    (gather_mod.gather_rows(table, idx) * g).sum().backward()
    assert gather_mod.GATHER_BWD.launches == before + 3
    assert _bwd_close(table.grad, want, g, idx, rows)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["one_row", "runs", "out_of_range", "uniform"])
@pytest.mark.parametrize("rows,cols", [(36, 52), (gather_mod.BWD_ROWS, 52), (36, 23), (36, 1),
                                       (gather_mod.BWD_ROWS, 1)])
def test_gather_bwd_shared_mode_patterns_on_card(dev, rows, cols, pattern):
    """K2b's shared mode at the shapes around its cut (ops/gather.py
    BWD_ROWS): every lane on one row, runs of equal indices (the path's
    shape), every index out of range (zeros), and uniform random indices;
    two launches bit-equal, within BWD_RTOL of the plain version."""
    assert gather_mod.bwd_slices(rows, cols) > 0
    gen = torch.Generator(device=dev).manual_seed(rows * cols)
    n = _N_PATH + 33
    if pattern == "one_row":
        idx = torch.full((n,), rows // 2, dtype=torch.int32, device=dev)
    elif pattern == "runs":  # runs of 1-300 lanes, a random row each
        lens = torch.randint(1, 301, (n,), generator=gen, device=dev)
        starts = torch.zeros(n, dtype=torch.bool, device=dev)
        starts[torch.cumsum(lens, 0)[torch.cumsum(lens, 0) < n]] = True
        starts[0] = True
        run_row = torch.randint(-2, rows + 2, (n,), generator=gen, device=dev)
        idx = run_row[torch.cumsum(starts.long(), 0) - 1].to(torch.int32)
    elif pattern == "out_of_range":
        idx = torch.where(torch.arange(n, device=dev) % 2 == 0, -1, rows).to(torch.int32)
    else:
        idx = torch.randint(0, rows, (n,), generator=gen, device=dev, dtype=torch.int32)
    g = torch.randn(n, cols, generator=gen, device=dev)
    got = gather_mod.gather_rows_bwd(g, idx, rows)
    again = gather_mod.gather_rows_bwd(g, idx, rows)
    want = gather_mod._gather_bwd_plain(g, idx, rows)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(again))
    assert _bwd_close(got, want, g, idx, rows)
    if pattern == "out_of_range":
        assert bool((got == 0.0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["big_room400", "soup4096"])
def test_sub_kernels_match_plain_and_k5_on_card(dev, scene):
    mesh = (big_room(400) if scene == "big_room400" else random_soup(4096)).device_view(dev)
    subs, cl = build_subclusters(mesh), build_clusters(mesh)
    lo, hi = (-6.0, 6.0) if scene == "big_room400" else (-1.0, 1.0)
    o, d, active, tmax = _rays(65536, lo, hi, dev, seed=7)
    n = 65536
    t0, t1 = trace_mod._lanes(1e-4, n, dev), trace_mod._lanes(3.0e38, n, dev)
    hit = st.trace_closest_sub(subs, o, d, 1e-4, 3.0e38, active)
    ref = ft._closest_uv_plain(subs, o, d, t0, t1, active)
    k5 = ft.trace_closest_frontier(cl, o, d, 1e-4, 3.0e38, active)
    occ = st.trace_any_sub(subs, o, d, 0.0, tmax, active)
    occ_ref = ft._any_plain(subs, o, d, trace_mod._lanes(0.0, n, dev), tmax, active)
    occ5 = ft.trace_any_frontier(cl, o, d, 0.0, tmax, active)
    torch.cuda.synchronize()
    assert torch.equal(hit.tri, ref.tri) and torch.equal(hit.tri, k5.tri)
    for a, b in ((hit.t, ref.t), (hit.u, ref.u), (hit.v, ref.v), (hit.t, k5.t)):
        assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(occ, occ_ref) and torch.equal(occ, occ5)
    assert (hit.tri >= 0).any() and occ.any() and not occ.all()


@pytest.mark.cuda
def test_sub_wrappers_count_launches_and_reject_bad_input(dev):
    subs = build_subclusters(random_soup(300).device_view(dev))
    o, d, active, _ = _rays(64, -1.0, 1.0, dev, seed=3)
    before = [st.CLOSEST.launches, st.ANY.launches]
    st.trace_closest_sub(subs, o, d, 1e-4, 3.0e38, active)
    st.trace_any_sub(subs, o, d, 1e-4, 3.0e38, active)
    after = [st.CLOSEST.launches, st.ANY.launches]
    assert after == [b + 1 for b in before]
    with pytest.raises(ValueError):  # an active mask on the CPU
        st.trace_closest_sub(subs, o, d, 1e-4, 3.0e38, active.cpu())
    with pytest.raises(TypeError):  # float64 rays
        st.trace_any_sub(subs, Vec3(*(c.double() for c in o)), d, 1e-4, 3.0e38, active)
    # more subclusters than the E' row of shared memory holds at block 512
    ns = 60_000
    wide = lambda: torch.zeros(1, ns, device=dev)
    big = subs._replace(rows=torch.empty(ns, 32, 12, device=dev),
                        count=torch.zeros(ns, dtype=torch.int32, device=dev),
                        lo_x=wide(), lo_y=wide(), lo_z=wide(), hi_x=wide(), hi_y=wide(),
                        hi_z=wide())
    with pytest.raises(NotImplementedError):
        st.trace_closest_sub(big, o, d, 1e-4, 3.0e38, active)
    assert [st.CLOSEST.launches, st.ANY.launches] == after


@pytest.mark.cuda
def test_ad_gradient_on_card_matches_the_replay_gradient(dev):
    """render_pass under autograd on the card (K1, K2 and K2b) against K3b,
    the megakernel's replay gradient, for one adjoint: within 1e-3 of
    max|g|."""
    res = 64
    view = SceneView.build(cornell_box(glossy_boxes=True), cornell_camera(), dev)
    opts = tpt.PTOptions(max_path_length=6)
    leaf = view.mesh.materials.diffuse.stack().detach().clone().requires_grad_(True)
    mats = view.mesh.materials._replace(diffuse=Vec3(leaf[:, 0], leaf[:, 1], leaf[:, 2]))
    v = view._replace(mesh=view.mesh._replace(materials=mats))
    before = gather_mod.GATHER_BWD.launches
    img = tpt.render_pass(v, opts, res, res, 4, 0).composited.stack()
    adjoint = (2.0 * img / img.numel()).detach()
    (img * adjoint).sum().backward()
    torch.cuda.synchronize()
    assert gather_mod.GATHER_BWD.launches > before
    g = pt_mega.render_grad_diffuse_mega(view, opts, res, res, 4, adjoint, 0)
    torch.cuda.synchronize()
    scale = float(g.abs().max())
    assert scale > 0.0
    assert float((leaf.grad - g).abs().max()) <= 1e-3 * scale


def _lit_views(dev):
    """The glossy CornellBox with a blocker panel flagged
    FLAG_SHADOW_DIRECT_IGNORE, an analytic disk and rect, a point and a
    directional light and a 32x64 sky (its direct shadow set: 36 triangles);
    big_room(400) with the clutter flagged FLAG_SHADOW_INDIRECT_IGNORE, the
    sky and a directional sun (its indirect shadow set: the 36-triangle
    room)."""
    from fermat_tpu_torch.scene.lights import DirectionalLightDef
    from fermat_tpu_torch.scene.materials import (FLAG_SHADOW_DIRECT_IGNORE,
                                                  FLAG_SHADOW_INDIRECT_IGNORE, HostMaterial)
    from fermat_tpu_torch.scene.mesh import MeshStorage
    from fermat_tpu_torch.scene.procedural import _quad, big_room_camera

    rng = np.random.default_rng(11)
    sky = (rng.random((32, 64, 3)) * 0.5 + 0.2).astype(np.float32)
    sky[5:7, 8:10] = 60.0
    vs, tris, ids = [], [], []
    _quad(vs, tris, ids, [-0.99, 1.9, 0.99], [0.99, 1.9, 0.99], [0.99, 1.9, -0.99],
          [-0.99, 1.9, -0.99], 0)
    m = HostMaterial("blocker")
    m.diffuse, m.flags = (0.2, 0.2, 0.2), FLAG_SHADOW_DIRECT_IGNORE
    t = np.asarray(tris, np.int32)
    box = cornell_box(glossy_boxes=True).merge(MeshStorage(
        vertices=np.asarray(vs, np.float32), triangles=t, normal_indices=np.full_like(t, -1),
        uv_indices=np.full_like(t, -1), material_ids=np.asarray(ids, np.int32), materials=[m]))
    sun = [DirectionalLightDef((0.25, -0.5, -1.0), (0.8, 0.7, 0.6))]
    cornell = SceneView.build(
        box, cornell_camera(), dev, dir_light_defs=sun, env_map=sky,
        point_light_defs=[((0.3, 1.2, 0.5), (1.5, 1.2, 0.9))],
        area_light_defs=[dict(kind="disk", pos=(-0.45, 1.75, 0.25), normal=(0.15, -1.0, 0.1),
                              color=(6.0, 5.0, 4.0), radius=0.25),
                         dict(kind="rect", pos=(0.45, 1.6, -0.35), normal=(-0.2, -1.0, 0.15),
                              color=(3.0, 4.0, 5.0), u_extent=0.3, v_extent=0.2)])
    room = big_room(400)
    for mat in room.materials:
        if mat.name == "clutter":
            mat.flags = FLAG_SHADOW_INDIRECT_IGNORE
    lit_room = SceneView.build(room, big_room_camera(), dev, dir_light_defs=sun, env_map=sky)
    return cornell, lit_room


@pytest.mark.cuda
def test_shadow_set_tracers_match_plain_on_card(dev):
    """K1b over each shadow set's own soup and K5b over its own cluster
    table, against their plain versions and each other."""
    cornell, room = _lit_views(dev)
    for ss in (cornell.shadow_sets[0], room.shadow_sets[1]):
        assert ss.mesh.n_triangles == 36 and ss.tris.shape == (9, 36)
        o, d, active, tmax = _rays(65536, -1.0, 1.0, dev, seed=13)
        o = Vec3(o.x, o.y + 1.0, o.z)
        n = 65536
        t0 = trace_mod._lanes(0.0, n, dev)
        occ = trace_mod.trace_any(ss.tris, o, d, 0.0, tmax, active)
        occ5 = ft.trace_any_frontier(ss.clusters, o, d, 0.0, tmax, active)
        ref = trace_mod._any_plain(ss.tris, o, d, t0, tmax, active)
        ref5 = ft._any_plain(ss.clusters, o, d, t0, tmax, active)
        torch.cuda.synchronize()
        assert torch.equal(occ, ref) and torch.equal(occ5, ref5) and torch.equal(occ, occ5)
        assert occ.any() and not occ.all()


def _forced_plain(dev):
    """monkeypatch targets that put every kernel's plain version in the pass."""
    from fermat_tpu_torch.accel.traverse import Hit, walk_any, walk_closest
    from fermat_tpu_torch.core import rng as rng_mod
    from fermat_tpu_torch.scene import lights as lights_mod
    from fermat_tpu_torch.scene import mesh as mesh_mod
    from fermat_tpu_torch.scene import mesh_lights as mesh_lights_mod
    from fermat_tpu_torch.scene import textures as textures_mod

    lanes = lambda o, a, b: (trace_mod._lanes(a, o.x.shape[0], dev),
                             trace_mod._lanes(b, o.x.shape[0], dev))

    def closest_frontier(cl, o, d, t0, t1, active=None, with_uv=True):
        t, tri = ft._closest_plain(cl, o, d, *lanes(o, t0, t1), active)
        return Hit(t=t, tri=tri, u=torch.zeros_like(t), v=torch.zeros_like(t))

    return [(tpt, "trace_closest",
             lambda tr, o, d, t0, t1, a=None: trace_mod._closest_plain(tr, o, d,
                                                                      *lanes(o, t0, t1), a)),
            (tpt, "trace_any",
             lambda tr, o, d, t0, t1, a=None: trace_mod._any_plain(tr, o, d,
                                                                  *lanes(o, t0, t1), a)),
            (tpt, "trace_closest_frontier", closest_frontier),
            (tpt, "trace_any_frontier",
             lambda cl, o, d, t0, t1, a=None: ft._any_plain(cl, o, d, *lanes(o, t0, t1), a)),
            (tpt, "trace_closest_bvh",
             lambda b, tr, o, d, t0, t1, a=None: walk_closest(b, tr, o, d,
                                                              *trace_mod._lane_args(o, t0, t1, a))),
            (tpt, "trace_any_bvh",
             lambda b, tr, o, d, t0, t1, a=None: walk_any(b, tr, o, d,
                                                          *trace_mod._lane_args(o, t0, t1, a))),
            (tpt, "cdf_pick_rows", cdf_gather._pick_plain),
            (mesh_mod, "gather_rows", gather_mod._gather_plain),
            (lights_mod, "gather_rows", gather_mod._gather_plain),
            (mesh_lights_mod, "gather_rows", gather_mod._gather_plain),
            (textures_mod, "gather_rows", gather_mod._gather_plain),
            (rng_mod, "gather_rows", gather_mod._gather_plain),
            (trl, "gather_rows", gather_mod._gather_plain)]


@pytest.mark.cuda
@pytest.mark.parametrize("scene,tracer", [("cornell", "auto"), ("big_room400", "auto"),
                                          ("big_room400", "frontier")])
def test_lit_pass_kernels_match_plain_on_card(dev, scene, tracer, monkeypatch):
    """A lit 64x64 pass with the kernels against the same pass with every
    plain version forced: rays equal, every channel bit-equal. big_room with
    tracer="auto" traces its indirect shadow set with K1b, with "frontier"
    with K5b."""
    cornell, room = _lit_views(dev)
    view = cornell if scene == "cornell" else room
    opts = tpt.PTOptions(max_path_length=4, tracer=tracer)
    before = (trace_mod.ANY.launches, ft.ANY.launches)
    got = tpt.render_pass(view, opts, 64, 64, 3, 0)
    torch.cuda.synchronize()
    assert trace_mod.ANY.launches > before[0] or tracer == "frontier"
    for mod, name, value in _forced_plain(dev):
        monkeypatch.setattr(mod, name, value)
    after = (trace_mod.ANY.launches, ft.ANY.launches)
    want = tpt.render_pass(view, opts, 64, 64, 3, 0)
    torch.cuda.synchronize()
    assert (trace_mod.ANY.launches, ft.ANY.launches) == after
    assert float(got.rays) == float(want.rays) and torch.equal(got.tri, want.tri)
    for c in ("composited", "direct", "diffuse", "specular"):
        assert torch.equal(_bits(getattr(got, c).stack()), _bits(getattr(want, c).stack())), c
    assert float(got.composited.stack().mean()) > 0.0


_TEXTURED = {}


def _textured_views(dev, tmp):
    """The glossy CornellBox with write_cornell_textures's seeded 64-texel
    maps (diffuse on the walls and floor, one non-power-of-two; specular on
    the boxes; emissive on the light) and bathroom_standin(400) (4,812
    triangles: the frontier route and the emissive subset) over a seeded
    16-texel material set with one mapped emitter."""
    from fermat_tpu_torch.scene import procedural as proc

    if "cornell" not in _TEXTURED:
        c_dir, b_dir = os.path.join(tmp, "cornell"), os.path.join(tmp, "bath")
        os.makedirs(c_dir)
        names = proc.write_cornell_textures(c_dir, size=64)
        _TEXTURED["cornell"] = SceneView.build(
            proc.set_texture_names(cornell_box(glossy_boxes=True), names), cornell_camera(),
            dev, texture_dir=c_dir)
        proc.write_standin_assets(b_dir, size=16, emitter=True)
        storage, cam, tex_dir = proc.bathroom_standin(400, 3, b_dir)
        _TEXTURED["bathroom"] = SceneView.build(storage, cam, dev, texture_dir=tex_dir)
    return _TEXTURED


@pytest.mark.cuda
@pytest.mark.parametrize("scene,opt", [
    ("cornell", {}), ("cornell", {"texture_filter": "trilinear"}),
    ("cornell", {"sampler": "bluenoise"}), ("bathroom", {}),
    ("bathroom", {"texture_filter": "trilinear", "sampler": "bluenoise"})])
def test_textured_pass_kernels_match_plain_on_card(dev, scene, opt, monkeypatch,
                                                   tmp_path_factory):
    """A textured 64x64 pass with the kernels against the same pass with
    every plain version forced (the atlas's metadata fetch and the blue-noise
    shift table included): rays equal, every channel bit-equal."""
    view = _textured_views(dev, str(tmp_path_factory.mktemp("tex")))[scene]
    assert view.has_textures and bool(view.textured_emitters)
    opts = tpt.PTOptions(max_path_length=4, **opt)
    before = gather_mod.GATHER.launches
    got = tpt.render_pass(view, opts, 64, 64, 3, 0)
    torch.cuda.synchronize()
    assert gather_mod.GATHER.launches > before
    for mod, name, value in _forced_plain(dev):
        monkeypatch.setattr(mod, name, value)
    after = (gather_mod.GATHER.launches, trace_mod.ANY.launches, ft.ANY.launches)
    want = tpt.render_pass(view, opts, 64, 64, 3, 0)
    torch.cuda.synchronize()
    assert (gather_mod.GATHER.launches, trace_mod.ANY.launches, ft.ANY.launches) == after
    assert float(got.rays) == float(want.rays) and torch.equal(got.tri, want.tri)
    for c in ("composited", "direct", "diffuse", "specular", "diffuse_albedo",
              "specular_albedo"):
        assert torch.equal(_bits(getattr(got, c).stack()), _bits(getattr(want, c).stack())), c
    assert float(got.composited.stack().mean()) > 0.0


TEXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                        "torch_port_textures_24.npz")


def _textures_golden(dev):
    """(the golden, its configurations, {scene: its view on the card})."""
    import json

    gz = np.load(TEXTURES)
    views = {}
    for key in {k for k, _ in json.loads(str(gz["configs"])).values()}:
        p = f"{key}.view."
        views[key] = SceneView.from_numpy({k[len(p):]: gz[k] for k in gz.files
                                           if k.startswith(p)}, dev)
    return gz, json.loads(str(gz["configs"])), views


def _golden_opts(gz, configs, name):
    return tpt.PTOptions(lobes=tuple(bool(x) for x in gz[f"{name}.lobes"]),
                         clearcoat=bool(gz[f"{name}.clearcoat"]), **configs[name][1])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["T_A", "T_B", "T_C", "T_D", "T_E"])
def test_textures_golden_on_card(dev, name):
    """tests/golden/torch_port_textures_24.npz (JAX on the CPU) on the
    card's kernel path, within the tolerances of tests/test_torch_pt.py."""
    gz, configs, views = _textures_golden(dev)
    out = tpt.render_pass(views[configs[name][0]], _golden_opts(gz, configs, name),
                          int(gz["res"]), int(gz["res"]), int(gz["instance"]), int(gz["seed"]))
    want = float(gz[f"{name}.rays"])
    assert abs(float(out.rays) - want) <= 0.005 * want
    same = (out.tri.cpu().numpy() == gz[f"{name}.tri"]).mean()
    assert same >= (0.99 if name == "T_D" else 1.0), same
    for c in ("composited", "direct", "diffuse", "specular"):
        ref = torch.from_numpy(gz[f"{name}.{c}"].reshape(-1, 3)).to(dev)
        assert _image_ok(getattr(out, c).stack().T, ref.T), c


def _first_hit_uv(uv, hit):
    """scene.mesh._shade with bounce 0's uv replaced by `uv` (N, 2) on the
    lanes where `hit` is set (tests/test_torch_textures.first_hit_uv)."""
    import fermat_tpu_torch.scene.mesh as mesh_mod

    orig, calls = mesh_mod._shade, []

    def shade(r, u, v):
        sh = orig(r, u, v)
        calls.append(r.shape[0])
        if len(calls) > 1:
            return sh
        assert r.shape[0] == uv.shape[0]
        return sh._replace(uv=torch.where(hit[:, None], uv, sh.uv))

    return shade


@pytest.mark.cuda
@pytest.mark.parametrize("name,leaf,at_jax_uv", [("T_C", "texels", True),
                                                 ("C2", "texels", False),
                                                 ("E", "emissive", False)])
def test_textures_golden_grads_on_card(dev, name, leaf, at_jax_uv, monkeypatch):
    """The golden's jax.grad of the mean image with respect to the texels of
    T_C and C2 (the atlas's _replace, autograd's scatter-add of the texel
    fetches) and to E's (M, 3) emissive (the light table rebuilt on the card
    from it), within 1e-5 of max|g|. T_C's is taken at JAX's first-hit uv,
    as on the CPU (tests/test_torch_textures.py says why)."""
    import fermat_tpu_torch.scene.mesh as mesh_mod
    from fermat_tpu_torch.scene.lights import MeshLightsView

    gz, configs, views = _textures_golden(dev)
    view = views[configs[name][0]]
    if at_jax_uv:
        monkeypatch.setattr(mesh_mod, "_shade", _first_hit_uv(
            torch.from_numpy(gz[f"{name}.uv"].reshape(-1, 2)).to(dev),
            torch.from_numpy(gz[f"{name}.tri"] >= 0).to(dev)))
    if leaf == "texels":
        x = view.textures.texels.detach().clone().requires_grad_(True)
        view = view._replace(textures=view.textures._replace(texels=x))
    else:
        x = view.mesh.materials.emissive.stack().detach().clone().requires_grad_(True)
        mesh = view.mesh._replace(materials=view.mesh.materials._replace(
            emissive=Vec3(x[:, 0], x[:, 1], x[:, 2])))
        view = view._replace(mesh=mesh, lights=MeshLightsView.build_on_device(mesh))
    res = int(gz["res"])
    tpt.render_pass(view, _golden_opts(gz, configs, name), res, res, int(gz["instance"]),
                    int(gz["seed"])).composited.stack().mean().backward()
    want = gz[f"{name}.grad.{leaf}"]
    assert np.abs(x.grad.cpu().numpy() - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.cuda
def test_bluenoise_sequence_on_card_equals_cpu(dev):
    """sample_1d/2d/3d of the blue-noise sequence on 2^20 lanes (its shift
    table through K2) equal the CPU's bit for bit."""
    from fermat_tpu_torch.core.rng import BlueNoiseSequence

    seq = BlueNoiseSequence.create(seed=3, instance=7, res_x=1024)
    pix = torch.arange(1 << 20, dtype=torch.int64)
    before = gather_mod.GATHER.launches
    for dim in (0, 5, 18):
        got, want = seq.sample_3d(pix.to(dev), dim), seq.sample_3d(pix, dim)
        for a, b in zip(got, want):
            assert torch.equal(_bits(a.cpu()), _bits(b))
    assert gather_mod.GATHER.launches == before + 3


# ---- the BVH walk and the remaining PT options ----

_BVH_SCENES = {}


def _bvh_scene(dev, scene):
    """(mesh view, BVH) of the CornellBox, random_soup(5000) or big_room(400)."""
    from fermat_tpu_torch.accel.bvh import build_bvh_for_mesh

    if scene not in _BVH_SCENES:
        storage = {"cornell": lambda: cornell_box(glossy_boxes=True),
                   "soup5000": lambda: random_soup(5000),
                   "big_room400": lambda: big_room(400)}[scene]()
        mesh = storage.device_view(dev)
        _BVH_SCENES[scene] = (mesh, build_bvh_for_mesh(mesh))
    return _BVH_SCENES[scene]


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["cornell", "soup5000", "big_room400"])
def test_bvh_kernels_match_plain_on_card(dev, scene):
    """csrc/bvh.cu against the plain lockstep walk on 65,536 random rays, a
    tenth of them inactive: t, u, v bit-equal, tri and occlusion equal; one
    launch a call."""
    from fermat_tpu_torch.accel.traverse import walk_any, walk_closest

    mesh, bvh = _bvh_scene(dev, scene)
    tris = mesh.tri_soup()
    o, d, active, tmax = _rays(65536, -1.0, 1.0, dev, seed=7)
    if scene != "soup5000":
        o = Vec3(o.x, o.y + 1.0, o.z)
    n = o.x.shape[0]
    before = (bvh_trace.CLOSEST.launches, bvh_trace.ANY.launches)
    hit = bvh_trace.trace_closest_bvh(bvh, tris, o, d, 1e-4, 3.0e38, active)
    occ = bvh_trace.trace_any_bvh(bvh, tris, o, d, 1e-4, tmax, active)
    torch.cuda.synchronize()
    assert (bvh_trace.CLOSEST.launches, bvh_trace.ANY.launches) == (before[0] + 1, before[1] + 1)
    t0, t1 = trace_mod._lanes(1e-4, n, dev), trace_mod._lanes(3.0e38, n, dev)
    ref = walk_closest(bvh, tris, o, d, t0, t1, active)
    ref_occ = walk_any(bvh, tris, o, d, t0, tmax, active)
    assert torch.equal(hit.tri, ref.tri) and int((hit.tri >= 0).sum()) > n // 10
    for a, b in ((hit.t, ref.t), (hit.u, ref.u), (hit.v, ref.v)):
        assert torch.equal(_bits(a), _bits(b))
    assert torch.equal(occ, ref_occ)
    # the dense tracer's answer where the scene is small enough for it: the
    # same t on every ray; another triangle only where two tie in t (the walk
    # takes the first it visits, K1a the lower id)
    if scene == "cornell":
        dense = trace_mod.trace_closest(tris, o, d, 1e-4, 3.0e38, active)
        torch.cuda.synchronize()
        assert torch.equal(_bits(dense.t), _bits(hit.t))
        assert (dense.tri == hit.tri).float().mean() > 0.99


@pytest.mark.cuda
def test_bvh_wrappers_reject_bad_input(dev):
    mesh, bvh = _bvh_scene(dev, "cornell")
    o, d, active, _ = _rays(1024, -1.0, 1.0, dev, seed=8)
    with pytest.raises(ValueError):
        bvh_trace.trace_closest_bvh(bvh, mesh.tri_soup().cpu(), o, d, 1e-4, 1.0, active)
    with pytest.raises(ValueError):
        bvh_trace.trace_any_bvh(bvh, mesh.tri_soup()[:8].contiguous(), o, d, 1e-4, 1.0, active)


_OPTION_CELLS = [{"nee": "vpl"}, {"glossy_model": "ltc"}, {"queue_compaction": True},
                 {"detach_nee": True}, {"detach_emissive": True},
                 {"debug_nee_no_shadow": True}, {"debug_nee_fixed_light": True},
                 {"debug_nee_cheap_eval": True}, {"tracer": "bvh"}]


@pytest.mark.cuda
@pytest.mark.parametrize("opt", _OPTION_CELLS, ids=lambda o: "-".join(f"{k}={v}"
                                                                   for k, v in o.items()))
def test_options_pass_kernels_match_plain_on_card(dev, opt, monkeypatch):
    """A 64x64 CornellBox pass under each ported option with the kernels
    against the same pass with every plain version forced (the BVH walk's
    and the VPL pick's included): rays equal, every channel bit-equal; the
    compaction pass also bit-equal to the masked one."""
    view = SceneView.build(cornell_box(glossy_boxes=True), cornell_camera(), dev)
    if opt.get("tracer") == "bvh":
        view = view.with_bvh()
    opts = tpt.PTOptions(max_path_length=4, **opt)
    launches = lambda: (trace_mod.CLOSEST.launches, trace_mod.ANY.launches,
                        bvh_trace.CLOSEST.launches, bvh_trace.ANY.launches,
                        gather_mod.GATHER.launches)
    before = launches()
    got = tpt.render_pass(view, opts, 64, 64, 3, 0)
    torch.cuda.synchronize()
    moved = [b - a for a, b in zip(before, launches())]
    if opt.get("tracer") == "bvh":
        assert moved[:4] == [0, 0, 4, 4], moved
    else:
        n_any = 0 if opt.get("debug_nee_no_shadow") else 4
        assert moved[:4] == [4, n_any, 0, 0], moved
    if "queue_compaction" in opt:
        masked = tpt.render_pass(view, opts._replace(queue_compaction=False), 64, 64, 3, 0)
        for c in ("composited", "direct", "diffuse", "specular"):
            assert torch.equal(_bits(getattr(got, c).stack()), _bits(getattr(masked, c).stack()))
    for mod, name, value in _forced_plain(dev):
        monkeypatch.setattr(mod, name, value)
    after = launches()
    want = tpt.render_pass(view, opts, 64, 64, 3, 0)
    torch.cuda.synchronize()
    assert launches() == after
    assert float(got.rays) == float(want.rays) and torch.equal(got.tri, want.tri)
    for c in ("composited", "direct", "diffuse", "specular"):
        assert torch.equal(_bits(getattr(got, c).stack()), _bits(getattr(want, c).stack())), c
    assert float(got.composited.stack().mean()) > 0.0


OPTIONS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                       "torch_port_options_24.npz")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["vpl", "ltc", "compact", "no_shadow", "fixed_light",
                                  "cheap_eval"])
def test_options_golden_on_card(dev, name):
    """tests/golden/torch_port_options_24.npz (JAX on the CPU) on the card's
    kernel path, within the tolerances of tests/test_torch_pt.py."""
    import json

    gz = np.load(OPTIONS)
    view = SceneView.from_numpy({k[5:]: gz[k] for k in gz.files if k.startswith("view.")}, dev)
    opts = tpt.PTOptions(lobes=tuple(bool(x) for x in gz["lobes"]),
                         clearcoat=bool(gz["clearcoat"]), max_path_length=int(gz["max_path_length"]),
                         **json.loads(str(gz["passes"]))[name])
    res = int(gz["res"])
    out = tpt.render_pass(view, opts, res, res, int(gz["instance"]), int(gz["seed"]))
    want = float(gz[f"{name}.rays"])
    assert abs(float(out.rays) - want) <= 0.005 * want
    assert (out.tri.cpu().numpy() == gz[f"{name}.tri"].ravel()).all()
    for c in ("composited", "direct", "diffuse", "specular"):
        ref = torch.from_numpy(gz[f"{name}.{c}"].reshape(-1, 3)).to(dev)
        assert _image_ok(getattr(out, c).stack().T, ref.T), c


@pytest.mark.cuda
def test_bvh_pass_on_card_matches_the_frontier_golden(dev):
    """tracer="bvh" on big_room(400) over JAX's tree on the card against the
    stored frontier pass (tests/test_torch_bvh.py's check)."""
    gz = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                              "torch_port_bigroom_24.npz"))
    view = SceneView.from_numpy({k[5:]: gz[k] for k in gz.files if k.startswith("view.")}, dev)
    res = int(gz["res"])
    opts = tpt.PTOptions(max_path_length=int(gz["max_path_length"]), tracer="bvh",
                         lobes=tuple(bool(x) for x in gz["lobes"]))
    before = bvh_trace.CLOSEST.launches
    out = tpt.render_pass(view, opts, res, res, int(gz["instance"]), int(gz["seed"]))
    torch.cuda.synchronize()
    assert bvh_trace.CLOSEST.launches == before + opts.max_path_length
    assert abs(float(out.rays) - float(gz["rays"])) <= 0.005 * float(gz["rays"])
    assert (out.tri.cpu().numpy() == gz["tri"].ravel()).mean() >= 0.99
    for c in ("composited", "direct", "diffuse", "specular"):
        ref = torch.from_numpy(gz[c].reshape(-1, 3)).to(dev)
        assert _image_ok(getattr(out, c).stack().T, ref.T), c


BPT_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                          "torch_port_bpt_24.npz")


def _bpt_launches():
    return (trace_mod.CLOSEST.launches, trace_mod.ANY.launches, ft.CLOSEST.launches,
            ft.ANY.launches, gather_mod.GATHER.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["cornell", "big_room400"])
def test_bpt_pass_kernels_match_plain_on_card(dev, scene, monkeypatch):
    """A BPT pass (max_path_length 4, light tracing on) with the kernels
    against the same pass with every plain version forced: rays equal, the
    eye radiance bit-equal, the splat image (index_add_, no fixed order)
    within 1e-5 of its max; 6 closest and 7 shadow launches a pass (one
    light-tracing launch, 3 NEE and 3 connection launches over the slots)."""
    from fermat_tpu_torch.integrators import bpt
    from fermat_tpu_torch.scene.procedural import big_room_camera

    if scene == "cornell":
        view, res = SceneView.build(cornell_box(glossy_boxes=True), cornell_camera(), dev), 64
    else:
        view, res = SceneView.build(big_room(400), big_room_camera(), dev), 48
    opts = bpt.BPTOptions(max_path_length=4)
    before = _bpt_launches()
    got = bpt.render_pass(view, opts, res, res, 3, 0)
    torch.cuda.synchronize()
    moved = [b - a for a, b in zip(before, _bpt_launches())]
    assert moved[:4] == ([6, 7, 0, 0] if scene == "cornell" else [0, 0, 6, 7]), moved
    assert moved[4] > 0
    for mod, name, value in _forced_plain(dev):
        monkeypatch.setattr(mod, name, value)
    after = _bpt_launches()
    want = bpt.render_pass(view, opts, res, res, 3, 0)
    torch.cuda.synchronize()
    assert _bpt_launches() == after
    assert float(got[2]) == float(want[2])
    assert torch.equal(_bits(got[0].stack()), _bits(want[0].stack()))
    assert float((got[1] - want[1]).abs().max()) <= 1e-5 * float(want[1].abs().max())
    assert float(got[0].stack().mean()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("space", ["bpt", "pt"])
def test_pssmlt_step_kernels_match_plain_on_card(dev, space, monkeypatch):
    """A PSSMLT seed pass and one step at 32x32 with the kernels against the
    same step with every plain version forced: the chain state (u, i_lum,
    pixel, key) bit-equal, the splat within 1e-5 of its max."""
    from fermat_tpu_torch.integrators import pssmlt as ps

    view = SceneView.build(cornell_box(glossy_boxes=True), cornell_camera(), dev)
    opts = ps.PssmltOptions(max_path_length=4, n_seed_candidates=2, path_space=space)
    s0 = ps.init_state(view, opts, 32, 32, 1024, 0)
    before = _bpt_launches()
    s1, splat = ps.step(view, opts, 32, 32, s0)
    torch.cuda.synchronize()
    assert _bpt_launches()[0] == before[0] + (6 if space == "bpt" else 4)
    for mod, name, value in _forced_plain(dev):
        monkeypatch.setattr(mod, name, value)
    s1p, splat_p = ps.step(view, opts, 32, 32, s0)
    torch.cuda.synchronize()
    assert torch.equal(_bits(s1.u), _bits(s1p.u)) and torch.equal(_bits(s1.i_lum),
                                                                   _bits(s1p.i_lum))
    assert torch.equal(s1.pixel, s1p.pixel) and s1.key == s1p.key
    assert float((splat - splat_p).abs().max()) <= 1e-5 * float(splat_p.abs().max())
    assert float(splat.sum()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("name,tracer", [("A", "auto"), ("A_nolt", "auto"), ("panel", "auto"),
                                         ("env", "auto"), ("tex", "auto"),
                                         ("big_room", "auto"), ("big_room", "bvh")])
def test_bpt_golden_on_card(dev, name, tracer):
    """tests/golden/torch_port_bpt_24.npz (JAX on the CPU) on the card's
    kernel path, within the tolerances of tests/test_torch_pt.py."""
    import json

    from fermat_tpu_torch.integrators import bpt

    gz = np.load(BPT_GOLDEN)
    if name == "big_room":
        bz = np.load(os.path.join(os.path.dirname(BPT_GOLDEN), "torch_port_bigroom_24.npz"))
        arrays, key, fields, res = ({k[5:]: bz[k] for k in bz.files if k.startswith("view.")},
                                    "big_room", {}, int(gz["big_res"]))
    else:
        key, fields = json.loads(str(gz["cases"]))[name]
        p = f"{key}.view."
        arrays, res = {k[len(p):]: gz[k] for k in gz.files if k.startswith(p)}, int(gz["res"])
    view = SceneView.from_numpy(arrays, dev)
    opts = bpt.BPTOptions(max_path_length=int(gz["max_path_length"]), tracer=tracer,
                          lobes=tuple(bool(x) for x in gz[f"{key}.lobes"]), **fields)
    rad, splat, rays, _ = bpt.render_pass(view, opts, res, res, int(gz["instance"]),
                                          int(gz["seed"]))
    want = float(gz[f"{name}.rays"])
    assert abs(float(rays) - want) <= 0.005 * want
    for got, part in ((rad.stack(), "rad"), (splat, "splat")):
        ref = torch.from_numpy(gz[f"{name}.{part}"]).to(dev)
        if ref.any():
            assert _image_ok(got.T, ref.T), part
        else:
            assert not got.any(), part


@pytest.mark.cuda
@pytest.mark.parametrize("space", ["bpt", "pt"])
def test_pssmlt_golden_step_on_card(dev, space):
    """One step from JAX's stored chain state on the card: the same
    acceptance on >= 99% of chains, the splat within the image tolerance."""
    from fermat_tpu_torch.integrators import pssmlt as ps

    gz = np.load(BPT_GOLDEN)
    view = SceneView.from_numpy({k[7:]: gz[k] for k in gz.files if k.startswith("A.view.")},
                                dev)
    opts = ps.PssmltOptions(max_path_length=int(gz["ps_max_path_length"]),
                            n_seed_candidates=int(gz["ps_seed_candidates"]), path_space=space)
    p = f"ps_{space}."
    t = lambda k: torch.from_numpy(gz[p + k]).to(dev)
    s0 = ps.PssmltState(u=t("init.u"), i_lum=t("init.i_lum"), contrib=t("init.contrib"),
                        pixel=t("init.pixel"), brightness=t("init.brightness"),
                        key=int(gz[p + "init.key"]))
    res = int(gz["ps_res"])
    s1, splat = ps.step(view, opts, res, res, s0)
    # a chain that accepts holds its proposal, which rounds apart from JAX's
    took = (s1.u == ps._mutate(s0.u, ps.hash_combine(s0.key, 0x1234567), opts)).all(dim=1)
    want = (t("step.u") == t("u_prop")).all(dim=1)
    assert float((took == want).float().mean()) >= 0.99
    assert _image_ok(splat.T, t("splat").T)


@pytest.mark.cuda
def test_bpt_and_pssmlt_render_through_the_context_on_card(dev):
    """RenderingContext's "bpt" and "pssmlt" default to the card and launch
    the dense kernels there."""
    from fermat_tpu_torch.render.context import RenderingContext

    for renderer in ("bpt", "pssmlt"):
        ctx = RenderingContext.create(cornell_box(glossy_boxes=True), cornell_camera(), 32, 32,
                                      renderer=renderer, max_path_length=3,
                                      **({"n_seed_candidates": 1} if renderer == "pssmlt" else {}))
        assert ctx.device.type == "cuda"
        before = trace_mod.CLOSEST.launches
        ctx.render(2)
        assert trace_mod.CLOSEST.launches > before
        img = ctx.hdr_image()
        assert np.isfinite(img).all() and img.mean() > 0.0


PSF_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                          "torch_port_psf_24.npz")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [64, 1 << 18])
def test_deposit_owners_on_card_equal_the_cpu(dev, k):
    """The hash's ownership write with many duplicate slots: the owner
    table on the card equals the CPU's bit for bit (the highest lane
    writing a slot wins, an invalid lane writes slot 0's old key back),
    and so do the weights; the sums (index_add_, no fixed order on the
    card) within 1e-5 of their max."""
    from fermat_tpu_torch.scene.spatial_hash import HashAccumulator

    g = torch.Generator().manual_seed(k)
    n = 200_000
    key = torch.randint(1, 5000, (n,), generator=g, dtype=torch.int64) * 2654435761 % (1 << 32)
    key = key.clamp_min(1)
    slot = (key % k).to(torch.int32)
    valid = torch.rand(n, generator=g) < 0.6
    vals = [torch.rand(n, generator=g) for _ in range(3)]
    old = torch.randint(0, 1 << 32, (k,), generator=g, dtype=torch.int64)
    sums = [torch.rand(k, generator=g) for _ in range(4)]
    cpu = HashAccumulator(*sums, old).deposit(slot, key, *vals, valid)
    card = HashAccumulator(*(a.to(dev) for a in (*sums, old))).deposit(
        slot.to(dev), key.to(dev), *(v.to(dev) for v in vals), valid.to(dev))
    torch.cuda.synchronize()
    assert torch.equal(card.key.cpu(), cpu.key) and int((cpu.key != old).sum()) > 0
    assert torch.equal(_bits(card.weight.cpu()), _bits(cpu.weight))
    for f in ("sum_x", "sum_y", "sum_z"):
        a, b = getattr(card, f).cpu(), getattr(cpu, f)
        assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("renderer,scene", [("psfpt", "cornell"), ("psfpt", "big_room400"),
                                            ("ptrl", "cornell"), ("ptrl", "big_room400"),
                                            ("ptrl_tri", "cornell")])
def test_psf_passes_kernels_match_plain_on_card(dev, renderer, scene, monkeypatch):
    """Two passes of psfpt or ptrl (max_path_length 4) with the kernels, then
    the third pass from their state with the kernels and with every plain
    version forced: rays equal; psfpt's PSF slots and keys, owner table and
    weights bit-equal, its cell sums and image within 1e-5 of their max
    (index_add_ adds in no fixed order); ptrl's image bit-equal (Q is fixed
    within a pass), its new Q within 1e-5 of max."""
    from fermat_tpu_torch.integrators import psfpt, ptrl
    from fermat_tpu_torch.scene.procedural import big_room_camera

    if scene == "cornell":
        view, res = SceneView.build(cornell_box(glossy_boxes=True), cornell_camera(), dev), 64
    else:
        view, res = SceneView.build(big_room(400), big_room_camera(), dev), 48
    frontier = scene != "cornell"
    closest = ft.CLOSEST if frontier else trace_mod.CLOSEST
    if renderer == "psfpt":
        opts = psfpt.PsfptOptions(max_path_length=4, table_size=4096)
        state = psfpt.init_state(view, opts)
        for i in range(2):
            state = psfpt.render_pass(view, opts, res, res, i, state)[1]
        run = lambda: psfpt.render_pass(view, opts, res, res, 2, state, with_psf=True)
    else:
        opts = ptrl.PtrlOptions(max_path_length=4, table_size=1024,
                                sampler="tri" if renderer == "ptrl_tri" else "vtl")
        state = ptrl.start(view, opts)
        for i in range(2):
            state = ptrl.step(view, opts, state, res, res, i)[3]
        run = lambda: ptrl.render_pass(view, opts, state.clusters, res, res, 2, state.state)
    before = closest.launches
    got = run()
    torch.cuda.synchronize()
    assert closest.launches == before + 4
    for mod, name, value in _forced_plain(dev):
        monkeypatch.setattr(mod, name, value)
    after = _bpt_launches()
    want = run()
    torch.cuda.synchronize()
    assert _bpt_launches() == after
    assert float(got[2]) == float(want[2])
    of_max = lambda a, b: float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    if renderer == "psfpt":
        assert all(torch.equal(a, b) for a, b in zip(got[4], want[4])) and bool(got[4].has.any())
        cg, cw = got[1].cells, want[1].cells
        assert torch.equal(cg.key, cw.key) and torch.equal(_bits(cg.weight), _bits(cw.weight))
        assert all(of_max(getattr(cg, f), getattr(cw, f)) for f in ("sum_x", "sum_y", "sum_z"))
        assert of_max(got[0].stack(), want[0].stack())
    else:
        assert torch.equal(_bits(got[0].stack()), _bits(want[0].stack()))
        assert of_max(got[1].qstate.q, want[1].qstate.q)
    assert float(got[0].stack().mean()) > 0.0


def _psf_cases():
    import json

    gz = np.load(PSF_GOLDEN)
    return [(n, t) for n, c in json.loads(str(gz["cases"])).items()
            for t in (("auto", "bvh") if c[0] == "big_room" else ("auto",))]


@pytest.mark.cuda
@pytest.mark.parametrize("name,tracer", _psf_cases())
def test_psf_golden_on_card(dev, name, tracer):
    """tests/golden/torch_port_psf_24.npz (JAX on the CPU) on the card's
    kernel path: pass 1 from a fresh state and pass k+1 from JAX's state
    after pass k (big_room through the BVH walk: pass 1), within the
    tolerances of tests/test_torch_psf.py (the rays within 0.5% on big_room,
    where coplanar triangles tie; the VTL cut equal to JAX's)."""
    import json

    from fermat_tpu_torch.integrators import psfpt, ptrl
    from fermat_tpu_torch.scene.mesh_lights import VTLView
    from fermat_tpu_torch.scene.spatial_hash import HashAccumulator

    gz = np.load(PSF_GOLDEN)
    scene, renderer, fields, passes = json.loads(str(gz["cases"]))[name]
    big = scene == "big_room"
    if big:
        z, p, res = np.load(os.path.join(os.path.dirname(PSF_GOLDEN),
                                         "torch_port_bigroom_24.npz")), "view.", int(gz["big_res"])
    else:
        z, p, res = gz, f"{scene}.view.", int(gz["res"])
    view = SceneView.from_numpy({k[len(p):]: z[k] for k in z.files if k.startswith(p)}, dev)
    lobes = tuple(bool(x) for x in gz[f"{scene}.lobes"])
    t = lambda k: torch.from_numpy(gz[k]).to(dev)
    for k in range(1 if tracer == "bvh" else passes):
        if renderer == "psfpt":
            opts = psfpt.PsfptOptions(lobes=lobes, tracer=tracer, **fields)
            state = (psfpt.init_state(view, opts) if k == 0 else psfpt.PsfptState(
                HashAccumulator.from_numpy(*(gz[f"{name}.{k}.cells.{f}"] for f in (
                    "sum_x", "sum_y", "sum_z", "weight", "key")), dev)))
            img, state, rays, _ = psfpt.render_pass(view, opts, res, res, k, state,
                                                    int(gz["seed"]))
            keys = gz[f"{name}.{k + 1}.cells.key"].astype(np.int64)
            assert (state.cells.key.cpu().numpy() == keys).mean() >= 0.999
        else:
            opts = ptrl.PtrlOptions(lobes=lobes, tracer=tracer, **fields)
            run = ptrl.start(view, opts)
            if k:
                if run.cut is not None:
                    run.cut.cut = list(gz[f"{name}.{k}.cut"])
                    run = run._replace(clusters=VTLView.from_numpy(
                        {f: gz[f"{name}.{k}.vtl.{f}"] for f in VTLView._fields[:-1]},
                        opts.n_clusters, dev))
                run = run._replace(state=ptrl.PtrlState(trl.RLState(t(f"{name}.{k}.q"))),
                                   passes=k)
            elif f"{name}.q0" in gz.files:
                run = run._replace(state=ptrl.PtrlState(trl.RLState(t(f"{name}.q0"))))
            img, rays, _, run = ptrl.step(view, opts, run, res, res, k, int(gz["seed"]))
            if run.cut is not None:
                assert run.cut.cut == list(gz[f"{name}.{k + 1}.cut"])
        want = float(gz[f"{name}.{k + 1}.rays"])
        assert float(rays) == want or (big and abs(float(rays) - want) <= 0.005 * want)
        assert _image_ok(img.stack().T, t(f"{name}.{k + 1}.img").T), k


@pytest.mark.cuda
def test_psfpt_and_ptrl_render_through_the_context_on_card(dev):
    """RenderingContext's "psfpt" and "ptrl" default to the card, launch the
    dense kernels there and carry their state from pass to pass."""
    from fermat_tpu_torch.render.context import RenderingContext

    for renderer in ("psfpt", "ptrl"):
        ctx = RenderingContext.create(cornell_box(glossy_boxes=True), cornell_camera(), 32, 32,
                                      renderer=renderer, max_path_length=3)
        assert ctx.device.type == "cuda"
        before = trace_mod.CLOSEST.launches
        ctx.render(2)
        assert trace_mod.CLOSEST.launches == before + 6
        assert ctx.renderer_state is not None
        img = ctx.hdr_image()
        assert np.isfinite(img).all() and img.mean() > 0.0


MLT_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                          "torch_port_mlt_24.npz")


def _mcmc_view(scene, dev):
    from fermat_tpu_torch.scene.procedural import big_room_camera

    if scene == "cornell":
        return SceneView.build(cornell_box(glossy_boxes=True), cornell_camera(), dev), 48
    return SceneView.build(big_room(400), big_room_camera(), dev), 32


def _states_equal(a, b) -> bool:
    """Two chain states bit for bit (floats by their bits)."""
    for x, y in zip(a, b):
        if isinstance(x, torch.Tensor):
            if x.dtype == torch.float32:
                x, y = _bits(x), _bits(y)
            if not torch.equal(x, y):
                return False
        elif x != y:
            return False
    return True


def _splat_close(a, b) -> bool:
    return float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["cornell", "big_room400"])
def test_mlt_steps_kernels_match_plain_on_card(dev, scene, monkeypatch):
    """An MLT presample and steps 0-3 (max_path_length 4; step 3 an ST
    swap) with the kernels, then with every plain version forced: each
    chain state bit-equal, the rays equal, each step's splat (index_add_,
    no fixed order) within 1e-5 of its max; 2 + 4 closest and 6 shadow
    launches in the presample, 4 + 2 + 1 closest and 1 shadow launch a
    perturbation step, none in the swap."""
    from fermat_tpu_torch.integrators import mlt

    view, res = _mcmc_view(scene, dev)
    opts = mlt.MLTOptions(max_path_length=4, steps_per_pass=4)

    def run():
        st, rays = mlt.presample(view, opts, res, res, 2, 0)
        states, splats, n_rays = [st], [], [float(rays)]
        for k in range(opts.steps_per_pass):
            st, sp, r = mlt.step(view, opts, res, res, 2, 0, st, k)
            states.append(st)
            splats.append(sp)
            n_rays.append(float(r))
        return states, splats, n_rays

    before = _bpt_launches()
    got = run()
    torch.cuda.synchronize()
    moved = [b - a for a, b in zip(before, _bpt_launches())]
    want_moved = [6 + 3 * 7, 6 + 3]
    assert moved[:4] == (want_moved + [0, 0] if scene == "cornell" else [0, 0] + want_moved)
    assert moved[4] > 0
    for mod, name, value in _forced_plain(dev):
        monkeypatch.setattr(mod, name, value)
    after = _bpt_launches()
    want = run()
    torch.cuda.synchronize()
    assert _bpt_launches() == after
    assert got[2] == want[2] and got[2][4] == 0.0
    assert all(_states_equal(a, b) for a, b in zip(got[0], want[0]))
    assert all(_splat_close(a, b) for a, b in zip(got[1], want[1]))
    assert float(got[1][1].sum()) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["cornell", "big_room400"])
def test_cmlt_steps_kernels_match_plain_on_card(dev, scene, monkeypatch):
    """CMLT's init_state (max_path_length 4, two seed rounds) and three
    steps (step 2 a chart swap) with the kernels, then with every plain
    version forced: the states bit-equal, the rays equal, the splats within
    1e-5 of their max."""
    from fermat_tpu_torch.integrators import cmlt

    view, res = _mcmc_view(scene, dev)
    opts = cmlt.CMLTOptions(max_path_length=4, n_seed_rounds=2)

    def run():
        st = cmlt.init_state(view, opts, res, res, res * res, 0)
        states, splats, n_rays = [st], [], []
        for _ in range(3):
            st, sp, r = cmlt.step(view, opts, res, res, st)
            states.append(st)
            splats.append(sp)
            n_rays.append(float(r))
        return states, splats, n_rays

    got = run()
    for mod, name, value in _forced_plain(dev):
        monkeypatch.setattr(mod, name, value)
    after = _bpt_launches()
    want = run()
    torch.cuda.synchronize()
    assert _bpt_launches() == after
    assert got[2] == want[2]
    assert all(_states_equal(a, b) for a, b in zip(got[0], want[0]))
    assert all(_splat_close(a, b) for a, b in zip(got[1], want[1]))
    assert float(got[1][0].sum()) > 0.0


def _mlt_cases():
    import json

    return list(json.loads(str(np.load(MLT_GOLDEN)["cases"])))


def _moved_chains(new, old):
    out = None
    for x, y in zip(new, old):
        if isinstance(x, torch.Tensor) and x.ndim:
            m = (x != y).reshape(x.shape[0], -1).any(dim=1)
            out = m if out is None else out | m
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", _mlt_cases())
def test_mlt_golden_on_card(dev, name):
    """tests/golden/torch_port_mlt_24.npz (JAX on the CPU) on the card's
    kernel path: the seeded chains' integer fields equal on >= 99% of
    chains, and each step from JAX's stored state the same accept decision
    on >= 99% of chains, its splat within the image tolerance and its rays
    within 0.5% (tests/test_torch_mlt.py's tolerances)."""
    import json

    from fermat_tpu_torch.integrators import cmlt, mlt

    gz = np.load(MLT_GOLDEN)
    scene, renderer, fields = json.loads(str(gz["cases"]))[name]
    if scene == "big_room":
        z, p, res = np.load(os.path.join(os.path.dirname(MLT_GOLDEN),
                                         "torch_port_bigroom_24.npz")), "view.", int(gz["big_res"])
    else:
        z, p, res = gz, f"{scene}.view.", int(gz["res"])
    view = SceneView.from_numpy({k[len(p):]: z[k] for k in z.files if k.startswith(p)}, dev)
    lobes = tuple(bool(x) for x in gz[f"{scene}.lobes"])
    seed = int(gz["seed"])
    if renderer == "mlt":
        opts, cls = mlt.MLTOptions(lobes=lobes, **fields), mlt.ChainState
        state = mlt.presample(view, opts, res, res, 0, seed)[0]
        n_steps = opts.steps_per_pass
    else:
        opts, cls = cmlt.CMLTOptions(lobes=lobes, **fields), cmlt.CMLTState
        state = cmlt.init_state(view, opts, res, res, res * res, seed)
        n_steps = 3
    load = lambda k: cls.from_numpy({f: gz[f"{name}.{k}.{f}"] for f in cls._fields}, dev)
    for x, y in zip(state, load(0)):
        if isinstance(x, torch.Tensor) and x.dtype in (torch.int32, torch.int64, torch.bool):
            assert float((x == y).reshape(x.shape[0], -1).all(dim=1).float().mean()) >= 0.99
    for k in range(n_steps):
        old = load(k)
        if renderer == "mlt":
            new, splat, rays = mlt.step(view, opts, res, res, 0, seed, old, k)
        else:
            new, splat, rays = cmlt.step(view, opts, res, res, old)
        same = (_moved_chains(new, old) == _moved_chains(load(k + 1), old)).float().mean()
        assert float(same) >= 0.99, k
        assert _image_ok(splat.T, torch.from_numpy(gz[f"{name}.{k + 1}.splat"]).to(dev).T), k
        want = float(gz[f"{name}.{k + 1}.rays"])
        assert abs(float(rays) - want) <= 0.005 * want, k


@pytest.mark.cuda
def test_mlt_and_cmlt_render_through_the_context_on_card(dev):
    """RenderingContext's "mlt" and "cmlt" default to the card, launch the
    dense kernels there, and cmlt carries its chains from pass to pass."""
    from fermat_tpu_torch.render.context import RenderingContext

    for renderer, kw in (("mlt", {"steps_per_pass": 4}), ("cmlt", {"n_seed_rounds": 1})):
        ctx = RenderingContext.create(cornell_box(glossy_boxes=True), cornell_camera(), 32, 32,
                                      renderer=renderer, max_path_length=3, **kw)
        assert ctx.device.type == "cuda"
        before = trace_mod.CLOSEST.launches
        ctx.render(2)
        assert trace_mod.CLOSEST.launches > before
        assert (ctx.renderer_state is not None) == (renderer == "cmlt")
        img = ctx.hdr_image()
        assert np.isfinite(img).all() and img.mean() > 0.0


@pytest.mark.cuda
def test_direct_env_image_on_card_matches_plain(dev, monkeypatch):
    """pt.direct_env_image on the env-lit floor of tests/test_torch_mlt.py:
    one K1a launch, n rays, the image bit-equal to the same call with the
    plain versions forced and within 1e-5 of the CPU's on >= 99% of pixels;
    and mlt and cmlt
    render the floor through the context with it."""
    from fermat_tpu_torch.core.camera import Camera
    from fermat_tpu_torch.render.context import RenderingContext
    from fermat_tpu_torch.scene.procedural import floor_quad

    cam = Camera.create((0, 2.0, 2.0), (0, 0, 0), (0, 1, 0), 0.7)
    env = np.full((8, 16, 3), 0.8, np.float32)
    view = SceneView.build(floor_quad(1.0, (0.6, 0.6, 0.6)), cam, dev, env_map=env)
    before = trace_mod.CLOSEST.launches
    got = tpt.direct_env_image(view, 32, 24, 3, 1)
    assert trace_mod.CLOSEST.launches == before + 1 and float(got[1]) == 768.0
    cpu = tpt.direct_env_image(SceneView.build(floor_quad(1.0, (0.6, 0.6, 0.6)), cam, "cpu",
                                               env_map=env), 32, 24, 3, 1)
    # the camera rays round apart on the two devices: a ray on the floor's
    # edge may flip between hit and miss
    near = ((got[0].cpu() - cpu[0]).abs() <= 1e-5).all(dim=1).float().mean()
    assert float(near) >= 0.99 and float(cpu[0].max()) > 0.5
    with monkeypatch.context() as m:
        for mod, name, value in _forced_plain(dev):
            m.setattr(mod, name, value)
        want = tpt.direct_env_image(view, 32, 24, 3, 1)
    assert torch.equal(_bits(got[0]), _bits(want[0]))
    for renderer, kw in (("mlt", {"steps_per_pass": 4}), ("cmlt", {"n_seed_rounds": 1})):
        ctx = RenderingContext.create(floor_quad(1.0, (0.6, 0.6, 0.6)), cam, 32, 32,
                                      renderer=renderer, max_path_length=3, env_map=env, **kw)
        ctx.render(2)
        img = ctx.hdr_image()
        assert np.isfinite(img).all() and img.mean() > 0.4


def _rpt_launches():
    return (trace_mod.CLOSEST.launches, trace_mod.ANY.launches, ft.CLOSEST.launches,
            ft.ANY.launches, gather_mod.GATHER.launches, cdf_gather.PICK.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", ["cornell", "big_room400"])
def test_rpt_pass_kernels_match_plain_on_card(dev, scene, monkeypatch):
    """An RPT pass (max_path_length 4, two reuse shadow samples) with the
    kernels against the same pass with every plain version forced: rays
    equal, the radiance and the rays per pixel bit-equal; 4 closest
    launches (x, y, two walk bounces) and 6 any-hit launches (NEE at x, at
    y and at the two walk vertices, two reuse connections) a pass, and K4
    for each of the four light picks on big_room."""
    from fermat_tpu_torch.integrators import rpt
    from fermat_tpu_torch.scene.procedural import big_room_camera

    if scene == "cornell":
        view, res = SceneView.build(cornell_box(glossy_boxes=True), cornell_camera(), dev), 64
    else:
        view, res = SceneView.build(big_room(400), big_room_camera(), dev), 48
    opts = rpt.RPTOptions(max_path_length=4)
    before = _rpt_launches()
    got = rpt.render_pass(view, opts, res, res, 3, 0)
    torch.cuda.synchronize()
    moved = [b - a for a, b in zip(before, _rpt_launches())]
    assert moved[:4] == ([4, 6, 0, 0] if scene == "cornell" else [0, 0, 4, 6]), moved
    assert moved[4] > 0 and moved[5] == (0 if scene == "cornell" else 4), moved
    for mod, name, value in _forced_plain(dev):
        monkeypatch.setattr(mod, name, value)
    after = _rpt_launches()
    want = rpt.render_pass(view, opts, res, res, 3, 0)
    torch.cuda.synchronize()
    assert _rpt_launches() == after
    assert float(got[1]) == float(want[1]) and torch.equal(got[2], want[2])
    assert torch.equal(_bits(got[0].stack()), _bits(want[0].stack()))
    assert float(got[0].stack().mean()) > 0.0


@pytest.mark.cuda
def test_rpt_renders_through_the_context_on_card(dev):
    """RenderingContext's "rpt" defaults to the card and launches the dense
    kernels there; an untiled resolution raises."""
    from fermat_tpu_torch.render.context import RenderingContext

    ctx = RenderingContext.create(cornell_box(glossy_boxes=True), cornell_camera(), 32, 32,
                                  renderer="rpt", max_path_length=3)
    assert ctx.device.type == "cuda"
    before = trace_mod.CLOSEST.launches
    ctx.render(2)
    assert trace_mod.CLOSEST.launches == before + 2 * 3
    img = ctx.hdr_image()
    assert np.isfinite(img).all() and img.mean() > 0.0
    bad = RenderingContext.create(cornell_box(), cornell_camera(), 30, 32, renderer="rpt")
    with pytest.raises(ValueError, match="tiles evenly"):
        bad.render(1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["brute", "pallas"])
def test_jax_tracer_names_match_dense_on_card(dev, name):
    """tracer="brute" and "pallas" launch K1 (6 closest a 6-bounce pass) and
    render a pass bit-equal to tracer="dense"."""
    view = SceneView.build(cornell_box(glossy_boxes=True), cornell_camera(), dev)
    outs = []
    for tracer in (name, "dense"):
        before = trace_mod.CLOSEST.launches
        outs.append(tpt.render_pass(view, tpt.PTOptions(tracer=tracer), 64, 64, 2, 0))
        torch.cuda.synchronize()
        assert trace_mod.CLOSEST.launches == before + 6
    assert float(outs[0].rays) == float(outs[1].rays)
    for c in ("composited", "direct", "diffuse", "specular"):
        assert torch.equal(_bits(getattr(outs[0], c).stack()),
                           _bits(getattr(outs[1], c).stack())), c


@pytest.mark.cuda
def test_dump_speed_stats_detailed_on_card(dev):
    """dump_speed_stats(detailed=True) buckets the profiled pass's device
    kernels: the closest and any-hit tracer kernels and the rest."""
    from fermat_tpu_torch.render.context import RenderingContext

    ctx = RenderingContext.create(cornell_box(glossy_boxes=True), cornell_camera(), 64, 64)
    ctx.render(2)
    stats = ctx.dump_speed_stats(detailed=True)
    assert stats["rt_ms"] + stats["shadow_rt_ms"] + stats["shade_ms"] > 0.0
    assert stats["device"].startswith("cuda")


# ---- the last slice: denoisers, checkpoints, LBVH, kNN, uv BVH, multi-device ----

def _slice_ctx(dev, renderer="pt", res=64):
    from fermat_tpu_torch.render.context import RenderingContext

    return RenderingContext.create(cornell_box(glossy_boxes=True), cornell_camera(), res, res,
                                   renderer=renderer, device=dev, max_path_length=3)


@pytest.mark.cuda
@pytest.mark.parametrize("method", ["eaw", "xbl"])
def test_denoise_on_card_matches_cpu(dev, method):
    """The card's denoisers against the same call on the CPU, at the CPU
    test's tolerance (tests/test_torch_denoise.py: rtol 2e-5, atol 1e-6)."""
    from fermat_tpu_torch.render.denoise import denoise
    from fermat_tpu_torch.render.framebuffer import Framebuffer

    ctx = _slice_ctx(dev)
    ctx.render(2)
    gb = ctx.gbuffer
    got = denoise(ctx.fb, gb["normal"], gb["position"], gb["miss"], ctx.view.camera, 1,
                  method=method).cpu()
    want = denoise(Framebuffer(*(t.cpu() for t in ctx.fb)),
                   *(gb[k].cpu() for k in ("normal", "position", "miss")),
                   ctx.view.camera.to("cpu"), 1, method=method)
    torch.testing.assert_close(got, want, rtol=2e-5, atol=1e-6)
    assert ctx.filtered_image(method=method).shape == (64, 64, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("renderer", ["pt", "pssmlt", "psfpt"])
def test_checkpoint_round_trip_on_card(dev, renderer, tmp_path):
    from fermat_tpu_torch.render.checkpoint import load_checkpoint, save_checkpoint

    full = _slice_ctx(dev, renderer)
    full.render(2)
    save_checkpoint(str(tmp_path / "c.npz"), full)
    full.render(1)
    resumed = _slice_ctx(dev, renderer)
    load_checkpoint(str(tmp_path / "c.npz"), resumed)
    resumed.render(1)
    if renderer == "pt":
        assert all(torch.equal(a, b) for a, b in zip(resumed.fb, full.fb))
    else:  # their splats and cell sums are index_add_s, in no fixed order on the card
        for a, b in zip(resumed.fb, full.fb):
            assert float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())


@pytest.mark.cuda
def test_lbvh_knn_and_locate_on_card_match_cpu(dev):
    from fermat_tpu_torch.accel.kdtree import build_kdtree, knn
    from fermat_tpu_torch.accel.lbvh import build_lbvh_for_mesh
    from fermat_tpu_torch.scene.uv_bvh import build_uv_bvh, locate

    storage = random_soup(3000, seed=5)
    a, b = build_lbvh_for_mesh(storage.device_view(dev)), build_lbvh_for_mesh(
        storage.device_view("cpu"))
    for f in ("lo_x", "hi_z", "skip", "prim_start", "is_leaf", "prims", "child"):
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f)), f
    assert torch.equal(a.nodes.cpu().view(torch.int32), b.nodes.view(torch.int32))
    r = np.random.default_rng(2)
    pts, q = r.random((5000, 3), dtype=np.float32), torch.from_numpy(r.random((4096, 3),
                                                                               dtype=np.float32))
    qd = q.to(dev)
    d2, ids = knn(build_kdtree(pts, device=dev), qd[:, 0], qd[:, 1], qd[:, 2], k=4)
    d2c, idc = knn(build_kdtree(pts, device="cpu"), q[:, 0], q[:, 1], q[:, 2], k=4)
    assert torch.equal(ids.cpu(), idc)
    torch.testing.assert_close(d2.cpu(), d2c, rtol=1e-6, atol=0)
    box = cornell_box()
    su, sv = torch.rand(2, 2048, generator=torch.Generator().manual_seed(1))
    t_d = locate(build_uv_bvh(box, device=dev), 0, su.to(dev), sv.to(dev))
    t_c = locate(build_uv_bvh(box, device="cpu"), 0, su, sv)
    assert torch.equal(t_d[0].cpu(), t_c[0])
    torch.testing.assert_close(t_d[1].cpu(), t_c[1], rtol=1e-6, atol=1e-7)


@pytest.mark.cuda
def test_sharded_pass_and_step_on_nccl_at_world_size_one(dev, tmp_path):
    import torch.distributed as dist

    from fermat_tpu_torch.parallel import mesh as pmesh

    ctx = _slice_ctx(dev)
    view, opts = ctx.view, tpt.PTOptions(**ctx.renderer_options)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path / 'rdv'}", world_size=1,
                            rank=0, device_id=torch.device("cuda", 0))
    try:
        mesh = pmesh.make_mesh(torch.device("cuda", 0))
        with pytest.raises(ValueError):
            pmesh.make_mesh("cpu")
        out = pmesh.render_pass_sharded(view, opts, 64, 64, 3, mesh)
        want = tpt.render_pass(view, opts, 64, 64, 3)
        assert torch.equal(out.composited.stack(), want.composited.stack())
        assert torch.equal(out.rays, want.rays)
        target = torch.zeros((64 * 64, 3), device=dev)
        new_view, loss = pmesh.train_step_sharded(view, target, opts, 64, 64, 3, mesh)
        assert float(loss) > 0
        assert not torch.equal(new_view.mesh.materials.diffuse.stack(),
                               view.mesh.materials.diffuse.stack())
    finally:
        dist.destroy_process_group()
