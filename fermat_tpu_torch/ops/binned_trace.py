"""K7a / K7b — the binned tracer: closest hit and occlusion over the
cluster table as rounds of per-ray cluster visits binned by cluster
(fermat_tpu/ops/pallas_binned_trace.py).

It replaces JAX's `_run_kernel` (:320, pallas_call :341) over
`_binned_closest_kernel` (:189) and `_binned_any_kernel` (:264), with the
round loops `_closest_impl` (:362) and `_any_impl` (:426) and their XLA
scan `_frontier_scan` (:109). The function is K5's (ops/frontier_trace.py),
so the answer equals K5's bit for bit; the closest hit also returns the
winner's Moller-Trumbore u, v, as the Pallas kernel does (:233-238).

On CUDA tensors `trace_closest_binned` / `trace_any_binned` run the round
loop on the device, over the kernels of csrc/binned.cu. JAX keeps its loop
on the device under `lax.while_loop`; here the live count, the bins and
every per-ray state live in device memory, `_rounds` enqueues ROUND_BATCH
rounds at a time with one C call (one launch of a CUDA graph of the
batch, captured once for each batch shape and replayed by every trace),
and each kernel of a round reads its counts there and exits early when
nothing is left. The host reads the counts back once per batch
(`LOOP.readbacks`), so a trace of R rounds takes ceil(R / ROUND_BATCH)
readbacks, the last of which finds the loop over. A round:

  1. the scan (SCAN_CLOSEST / SCAN_ANY): one pass over the cluster boxes
     (skipping each 32 whose union box the ray misses) for each ray whose
     queue ran out (in the first round, every active ray) fills its queue
     of the next QUEUE keys: the smallest (E', cid)
     after its cursor with E' <= its best t, or for occlusion the next
     entered cids (JAX's min by cid, :166-169). A queue that holds all of a
     ray's keys is never rescanned, so the ray's full passes fall from one
     a visit to one per QUEUE visits;
  2. the counting sort (BIN): the ready rays' histogram by cid (summed as
     they were appended), its exclusive scan over the c_pad bins, cut into
     work items of BLOCK rays, and a scatter into the bins, in any order
     within a bin; JAX's liveness cap of 4 x Cp rounds (:373-378) is held
     here, on the device;
  3. the test (K7a / K7b): persistent CTAs pop the work items, stage the
     item's cluster in shared memory and test it against one ray a thread;
     each ray folds the result into its own state (JAX's merge, :394-405),
     steps its queue and appends itself to the next round's ready list or
     to the rescan list. Every ready ray is tested every round (no retries
     of JAX's `u_steps`), so a round is one visit of each live ray and the
     rounds are the longest visit list.

A ray's state changes only by its own visits, and each visit folds into it
by a min over (t, id), or an "or" for occlusion, which do not depend on the
order they are taken in; the E' <= t_best cut skips only clusters that
cannot hold the answer. So neither the order of the visits nor the order of
the rays within a bin can change a bit of the answer.

`_scan_plain`, `_bin_plain` and `_test_plain` are the plain PyTorch versions
of the three steps, over the same device-resident state (`_Loop`); no
wrapper calls them: `_plain_run` strings them into the runner the tests
give `_rounds`, so that the CPU tests run the whole loop, its batches and
its cap. On CPU tensors the wrappers run the shared plain versions of the
function (`_closest_uv_plain`, `_any_plain`). BLOCK, QUEUE and ROUND_BATCH
are module constants, not options of the wrappers; the tests set them
small to force many rounds, rescans and batches.

Divergences from the Pallas kernels, each deliberate and shared with K5:
the margin E' (the scan orders by E', not E) and the smallest-id tie rule;
inactive lanes are masked by `active` rather than by tmax = -1 (:492-493),
and a miss returns t = tmax. JAX's merge starts each round's hit at -1
(:251), so it shows no phantom hit at tmax = inf; the port has none either.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import torch

from fermat_tpu_torch.accel.cluster import ClusterView
from fermat_tpu_torch.accel.traverse import Hit
from fermat_tpu_torch.core.math import Vec3
from fermat_tpu_torch.ops._cuda import I, P, CudaKernel
from fermat_tpu_torch.ops.frontier_trace import (_INT_MAX, _any_plain, _chunks,
                                                 _closest_uv_plain, _ray_args, _slack,
                                                 _table_args, _tile, cluster_entries)
from fermat_tpu_torch.ops.trace import _lane_args, mt_test

Tensor = torch.Tensor

BLOCK = 128  # rays a work item of the test kernel (its CTA's threads), 32..256
QUEUE = 8  # keys a scan queues per ray: 1 or 8 on the card, any in the plain steps
ROUND_BATCH = 16  # rounds enqueued between two readbacks
SCAN_GROUP = 32  # boxes under one union box in the scan (csrc/binned.cu kGroup)
SENT = _INT_MAX  # "no cluster" (csrc/binned.cu kSent)
# ctl slots (csrc/binned.cu): rays tested this round, appended ready, to
# rescan, the test's next work item, rounds that tested rays, rays live at
# the cap, full scans, ray-cluster visits
CTL_LIVE, CTL_READY, CTL_RESCAN, CTL_ITEM, CTL_ROUNDS, CTL_OVER, CTL_SCANS, CTL_PAIRS = range(8)
STEP_SCAN, STEP_BIN, STEP_TEST = 1, 2, 4
ALL_STEPS = STEP_SCAN | STEP_BIN | STEP_TEST

_ROUNDS_ARGS = [I] * 8 + [P] * 9 + [P, I, I, P, P] + [P] * 6 + [P] * 5 + [P] * 5


def _rounds_kernel(name: str, replaces: str) -> CudaKernel:
    return CudaKernel(name, "binned.cu", "fermat_binned_rounds", _ROUNDS_ARGS, replaces)


# One C call enqueues a batch of rounds; each counter counts its kernel's
# launches (BIN: the offsets and scatter kernels, a pair a round).
SCAN_CLOSEST = _rounds_kernel(
    "binned_scan_closest",
    "helper: fermat_tpu/ops/pallas_binned_trace.py:109 (_frontier_scan, XLA, ordered=True)")
SCAN_ANY = _rounds_kernel(
    "binned_scan_any",
    "helper: fermat_tpu/ops/pallas_binned_trace.py:109 (_frontier_scan, XLA, ordered=False)")
BIN = _rounds_kernel(
    "binned_bin",
    "helper: fermat_tpu/ops/pallas_binned_trace.py:383-393 (the rounds' compaction, XLA)")
CLOSEST = _rounds_kernel(
    "trace_closest_binned",
    "fermat_tpu/ops/pallas_binned_trace.py:320 (_run_kernel, pallas_call :341, kernel "
    "_binned_closest_kernel :189; round loop _closest_impl :362)")
ANY = _rounds_kernel(
    "trace_any_binned",
    "fermat_tpu/ops/pallas_binned_trace.py:320 (_run_kernel, pallas_call :341, kernel "
    "_binned_any_kernel :264; round loop _any_impl :426)")

# the parts of csrc/binned.cu's kernel names, by family
_FAMILIES = (("binned_scan", "scan"), ("binned_offsets", "bin"), ("binned_scatter", "bin"),
             ("binned_test", "test"))


def kernel_family(name: str) -> str:
    """The family of a device kernel's name in a profile: the loop's scan,
    its counting sort (offsets and scatter), its test, or "other"."""
    return next((fam for part, fam in _FAMILIES if part in name), "other")


class _LoopCounts:
    """Totals over the binned traces since `reset()`: traces, rounds that
    tested rays, full scans of the box table, ray-cluster visits, and the
    host's readbacks of the loop's counts (one per batch of rounds)."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.traces = self.rounds = self.scans = self.pairs = self.readbacks = 0


LOOP = _LoopCounts()


class _Rays(NamedTuple):
    o: Vec3
    d: Vec3
    tmin: Tensor
    tmax: Tensor


class _Loop(NamedTuple):
    """The device-resident state of one trace (csrc/binned.cu Loop)."""

    t_best: Tensor
    id_best: Tensor  # int32, _INT_MAX = no hit yet
    tri: Tensor  # int32, the answer's id: id_best, -1 for no hit
    u: Tensor
    v: Tensor
    occ: Tensor  # bool
    qe: Tensor  # (QUEUE, n) E' of each queued key (closest only)
    qc: Tensor  # (QUEUE, n) cid of each queued key
    qhead: Tensor  # next queue slot to visit
    qlen: Tensor  # keys in the queue
    qdone: Tensor  # bool: the last scan saw no key beyond the queue
    lists: Tensor  # (3, n): sorted, ready, rescan
    ready_cid: Tensor
    bins: Tensor  # hist (c_pad), start (c_pad + 1), items (c_pad + 1), fill (c_pad)
    item_bin: Tensor
    ctl: Tensor  # (8,) int32, the CTL_* slots

    @property
    def c_pad(self) -> int:
        return (self.bins.shape[0] - 2) // 4

    def hist(self) -> Tensor:
        return self.bins[:self.c_pad]

    def start(self) -> Tensor:
        return self.bins[self.c_pad:2 * self.c_pad + 1]

    def items(self) -> Tensor:
        return self.bins[2 * self.c_pad + 1:3 * self.c_pad + 2]

    def fill(self) -> Tensor:
        return self.bins[3 * self.c_pad + 2:]


def _new_loop(n: int, c_pad: int, closest: bool, dev) -> _Loop:
    """Every buffer of a trace, uninitialised (the first round starts them):
    one allocation, cut into a float32, an int32 and a bool run and each run
    into its fields (a dozen tensor ops, not three a field: this runs once a
    trace, before its first launch)."""
    runs = ((torch.float32, (("t_best", (n,)), ("u", (n,)), ("v", (n,)),
                             ("qe", (QUEUE if closest else 0, n)))),
            (torch.int32, (("id_best", (n,)), ("tri", (n,)), ("qc", (QUEUE, n)),
                           ("qhead", (n,)), ("qlen", (n,)), ("lists", (3, n)),
                           ("ready_cid", (n,)), ("bins", (4 * c_pad + 2,)),
                           ("item_bin", (-(-n // BLOCK) + c_pad + 1,)), ("ctl", (8,)))),
            (torch.bool, (("occ", (n,)), ("qdone", (n,)))))
    sizes = [[math.prod(shape) for _, shape in fields] for _, fields in runs]
    nbytes = [sum(sz) * dt.itemsize for sz, (dt, _) in zip(sizes, runs)]
    room = [-(-b // 16) * 16 for b in nbytes]  # each run 16-byte aligned
    buf = torch.empty(sum(room), dtype=torch.uint8, device=dev)
    out = {}
    for part, b, sz, (dt, fields) in zip(buf.split(room), nbytes, sizes, runs):
        for t, (name, shape) in zip(part[:b].view(dt).split(sz), fields):
            out[name] = t.view(shape) if len(shape) > 1 else t
    return _Loop(**out)


def _append(lp: _Loop, slot: int, lanes: Tensor, cids: Optional[Tensor] = None) -> None:
    """Appends lanes to the ready list (slot CTL_READY, with their cids,
    counted in the histogram) or to the rescan list (CTL_RESCAN)."""
    at, m = int(lp.ctl[slot]), lanes.shape[0]
    row = 1 if slot == CTL_READY else 2
    lp.lists[row, at:at + m] = lanes.to(torch.int32)
    if cids is not None:
        lp.ready_cid[at:at + m] = cids
        lp.hist().add_(torch.bincount(cids.long(), minlength=lp.c_pad).to(torch.int32))
    lp.ctl[slot] += m


def _peek(lp: _Loop, lanes: Tensor, closest: bool) -> None:
    """Each lane's next step after a scan or a visit: its queue's head key
    to the ready list (for the closest hit only with E' <= its best t), the
    rescan list when its queue ran out and the scan saw more, else done."""
    h, size = lp.qhead[lanes].long(), lp.qlen[lanes].long()
    has = h < size
    hc = h.clamp(max=lp.qc.shape[0] - 1)
    ok = has & (lp.qe[hc, lanes] <= lp.t_best[lanes]) if closest else has
    _append(lp, CTL_READY, lanes[ok], lp.qc[hc, lanes][ok])
    _append(lp, CTL_RESCAN, lanes[~has & ~lp.qdone[lanes]])


def _scan_plain(cl: ClusterView, rays: _Rays, active: Tensor, lp: _Loop, first: bool,
                closest: bool) -> None:
    """Plain version of the scan kernel: for each ray of the rescan list (in
    the first round every lane starts its state and every active ray is
    scanned), its next QUEUE keys after its cursor, then its first key."""
    dev = active.device
    if first:
        if closest:
            lp.t_best.copy_(rays.tmax)
            lp.id_best.fill_(_INT_MAX)
            lp.tri.fill_(-1)
            lp.u.zero_()
            lp.v.zero_()
        else:
            lp.occ.zero_()
        lanes = torch.nonzero(active)[:, 0]
    else:
        lanes = lp.lists[2, :int(lp.ctl[CTL_RESCAN])].long()
    lp.ctl[CTL_SCANS] += lanes.shape[0]
    k, c_pad = QUEUE, lp.c_pad
    col = torch.arange(c_pad, dtype=torch.int32, device=dev)
    slots = torch.arange(k, device=dev)
    for sl in _chunks(lanes.shape[0], c_pad):
        g = lanes[sl]
        pick = lambda a: a[g]
        e = _slack(cluster_entries(cl, Vec3(*map(pick, rays.o)), Vec3(*map(pick, rays.d)),
                                   pick(rays.tmin), pick(rays.tmax))[:, :c_pad])
        entered = e < float("inf")
        size = torch.zeros_like(g) if first else lp.qlen[g].long()
        last = (size - 1).clamp(min=0)
        lc = torch.where(size > 0, lp.qc[last, g], -1)[:, None]
        if closest:
            le = torch.where(size > 0, lp.qe[last, g], float("-inf"))[:, None]
            elig = (entered & (e <= lp.t_best[g][:, None])
                    & ((e > le) | ((e == le) & (col > lc))))
            # ascending E', ties in ascending cid: the kernel's insertion order
            ks, kc = torch.sort(torch.where(elig, e, float("inf")), dim=1, stable=True)
        else:
            elig = entered & (col > lc)
            kc = torch.sort(torch.where(elig, col, SENT), dim=1).values
            ks = None
        found = elig.sum(dim=1)
        size = found.clamp(max=k)
        w = min(k, c_pad)
        keep = slots[:w][None, :] < size[:, None]
        lp.qc[:w, g] = torch.where(keep, kc[:, :w].to(torch.int32), lp.qc[:w, g].T).T
        if closest:
            lp.qe[:w, g] = torch.where(keep, ks[:, :w], lp.qe[:w, g].T).T
        lp.qhead[g] = 0
        lp.qlen[g] = size.to(torch.int32)
        lp.qdone[g] = found <= k
    _peek(lp, lanes, closest)


def _bin_plain(lp: _Loop, cap: int, order: Callable = None) -> None:
    """Plain version of the offsets and scatter kernels: the cap, the bins'
    exclusive scan, their work items of BLOCK rays and the scatter (in cid
    order, stable; `order(cids)` may give another order within the bins)."""
    c_pad, ctl = lp.c_pad, lp.ctl
    m = int(ctl[CTL_READY])
    if m > 0 and int(ctl[CTL_ROUNDS]) >= cap:
        ctl[CTL_OVER] = m
        m = 0
    ctl[CTL_LIVE] = m
    ctl[CTL_READY] = ctl[CTL_RESCAN] = ctl[CTL_ITEM] = 0
    hist = lp.hist()
    if m == 0:
        hist.zero_()
        lp.items()[c_pad] = 0
        return
    ctl[CTL_ROUNDS] += 1
    ctl[CTL_PAIRS] += m
    h = hist.long()
    nb = (h + BLOCK - 1) // BLOCK
    lp.start()[:c_pad] = torch.cumsum(h, 0) - h
    lp.start()[c_pad] = m
    lp.items()[:c_pad] = torch.cumsum(nb, 0) - nb
    lp.items()[c_pad] = int(nb.sum())
    lp.item_bin[:int(nb.sum())] = torch.repeat_interleave(
        torch.arange(c_pad, dtype=torch.int32, device=h.device), nb)
    lp.fill()[:] = lp.start()[1:]  # where the scatter leaves its cursors
    hist.zero_()
    cids = lp.ready_cid[:m]
    perm = (order or (lambda c: torch.sort(c, stable=True).indices))(cids)
    lp.lists[0, :m] = lp.lists[1, :m][perm]


def _test_plain(cl: ClusterView, rays: _Rays, lp: _Loop, closest: bool,
                advance: bool = True) -> None:
    """Plain version of the test kernel: each ray of the sorted list visits
    its head key's cluster, folds the result into its state, steps its queue
    (unless `advance` is off) and goes on as `_peek` says."""
    m = int(lp.ctl[CTL_LIVE])
    lanes = lp.lists[0, :m].long()
    h = lp.qhead[lanes].long()
    for sl in _chunks(m, cl.rows.shape[1]):
        g, hs = lanes[sl], h[sl]
        tri9, ids = _tile(cl, lp.qc[hs, g].long())
        col = lambda a: a[g][:, None]
        tt, uu, vv, inside = mt_test(tri9, tuple(map(col, rays.o)), tuple(map(col, rays.d)))
        ok = inside & (tt > col(rays.tmin)) & (tt < col(rays.tmax)) & (ids >= 0)
        if not closest:
            lp.occ[g] = lp.occ[g] | ok.any(dim=1)
            continue
        ok = ok & (tt >= lp.qe[hs, g][:, None])
        tt = torch.where(ok, tt, float("inf"))
        t_new = tt.min(dim=1).values
        win = ok & (tt == t_new[:, None])
        id_new = torch.where(win, ids, _INT_MAX).min(dim=1).values
        k = (win & (ids == id_new[:, None])).to(torch.int64).argmax(dim=1, keepdim=True)
        t_cur, i_cur = lp.t_best[g], lp.id_best[g]
        better = ok.any(dim=1) & ((t_new < t_cur) | ((t_new == t_cur) & (id_new < i_cur)))
        lp.t_best[g] = torch.where(better, t_new, t_cur)
        lp.id_best[g] = torch.where(better, id_new, i_cur)
        lp.tri[g] = torch.where(better, id_new, lp.tri[g])
        lp.u[g] = torch.where(better, uu.gather(1, k)[:, 0], lp.u[g])
        lp.v[g] = torch.where(better, vv.gather(1, k)[:, 0], lp.v[g])
    if advance:
        lp.qhead[lanes] = (h + 1).to(torch.int32)
    _peek(lp, lanes if closest else lanes[~lp.occ[lanes]], closest)


def _plain_run(cl: ClusterView, rays: _Rays, active: Tensor, closest: bool,
               order: Callable = None, advance: bool = True) -> Callable:
    """The runner of `_rounds` over the plain steps (tests and checks)."""
    cap = 4 * cl.lo_x.shape[1]

    def run(lp: _Loop, n_rounds: int, first: bool, steps: int = ALL_STEPS) -> None:
        if first:
            lp.ctl.zero_()
            lp.hist().zero_()
        for r in range(n_rounds):
            if steps & STEP_SCAN:
                _scan_plain(cl, rays, active, lp, first and r == 0, closest)
            if steps & STEP_BIN:
                _bin_plain(lp, cap, order)
            if steps & STEP_TEST:
                _test_plain(cl, rays, lp, closest, advance)

    return run


def _kernel_run(cl: ClusterView, rays: _Rays, active: Tensor, closest: bool) -> Callable:
    """The runner of `_rounds` over csrc/binned.cu: one C call enqueues a
    batch of rounds. It holds the checked inputs until each call returns."""
    dev = rays.tmax.device
    boxes = _table_args(cl, dev)
    args = _ray_args(rays.o, rays.d, rays.tmin, rays.tmax, active)
    cap = 4 * cl.lo_x.shape[1]
    scan_k, test_k = (SCAN_CLOSEST, CLOSEST) if closest else (SCAN_ANY, ANY)
    table = [*(a.data_ptr() for a in args), boxes.data_ptr(), boxes.shape[1],
             cl.rows.shape[0], cl.rows.data_ptr(), cl.count.data_ptr()]
    # the copies behind those pointers (the boxes' concatenation, a ray made
    # contiguous), held as long as the runner: freed, their memory could be
    # handed to the state's allocation while the kernels still read it
    state = {"held": (args, boxes)}

    def run(lp: _Loop, n_rounds: int, first: bool, steps: int = ALL_STEPS) -> None:
        if state.get("lp") is not lp:
            state.update(lp=lp, ptrs=[a.data_ptr() for a in lp])
        test_k.launch(dev, int(closest), int(first), n_rounds, steps, args[0].shape[0], QUEUE,
                      BLOCK, cap, *table, *state["ptrs"],
                      count=n_rounds if steps & STEP_TEST else 0)
        scan_k.launches += n_rounds if steps & STEP_SCAN else 0
        BIN.launches += n_rounds if steps & STEP_BIN else 0

    return run


def _rounds(cl: ClusterView, rays: _Rays, active: Tensor, closest: bool,
            run: Callable) -> tuple:
    """The round loop -> (final state, rounds that tested rays): batches of
    ROUND_BATCH rounds, one readback of the counts after each; raises at
    JAX's liveness cap of 4 x Cp rounds."""
    n, dev = rays.tmax.shape[0], rays.tmax.device
    lp = _new_loop(n, cl.rows.shape[0], closest, dev)
    cap = 4 * cl.lo_x.shape[1]
    if n == 0:
        return lp, 0
    queued = 0
    while queued <= cap:
        batch = min(ROUND_BATCH, cap + 1 - queued)
        run(lp, batch, queued == 0)
        queued += batch
        ctl = lp.ctl.tolist()  # the batch's one readback
        LOOP.readbacks += 1
        if ctl[CTL_OVER]:
            raise RuntimeError(f"binned trace: {ctl[CTL_OVER]} rays still live after {cap} "
                               "rounds (the liveness cap, 4 x Cp)")
        if ctl[CTL_LIVE] == 0:
            LOOP.traces += 1
            LOOP.rounds += ctl[CTL_ROUNDS]
            LOOP.scans += ctl[CTL_SCANS]
            LOOP.pairs += ctl[CTL_PAIRS]
            return lp, ctl[CTL_ROUNDS]
    raise RuntimeError(f"binned trace: the loop ran {queued} rounds past the liveness cap "
                       f"({cap} = 4 x Cp) without stopping")


def _state_diff(a: _Loop, b: _Loop, closest: bool) -> list:
    """The fields in which two states of one trace differ, each list read as
    what the kernels promise of it: the ready and rescan lists as sets, the
    sorted list bin by bin in any order within a bin, ctl but for its
    work-item cursor; the rest bit for bit. Empty when they agree (the
    checks of each kernel step against its plain version)."""
    bits = lambda t: t.view(torch.int32) if t.is_floating_point() else t
    fields = ("t_best", "id_best", "tri", "u", "v") if closest else ("occ",)
    diff = [f for f in (*fields, "qe", "qc", "qhead", "qlen", "qdone", "bins", "item_bin")
            if not torch.equal(bits(getattr(a, f)), bits(getattr(b, f)))]
    ctl_a, ctl_b = a.ctl.tolist(), b.ctl.tolist()
    ctl_a[CTL_ITEM] = ctl_b[CTL_ITEM] = 0
    if ctl_a != ctl_b:
        return diff + ["ctl"]
    n, m, r = a.lists.shape[1], ctl_a[CTL_LIVE], ctl_a[CTL_READY]
    in_bin = torch.repeat_interleave(torch.arange(a.c_pad, device=a.ctl.device),
                                     a.start().diff().long()) * n if m else 0
    keys = lambda s: (("sorted", s.lists[0, :m].long() + in_bin),
                      ("ready", s.lists[1, :r].long() + s.ready_cid[:r].long() * n),
                      ("rescan", s.lists[2, :ctl_a[CTL_RESCAN]].long()))
    return diff + [name for (name, x), (_, y) in zip(keys(a), keys(b))
                   if not torch.equal(torch.sort(x).values, torch.sort(y).values)]


def _hit(lp: _Loop) -> Hit:
    """The state is the answer: a miss keeps t_best = tmax, tri = -1 and
    u = v = 0 from the first round."""
    return Hit(t=lp.t_best, tri=lp.tri, u=lp.u, v=lp.v)


def trace_closest_binned(clusters: ClusterView, o: Vec3, d: Vec3, tmin, tmax,
                         active: Optional[Tensor] = None) -> Hit:
    """Closest hit over the cluster table; t = tmax, tri = -1 and u = v = 0
    on a miss."""
    tmin, tmax, active = _lane_args(o, tmin, tmax, active)
    if o.x.device.type == "cpu":
        return _closest_uv_plain(clusters, o, d, tmin, tmax, active)
    rays = _Rays(o, d, tmin, tmax)
    lp, _ = _rounds(clusters, rays, active, True, _kernel_run(clusters, rays, active, True))
    return _hit(lp)


def trace_any_binned(clusters: ClusterView, o: Vec3, d: Vec3, tmin, tmax,
                     active: Optional[Tensor] = None) -> Tensor:
    """Occlusion flag per ray inside (tmin, tmax), masked by `active`."""
    tmin, tmax, active = _lane_args(o, tmin, tmax, active)
    if o.x.device.type == "cpu":
        return _any_plain(clusters, o, d, tmin, tmax, active)
    rays = _Rays(o, d, tmin, tmax)
    lp, _ = _rounds(clusters, rays, active, False, _kernel_run(clusters, rays, active, False))
    return lp.occ
