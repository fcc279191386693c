#!/usr/bin/env python3
"""Where the port's AD gradient and the megakernel's replay gradient (K3b)
part ways, on the configuration of chip_smoke.py phase 4f: the glossy
CornellBox, 512x512, 6 bounces, instance 2, an MSE against a zero target,
d loss / d materials.diffuse.

    python3 tools/torch_ad_bisect.py [--device cuda|cpu] [--res 512]

Prints, each as a fraction of max|g|, the AD gradient (render_pass under
torch.autograd) against K3b's (render_grad_diffuse_mega) for the same
adjoint, with K2's backward as the port runs it, with its plain version and
with its plain version summed in float64; each of those and K3b against a
float64 sum of the replay's own per-lane terms (_plain_pass); the forward
images of the AD pass, of K3a and of K3a's plain version compared pixel by
pixel (bit-equal share, pixels apart by more than 1e-4, and those pixels);
and the same gradient comparison with only the NEE terms and with only the
BSDF-sampled terms on. On the CPU the port's kernels are their plain
versions, so "K2b" and "plain" are one thing there.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


@contextlib.contextmanager
def patched(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def main() -> int:
    import torch

    from fermat_tpu_torch.core.math import Vec3
    from fermat_tpu_torch.integrators import pt
    from fermat_tpu_torch.ops import gather as gm
    from fermat_tpu_torch.ops import pt_mega
    from fermat_tpu_torch.render.context import RenderingContext
    from fermat_tpu_torch.scene.procedural import cornell_box, cornell_camera

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--res", type=int, default=512)
    a = ap.parse_args()
    res, inst = a.res, 2
    ctx = RenderingContext.create(cornell_box(glossy_boxes=True), cornell_camera(), res, res,
                                  renderer="pt", max_path_length=6, device=a.device)
    view, opts = ctx.view, pt.PTOptions(**ctx.renderer_options)

    def ad_grad(o):
        leaf = view.mesh.materials.diffuse.stack().detach().clone().requires_grad_(True)
        mats = view.mesh.materials._replace(diffuse=Vec3(leaf[:, 0], leaf[:, 1], leaf[:, 2]))
        out = pt.render_pass(view._replace(mesh=view.mesh._replace(materials=mats)), o, res,
                             res, inst, 0)
        img = out.composited.stack()
        (img ** 2).mean().backward()
        return leaf.grad.double(), (2.0 * img / img.numel()).detach(), img.detach()

    def bwd64(g, idx, rows):
        return gm._gather_bwd_plain(g.double(), idx, rows).float()

    report = {"device": a.device, "res": res}
    if a.device != "cpu":
        report["card"] = torch.cuda.get_device_name(0)
    g_ad, adj, img = ad_grad(opts)
    with patched(gm, "gather_rows_bwd", gm._gather_bwd_plain):
        g_plain = ad_grad(opts)[0]
    with patched(gm, "gather_rows_bwd", bwd64):
        g_64 = ad_grad(opts)[0]
    g3 = pt_mega.render_grad_diffuse_mega(view, opts, res, res, inst, adj, 0).double()
    tb = pt_mega.build_mega_tables(view, res, res, opts.ray_eps)
    g_sum64 = pt_mega._plain_pass(tb, opts, res, res * res, inst, 0, adj).double().sum(0)
    scale = float(g_sum64.abs().max())
    rel = lambda x, y: float((x - y).abs().max()) / scale
    report["grad"] = {
        name: {"vs_K3b": rel(g, g3), "vs_float64_sum_of_the_replay_terms": rel(g, g_sum64)}
        for name, g in (("AD, K2b", g_ad), ("AD, K2 plain backward", g_plain),
                        ("AD, K2 plain backward in float64", g_64), ("K3b", g3))}

    comp = lambda z: (z[0:3] + z[3:6] + z[6:9]).t()
    k3a = comp(pt_mega._mega_forward(tb, opts, res, res * res, inst, 0))
    k3p = comp(pt_mega._mega_plain(tb, opts, res, res * res, inst, 0))
    images = {}
    for label, x, y in (("AD pass vs K3a", img, k3a), ("AD pass vs K3a's plain version", img, k3p),
                        ("K3a vs its plain version", k3a, k3p)):
        d = (x - y).abs().max(dim=1).values
        far = torch.nonzero(d > 1e-4)[:, 0]
        images[label] = {"bit_equal_share": float((d == 0).float().mean()),
                         "pixels_over_1e-4": int(far.numel()), "max_abs_diff": float(d.max()),
                         "pixels": {int(p): [x[p].tolist(), y[p].tolist()] for p in far[:8]}}
    report["images"] = images

    for label, kw in (("NEE only", dict(direct_lighting_bsdf=False, indirect_lighting_bsdf=False)),
                      ("BSDF-sampled only", dict(direct_lighting_nee=False,
                                                 indirect_lighting_nee=False))):
        o2 = opts._replace(**kw)
        g2, adj2, _ = ad_grad(o2)
        g32 = pt_mega.render_grad_diffuse_mega(view, o2, res, res, inst, adj2, 0).double()
        report[label] = float((g2 - g32).abs().max() / g32.abs().max())
    print(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
