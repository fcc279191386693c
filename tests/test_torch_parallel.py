"""Multi-device rendering (parallel/mesh.py) at world size 2 on the gloo
backend, against the unsharded port pass and step (which the other test
files hold to JAX's): the pixel lanes split over two processes started with
torch.multiprocessing, their rendezvous a file:// under tmp_path (so that
parallel test workers cannot collide on a port).

Each rank's lanes equal the unsharded pass's lanes bit for bit, and the
all_reduce'd ray count equals its count (JAX's test_sharded_matches_single,
tests/test_parallel.py:28-60). BPT's radiance lanes are equal too; its
splat image, summed over the ranks, is held to the unsharded one at rtol
1e-6, atol 1e-7 (two partial scatter-sums added in another order). The
train step's loss and updated diffuse albedos are held at rtol 1e-6,
atol 1e-7, its gradient likewise being a sum of two partial sums.
"""
import os
import sys

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RES = 16
WORLD = 2
PT_OPTS = dict(max_path_length=3)


def _scene():
    from fermat_tpu_torch.bsdf.composite import scene_lobes
    from fermat_tpu_torch.integrators import bpt, pt
    from fermat_tpu_torch.scene import procedural
    from fermat_tpu_torch.scene.view import SceneView

    box = procedural.cornell_box()
    view = SceneView.build(box, procedural.cornell_camera(), torch.device("cpu"))
    lobes = scene_lobes(box.materials)
    target = torch.from_numpy(np.random.default_rng(3).random((RES * RES, 3), dtype=np.float32))
    return (view, pt.PTOptions(lobes=lobes, **PT_OPTS),
            bpt.BPTOptions(lobes=lobes, max_path_length=3), target)


def _worker(rank, rendezvous, out_dir):
    import torch.distributed as dist

    from fermat_tpu_torch.parallel import mesh as pmesh

    dist.init_process_group("gloo", init_method=f"file://{rendezvous}", world_size=WORLD,
                            rank=rank)
    try:
        view, opts, bopts, target = _scene()
        mesh = pmesh.make_mesh()
        out = pmesh.render_pass_sharded(view, opts, RES, RES, 1, mesh)
        gs = pmesh.render_pass_gspmd(view, opts, RES, RES, 1, mesh)
        rad, splat, brays = pmesh.render_bpt_pass_sharded(view, bopts, RES, RES, 1, mesh)
        img = pmesh.render_image_sharded(view, opts, RES, RES, 2, mesh)
        new_view, loss = pmesh.train_step_sharded(view, target, opts, RES, RES, 1, mesh)
        try:
            pmesh.make_mesh("cuda:0")
            refused = False
        except ValueError:
            refused = True
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 composited=out.composited.stack().numpy(), tri=out.tri.numpy(),
                 depth=out.depth.numpy(), rays=out.rays.numpy(),
                 gspmd=gs.composited.stack().numpy(), bpt_rad=rad.stack().numpy(),
                 splat=splat.numpy(), bpt_rays=brays.numpy(), image=img.numpy(),
                 loss=loss.numpy(), diffuse=new_view.mesh.materials.diffuse.stack().numpy(),
                 refused=refused)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    mp.start_processes(_worker, args=(str(d / "rendezvous"), str(d)), nprocs=WORLD,
                       start_method="spawn", join=True)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(WORLD)]


def _cat(ranks, key):
    return np.concatenate([r[key] for r in ranks])


def test_render_pass_sharded_equals_the_unsharded_pass(ranks):
    from fermat_tpu_torch.integrators import pt

    view, opts, _, _ = _scene()
    want = pt.render_pass(view, opts, RES, RES, 1)
    assert np.array_equal(_cat(ranks, "composited"), want.composited.stack().numpy())
    assert np.array_equal(_cat(ranks, "gspmd"), want.composited.stack().numpy())
    assert np.array_equal(_cat(ranks, "tri"), want.tri.numpy())
    assert np.array_equal(_cat(ranks, "depth"), want.depth.numpy())
    for r in ranks:
        assert float(r["rays"]) == float(want.rays)
        assert bool(r["refused"])  # gloo with a CUDA device: no pairing across backends
    acc = sum(pt.render_pass(view, opts, RES, RES, i).composited.stack() for i in range(2))
    np.testing.assert_array_equal(ranks[0]["image"], (acc / 2).reshape(RES, RES, 3).numpy())
    assert np.array_equal(ranks[0]["image"], ranks[1]["image"])


def test_bpt_pass_sharded_equals_the_unsharded_pass(ranks):
    from fermat_tpu_torch.integrators import bpt

    view, _, bopts, _ = _scene()
    rad, splat, rays, _ = bpt.render_pass(view, bopts, RES, RES, 1)
    assert np.array_equal(_cat(ranks, "bpt_rad"), rad.stack().numpy())
    for r in ranks:
        np.testing.assert_allclose(r["splat"], splat.numpy(), rtol=1e-6, atol=1e-7)
        assert float(r["bpt_rays"]) == float(rays)
    assert float(splat.abs().sum()) > 0


def test_train_step_sharded_equals_the_unsharded_step(ranks):
    from fermat_tpu_torch.core.math import Vec3
    from fermat_tpu_torch.integrators import pt

    view, opts, _, target = _scene()
    leaf = view.mesh.materials.diffuse.stack().clone().requires_grad_(True)
    mats = view.mesh.materials._replace(diffuse=Vec3(leaf[:, 0], leaf[:, 1], leaf[:, 2]))
    with torch.enable_grad():
        out = pt.render_pass(view._replace(mesh=view.mesh._replace(materials=mats)), opts,
                             RES, RES, 1)
        loss = torch.mean((out.composited.stack() - target) ** 2)
        loss.backward()
    new = torch.clamp(leaf.detach() - 0.05 * leaf.grad, 0.0, 1.0)
    assert float(leaf.grad.abs().max()) > 0
    for r in ranks:
        np.testing.assert_allclose(float(r["loss"]), float(loss.detach()), rtol=1e-6)
        np.testing.assert_allclose(r["diffuse"], new.numpy(), rtol=1e-6, atol=1e-7)
